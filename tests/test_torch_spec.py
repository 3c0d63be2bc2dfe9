"""The port's own copies of the framework-free modules of ``eco_tpu`` (GraphSpec
IR, prototxt import, the model zoo, shape arithmetic) held to the reference;
the port's entry points defaulting to the card; the AVE divisor cache; and
K3's tile planner over every int8 layer of ECO-Lite and ECO-Full."""

import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from eco_tpu.models import REGISTRY as JAX_REGISTRY
from eco_tpu.ops.pool import pool_nd as jax_pool_nd
from eco_tpu.spec.graph import graph_to_json as jax_graph_to_json
from eco_tpu.spec.prototxt import graph_from_prototxt as jax_graph_from_prototxt
from eco_tpu.spec.prototxt import parse_prototxt as jax_parse_prototxt
from eco_tpu.utils import shapes as jax_shapes
from eco_tpu_torch.convert import optimize_for_inference
from eco_tpu_torch.models import REGISTRY, get_model
from eco_tpu_torch.ops import pool, qconv
from eco_tpu_torch.runtime import Program, get_impl
from eco_tpu_torch.runtime.executor import Context
from eco_tpu_torch.spec.graph import graph_from_json, graph_to_json
from eco_tpu_torch.spec.prototxt import graph_from_prototxt, parse_prototxt
from eco_tpu_torch.utils import shapes

FIXTURES = Path(__file__).resolve().parent / "fixtures"


# zoo entries the port has and the reference does not (held to
# tests/reference_i3d.py by tests/test_torch_i3d.py)
PORT_ONLY = {"i3d_rgb_kinetics", "video_swin_b_kinetics", "mvit_v2_b_kinetics"}


def test_registry_names_match_the_reference():
    assert sorted(set(REGISTRY) - PORT_ONLY) == sorted(JAX_REGISTRY) and len(JAX_REGISTRY) == 10
    assert PORT_ONLY <= set(REGISTRY)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_zoo_builder_gives_the_reference_graph(name):
    kw = dict(batch=2) if name.startswith("c3d") else dict(num_segments=4, batch=2)
    got = graph_to_json(get_model(name, **kw))
    assert got == jax_graph_to_json(JAX_REGISTRY[name](**kw))
    # and the JSON crosses back into the port unchanged
    assert graph_to_json(graph_from_json(got)) == got


@pytest.mark.parametrize("fixture", ["mini_eco.prototxt", "mini_flow.prototxt"])
def test_prototxt_import_gives_the_reference_graph(fixture):
    text = (FIXTURES / fixture).read_text()
    assert parse_prototxt(text) == jax_parse_prototxt(text)
    got = graph_to_json(graph_from_prototxt(text))
    assert got == jax_graph_to_json(jax_graph_from_prototxt(text))


def test_pool_shape_arithmetic_matches_the_reference():
    for size, k, s, p in itertools.product(range(1, 16), range(1, 8), range(1, 4), range(0, 3)):
        if p >= k or size + 2 * p < k:
            continue
        assert shapes.caffe_pool_out_dim(size, k, s, p) == jax_shapes.caffe_pool_out_dim(size, k, s, p)
        assert (shapes.caffe_avg_pool_divisors(size, k, s, p)
                == jax_shapes.caffe_avg_pool_divisors(size, k, s, p))
        assert (shapes.caffe_conv_out_dim(size, k, s, p, 2)
                == jax_shapes.caffe_conv_out_dim(size, k, s, p, 2))
    for value in (None, 3, [3], [2, 3], (1, 2, 3)):
        try:
            want = jax_shapes.normalize_spatial_param(value, 3 if value != [2, 3] else 2)
        except ValueError:
            continue
        assert shapes.normalize_spatial_param(value, 3 if value != [2, 3] else 2) == want


def test_program_defaults_to_the_card():
    g = get_model("eco_lite_kinetics", num_segments=4, batch=1)
    assert Program(g).device.type == "cuda"
    assert Program(g, device="cpu").device.type == "cpu"


def test_second_ave_pool_reuses_the_cached_divisors_and_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 9, 11, 5)).astype(np.float32)
    kw = dict(kernel=(1, 3, 3), stride=(1, 2, 2), pad=(0, 1, 1), mode="ave")
    spatial, geo = (4, 9, 11), ((1, 3, 3), (1, 2, 2), (0, 1, 1))
    cpu = torch.device("cpu")
    pool.ave_divisors.cache_clear()
    first = pool.pool_nd(torch.from_numpy(x), **kw)
    div = pool.ave_divisors(spatial, *geo, cpu)
    second = pool.pool_nd(torch.from_numpy(x), **kw)
    assert pool.ave_divisors(spatial, *geo, cpu) is div
    info = pool.ave_divisors.cache_info()
    assert info.misses == 1 and info.hits >= 2
    want = np.asarray(jax_pool_nd(x, **kw))
    for got in (first, second):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _int8_layer_geometries(name):
    """(M, C_in, C_out, groups, kernel (3 axes), dilation (3 axes)) of every
    conv and fc that int8 quantization takes in the optimized graph of
    ``name`` at full width, batch 8; shapes propagated on the meta device."""
    g = get_model(name, num_segments=16, batch=8, crop_size=224)
    params, state = Program(g, device="meta").init(torch.Generator().manual_seed(0),
                                                   {"data": g.inputs["data"]})
    g_opt, p_opt, s_opt = optimize_for_inference(g, params, state)
    prog = Program(g_opt, device="meta")
    ctx = Context()
    blobs = {"data": torch.empty(g_opt.inputs["data"], device="meta")}
    out = []
    for layer in prog.exec_layers:
        ins = [blobs[b] for b in layer.bottoms]
        tops = get_impl(layer.type).apply(layer, p_opt.get(layer.name, {}),
                                          s_opt.get(layer.name, {}), ins, ctx)
        kind = layer.type.lower()
        if kind in ("convolution", "innerproduct"):
            w = p_opt[layer.name]["w"]
            if kind == "innerproduct":
                m, c_in, groups, k, dil = ins[0].shape[0], w.shape[1], 1, (1, 1), (1, 1)
            else:
                nsp = ins[0].ndim - 2
                m, c_in = math.prod(tops[0].shape[:-1]), ins[0].shape[-1]
                groups, k = int(layer.opt("group", 1)), tuple(w.shape[2:])
                dil = shapes.normalize_spatial_param(layer.opt("dilation", 1), nsp, default=1)
            pre = 3 - len(k)
            out.append((layer.name, m, c_in, w.shape[0], groups, (1,) * pre + k,
                        (1,) * pre + tuple(dil)))
        blobs.update(zip(layer.tops, tops))
    return out


@pytest.mark.parametrize("name,count", [("eco_lite_kinetics", 29), ("eco_full_kinetics", 65)])
def test_k3_plan_covers_every_int8_layer_and_fills_the_card(name, count):
    layers = _int8_layer_geometries(name)
    assert len(layers) == count
    modes = set()
    for lname, m, c_in, c_out, groups, kernel, dil in layers:
        p = qconv.plan(m, c_in, c_out, groups, kernel, dil)
        modes.add(p.mode)
        cg, cog = c_in // groups, c_out // groups
        # the tiles cover M and N exactly
        assert (p.m_tiles - 1) * qconv.TILE_M < m <= p.m_tiles * qconv.TILE_M, lname
        assert (p.n_tiles - 1) * p.bn < cog <= p.n_tiles * p.bn, lname
        # the K chunks cover K, and the splits add up to all of them
        k_bytes = {"vec": math.prod(kernel) * -(-cg // p.bk) * p.bk,
                   "span": math.prod(kernel[:-1]) * qconv.SPAN_BYTES,
                   "gather": -(-math.prod(kernel) * cg // p.bk) * p.bk}[p.mode]
        assert p.chunks * p.bk == k_bytes >= math.prod(kernel) * cg, lname
        # split s takes chunks [s * per, min(chunks, (s + 1) * per)), as the kernel
        ranges = [(sp * p.chunks_per_split, min(p.chunks, (sp + 1) * p.chunks_per_split))
                  for sp in range(p.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == p.chunks, lname
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), lname
        assert all(end > begin for begin, end in ranges), lname
        # enough blocks for 132 SMs, or the K split
        blocks = p.grid_x * p.n_tiles * p.groups * p.splits
        assert blocks >= qconv.NUM_SMS or p.splits > 1, (lname, p)
        # every ECO layer takes the cp.async ring, but conv1 its tap rows
        assert p.mode == ("span" if c_in == 3 else "vec"), (lname, p)
    assert modes == {"vec", "span"}


@pytest.mark.parametrize("c_in,groups,kernel,dil,aligned,mode", [
    (32, 1, (1, 3, 3), (1, 1, 1), True, "vec"),
    (32, 1, (1, 3, 3), (1, 1, 1), False, "gather"),
    (3, 1, (1, 7, 7), (1, 1, 1), True, "span"),
    (3, 1, (3, 3, 3), (1, 2, 2), True, "gather"),
    (24, 3, (1, 3, 3), (1, 1, 1), True, "gather"),
    (64, 2, (1, 1, 3), (1, 1, 1), True, "vec"),
])
def test_k3_plan_picks_the_mode_the_geometry_allows(c_in, groups, kernel, dil, aligned, mode):
    p = qconv.plan(1000, c_in, 64, groups, kernel, dil, aligned16=aligned)
    assert p.mode == mode
    assert p.bk == (64 if mode == "vec" and (c_in // groups) % 64 == 0 else 32)
