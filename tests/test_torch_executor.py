"""eco_tpu_torch's Program, rewrites, weight bridge and UInt8Server against
eco_tpu's, on the same numpy inputs and on weights carried across by
``params_from_jax``.

Tolerances (f32): XLA's CPU convolutions and ATen's sum in other orders, and
the differences grow through the layers.  The mini-graph (a handful of convs,
outputs of magnitude ~1) agrees to 2.4e-7 and is held to rtol 1e-5 / atol
2e-6; the full-width ECO-Lite (~40 layers deep) to the tolerances stated at
its test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eco_tpu.apps.serving import UInt8Server as JaxUInt8Server
from eco_tpu.convert import optimize_for_inference as jax_optimize
from eco_tpu.convert.load import fold_bn as jax_fold_bn
from eco_tpu.models import build_eco_lite
from eco_tpu.ops.pallas.preprocess import preprocess_on_device as jax_preprocess
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.runtime.init import _fans as jax_fans
from eco_tpu.spec.graph import GraphSpec, LayerSpec
from eco_tpu.spec.netspec import NetBuilder
from eco_tpu.spec.transforms import merge_sibling_1x1_convs as jax_merge
from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import (
    fold_bn,
    merge_sibling_1x1_convs,
    optimize_for_inference,
    params_from_jax,
)
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.runtime.init import _fans, fill

SLICE_TYPES = {
    "concat", "convolution", "dropout", "eltwise", "fold_segments",
    "global_avg_pool", "innerproduct", "pooling", "relu", "scale", "slice",
    "softmax", "unfold_segments",
}
N, S, HW = 2, 4, 16


def _mini_graph(softmax: bool = True) -> GraphSpec:
    """8-16 channel ECO-shaped graph holding every layer type of the slice,
    with three mergeable sibling 1x1 convs and BNs that fold_bn must turn
    into Scale layers (after an eltwise, and on a conv top with two
    consumers).  ``softmax=False`` ends it at the logits "fc"."""
    b = NetBuilder("mini")
    x = b.layer("fold", "fold_segments", b.input("data", (N, S, HW, HW, 3)))
    x = b.conv_bn_relu("stem", x, 8, k=3, s=2, p=1)             # 8x8
    x = b.max_pool("pool1", x, k=3, s=2)                        # ceil: 4x4
    a = b.conv_bn_relu("blk_1x1", x, 8, k=1)
    r = b.conv_bn_relu("blk_3x3_reduce", x, 8, k=1)
    c = b.conv_bn_relu("blk_3x3", r, 12, k=3, p=1)
    r2 = b.conv_bn_relu("blk_dbl_reduce", x, 8, k=1)
    d = b.conv_bn_relu("blk_dbl", r2, 8, k=3, p=1)
    p = b.avg_pool("blk_pool", x, k=3, s=1, p=1)
    pp = b.conv_bn_relu("blk_pool_proj", p, 8, k=1)
    x = b.concat("blk_out", [a, c, d, pp])                      # 36 channels
    lo, hi = b.layer("blk_slice", "slice", x, tops=("blk_lo", "blk_hi"),
                     axis=1, slice_point=[12])
    x = b.concat("blk_swap", [hi, lo])
    x = b.conv_bn_relu("to3d", x, 8, k=1)
    x = b.layer("r2Dto3D", "unfold_segments", x, num_segments=S)  # (N, S, 4, 4, 8)
    res = b.conv("res_a", x, 16, k=(3, 3, 3), p=(1, 1, 1))
    y = b.relu("res_a_relu", b.bn("res_a_bn", res))
    y = b.conv("res_b", y, 16, k=(3, 3, 3), s=(2, 2, 2), p=(1, 1, 1))
    down = b.conv("res_down", res, 16, k=(3, 3, 3), s=(2, 2, 2), p=(1, 1, 1))
    x = b.eltwise_sum("res_sum", [y, down])
    x = b.relu("res_sum_relu", b.bn("res_sum_bn", x))
    x = b.layer("post_scale", "scale", x)
    x = b.layer("gpool", "global_avg_pool", x)
    x = b.dropout("drop", x, 0.5)
    logits = b.fc("fc", x, 5)
    if softmax:
        b.layer("probs", "softmax", logits)
    return b.build()


def _randomize(params, state, seed=0):
    """Non-trivial BN statistics, biases and Scale params (the fillers leave
    them at identity / zero), as tests/test_golden_torch.py:_randomize_bn."""
    rng = np.random.default_rng(seed)
    out_p, out_s = {}, {k: dict(v) for k, v in state.items()}
    for lname, lp in params.items():
        out_p[lname] = dict(lp)
        for pname, v in lp.items():
            n = np.shape(v)
            if pname in ("gamma", "scale"):
                out_p[lname][pname] = jnp.asarray(1 + 0.2 * rng.standard_normal(n), jnp.float32)
            elif pname in ("beta", "shift", "b"):
                out_p[lname][pname] = jnp.asarray(0.1 * rng.standard_normal(n), jnp.float32)
        if lname in state:
            c = np.shape(state[lname]["mean"])
            out_s[lname]["mean"] = jnp.asarray(0.3 * rng.standard_normal(c), jnp.float32)
            out_s[lname]["var"] = jnp.asarray(0.5 + rng.random(c), jnp.float32)
    return out_p, out_s


def _jax_init(graph, seed=0):
    data = jnp.zeros(graph.inputs["data"], jnp.float32)
    params, state = JaxProgram(graph, train=False).init(jax.random.PRNGKey(seed), {"data": data})
    return _randomize(params, state, seed)


@pytest.fixture(scope="module")
def mini():
    """The mini-graph and its randomized reference weights (built once: the
    reference's init traces every layer)."""
    g = _mini_graph()
    return (g,) + _jax_init(g)


def _data(seed=1):
    return np.random.default_rng(seed).standard_normal((N, S, HW, HW, 3)).astype(np.float32)


def _layers(graph):
    return [(l.name, l.type, l.bottoms, l.tops, dict(l.options)) for l in graph.layers]


def _assert_trees_close(got, want, rtol=1e-6, atol=1e-7):
    assert got.keys() == want.keys()
    for lname in want:
        assert got[lname].keys() == want[lname].keys(), lname
        for pname in want[lname]:
            torch.testing.assert_close(got[lname][pname], want[lname][pname],
                                       rtol=rtol, atol=atol)


def test_mini_graph_holds_every_slice_type(mini):
    g, params, state = mini
    g_opt = jax_optimize(g, params, state)[0]
    assert {l.type for l in g.layers} >= SLICE_TYPES
    assert {l.type for l in g_opt.layers} == SLICE_TYPES


@pytest.mark.parametrize("optimized", [False, True])
def test_mini_graph_matches_jax(mini, optimized):
    g, params, state = mini
    tp, ts = params_from_jax(g, params, state, device="cpu")
    if optimized:
        g, params, state = jax_optimize(g, params, state)
        g_t, tp, ts = optimize_for_inference(mini[0], tp, ts)
        assert _layers(g_t) == _layers(g)
    x = _data()
    want, _ = JaxProgram(g, train=False).apply(params, state, {"data": jnp.asarray(x)},
                                               capture=["fc"])
    got, _ = Program(g, device="cpu").apply(tp, ts, {"data": torch.from_numpy(x)}, capture=["fc"])
    for name in ("fc", "probs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("rewrite", ["merge", "fold", "both"])
def test_rewrites_match_jax(mini, rewrite):
    """Same layer list, and params equal through the bridge."""
    g, params, state = mini
    tp, ts = params_from_jax(g, params, state, device="cpu")
    if rewrite == "merge":
        jg, jp, js = jax_merge(g, params, state)
        tg, tp, ts = merge_sibling_1x1_convs(g, tp, ts)
    elif rewrite == "fold":
        jg, jp, js = jax_fold_bn(g, params, state)
        tg, tp, ts = fold_bn(g, tp, ts)
    else:
        jg, jp, js = jax_optimize(g, params, state)
        tg, tp, ts = optimize_for_inference(g, tp, ts)
    assert _layers(tg) == _layers(jg) and tg.name == jg.name
    want_p, want_s = params_from_jax(jg, jp, js, device="cpu")
    _assert_trees_close(tp, want_p)
    _assert_trees_close(ts, want_s)


def test_init_shapes_match_jax_through_the_bridge(mini):
    g, params, state = mini
    want_p, want_s = params_from_jax(g, params, state, device="cpu")
    tp, ts = Program(g, device="cpu").init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]})
    for got, want in ((tp, want_p), (ts, want_s)):
        assert got.keys() == want.keys()
        for lname in want:
            assert {k: tuple(v.shape) for k, v in got[lname].items()} == \
                {k: tuple(v.shape) for k, v in want[lname].items()}
    for stats in ts.values():  # BN stats start at (0, 1), as in the reference
        assert bool((stats["mean"] == 0).all()) and bool((stats["var"] == 1).all())


def test_init_is_seeded_and_on_the_programs_device():
    g = _mini_graph()
    a = Program(g, device="cpu").init(torch.Generator().manual_seed(3), {"data": g.inputs["data"]})[0]
    b = Program(g, device="cpu").init(torch.Generator().manual_seed(3), {"data": g.inputs["data"]})[0]
    c = Program(g, device="cpu").init(torch.Generator().manual_seed(4), {"data": g.inputs["data"]})[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a["stem"]["w"], c["stem"]["w"])
    assert a["stem"]["w"].device.type == "cpu"


@pytest.mark.parametrize("jax_shape,torch_shape", [
    ((3, 3, 8, 16), (16, 8, 3, 3)),
    ((3, 3, 3, 96, 128), (128, 96, 3, 3, 3)),
    ((512, 400), (400, 512)),
    ((64,), (64,)),
])
def test_fans_match_jax_layout(jax_shape, torch_shape):
    assert _fans(torch_shape) == jax_fans(jax_shape)


@pytest.mark.parametrize("filler,check", [
    ({"type": "constant", "value": 0.5}, lambda t, fi, fo: bool((t == 0.5).all())),
    ({"type": "uniform", "min": -2.0, "max": 3.0},
     lambda t, fi, fo: t.min() >= -2 and t.max() <= 3 and abs(t.mean() - 0.5) < 0.05),
    ({"type": "gaussian", "mean": 1.0, "std": 2.0},
     lambda t, fi, fo: abs(t.mean() - 1) < 0.05 and abs(t.std() - 2) < 0.05),
    ({"type": "xavier"},
     lambda t, fi, fo: t.abs().max() <= (3 / fi) ** 0.5 and t.abs().max() > 0.9 * (3 / fi) ** 0.5),
    ({"type": "xavier", "variance_norm": "AVERAGE"},
     lambda t, fi, fo: t.abs().max() <= (6 / (fi + fo)) ** 0.5),
    ({"type": "msra", "variance_norm": "FAN_OUT"},
     lambda t, fi, fo: abs(t.std() - (2 / fo) ** 0.5) < 0.02 * (2 / fo) ** 0.5),
])
def test_fillers(filler, check):
    shape = (64, 32, 3, 3)  # (C_out, C_in, kh, kw): fan_in 288, fan_out 576
    t = fill(torch.Generator().manual_seed(0), shape, torch.float32, filler)
    assert tuple(t.shape) == shape and t.dtype == torch.float32
    assert check(t, *_fans(shape))


def test_bridge_layouts(mini):
    g, params, state = mini
    tp, ts = params_from_jax(g, params, state, device="cpu")
    np.testing.assert_array_equal(tp["stem"]["w"].numpy(),
                                  np.asarray(params["stem"]["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tp["res_a"]["w"].numpy(),
                                  np.asarray(params["res_a"]["w"]).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(tp["fc"]["w"].numpy(), np.asarray(params["fc"]["w"]).T)
    np.testing.assert_array_equal(ts["stem_bn"]["var"].numpy(), np.asarray(state["stem_bn"]["var"]))
    assert all(v.is_contiguous() for lp in tp.values() for v in lp.values())


def test_program_checks_inputs_and_layer_types():
    g = _mini_graph()
    prog = Program(g, compute_dtype=torch.bfloat16, device="cpu")
    assert isinstance(prog, torch.nn.Module)
    assert prog.output_names == JaxProgram(g, train=False).output_names == ["probs"]
    # the reference's cast policy: float features to compute_dtype, labels kept
    assert prog.cast_input(torch.zeros(2, 3, 4)).dtype == torch.bfloat16
    assert prog.cast_input(torch.zeros(2, dtype=torch.int64)).dtype == torch.int64
    assert prog.cast_input(torch.zeros(2, 3)).dtype == torch.float32
    params, state = Program(g, device="cpu").init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]})
    with pytest.raises(ValueError, match="non-batch dims"):
        prog.apply(params, state, {"data": torch.zeros(N, S + 1, HW, HW, 3)})
    with pytest.raises(ValueError, match="missing"):
        prog.init(torch.Generator(), {})
    # types that neither package implements (Caffe's Python and Crop layers)
    for ltype in ("python", "crop"):
        bad = GraphSpec("bad", {"data": (1, 4, 4, 3)},
                        [LayerSpec("l", ltype, ("data",), ("l",), {"num_output": 2})])
        with pytest.raises(KeyError, match=ltype):
            Program(bad, device="cpu")


def _frames_and_augment(h, w, crop, seed=2):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N, S, h, w, 3), dtype=np.uint8)
    h_off = np.array([0, h - crop], np.int32)
    w_off = np.array([w - crop, 3], np.int32)
    mirror = np.array([True, False])
    return frames, h_off, w_off, mirror


def _serve_both(g, params, state, frames, h_off, w_off, mirror, *, crop, compute_dtype):
    """The same request through the reference server (Pallas kernel in
    interpret mode) and the port's, each optimizing its own graph."""
    jg, jp, js = jax_optimize(g, params, state)
    jprog = JaxProgram(jg, train=False,
                       compute_dtype=None if compute_dtype is None else jnp.float32)
    aug = (jnp.asarray(h_off), jnp.asarray(w_off), jnp.asarray(mirror))
    want = JaxUInt8Server(jprog, jp, js, crop=crop, interpret=True)(
        jnp.asarray(frames), h_off=aug[0], w_off=aug[1], mirror=aug[2])
    tg, tp, ts = optimize_for_inference(g, *params_from_jax(g, params, state, device="cpu"))
    tprog = Program(tg, compute_dtype=None if compute_dtype is None else torch.float32, device="cpu")
    taug = dict(h_off=torch.from_numpy(h_off), w_off=torch.from_numpy(w_off),
                mirror=torch.from_numpy(mirror))
    got = UInt8Server(tprog, tp, ts, crop=crop)(torch.from_numpy(frames), **taug)
    return got, want, (jprog, jp, js, aug), (tprog, tp, ts, taug)


def test_server_runs_bf16_by_default_like_the_reference(mini):
    """Neither server passes an out_dtype to the kernel, so clips are bf16
    and, with compute_dtype=None, the whole model runs in bf16.  Compared on
    the logits (the mini-graph without its softmax, which saturates on raw
    pixel inputs)."""
    _, params, state = mini
    req = _frames_and_augment(HW + 4, HW + 8, HW)
    got, want, _, _ = _serve_both(_mini_graph(softmax=False), params, state, *req,
                                  crop=HW, compute_dtype=None)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    # bf16 rounds at other places in the two frameworks: logits of magnitude
    # 20-50 differ by up to one bf16 ulp there (0.25; measured 0.25, 5e-3 rel)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=0.5)


def test_full_width_uint8_server_matches_jax():
    """The slice end to end: full-width ECO-Lite (400 classes), crop 64, S=4,
    N=2, 80x96 uint8 frames with offsets at both edges and a mirror, f32 on
    both sides.  ~40 f32 layers summed in different orders: measured max abs
    error 2.0e-5 on logits of magnitude ~18 and 2.4e-6 on probs, held to
    atol 1e-4 / 1e-5 (5x and 4x margin, for other CPUs' kernel choices) and
    rtol 1e-5."""
    crop = 64
    g = build_eco_lite(batch=N, num_segments=S, crop_size=crop)
    params, state = _jax_init(g)
    req = _frames_and_augment(80, 96, crop)
    got, want, jside, tside = _serve_both(g, params, state, *req, crop=crop,
                                          compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, 400)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    jprog, jp, js, aug = jside
    clips = jax_preprocess(jnp.asarray(req[0]), *aug, crop=crop, interpret=True)
    want_logits = jax.jit(
        lambda p, s, x: jprog.apply(p, s, {"data": x}, capture=["fc8"])[0]["fc8"]
    )(jp, js, clips)
    tprog, tp, ts, taug = tside
    got_logits = UInt8Server(tprog, tp, ts, crop=crop, output="fc8")(
        torch.from_numpy(req[0]), **taug)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-4)
