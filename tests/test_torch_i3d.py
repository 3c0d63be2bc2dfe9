"""I3D-RGB in the port (``models/i3d.py``, zoo entry ``i3d_rgb_kinetics``)
against the plain reference of ``tests/reference_i3d.py`` on seeded random
weights, and what the port gained for it: asymmetric conv pads (float and
int8), the input transform and its fold, batch norm folded with its own
``eps``, 1x1x1 sibling merging, the ``pool.bytes`` counter, and the stem
run as space-to-depth and a stride-1 conv (float and int8).

Tolerance of the whole net in float32: relative L2 of the logits 1e-4, the
summation order of some 60 layers of convolutions (a bfloat16 program
misses it fiftyfold: 5.1e-3 on the CPU).
"""

import itertools
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import (
    fold_bn,
    fold_input_transform,
    fold_space_to_depth,
    merge_sibling_1x1_convs,
    optimize_for_inference,
    quantize_for_serving,
)
from eco_tpu_torch.models import get_model
from eco_tpu_torch.ops import conv_nd, pool, s2d
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.ops.qconv import conv_acc_reference
from eco_tpu_torch.ops.quant import conv_nd_int8, quantize_act
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.netspec import NetBuilder
from eco_tpu_torch.utils.tracing import COUNTS

sys.path.insert(0, str(Path(__file__).resolve().parent))
import reference_i3d as ref  # noqa: E402

CFG = {"num_classes": 400, "num_segments": 16, "crop_size": 224}
FRAMES = (2, 16, 232, 240, 3)
MEAN = (127.5,) * 3


def draw(specs, g):
    """Tensors of ``specs`` as their draws say, from ``g``."""
    out = {}
    for s in specs:
        if s.laplace > 0:
            u = torch.rand(s.shape, generator=g) - 0.5
            v = -s.laplace * u.sign() * torch.log1p(-2 * u.abs())
        else:
            v = torch.rand(s.shape, generator=g) * (s.high - s.low) + s.low
        out.setdefault(s.layer, {})[s.name] = v
    return out


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


# -- the graph ---------------------------------------------------------------

# i3d.py's end points at 64 x 224 x 224, (T, H, W, C); a unit's ReLU is in place,
# on its batch norm's top
TABLE = {
    "Conv3d_1a_7x7/batch_norm": (32, 112, 112, 64),
    "MaxPool3d_2a_3x3": (32, 56, 56, 64),
    "Conv3d_2b_1x1/batch_norm": (32, 56, 56, 64),
    "Conv3d_2c_3x3/batch_norm": (32, 56, 56, 192),
    "MaxPool3d_3a_3x3": (32, 28, 28, 192),
    "Mixed_3b/concat": (32, 28, 28, 256),
    "Mixed_3c/concat": (32, 28, 28, 480),
    "MaxPool3d_4a_3x3": (16, 14, 14, 480),
    "Mixed_4b/concat": (16, 14, 14, 512),
    "Mixed_4c/concat": (16, 14, 14, 512),
    "Mixed_4d/concat": (16, 14, 14, 512),
    "Mixed_4e/concat": (16, 14, 14, 528),
    "Mixed_4f/concat": (16, 14, 14, 832),
    "MaxPool3d_5a_2x2": (8, 7, 7, 832),
    "Mixed_5b/concat": (8, 7, 7, 832),
    "Mixed_5c/concat": (8, 7, 7, 1024),
    "Logits/AvgPool3d_0a_7x7": (7, 1, 1, 1024),
    "Conv3d_0c_1x1": (7, 1, 1, 400),
}


def test_graph_at_the_published_size():
    g = get_model("i3d_rgb_kinetics", num_frames=64, crop_size=224, batch=8)
    prog = Program(g, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]})
    assert sum(t.numel() for d in params.values() for t in d.values()) == 12_697_264
    specs, stats = ref.param_specs(ref.net({**CFG, "num_segments": 64}),
                                   {**CFG, "num_segments": 64})
    assert {(s.layer, s.name): s.shape for s in specs} == {
        (ln, pn): tuple(t.shape) for ln, d in params.items() for pn, t in d.items()}
    assert {(s.layer, s.name): s.shape for s in stats} == {
        (ln, pn): tuple(t.shape) for ln, d in state.items() for pn, t in d.items()}
    meta = {ln: {k: v.to("meta") for k, v in d.items()} for ln, d in params.items()}
    meta_s = {ln: {k: v.to("meta") for k, v in d.items()} for ln, d in state.items()}
    outs, _ = Program(g, device="meta").apply(
        meta, meta_s, {"data": torch.empty(g.inputs["data"], device="meta")},
        capture=list(TABLE))
    assert {k: tuple(outs[k].shape) for k in TABLE} == {k: (8,) + v for k, v in TABLE.items()}
    assert tuple(outs["probs"].shape) == (8, 400)
    pools = [l for l in g.layers if l.type == "pooling"]
    assert len(pools) == 14 and sum(l.opt("pool") == "max" for l in pools) == 13
    assert all(l.opt("eps") == 1e-3 for l in g.layers if l.type == "bn")
    stem = g.layer("Conv3d_1a_7x7")
    assert [list(p) for p in stem.opt("pad")] == [[2, 3]] * 3


# -- the program against the reference ----------------------------------------


@pytest.fixture(scope="module")
def weights_and_reference():
    net = ref.net(CFG)
    specs, stats = ref.param_specs(net, CFG)
    g = torch.Generator().manual_seed(2**31 + 19)
    params, state = draw(specs, g), draw(stats, g)
    frames = torch.randint(0, 256, FRAMES, dtype=torch.uint8, generator=g)
    h_off, w_off, mirror = [3, 8], [16, 0], [1, 0]
    with torch.no_grad():
        want = ref.forward(net, params, state, ref.clips(CFG, frames, h_off, w_off, mirror))
    return params, state, (frames, h_off, w_off, mirror), want


@pytest.mark.parametrize("optimized", [False, True], ids=["unfolded", "optimized"])
def test_program_matches_the_reference_in_float32(weights_and_reference, optimized):
    params, state, (frames, h_off, w_off, mirror), want = weights_and_reference
    g = get_model("i3d_rgb_kinetics", num_frames=16, crop_size=224, batch=2)
    p, s = params, state
    if optimized:
        g, p, s = optimize_for_inference(g, p, s)
        types = [l.type for l in g.layers]
        assert "input_transform" not in types and "bn" not in types
        # the stem reads its clip as space-to-depth cells (fold_space_to_depth)
        assert g.layer("Conv3d_1a_7x7").bottoms == ("Conv3d_1a_7x7/space_to_depth",)
        assert g.layer("Conv3d_1a_7x7/space_to_depth").type == "space_to_depth"
        assert g.layer("Conv3d_1a_7x7/space_to_depth").bottoms == ("data",)
        merged = [l for l in g.layers if l.name.endswith("__merged")]
        widths = dict(ref.MIXED)
        assert len(merged) == 9 and all(l.opt("num_output") == sum(
            widths[l.name.split("/")[0]][i] for i in (0, 1, 3)) for l in merged)
    server = UInt8Server(Program(g, compute_dtype=torch.float32, device="cpu"), p, s,
                         crop=224, mean=MEAN, output="averaged_logits")
    with torch.no_grad():
        got = server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= 1e-4


def test_a_bfloat16_program_misses_the_float32_tolerance(weights_and_reference):
    params, state, (frames, h_off, w_off, mirror), want = weights_and_reference
    g, p, s = optimize_for_inference(
        get_model("i3d_rgb_kinetics", num_frames=16, crop_size=224, batch=2), params, state)
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device="cpu"), p, s,
                         crop=224, mean=MEAN, output="averaged_logits")
    with torch.no_grad():
        got = server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
    assert _rel(got.float(), want) > 10 * 1e-4


# -- asymmetric conv pads ------------------------------------------------------

PADS = {
    "3d_same_s2": ((2, 5, 9, 8, 3), (4, 3, 3, 3, 3), (2, 2, 2), ((1, 2), (0, 1), (1, 1))),
    "3d_stem": ((1, 8, 12, 12, 3), (4, 3, 7, 7, 7), (2, 2, 2), ((2, 3), (2, 3), (2, 3))),
    "2d": ((2, 9, 10, 5), (6, 5, 3, 3), (1, 2), ((0, 2), (1, 1))),
    "3d_symmetric_pairs": ((2, 4, 6, 6, 4), (5, 4, 3, 3, 3), (1, 1, 1), ((1, 1),) * 3),
}


def _padded(x, pads):
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat)


@pytest.mark.parametrize("case", sorted(PADS))
def test_asymmetric_conv_pad_is_an_explicit_pad_then_a_conv(case):
    shape, wshape, stride, pads = PADS[case]
    g = torch.Generator().manual_seed(3)
    x, w, b = torch.randn(shape, generator=g), torch.randn(wshape, generator=g), torch.randn(
        wshape[0], generator=g)
    got = conv_nd(x, w, b, stride=stride, pad=pads)
    conv = F.conv3d if x.ndim == 5 else F.conv2d
    want = conv(_padded(x, pads).movedim(-1, 1), w, b, stride=stride).movedim(1, -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    meta = conv_nd(x.to("meta"), w.to("meta"), stride=stride, pad=pads)
    assert meta.shape == want.shape


@pytest.mark.parametrize("case", sorted(PADS))
def test_asymmetric_conv_pad_of_the_int8_path(case):
    shape, wshape, stride, pads = PADS[case]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=g)
    w_q = torch.randint(-127, 128, wshape, generator=g, dtype=torch.int8)
    w_scale, b = torch.rand(wshape[0], generator=g) * 0.01, torch.randn(wshape[0], generator=g)
    got = conv_nd_int8(x, w_q, w_scale, b, act_scale=0.02, stride=stride, pad=pads)
    acc = conv_acc_reference(_padded(quantize_act(x, 0.02), pads), w_q, stride=stride)
    want = acc.float() * (w_scale * 0.02) + b
    assert torch.equal(got, want.to(got.dtype))


def test_a_deconvolution_refuses_an_asymmetric_pad():
    x, w = torch.randn(1, 4, 4, 3), torch.randn(3, 2, 3, 3)
    with pytest.raises(ValueError, match="symmetric"):
        conv_nd(x, w, pad=((0, 1), (1, 1)), transposed=True)


# -- pools ---------------------------------------------------------------------

# I3D's four pool geometries at their sizes in the net (channels cut):
# (T, H, W), kernel, stride
POOLS = {
    "MaxPool3d_2a_3x3": ((32, 112, 112), (1, 3, 3), (1, 2, 2)),
    "Branch_3_3x3x3_s1": ((16, 14, 14), (3, 3, 3), (1, 1, 1)),
    "MaxPool3d_4a_3x3": ((32, 28, 28), (3, 3, 3), (2, 2, 2)),
    "MaxPool3d_5a_2x2": ((16, 14, 14), (2, 2, 2), (2, 2, 2)),
}


def _graph_pool(name):
    """The pad the builder gives the pool, from the graph at 64 x 224."""
    g = get_model("i3d_rgb_kinetics", num_frames=64, crop_size=224, batch=1)
    key = "Mixed_4c/Branch_3/MaxPool3d_0a_3x3" if name.startswith("Branch") else name
    return g.layer(key).opt("pad")


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool_geometry_is_tf_same(name):
    spatial, k, s = POOLS[name]
    x = torch.randn((1,) + spatial + (5,), generator=torch.Generator().manual_seed(5))
    got = pool.pool_nd(x, kernel=k, stride=s, pad=_graph_pool(name), mode="max")
    xt = x.movedim(-1, 1)
    tf_pads = []
    for size, kk, ss in reversed(list(zip(spatial, k, s))):
        tf_pads += list(ref.same_pads(size, kk, ss))
    want = F.max_pool3d(F.pad(xt, tf_pads, value=float("-inf")), k, s).movedim(1, -1)
    assert torch.equal(got, want)


def test_pool_bytes_by_hand():
    x = torch.randn(2, 8, 14, 14, 6, dtype=torch.bfloat16)
    before = COUNTS["pool.bytes"]
    pool.pool_nd(x, kernel=(3, 3, 3), stride=(2, 2, 2), pad=0, mode="max")   # -> (4, 7, 7)
    pool.pool_nd(x[:, 0], kernel=3, stride=1, pad=1, mode="ave")               # -> (14, 14)
    pool.pool_nd(x.to("meta"), kernel=2, stride=2, mode="max")                 # not counted
    by_hand = (2 * 8 * 14 * 14 * 6 + 2 * 4 * 7 * 7 * 6) * 2 + (2 * 14 * 14 * 6) * 2 * 2
    assert COUNTS["pool.bytes"] - before == by_hand


# -- the folds -----------------------------------------------------------------


def _stem_graph(eps=None):
    b = NetBuilder("stem")
    x = b.input("data", (2, 6, 10, 10, 3))
    x = b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0],
                scale=1 / 127.5)
    x = b.conv("stem", x, 4, k=(3, 5, 5), s=(2, 2, 2), p=[(0, 1), (1, 2), (1, 2)], bias=False)
    bn = b.layer("stem/batch_norm", "bn", x, **({} if eps is None else {"eps": eps}))
    b.layer("stem/relu", "relu", bn, tops=bn)
    return b.build()


def _init(g, seed=6):
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(seed),
                                         {"data": g.inputs["data"]})
    gen = torch.Generator().manual_seed(seed + 1)
    for d in list(p.values()) + list(s.values()):
        for k, v in d.items():
            lo, hi = {"gamma": (0.8, 1.2), "var": (0.8, 1.25)}.get(k, (-0.3, 0.3))
            d[k] = torch.rand(v.shape, generator=gen) * (hi - lo) + lo
    return p, s


def _run(g, p, s, x):
    with torch.no_grad():
        outs, _ = Program(g, device="cpu").apply(p, s, {"data": x})
    return next(iter(outs.values()))


def test_input_fold_equals_the_transform_layer():
    g = _stem_graph(eps=1e-3)
    p, s = _init(g)
    x = torch.randint(0, 256, g.inputs["data"]).float() - 127.5
    want = _run(g, p, s, x)
    g2, p2, s2 = fold_input_transform(g, p, s)
    assert [l.type for l in g2.layers] == ["convolution", "bn", "relu"]
    assert g2.layers[0].bottoms == ("data",)
    assert _rel(_run(g2, p2, s2, x), want) <= 1e-6
    assert g.layers[0].type == "input_transform" and p["stem"]["w"] is not p2["stem"]["w"]
    # after the BN fold too, in either order
    g3, p3, s3 = fold_input_transform(*fold_bn(g, p, s))
    assert _rel(_run(g3, p3, s3, x), want) <= 1e-6


def test_input_transform_with_another_reader_stays_a_layer():
    b = NetBuilder("two")
    x = b.layer("t", "input_transform", b.input("data", (1, 4, 4, 3)), channel_order=[2, 1, 0],
                scale=0.5)
    b.conv("c", x, 2, k=1)
    b.layer("r", "relu", x, tops="r")
    g = b.build()
    p, s = _init(g)
    g2, *_ = fold_input_transform(g, p, s)
    assert [l.type for l in g2.layers] == [l.type for l in g.layers]


@pytest.mark.parametrize("eps", [1e-3, None])
def test_fold_bn_folds_each_bn_with_its_own_eps(eps):
    g = _stem_graph(eps=eps)
    p, s = _init(g)
    x = torch.randn(g.inputs["data"], generator=torch.Generator().manual_seed(8))
    want = _run(g, p, s, x)
    g2, p2, s2 = fold_bn(g, p, s)
    assert "bn" not in [l.type for l in g2.layers]
    assert (_run(g2, p2, s2, x) - want).abs().max() <= 1e-5
    bn_p, bn_s = p["stem/batch_norm"], s["stem/batch_norm"]
    scale = bn_p["gamma"] / torch.sqrt(bn_s["var"] + (1e-5 if eps is None else eps))
    assert torch.equal(p2["stem"]["w"], p["stem"]["w"] * scale.reshape(-1, 1, 1, 1, 1))


def test_eco_bns_fold_with_the_default_eps():
    """ECO's BN layers carry no ``eps``: its folded weights are what a fold
    at 1e-5 for every BN gives, bit for bit, as before BNs had their own."""
    g = get_model("eco_lite_kinetics", num_segments=4, batch=1)
    assert all(l.opt("eps") is None for l in g.layers if l.type == "bn")
    p, s = _init(g)
    _, p2, _ = fold_bn(g, p, s)
    conv = "inception_3a_1x1"
    bn_p, bn_s = p[conv + "_bn"], s[conv + "_bn"]
    scale = bn_p["gamma"] / torch.sqrt(bn_s["var"] + 1e-5)
    assert torch.equal(p2[conv]["w"], p[conv]["w"] * scale.reshape(-1, 1, 1, 1))
    assert torch.equal(p2[conv]["b"], p[conv]["b"] * scale + (bn_p["beta"] - bn_s["mean"] * scale))


def test_siblings_with_other_eps_do_not_merge():
    from eco_tpu_torch.convert import merge_sibling_1x1_convs

    b = NetBuilder("sib")
    x = b.input("data", (1, 2, 4, 4, 6))
    outs = []
    for i, eps in enumerate((1e-3, 1e-3, 1e-5)):
        c = b.conv(f"c{i}", x, 3, k=(1, 1, 1), bias=False)
        bn = b.layer(f"c{i}/batch_norm", "bn", c, eps=eps)
        outs.append(b.layer(f"c{i}/relu", "relu", bn, tops=bn))
    b.concat("cat", outs)
    g = b.build()
    p, s = _init(g)
    g2, p2, s2 = merge_sibling_1x1_convs(g, p, s)
    merged = [l for l in g2.layers if l.name.endswith("__merged")]
    assert [l.name for l in merged] == ["c0__merged"] and merged[0].opt("num_output") == 6
    assert g2.layer("c0__merged_bn").opt("eps") == 1e-3 and "c2" in p2
    x = torch.randn(g.inputs["data"], generator=torch.Generator().manual_seed(9))
    assert torch.allclose(_run(g2, p2, s2, x), _run(g, p, s, x), rtol=1e-6, atol=1e-6)


def test_merged_i3d_modules_read_their_input_once():
    g = get_model("i3d_rgb_kinetics", num_frames=16, crop_size=224, batch=1)
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                         {"data": g.inputs["data"]})
    g2, p2, _ = optimize_for_inference(g, p, s)
    for name, widths in ref.MIXED:
        if widths is None:
            continue
        merged = g2.layer(f"{name}/Branch_0/Conv3d_0a_1x1__merged")
        assert merged.bottoms == g2.layer(f"{name}/Branch_3/MaxPool3d_0a_3x3").bottoms
        cin = p[f"{name}/Branch_0/Conv3d_0a_1x1"]["w"].shape[1]
        assert tuple(p2[merged.name]["w"].shape) == (
            widths[0] + widths[1] + widths[3], cin, 1, 1, 1)
    assert math.isclose(1 / 127.5, g.layer("input_transform").opt("scale"))


# -- the stem as space-to-depth ------------------------------------------------

# input (N, T, H, W, C), kernel, TF "SAME" pads at stride 2
S2D_STEMS = {
    # I3D's stem at 16 frames: (2, 3) on every axis, padded extents odd
    "i3d_stem_16": ((1, 16, 224, 224, 3), (7, 7, 7), ((2, 3), (2, 3), (2, 3))),
    # an odd size: symmetric pads, 231 padded
    "odd_225": ((1, 5, 225, 225, 3), (7, 7, 7), ((3, 3), (3, 3), (3, 3))),
    "5x5x5_two_channels": ((2, 9, 20, 17, 2), (5, 5, 5), ((2, 2), (1, 2), (2, 2))),
}


def _conv_graph(shape, cout, k, s, p, bias=True):
    b = NetBuilder("conv")
    x = b.conv("conv", b.input("data", shape), cout, k=k, s=s, p=p, bias=bias)
    b.layer("relu", "relu", x, tops=x)
    return b.build()


@pytest.mark.parametrize("case", sorted(S2D_STEMS))
def test_space_to_depth_fold_equals_the_strided_conv(case):
    shape, k, pads = S2D_STEMS[case]
    g = _conv_graph(shape, 16, k, 2, [list(p) for p in pads])
    p, s = _init(g)
    g2, p2, s2 = fold_space_to_depth(g, p, s)
    assert [l.type for l in g2.layers] == ["space_to_depth", "convolution", "relu"]
    cells, conv = g2.layers[:2]
    assert cells.bottoms == ("data",) and conv.bottoms == cells.tops
    assert [tuple(v) for v in cells.opt("pad")] == list(pads)
    assert conv.opt("kernel_size") == [(kk + 1) // 2 for kk in k] and conv.opt("stride") == 1
    assert p2["conv"]["w"].shape[1] == cells.opt("channels") >= 8 * shape[-1]
    assert torch.equal(p2["conv"]["b"], p["conv"]["b"])
    x = torch.randn(shape, generator=torch.Generator().manual_seed(10))
    want = _run(g, p, s, x)
    got = _run(g2, p2, s2, x)
    assert got.shape == want.shape and _rel(got, want) <= 1e-5


LEFT_ALONE = {
    "2d": ((1, 32, 32, 3), 7, 2),
    "8_channels": ((1, 6, 16, 16, 8), 7, 2),
    "stride_1": ((1, 6, 16, 16, 3), 7, 1),
    "even_kernel": ((1, 6, 16, 16, 3), 4, 2),
    "3x7x7": ((1, 6, 16, 16, 3), (3, 7, 7), 2),
}


@pytest.mark.parametrize("case", sorted(LEFT_ALONE))
def test_space_to_depth_fold_leaves_other_convs_alone(case):
    shape, k, stride = LEFT_ALONE[case]
    g = _conv_graph(shape, 4, k, stride, 1)
    p, s = _init(g)
    g2, p2, s2 = fold_space_to_depth(g, p, s)
    assert g2 is g and p2 is p and s2 is s


@pytest.mark.parametrize("model", ["eco_lite_kinetics", "eco_full_kinetics"])
def test_space_to_depth_fold_leaves_eco_alone(model):
    """ECO's 7x7/s2 stem is 2D: its optimized graph and params are those of
    the folds before this one."""
    g = get_model(model, num_segments=4, batch=1)
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                         {"data": g.inputs["data"]})
    before = fold_input_transform(*fold_bn(*merge_sibling_1x1_convs(g, p, s)))
    after = optimize_for_inference(g, p, s)
    assert after[0].layers == before[0].layers and after[0].inputs == before[0].inputs
    assert after[1].keys() == before[1].keys()
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(after[1].values(), before[1].values()))
    assert "space_to_depth" not in {l.type for l in after[0].layers}


def _space_to_depth_by_loops(x, block, pads, channels):
    """An output cell at a time, an offset at a time, from the unpadded
    input: the plain version's function without its pad, view or permute."""
    n, *spatial, c = x.shape
    cells = [-(-(size + lo + hi) // b) for size, b, (lo, hi) in zip(spatial, block, pads)]
    out = torch.zeros((n, *cells, channels), dtype=x.dtype)
    offsets = list(itertools.product(*[range(b) for b in block]))
    for cell in itertools.product(*[range(m) for m in cells]):
        for i, off in enumerate(offsets):
            src = [q * b + o - lo for q, b, o, (lo, _) in zip(cell, block, off, pads)]
            if all(0 <= v < size for v, size in zip(src, spatial)):
                out[(slice(None), *cell, slice(i * c, (i + 1) * c))] = x[
                    (slice(None), *src, slice(None))]
    return out


# extents padded to even and to odd sizes (the last cell then completed
# with zeros), a 2D block, widths with zero channels, integers
@pytest.mark.parametrize("shape,block,pads,channels,dtype", [
    ((2, 5, 6, 7, 3), (2, 2, 2), ((2, 3), (2, 4), (2, 3)), 24, torch.float32),
    ((1, 4, 5, 3, 2), (2, 2, 2), ((0, 0), (1, 0), (0, 1)), 32, torch.bfloat16),
    ((2, 7, 6, 3), (2, 2), ((3, 4), (1, 1)), 16, torch.float32),
    ((1, 3, 4, 5, 3), (2, 2, 2), ((1, 0), (0, 0), (2, 1)), 24, torch.int8),
    ((1, 4, 4, 4, 1), (2, 2, 2), ((1, 0), (0, 1), (2, 3)), 8, torch.float32),
])
def test_plain_space_to_depth_equals_loops(shape, block, pads, channels, dtype):
    x = torch.randint(-100, 100, shape, generator=torch.Generator().manual_seed(11)).to(dtype)
    got = s2d.space_to_depth(x, block, pads, channels)
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, _space_to_depth_by_loops(x, block, pads, channels))
    assert tuple(got.shape) == s2d.out_shape(x.shape, block, pads, channels)
    assert s2d.space_to_depth(x.to("meta"), block, pads, channels).shape == got.shape


def test_int8_path_runs_on_the_folded_graph(weights_and_reference):
    """``quantize_for_serving`` of the optimized graph, as the benchmark's
    control quantizes it: the stem is an int8 conv reading the
    space-to-depth cells, which the int8 input plane feeds int8."""
    params, state, (frames, h_off, w_off, mirror), want = weights_and_reference
    g, p, s = optimize_for_inference(
        get_model("i3d_rgb_kinetics", num_frames=16, crop_size=224, batch=2), params, state)
    clips = preprocess_on_device(frames, h_off, w_off, mirror, crop=224, mean=MEAN,
                                 out_dtype=torch.float32)
    qprog, qp, qs, report = quantize_for_serving(Program(g, device="cpu"), p, s,
                                                 [{"data": clips}], fold=False)
    stem = qprog.graph.layer("Conv3d_1a_7x7")
    assert stem.type == "qconvolution" and stem.bottoms == ("Conv3d_1a_7x7/space_to_depth",)
    server = UInt8Server(qprog, qp, qs, crop=224, mean=MEAN, output="averaged_logits")
    assert server.in_scale is not None
    with torch.no_grad():
        got = server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
    assert got.shape == want.shape and torch.isfinite(got).all()
