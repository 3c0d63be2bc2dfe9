"""Video Swin-B in the port (``models/video_swin.py``, zoo entry
``video_swin_b_kinetics``) against the plain reference of
``tests/reference_video_swin.py`` on seeded random weights, and what the
port gained for it: the token layers (layer norm, GELU, window pad,
shifted-window attention, patch merging), token-wise InnerProducts float
and int8, the per-channel input transform and its fold, and the
``eco.window`` / ``eco.attn`` spans with the ``attn.*`` counters.

Tolerance of the whole net in float32: relative L2 of the logits 1e-4, the
summation order of some 40 layers of products and norms (5e-6 measured;
a bfloat16 program misses it a hundredfold and more).  The float32
comparisons feed the program float32 clips from K1 (``out_dtype``): the
serving plane's bfloat16 clips round ``x - mean`` by up to a quarter of a
grey level where the mean is not a multiple of one half (ImageNet's is
not), which alone moves these random-weight logits by some 1e-2.

Sizes: C = 32 (head dimension 32 at one head), depths [2, 2, 2, 2], the
published window (8, 7, 7) and patch (2, 4, 4).  ``GEOMETRIES`` force a
padded temporal axis with a shift, padded spatial axes in the first two
stages, and spatial axes clipped to the grid (no spatial shift) in the last
two; and a clip whose temporal axis is clipped too.
"""

import hashlib
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import fold_input_transform, optimize_for_inference
from eco_tpu_torch.convert.quantize import quantize_for_serving
from eco_tpu_torch.models import get_model
from eco_tpu_torch.ops import attention
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.netspec import NetBuilder
from eco_tpu_torch.utils.tracing import COUNTS

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
import reference_video_swin as ref  # noqa: E402

SMALL = dict(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8])
MEAN_BGR = (103.53, 116.28, 123.675)
STD_RGB = (58.395, 57.12, 57.375)
# (frames, crop): token grids by stage
GEOMETRIES = {
    # (10, 15, 15) (10, 8, 8) (10, 4, 4) (10, 2, 2): T padded to 16 and shifted
    # by 4, H and W padded to 21 and 14, then clipped to 4 and 2
    "padded": (20, 60),
    # (4, 8, 8) (4, 4, 4) ...: T clipped to 4, no temporal shift
    "short": (8, 32),
}
TOL = 1e-4


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


def _cfg(frames, crop, **kw):
    return dict(num_classes=400, num_segments=frames, crop_size=crop, mean_bgr=list(MEAN_BGR),
                std_rgb=list(STD_RGB), **{**SMALL, **kw})


def _frames(n, t, h, w, g):
    """Smooth random frames, as the benchmark's traffic draws them: uniform
    noise makes every token alike to a net."""
    from portbench import load

    spec = json.loads((ROOT / "portbench" / "traffic" / "closed_batch12.json").read_text())
    return load.smooth_frames((n, t, h, w, 3), spec["frames"], g, "cpu")


def _model(frames, crop, batch=2, **kw):
    return get_model("video_swin_b_kinetics", num_frames=frames, crop_size=crop, batch=batch,
                     **{**SMALL, **kw})


# -- the graph ---------------------------------------------------------------


def _macs(graph, params):
    """Multiply-adds of the graph from the shapes of one meta run: every
    conv and InnerProduct, and the attention's (``attn.flops`` / 2)."""
    meta = {ln: {k: v.to("meta") for k, v in d.items()} for ln, d in params.items()}
    names = [l.tops[0] for l in graph.layers if l.type in ("convolution", "innerproduct")]
    before = COUNTS["attn.flops"]
    outs, _ = Program(graph, device="meta").apply(
        meta, {}, {"data": torch.empty(graph.inputs["data"], device="meta")}, capture=names)
    attn = (COUNTS["attn.flops"] - before) / 2
    macs = 0
    for l in graph.layers:
        if l.type in ("convolution", "innerproduct"):
            w = params[l.name]["w"]
            macs += math.prod(outs[l.tops[0]].shape[:-1]) * w[0].numel() * w.shape[0]
    return macs, attn, outs


def test_graph_at_the_published_size():
    g = get_model("video_swin_b_kinetics", batch=1)
    params, state = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                                   {"data": g.inputs["data"]})
    assert state == {}
    assert sum(t.numel() for d in params.values() for t in d.values()) == 88_048_984
    specs, stats = ref.param_specs(ref.net({}), {})
    assert stats == []
    assert {(s.layer, s.name): s.shape for s in specs} == {
        (ln, pn): tuple(t.shape) for ln, d in params.items() for pn, t in d.items()}
    macs, attn, outs = _macs(g, params)
    assert (macs + attn) / 1e9 == pytest.approx(281.33, abs=0.005)
    assert attn / 1e9 == pytest.approx(39.02, abs=0.005)
    # token grids 16x56x56 at C = 128, then 12,544, 3,136 and 784 tokens
    for i, (grid, c) in enumerate(zip([(16, 56, 56), (16, 28, 28), (16, 14, 14), (16, 7, 7)],
                                      (128, 256, 512, 1024))):
        assert tuple(outs[f"layers.{i}.blocks.1.attn.proj"].shape) == (1,) + grid + (c,)
    assert tuple(outs["cls_head.fc_cls"].shape) == (1, 400)
    attn_layers = [l for l in g.layers if l.type == "window_attention"]
    assert len(attn_layers) == 24 and not any(l.type == "window_pad" for l in g.layers)
    assert [l.opt("heads") for l in attn_layers] == [4] * 2 + [8] * 2 + [16] * 18 + [32] * 2
    assert all(l.opt("window") == [8, 7, 7] for l in attn_layers)
    # every odd block shifted by (4, 3, 3); the last stage's 7 x 7 is the window
    assert [l.opt("shift") for l in attn_layers[1::2]] == [[4, 3, 3]] * 11 + [[4, 0, 0]]
    assert all(l.opt("shift") == [0, 0, 0] for l in attn_layers[0::2])
    assert all(l.opt("eps") == 1e-5 for l in g.layers if l.type == "layer_norm")
    assert g.layer("patch_embed.proj").opt("kernel_size") == [2, 4, 4]
    assert g.layer("patch_embed.proj").opt("stride") == [2, 4, 4]


# -- the program against the reference ----------------------------------------


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    frames, crop = GEOMETRIES[request.param]
    cfg = _cfg(frames, crop)
    net = ref.net(cfg)
    specs, _ = ref.param_specs(net, cfg)
    g = torch.Generator().manual_seed(2**31 + 23)
    params = draw(specs, g)
    raw = _frames(2, frames, crop + 8, crop + 12, g)
    aug = ([3, 8], [12, 0], [1, 0])
    with torch.no_grad():
        want = ref.forward(net, params, {}, ref.clips(cfg, raw, *aug))
    return frames, crop, params, raw, aug, want


def _clips_f32(raw, aug, crop):
    return preprocess_on_device(raw, *aug, crop=crop, mean=MEAN_BGR, out_dtype=torch.float32)


@pytest.mark.parametrize("optimized", [False, True], ids=["unfolded", "optimized"])
def test_program_matches_the_reference_in_float32(case, optimized):
    frames, crop, params, raw, aug, want = case
    g, p, s = _model(frames, crop), params, {}
    if optimized:
        g, p, s = optimize_for_inference(g, p, s)
        assert "input_transform" not in [l.type for l in g.layers]
    with torch.no_grad():
        outs, _ = Program(g, compute_dtype=torch.float32, device="cpu").apply(
            p, s, {"data": _clips_f32(raw, aug, crop)}, capture=["cls_head.fc_cls"])
    got = outs["cls_head.fc_cls"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= TOL


def test_serving_in_bfloat16_misses_the_float32_tolerance(case):
    frames, crop, params, raw, aug, want = case
    g, p, s = optimize_for_inference(_model(frames, crop), params, {})
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device="cpu"), p, s,
                         crop=crop, mean=MEAN_BGR, output="cls_head.fc_cls")
    with torch.no_grad():
        got = server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
    assert got.dtype == torch.bfloat16
    assert 100 * TOL < _rel(got.float(), want) < 0.5


def test_padded_geometry_pads_and_clips():
    g = _model(*GEOMETRIES["padded"])
    pads = {l.name: l.opt("pads") for l in g.layers if l.type == "window_pad"}
    assert pads["layers.0.blocks.0.attn.pad"] == [6, 6, 6]
    assert pads["layers.1.blocks.1.attn.pad"] == [6, 6, 6]
    # the clipped spatial windows are whole; T stays 10 and pads in every stage
    assert pads["layers.2.blocks.0.attn.pad"] == pads["layers.3.blocks.1.attn.pad"] == [6, 0, 0]
    attn = {l.name: (l.opt("window"), l.opt("shift")) for l in g.layers
            if l.type == "window_attention"}
    assert attn["layers.0.blocks.1.attn"] == ([8, 7, 7], [4, 3, 3])
    assert attn["layers.2.blocks.1.attn"] == ([8, 4, 4], [4, 0, 0])
    assert attn["layers.3.blocks.1.attn"] == ([8, 2, 2], [4, 0, 0])
    short = {l.name: (l.opt("window"), l.opt("shift")) for l in _model(*GEOMETRIES["short"]).layers
             if l.type == "window_attention"}
    assert short["layers.0.blocks.1.attn"] == ([4, 7, 7], [0, 3, 3])


def test_attention_weights_are_informative():
    """The reference's draws keep the attention neither nearly uniform nor
    nearly one-hot: a query's logits (q k^T / sqrt(d) + bias) spread by
    roughly 1-3 over the keys its mask keeps, in every block, on smooth
    frames; C = 64 keeps the head dimension 32 with two heads."""
    cfg = _cfg(16, 56, embed_dim=64, num_heads=[2, 4, 8, 16])
    net = ref.net(cfg)
    params = draw(ref.param_specs(net, cfg)[0], torch.Generator().manual_seed(7))
    raw = _frames(1, 16, 64, 64, torch.Generator().manual_seed(8))
    probe = []
    with torch.no_grad():
        ref.forward(net, params, {}, ref.clips(cfg, raw, [4], [4], [0]), probe)
    spreads = dict(probe)
    assert len(spreads) == 8
    assert all(0.5 <= v <= 4.0 for v in spreads.values()), spreads
    assert 1.0 <= sum(spreads.values()) / len(spreads) <= 3.0, spreads


# -- the attention op ------------------------------------------------------------


@pytest.mark.parametrize("grid,window,shift", [
    ((8, 14, 14), (8, 7, 7), (4, 3, 3)),
    ((16, 7, 7), (8, 7, 7), (4, 0, 0)),
    ((4, 8, 8), (4, 4, 4), (0, 2, 2)),
])
def test_shift_mask_and_index_are_the_published(grid, window, shift):
    assert torch.equal(attention.shift_mask(grid, window, shift),
                       ref.compute_mask(*grid, window, shift, "cpu"))
    assert torch.equal(attention.relative_position_index(window),
                       ref.relative_position_index(window))


@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 3, 3)], ids=["plain", "shifted"])
def test_window_attention_equals_the_published_block_part(shift):
    """qkv, then the op, then proj: the published attention of a block
    (``forward_part1`` less its norm) at a 16 x 14 x 14 grid, 2 heads."""
    g = torch.Generator().manual_seed(3)
    n, c, heads, window = 2, 64, 2, (8, 7, 7)
    grid = (16, 14, 14)
    x = torch.randn((n,) + grid + (c,), generator=g)
    rows = 15 * 13 * 13
    p = {"attn": {"relative_position_bias_table": torch.rand(rows, heads, generator=g) * 2 - 1},
         "attn.qkv": {"w": torch.randn(3 * c, c, generator=g) / 8,
                      "b": torch.randn(3 * c, generator=g) / 10},
         "attn.proj": {"w": torch.eye(c), "b": torch.zeros(c)}}
    qkv = torch.nn.functional.linear(x, p["attn.qkv"]["w"], p["attn.qkv"]["b"])
    got = attention.window_attention(qkv, p["attn"]["relative_position_bias_table"],
                                     heads=heads, window=window, shift=shift,
                                     table_window=window, size=grid)
    shifted = torch.roll(x, tuple(-s for s in shift), (1, 2, 3)) if any(shift) else x
    mask = ref.compute_mask(*grid, window, shift, "cpu") if any(shift) else None
    wins = ref.window_attention(p, "attn", ref.window_partition(shifted, window), heads, window,
                                mask, None)
    want = ref.window_reverse(wins.view(-1, *window, c), window, n, *grid)
    if any(shift):
        want = torch.roll(want, shift, (1, 2, 3))
    assert _rel(got, want) <= 1e-5


def test_the_bias_is_gathered_once_per_table():
    table = torch.rand(15 * 13 * 13, 2)
    a = attention.attention_bias(table, (8, 7, 7), (8, 7, 7), (8, 14, 14), (4, 3, 3),
                                 torch.bfloat16)
    b = attention.attention_bias(table, (8, 7, 7), (8, 7, 7), (8, 14, 14), (4, 3, 3),
                                 torch.bfloat16)
    assert a is b and a.shape == (1, 2 * 4, 392, 392) and a.dtype == torch.bfloat16
    plain = attention.attention_bias(table, (8, 7, 7), (8, 7, 7), (8, 14, 14), (0, 0, 0),
                                     torch.float32)
    assert plain.shape == (1, 2, 392, 392)
    table.add_(1.0)  # a changed table gathers anew
    c = attention.attention_bias(table, (8, 7, 7), (8, 7, 7), (8, 14, 14), (4, 3, 3),
                                 torch.bfloat16)
    assert c is not a and torch.allclose(c.float(), a.float() + 1.0, atol=0.07)
    key = id(table)
    del table, a, b, c, plain
    assert key not in attention._BIAS


# (grid, window, shift, table window): the published shifted and unshifted
# blocks, a shift on T only (Swin-B's last stage), on H and W only, on one
# axis only with a window clipped below its table window, and unequal windows
INDEX_GEOMETRIES = [
    ((8, 14, 14), (8, 7, 7), (4, 3, 3), (8, 7, 7)),
    ((16, 14, 14), (8, 7, 7), (0, 0, 0), (8, 7, 7)),
    ((16, 7, 7), (8, 7, 7), (4, 0, 0), (8, 7, 7)),
    ((4, 8, 8), (4, 4, 4), (0, 2, 2), (4, 4, 4)),
    ((8, 8, 8), (8, 4, 4), (0, 2, 0), (8, 7, 7)),
    ((6, 8, 10), (2, 4, 5), (1, 0, 2), (3, 4, 5)),
]


def _by_index(qkv, table, heads, window, shift, table_window, size):
    """The window attention as K6 computes it, in float32: q, k and v read
    from the tokens by ``window_indices``' token, the bias by its offsets,
    the mask by its regions, each output row written to its token, then the
    crop."""
    n, t, h, w, c3 = qkv.shape
    d = c3 // 3 // heads
    token, offset, region = attention.window_indices((t, h, w), window, shift, table_window)
    rows = table.shape[0]
    rel = offset[:, None] - offset[None, :] + (rows - 1) // 2
    bias = table.float()[rel].permute(2, 0, 1)                          # heads, L, L
    mask = torch.where(region[:, :, None] != region[:, None, :], attention.MASK_VALUE, 0.0)
    x = qkv.float().reshape(n, t * h * w, 3, heads, d)[:, token]        # n, win, L, 3, heads, d
    q, k, v = x.permute(3, 0, 1, 4, 2, 5)                               # n, win, heads, L, d
    logits = q @ k.transpose(-1, -2) / math.sqrt(d) + bias + mask[None, :, None]
    o = logits.softmax(-1) @ v                                          # n, win, heads, L, d
    out = torch.empty(n, t * h * w, heads, d)
    out[:, token.reshape(-1)] = o.permute(0, 1, 3, 2, 4).reshape(n, -1, heads, d)
    return out.view(n, t, h, w, heads * d)[:, :size[0], :size[1], :size[2]]


@pytest.mark.parametrize("grid,window,shift,table_window", INDEX_GEOMETRIES)
def test_window_indices_give_the_routes_order_bias_and_mask(grid, window, shift, table_window):
    """K6's index arithmetic (``window_indices``) against the route's
    tensors: the tokens each window position reads (``_window_order``), the
    relative index (``relative_position_index`` at its first L rows and
    columns), the gathered bias with the mask (``_gather_bias``), and the
    mask alone (``shift_mask``)."""
    length = math.prod(window)
    token, offset, region = attention.window_indices(grid, window, shift, table_window)
    assert torch.equal(token.reshape(-1), attention._window_order(grid, window, shift, "cpu"))
    rows = math.prod(2 * w - 1 for w in table_window)
    rel = offset[:, None] - offset[None, :] + (rows - 1) // 2
    assert torch.equal(rel, attention.relative_position_index(table_window)[:length, :length])
    mask = torch.where(region[:, :, None] != region[:, None, :], attention.MASK_VALUE, 0.0)
    if any(shift):
        assert torch.equal(mask, attention.shift_mask(grid, window, shift))
    else:
        assert not mask.any()
    heads = 3
    table = torch.rand(rows, heads, generator=torch.Generator().manual_seed(5)) * 2 - 1
    bias = table[rel].permute(2, 0, 1)                                  # heads, L, L
    want = attention._gather_bias(table, window, table_window, grid, shift)
    got = (bias[:, None] + mask[None]).flatten(0, 1) if any(shift) else bias
    assert torch.equal(got, want)


@pytest.mark.parametrize("grid,window,shift,table_window,size", [
    ((8, 14, 14), (8, 7, 7), (4, 3, 3), (8, 7, 7), (8, 14, 14)),
    ((16, 7, 7), (8, 7, 7), (4, 0, 0), (8, 7, 7), (16, 7, 7)),
    ((8, 8, 8), (8, 4, 4), (0, 2, 0), (8, 7, 7), (8, 8, 8)),
    ((6, 8, 10), (2, 4, 5), (1, 0, 2), (3, 4, 5), (5, 7, 10)),
])
def test_attention_by_index_equals_the_route(grid, window, shift, table_window, size):
    """The attention computed from ``window_indices`` alone (K6's
    arithmetic: gather, bias and mask by index, scatter, crop) equals the
    route's (copies, gathered bias, the library's attention) in float32 on
    the CPU, also with a clipped window, unequal windows and a crop."""
    g = torch.Generator().manual_seed(9)
    heads = 2
    qkv = torch.randn((2, *grid, 3 * heads * 8), generator=g)
    table = torch.rand(math.prod(2 * w - 1 for w in table_window), heads, generator=g) * 2 - 1
    kw = dict(heads=heads, window=window, shift=shift, table_window=table_window, size=size)
    want = attention.window_attention(qkv, table, **kw)
    assert _rel(_by_index(qkv, table, **kw), want) <= 1e-5


def test_the_cpu_takes_the_route_and_builds_nothing(monkeypatch):
    """On the CPU ``window_attention`` is the plain route: no nvcc, no K6
    launch counted."""
    def no_build(name):
        raise AssertionError(f"built {name} on the CPU")

    monkeypatch.setattr(attention._build, "load", no_build)
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn((1, 8, 14, 14, 3 * 64), generator=g).bfloat16()
    table = torch.rand(15 * 13 * 13, 2, generator=g)
    kw = dict(heads=2, window=(8, 7, 7), shift=(4, 3, 3), table_window=(8, 7, 7),
              size=(8, 14, 14))
    before = COUNTS["k6.launches"]
    got = attention.window_attention(qkv, table, **kw)
    assert COUNTS["k6.launches"] == before
    assert torch.equal(got, attention.window_attention_reference(qkv, table, **kw))


def test_spans_and_counters_of_one_request():
    g = _model(8, 28, batch=1)
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                         {"data": g.inputs["data"]})
    clips = torch.zeros(g.inputs["data"])
    prog = Program(g, device="cpu")
    before = COUNTS.copy()
    with torch.no_grad(), torch.profiler.profile() as prof:
        prog.apply(p, s, {"data": clips})
    counts = COUNTS - before
    names = [e.name for e in prof.events()]
    assert names.count("eco.attn") == 8
    # a partition and a reverse each block; no pads at this geometry
    assert names.count("eco.window") == 16
    # by hand: stage grids (4, 7, 7) (4, 4, 4) (4, 2, 2) (4, 1, 1), each one
    # window clipped to the grid, so no shift; d = 32, heads 1, 2, 4, 8, two
    # blocks a stage; q, k, v and the output 4 bytes a value, the bias too
    stages = list(zip((1, 2, 4, 8), (196, 64, 16, 4)))
    assert counts["attn.flops"] == sum(2 * 4 * heads * n * n * 32 for heads, n in stages)
    qkvo = sum(2 * 4 * heads * n * 32 * 4 for heads, n in stages)
    bias = sum(2 * heads * n * n * 4 for heads, n in stages)
    assert counts["attn.bytes"] == qkvo + bias


# -- the input transform -----------------------------------------------------------


def test_per_channel_input_fold_equals_the_transform_layer():
    b = NetBuilder("t")
    x = b.input("data", (2, 6, 12, 12, 3))
    x = b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0],
                scale=[1.0 / s for s in STD_RGB])
    b.conv("proj", x, 8, k=[2, 4, 4], s=[2, 4, 4], p=[[0, 0], [0, 0], [0, 0]])
    g = b.build()
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(1),
                                         {"data": g.inputs["data"]})
    clips = torch.randn(g.inputs["data"], generator=torch.Generator().manual_seed(2)) * 60
    folded = fold_input_transform(g, p, s)
    assert [l.type for l in folded[0].layers] == ["convolution"]
    want = Program(g, device="cpu").apply(p, s, {"data": clips})[0]["proj"]
    got = Program(folded[0], device="cpu").apply(folded[1], folded[2], {"data": clips})[0]["proj"]
    assert _rel(got, want) <= 1e-6


def test_input_transform_refuses_scales_of_another_count():
    b = NetBuilder("t")
    x = b.input("data", (1, 2, 4, 4, 3))
    b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0], scale=[1.0, 2.0])
    g = b.build()
    with pytest.raises(ValueError, match="2 scales for 3 channels"):
        Program(g, device="cpu").apply({}, {}, {"data": torch.zeros(1, 2, 4, 4, 3)})


# -- int8 --------------------------------------------------------------------------


def test_the_int8_path_quantizes_every_linear(case):
    frames, crop, params, raw, aug, want = case
    g, p, s = optimize_for_inference(_model(frames, crop), params, {})
    calib = [{"data": _clips_f32(raw, aug, crop)}]
    prog = Program(g, compute_dtype=torch.float32, device="cpu")
    qprog, qp, qs, report = quantize_for_serving(prog, p, s, calib, fold=False)
    linears = {l.name for l in g.layers if l.type in ("innerproduct", "convolution")}
    assert set(report["quantized"]) == linears
    assert len(linears) == 4 * 8 + 3 + 2  # 4 a block, 3 reductions, the embedding, fc_cls
    assert all(qp[n]["w"].dtype == torch.int8 for n in linears)
    # the output projections hand int8 to the residual adds
    assert {n for n in report["chained"] if n.endswith("attn.proj")}
    server = UInt8Server(qprog, qp, qs, crop=crop, mean=MEAN_BGR, output="cls_head.fc_cls")
    with torch.no_grad():
        got = server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
    assert server.in_scale is not None  # the patch embedding reads K1's int8 clips
    assert 1e-2 < _rel(got.float(), want) < 0.5


# -- the other models' graphs --------------------------------------------------------


def _digest(name, **kw):
    """sha256 of a zoo graph after ``optimize_for_inference`` on weights
    from a fixed seed: its layers and the bytes of its params and state."""
    graph = get_model(name, **kw)
    p, s = Program(graph, device="cpu").init(torch.Generator().manual_seed(11),
                                             {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, p, s)
    h = hashlib.sha256()
    for l in g.layers:
        h.update(repr((l.name, l.type, l.bottoms, l.tops, sorted(l.options.items()))).encode())
    for tree in (p, s):
        for ln in sorted(tree):
            for pn in sorted(tree[ln]):
                t = tree[ln][pn].contiguous()
                h.update(f"{ln}/{pn}{tuple(t.shape)}{t.dtype}".encode())
                h.update(t.numpy().tobytes())
    return h.hexdigest()


# the digests of the parent of the change that added Video Swin, which these
# graphs must keep: the same layers, options and parameters
UNCHANGED = {
    "eco_lite_kinetics": (dict(batch=1, num_segments=4, crop_size=112),
                          "eca9cca3699185c5ccf902bb55a68e20cf30ff7d41ab0e00adc901f5448922df"),
    "eco_full_kinetics": (dict(batch=1, num_segments=4, crop_size=224),
                          "8030477d658ca4c5285119f2de2e5e4246b7f82f8b339843dc40004a17a45ea6"),
    "i3d_rgb_kinetics": (dict(batch=1, num_frames=16, crop_size=224),
                         "89549a13ff65597c7d5ff2b5f04a0b1f0f5a87a1bdb13af6b6b8274f7d82298f"),
}


@pytest.mark.parametrize("name", sorted(UNCHANGED))
def test_other_models_come_out_of_optimize_for_inference_unchanged(name):
    kw, want = UNCHANGED[name]
    assert _digest(name, **kw) == want
