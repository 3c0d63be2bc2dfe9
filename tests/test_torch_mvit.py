"""MViTv2-B in the port (``models/mvit.py``, zoo entry
``mvit_v2_b_kinetics``) against the plain reference of
``tests/reference_mvit.py`` on seeded random weights, and what the port
gained for it: tokens as rows with a class token (``cls_token``,
``cls_select``), the pooling attention with decomposed relative positions
(``pooled_attention``, ``ops/pooled_attention.py``), the skip path's max pool
over the grid rows (``token_pool``), the fold of the input transform into
the padded patch embedding, the int8 path, and the ``eco.qkv_pool`` /
``eco.pattn`` spans with the ``pattn.*`` counters.

Tolerance of the whole net in float32: relative L2 of the logits 1e-4, the
summation order of some 25 layers of products, norms and pools (5e-7
measured; a bfloat16 program misses it a hundredfold and more).  The
float32 comparisons feed the program float32 clips from K1
(``out_dtype``): the serving plane's bfloat16 clips round ``x - 114.75``.

Sizes (``SMALL``): 4 blocks, width 32 -> 64 -> 128 and heads 1 -> 2 -> 4
at blocks 1 and 3 (d = 32, q stride (1, 2, 2) there), the kv stride from
(1, 4, 4); 8 frames at 64 x 64 give grids (4, 16, 16) -> (4, 8, 8) -> (4,
4, 4).  Block 0 has keys coarser than its queries (16 -> 4), block 1 equal
sizes, block 2 keys coarser (8 -> 4), block 3 queries coarser (4 against
kv stride 1's 8): every ratio of the published distance, the class token,
the residual pooling and the skip's max pool with and without a width
change.
"""

import collections
import functools
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import fold_input_transform, optimize_for_inference
from eco_tpu_torch.convert.quantize import quantize_for_serving
from eco_tpu_torch.models import get_model
from eco_tpu_torch.ops import pooled_attention as pa
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.netspec import NetBuilder
from eco_tpu_torch.utils.tracing import COUNTS

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
import reference_mvit as ref  # noqa: E402
from test_torch_video_swin import _digest, _frames, _rel, draw  # noqa: E402

SMALL = dict(embed_dim=32, depth=4, num_heads=1, dim_mul_blocks=[1, 3], kv_stride=[1, 4, 4])
MEAN = (114.75,) * 3
STD = 57.375
FRAMES, CROP = 8, 64
TOL = 1e-4


def _cfg(frames=FRAMES, crop=CROP, **kw):
    return dict(num_classes=400, num_segments=frames, crop_size=crop, mean_bgr=list(MEAN),
                std_rgb=[STD] * 3, **{**SMALL, **kw})


def _model(frames=FRAMES, crop=CROP, batch=2, **kw):
    return get_model("mvit_v2_b_kinetics", num_frames=frames, crop_size=crop, batch=batch,
                     **{**SMALL, **kw})


# -- the graph ---------------------------------------------------------------


def _macs(graph, params):
    """Multiply-adds of the graph from the shapes of one meta run: every
    conv and InnerProduct, the pooling convs from each attention layer's
    grids, and the core's (``pattn.flops`` / 2)."""
    meta = {ln: {k: v.to("meta") for k, v in d.items()} for ln, d in params.items()}
    names = [l.tops[0] for l in graph.layers if l.type in ("convolution", "innerproduct")]
    names += [l.tops[0] for l in graph.layers if l.type == "pooled_attention"]
    before = COUNTS["pattn.flops"]
    outs, _ = Program(graph, device="meta").apply(
        meta, {}, {"data": torch.empty(graph.inputs["data"], device="meta")}, capture=names)
    core = (COUNTS["pattn.flops"] - before) / 2
    macs = pool = 0
    for l in graph.layers:
        if l.type in ("convolution", "innerproduct"):
            w = params[l.name]["w"]
            macs += math.prod(outs[l.tops[0]].shape[:-1]) * w[0].numel() * w.shape[0]
        if l.type == "pooled_attention":
            q, k = (pa.pooled_size(l.opt("size"), l.opt("kernel"), l.opt(s), [1, 1, 1])
                    for s in ("stride_q", "stride_kv"))
            c = outs[l.tops[0]].shape[-1]
            pool += c * math.prod(l.opt("kernel")) * (math.prod(q) + 2 * math.prod(k))
    return macs, pool, core, outs


def test_graph_at_the_published_size():
    g = get_model("mvit_v2_b_kinetics", batch=1)
    params, state = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                                   {"data": g.inputs["data"]})
    assert state == {}
    assert sum(t.numel() for d in params.values() for t in d.values()) == 51_230_128
    cfg = {"num_segments": 32, "crop_size": 224}
    specs, stats = ref.param_specs(ref.net({}), cfg)
    assert stats == []
    assert {(s.layer, s.name): s.shape for s in specs} == {
        (ln, pn): tuple(t.shape) for ln, d in params.items() for pn, t in d.items()}
    macs, pool, core, outs = _macs(g, params)
    assert (macs + pool + core) / 1e9 == pytest.approx(224.47, abs=0.005)
    assert pool / 1e9 == pytest.approx(1.59, abs=0.005)
    assert core / 1e9 == pytest.approx(79.40 + 1.20, abs=0.01)
    attn = [l for l in g.layers if l.type == "pooled_attention"]
    assert len(attn) == 24
    # queries and keys of each block, class token included
    queries = [outs[l.tops[0]].shape[1] for l in attn]
    keys = [1 + math.prod(pa.pooled_size(l.opt("size"), [3, 3, 3], l.opt("stride_kv"),
                                         [1, 1, 1])) for l in attn]
    assert queries == [50177] * 2 + [12545] * 3 + [3137] * 16 + [785] * 3
    assert keys == [785] * 2 + [3137] + [785] * 2 + [3137] + [785] * 15 + [3137] + [785] * 2
    assert [l.opt("heads") for l in attn] == [1] * 2 + [2] * 3 + [4] * 16 + [8] * 3
    assert [outs[l.tops[0]].shape[-1] // l.opt("heads") for l in attn] == [96] * 24
    strided = [i for i, l in enumerate(attn) if l.opt("stride_q") == [1, 2, 2]]
    assert strided == [2, 5, 21]
    assert [l.opt("stride_kv") for l in attn] == (
        [[1, 8, 8]] * 2 + [[1, 4, 4]] * 3 + [[1, 2, 2]] * 16 + [[1, 1, 1]] * 3)
    assert all(l.opt("kernel") == [3, 3, 3] for l in attn)
    pools = [l for l in g.layers if l.type == "token_pool"]
    assert [l.name for l in pools] == [f"blocks.{i}.pool_skip" for i in strided]
    assert all((l.opt("kernel_size"), l.opt("stride"), l.opt("pad")) == (
        [1, 3, 3], [1, 2, 2], [0, 1, 1]) for l in pools)
    assert all(l.opt("eps") == 1e-6 for l in g.layers if l.type == "layer_norm")
    conv = g.layer("patch_embed.proj")
    assert (conv.opt("kernel_size"), conv.opt("stride"), conv.opt("pad")) == (
        [3, 7, 7], [2, 4, 4], [1, 3, 3])
    assert tuple(outs["patch_embed.proj"].shape) == (1, 16, 56, 56, 96)
    assert tuple(outs["head.projection"].shape) == (1, 400)
    assert [l.type for l in g.layers][-4:] == ["layer_norm", "cls_select", "innerproduct",
                                               "softmax"]


# -- the program against the reference ----------------------------------------


@pytest.fixture(scope="module")
def case():
    cfg = _cfg()
    net = ref.net(cfg)
    g = torch.Generator().manual_seed(2**31 + 25)
    params = draw(ref.param_specs(net, cfg)[0], g)
    raw = _frames(2, FRAMES, CROP + 8, CROP + 12, g)
    aug = ([3, 8], [12, 0], [1, 0])
    with torch.no_grad():
        want = ref.forward(net, params, {}, ref.clips(cfg, raw, *aug))
    return params, raw, aug, want


def _clips_f32(raw, aug):
    return preprocess_on_device(raw, *aug, crop=CROP, mean=MEAN, out_dtype=torch.float32)


@pytest.mark.parametrize("optimized", [False, True], ids=["unfolded", "optimized"])
def test_program_matches_the_reference_in_float32(case, optimized):
    params, raw, aug, want = case
    g, p, s = _model(), params, {}
    if optimized:
        g, p, s = optimize_for_inference(g, p, s)
        assert "input_transform" not in [l.type for l in g.layers]
    with torch.no_grad():
        outs, _ = Program(g, compute_dtype=torch.float32, device="cpu").apply(
            p, s, {"data": _clips_f32(raw, aug)}, capture=["head.projection"])
    got = outs["head.projection"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= TOL


def test_serving_in_bfloat16_misses_the_float32_tolerance(case):
    params, raw, aug, want = case
    g, p, s = optimize_for_inference(_model(), params, {})
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device="cpu"), p, s,
                         crop=CROP, mean=MEAN, output="head.projection")
    with torch.no_grad():
        got = server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
    assert got.dtype == torch.bfloat16
    assert 100 * TOL < _rel(got.float(), want) < 0.5


def test_attention_weights_and_positions_are_informative():
    """The reference's draws keep the attention neither nearly uniform nor
    nearly one-hot: a query's logits (after the position terms) spread by
    roughly 1-3 over its keys in every block, on smooth frames; and the
    position terms alone spread by a visible fraction of that."""
    cfg = _cfg()
    net = ref.net(cfg)
    params = draw(ref.param_specs(net, cfg)[0], torch.Generator().manual_seed(7))
    raw = _frames(1, FRAMES, CROP + 8, CROP + 8, torch.Generator().manual_seed(8))
    probe = []
    with torch.no_grad():
        ref.forward(net, params, {}, ref.clips(cfg, raw, [4], [4], [0]), probe)
    assert len(probe) == 4
    spreads = [s for _, s, _ in probe]
    assert all(0.7 <= s <= 3.5 for s in spreads), probe
    assert 1.0 <= sum(spreads) / len(spreads) <= 3.0, probe
    assert all(0.2 <= pos / s <= 0.8 for _, s, pos in probe), probe


# -- the pooled attention op ------------------------------------------------------


@pytest.mark.parametrize("q,k", [(56, 7), (7, 56), (28, 14), (14, 28), (16, 16), (7, 4),
                                 (4, 7), (5, 3), (1, 4)])
def test_rel_pos_index_is_the_published_distance(q, k):
    got = pa.rel_pos_index(q, k)
    assert torch.equal(got, ref.rel_pos_distance(q, k))
    assert got.min() >= 0 and got.max() <= 2 * max(q, k) - 2
    if k % q == 0:  # queries coarser: each query steps k / q rows, keys one
        ratio = k // q
        want = torch.arange(q)[:, None] * ratio - torch.arange(k)[None, :] + k - 1
        assert torch.equal(got, want)


def _op_case(stride_q, stride_kv, heads=2, d=16, size=(4, 8, 8), n=2, seed=5):
    g = torch.Generator().manual_seed(seed)
    c = heads * d
    qkv = torch.randn((n, 1 + math.prod(size), 3 * c), generator=g)
    q, k = (pa.pooled_size(size, (3, 3, 3), s, (1, 1, 1)) for s in (stride_q, stride_kv))
    params = {}
    for s in "qkv":
        params[f"pool_{s}.w"] = torch.randn((d, 1, 3, 3, 3), generator=g) / 5
        params[f"norm_{s}.gamma"] = torch.rand(d, generator=g) + 0.5
        params[f"norm_{s}.beta"] = torch.rand(d, generator=g) - 0.5
    for axis, qs, ks in zip("thw", q, k):
        params[f"rel_pos_{axis}"] = torch.rand((2 * max(qs, ks) - 1, d), generator=g) - 0.5
    return qkv, params, q


@pytest.mark.parametrize("stride_q,stride_kv", [
    ((1, 1, 1), (1, 4, 4)), ((1, 2, 2), (1, 2, 2)), ((1, 2, 2), (1, 1, 1)),
    ((1, 1, 1), (1, 1, 1))])
def test_pooled_attention_equals_the_published_attention(stride_q, stride_kv):
    """The op, then an identity projection, against the published
    ``MultiScaleAttention.forward`` (``reference_mvit.attention``) on the
    same qkv rows: the linear before it the identity too."""
    heads, d, size = 2, 16, (4, 8, 8)
    qkv, params, q_size = _op_case(stride_q, stride_kv, heads, d, size)
    got, got_size = pa.pooled_attention(qkv, params, heads=heads, size=size, stride_q=stride_q,
                                        stride_kv=stride_kv, kernel=(3, 3, 3), eps=1e-6)
    c = heads * d
    eye = {"w": torch.eye(c), "b": torch.zeros(c)}
    blk = ref.Block(c, c, heads, stride_q, stride_kv, size)
    net = ref.net({})
    # the published attention runs its qkv linear itself: feed it the rows
    # through a linear that lays [q, k, v] out of a 3C-wide input
    p = {"attn": params, "attn.qkv": {"w": torch.eye(3 * c), "b": torch.zeros(3 * c)},
         "attn.proj": eye}
    want, want_size = ref.attention(net, p, "attn", qkv, list(size), blk, None)
    assert tuple(got_size) == tuple(want_size) == tuple(q_size)
    assert _rel(got, want) <= 1e-5


def test_pooled_attention_counts_and_spans():
    """One call's spans and counters, by hand: queries 1 + 4 x 8 x 8, keys
    1 + 4 x 2 x 2, d 16, 2 heads, 2 clips, 4 bytes a value."""
    qkv, params, _ = _op_case((1, 1, 1), (1, 4, 4))
    before = COUNTS.copy()
    with torch.no_grad(), torch.profiler.profile() as prof:
        pa.pooled_attention(qkv, params, heads=2, size=(4, 8, 8), stride_q=(1, 1, 1),
                            stride_kv=(1, 4, 4), kernel=(3, 3, 3), eps=1e-6)
    counts = COUNTS - before
    names = [e.name for e in prof.events()]
    assert names.count("eco.qkv_pool") == 1 and names.count("eco.pattn") == 1
    lq, lk, grid = 257, 17, 256
    assert counts["pattn.flops"] == 2 * 2 * 2 * (2 * lq * lk + grid * (4 + 2 + 2)) * 16
    rows = (2 * 4 - 1) + (2 * 8 - 1) * 2
    assert counts["pattn.bytes"] == (2 * 2 * (2 * lq + 2 * lk) * 16 + rows * 16) * 4
    # 8 position columns: d + 4 + 2 + 2 is a multiple of 8 already
    assert counts["pattn.bias_bytes"] == 2 * 2 * (lq + lk) * 8 * 4
    assert "attn.flops" not in counts and "eco.attn" not in names


def test_position_columns_give_the_published_bias():
    """The product of the queries' and the keys' position columns, over
    sqrt(d), is the published decomposed bias (``cal_rel_pos_spatial`` and
    ``cal_rel_pos_temporal`` added to zero logits), with none in the class
    token's row and column: queries coarser than keys here, (4, 4, 4)
    against (4, 8, 8)."""
    _, params, q_size = _op_case((1, 2, 2), (1, 1, 1))
    k_size, n, heads, d = (4, 8, 8), 2, 2, 16
    q = torch.randn((n, 1 + math.prod(q_size), heads, d), generator=torch.Generator().manual_seed(3))
    tables = tuple(params[f"rel_pos_{a}"] for a in "thw")
    width = pa.position_width(k_size, d)
    assert (d + width) % pa.COLUMN_ALIGN == 0 and sum(k_size) <= width < sum(k_size) + 8
    cq = pa.position_columns(q, tables, q_size, k_size)
    ck = pa.key_columns(k_size, width, torch.float32, torch.device("cpu"))
    assert cq.shape == (n, q.shape[1], heads, width) and ck.shape == (1 + 256, width)
    got = torch.einsum("nqyw,kw->nyqk", cq, ck) / math.sqrt(d)
    want = torch.zeros((n, heads, q.shape[1], ck.shape[0]))
    ref.cal_rel_pos_spatial(want, q.transpose(1, 2), None, True, q_size, k_size, tables[1],
                            tables[2])
    ref.cal_rel_pos_temporal(want, q.transpose(1, 2), True, q_size, k_size, tables[0])
    assert torch.allclose(got, want, atol=1e-5)
    assert not got[:, :, 0].any() and not got[:, :, :, 0].any()


def test_pooling_convs_and_the_skip_pool_get_contiguous_clips(monkeypatch):
    """The depthwise convs get NCDHW clips and the skip's pool channels-last
    ones, contiguous: a strided view sends the conv to cuDNN's channels-last
    path and the pool to the padded route instead of K4 on the card."""
    seen = []
    conv3d, pool_nd = pa.F.conv3d, pa.pool_nd

    def conv(x, *args):
        seen.append(("conv", x.is_contiguous(), x.shape[1]))
        return conv3d(x, *args)

    def pool(x, **kw):
        seen.append(("pool", x.is_contiguous(), x.shape[-1]))
        return pool_nd(x, **kw)

    monkeypatch.setattr(pa.F, "conv3d", conv)
    monkeypatch.setattr(pa, "pool_nd", pool)
    qkv, params, _ = _op_case((1, 2, 2), (1, 2, 2))
    pa.pooled_attention(qkv, params, heads=2, size=(4, 8, 8), stride_q=(1, 2, 2),
                        stride_kv=(1, 2, 2), kernel=(3, 3, 3), eps=1e-6)
    pa.pool_skip(qkv, size=(4, 8, 8), kernel=(1, 3, 3), stride=(1, 2, 2), pad=(0, 1, 1))
    assert seen == [("conv", True, 32)] * 3 + [("pool", True, 96)]


def test_a_gradient_through_the_layer_raises():
    qkv, params, _ = _op_case((1, 1, 1), (1, 4, 4))
    # autograd on: another test file turns it off for its whole process, and
    # a pytest-xdist worker imports every file
    with torch.enable_grad(), pytest.raises(NotImplementedError, match="serving-only"):
        pa.pooled_attention(qkv.requires_grad_(), params, heads=2, size=(4, 8, 8),
                            stride_q=(1, 1, 1), stride_kv=(1, 4, 4), kernel=(3, 3, 3), eps=1e-6)


@pytest.mark.parametrize("size", [(4, 16, 16), (2, 7, 7), (3, 14, 9), (1, 2, 2)])
def test_pool_skip_is_the_published_max_pool(size):
    """The skip's max pool (kernel (1, 3, 3), stride (1, 2, 2), pad (0, 1, 1),
    floor mode) of the grid rows against ``F.max_pool3d``, the class token
    passed through, at even and odd sizes (Caffe's ceil mode adds a window
    past the floor mode's at an even size; the op drops it)."""
    g = torch.Generator().manual_seed(2)
    n, c = 2, 8
    x = torch.randn((n, 1 + math.prod(size), c), generator=g)
    got = pa.pool_skip(x, size=size, kernel=(1, 3, 3), stride=(1, 2, 2), pad=(0, 1, 1))
    grid = x[:, 1:].reshape(n, *size, c).permute(0, 4, 1, 2, 3)
    want = F.max_pool3d(grid, (1, 3, 3), (1, 2, 2), (0, 1, 1)).flatten(2).transpose(1, 2)
    assert torch.equal(got[:, 0], x[:, 0])
    assert torch.equal(got[:, 1:], want)


def test_spans_and_counters_of_one_request():
    g = _model(batch=1)
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                         {"data": g.inputs["data"]})
    before = COUNTS.copy()
    with torch.no_grad(), torch.profiler.profile() as prof:
        Program(g, device="cpu").apply(p, s, {"data": torch.zeros(g.inputs["data"])})
    counts = COUNTS - before
    names = [e.name for e in prof.events()]
    assert names.count("eco.qkv_pool") == names.count("eco.pattn") == 4
    assert names.count("eco.layer.token_pool") == 2
    assert "eco.attn" not in names and "eco.window" not in names
    # by hand: (queries, keys, heads, q grid, k grid, position columns) of the
    # four blocks, d 32: 32 + 12 and 32 + 20 rounded up to a multiple of 8
    blocks = [(1025, 65, 1, (4, 16, 16), (4, 4, 4), 16), (257, 257, 2, (4, 8, 8), (4, 8, 8), 24),
              (257, 65, 2, (4, 8, 8), (4, 4, 4), 16), (65, 257, 4, (4, 4, 4), (4, 8, 8), 24)]
    flops = sum(2 * h * (2 * lq * lk + math.prod(qg) * sum(kg)) * 32
                for lq, lk, h, qg, kg, _ in blocks)
    assert counts["pattn.flops"] == flops
    assert counts["pattn.bias_bytes"] == sum(h * (lq + lk) * w * 4
                                             for lq, lk, h, _, _, w in blocks)
    assert "attn.flops" not in counts


# -- the q/k/v pooling: K7's plain version and the route --------------------------

# q's and k and v's strides of the published blocks, each kind once
POOL_STRIDES = [((1, 1, 1), (1, 8, 8)), ((1, 2, 2), (1, 4, 4)), ((1, 1, 1), (1, 4, 4)),
                ((1, 2, 2), (1, 2, 2)), ((1, 1, 1), (1, 2, 2)), ((1, 2, 2), (1, 1, 1)),
                ((1, 1, 1), (1, 1, 1))]
POOL_KW = dict(kernel=(3, 3, 3), eps=1e-6)


def _pool_case(heads, size, d=8, n=2, seed=9, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((n, 1 + math.prod(size), 3 * heads * d), generator=g).to(dtype)
    params = {}
    for s in "qkv":
        params[f"pool_{s}.w"] = torch.randn((d, 1, 3, 3, 3), generator=g) / 5
        params[f"norm_{s}.gamma"] = torch.rand(d, generator=g) + 0.5
        params[f"norm_{s}.beta"] = torch.rand(d, generator=g) - 0.5
    return qkv, params


def _published_pool(qkv, params, heads, size, stride_q, stride_kv):
    """The published ``attention_pool`` of q, k and v (``reference_mvit``):
    (N, heads, L', d) each, and the grids."""
    n, _, c3 = qkv.shape
    d = c3 // 3 // heads
    x = qkv.view(n, -1, 3, heads, d).permute(2, 0, 3, 1, 4)
    out = []
    for i, (s, stride) in enumerate(zip("qkv", (stride_q, stride_kv, stride_kv))):
        conv = functools.partial(F.conv3d, weight=params[f"pool_{s}.w"], stride=stride,
                                 padding=[1, 1, 1], groups=d)
        norm = functools.partial(ref._norm, params, prefix=f"norm_{s}.")
        out.append(ref.attention_pool(x[i], conv, list(size), True, norm))
    return out


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("size", [(2, 8, 16), (3, 9, 7)], ids=["even", "odd"])
@pytest.mark.parametrize("stride_q,stride_kv", POOL_STRIDES,
                         ids=[f"q{q[1]}kv{kv[1]}" for q, kv in POOL_STRIDES])
def test_k7_plain_version_and_the_route_are_the_published_attention_pool(stride_q, stride_kv,
                                                                         size, heads):
    """In f32, K7's plain version and the route each within 1e-5 of the
    published ``attention_pool`` of q, k and v and of each other, at every
    published pair of strides, even and odd grids and 1, 2 or 4 heads; row
    0 is the class token's row normed over d."""
    qkv, params = _pool_case(heads, size)
    kw = dict(heads=heads, size=size, stride_q=stride_q, stride_kv=stride_kv, **POOL_KW)
    plain = pa.pool_qkv_plain(qkv, params, **kw)
    route = pa.pool_qkv_route(qkv, params, **kw)
    got = pa.pool_qkv(qkv, params, **kw)  # the CPU takes the route
    want = _published_pool(qkv, params, heads, size, stride_q, stride_kv)
    q_size, k_size = (pa.pooled_size(size, (3, 3, 3), s, (1, 1, 1)) for s in (stride_q, stride_kv))
    assert plain[3:] == route[3:] == got[3:] == (q_size, k_size)
    d = qkv.shape[-1] // 3 // heads
    for i, s in enumerate("qkv"):
        (w, w_size), grid = want[i], (q_size if s == "q" else k_size)
        assert tuple(w_size) == grid
        assert plain[i].shape == route[i].shape == (2, 1 + math.prod(grid), heads, d)
        assert torch.equal(got[i], route[i])
        for mine in (plain[i], route[i]):
            assert (mine.transpose(1, 2) - w).abs().max() <= 1e-5
        assert (plain[i] - route[i]).abs().max() <= 1e-5
        cls = qkv[:, 0].view(2, 3, heads, d)[:, i]
        row0 = F.layer_norm(cls, (d,), params[f"norm_{s}.gamma"], params[f"norm_{s}.beta"], 1e-6)
        assert (plain[i][:, 0] - row0).abs().max() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_k7_plain_version_rounds_once(dtype):
    """K7's plain version sums and norms in f32 and rounds once: on bf16 or
    f16 rows it is its f32 result on the same values, rounded."""
    size, heads = (3, 9, 7), 2
    qkv, params = _pool_case(heads, size, dtype=dtype)
    kw = dict(heads=heads, size=size, stride_q=(1, 2, 2), stride_kv=(1, 8, 8), **POOL_KW)
    low = pa.pool_qkv_plain(qkv, params, **kw)
    f32 = pa.pool_qkv_plain(qkv.float(), params, **kw)
    for a, b in zip(low[:3], f32[:3]):
        assert a.dtype == dtype and torch.equal(a, b.to(dtype))


def test_qkv_pool_bytes_by_hand():
    """``qkv_pool.bytes`` of one call, by hand: 2 clips, grid (3, 9, 9), C 16
    (2 heads of 8), f32; q at stride 1 reads every row, k and v at (1, 8,
    8) read rows 0, 1, 7 and 8 along H and W and give a (3, 2, 2) grid."""
    size, heads = (3, 9, 9), 2
    qkv, params = _pool_case(heads, size)
    before = COUNTS["qkv_pool.bytes"]
    pa.pool_qkv(qkv, params, heads=heads, size=size, stride_q=(1, 1, 1), stride_kv=(1, 8, 8),
                **POOL_KW)
    q_rows = (243 + 1) + (243 + 1)          # read (grid and class token), written
    kv_rows = (3 * 4 * 4 + 1) + (3 * 2 * 2 + 1)
    assert COUNTS["qkv_pool.bytes"] - before == 2 * 16 * 4 * (q_rows + 2 * kv_rows)
    # the bytes are the rows', whatever computes them: half in bf16
    before = COUNTS["qkv_pool.bytes"]
    pa.pool_qkv(qkv.bfloat16(), params, heads=heads, size=size, stride_q=(1, 1, 1),
                stride_kv=(1, 8, 8), **POOL_KW)
    assert COUNTS["qkv_pool.bytes"] - before == 2 * 16 * 2 * (q_rows + 2 * kv_rows)


def _tapped(size, stride):
    """Rows along an axis that some (3)-window of ``stride``, pad 1, reads."""
    out = (size - 1) // stride + 1
    return len({i * stride - 1 + k for i in range(out) for k in range(3)} & set(range(size)))


def test_qkv_pool_bytes_at_the_published_size():
    """A request of 10 MViTv2-B clips at 32 x 224 x 224 in bf16 counts
    3,600,506,880 B, the sum over the 24 blocks of ``chip_smoke.py``'s table
    by hand: for each of q, k and v, the rows some window reads and the
    class token's, and the output rows and their class token's, at C
    channels of 2 bytes."""
    from chip_smoke import MVIT_BLOCKS, MVIT_CLIPS, MVIT_HEAD_DIM

    g = get_model("mvit_v2_b_kinetics", batch=MVIT_CLIPS)
    params, _ = Program(g, device="meta").init(torch.Generator().manual_seed(0),
                                               {"data": g.inputs["data"]})
    before = COUNTS["qkv_pool.bytes"]
    with torch.no_grad():
        Program(g, compute_dtype=torch.bfloat16, device="meta").apply(
            params, {}, {"data": torch.empty(g.inputs["data"], device="meta")})
    counted = COUNTS["qkv_pool.bytes"] - before
    by_hand = 0
    for size, heads, stride_q, stride_kv, blocks in MVIT_BLOCKS.values():
        for stride in (stride_q, stride_kv, stride_kv):
            read = math.prod(_tapped(n, s) for n, s in zip(size, stride))
            out = math.prod((n - 1) // s + 1 for n, s in zip(size, stride))
            by_hand += blocks * MVIT_CLIPS * heads * MVIT_HEAD_DIM * 2 * (read + 1 + out + 1)
    assert counted == by_hand == 3_600_506_880


def test_k7_blocks_table_is_the_models():
    """``chip_smoke.py``'s MVIT_BLOCKS, which the card's checks of K7 read,
    is the published graph's 24 pooled attentions, and K7 is built for
    every one of them."""
    from chip_smoke import MVIT_BLOCKS, MVIT_CLIPS, MVIT_HEAD_DIM

    g = get_model("mvit_v2_b_kinetics", batch=MVIT_CLIPS)
    attn = [l for l in g.layers if l.type == "pooled_attention"]
    seen = collections.Counter(
        (tuple(l.opt("size")), l.opt("heads"), tuple(l.opt("stride_q")), tuple(l.opt("stride_kv")))
        for l in attn)
    table = {(size, heads, q, kv): blocks for size, heads, q, kv, blocks in MVIT_BLOCKS.values()}
    assert dict(seen) == table and sum(table.values()) == 24
    for size, heads, q, kv in table:
        shape = (MVIT_CLIPS, 1 + math.prod(size), 3 * heads * MVIT_HEAD_DIM)
        assert pa.k7_fits(torch.bfloat16, shape, heads, size, q, kv, (3, 3, 3))


@pytest.mark.parametrize("case,fits", [
    ("bf16", True), ("f16", True), ("f32", False), ("kernel_133", False),
    ("stride_t2", False), ("stride_3", False), ("stride_unequal", False), ("d_12", False),
    ("d_104", False), ("rows_short", False)])
def test_k7_is_built_for_the_published_geometries_alone(case, fits):
    """What K7 takes: bf16 or f16 rows, a (3, 3, 3) kernel, strides (1, s, s)
    for s in 1, 2, 4 and 8, d a multiple of 8 up to 96; anything else
    takes the route."""
    heads, size, q, kv, kernel, d, dtype = 2, (4, 14, 14), (1, 2, 2), (1, 4, 4), (3, 3, 3), 96, \
        torch.bfloat16
    rows = 1 + math.prod(size)
    if case == "f16":
        dtype = torch.float16
    elif case == "f32":
        dtype = torch.float32
    elif case == "kernel_133":
        kernel = (1, 3, 3)
    elif case == "stride_t2":
        q = (2, 2, 2)
    elif case == "stride_3":
        kv = (1, 3, 3)
    elif case == "stride_unequal":
        kv = (1, 4, 2)
    elif case == "d_12":
        d = 12
    elif case == "d_104":
        d = 104
    elif case == "rows_short":
        rows -= 1
    assert pa.k7_fits(dtype, (2, rows, 3 * heads * d), heads, size, q, kv, kernel) is fits


def test_rows_on_the_cpu_take_the_route(monkeypatch):
    """bf16 rows that K7 fits, but on the CPU, take the route: K7 is never
    built or launched, and the result is the route's."""
    def no_kernel():
        raise AssertionError("K7 reached on the CPU")

    monkeypatch.setattr(pa, "_kernel", no_kernel)
    size, heads = (3, 9, 7), 2
    qkv, params = _pool_case(heads, size, dtype=torch.bfloat16)
    kw = dict(heads=heads, size=size, stride_q=(1, 2, 2), stride_kv=(1, 4, 4), **POOL_KW)
    assert pa.k7_fits(qkv.dtype, tuple(qkv.shape), heads, size, (1, 2, 2), (1, 4, 4), (3, 3, 3))
    before = COUNTS["k7.launches"]
    got = pa.pool_qkv(qkv, params, **kw)
    want = pa.pool_qkv_route(qkv, params, **kw)
    assert COUNTS["k7.launches"] == before
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))


# -- the input transform -----------------------------------------------------------


def test_input_fold_into_the_padded_patch_embedding_is_exact():
    """The transform (BGR -> RGB, 1 / 57.375 every channel) folded into the
    patch embedding, whose (1, 3, 3) zero padding the transform maps to
    itself: the folded conv equals the transform and the conv."""
    b = NetBuilder("t")
    x = b.input("data", (2, 8, 24, 24, 3))
    x = b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0],
                scale=1.0 / STD)
    b.conv("proj", x, 8, k=[3, 7, 7], s=[2, 4, 4], p=[1, 3, 3])
    g = b.build()
    p, s = Program(g, device="cpu").init(torch.Generator().manual_seed(1),
                                         {"data": g.inputs["data"]})
    clips = torch.randn(g.inputs["data"], generator=torch.Generator().manual_seed(2)) * 60
    folded = fold_input_transform(g, p, s)
    assert [l.type for l in folded[0].layers] == ["convolution"]
    want = Program(g, device="cpu").apply(p, s, {"data": clips})[0]["proj"]
    got = Program(folded[0], device="cpu").apply(folded[1], folded[2], {"data": clips})[0]["proj"]
    assert _rel(got, want) <= 1e-6


# -- int8 --------------------------------------------------------------------------


def test_the_int8_path_runs_a_small_mvit(case):
    """Every linear and the patch embedding quantised; the pooling convs
    inside the attention layers stay float."""
    params, raw, aug, want = case
    g, p, s = optimize_for_inference(_model(), params, {})
    calib = [{"data": _clips_f32(raw, aug)}]
    prog = Program(g, compute_dtype=torch.float32, device="cpu")
    qprog, qp, qs, report = quantize_for_serving(prog, p, s, calib, fold=False)
    linears = {l.name for l in g.layers if l.type in ("innerproduct", "convolution")}
    assert set(report["quantized"]) == linears
    assert len(linears) == 4 * 4 + 2 + 2  # 4 a block, 2 skip projs, the embedding, the head
    assert all(qp[n]["w"].dtype == torch.int8 for n in linears)
    attn = [l.name for l in g.layers if l.type == "pooled_attention"]
    assert all(t.dtype == torch.float32 for n in attn for t in qp[n].values())
    server = UInt8Server(qprog, qp, qs, crop=CROP, mean=MEAN, output="head.projection")
    with torch.no_grad():
        got = server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
    assert server.in_scale is not None  # the patch embedding reads K1's int8 clips
    assert 1e-2 < _rel(got.float(), want) < 0.5


# -- the other models' graphs --------------------------------------------------------


# the digests of the parent of the change that added MViTv2, which these
# graphs must keep out of ``optimize_for_inference``: the same layers,
# options and parameters (``torch.equal``: the bytes)
UNCHANGED = {
    "eco_lite_kinetics": (dict(batch=1, num_segments=4, crop_size=112),
                          "eca9cca3699185c5ccf902bb55a68e20cf30ff7d41ab0e00adc901f5448922df"),
    "eco_full_kinetics": (dict(batch=1, num_segments=4, crop_size=224),
                          "8030477d658ca4c5285119f2de2e5e4246b7f82f8b339843dc40004a17a45ea6"),
    "i3d_rgb_kinetics": (dict(batch=1, num_frames=16, crop_size=224),
                         "89549a13ff65597c7d5ff2b5f04a0b1f0f5a87a1bdb13af6b6b8274f7d82298f"),
    "video_swin_b_kinetics": (dict(batch=1, num_frames=8, crop_size=64, embed_dim=32,
                                   depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8]),
                              "c2c8916d742b7947f8b7bd135bdb08c644580f1394730f9aebf1dee7ffcfcb40"),
}


@pytest.mark.parametrize("name", sorted(UNCHANGED))
def test_shared_code_leaves_the_other_models_graphs_unchanged(name):
    kw, want = UNCHANGED[name]
    assert _digest(name, **kw) == want
