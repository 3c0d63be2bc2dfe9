"""Shifted-window 3D attention: the attention of the Video Swin Transformer
(Liu et al., "Video Swin Transformer", arXiv:2106.13230, 2022), as
``WindowAttention3D`` and ``SwinTransformerBlock3D.forward_part1`` of
SwinTransformer/Video-Swin-Transformer (``mmaction/models/backbones/
swin_transformer.py``) run it at test time.

Tokens are the executor's channels-last blobs, (N, T, H, W, C).  The
window attention layer takes the block's qkv tokens (N, T, H, W, 3C): the
published qkv linear runs on the partitioned windows, but it is a product
of each token alone, so it commutes with the shift and the partition and
runs before them as a token-wise linear (``ops/linear.py``); the output
projection likewise runs after the reverse.  A block whose grid is not a
whole number of windows pads its normalised tokens with zeros before the
qkv linear (:func:`pad_tokens`, as the published block pads before its
attention), and the attention crops its output back.

- :func:`window_geometry`: the window and shift of a grid (the published
  ``get_window_size``): an axis whose grid is not larger than the window
  takes the grid as its window and is not shifted.
- :func:`relative_position_index`: the published index into the bias table
  of a full window; a clipped window of L tokens reads its first L rows
  and columns, as the published code does.
- :func:`shift_mask`: the published ``compute_mask``: 0 between tokens of
  one region of the shifted grid, -100 between tokens that the cyclic shift
  brought together.
- :func:`window_attention`: roll by -shift, partition, the attention
  softmax(q k^T / sqrt(d) + bias + mask) v of each window and head, reverse,
  roll by +shift, crop.  Its plain version, :func:`window_attention_reference`,
  partitions and reverses an unshifted block by one permuting copy each; a
  shifted block's roll and partition are one gather of the tokens in the
  order of the shifted grid's windows, and its reverse and roll back one
  scatter by the same order (``torch.roll`` would cost a pass over the
  tokens for each rolled axis).
- :func:`window_indices`: the same geometry as index arithmetic, per
  window position: the token it reads, its offset into the bias table and
  its region of the shifted grid; the arithmetic K6 does.

:func:`window_attention` takes one of two routes, by its input alone.  K6,
the hand-written kernel ``csrc/window_attn.cu`` (built with ``nvcc`` at
first use), takes bf16 or f16 qkv tokens on the card with a head width of
32 (every Video Swin stage) and no gradient asked, outside ``torch.export``
and ``torch.compile`` traces: one launch reads q, k and v from the tokens by
index, computes the bias and mask from the table by index, and writes the
output rows to their tokens, cropped.  Everything else (the CPU, f32,
gradients, other head widths) takes :func:`window_attention_reference`, the
plain version: the copies and ``F.scaled_dot_product_attention`` over the
gathered bias.  ``COUNTS["k6.launches"]`` counts K6's launches.

The route's bias gathered from the table, with the mask added, is made once
per table and geometry, in the compute type, and kept while the table lives
(:func:`attention_bias`); a table that takes a gradient gathers anew each
call.  Windows of an unshifted block share one bias, (1, heads, L, L),
which the attention broadcasts over the windows; a shifted block's differs
by window, (1, heads x windows, L, L), with the windows laid on the heads
axis, broadcast over the clips.  K6 makes and keeps none.

Spans and counters (``utils/tracing.py``): ``eco.window`` around each pad,
shift and partition copy and each reverse, unshift and crop copy of the
route; ``eco.attn`` around the attention core (the route's library call, or
K6's launch); ``COUNTS["attn.flops"]`` adds twice the multiply-adds of
q k^T and of the weights times v, ``COUNTS["attn.bytes"]`` q, k and v read
once, the output written once and the call's bias read once (the route's
gathered bias, whatever implements the core).
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch
import torch.nn.functional as F

from eco_tpu_torch.ops import _build
from eco_tpu_torch.utils.tracing import COUNTS, span

MASK_VALUE = -100.0  # the published mask between regions of a shifted grid
HEAD_DIM = 32  # the head width K6 is built for (csrc/window_attn.cu's kD)
MAX_LENGTH = 1024  # K6's longest window (kMaxLength)
MAX_TABLE_ROWS = 8192  # K6's largest table (kMaxTableRows)
_ELEM_KINDS = {torch.bfloat16: 1, torch.float16: 2}  # K6's token types

# id of a table -> {geometry and type: gathered bias}, dropped with the table
_BIAS: dict[int, dict] = {}


def window_geometry(grid, window, shift):
    """(window, shift) of a (T, H, W) ``grid``: an axis whose grid is not
    larger than the window takes the grid's size and no shift."""
    win, sh = list(window), list(shift)
    for i, (g, w) in enumerate(zip(grid, window)):
        if g <= w:
            win[i], sh[i] = g, 0
    return tuple(win), tuple(sh)


def window_pads(grid, window) -> tuple:
    """The zeros each axis of ``grid`` takes at its end to be whole
    windows."""
    return tuple((w - g % w) % w for g, w in zip(grid, window))


def relative_position_index(window) -> torch.Tensor:
    """(L, L) int64 index into a ((2Wt-1)(2Wh-1)(2Ww-1), heads) table of
    the relative offset of token j from token i, tokens in (t, h, w) order."""
    wt, wh, ww = window
    coords = torch.stack(torch.meshgrid(torch.arange(wt), torch.arange(wh), torch.arange(ww),
                                        indexing="ij")).flatten(1)      # 3, L
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)      # L, L, 3
    rel = rel + torch.tensor([wt - 1, wh - 1, ww - 1])
    return rel[..., 0] * (2 * wh - 1) * (2 * ww - 1) + rel[..., 1] * (2 * ww - 1) + rel[..., 2]


def shift_mask(grid, window, shift) -> torch.Tensor:
    """(windows, L, L) float32: 0 between tokens of one region of the
    padded ``grid`` shifted by ``shift``, ``MASK_VALUE`` across regions;
    the regions labelled as the published ``compute_mask`` labels them."""
    label = torch.zeros(grid)
    cnt = 0
    slices = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    for d in slices[0]:
        for h in slices[1]:
            for w in slices[2]:
                label[d, h, w] = cnt
                cnt += 1
    win = partition(label[None, ..., None], window)[0, :, :, 0]      # windows, L
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def partition(x: torch.Tensor, window) -> torch.Tensor:
    """(N, T, H, W, C) -> (N, windows, L, C), windows in (t, h, w) order and
    the tokens of each too."""
    n, t, h, w, c = x.shape
    wt, wh, ww = window
    x = x.view(n, t // wt, wt, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(n, -1, wt * wh * ww, c)


def pad_tokens(x: torch.Tensor, pads) -> torch.Tensor:
    """(N, T, H, W, C) with ``pads`` zeros at the end of T, H and W."""
    if not any(pads):
        return x
    with span("eco.window"):
        pt, ph, pw = pads
        return F.pad(x, (0, 0, 0, pw, 0, ph, 0, pt))


def _gather_bias(table, window, table_window, grid, shift):
    """The bias of every head, float32: (heads, L, L); with a shift, of
    every head and window, the shift's mask added: (heads x windows, L, L)."""
    length = math.prod(window)
    index = relative_position_index(table_window)[:length, :length].reshape(-1)
    heads = table.shape[1]
    rel = table[index.to(table.device)].view(length, length, heads).permute(2, 0, 1)
    rel = rel.contiguous().float()
    if not any(shift):
        return rel
    mask = shift_mask(grid, window, shift).to(table.device)
    return (rel[:, None] + mask[None]).flatten(0, 1)


@functools.lru_cache(maxsize=64)
def _window_order(grid, window, shift, device) -> torch.Tensor:
    """(T x H x W,) int64 on ``device``: the token of ``grid`` that each
    position of the shifted grid's windows reads, windows and their tokens
    in (t, h, w) order, the grid rolled by -``shift``."""
    index = torch.arange(math.prod(grid)).view(grid)
    index = torch.roll(index, shifts=tuple(-s for s in shift), dims=(0, 1, 2))
    return partition(index[None, ..., None], window).reshape(-1).to(device)


def window_indices(grid, window, shift, table_window):
    """The geometry of a block as K6 computes it, per window position p of
    each window of ``grid`` (windows and positions in (t, h, w) order):

    - ``token`` (windows, L) int64: the flat token of ``grid`` that p reads
      and writes, (x + shift) mod the grid for p's coordinate x in the
      grid rolled by -shift (:func:`_window_order`);
    - ``offset`` (L,) int64: p unravelled in ``table_window``'s shape as a
      row offset of the bias table, so that the relative index of query p
      and key j is ``offset[p] - offset[j] + (rows - 1) // 2``
      (:func:`relative_position_index` at its first L rows and columns);
    - ``region`` (windows, L) int64: p's region of the rolled grid, on each
      axis 0, 1 or 2 as x < G - w, x < G - s or neither; two positions of
      one window are masked where their regions differ (:func:`shift_mask`).
    """
    src, region = [], []
    for g, w, s in zip(grid, window, shift):
        x = torch.arange(g).view(g // w, w)  # (window, position) -> rolled coordinate
        src.append((x + s) % g)
        region.append(torch.where(x < g - w, 0, torch.where(x < g - s, 1, 2)))

    def flat(v, sizes):
        # per axis (windows, positions) -> (windows, L), (t, h, w) order both
        t, h, w = v
        out = (t[:, None, None, :, None, None] * (sizes[1] * sizes[2])
               + h[None, :, None, None, :, None] * sizes[2] + w[None, None, :, None, None, :])
        return out.reshape(-1, math.prod(window))

    _, th, tw = table_window
    p = torch.arange(math.prod(window))
    offset = ((p // (th * tw)) * (2 * th - 1) + (p // tw) % th) * (2 * tw - 1) + p % tw
    return flat(src, grid), offset, flat(region, (3, 3, 3))


def attention_bias(table, window, table_window, grid, shift, dtype) -> torch.Tensor:
    """The bias and mask the attention of one block adds, in ``dtype``:
    gathered once per table, geometry and type while the table lives (every
    call when the table takes a gradient or has no storage)."""
    if (table.requires_grad and torch.is_grad_enabled()) or table.device.type == "meta":
        return _gather_bias(table, window, table_window, grid, shift)[None].to(dtype)
    key = (tuple(window), tuple(table_window), tuple(grid), tuple(shift), dtype,
           table._version)
    per_table = _BIAS.get(id(table))
    if per_table is None:
        per_table = _BIAS[id(table)] = {}
        weakref.finalize(table, _BIAS.pop, id(table), None)
    if key not in per_table:
        with torch.no_grad():
            per_table[key] = _gather_bias(table, window, table_window, grid, shift)[None].to(dtype)
    return per_table[key]


def attention_core(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v over (B, heads, L, d) with ``bias``
    broadcast to (B, heads, L, L); counts its operations and least bytes."""
    b, heads, length, d = q.shape
    _count_core(b * heads, length, d, bias.shape[1], q.element_size())
    with span("eco.attn"):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


@functools.cache
def _kernel():
    fn = _build.load("window_attn").eco_window_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 3           # qkv, table, out
        + [ctypes.c_int] * 18           # n, t, h, w, heads, window, shift, table window,
                                        # size, element kind
        + [ctypes.c_void_p]             # stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load K6 now rather than at its first launch."""
    _kernel()


def _takes(qkv: torch.Tensor, table: torch.Tensor, heads: int, window, shift, table_window,
           size) -> bool:
    """True iff :func:`window_attention` launches K6: bf16 or f16 qkv tokens
    on the card, contiguous, a head width of ``HEAD_DIM``, a grid of whole
    windows (fewer than 2**31 tokens), each shift under its window, a crop
    inside the grid, a window and table K6 holds in shared memory, no
    gradient asked and no trace running."""
    rows = math.prod(2 * w - 1 for w in table_window)
    return (qkv.device.type == "cuda" and qkv.dtype in _ELEM_KINDS
            and qkv.ndim == 5 and qkv.shape[-1] == 3 * heads * HEAD_DIM
            and all(g % w == 0 for g, w in zip(qkv.shape[1:4], window))
            and all(0 <= s < w for s, w in zip(shift, window))
            and all(0 < o <= g for o, g in zip(size, qkv.shape[1:4]))
            and math.prod(qkv.shape[:4]) < 2**31
            and math.prod(window) <= min(MAX_LENGTH, math.prod(table_window))
            and rows <= MAX_TABLE_ROWS and tuple(table.shape) == (rows, heads)
            and table.device == qkv.device and table.is_floating_point()
            and qkv.is_contiguous() and table.is_contiguous()
            and not (torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad))
            and not torch.compiler.is_compiling())


def _count_core(batch_heads: int, length: int, d: int, bias_heads: int, itemsize: int):
    """``attn.flops`` and ``attn.bytes`` of an attention core over
    ``batch_heads`` (batch x heads) windows of ``length`` tokens, whose bias
    has ``bias_heads`` (L, L) planes; ``itemsize`` bytes a value."""
    COUNTS["attn.flops"] += 4 * batch_heads * length * length * d
    COUNTS["attn.bytes"] += (4 * batch_heads * length * d + bias_heads * length * length) * itemsize


def window_attention(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, window,
                     shift, table_window, size) -> torch.Tensor:
    """Shifted-window multi-head attention of qkv tokens.

    ``qkv``: (N, T, H, W, 3C), a whole number of ``window`` s on each axis,
    channels (q, k, v) x heads x d as the published qkv linear lays them
    out; ``table``: the ((2Wt-1)(2Wh-1)(2Ww-1), heads) relative-position
    bias table of the full ``table_window``; ``window`` and ``shift`` as
    :func:`window_geometry` gives them.  Returns the attention's output
    tokens, before the projection, (N, *size, C): cropped to ``size``
    (T, H, W), the grid before :func:`pad_tokens`.  K6 where it takes the
    input, else :func:`window_attention_reference`.
    """
    if not _takes(qkv, table, heads, window, shift, table_window, size):
        return window_attention_reference(qkv, table, heads=heads, window=window, shift=shift,
                                          table_window=table_window, size=size)
    n, t, h, w, c3 = qkv.shape
    length = math.prod(window)
    nwin = t * h * w // length
    _count_core(n * nwin * heads, length, HEAD_DIM, heads * nwin if any(shift) else heads,
                qkv.element_size())
    out = torch.empty((n, *size, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    with span("eco.attn"):
        table = table.float()  # the serving table is f32 already: no copy
        err = _kernel()(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), n, t, h, w, heads, *window,
            *shift, *table_window, *size, _ELEM_KINDS[qkv.dtype],
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: CUDA error {err}")
    COUNTS["k6.launches"] += 1
    return out


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, window,
                               shift, table_window, size) -> torch.Tensor:
    """Plain version of :func:`window_attention`: the shift and partition
    copies, the library's attention over the gathered bias and mask, the
    reverse copies."""
    n, t, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    wt, wh, ww = window
    length = wt * wh * ww
    nwin = (t // wt) * (h // wh) * (w // ww)
    shifted = any(shift)
    bias = attention_bias(table, window, table_window, (t, h, w), shift, qkv.dtype)
    if shifted:
        # each window its own bias: (N, heads x windows, L, d), windows on the
        # heads axis; the shift and the partition one gather of whole heads
        order = _window_order((t, h, w), tuple(window), tuple(shift), qkv.device)
        with span("eco.window"):
            wins = qkv.view(n, t * h * w, 3, heads, d).permute(2, 0, 3, 1, 4)
            wins = wins.index_select(3, order)
        q, k, v = (x.view(n, heads * nwin, length, d) for x in wins)
        out = attention_core(q, k, v, bias)
        with span("eco.window"):
            res = torch.empty((n, t * h * w, heads, d), dtype=out.dtype, device=out.device)
            res.permute(0, 2, 1, 3).index_copy_(2, order, out.reshape(n, heads, nwin * length, d))
            return _cropped(res.view(n, t, h, w, c), size)
    else:
        # every window the same bias: (N x windows, heads, L, d), windows on
        # the batch axis; the partition and the reverse one copy each
        with span("eco.window"):
            wins = qkv.view(n, t // wt, wt, h // wh, wh, w // ww, ww, 3, heads, d)
            wins = wins.permute(7, 0, 1, 3, 5, 8, 2, 4, 6, 9).contiguous()
        q, k, v = (x.view(n * nwin, heads, length, d) for x in wins)
        out = attention_core(q, k, v, bias)
        with span("eco.window"):
            out = out.reshape(n, t // wt, h // wh, w // ww, heads, wt, wh, ww, d)
            out = out.permute(0, 1, 5, 2, 6, 3, 7, 4, 8).contiguous().view(n, t, h, w, c)
            return _cropped(out, size)


def _cropped(x, size):
    """(N, T, H, W, C) cut to ``size`` (T, H, W) at the end of each axis."""
    if tuple(size) == tuple(x.shape[1:4]):
        return x
    return x[:, :size[0], :size[1], :size[2]].contiguous()


def patch_merging(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N, T, ceil(H/2), ceil(W/2), 4C): H and W padded
    with zeros to even, then each 2x2 cell's tokens laid along the channels
    in the published order (h, w) = (0, 0), (1, 0), (0, 1), (1, 1)."""
    h, w = x.shape[2], x.shape[3]
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    return torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                      x[:, :, 1::2, 1::2]], dim=-1)
