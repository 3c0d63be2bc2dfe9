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
  roll by +shift, crop.  An unshifted block partitions and reverses by one
  permuting copy each; a shifted block's roll and partition are one gather
  of the tokens in the order of the shifted grid's windows, and its reverse
  and roll back one scatter by the same order (``torch.roll`` would cost a
  pass over the tokens for each rolled axis).

The bias gathered from the table, with the mask added, is made once per
table and geometry, in the compute type, and kept while the table lives
(:func:`attention_bias`); a table that takes a gradient gathers anew each
call.  Windows of an unshifted block share one bias, (1, heads, L, L),
which the attention broadcasts over the windows; a shifted block's differs
by window, (1, heads x windows, L, L), with the windows laid on the heads
axis, broadcast over the clips.

Spans and counters (``utils/tracing.py``): ``eco.window`` around each pad,
shift and partition copy and each reverse, unshift and crop copy;
``eco.attn`` around the attention core; ``COUNTS["attn.flops"]`` adds
twice the multiply-adds of q k^T and of the weights times v,
``COUNTS["attn.bytes"]`` q, k and v read once, the output written once and
the call's bias read once.
"""

from __future__ import annotations

import functools
import math
import weakref

import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.tracing import COUNTS, span

MASK_VALUE = -100.0  # the published mask between regions of a shifted grid

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
    COUNTS["attn.flops"] += 4 * b * heads * length * length * d
    COUNTS["attn.bytes"] += (4 * q.numel() * q.element_size()
                             + bias.shape[1] * length * length * bias.element_size())
    with span("eco.attn"):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, *, heads: int, window,
                     shift, table_window, size) -> torch.Tensor:
    """Shifted-window multi-head attention of qkv tokens.

    ``qkv``: (N, T, H, W, 3C), a whole number of ``window`` s on each axis,
    channels (q, k, v) x heads x d as the published qkv linear lays them
    out; ``table``: the ((2Wt-1)(2Wh-1)(2Ww-1), heads) relative-position
    bias table of the full ``table_window``; ``window`` and ``shift`` as
    :func:`window_geometry` gives them.  Returns the attention's output
    tokens, before the projection, (N, *size, C): cropped to ``size``
    (T, H, W), the grid before :func:`pad_tokens`.
    """
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
