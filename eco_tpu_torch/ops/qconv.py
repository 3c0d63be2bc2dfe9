"""int8 x int8 -> int32 convolution with its epilogue fused: kernel K3.

Replaces the XLA int8 convolution behind ``eco_tpu/ops/quant.py:69
conv_nd_int8`` (``lax.conv_general_dilated`` with an int32 accumulator,
followed by ``_epilogue``).  That is an XLA op, not a Pallas kernel, but
PyTorch has no int8 convolution on CUDA, so the port writes it by hand.

- ``qconv_nd`` takes an int8 channels-last ``x`` (N, *spatial, C_in) with 1-3
  spatial axes and int8 weights ``(C_out, C_in/g, *k)``.  A CUDA tensor goes
  to the hand-written kernel ``csrc/qconv.cu`` (built with ``nvcc`` at first
  use) or the call raises; a CPU tensor (or a ``meta`` one, for shape
  propagation) goes to the plain version.
- ``qconv_nd_reference`` is that plain version: ``conv_acc_reference`` for
  the int32 accumulator, then ``epilogue``.
- ``kernel_layout`` puts weights in the kernel's memory order, once, where
  they are made; on the card ``qconv_nd`` refuses weights in any other.
- ``plan`` picks the kernel's load mode, tile width, K chunk and K split for
  a geometry (the kernel checks what it is handed); the CPU tests reach it.
- ``COUNTS["k3.launches"]`` (``utils/tracing.py``) counts kernel launches
  (one a call; a split-K call's second, summing pass is part of it).

The epilogue, as the reference's: ``y = f32(acc) * scale_vec[c] (+ b[c])``;
then either ``y`` cast to ``out_dtype`` (f32 or bf16), or, with
``out_scale`` set, int8 ``clip(round(y / out_scale), -127, 127)``.
``scale_vec`` is ``act_scale * w_scale``, computed once in f32 by the caller.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.shapes import normalize_spatial_param
from eco_tpu_torch.ops import _build
from eco_tpu_torch.utils.tracing import COUNTS

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# The kernel's tiling (csrc/qconv.cu): 128 output pixels a tile, two
# warpgroups, 132 SMs on an H100.
TILE_M = 128
NUM_SMS = 132
SPAN_BYTES = 32           # SPAN/GATHER: bytes of K a chunk (one wgmma k32)
SPAN_MAX_WEIGHT_BYTES = 65536  # SPAN: the block's padded weights in shared memory
SPAN_BLOCKS_PER_SM = 8    # SPAN blocks walk M tiles; this many a SM
VEC_BLOCKS_PER_SM = 4     # VEC blocks walk M tiles too (two fit an SM at once),
SHORT_K_BLOCKS_PER_SM = 2  # and one wave of them where a tile is 1-2 K chunks
MIN_CHUNKS_PER_SPLIT = 2
MODES = {"vec": 0, "span": 1, "gather": 2}


@dataclass(frozen=True)
class Plan:
    """How K3 runs one geometry.

    ``mode``: ``vec`` (C_in/g a multiple of 16, 16-byte aligned operands:
    cp.async ring), ``span`` (C_in*kw <= 32, one group, no W dilation: conv1's
    tap rows) or ``gather`` (anything else).  A block computes a TILE_M x
    ``bn`` output tile of one group over ``chunks_per_split`` of the
    ``chunks`` K chunks of ``bk`` bytes; ``splits`` blocks share a tile's K
    and a second pass adds their int32 sums.  ``grid_x`` blocks walk the
    ``m_tiles`` (VEC: about four blocks an SM, two for short K; SPAN: eight
    an SM; GATHER: one block a tile)."""

    mode: str
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    groups: int
    chunks: int
    splits: int
    chunks_per_split: int
    grid_x: int


@functools.lru_cache(maxsize=4096)
def plan(m: int, c_in: int, c_out: int, groups: int, kernel, dilation, *,
         aligned16: bool = True, aligned4: bool = True) -> Plan:
    """The kernel's mode, tile and K split for an int8 conv of ``m`` output
    pixels; ``kernel`` and ``dilation`` per spatial axis (D, H, W order),
    as tuples.  Tiles 128 x 128 where C_out/g > 64, else 128 x 64 (128 x 32
    where C_out/g <= 32), and 128 x 64 too where the wider tiles would leave
    SMs idle; where even those do not fill the 132 SMs, K is split."""
    cg, cog = c_in // groups, c_out // groups
    kernel = tuple(int(k) for k in kernel)
    taps = math.prod(kernel)
    rows = math.prod(kernel[:-1])  # (kz, ky) tap rows
    if cg % 16 == 0 and aligned16:
        mode, bk = "vec", 32
        bn = 32 if cog <= 32 else (64 if cog <= 64 else 128)
    elif (groups == 1 and int(dilation[-1]) == 1 and kernel[-1] * c_in <= SPAN_BYTES
          and rows * 64 * SPAN_BYTES <= SPAN_MAX_WEIGHT_BYTES and aligned4):
        mode, bk, bn, chunks = "span", SPAN_BYTES, 64, rows
    else:
        mode, bk, bn = "gather", SPAN_BYTES, 64
        chunks = -(-taps * cg // SPAN_BYTES)
    m_tiles = -(-m // TILE_M)
    if bn == 128 and m_tiles * -(-cog // bn) * groups < NUM_SMS:
        bn = 64
    n_tiles = -(-cog // bn)
    splits = 1
    tiles = m_tiles * n_tiles * groups
    if mode == "vec":
        # 32-byte stages in a ring of 8 measured faster on an H100 than
        # 64-byte ones in a ring of 4, but where K is split
        bk = 64 if tiles < NUM_SMS and cg % 64 == 0 else 32
        chunks = taps * -(-cg // bk)
    if mode == "vec" and tiles < NUM_SMS:
        splits = max(1, min(-(-NUM_SMS // tiles), chunks // MIN_CHUNKS_PER_SPLIT))
    per = -(-chunks // splits)
    splits = -(-chunks // per)
    grid_x = m_tiles
    if mode == "span":
        grid_x = min(m_tiles, NUM_SMS * SPAN_BLOCKS_PER_SM)
    elif mode == "vec":
        # about four blocks an SM, each walking its share of the M tiles; one
        # wave where a tile is one or two K chunks, so the ring runs ahead
        # over tiles (measured on an H100 against one to four an SM, and one
        # a tile)
        per_sm = SHORT_K_BLOCKS_PER_SM if per <= 2 else VEC_BLOCKS_PER_SM
        grid_x = min(m_tiles, -(-NUM_SMS * per_sm // (n_tiles * groups * splits)))
    return Plan(mode, bn, bk, m_tiles, n_tiles, groups, chunks, splits, per, grid_x)


@functools.cache
def _kernel():
    fn = _build.load("qconv").eco_qconv
    fn.argtypes = (
        [ctypes.c_void_p] * 6           # x, w, scale_vec, bias, out, workspace
        + [ctypes.c_int] * 7            # n, d, h, w, c_in, c_out, groups
        + [ctypes.c_int] * 12           # kernel, stride, pad, dilation (d, h, w)
        + [ctypes.c_int] * 3            # out d, h, w
        + [ctypes.c_int, ctypes.c_float]  # out kind, out_scale
        + [ctypes.c_int] * 6            # mode, bn, bk, splits, chunks/split, grid x
        + [ctypes.c_void_p]             # stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load the CUDA kernel now rather than at its first launch."""
    _kernel()


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """``w`` (C_out, C_in/g, *k) with the same shape but the memory order
    (C_out, *k, C_in/g) -- PyTorch's channels-last for weights -- so that
    the kernel's reduction axis runs along contiguous input channels.  Done
    once, where weights are quantized or bridged; ``qconv_nd`` then reads
    them with no copy."""
    return w.movedim(1, -1).contiguous().movedim(-1, 1)


def _geometry(x_ndim, stride, pad, dilation):
    nsp = x_ndim - 2
    if nsp not in _CONV:
        raise ValueError(f"qconv_nd takes 1-3 spatial axes, got a rank-{x_ndim} input")
    return (nsp,
            normalize_spatial_param(stride, nsp, default=1),
            normalize_spatial_param(pad, nsp, default=0),
            normalize_spatial_param(dilation, nsp, default=1))


def conv_acc_reference(x_q, w_q, *, stride=1, pad=0, dilation=1, groups: int = 1):
    """The int32 accumulator of the int8 convolution, channels-last.

    ``F.conv`` on the int8 operands cast to float64: every product and every
    partial sum is an integer below 2**53, so the sums are exact, and the
    round guards against an algorithm (FFT, Winograd) that is not."""
    nsp, stride, pad, dilation = _geometry(x_q.ndim, stride, pad, dilation)
    y = _CONV[nsp](x_q.movedim(-1, 1).double(), w_q.double(), None, stride=stride,
                   padding=pad, dilation=dilation, groups=groups)
    return torch.round(y).to(torch.int32).movedim(1, -1).contiguous()


def epilogue(acc, scale_vec, b, *, out_scale, out_dtype):
    """int32 accumulator -> dequantized float (+ bias) in ``out_dtype``, or
    requantized int8 at ``out_scale``."""
    y = acc.float() * scale_vec
    if b is not None:
        y = y + b.float()
    if out_scale is not None:
        # A 0-d device tensor, not a Python float: CUDA's division by a CPU
        # scalar multiplies by its reciprocal, which can differ in the last bit.
        s = torch.full((), out_scale, dtype=torch.float32, device=y.device)
        return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def qconv_nd_reference(x_q, w_q, scale_vec, b=None, *, stride=1, pad=0, dilation=1,
                       groups: int = 1, out_scale=None, out_dtype=torch.float32):
    """Plain PyTorch version of K3."""
    acc = conv_acc_reference(x_q, w_q, stride=stride, pad=pad, dilation=dilation,
                             groups=groups)
    return epilogue(acc, scale_vec, b, out_scale=out_scale, out_dtype=out_dtype)


def _alignment(x_q, wk):
    return dict(aligned16=x_q.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0,
                aligned4=x_q.data_ptr() % 4 == 0)


def plan_for(x_q, w_q, *, stride=1, pad=0, dilation=1, groups: int = 1) -> Plan:
    """``plan`` of one ``qconv_nd`` call on these operands."""
    nsp, stride, pad, dilation = _geometry(x_q.ndim, stride, pad, dilation)
    kernel = tuple(w_q.shape[2:])
    out_sp = [(i + 2 * p - dl * (k - 1) - 1) // s + 1
              for i, k, s, p, dl in zip(x_q.shape[1:-1], kernel, stride, pad, dilation)]
    pre = (1,) * (3 - nsp)
    return plan(x_q.shape[0] * math.prod(out_sp), x_q.shape[-1], w_q.shape[0], groups,
                pre + kernel, pre + tuple(dilation), **_alignment(x_q, w_q.movedim(1, -1)))


def _qconv_cuda(x_q, w_q, scale_vec, b, *, stride, pad, dilation, groups,
                out_scale, out_dtype):
    nsp, stride, pad, dilation = _geometry(x_q.ndim, stride, pad, dilation)
    if not x_q.is_contiguous():
        raise ValueError("qconv_nd takes a contiguous channels-last input")
    n, *spatial, c_in = x_q.shape
    c_out = w_q.shape[0]
    kernel = tuple(w_q.shape[2:])
    if c_in % groups or c_out % groups or w_q.shape[1] * groups != c_in:
        raise ValueError(f"weights {tuple(w_q.shape)} do not fit C_in {c_in} "
                         f"in {groups} groups")
    out_sp = [(i + 2 * p - dl * (k - 1) - 1) // s + 1
              for i, k, s, p, dl in zip(spatial, kernel, stride, pad, dilation)]
    if min(out_sp) <= 0:
        raise ValueError(f"qconv_nd: empty output {out_sp} for input {tuple(spatial)}")
    for name, v in (("scale_vec", scale_vec), ("bias", b)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (c_out,)
                              or v.device != x_q.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 ({c_out},) tensor on "
                             f"{x_q.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    kind = torch.int8 if out_scale is not None else out_dtype
    if kind not in _OUT_KIND:
        raise ValueError(f"no qconv_nd kernel for out_dtype {out_dtype}")
    # (C_out, *k, C_in/g): a view of weights in kernel_layout, never a copy
    wk = w_q.movedim(1, -1)
    if not wk.is_contiguous():
        raise ValueError("qconv_nd takes weights in kernel_layout on the card; reorder "
                         "them once where they are made, not at every call")
    out = torch.empty((n, *out_sp, c_out), dtype=kind, device=x_q.device)
    # pad to three spatial axes: (N, D, H, W, C) with D = 1 (and H = 1 for 1D)
    pre = 3 - nsp
    geo = []
    for vals, fill in ((spatial, 1), (kernel, 1), (stride, 1), (pad, 0), (dilation, 1)):
        geo.append([fill] * pre + [int(v) for v in vals])
    out3 = [1] * pre + out_sp
    p = plan(math.prod(out.shape[:-1]), c_in, c_out, groups, tuple(geo[1]), tuple(geo[4]),
             **_alignment(x_q, wk))
    ws = None
    if p.splits > 1:
        ws = torch.empty((p.splits, *out.shape), dtype=torch.int32, device=x_q.device)
    err = _kernel()(
        x_q.data_ptr(), wk.data_ptr(), scale_vec.data_ptr(),
        b.data_ptr() if b is not None else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        n, *geo[0], c_in, c_out, groups, *geo[1], *geo[2], *geo[3], *geo[4], *out3,
        _OUT_KIND[kind], float(out_scale if out_scale is not None else 1.0),
        MODES[p.mode], p.bn, p.bk, p.splits, p.chunks_per_split, p.grid_x,
        torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qconv kernel launch failed: CUDA error {err}")
    COUNTS["k3.launches"] += 1
    return out


def qconv_nd(x_q, w_q, scale_vec, b=None, *, stride=1, pad=0, dilation=1,
             groups: int = 1, out_scale=None, out_dtype=torch.float32):
    """int8 (N, *spatial, C_in) conv int8 (C_out, C_in/g, *k) -> int32,
    then the epilogue; output channels-last, contiguous."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"qconv_nd takes int8 operands, got {x_q.dtype} and {w_q.dtype}")
    if w_q.ndim != x_q.ndim:
        raise ValueError(f"weights of rank {w_q.ndim} for an input of rank {x_q.ndim}")
    kw = dict(stride=stride, pad=pad, dilation=dilation, groups=groups,
              out_scale=out_scale, out_dtype=out_dtype)
    if x_q.device.type == "cuda":
        return _qconv_cuda(x_q, w_q, scale_vec, b, **kw)
    if x_q.device.type in ("cpu", "meta"):
        return qconv_nd_reference(x_q, w_q, scale_vec, b, **kw)
    raise ValueError(f"no qconv_nd for device {x_q.device}")
