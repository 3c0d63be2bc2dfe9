"""Caffe-semantics ND pooling on channels-last tensors.

Twin of ``eco_tpu/ops/pool.py:pool_nd`` and ``global_avg_pool``.  Caffe's
ceil-mode output dims and last-window clip become an explicit asymmetric
``(pad, pad_hi)`` padding computed statically by
``utils.shapes.caffe_pool_out_dim``; PyTorch's ``ceil_mode=True`` agrees
with Caffe only on some shapes, and only the AVE route below uses it, on
those.

``pool_nd`` routes by what the input shows:

- a float 2D or 3D MAX or AVE pool of a contiguous tensor on the card, with
  no gradient asked and no trace running, goes to K4, the one-pass kernel of
  ``ops/poolk.py`` (``poolk.takes``, then ``poolk.launch``, which pools a
  3D window of one frame as a 2D pool of each frame);
- everything else takes the padded route, :func:`padded_pool`, which is
  also K4's plain version.  ``COUNTS["pool.route"]`` counts the float pools
  on the card that take it.

``COUNTS["pool.bytes"]`` adds every call's least traffic, whatever its
route: the input read once and the output written once, from the shapes
alone (no launch, no sync); not while shapes propagate on the meta device
or ``torch.export`` traces.

The padded route:

- MAX pads with ``-inf`` (the integer minimum for integer types) and then
  takes unpadded windows: ATen's ``max_pool{1,2,3}d`` for floats, a window
  view and ``amax`` for integers, which ATen's pools do not take.
- AVE is pooling_layer.cpp's: each window's image cells added in f32, one
  add at a time in row-major order from +0.0, divided by the window
  clipped to H + pad (``caffe_avg_pool_divisors``), rounded once to the
  input's type.  That is ATen's ``avg_pool{1,2}d`` with Caffe's pads,
  ``ceil_mode`` and ``count_include_pad``, on the card and on the CPU,
  wherever ATen takes the pads (at most half the window) and its ceil rule
  gives Caffe's dims (it drops a last window that starts past the input
  even without a pad; Caffe keeps it), and no gradient is asked.
  Elsewhere (and in 3D, where ATen's CPU pool takes no bf16, and under a
  gradient, where ATen's CUDA backward of that call is off) the route adds
  the same cells in the same order in ATen's pool with a divisor of 1 on
  the zero-padded f32 tensor (a padded cell adds +0.0, which changes no sum
  that starts from +0.0) and divides by the divisor grid, made once per
  geometry and device and kept there: a copy from host memory at every call
  would wait for the stream.  K4 adds in this order, so the two give the
  same bits; with and without a gradient the route gives the same values.

Spans (``utils/tracing.py``): ``eco.pad`` around every spatial padding,
``eco.layout`` around the max pool's move back to channels-last.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.shapes import (
    caffe_avg_pool_divisors,
    caffe_pool_out_dim,
    normalize_spatial_param,
)
from eco_tpu_torch.ops import poolk
from eco_tpu_torch.ops.layout import extract_windows, pad_spatial
from eco_tpu_torch.utils.tracing import COUNTS, span

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _windows(x, kernel, stride):
    """(N, *spatial, C) -> strided view (N, *out, C, *kernel)."""
    for axis, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(1 + axis, k, s)
    return x


@functools.cache
def ave_divisors(spatial, kernel, stride, pad, device) -> torch.Tensor:
    """The f32 AVE divisor grid (*out, 1) of one geometry, on ``device``;
    cached, so a pool copies it from the host only at its first call."""
    div = np.ones((), dtype=np.float32)
    for axis, (size, k, s, p) in enumerate(zip(spatial, kernel, stride, pad)):
        d = np.asarray(caffe_avg_pool_divisors(size, k, s, p), dtype=np.float32)
        shape = [1] * len(spatial)
        shape[axis] = len(d)
        div = div * d.reshape(shape)
    return torch.from_numpy(div.reshape(div.shape + (1,))).to(device)


def pool_nd(
    x: torch.Tensor,
    *,
    kernel=None,
    stride=1,
    pad=0,
    mode: str = "max",
    global_pooling: bool = False,
) -> torch.Tensor:
    """Pool over the spatial axes of a channels-last (N, *spatial, C) tensor."""
    num_spatial = x.ndim - 2
    if global_pooling:
        kernel = tuple(x.shape[1:-1])
        stride = (1,) * num_spatial
        pad = (0,) * num_spatial
    kernel = normalize_spatial_param(kernel, num_spatial)
    stride = normalize_spatial_param(stride, num_spatial, default=1)
    pad = normalize_spatial_param(pad, num_spatial, default=0)
    mode = mode.lower()
    if mode in ("avg", "mean"):
        mode = "ave"
    if mode not in ("max", "ave"):
        raise ValueError(f"unknown pool mode {mode!r}")
    # a trace (torch.export) has symbolic sizes and no work to count
    if not (x.is_meta or torch.compiler.is_compiling()):
        out = math.prod(caffe_pool_out_dim(size, k, s, p)[0]
                        for size, k, s, p in zip(x.shape[1:-1], kernel, stride, pad))
        COUNTS["pool.bytes"] += (x.numel() + x.shape[0] * out * x.shape[-1]) * x.element_size()
    if poolk.takes(x, mode):
        return poolk.launch(x, kernel, stride, pad, mode)
    if x.device.type == "cuda" and x.dtype.is_floating_point:
        COUNTS["pool.route"] += 1
    return padded_pool(x, kernel, stride, pad, mode)


def padded_pool(x: torch.Tensor, kernel, stride, pad, mode: str) -> torch.Tensor:
    """The padded route of :func:`pool_nd` ("max" or "ave"; ``kernel``,
    ``stride`` and ``pad`` one entry a spatial axis), and K4's plain
    version."""
    num_spatial = x.ndim - 2
    spatial = tuple(x.shape[1:-1])
    dims = [caffe_pool_out_dim(size, k, s, p) for size, k, s, p in zip(spatial, kernel, stride, pad)]
    out = [dim for dim, _ in dims]
    pad_cfg = [(p, pad_hi) for p, (_, pad_hi) in zip(pad, dims)]
    if mode == "max":
        if x.dtype.is_floating_point:
            xp = pad_spatial(x, pad_cfg, float("-inf"))
            y = _MAX_POOL[num_spatial](xp.movedim(-1, 1), kernel, stride)
            with span("eco.layout"):
                return y.movedim(1, -1).contiguous()
        xp = pad_spatial(x, pad_cfg, torch.iinfo(x.dtype).min)
        return _windows(xp, kernel, stride).amax(dim=tuple(range(-num_spatial, 0)))
    # ATen's own pads where it takes them and its ceil rule gives Caffe's dims,
    # and no gradient is asked: ATen's CUDA backward of this call put an f32
    # train step of ECO-Lite 0.27-0.29 (relative L2 of the update) off the
    # CPU's on an H100, where the zero-padded call's backward agrees
    if (x.dtype.is_floating_point and num_spatial < 3
            and not (torch.is_grad_enabled() and x.requires_grad)) and all(
            p <= k // 2 and (p or (dim - 1) * s < size)
            for size, k, s, p, dim in zip(spatial, kernel, stride, pad, out)):
        y = _AVG_POOL[num_spatial](x.movedim(-1, 1), kernel, stride, pad, ceil_mode=True,
                                   count_include_pad=True)
        return y.movedim(1, -1).contiguous()
    xp = pad_spatial(x.float(), pad_cfg, 0.0).movedim(-1, 1)
    if num_spatial == 1:  # ATen's 1D average pool takes no divisor
        acc = F.avg_pool2d(xp[:, :, None], (1, *kernel), (1, *stride), divisor_override=1)[:, :, 0]
    else:
        acc = _AVG_POOL[num_spatial](xp, kernel, stride, divisor_override=1)
    # a trace (torch.export) makes its own grid: a tensor made inside one
    # trace must not be cached for the next
    divisors = ave_divisors.__wrapped__ if torch.compiler.is_compiling() else ave_divisors
    div = divisors(spatial, tuple(kernel), tuple(stride), tuple(pad), x.device)
    return (acc.movedim(1, -1) / div).to(x.dtype).contiguous()


def extract_pool_windows(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """(N, *spatial, C) -> (N, *out, C, K) windows, K = prod(kernel), the
    offsets in row-major (Caffe im2col) order.  Windows start at
    ``i * stride`` with no padding, as the reference's stochastic kernels
    index them; the last ones are clipped at the border, their missing cells
    zero, which both stochastic modes treat as absent."""
    num_spatial = x.ndim - 2
    kernel = normalize_spatial_param(kernel, num_spatial)
    stride = normalize_spatial_param(stride, num_spatial, default=1)
    spatial = x.shape[1:-1]
    outs = [caffe_pool_out_dim(size, k, s, 0)[0]
            for size, k, s in zip(spatial, kernel, stride)]
    need = [max(0, (o - 1) * s + k - size)
            for o, s, k, size in zip(outs, stride, kernel, spatial)]
    xp = pad_spatial(x, [(0, n) for n in need], 0.0)
    return extract_windows(xp, kernel, stride, outs)


def stochastic_pool(x: torch.Tensor, kernel, stride=1, *, train: bool,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """STOCHASTIC pooling (pooling_layer.cu StoPoolForwardTrain/Test) on a
    channels-last tensor (twin of ``eco_tpu/ops/pool.py:stochastic_pool``),
    over the windows of :func:`extract_pool_windows`.

    TRAIN picks one activation a window with probability proportional to its
    value, by the Gumbel-max over ``log(x)`` as the reference does, with
    noise from ``generator`` (its bits are not ``jax.random.gumbel``'s);
    assumes non-negative inputs (post-ReLU).  TEST is the probability-
    weighted mean ``sum(x^2) / (FLT_MIN + sum(x))``.
    """
    windows = extract_pool_windows(x, kernel, stride)  # (N, *out, C, K)
    wf = windows.float()
    if not train:
        num = wf.square().sum(dim=-1)
        den = wf.sum(dim=-1) + float(np.finfo(np.float32).tiny)
        return (num / den).to(x.dtype)
    if generator is None:
        raise ValueError("stochastic_pool(train=True) needs a generator")
    u = torch.rand(wf.shape, generator=generator, device=generator.device).to(wf.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(float(np.finfo(np.float32).tiny))))
    pick = (torch.log(wf.clamp_min(0.0)) + gumbel).argmax(dim=-1, keepdim=True)
    return windows.gather(-1, pick).squeeze(-1).to(x.dtype)


def max_pool(x, kernel, stride=1, pad=0):
    return pool_nd(x, kernel=kernel, stride=stride, pad=pad, mode="max")


def avg_pool(x, kernel, stride=1, pad=0):
    return pool_nd(x, kernel=kernel, stride=stride, pad=pad, mode="ave")


def global_avg_pool(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """Global spatial mean taken in f32 -- the (4,7,7) head pool."""
    dims = tuple(range(1, x.ndim - 1))
    return x.mean(dim=dims, keepdim=keepdims, dtype=torch.float32).to(x.dtype)


def _c_round(v: torch.Tensor) -> torch.Tensor:
    """C's round(): half away from zero (``torch.round`` rounds half to even)."""
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


def _roi_bins(start, size, pooled: int, extent: int):
    """Each ROI's bin p covers [lo, hi) of an axis of ``extent`` cells:
    ``lo = floor(p * size / pooled) + start``, ``hi = ceil((p + 1) * size /
    pooled) + start``, both clipped into the axis; (R, pooled) int64 each."""
    p = torch.arange(pooled, dtype=torch.float32, device=start.device)
    # a true division: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can land an ulp off a whole bin edge
    bin_size = (size / torch.full((), pooled, dtype=torch.float32, device=start.device))[:, None]
    lo = (torch.floor(p * bin_size) + start[:, None]).clamp(0, extent)
    hi = (torch.ceil((p + 1) * bin_size) + start[:, None]).clamp(0, extent)
    return lo.long(), hi.long()


def _widest(lo: torch.Tensor, hi: torch.Tensor) -> int:
    return int((hi - lo).max().clamp_min(1))


def roi_max_pool(x: torch.Tensor, rois: torch.Tensor, *, pooled_h: int, pooled_w: int,
                 spatial_scale: float = 1.0) -> torch.Tensor:
    """Fast R-CNN ROI max pooling (roi_pooling_layer.cpp:28-130; twin of
    ``eco_tpu/ops/pool.py:roi_max_pool``).

    ``x``: (N, H, W, C) channels-last; ``rois``: (R, 5) rows ``[batch_index,
    x1, y1, x2, y2]`` in input-image coordinates, scaled by
    ``spatial_scale`` and rounded half away from zero.  Each ROI is split
    into ``pooled_h x pooled_w`` bins from floor/ceil (see ``_roi_bins``)
    and max-pooled; an empty bin gives 0.  Returns (R, pooled_h, pooled_w,
    C) in ``x``'s type, the max taken in f32.

    The reference masks the whole map for every bin, an (R, pooled_h, H,
    W, C) intermediate.  Here each bin's rows are gathered from its ROI's
    image cell by cell and reduced, (R, pooled_h, W, C), then each bin's
    columns of that, (R, pooled_h, pooled_w, C): as many gathers a pass as
    the widest bin has cells, each the size of the pass's output.  Counting
    them reads the bins' extents back to the host: one stream sync a call.
    Ties share the gradient evenly (``amax``), as the reference's ``max``.
    """
    n, h, w, c = x.shape
    if x.is_meta:  # shape propagation (Program.init): no extents to read
        return x.new_empty((rois.shape[0], pooled_h, pooled_w, c))
    rf = rois.float()
    start_w, start_h = _c_round(rf[:, 1] * spatial_scale), _c_round(rf[:, 2] * spatial_scale)
    end_w, end_h = _c_round(rf[:, 3] * spatial_scale), _c_round(rf[:, 4] * spatial_scale)
    roi_h = (end_h - start_h + 1.0).clamp_min(1.0)
    roi_w = (end_w - start_w + 1.0).clamp_min(1.0)
    lo_h, hi_h = _roi_bins(start_h, roi_h, pooled_h, h)
    lo_w, hi_w = _roi_bins(start_w, roi_w, pooled_w, w)
    batch = rois[:, 0].long()[:, None]
    picks = []
    for o in range(_widest(lo_h, hi_h)):
        cells = x[batch, (lo_h + o).clamp_max(h - 1)].float()        # (R, PH, W, C)
        picks.append(torch.where((lo_h + o < hi_h)[..., None, None], cells, float("-inf")))
    rows = torch.stack(picks).amax(dim=0)
    picks = []
    r = torch.arange(len(rois), device=x.device)[:, None]
    for o in range(_widest(lo_w, hi_w)):
        cells = rows[r, :, (lo_w + o).clamp_max(w - 1)].transpose(1, 2)  # (R, PH, PW, C)
        picks.append(torch.where((lo_w + o < hi_w)[:, None, :, None], cells, float("-inf")))
    out = torch.stack(picks).amax(dim=0)
    return torch.where(torch.isfinite(out), out, 0.0).to(x.dtype)
