"""Caffe-semantics ND pooling on channels-last tensors.

Twin of ``eco_tpu/ops/pool.py:pool_nd`` and ``global_avg_pool``.  Caffe's
ceil-mode output dims and last-window clip become an explicit asymmetric
``(pad, pad_hi)`` padding computed statically by
``utils.shapes.caffe_pool_out_dim``; PyTorch's ``ceil_mode=True`` is
not used, because it agrees with Caffe only on some shapes.

- MAX pads with ``-inf`` (the integer minimum for integer types) and then
  takes unpadded windows: ATen's ``max_pool{1,2,3}d`` for floats, a window
  view and ``amax`` for integers, which ATen's pools do not take.  With
  ``ECO_PALLAS_POOL=1``, a float 3x3/s2/pad-0 max pool with even H and W on
  the card goes to the fused kernel of ``ops/poolfuse.py`` instead, as the
  reference's goes to its Pallas kernel on the TPU; that route has no
  backward and raises when a gradient is asked through it.
- AVE sums the zero-padded windows in f32 and divides by the static
  per-position divisor grid of ``caffe_avg_pool_divisors``, so padded cells
  count in the denominator as in pooling_layer.cpp.  The grid is made once
  per geometry and device and kept there: a copy from host memory at every
  call would wait for the stream.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.shapes import (
    caffe_avg_pool_divisors,
    caffe_pool_out_dim,
    normalize_spatial_param,
)
from eco_tpu_torch.ops import poolfuse

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _pad_spatial(x, pad_cfg, value):
    """Pad the spatial axes of (N, *spatial, C) by [(lo, hi), ...] (negative
    ``hi`` crops)."""
    flat = [0, 0]  # channels (last axis) first: F.pad lists axes from the end
    for lo, hi in reversed(pad_cfg):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


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
    spatial = tuple(x.shape[1:-1])
    if global_pooling:
        kernel = spatial
        stride = (1,) * num_spatial
        pad = (0,) * num_spatial
    kernel = normalize_spatial_param(kernel, num_spatial)
    stride = normalize_spatial_param(stride, num_spatial, default=1)
    pad = normalize_spatial_param(pad, num_spatial, default=0)

    pad_cfg = []
    for size, k, s, p in zip(spatial, kernel, stride, pad):
        _, pad_hi = caffe_pool_out_dim(size, k, s, p)
        pad_cfg.append((p, pad_hi))
    window_dims = tuple(range(-num_spatial, 0))

    mode = mode.lower()
    if mode == "max":
        if (os.environ.get("ECO_PALLAS_POOL") == "1" and x.device.type == "cuda"
                and x.dtype.is_floating_point
                and poolfuse.supports(x.shape, kernel, stride, pad, mode)):
            return poolfuse.fused_maxpool_3x3s2(x)
        if x.dtype.is_floating_point:
            xp = _pad_spatial(x, pad_cfg, float("-inf"))
            y = _MAX_POOL[num_spatial](xp.movedim(-1, 1), kernel, stride)
            return y.movedim(1, -1).contiguous()
        xp = _pad_spatial(x, pad_cfg, torch.iinfo(x.dtype).min)
        return _windows(xp, kernel, stride).amax(dim=window_dims)
    if mode in ("ave", "avg", "mean"):
        xp = _pad_spatial(x.float(), pad_cfg, 0.0)
        acc = _windows(xp, kernel, stride).sum(dim=window_dims)
        div = ave_divisors(spatial, kernel, stride, pad, x.device)
        return (acc / div).to(x.dtype)
    raise ValueError(f"unknown pool mode {mode!r}")


def stochastic_pool(x: torch.Tensor, kernel, stride=1, *, train: bool,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """STOCHASTIC pooling (pooling_layer.cu StoPoolForwardTrain/Test) on a
    channels-last tensor (twin of ``eco_tpu/ops/pool.py:stochastic_pool``).

    Windows start at ``i * stride`` with no padding; the last ones are
    clipped at the border, their missing cells zero, which neither mode
    counts.  TRAIN picks one activation a window with probability
    proportional to its value, by the Gumbel-max over ``log(x)`` as the
    reference does, with noise from ``generator`` (its bits are not
    ``jax.random.gumbel``'s); assumes non-negative inputs (post-ReLU).
    TEST is the probability-weighted mean ``sum(x^2) / (FLT_MIN + sum(x))``.
    """
    num_spatial = x.ndim - 2
    kernel = normalize_spatial_param(kernel, num_spatial)
    stride = normalize_spatial_param(stride, num_spatial, default=1)
    spatial = x.shape[1:-1]
    outs = [caffe_pool_out_dim(size, k, s, 0)[0]
            for size, k, s in zip(spatial, kernel, stride)]
    need = [max(0, (o - 1) * s + k - size)
            for o, s, k, size in zip(outs, stride, kernel, spatial)]
    xp = _pad_spatial(x, [(0, n) for n in need], 0.0)
    # (N, *out, C, K), kernel offsets in row-major (Caffe im2col) order
    windows = _windows(xp, kernel, stride).flatten(-num_spatial)
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


def global_avg_pool(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """Global spatial mean taken in f32 -- the (4,7,7) head pool."""
    dims = tuple(range(1, x.ndim - 1))
    return x.mean(dim=dims, keepdim=keepdims, dtype=torch.float32).to(x.dtype)
