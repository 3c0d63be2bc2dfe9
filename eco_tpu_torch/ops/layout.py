"""Segment-axis layout transforms on channels-last tensors, the logical /
physical bridges, and the window view behind im2col.

Twin of ``eco_tpu/ops/layout.py``.  Blobs are ``(N, *spatial, C)`` and
contiguous, so ``unfold_segments`` is a free reshape: ``(N*S, H, W, C)`` ->
``(N, S, H, W, C)`` *is* NDHWC with the segments as depth, and its
``permute(0, 4, 1, 2, 3)`` is an NCDHW tensor in ``channels_last_3d`` memory,
which is what cuDNN's 3D convolution reads without a copy.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.shapes import normalize_spatial_param
from eco_tpu_torch.utils.tracing import span


def fold_segments(x: torch.Tensor) -> torch.Tensor:
    """(N, S, *spatial, C) -> (N*S, *spatial, C): run segments through a 2D net."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def unfold_segments(x: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(N*S, H, W, C) -> (N, S, H, W, C), a view of a contiguous input."""
    return x.reshape((-1, num_segments) + tuple(x.shape[1:]))


def segment_consensus(x: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean over segments in f32: (N*S, D) -> (N, D)."""
    y = x.reshape((-1, num_segments) + tuple(x.shape[1:]))
    return y.mean(dim=1, dtype=torch.float32).to(x.dtype)


def to_logical(x: torch.Tensor) -> torch.Tensor:
    """channels-last physical -> Caffe NCHW-style logical (ndim >= 3), a view."""
    if x.ndim < 3:
        return x
    return x.movedim(-1, 1)


def to_physical(x: torch.Tensor) -> torch.Tensor:
    """Caffe NCHW-style logical -> contiguous channels-last physical (ndim >= 3),
    in an ``eco.layout`` span."""
    if x.ndim < 3:
        return x
    with span("eco.layout"):
        return x.movedim(1, -1).contiguous()


def pad_spatial(x: torch.Tensor, pads, value=0.0) -> torch.Tensor:
    """Pad the spatial axes of (N, *spatial, C) by [(lo, hi), ...] (negative
    ``hi`` crops), in an ``eco.pad`` span."""
    flat = [0, 0]  # channels (last axis) first: F.pad lists axes from the end
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    with span("eco.pad"):
        return F.pad(x, flat, value=value)


def extract_windows(x: torch.Tensor, kernel, stride, outs, dilation=None) -> torch.Tensor:
    """The window gather shared by :func:`im2col` and
    ``ops.pool.extract_pool_windows``: one strided slice of the (already
    padded) ``(N, *spatial, C)`` input per kernel offset, stacked to
    ``(N, *out, C, K)`` with the offsets in row-major order (Caffe's im2col
    order).  The callers own the padding and the output dims."""
    if dilation is None:
        dilation = (1,) * len(kernel)
    slices = []
    for offs in itertools.product(*[range(k) for k in kernel]):
        idx = (slice(None),) + tuple(
            slice(o * d, o * d + (out - 1) * s + 1, s)
            for o, d, out, s in zip(offs, dilation, outs, stride)
        ) + (slice(None),)
        slices.append(x[idx])
    return torch.stack(slices, dim=-1)


def im2col(x: torch.Tensor, kernel, stride=1, pad=0, dilation=1) -> torch.Tensor:
    """Explicit column view (im2col_layer.cpp, util/im2col.cpp).  Caffe's
    logical output is (N, C*K, *out), column c*K + k_idx with k_idx
    row-major over the kernel offsets; in the channels-last physical layout
    that is (N, *out, C*K)."""
    num_spatial = x.ndim - 2
    kernel = normalize_spatial_param(kernel, num_spatial)
    stride = normalize_spatial_param(stride, num_spatial, default=1)
    pad = normalize_spatial_param(pad, num_spatial, default=0)
    dilation = normalize_spatial_param(dilation, num_spatial, default=1)
    if any(pad):
        flat = [0, 0]  # F.pad lists axes from the last (channels, unpadded)
        for p in reversed(pad):
            flat += [p, p]
        x = F.pad(x, flat)
    outs = [
        (size - d * (k - 1) - 1) // s + 1
        for size, k, s, d in zip(x.shape[1:-1], kernel, stride, dilation)
    ]
    cols = extract_windows(x, kernel, stride, outs, dilation)  # (N, *out, C, K)
    return cols.reshape(cols.shape[:-2] + (-1,))


def caffe_reshape_dims(in_shape, dims, axis: int = 0, num_axes: int = -1):
    """Resolve a Caffe ReshapeParameter shape (0 = copy, -1 = infer).

    Copy of ``eco_tpu.ops.layout.caffe_reshape_dims`` (whose module imports
    JAX); mirrors reshape_layer.cpp on *logical* shapes.
    """
    in_shape = tuple(int(d) for d in in_shape)
    if axis != 0 or num_axes != -1:
        end = len(in_shape) if num_axes == -1 else axis + num_axes
        head, mid, tail = in_shape[:axis], in_shape[axis:end], in_shape[end:]
        return head + caffe_reshape_dims(mid, dims) + tail
    out = []
    infer = None
    for i, d in enumerate(dims):
        if d == 0:
            out.append(in_shape[i])
        elif d == -1:
            if infer is not None:
                raise ValueError("at most one -1 dim")
            infer = i
            out.append(-1)
        else:
            out.append(int(d))
    total = 1
    for d in in_shape:
        total *= d
    if infer is not None:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        out[infer] = total // known
    return tuple(out)
