"""Channels-last ND convolution and deconvolution
(twin of ``eco_tpu/ops/conv.py``).

A contiguous ``(N, *spatial, C)`` blob viewed through ``movedim(-1, 1)`` is
an NC* tensor in ``channels_last`` / ``channels_last_3d`` memory, so cuDNN
reads it with no copy and writes its output in the same memory format; the
result is moved back to ``(N, *spatial, C)``.  Weights are OIHW / OIDHW,
``(C_out, C_in/groups, *k)``.

``transposed=True`` is Caffe's Deconvolution (deconv_layer.cpp), PyTorch's
``conv_transpose{1,2,3}d``: output ``s*(in-1) + d*(k-1) + 1 - 2p``, the
weight ``(C_in, C_out/groups, *k)``, which is Caffe's deconv blob as it is
(the reference keeps it spatial-first, ``(*k, C_in, C_out/groups)``).

``pad`` is Caffe's symmetric pad, or one ``(lo, hi)`` pair a spatial axis
(``utils/shapes.py:conv_pads``; TF's "SAME" at stride 2 pads one more cell
at the end).  Where some axis has ``lo != hi``, :func:`split_pad` pads the
input once with zeros and the convolution runs with pad 0; a symmetric pad
goes to cuDNN as it is.

Dtype policy, as in the reference: the weight is cast to ``x.dtype``, the
convolution output is rounded to ``x.dtype``, and the bias is added in that
type.

Spans (``utils/tracing.py``): ``eco.cast`` around the weight's cast,
``eco.pad`` around an asymmetric pad's copy, ``eco.layout`` around the
output's move back to channels-last, ``eco.bias`` around the bias's cast
and add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eco_tpu_torch.ops.layout import pad_spatial
from eco_tpu_torch.utils.shapes import conv_pads, normalize_spatial_param
from eco_tpu_torch.utils.tracing import span

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def split_pad(x: torch.Tensor, pad) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(``x``, the symmetric pad a convolution of ``x`` takes): ``x`` as it
    is when every axis pads alike, else ``x`` zero-padded (``lo``, ``hi``)
    on each spatial axis of (N, *spatial, C) and pad 0.  Zero is zero in
    int8 too, so the int8 conv pads its quantized input here alike."""
    if not isinstance(pad, (list, tuple)) or not isinstance(pad[0], (list, tuple)):
        # Caffe's symmetric pad, the common case: no pairs to build
        return x, normalize_spatial_param(pad, x.ndim - 2, default=0)
    pads = conv_pads(pad, x.ndim - 2)
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    return pad_spatial(x, pads), (0,) * len(pads)


def conv_nd(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride=1,
    pad=0,
    dilation=1,
    groups: int = 1,
    transposed: bool = False,
) -> torch.Tensor:
    """``x``: (N, *spatial, C_in); ``w``: (C_out, C_in/groups, *k), or
    (C_in, C_out/groups, *k) when ``transposed``."""
    num_spatial = x.ndim - 2
    stride = normalize_spatial_param(stride, num_spatial, default=1)
    if transposed and any(lo != hi for lo, hi in conv_pads(pad, num_spatial)):
        raise ValueError(f"a deconvolution takes a symmetric pad, got {pad}")
    x, pad = split_pad(x, pad)
    dilation = normalize_spatial_param(dilation, num_spatial, default=1)
    op = (_DECONV if transposed else _CONV)[num_spatial]
    with span("eco.cast"):
        w = w.to(x.dtype)
    y = op(
        x.movedim(-1, 1), w, None,
        stride=stride, padding=pad, dilation=dilation, groups=groups,
    )
    with span("eco.layout"):
        y = y.movedim(1, -1).contiguous()
    if b is not None:
        with span("eco.bias"):
            y = y + b.to(y.dtype)
    return y


def conv2d(x, w, b=None, *, stride=1, pad=0, dilation=1, groups=1):
    assert x.ndim == 4, x.shape
    return conv_nd(x, w, b, stride=stride, pad=pad, dilation=dilation, groups=groups)


def conv3d(x, w, b=None, *, stride=1, pad=0, dilation=1, groups=1):
    assert x.ndim == 5, x.shape
    return conv_nd(x, w, b, stride=stride, pad=pad, dilation=dilation, groups=groups)
