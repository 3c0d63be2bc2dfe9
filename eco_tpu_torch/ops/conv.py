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

Dtype policy, as in the reference: the weight is cast to ``x.dtype``, the
convolution output is rounded to ``x.dtype``, and the bias is added in that
type.

Spans (``utils/tracing.py``): ``eco.cast`` around the weight's cast,
``eco.layout`` around the output's move back to channels-last, ``eco.bias``
around the bias's cast and add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eco_tpu_torch.utils.shapes import normalize_spatial_param
from eco_tpu_torch.utils.tracing import span

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


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
    pad = normalize_spatial_param(pad, num_spatial, default=0)
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
