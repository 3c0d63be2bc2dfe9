"""Shape arithmetic matching the reference Caffe semantics.

Caffe computes conv output dims with floor and pool output dims with ceil
(plus a clip so the last window starts inside the padded image); see
reference ``src/caffe/layers/base_conv_layer.cpp`` and
``src/caffe/layers/pooling_layer.cpp:84-149``.  These helpers are pure
Python on static shapes -- everything is resolved at trace time so XLA sees
only static shapes.
"""

from __future__ import annotations

import math


def normalize_spatial_param(value, num_spatial: int, default=0):
    """Expand a Caffe-style repeated spatial param to one int per axis.

    Caffe proto allows ``kernel_size: 3`` (broadcast), ``kernel_size: [3,3,3]``
    (per-axis), or ``kernel_h/kernel_w`` pairs (handled by callers).  Mirrors
    ``BaseConvolutionLayer::LayerSetUp`` (reference base_conv_layer.cpp:13-80).
    """
    if value is None:
        return (default,) * num_spatial
    if isinstance(value, (int, float)):
        return (int(value),) * num_spatial
    value = tuple(int(v) for v in value)
    if len(value) == 0:
        return (default,) * num_spatial
    if len(value) == 1:
        return value * num_spatial
    if len(value) != num_spatial:
        raise ValueError(
            f"spatial param {value} does not match {num_spatial} spatial axes"
        )
    return value


def conv_pads(value, num_spatial: int) -> tuple[tuple[int, int], ...]:
    """A conv's padding as one ``(lo, hi)`` pair an axis.

    ``value`` is Caffe's symmetric ``pad`` (anything
    :func:`normalize_spatial_param` takes) or one ``(lo, hi)`` pair an
    axis, the form an asymmetric padding takes in a graph (TF's "SAME" at
    stride 2 on an even size pads one more cell at the end)."""
    if isinstance(value, (list, tuple)) and any(isinstance(v, (list, tuple)) for v in value):
        if len(value) != num_spatial or any(len(v) != 2 for v in value):
            raise ValueError(f"pad {value} is not one (lo, hi) pair for each of "
                             f"{num_spatial} spatial axes")
        return tuple((int(lo), int(hi)) for lo, hi in value)
    return tuple((p, p) for p in normalize_spatial_param(value, num_spatial, default=0))


def caffe_conv_out_dim(in_size: int, k: int, s: int, p: int, dilation: int = 1) -> int:
    """floor((in + 2p - k_ext)/s) + 1 with k_ext = dilation*(k-1)+1."""
    k_ext = dilation * (k - 1) + 1
    return (in_size + 2 * p - k_ext) // s + 1


def caffe_pool_out_dim(in_size: int, k: int, s: int, p: int) -> tuple[int, int]:
    """Caffe pooling output dim (ceil mode) and the required high padding.

    Returns ``(out, pad_hi)`` where ``pad_hi`` is the amount of implicit
    padding needed past the end of the input so that
    ``reduce_window`` with padding ``(p, pad_hi)`` reproduces Caffe's ceil
    semantics (reference pooling_layer.cpp:84-111: ceil, then drop the last
    window if it would start beyond ``in + p``).
    """
    out = int(math.ceil((in_size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= in_size + p:
        out -= 1
    pad_hi = (out - 1) * s + k - in_size - p
    return out, pad_hi


def caffe_avg_pool_divisors(in_size: int, k: int, s: int, p: int) -> list[int]:
    """Per-output-position divisor for Caffe AVE pooling along one axis.

    Caffe divides by the window area clipped to the *padded* image extent
    (reference pooling_layer.cpp:156-164): ``pool_size`` is computed after
    clipping ``hend`` to ``in + p`` but before clipping to the real image, so
    zero padding participates in the denominator except at the far edge.
    """
    out, _ = caffe_pool_out_dim(in_size, k, s, p)
    divs = []
    for j in range(out):
        start = j * s - p
        end = min(start + k, in_size + p)
        divs.append(end - start)
    return divs
