"""Batch norm, inference and train, per-channel affine
(twin of ``eco_tpu/ops/norm.py``), and the port's layer norm.

All math runs in f32 on the channel-last axis and is cast back to the input
type, as in the reference.  Train mode is Caffe's BN layer
(bn_layer.cpp:93-158): biased batch moments E[x^2] - E[x]^2, and a running
update ``(1 - m) * batch + m * running`` with the biased variance.  That is
not ``F.batch_norm(training=True)``, whose momentum is ``1 - m`` and whose
running variance is unbiased.
"""

from __future__ import annotations

from typing import Any

import torch

from eco_tpu_torch.ops.collectives import all_reduce_mean

DEFAULT_EPS = 1e-5
DEFAULT_MOMENTUM = 0.9


def fold_scale_shift(gamma, beta, mean, var, *, eps: float = DEFAULT_EPS):
    """BN -> (scale, shift): ``y = x * scale + shift``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return scale, shift


def bn_inference(x, gamma, beta, mean, var, *, eps: float = DEFAULT_EPS):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta, channel = last axis."""
    scale, shift = fold_scale_shift(gamma, beta, mean, var, eps=eps)
    return (x.float() * scale + shift).to(x.dtype)


def bn_train(x, gamma, beta, running_mean, running_var, *, eps: float = DEFAULT_EPS,
             momentum: float = DEFAULT_MOMENTUM, axis_name: Any = None):
    """Training-mode BN.  Returns (y, new_running_mean, new_running_var).

    The running statistics are state, not outputs: they carry no gradient.
    ``axis_name`` -- a process group, or a mesh dimension (``mesh["data"]``)
    -- makes it SyncBN (sync_bn_layer.cu:132-218): the moments ``(E[x],
    E[x^2])`` are averaged over its ranks by one SUM all-reduce of the
    stacked pair divided by the group's size, the reference's ``lax.pmean``
    under equal per-rank counts; the gradient flows back through the same
    mean.  A group of one gives plain ``bn_train`` bit for bit.
    """
    xf = x.float()
    dims = tuple(range(x.ndim - 1))
    mean = xf.mean(dim=dims)
    mean_sq = xf.square().mean(dim=dims)
    if isinstance(axis_name, str):
        raise TypeError(f"axis_name={axis_name!r}: SyncBN takes a process group or a mesh "
                        "dimension (mesh['data']), not a bare axis name")
    if axis_name is not None:
        group = axis_name.get_group() if hasattr(axis_name, "get_group") else axis_name
        mean, mean_sq = all_reduce_mean(torch.stack([mean, mean_sq]), group).unbind(0)
    var = mean_sq - mean.square()
    y = bn_inference(x, gamma, beta, mean, var, eps=eps)
    with torch.no_grad():
        new_mean = (1.0 - momentum) * mean + momentum * running_mean.float()
        new_var = (1.0 - momentum) * var + momentum * running_var.float()
    return y, new_mean.to(running_mean.dtype), new_var.to(running_var.dtype)


def scale_shift(x, scale, shift):
    """Per-channel affine (the Scale layer that stands in for unfoldable BNs)."""
    return (x.float() * scale + shift).to(x.dtype)


def layer_norm(x, gamma, beta, *, eps: float = DEFAULT_EPS):
    """Layer norm over the last (channel) axis of each token: its mean and
    variance in f32, the result cast back to ``x``'s type (``F.layer_norm``
    accumulates a low-precision input in f32); ``gamma`` and ``beta`` are
    cast to that type."""
    c = x.shape[-1]
    return torch.nn.functional.layer_norm(x, (c,), gamma.to(x.dtype), beta.to(x.dtype), eps)
