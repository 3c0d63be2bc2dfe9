"""Batch norm, inference and train, and per-channel affine
(twin of ``eco_tpu/ops/norm.py``).

All math runs in f32 on the channel-last axis and is cast back to the input
type, as in the reference.  Train mode is Caffe's BN layer
(bn_layer.cpp:93-158): biased batch moments E[x^2] - E[x]^2, and a running
update ``(1 - m) * batch + m * running`` with the biased variance.  That is
not ``F.batch_norm(training=True)``, whose momentum is ``1 - m`` and whose
running variance is unbiased.
"""

from __future__ import annotations

from typing import Optional

import torch

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
             momentum: float = DEFAULT_MOMENTUM, axis_name: Optional[str] = None):
    """Training-mode BN.  Returns (y, new_running_mean, new_running_var).

    The running statistics are state, not outputs: they carry no gradient.
    ``axis_name`` (SyncBN across a mesh axis in the reference) is not ported.
    """
    if axis_name is not None:
        raise NotImplementedError("SyncBN (axis_name) is not ported yet")
    xf = x.float()
    dims = tuple(range(x.ndim - 1))
    mean = xf.mean(dim=dims)
    mean_sq = xf.square().mean(dim=dims)
    var = mean_sq - mean.square()
    y = bn_inference(x, gamma, beta, mean, var, eps=eps)
    with torch.no_grad():
        new_mean = (1.0 - momentum) * mean + momentum * running_mean.float()
        new_var = (1.0 - momentum) * var + momentum * running_var.float()
    return y, new_mean.to(running_mean.dtype), new_var.to(running_var.dtype)


def scale_shift(x, scale, shift):
    """Per-channel affine (the Scale layer that stands in for unfoldable BNs)."""
    return (x.float() * scale + shift).to(x.dtype)
