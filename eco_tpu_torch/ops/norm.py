"""Inference batch norm and per-channel affine (twin of ``eco_tpu/ops/norm.py``).

All math runs in f32 on the channel-last axis and is cast back to the input
type, as in the reference.
"""

from __future__ import annotations

import torch

DEFAULT_EPS = 1e-5


def fold_scale_shift(gamma, beta, mean, var, *, eps: float = DEFAULT_EPS):
    """BN -> (scale, shift): ``y = x * scale + shift``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return scale, shift


def bn_inference(x, gamma, beta, mean, var, *, eps: float = DEFAULT_EPS):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta, channel = last axis."""
    scale, shift = fold_scale_shift(gamma, beta, mean, var, eps=eps)
    return (x.float() * scale + shift).to(x.dtype)


def scale_shift(x, scale, shift):
    """Per-channel affine (the Scale layer that stands in for unfoldable BNs)."""
    return (x.float() * scale + shift).to(x.dtype)
