"""ReLU, GELU, dropout, eltwise, channel concat, and the pointwise and
normalizing tail: threshold, BNLL, MVN and LRN
(twin of ``eco_tpu/ops/elementwise.py``).

ReLU's gradient at exactly 0 is 0 here, as in Caffe's backward; the
reference's ``jnp.maximum(x, 0)`` gives 0.5 there.
"""

from __future__ import annotations

from typing import Sequence

import torch


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope:
        return torch.where(x >= 0, x, negative_slope * x)
    return torch.relu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU, ``x * Phi(x)`` by erf (``nn.GELU``'s default), computed
    in f32 inside the op for a low-precision ``x``."""
    return torch.nn.functional.gelu(x)


def dropout(x: torch.Tensor, rate: float, *, train: bool = False,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Caffe inverted dropout (dropout_layer.cpp): at TRAIN each value is kept
    with probability ``keep = 1 - rate`` and divided by ``keep``; at TEST it
    is the identity.  The mask is drawn from ``generator``, which must live
    on ``x``'s device; it does not reproduce ``jax.random.bernoulli``'s bits."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout(train=True) needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def eltwise(
    inputs: Sequence[torch.Tensor],
    op: str = "sum",
    coeffs: Sequence[float] | None = None,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Eltwise PROD / SUM (with coefficients) / MAX (eltwise_layer.cpp), and
    the fork's STOCHASTIC_SUM (eltwise_layer.cpp:101-118): at TRAIN each
    bottom is included with probability ``coeff[i]`` (default 1), one draw
    per bottom from ``generator``; at TEST it is the coefficient-weighted
    sum.  The draws do not reproduce ``jax.random.uniform``'s bits."""
    op = op.lower()
    if op == "prod":
        out = inputs[0]
        for t in inputs[1:]:
            out = out * t
        return out
    if op == "max":
        out = inputs[0]
        for t in inputs[1:]:
            out = torch.maximum(out, t)
        return out
    if op not in ("sum", "stochastic_sum"):
        raise ValueError(f"unknown eltwise op {op!r}")
    if coeffs is None:
        coeffs = (1.0,) * len(inputs)
    if op == "stochastic_sum" and train:
        if generator is None:
            raise ValueError("stochastic_sum(train=True) needs a generator")
        u = torch.rand(len(inputs), generator=generator, device=generator.device)
        out = None
        for i, (c, t) in enumerate(zip(coeffs, inputs)):
            term = (u[i] <= c).to(t.device, t.dtype) * t
            out = term if out is None else out + term
        return out
    out = None
    for c, t in zip(coeffs, inputs):
        term = t if c == 1.0 else c * t
        out = term if out is None else out + term
    return out


def concat_channels(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Caffe Concat(axis=1) == channels-last concat on the final axis."""
    return torch.cat(list(inputs), dim=-1)


def threshold(x: torch.Tensor, t: float = 0.0) -> torch.Tensor:
    """Step function (threshold_layer.cpp): 1 where ``x > t``, else 0; it has
    no gradient, as Caffe declares no Backward for it."""
    return (x > t).to(x.dtype)


def bnll(x: torch.Tensor) -> torch.Tensor:
    """Binomial normal log-likelihood (bnll_layer.cpp), ``log(1 + exp(x))``,
    in the overflow-stable softplus form, computed in f32."""
    return torch.nn.functional.softplus(x.float()).to(x.dtype)


def mvn(x: torch.Tensor, *, across_channels: bool = False,
        normalize_variance: bool = True, eps: float = 1e-9) -> torch.Tensor:
    """Mean-variance normalization (mvn_layer.cpp) on a channels-last tensor,
    per sample over the spatial axes of each channel, or over channels too
    when ``across_channels``.  As the reference: var = E[x^2] - E[x]^2, and
    eps is added OUTSIDE the square root, ``(x - mean) / (sqrt(var) + eps)``."""
    xf = x.float()
    dims = tuple(range(1, x.ndim - 1)) + ((x.ndim - 1,) if across_channels else ())
    mean = xf.mean(dim=dims, keepdim=True)
    y = xf - mean
    if normalize_variance:
        var = xf.square().mean(dim=dims, keepdim=True) - mean.square()
        y = y / (var.sqrt() + eps)
    return y.to(x.dtype)


def lrn(x: torch.Tensor, *, local_size: int = 5, alpha: float = 1.0, beta: float = 0.75,
        k: float = 1.0) -> torch.Tensor:
    """Local response normalization ACROSS_CHANNELS (lrn_layer.cpp) over the
    last (channel) axis: ``x / (k + alpha/n * sum of x^2 over the n channels
    centred on it)^beta``, the window zero-padded at the ends, in f32.  The
    window sum is taken over a strided view of the padded squares (the
    reference takes differences of a running sum)."""
    xf = x.float()
    half = local_size // 2
    sq = torch.nn.functional.pad(xf.square(), (half, half))
    window = sq.unfold(-1, local_size, 1).sum(dim=-1)
    return (xf / (k + (alpha / local_size) * window).pow(beta)).to(x.dtype)
