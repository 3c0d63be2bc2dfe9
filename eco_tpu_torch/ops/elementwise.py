"""ReLU, eval-mode dropout, eltwise and channel concat
(twin of ``eco_tpu/ops/elementwise.py``)."""

from __future__ import annotations

from typing import Sequence

import torch


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope:
        return torch.where(x >= 0, x, negative_slope * x)
    return torch.relu(x)


def dropout(x: torch.Tensor, rate: float, *, train: bool = False) -> torch.Tensor:
    """Caffe inverted dropout is the identity at TEST."""
    if train and rate > 0.0:
        raise NotImplementedError("train-mode dropout is not ported yet")
    return x


def eltwise(
    inputs: Sequence[torch.Tensor],
    op: str = "sum",
    coeffs: Sequence[float] | None = None,
) -> torch.Tensor:
    """Eltwise PROD / SUM (with coefficients) / MAX (eltwise_layer.cpp)."""
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
    if op == "sum":
        if coeffs is None:
            coeffs = (1.0,) * len(inputs)
        out = None
        for c, t in zip(coeffs, inputs):
            term = t if c == 1.0 else c * t
            out = term if out is None else out + term
        return out
    raise ValueError(f"unknown eltwise op {op!r}")


def concat_channels(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Caffe Concat(axis=1) == channels-last concat on the final axis."""
    return torch.cat(list(inputs), dim=-1)
