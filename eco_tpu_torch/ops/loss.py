"""Softmax over the class axis, in f32 and cast back
(twin of ``eco_tpu/ops/loss.py:softmax``)."""

from __future__ import annotations

import torch


def softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(logits.dtype)
