"""Softmax, SoftmaxWithLoss and top-k accuracy (twin of ``eco_tpu/ops/loss.py``).

- ``softmax_cross_entropy`` is Caffe's SoftmaxWithLoss
  (softmax_loss_layer.cpp): log-sum-exp NLL with ``ignore_label`` and the
  normalization modes VALID (the default), BATCH_SIZE, FULL and NONE;
- ``topk_accuracy`` is the Accuracy layer (accuracy_layer.cpp): a row counts
  when fewer than k classes have a strictly larger logit than the true one,
  so ties count in its favour.

All reductions run in f32 whatever the activation type.
"""

from __future__ import annotations

from typing import Optional

import torch


def softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(logits.dtype)


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[i, labels[i]]; an out-of-range label (an ignored one) reads
    column 0, and the caller masks it."""
    idx = labels.long()
    idx = torch.where((idx >= 0) & (idx < logits.shape[-1]), idx, torch.zeros_like(idx))
    return logits.gather(-1, idx[:, None])[:, 0]


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_label: Optional[int] = None,
    normalization: str = "valid",
) -> torch.Tensor:
    """logits: (N, C); labels: (N,) int.  Returns the scalar loss, f32."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - _picked(logits, labels)
    n = logits.shape[0]
    count = n
    if ignore_label is not None:
        valid = labels != ignore_label
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        count = torch.clamp(valid.float().sum(), min=1.0)
    total = nll.sum()
    normalization = normalization.lower()
    if normalization == "valid":
        return total / count
    if normalization in ("batch_size", "full"):
        return total / n
    if normalization == "none":
        return total
    raise ValueError(f"unknown normalization {normalization!r}")


def topk_accuracy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    k: int = 1,
    *,
    ignore_label: Optional[int] = None,
) -> torch.Tensor:
    """Fraction of rows whose true label is within the top-k logits."""
    logits = logits.float()
    rank = (logits > _picked(logits, labels)[:, None]).sum(dim=-1)
    correct = (rank < k).float()
    if ignore_label is not None:
        valid = (labels != ignore_label).float()
        return (correct * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return correct.mean()
