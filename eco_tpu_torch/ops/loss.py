"""Softmax, the losses and top-k accuracy (twin of ``eco_tpu/ops/loss.py``,
and of the losses its executor computes inline).

- ``softmax_cross_entropy`` is Caffe's SoftmaxWithLoss
  (softmax_loss_layer.cpp): log-sum-exp NLL with ``ignore_label`` and the
  normalization modes VALID (the default), BATCH_SIZE, FULL and NONE;
- ``topk_accuracy`` is the Accuracy layer (accuracy_layer.cpp): a row counts
  when fewer than k classes have a strictly larger logit than the true one,
  so ties count in its favour;
- the rest of Caffe's losses: Hinge, SigmoidCrossEntropy, Infogain,
  Contrastive, Euclidean, MultinomialLogistic and the Fast R-CNN SmoothL1,
  each normalized as its reference layer is (by the batch size).

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


def hinge_loss(logits: torch.Tensor, labels: torch.Tensor, *, norm: str = "l1") -> torch.Tensor:
    """One-vs-all hinge loss (hinge_loss_layer.cpp): the true-class logit is
    negated, then ``max(0, 1 + m)`` per value; L1 sums the margins, L2 their
    squares; both divide by the batch size."""
    x = logits.float()
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[-1]).float()
    m = torch.clamp_min(1.0 + x * (1.0 - 2.0 * onehot), 0.0)
    if norm.lower() == "l2":
        return m.square().sum() / x.shape[0]
    return m.sum() / x.shape[0]


def sigmoid_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Fused sigmoid + binary cross-entropy
    (sigmoid_cross_entropy_loss_layer.cpp) in the stable form
    ``max(x, 0) - x t + log(1 + exp(-|x|))``, divided by the batch size."""
    x, t = logits.float(), targets.float()
    elem = torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return elem.sum() / x.shape[0]


def infogain_loss(probs: torch.Tensor, labels: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Infogain loss (infogain_loss_layer.cpp) on probabilities:
    ``-1/N sum_i sum_j H[label_i, j] log(max(p_ij, 1e-20))``."""
    p = probs.float()
    rows = H.float()[labels.long()]
    return -(rows * torch.log(torch.clamp_min(p, 1e-20))).sum() / p.shape[0]


def contrastive_loss(a: torch.Tensor, b: torch.Tensor, similar: torch.Tensor, *,
                     margin: float = 1.0, legacy: bool = False) -> torch.Tensor:
    """Siamese contrastive loss (contrastive_loss_layer.cpp), with
    ``d2 = ||a - b||^2`` per row: ``1/(2N) sum(y d2 + (1 - y) max(margin -
    sqrt(d2), 0)^2)``; ``legacy`` takes ``max(margin - d2, 0)`` instead."""
    n = a.shape[0]
    d2 = (a.float().reshape(n, -1) - b.float().reshape(n, -1)).square().sum(dim=-1)
    y = similar.float().reshape(-1)
    if legacy:
        dissim = torch.clamp_min(margin - d2, 0.0)
    else:
        dissim = torch.clamp_min(margin - torch.sqrt(torch.clamp_min(d2, 1e-12)), 0.0).square()
    return (y * d2 + (1.0 - y) * dissim).sum() / (2.0 * n)


def euclidean_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``0.5/N * sum((a - b)^2)`` (euclidean_loss_layer.cpp)."""
    return 0.5 * (a.float() - b.float()).square().sum() / a.shape[0]


def multinomial_logistic_loss(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLL of already-softmaxed probabilities
    (multinomial_logistic_loss_layer.cpp): ``-1/N sum log(max(p[i, label_i],
    1e-20))``."""
    picked = _picked(probs.float(), labels)
    return -torch.log(torch.clamp_min(picked, 1e-20)).sum() / probs.shape[0]


def smooth_l1_loss(a: torch.Tensor, b: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fast R-CNN smooth-L1 (smooth_L1_loss_layer.cu:13-50): ``d = w (a -
    b)``, ``f(d) = 0.5 d^2`` where ``|d| < 1``, else ``|d| - 0.5``, summed
    and divided by the batch size."""
    d = a.float() - b.float()
    if weights is not None:
        d = d * weights.float()
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d.square(), ad - 0.5).sum() / a.shape[0]
