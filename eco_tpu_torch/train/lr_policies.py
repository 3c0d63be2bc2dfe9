"""Learning-rate policies with exact reference semantics
(SGDSolver::GetLearningRate, solver.cpp:580-619), incl. the fork's ``exp10``.

Twin of ``eco_tpu/train/lr_policies.py``.  Computed in f32 on the host, as a
0-d CPU tensor: the update multiplies device tensors by it with no transfer.
"""

from __future__ import annotations

import torch


def learning_rate(cfg, it) -> torch.Tensor:
    """cfg: SolverConfig-like; it: the iteration (int)."""
    it = torch.tensor(float(it), dtype=torch.float32)
    base = cfg.base_lr
    policy = cfg.lr_policy
    if policy == "fixed":
        return torch.full((), base, dtype=torch.float32)
    if policy == "step":
        return base * torch.pow(cfg.gamma, torch.floor(it / cfg.stepsize))
    if policy == "exp":
        return base * torch.pow(cfg.gamma, it)
    if policy == "inv":
        return base * torch.pow(1.0 + cfg.gamma * it, -cfg.power)
    if policy == "multistep":
        # current_step = #stepvalues passed (solver.cpp:595-602)
        steps = torch.tensor(cfg.stepvalues, dtype=torch.float32)
        current = (it >= steps).float().sum()
        return base * torch.pow(cfg.gamma, current)
    if policy == "poly":
        return base * torch.pow(1.0 - it / cfg.max_iter, cfg.power)
    if policy == "sigmoid":
        return base * (1.0 / (1.0 + torch.exp(-cfg.gamma * (it - cfg.stepsize))))
    if policy == "exp10":
        return base * torch.pow(10.0, -it / cfg.stepsize)
    raise ValueError(f"unknown lr_policy {policy!r}")
