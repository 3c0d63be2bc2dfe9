"""Solver family with exact reference-Caffe update semantics.

Twin of ``eco_tpu/train/solver.py``: ``SGDSolver/NesterovSolver/
AdaGradSolver`` (solver.cpp:620-900) as one functional step,
``step(ts, batch, generator) -> (ts, metrics)``:

1. gradients are *accumulated raw* over ``iter_size`` micro-batches
   (Solver::Step, solver.cpp:195-215), a loop over the batch's leading
   micro-batch axis that threads the BN state through;
2. ``ClipGradients`` on the accumulated grads: global L2 over all params,
   scale by clip/norm when norm > clip (solver.cpp:636-659);
3. ``Normalize``: grads /= iter_size (solver.cpp:676-700);
4. ``Regularize``: g += weight_decay * decay_mult * w (L2) or * sign(w) (L1)
   (solver.cpp:703-760);
5. update value:
   - SGD:       h' = m*h + local_rate*g;            u = h'
   - Nesterov:  h' = m*h + local_rate*g;            u = (1+m)*h' - m*h
     (solver.cpp:820-870)
   - AdaGrad:   hist' = hist + g^2;  u = local_rate * g / (sqrt(hist') + delta)
6. w -= u  (Net::Update).

``local_rate = lr_policy(iter) * lr_mult`` with per-blob lr_mult/decay_mult
from the graph's ParamSpecs.  Gradients come from ``torch.autograd.grad``
over the param tensors; the update runs under ``torch.no_grad()`` and builds
new tensors, so the step leaves its input ``TrainState`` as it was.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch

from eco_tpu_torch.runtime.memory import apply_with_remat
from eco_tpu_torch.spec.graph import GraphSpec, ParamSpec
from eco_tpu_torch.train.lr_policies import learning_rate


@dataclass(frozen=True)
class SolverConfig:
    """Mirror of SolverParameter (caffe.proto:103-214); a copy of
    ``eco_tpu.train.solver.SolverConfig``, whose module imports JAX."""

    base_lr: float = 0.001
    lr_policy: str = "step"
    gamma: float = 0.1
    stepsize: int = 24000
    stepvalues: tuple[int, ...] = ()
    power: float = 1.0
    max_iter: int = 60000
    momentum: float = 0.9
    weight_decay: float = 0.0005
    regularization_type: str = "L2"
    clip_gradients: float = -1.0
    iter_size: int = 1
    solver_type: str = "nesterov"  # sgd | nesterov | adagrad
    delta: float = 1e-8  # adagrad
    # bookkeeping (host-side)
    display: int = 20
    average_loss: int = 1
    snapshot: int = 1000
    snapshot_prefix: str = "snapshots/eco"
    test_iter: int = 0
    test_interval: int = 0
    random_seed: int = 0


@dataclass
class TrainState:
    params: Any
    state: Any  # BN running stats
    history: Any  # momentum / adagrad accumulator, same structure as params
    it: int  # iteration counter, on the host


# Caffe blob positions for our param names (LayerParameter.param ordering:
# weights/slope first, bias second); other names take their position in
# sorted order, as the reference's pytrees do.
_PARAM_POS = {"w": 0, "gamma": 0, "scale": 0, "b": 1, "beta": 1, "shift": 1}


def param_multipliers(graph: GraphSpec, params) -> tuple[Any, Any]:
    """Per-blob (lr_mult, decay_mult) trees from the graph's ParamSpecs."""
    lr, decay = {}, {}
    for lname, lp in params.items():
        spec = graph.layer(lname)
        lr[lname], decay[lname] = {}, {}
        for i, pname in enumerate(sorted(lp)):
            pos = _PARAM_POS.get(pname, i)
            m = spec.params[pos] if pos < len(spec.params) else ParamSpec()
            lr[lname][pname] = m.lr_mult
            decay[lname][pname] = m.decay_mult
    return lr, decay


def init_train_state(params, state) -> TrainState:
    history = {ln: {k: torch.zeros_like(v) for k, v in lp.items()}
               for ln, lp in params.items()}
    return TrainState(params, state, history, 0)


def make_train_step(program, cfg: SolverConfig, *, remat: Optional[str] = None):
    """Returns ``step(ts, batch, generator) -> (ts, metrics)``.

    ``batch`` values carry a leading micro-batch axis of length
    ``cfg.iter_size`` (shape [1, ...] without accumulation).  ``generator``
    seeds the step's randomness (dropout); a CPU generator costs no device
    synchronisation.  Metrics are ``loss`` (the mean over micro-batches),
    ``lr`` and ``grad_norm`` (0 without clipping), as tensors.  ``remat``
    is a policy of ``runtime/memory.py`` ("dots", "nothing", "everything"
    or None); it changes the step's memory and time, not its values.
    """
    apply = apply_with_remat(program, remat)
    solver_type = cfg.solver_type.lower()
    if solver_type not in ("sgd", "nesterov", "adagrad"):
        raise ValueError(f"unknown solver_type {cfg.solver_type!r}")

    def update_one(w, g, h, rate, lm, dm):
        g = g.float() / cfg.iter_size  # 3. Normalize
        wd = cfg.weight_decay * dm
        if cfg.regularization_type.upper() == "L1":
            g = g + wd * torch.sign(w)
        else:
            g = g + wd * w  # 4. Regularize (L2)
        local_rate = rate * lm
        if solver_type == "adagrad":
            h_new = h + g.square()
            u = local_rate * g / (torch.sqrt(h_new) + cfg.delta)
        elif solver_type == "nesterov":
            h_new = cfg.momentum * h + local_rate * g
            u = (1.0 + cfg.momentum) * h_new - cfg.momentum * h
        else:
            h_new = cfg.momentum * h + local_rate * g
            u = h_new
        return w - u, h_new

    def step(ts: TrainState, batch: Mapping[str, Any],
             generator: Optional[torch.Generator] = None):
        lr_tree, decay_tree = param_multipliers(program.graph, ts.params)
        keys = [(ln, pn) for ln, lp in ts.params.items() for pn in lp]
        leaves = [ts.params[ln][pn].detach().requires_grad_() for ln, pn in keys]
        params: dict = {}
        for (ln, pn), leaf in zip(keys, leaves):
            params.setdefault(ln, {})[pn] = leaf

        # 1. raw gradients summed over the micro-batches, whatever the
        # caller's grad mode
        gsum = None
        state = ts.state
        losses = []
        for i in range(cfg.iter_size):
            micro = {k: v[i] for k, v in batch.items()}
            with torch.enable_grad():
                outs, state = apply(params, state, micro, generator=generator)
                loss = program.total_loss(outs)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g for w, g in zip(leaves, grads)]
            gsum = grads if gsum is None else [a + b for a, b in zip(gsum, grads)]
            losses.append(loss.detach())

        with torch.no_grad():
            # 2. global-norm clip on the ACCUMULATED grads (solver.cpp:636-659)
            if cfg.clip_gradients > 0:
                gnorm = torch.sqrt(sum(g.float().square().sum() for g in gsum))
                clip = torch.full_like(gnorm, cfg.clip_gradients)
                scale = torch.where(gnorm > clip, clip / gnorm, torch.ones_like(gnorm))
                gsum = [g * scale for g in gsum]
            else:
                gnorm = torch.zeros(())
            rate = learning_rate(cfg, ts.it)
            new_params: dict = {}
            new_history: dict = {}
            for (ln, pn), g in zip(keys, gsum):
                nw, nh = update_one(ts.params[ln][pn], g, ts.history[ln][pn], rate,
                                    lr_tree[ln][pn], decay_tree[ln][pn])
                new_params.setdefault(ln, {})[pn] = nw
                new_history.setdefault(ln, {})[pn] = nh
        metrics = {"loss": torch.stack(losses).mean(), "lr": rate, "grad_norm": gnorm}
        return TrainState(new_params, state, new_history, ts.it + 1), metrics

    return step


def make_eval_step(program):
    """Test-phase forward collecting the graph's scalar metric tops
    (Solver::Test, solver.cpp:450-518)."""

    def eval_step(params, state, batch):
        with torch.no_grad():
            outs, _ = program.apply(params, state, batch)
        return {k: v for k, v in outs.items() if v.ndim == 0}

    return eval_step
