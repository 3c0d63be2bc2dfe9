"""Host-side training loop -- Solver::Solve/Step/TestAll parity
(solver.cpp:168-518) over the train step.

Twin of ``eco_tpu/train/loop.py``.  Mirrored: ``iter_size`` micro-batching
(delegated to the step), the smoothed-loss window (``average_loss``,
solver.cpp:230-239), the display interval with lr reporting, periodic test
passes averaging the metric tops (solver.cpp:450-518), the snapshot interval
and final snapshot, resume from a solverstate, and the non-finite-loss
guard, rematerialization from the graph's ``mem_param``, and training and
testing over a mesh (``Trainer(mesh=)``: data parallelism with SyncBN, or
DP x TP when the mesh has a ``model`` axis; snapshots by rank 0 only).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from eco_tpu_torch.runtime.memory import remat_policy_from_graph
from eco_tpu_torch.train.checkpoint import load_model, restore, save_model, snapshot
from eco_tpu_torch.utils.logging import rank as _rank
from eco_tpu_torch.train.solver import (
    SolverConfig,
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
)


def solver_config_from_prototxt(text: str) -> SolverConfig:
    """Parse a solver.prototxt into SolverConfig (SolverParameter subset)."""
    from eco_tpu_torch.spec.prototxt import parse_prototxt

    d = parse_prototxt(text)
    typ = str(d.get("solver_type", "SGD")).lower()
    stepvalues = d.get("stepvalue", ())
    if not isinstance(stepvalues, (list, tuple)):
        stepvalues = (stepvalues,)
    return SolverConfig(
        base_lr=float(d.get("base_lr", 0.01)),
        lr_policy=str(d.get("lr_policy", "fixed")),
        gamma=float(d.get("gamma", 0.1)),
        stepsize=int(d.get("stepsize", 100000)),
        stepvalues=tuple(int(s) for s in stepvalues),
        power=float(d.get("power", 1.0)),
        max_iter=int(d.get("max_iter", 10000)),
        # SolverParameter's momentum default is 0 (caffe.proto); ECO's shipped
        # solvers all set it explicitly.
        momentum=float(d.get("momentum", 0.0)),
        weight_decay=float(d.get("weight_decay", 0.0)),
        regularization_type=str(d.get("regularization_type", "L2")),
        clip_gradients=float(d.get("clip_gradients", -1)),
        iter_size=int(d.get("iter_size", 1)),
        solver_type=typ,
        display=int(d.get("display", 0)),
        average_loss=int(d.get("average_loss", 1)),
        snapshot=int(d.get("snapshot", 0)),
        snapshot_prefix=str(d.get("snapshot_prefix", "snapshots/eco")),
        test_iter=int(d.get("test_iter", 0)),
        test_interval=int(d.get("test_interval", 0)),
        random_seed=int(d.get("random_seed", 0)),
    )


class Trainer:
    """Drives train/test programs against data iterators.

    ``train_iter`` must yield {"data": (iter_size, N, ...), "label":
    (iter_size, N)} micro-batched tensors; ``test_iter_fn`` returns a fresh
    iterator of {"data": (N, ...), "label": (N,)} eval batches.
    """

    def __init__(
        self,
        train_program,
        cfg: SolverConfig,
        *,
        test_program=None,
        step_fn: Optional[Callable] = None,
        log_fn: Callable[[str], None] = print,
        remat: Optional[str] = "auto",
        process_index: Optional[int] = None,
        mesh=None,
        metrics_lag: int = 0,
    ):
        self.cfg = cfg
        self.train_program = train_program
        self.test_program = test_program
        # injectable rank for snapshot gating (None = the torch.distributed
        # rank, 0 without a process group)
        self.process_index = process_index
        if remat == "auto":
            # mem_param { optimize_train: true } in the graph -> remat
            remat = remat_policy_from_graph(train_program.graph)
        self.remat = remat
        self.dist = None
        if mesh is not None:
            if not getattr(mesh, "mesh_dim_names", None):
                raise TypeError("mesh must be a DeviceMesh with named axes (parallel.make_mesh)")
            from eco_tpu_torch.parallel.mesh import MODEL_AXIS
            from eco_tpu_torch.parallel.shard import DataParallel
            from eco_tpu_torch.parallel.tp import TensorParallel

            # a ``model`` axis: DP x TP, weights, momentum and BN state
            # channel-sharded (pass a shard_tp_train_state'd TrainState);
            # else data parallelism with SyncBN.  Each rank passes its slice
            # of every batch; the eval tops average over the global batch
            # (SyncOutput/SyncLoss)
            self.dist = (TensorParallel if MODEL_AXIS in mesh.mesh_dim_names
                         else DataParallel)(mesh)
        self.step = step_fn or make_train_step(train_program, cfg, remat=remat, dist=self.dist)
        self.eval_step = (make_eval_step(test_program, dist=self.dist)
                          if test_program is not None else None)
        self.log = log_fn
        if metrics_lag not in (0, 1):
            raise ValueError(f"metrics_lag must be 0 or 1, got {metrics_lag}")
        # metrics_lag=1 defers the host read of step i's metrics until step
        # i+1 has been enqueued, so the host does not wait for the device
        # between steps.  Cost, as in the reference: loss display and
        # non-finite detection lag one iteration, the last-good snapshot on
        # divergence is not written, and hooks receive the LATEST TrainState
        # (one step ahead of the metrics they accompany).
        self.metrics_lag = metrics_lag
        self.loss_window: collections.deque = collections.deque(
            maxlen=max(1, cfg.average_loss)
        )

    def init_state(self, sample_micro: Mapping, seed: int = 0) -> TrainState:
        params, state = self.train_program.init(
            torch.Generator().manual_seed(seed), sample_micro
        )
        return init_train_state(params, state)

    def solve(
        self,
        ts: TrainState,
        train_iter: Iterator,
        *,
        test_iter_fn: Optional[Callable[[], Iterable]] = None,
        resume_from: Optional[str] = None,
        hooks: Iterable[Callable] = (),
    ) -> TrainState:
        """Run the training loop.

        ``hooks``: callables ``hook(it, ts, metrics)`` invoked once per
        consumed step.  ``it`` and ``metrics`` always belong to the same
        step; under ``metrics_lag=1`` ``ts`` is the TrainState one step
        AHEAD of them.  With ``metrics_lag=0`` all three are step-consistent.
        """
        cfg = self.cfg
        if resume_from:
            ts = restore(resume_from, ts)
            self.log(f"Resumed from {resume_from} at iter {ts.it}")
        generator = torch.Generator().manual_seed(cfg.random_seed)
        self._t_last = time.perf_counter()
        it = ts.it
        pending = None  # (it, metrics) not yet read back (metrics_lag=1)
        while it < cfg.max_iter:
            if (
                cfg.test_interval
                and it > 0
                and it % cfg.test_interval == 0
                and test_iter_fn is not None
                and self.eval_step is not None
            ):
                self.test(ts, test_iter_fn())
            batch = next(train_iter)
            prev_ts = ts
            ts, metrics = self.step(ts, batch, generator)
            it += 1
            if self.metrics_lag:
                if pending is not None:
                    self._consume_metrics(pending[0], pending[1], ts, None, hooks)
                pending = (it - 1, metrics)
            else:
                self._consume_metrics(it - 1, metrics, ts, prev_ts, hooks)
            if cfg.snapshot and it % cfg.snapshot == 0:
                # flush the lagged metrics BEFORE writing: the non-finite
                # guard in _consume_metrics must precede any snapshot write,
                # or a NaN loss at a snapshot boundary would persist poisoned
                # weights that a later resume silently restores
                if pending is not None:
                    self._consume_metrics(pending[0], pending[1], ts, None, hooks)
                    pending = None
                self._snapshot(ts)
        if pending is not None:
            self._consume_metrics(pending[0], pending[1], ts, None, hooks)
        if cfg.snapshot and it % cfg.snapshot != 0:
            self._snapshot(ts)
        return ts

    def _consume_metrics(self, it, metrics, ts, prev_ts, hooks):
        """Host-side read of one step's metrics: failure detection, loss
        window, hooks, display.  ``it`` is the pre-step iteration index the
        metrics belong to; ``ts`` the latest TrainState (== that step's
        result, or one step ahead under metrics_lag=1); ``prev_ts`` the
        pre-step state, or None under metrics_lag=1."""
        cfg = self.cfg
        loss_val = float(metrics["loss"])
        if not np.isfinite(loss_val):
            # failure detection the reference Caffe lacks: snapshot the
            # last-good state before aborting so training can resume instead
            # of silently poisoning the weights
            saved = ""
            if prev_ts is not None and cfg.snapshot_prefix:
                snapshot(cfg.snapshot_prefix + "_lastgood", prev_ts, it)
                saved = "; last-good state snapshotted"
            raise FloatingPointError(f"non-finite loss {loss_val} at iteration {it}{saved}")
        self.loss_window.append(loss_val)
        for hook in hooks:
            hook(it, ts, metrics)
        if cfg.display and it % cfg.display == 0:
            dt = time.perf_counter() - self._t_last
            self._t_last = time.perf_counter()
            smoothed = float(np.mean(self.loss_window))
            self.log(
                f"Iteration {it}, loss = {smoothed:.4f} "
                f"(lr={float(metrics['lr']):.2e}, "
                f"|g|={float(metrics['grad_norm']):.2f}, {dt:.2f}s)"
            )

    def test(self, ts: TrainState, batches: Iterable) -> dict[str, float]:
        """Average scalar metric tops over test batches (Solver::Test)."""
        sums: dict[str, float] = collections.defaultdict(float)
        n = 0
        for batch in batches:
            outs = self.eval_step(ts.params, ts.state, batch)
            for k, v in outs.items():
                sums[k] += float(v)
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        self.log(
            "Test: " + ", ".join(f"{k} = {v:.4f}" for k, v in sorted(means.items()))
        )
        return means

    def _snapshot(self, ts: TrainState):
        # only rank 0 writes (rank-0 snapshot of the reference,
        # solver.cpp:523-546); the other ranks hold the same state
        gather = getattr(self.dist, "gather_train_state", None)
        if gather is not None:
            ts = gather(ts)  # every rank takes part; rank 0 writes the full state
        rank = self.process_index if self.process_index is not None else _rank()
        if rank != 0:
            return
        mp, _ = snapshot(self.cfg.snapshot_prefix, ts, ts.it)
        self.log(f"Snapshotting to {mp}")


def polyak_average(model_paths, out_path=None, *, device="cuda"):
    """Average the params of K snapshots (reference polyak_average.py) on
    ``device``."""
    acc_p = acc_s = None
    for path in model_paths:
        params, state = load_model(path, device=device)
        if acc_p is None:
            acc_p, acc_s = params, state
        else:
            acc_p = {ln: {k: v + params[ln][k] for k, v in lp.items()} for ln, lp in acc_p.items()}
            acc_s = {ln: {k: v + state[ln][k] for k, v in ls.items()} for ln, ls in acc_s.items()}
    k = float(len(model_paths))
    acc_p = {ln: {n: v / k for n, v in lp.items()} for ln, lp in acc_p.items()}
    acc_s = {ln: {n: v / k for n, v in ls.items()} for ln, ls in acc_s.items()}
    if out_path:
        save_model(out_path, acc_p, acc_s)
    return acc_p, acc_s
