"""Tensor (model) parallelism: channel-sharded params over the ``model`` axis.

Twin of ``eco_tpu/parallel/tp.py``.  The reference annotates each weight's
output-channel dim with the ``model`` mesh axis and lets GSPMD insert the
collectives.  Here each rank stores 1/tp of every sharded leaf (params,
momentum, BN state), the update runs on the local shards, and the layers
that read a sharded leaf run through explicit collectives
(``ops/collectives.py``):

- a plain convolution or inner product (one group, not transposed) runs
  column-parallel: its input enters through ``copy_to_group`` (identity
  forward, SUM all-reduce of the input gradient) and its output channels
  are all-gathered with ``gather_from_group`` (the gradient sliced back) --
  Megatron's pair;
- any other layer (BN, Scale, deconvolution, grouped and int8 convs, ...)
  all-gathers its sharded params (the gradient sliced back), runs
  replicated, and keeps its rank's slice of the new BN statistics.

The sharding rule, for the port's layouts (``convert/bridge.py``): dim 0 of
conv, deconv, fc and int8 weights (output channels; a deconv's input
channels) when ``tp`` divides it; 1-D per-channel vectors on dim 0 when
divisible; everything else replicated.  The clip's global norm sums the
sharded leaves' squares across ``model`` and the replicated ones once.
Numerics equal the single-device step's; the gain is per-rank weight and
optimizer memory (1/tp).  It composes with a ``data`` axis (DP x TP).
"""

from __future__ import annotations

from typing import Mapping

import torch

from eco_tpu_torch.ops import collectives
from eco_tpu_torch.ops.qconv import kernel_layout
from eco_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    batch_sharding,
    replicated,
)
from eco_tpu_torch.parallel.shard import DataParallel, _infer, shard_batch
from eco_tpu_torch.runtime.executor import _transposed
from eco_tpu_torch.train.solver import SolverConfig, TrainState, make_train_step

_COLUMN_TYPES = ("convolution", "innerproduct")


def _sharded(shape, tp: int) -> bool:
    return len(shape) >= 1 and shape[0] >= tp and shape[0] % tp == 0


def tp_spec_tree(tree, mesh, *, axis: str = MODEL_AXIS):
    """Placements tree mirroring ``tree`` under the channel-sharding rule."""
    tp = axis_size(mesh, axis)
    shard, rep = batch_sharding(mesh, 0, axis), replicated(mesh)
    return {ln: {k: shard if _sharded(tuple(v.shape), tp) else rep for k, v in lp.items()}
            for ln, lp in tree.items()}


def _local(v, rank: int, tp: int):
    part = v.chunk(tp, 0)[rank].contiguous()
    return kernel_layout(part) if part.dtype == torch.int8 and part.ndim > 2 else part


def shard_tp_tree(mesh, tree, *, axis: str = MODEL_AXIS):
    """This rank's shard of every leaf of ``tree`` (the sharded leaves'
    1/tp slices, the others whole)."""
    tp, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
    return {ln: {k: _local(v, rank, tp) if _sharded(tuple(v.shape), tp) else v
                 for k, v in lp.items()}
            for ln, lp in tree.items()}


def shard_tp_train_state(mesh, ts: TrainState, *, axis: str = MODEL_AXIS) -> TrainState:
    """Shard a TrainState: params, state and history channel-sharded."""
    return TrainState(shard_tp_tree(mesh, ts.params, axis=axis),
                      shard_tp_tree(mesh, ts.state, axis=axis),
                      shard_tp_tree(mesh, ts.history, axis=axis), ts.it)


class TensorParallel(DataParallel):
    """One rank of a ``model`` (x ``data``) mesh (see the module note)."""

    def __init__(self, mesh, axis: str = MODEL_AXIS):
        super().__init__(mesh)
        self.model_group = axis_group(mesh, axis)
        self.tp = axis_size(mesh, axis)
        self.rank = axis_rank(mesh, axis)
        # (layer, name) of the sharded leaves seen so far
        self.sharded_params: set = set()
        self.sharded_state: set = set()

    def _gather_param(self, v):
        full = collectives.gather_from_group(v, 0, self.model_group)
        return kernel_layout(full) if full.dtype == torch.int8 and full.ndim > 2 else full

    def run_layer(self, layer, impl, params, state, inputs, ctx):
        in_shapes = [tuple(x.shape) for x in inputs]
        sp = {k for k, (shape, *_) in impl.param_specs(layer, in_shapes).items()
              if k in params and _sharded(shape, self.tp)}
        ss = {k for k, (shape, _) in impl.state_specs(layer, in_shapes).items()
              if k in state and _sharded(shape, self.tp)}
        if not sp and not ss:
            return impl.apply(layer, params, state, inputs, ctx)
        self.sharded_params.update((layer.name, k) for k in sp)
        self.sharded_state.update((layer.name, k) for k in ss)
        if (layer.type.lower() in _COLUMN_TYPES and not _transposed(layer)
                and int(layer.opt("group", 1)) == 1 and sp == set(params) and not state
                and params["w"].dtype != torch.int8):
            x = collectives.copy_to_group(inputs[0], self.model_group)
            y = impl.apply(layer, params, state, [x], ctx)[0]
            return [collectives.gather_from_group(y, -1, self.model_group)]
        full_p = {k: self._gather_param(v) if k in sp else v for k, v in params.items()}
        full_s = {k: collectives.all_gather(v, 0, self.model_group) if k in ss else v
                  for k, v in state.items()}
        outs = impl.apply(layer, full_p, full_s, inputs, ctx)
        new = ctx.new_state.get(layer.name)
        if new is not None:
            ctx.new_state[layer.name] = {
                k: _local(v, self.rank, self.tp) if k in ss else v for k, v in new.items()}
        return outs

    def sq_norm(self, keys, grads):
        zero = torch.zeros((), device=grads[0].device)
        sharded = sum((g.float().square().sum() for k, g in zip(keys, grads)
                       if k in self.sharded_params), zero)
        rest = sum((g.float().square().sum() for k, g in zip(keys, grads)
                    if k not in self.sharded_params), zero)
        return rest + collectives.all_reduce_sum(sharded, self.model_group)

    def gather_tree(self, tree: Mapping, sharded: set) -> dict:
        """The full tree from this rank's shards (a collective: every rank of
        ``model`` calls it)."""
        out = {}
        for ln, lp in tree.items():
            out[ln] = {k: (self._gather_param(v).detach() if (ln, k) in sharded else v)
                       for k, v in lp.items()}
        return out

    def gather_train_state(self, ts: TrainState) -> TrainState:
        """The full TrainState, for a snapshot or a digest."""
        with torch.no_grad():
            return TrainState(self.gather_tree(ts.params, self.sharded_params),
                              self.gather_tree(ts.state, self.sharded_state),
                              self.gather_tree(ts.history, self.sharded_params), ts.it)


def make_tp_infer_fn(program, mesh, *, output: str = "probs", axis: str = MODEL_AXIS):
    """Inference with weights channel-sharded over ``model`` (and the batch
    over ``data`` when the mesh has that axis).  Takes this rank's
    ``shard_tp_tree`` params and state and the global batch; returns the
    global output."""
    d = TensorParallel(mesh, axis)
    return _infer(program, d, output, lambda x: shard_batch(mesh, {"data": x})["data"], d.group)


def make_tp_train_step(program, cfg: SolverConfig, mesh, *, remat=None,
                       axis: str = MODEL_AXIS):
    """Train step over a DP x TP mesh: each rank passes its ``data`` shard of
    the batch (all of it without a ``data`` axis) and a
    ``shard_tp_train_state``'d TrainState; weight grads, momentum and the
    update stay sharded.  The step's ``dist`` (a ``TensorParallel``) gathers
    the full state for snapshots (``dist.gather_train_state``)."""
    d = TensorParallel(mesh, axis)
    step = make_train_step(program, cfg, remat=remat, dist=d)
    step.dist = d
    return step
