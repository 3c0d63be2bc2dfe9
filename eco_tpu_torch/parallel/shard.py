"""Sharded training / inference steps over a device mesh.

Twin of ``eco_tpu/parallel/shard.py``.  The reference's distributed
machinery -- the MPI comm thread (channel.cpp), the gradient allreduce
(net.cpp:670-702), the 1/world rescale and output/loss averaging
(solver.cpp:310-392), cursor-offset data sharding (base_data_layer.cpp:
42-45) -- is GSPMD over one global program in ``eco_tpu``.  Here each rank
runs its own program on its slice of the batch, and the collectives are
written out (``ops/collectives.py``):

- data parallelism (``DataParallel``): params replicated; the accumulated
  f32 gradients mean all-reduced in flat buckets BEFORE the global-norm
  clip, so every rank clips by the same norm and the params stay equal;
  every train-mode BN is SyncBN over ``data`` (under pjit the moments are
  global by construction); the loss and the eval tops averaged over the
  global batch (SyncLoss/SyncOutput).  Overlapping the all-reduce with the
  backward is not done.
- segment sharding (``SegmentParallel``), for few videos with many
  segments: the 2D trunk runs on each rank's segments of the fused (N*S)
  axis, the segments are all-gathered over ``segment`` where the graph
  unfolds them (``unfold_segments``, r2Dto3D) or averages them
  (``segment_consensus``) -- the reference's own Gather section -- and the
  3D head runs replicated over ``segment``.  XLA partitions the head's
  temporal convs with halo exchanges instead; the numbers are the same.
  The trunk's gradients SUM over ``segment`` (each rank's covers its own
  frames), the head's are the same on every segment rank; the trunk's BN
  averages over ``data`` x ``segment``, the head's over ``data``.

A train step takes the rank's shard of the batch (``shard_batch``); an
inference function takes the global batch, runs the rank's slice and
returns the gathered global output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from eco_tpu_torch.ops import collectives
from eco_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEGMENT_AXIS,
    axis_group,
    axis_rank,
    axis_size,
)
from eco_tpu_torch.runtime.executor import Collectives
from eco_tpu_torch.train.solver import SolverConfig, make_train_step

BUCKET_BYTES = 25 * 2**20
_BN_TYPES = ("bn", "batchnorm")


def _take(v, axis: int, index: int, parts: int):
    size = v.shape[axis]
    if size % parts:
        raise ValueError(f"axis {axis} of size {size} does not split into {parts} shards")
    n = size // parts
    return v[(slice(None),) * axis + (slice(index * n, (index + 1) * n),)]


def shard_batch(mesh, batch: Mapping[str, Any], *, batch_axis: int = 0,
                segment_axis: Optional[int] = None) -> dict:
    """This rank's slice of a host batch: axis ``batch_axis`` split over
    ``data`` (``(iter_size, N, ...)`` takes ``batch_axis=1``) and, with
    ``segment_axis``, that axis of every clip-shaped value split over
    ``segment`` (label-shaped values are split over ``data`` only)."""
    d, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    out = {}
    for k, v in batch.items():
        v = _take(v, batch_axis, r, d)
        if segment_axis is not None and v.ndim >= segment_axis + 3:
            v = _take(v, segment_axis, axis_rank(mesh, SEGMENT_AXIS),
                      axis_size(mesh, SEGMENT_AXIS))
        out[k] = v
    return out


def _reduce_buckets(grads: list, group, divisor: int) -> list:
    """SUM all-reduce of ``grads`` over ``group`` divided by ``divisor``, in
    flat buckets of at most BUCKET_BYTES (one dtype a bucket)."""
    if group is None:
        return grads
    out = list(grads)
    buckets: list[list[int]] = []
    for dtype in dict.fromkeys(g.dtype for g in grads):
        fill = BUCKET_BYTES
        for i, g in enumerate(grads):
            if g.dtype != dtype:
                continue
            nbytes = g.numel() * g.element_size()
            if fill + nbytes > BUCKET_BYTES:
                buckets.append([])
                fill = 0
            buckets[-1].append(i)
            fill += nbytes
    for idx in buckets:
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / divisor
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            # back into the gradient's own tensor, which keeps its memory
            # layout (a conv weight's is channels-last): the clip's norm then
            # sums it in the single-device step's order, and one rank's step
            # is that step bit for bit
            out[i] = grads[i].copy_(part.view(grads[i].shape))
    return out


def _mean(value, group, size: int):
    if group is None:
        return value
    return collectives.all_reduce_sum(value, group) / size


class DataParallel(Collectives):
    """One rank of data parallelism over the mesh's ``data`` axis."""

    def __init__(self, mesh):
        self.group = axis_group(mesh, DATA_AXIS)
        self.size = axis_size(mesh, DATA_AXIS)
        self.bn_axis_name = self.group
        self.data_group = self.group
        self.seed_offset = axis_rank(mesh, DATA_AXIS)

    def reduce_grads(self, keys, grads):
        return _reduce_buckets(grads, self.group, self.size)

    def reduce_metric(self, value):
        return _mean(value, self.group, self.size)


class SegmentParallel(DataParallel):
    """One rank of a ``data`` x ``segment`` mesh (see the module note)."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.seg_group = axis_group(mesh, SEGMENT_AXIS)
        self.seg = axis_size(mesh, SEGMENT_AXIS)
        self.sharded: set[str] = set()  # blobs holding this rank's segments
        self.trunk: set[str] = set()  # layers that ran on them

    def start(self, inputs):
        # clip-shaped inputs (N, S, ...) arrive as this rank's segments
        self.sharded = {k for k, v in inputs.items() if len(getattr(v, "shape", ())) >= 3}

    def input_shape(self, name, declared):
        if len(declared) < 3:
            return declared
        return (declared[0], declared[1] // self.seg) + tuple(declared[2:])

    def _gather_segments(self, x, segments: int):
        local = segments // self.seg
        return collectives.gather_from_group(
            x.unflatten(0, (-1, local)), 1, self.seg_group).flatten(0, 1)

    def run_layer(self, layer, impl, params, state, inputs, ctx):
        if not any(b in self.sharded for b in layer.bottoms):
            self.sharded.difference_update(layer.tops)
            return impl.apply(layer, params, state, inputs, ctx)
        if layer.type.lower() in ("unfold_segments", "segment_consensus"):
            segments = int(layer.opt("num_segments"))
            inputs = [self._gather_segments(x, segments) if b in self.sharded else x
                      for b, x in zip(layer.bottoms, inputs)]
            self.sharded.difference_update(layer.tops)
            return impl.apply(layer, params, state, inputs, ctx)
        self.trunk.add(layer.name)
        if layer.type.lower() in _BN_TYPES:
            # the trunk's moments cover every rank's frames
            ctx = dataclasses.replace(ctx, bn_axis_name=dist.group.WORLD)
        self.sharded.update(layer.tops)
        return impl.apply(layer, params, state, inputs, ctx)

    def reduce_grads(self, keys, grads):
        trunk = [i for i, (ln, _) in enumerate(keys) if ln in self.trunk]
        head = [i for i, (ln, _) in enumerate(keys) if ln not in self.trunk]
        out = list(grads)
        for idx, group in ((trunk, dist.group.WORLD), (head, self.group)):
            for i, g in zip(idx, _reduce_buckets([grads[i] for i in idx], group, self.size)):
                out[i] = g
        return out


def make_sharded_train_step(program, cfg: SolverConfig, mesh, *, remat=None):
    """Data-parallel train step over ``mesh``'s ``data`` axis: each rank
    passes its shard ``{name: (iter_size, N / data, ...)}`` and all ranks end
    with the same params."""
    return make_train_step(program, cfg, remat=remat, dist=DataParallel(mesh))


def make_segment_sharded_train_step(program, cfg: SolverConfig, mesh, *, remat=None):
    """Sequence-parallel train step over a ``data`` x ``segment`` mesh: each
    rank passes ``shard_batch(mesh, batch, batch_axis=1, segment_axis=2)``.
    Params and momentum stay replicated; numerics equal the single-device
    step's."""
    return make_train_step(program, cfg, remat=remat, dist=SegmentParallel(mesh))


def _infer(program, dist_, output: str, shard, group):
    def infer(params, state, data):
        with torch.no_grad():
            outs, _ = program.apply(params, state, {"data": shard(data)}, capture=[output],
                                    dist=dist_)
            y = outs[output]
            return y if group is None else collectives.all_gather(y, 0, group)

    return infer


def make_segment_sharded_infer_fn(program, mesh, *, output: str = "probs"):
    """Inference with the video and segment axes sharded: takes the global
    ``(N, S, ...)`` clips, returns the global output."""
    d = SegmentParallel(mesh)
    return _infer(program, d, output,
                  lambda x: shard_batch(mesh, {"data": x}, segment_axis=1)["data"], d.group)


def make_sharded_infer_fn(program, mesh, *, output: str = "probs"):
    """Batched multi-video inference with videos sharded over ``data``:
    takes the global batch, returns the global output."""
    d = DataParallel(mesh)
    return _infer(program, d, output, lambda x: shard_batch(mesh, {"data": x})["data"], d.group)
