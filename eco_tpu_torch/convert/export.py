"""Serving artifacts via ``torch.export`` (``.pt2``).

Twin of ``eco_tpu/convert/export_hlo.py``.  The reference's deployment
story is a deploy prototxt + ``.caffemodel`` pair interpreted by the Caffe
runtime at the destination; ``eco_tpu`` lowers the inference program once
to StableHLO with the weights baked in.  Here the program is traced once by
``torch.export.export`` as an ``nn.Module`` that closes over the params and
state as constants, and saved as ONE ``.pt2`` file.  Any PyTorch process
loads and runs it with ``torch.export.load(path).module()`` -- no
eco_tpu_torch, no model code, no prototxt at the destination -- after
``move_to_device_pass`` to the device it wants (``cuda`` or ``cpu``), in
place of JAX's ``platforms``.

Two artifact shapes:

* clips mode (default): ``(B, S, crop, crop, 3)`` model-ready clips in,
  class probabilities out -- the deploy-prototxt equivalent.
* ``uint8=True``: raw resized frames ``(B, S, H, W, 3) uint8`` + per-video
  ``(h_off, w_off, mirror)`` in -- the whole ``UInt8Server`` path in one
  artifact.  The crop, mean, mirror and (for a quantized graph) the int8
  input plane are traced from their plain tensor-op versions, never from
  the hand-written kernels: the program is traced on the CPU, where every
  op of the port takes its plain version, so the artifact holds plain K1
  (``ops.preprocess.crop_normalize_reference``) and, in an int8 graph,
  plain K3 (an f64 convolution).  A CUDA kernel behind a ``ctypes`` call
  cannot be traced or carried in the file, and the reference keeps its
  Pallas kernel out of its artifact for portability (export_hlo.py:21-27).
  Offsets are clamped into ``[0, H - crop]`` as ``lax.dynamic_slice``
  clamps them, past the far edge too.

``dynamic_batch=True`` exports a symbolic batch dimension
(``torch.export.Dim``), so one artifact serves any batch size.  ``mesh=``
exports the per-rank shard (``batch / world`` over ``data``); the loader's
callable then takes the global batch, runs its rank's shard and
all-gathers the result.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
from torch import nn

from eco_tpu_torch.ops.preprocess import crop_normalize_reference

META_FILE = "eco_serving.json"


class _Clips(nn.Module):
    """The inference program with its weights as constants: clips in."""

    def __init__(self, program, params, state, output: str):
        super().__init__()
        self.program = program
        self.params = params
        self.state = state
        self.output = output

    def forward(self, clips):
        outs, _ = self.program.apply(self.params, self.state, {"data": clips},
                                     capture=[self.output])
        return outs[self.output]


class _Frames(_Clips):
    """uint8 frames and per-video offsets and mirrors in: the plain crop,
    mean, mirror (and int8 input plane) in front of the program."""

    def __init__(self, program, params, state, output: str, preprocess: dict):
        super().__init__(program, params, state, output)
        self.preprocess = preprocess

    def forward(self, frames_u8, h_off, w_off, mirror):
        return super().forward(
            crop_normalize_reference(frames_u8, h_off, w_off, mirror, **self.preprocess))


def _cpu(tree):
    # contiguous: the archive stores a tensor whole (K3's int8 weights lie
    # in their kernel's memory order, which the plain version does not need)
    return {ln: {k: v.detach().to("cpu").contiguous() for k, v in lp.items()}
            for ln, lp in tree.items()}


def export_serving(program, params, state, *, batch: int = 8, segments: int = 16,
                   crop: int = 224, output: Optional[str] = None,
                   dynamic_batch: bool = False, uint8: bool = False,
                   frame_hw: tuple = (256, 340), mean=(104.0, 117.0, 123.0),
                   mesh=None, data_axis: str = "data"):
    """Trace ``program`` (a deploy-phase Program) into a serving artifact.

    Returns a ``torch.export.ExportedProgram``; persist it with
    :func:`save_serving_artifact` and run it with :func:`load_serving_artifact`
    (or plain ``torch.export.load``).  The trace runs on the CPU on copies of
    ``params`` and ``state``, whatever the program's device.
    """
    from eco_tpu_torch.runtime.executor import Program

    out_name = output or (
        "probs" if "probs" in program.output_names else program.output_names[-1])
    dtype = program.compute_dtype or torch.float32
    world = 1
    if mesh is not None:
        if dynamic_batch:
            raise ValueError("mesh and dynamic_batch are mutually exclusive")
        from eco_tpu_torch.parallel.mesh import axis_size

        world = axis_size(mesh, data_axis)
        if batch % world:
            raise ValueError(f"batch {batch} not divisible by mesh axis "
                             f"{data_axis!r}={world}")
    b = batch // world
    graph = program.graph
    if uint8:
        fh, fw = frame_hw
        if fh < crop or fw < crop:
            raise ValueError(
                f"frame_hw {frame_hw} smaller than crop {crop}: the baked "
                "preprocess crops a fixed window from each frame")
        # a quantized graph: bake the int8 input plane into the preprocess
        # (a no-op on float graphs)
        from eco_tpu_torch.convert.quantize import int8_input_rewrite

        graph, in_scale = int8_input_rewrite(graph)
        preprocess = dict(crop=crop, mean=tuple(float(m) for m in mean), out_dtype=dtype,
                          act_scale=in_scale)
        args = (torch.zeros((b, segments, fh, fw, 3), dtype=torch.uint8),
                torch.zeros((b,), dtype=torch.int32), torch.zeros((b,), dtype=torch.int32),
                torch.zeros((b,), dtype=torch.bool))
    else:
        args = (torch.zeros((b, segments, crop, crop, 3), dtype=dtype),)
    weights = (Program(graph, train=False, compute_dtype=program.compute_dtype, device="cpu"),
               _cpu(params), _cpu(state), out_name)
    module = _Frames(*weights, preprocess) if uint8 else _Clips(*weights)
    dynamic = None
    if dynamic_batch:
        n = torch.export.Dim("batch", min=1)
        dynamic = tuple({0: n} for _ in args)
    with torch.no_grad():
        exported = torch.export.export(module, args, dynamic_shapes=dynamic)
    exported.graph_module.meta[META_FILE] = {
        "data_parallel": world, "data_axis": data_axis, "uint8": uint8}
    return exported


def save_serving_artifact(exported, path: str) -> int:
    """Write ``exported`` to ``path`` (``.pt2``); returns the byte size."""
    meta = exported.graph_module.meta.get(META_FILE, {})
    torch.export.save(exported, path, extra_files={META_FILE: json.dumps(meta)})
    return os.path.getsize(path)


def load_serving_artifact(path: str, *, device="cuda"):
    """Load a serving artifact onto ``device`` as a callable.

    Needs nothing but ``torch``: ``torch.export.load``, then
    ``move_to_device_pass``.  A mesh artifact's callable takes the global
    batch on every rank of the default process group, runs this rank's
    shard and returns the all-gathered output.
    """
    import torch.distributed as dist
    from torch.export.passes import move_to_device_pass

    extra = {META_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    exported = move_to_device_pass(exported, device)
    module = exported.module()
    world = json.loads(extra[META_FILE] or "{}").get("data_parallel", 1)

    def call(*args):
        args = [torch.as_tensor(a).to(device) for a in args]
        if world == 1:
            return module(*args)
        if dist.get_world_size() != world:
            raise ValueError(f"artifact exported for {world} ranks, the process group "
                             f"has {dist.get_world_size()}")
        rank = dist.get_rank()
        y = module(*[a.chunk(world, 0)[rank] for a in args])
        parts = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(parts, y.contiguous())
        return torch.cat(parts, 0)

    call.exported = exported
    return call
