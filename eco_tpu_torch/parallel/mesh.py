"""Device mesh construction and distributed bootstrap.

Twin of ``eco_tpu/parallel/mesh.py``.  The reference's MPI bootstrap
(GlobalInit/MPI_Init_thread + rank->GPU mapping, common.cpp:51-74,
tools/caffe.cpp:128-160) becomes ``torch.distributed.init_process_group``
(NCCL on the card, gloo on the CPU) and a ``DeviceMesh`` with named axes:

- ``data``    -- data parallelism over videos (the reference's MPI DP);
- ``segment`` -- sharding the temporal segment axis of the 2D trunk (the
  analogue of the reference's batch-axis Gather/Scatter sections);
- ``model``   -- channel (tensor) sharding of the weights.

In torch one process is one rank and owns one device (``cuda:LOCAL_RANK``),
so a mesh's size is the process group's world size.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEGMENT_AXIS = "segment"
MODEL_AXIS = "model"


_CLUSTER_ENV_VARS = (
    # what torch's launchers (torchrun, torch.multiprocessing with env://)
    # and the cluster launchers the reference reached through mpirun
    # (train_action_recognition_rgb.sh:1-8) set; probed by
    # multihost_evidence to decide whether a failed distributed_init may be
    # swallowed.  Size variables count only when their value implies
    # world > 1.
    "WORLD_SIZE",
    "MASTER_ADDR",
    "SLURM_NTASKS",
    "OMPI_COMM_WORLD_SIZE",
    "PMI_SIZE",
)
_SIZE_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


def multihost_evidence() -> Optional[str]:
    """Best-effort probe: does the environment say this process belongs to a
    MULTI-process job?  Returns a ``VAR=value`` description or None."""
    for var in _CLUSTER_ENV_VARS:
        val = os.environ.get(var)
        if not val:
            continue
        if var in _SIZE_VARS:
            try:
                if int(val) <= 1:
                    continue  # a single-task allocation
            except ValueError:
                pass
        return f"{var}={val}"
    return None


def _env_complete() -> bool:
    """torch's ``env://`` rendezvous has everything it needs."""
    return all(os.environ.get(v) for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"))


def distributed_init(*, device: Optional[str] = None, **kwargs) -> None:
    """Multi-process bootstrap (MPI_Init equivalent).

    ``kwargs`` go to ``torch.distributed.init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``backend``, ...).  The backend is NCCL when
    ``device`` is a card (the default) and gloo on the CPU, unless
    ``backend`` is given.

    Failure classification, as in the reference: "already initialised" is a
    no-op; with no explicit config and no cluster in the environment (no
    complete ``env://`` rendezvous, no launcher variables) there is nothing
    to join and the call is a no-op; any error with explicit config, or
    with a cluster visible in the environment, PROPAGATES -- a process
    silently falling back to single-process while its peers formed the
    group would train un-synchronised.
    """
    if dist.is_initialized():
        return
    explicit = any(v is not None for v in kwargs.values())
    evidence = multihost_evidence()
    if not explicit and evidence is None and not _env_complete():
        return  # no cluster detected: single process
    dev = torch.device(device or "cuda")
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    if kwargs["backend"] == "nccl":
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank") or 0))
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError) as e:
        if "already" in str(e).lower():
            return
        if not explicit and evidence is not None:
            raise RuntimeError(
                f"init_process_group failed but the environment indicates a "
                f"multi-process job ({evidence}); refusing to fall back to "
                f"single-process") from e
        raise


def make_mesh(axes: Optional[Mapping[str, int]] = None, *, device_type: Optional[str] = None):
    """Build a named ``DeviceMesh`` over the process group.  Default: a 1-D
    ``data`` mesh over every rank.

    ``axes`` maps axis name -> size; sizes must multiply to the world size
    (use -1 for one inferred axis).  ``device_type`` defaults to ``cuda``
    under NCCL and ``cpu`` otherwise.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call distributed_init first")
    n = dist.get_world_size()
    axes = dict(axes) if axes else {DATA_AXIS: n}
    sizes = list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
        axes = dict(zip(axes.keys(), sizes))
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh axes {axes} do not cover {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> dict:
    """``{axis name: size}``, as ``jax.sharding.Mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def axis_group(mesh, axis: str):
    """The process group of ``axis``, or None when the mesh has no such axis."""
    return mesh.get_group(axis) if axis in mesh.mesh_dim_names else None


def replicated(mesh) -> list:
    """Placements of a tensor replicated over every mesh axis."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def batch_sharding(mesh, axis: int = 0, mesh_axis: str = DATA_AXIS) -> list:
    """Placements of a tensor whose dim ``axis`` is sharded over ``mesh_axis``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(axis) if name == mesh_axis else Replicate() for name in mesh.mesh_dim_names]
