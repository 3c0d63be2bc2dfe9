"""K5: space-to-depth, the rearrangement behind a strided convolution over
few channels run as a stride-1 convolution over many.

A ``(N, *spatial, C)`` tensor is zero-padded by one ``(lo, hi)`` pair a
spatial axis, and at the end of each axis on to a whole number of cells of
``block`` (one size an axis), cut into those cells and each cell's values
laid along the channels: channel ``(offset in the cell, row-major) * C +
c``.  ``convert/load.py:
fold_space_to_depth`` puts it in front of I3D's stem, whose 7x7x7/s2 conv
over 3 channels becomes a 4x4x4/s1 conv over 24.

- :func:`space_to_depth` runs it, in an ``eco.s2d`` span.  A 3D float
  tensor on the card in 2x2x2 cells of 1 to 4 channels, contiguous, with no
  gradient asked and no ``torch.export`` or ``torch.compile`` trace running,
  goes to the hand-written kernel ``csrc/s2d.cu`` (built with ``nvcc`` at
  first use); everything else (the CPU, integers, a gradient, traces, other
  blocks) to the plain version.
- :func:`space_to_depth_reference` is that plain version: ``F.pad``, a view
  and a permute.  The kernel copies bits, so the two are equal in every
  type.
- ``COUNTS["s2d.launches"]`` (``utils/tracing.py``) counts kernel launches.

``channels`` pads each cell with zero channels up to that width.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from eco_tpu_torch.ops import _build
from eco_tpu_torch.utils.tracing import COUNTS, span

_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
MAX_CELL_BYTES = 128  # csrc/s2d.cu's kMaxCellBytes: a cell's output, in registers


@functools.cache
def _kernel():
    fn = _build.load("s2d").eco_space_to_depth
    fn.argtypes = (
        [ctypes.c_void_p] * 2           # x, out
        + [ctypes.c_int] * 13           # n, t, h, w, c, to, ho, wo, cout, lo_t, lo_h, lo_w,
                                        # element bytes
        + [ctypes.c_void_p]             # stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load the CUDA kernel now rather than at its first launch."""
    _kernel()


def out_shape(shape, block, pads, channels: int | None = None) -> tuple[int, ...]:
    """The shape :func:`space_to_depth` gives ``shape``: each padded extent
    in whole cells, the last one completed with zeros."""
    n, *spatial, c = shape
    cells = [-(-(size + lo + hi) // b)
             for size, b, (lo, hi) in zip(spatial, block, pads, strict=True)]
    width = math.prod(block) * c
    if channels is not None and channels < width:
        raise ValueError(f"space_to_depth: {channels} channels cannot hold a cell of {width}")
    return (n, *cells, channels or width)


def space_to_depth_reference(x: torch.Tensor, block, pads,
                             channels: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``F.pad``, then a view and a permute."""
    n, *spatial, c = x.shape
    shape = out_shape(x.shape, block, pads, channels)
    flat = [0, 0]  # F.pad lists axes from the last (channels, unpadded)
    for size, cells, b, (lo, _) in reversed(list(zip(spatial, shape[1:-1], block, pads))):
        flat += [lo, cells * b - size - lo]
    x = F.pad(x, flat)
    k = len(block)
    split = [n]
    for cells, b in zip(shape[1:-1], block):
        split += [cells, b]
    # (n, cells_0, b_0, cells_1, b_1, ..., c) -> (n, cells_0, ..., b_0, ..., c)
    order = [0] + [1 + 2 * i for i in range(k)] + [2 + 2 * i for i in range(k)] + [2 * k + 1]
    y = x.reshape(split + [c]).permute(order).reshape(shape[:-1] + (-1,))
    if shape[-1] > y.shape[-1]:
        y = F.pad(y, [0, shape[-1] - y.shape[-1]])
    return y.contiguous()


def _takes(x: torch.Tensor, block, shape) -> bool:
    """True iff :func:`space_to_depth` launches the kernel for output
    ``shape``: a contiguous 3D float tensor on the card of 1 to 4 channels
    in 2x2x2 cells, whose cell fits the kernel's registers, with fewer than
    2**31 cells, no gradient asked and no trace running."""
    return (x.device.type == "cuda" and x.dtype in _BYTES and x.ndim == 5
            and tuple(block) == (2, 2, 2) and 1 <= x.shape[-1] <= 4
            and shape[-1] * _BYTES[x.dtype] % 16 == 0
            and shape[-1] * _BYTES[x.dtype] <= MAX_CELL_BYTES
            and math.prod(shape[:-1]) < 2**31 - 256 and x.is_contiguous()
            and not (torch.is_grad_enabled() and x.requires_grad)
            and not torch.compiler.is_compiling())


def space_to_depth(x: torch.Tensor, block, pads, channels: int | None = None) -> torch.Tensor:
    """``x`` (N, *spatial, C) zero-padded by ``pads`` (one ``(lo, hi)`` an
    axis, then on to whole cells) and cut into ``block`` cells: (N, *cells,
    ``channels`` or prod(block) * C)."""
    block = tuple(int(b) for b in block)
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    shape = out_shape(x.shape, block, pads, channels)
    with span("eco.s2d"):
        if not _takes(x, block, shape):
            return space_to_depth_reference(x, block, pads, channels)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        err = _kernel()(
            x.data_ptr(), out.data_ptr(), *x.shape, *shape[1:], *(lo for lo, _ in pads),
            _BYTES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"space_to_depth kernel launch failed: CUDA error {err}")
        COUNTS["s2d.launches"] += 1
        return out
