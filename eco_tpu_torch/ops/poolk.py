"""K4: Caffe ceil-mode 2D and 3D MAX and AVE pooling of a channels-last
float tensor on the card, in one pass.

``ops/pool.py:pool_nd`` sends every float 2D or 3D MAX or AVE pool here when
:func:`takes` holds: the tensor is on the card and contiguous, no gradient is
asked, and no ``torch.export`` or ``torch.compile`` trace runs.  Everything
else (training, integer pools, 1D pools, traces, CPU and meta tensors) keeps
the padded route, ``pool.padded_pool``, which is also K4's plain version:
the kernel gives its bits in every float type (``csrc/pool.cu`` says how the
AVE sum order makes that so).

- :func:`caffe_pool` launches the hand-written kernel ``csrc/pool.cu``
  (built with ``nvcc`` at first use) on the current stream, or raises on
  what it does not take; :func:`launch`, which ``pool_nd`` calls once
  :func:`takes` has held, launches it unchecked.  A 3D pool whose window,
  stride and pad along T are 1, 1 and 0 is a 2D pool of each frame: it runs
  on the 2D path over the (N * T, H, W, C) view.
- :func:`plan` and :func:`plan3d` pick the kernel's path and tile from the
  shapes, the one place that decides them; the CPU tests reach them.
- ``COUNTS["k4.launches"]`` (``utils/tracing.py``) counts every launch,
  ``COUNTS["k4.launches.3d"]`` those of the 3D path.

The kernel has no backward: under a gradient ``pool_nd`` keeps the route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from eco_tpu_torch.ops import _build
from eco_tpu_torch.utils.shapes import caffe_pool_out_dim
from eco_tpu_torch.utils.tracing import COUNTS

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MODE = {"max": 0, "ave": 1}
# output columns a thread takes, by (kh, kw, sh, sw): the template
# specialisations of csrc/pool.cu; any other window takes 1
_PER_THREAD = {(3, 3, 2, 2): 2, (3, 3, 1, 1): 4, (7, 7, 1, 1): 1}
THREADS = 256            # most threads a block (the kernel's launch bound)
ROW_OUTPUTS = 32         # most output columns a tile
SMEM_BYTES = 48 * 1024   # most shared memory a tile's input band takes
MIN_BLOCKS = 2 * 132     # two blocks for each SM of an H100
# the 3D tile path: output columns a thread, by (kt, kh, kw, st, sh, sw, mode),
# its instantiations in csrc/pool.cu (the windows and modes I3D runs); every
# other 3D pool takes the scalar path
_TILE3 = {(3, 3, 3, 1, 1, 1, "max"): 4, (3, 3, 3, 2, 2, 2, "max"): 2,
          (2, 2, 2, 2, 2, 2, "max"): 2, (2, 7, 7, 1, 1, 1, "ave"): 1}
RING = 3                 # frames a 3D block stages at once: csrc/pool.cu's kRing
SMEM3_BYTES = 112 * 1024  # most shared memory a 3D block's ring takes (two blocks an SM)
CV3 = 8                  # channel vectors a 3D tile: 128 contiguous bytes a pixel


class Plan(NamedTuple):
    """The kernel's path, output dims and tile for one call.  ``tiled``
    False is the scalar path, one thread per output element; the tile
    fields are then unused."""

    ho: int
    wo: int
    tiled: bool
    per: int = 1       # output columns a thread
    tx: int = 1        # threads along a tile's row
    toh: int = 1       # output rows a tile
    cv: int = 1        # 16-byte channel vectors a tile
    tiles: tuple = (0, 0, 0)   # tiles along Ho, along Wo, and channel chunks
    threads: int = 0   # a block
    smem: int = 0      # bytes of shared memory a block


class Plan3(NamedTuple):
    """The 3D path's plan for one call: as :class:`Plan`, with ``tt``
    output frames a block; ``tiles`` are along To, Ho, Wo and the channel
    vectors."""

    to: int
    ho: int
    wo: int
    tiled: bool
    per: int = 1
    tx: int = 1
    toh: int = 1
    cv: int = 1
    tt: int = 1
    tiles: tuple = (0, 0, 0, 0)
    threads: int = 0
    smem: int = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def plan(shape, kernel, stride, pad, itemsize: int, aligned: bool) -> Plan:
    """The path and tile for pooling (N, H, W, C) of ``itemsize``-byte
    floats; ``aligned``: the input's pointer is 16-byte aligned (an output
    from the caching allocator always is, and the kernel refuses one that is
    not).  Cached: a serving request asks for the same few plans at every
    call.  ``csrc/pool.cu`` launches the tile it is given and only checks
    that it is within the kernel's limits.

    The tile path takes C * itemsize a multiple of 16 on aligned pointers.
    A tile is ``toh`` output rows by ``tx * per`` output columns (at most
    ROW_OUTPUTS, the row split evenly) by ``cv`` vectors, within THREADS
    threads; once a tile covers the whole output plane, spare threads go to
    more channels.  Its input band must fit in SMEM_BYTES, shrinking rows,
    then columns, then channels; where even one cell's window does not fit,
    the scalar path takes it.  Then rows, and after them channels (down to
    a warp a block), are split until the grid has MIN_BLOCKS blocks.
    """
    n, h, w, c = shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    ho, wo = caffe_pool_out_dim(h, kh, sh, ph)[0], caffe_pool_out_dim(w, kw, sw, pw)[0]
    el = 16 // itemsize
    if not aligned or c % el:
        return Plan(ho, wo, tiled=False)
    groups = c // el
    per = _PER_THREAD.get((kh, kw, sh, sw), 1)
    tx = _ceil(_ceil(wo, _ceil(wo, ROW_OUTPUTS)), per)
    cv = min(groups, 8)
    toh = max(1, min(ho, THREADS // (cv * tx)))
    toh = _ceil(ho, _ceil(ho, toh))
    if toh == ho and tx * per >= wo:
        cv = min(groups, max(cv, THREADS // (tx * toh)))

    def smem(toh, tx, cv):
        return ((toh - 1) * sh + kh) * ((tx * per - 1) * sw + kw) * cv * 16

    while smem(toh, tx, cv) > SMEM_BYTES:
        if toh > 1:
            toh = _ceil(toh, 2)
        elif tx > 1:
            tx = _ceil(tx, 2)
        elif cv > 1:
            cv = max(1, SMEM_BYTES // smem(1, 1, 1))
            if smem(toh, tx, cv) > SMEM_BYTES:
                return Plan(ho, wo, tiled=False)
        else:
            return Plan(ho, wo, tiled=False)

    def tiles(toh, cv):
        return _ceil(ho, toh), _ceil(wo, tx * per), _ceil(groups, cv)

    while n * math.prod(tiles(toh, cv)) < MIN_BLOCKS:
        if toh > 1:
            toh = _ceil(toh, 2)
        elif cv * tx > 32:
            cv = _ceil(cv, 2)
        else:
            break
    # the same number of chunks, spread evenly over the channel vectors
    cv = _ceil(groups, _ceil(groups, cv))
    return Plan(ho, wo, True, per, tx, toh, cv, tiles(toh, cv), cv * tx * toh,
                smem(toh, tx, cv))


@functools.cache
def plan3d(shape, kernel, stride, pad, mode: str, itemsize: int, aligned: bool) -> Plan3:
    """The path and tile for pooling (N, T, H, W, C) of ``itemsize``-byte
    floats, ``kernel``, ``stride`` and ``pad`` (t, h, w), ``mode`` "max" or
    "ave"; ``aligned`` as in :func:`plan`.  Cached.

    The tile path takes the windows and modes of ``_TILE3``, C * itemsize a
    multiple of 16 on aligned pointers, and a T pad under the T window
    (Caffe's own rule); everything else takes the scalar path.  A tile is
    ``toh`` output rows by a whole output row (up to ROW_OUTPUTS columns,
    split evenly) by CV3 vectors, rows filling THREADS threads and channels
    at least a warp; it walks ``tt`` output frames, at first all of them,
    its threads keeping every open window in registers.  Its ring of RING
    frames must fit in SMEM3_BYTES, shrinking rows, then columns, then
    channels.  Then, until the grid has MIN_BLOCKS blocks: rows (while a
    block keeps 128 threads), frames (a split reads kt - st frames twice),
    rows again, and channels (down to half a warp a block) are split.  At I3D's twelve 3D pools (8
    clips, bf16) these tiles took 8% more time than the best of 3,366 tiles
    timed on an H100.
    """
    n, t, h, w, c = shape
    (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = kernel, stride, pad
    to, ho, wo = (caffe_pool_out_dim(size, k, s, p)[0]
                  for size, k, s, p in zip((t, h, w), kernel, stride, pad))
    el = 16 // itemsize
    key = (kt, kh, kw, st, sh, sw, mode)
    if not aligned or c % el or key not in _TILE3 or pt >= kt:
        return Plan3(to, ho, wo, tiled=False)
    groups = c // el
    per = _TILE3[key]
    tt = to
    tx = _ceil(_ceil(wo, _ceil(wo, ROW_OUTPUTS)), per)
    cv = min(groups, CV3)
    toh = max(1, min(ho, THREADS // (cv * tx)))
    toh = _ceil(ho, _ceil(ho, toh))
    cv = min(groups, max(cv, 32 // (tx * toh)))

    def smem(toh, tx, cv):
        return RING * ((toh - 1) * sh + kh) * ((tx * per - 1) * sw + kw) * cv * 16

    while smem(toh, tx, cv) > SMEM3_BYTES:
        if toh > 1:
            toh = _ceil(toh, 2)
        elif tx > 1:
            tx = _ceil(tx, 2)
        elif cv > 1:
            cv = max(1, SMEM3_BYTES // smem(1, 1, 1))
            if smem(toh, tx, cv) > SMEM3_BYTES:
                return Plan3(to, ho, wo, tiled=False)
        else:
            return Plan3(to, ho, wo, tiled=False)

    def tiles(tt, toh, cv):
        return _ceil(to, tt), _ceil(ho, toh), _ceil(wo, tx * per), _ceil(groups, cv)

    while n * math.prod(tiles(tt, toh, cv)) < MIN_BLOCKS:
        if toh > 1 and _ceil(toh, 2) * tx * cv >= 128:
            toh = _ceil(toh, 2)
        elif tt > 1:
            tt = _ceil(tt, 2)
        elif toh > 1:
            toh = _ceil(toh, 2)
        elif cv * tx * toh > 16:
            cv = _ceil(cv, 2)
        else:
            break
    # the same number of chunks and frame tiles, spread evenly
    cv = _ceil(groups, _ceil(groups, cv))
    tt = _ceil(to, _ceil(to, tt))
    return Plan3(to, ho, wo, True, per, tx, toh, cv, tt, tiles(tt, toh, cv),
                 cv * tx * toh, smem(toh, tx, cv))


@functools.cache
def _kernel():
    fn = _build.load("pool").eco_caffe_pool2d
    fn.argtypes = (
        [ctypes.c_void_p] * 2           # x, out
        + [ctypes.c_int] * 24           # n, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw,
                                        # dtype, ave, tiled, per, tx, toh, cv, row
                                        # tiles, column tiles, chunks, threads, smem
        + [ctypes.c_void_p]             # stream
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel3():
    fn = _build.load("pool").eco_caffe_pool3d
    fn.argtypes = (
        [ctypes.c_void_p] * 2           # x, out
        + [ctypes.c_int] * 31           # n, t, h, w, c, to, ho, wo, kt, kh, kw, st, sh,
                                        # sw, pt, ph, pw, dtype, ave, tiled, per, tx, toh,
                                        # cv, tt, frame tiles, row tiles, column tiles,
                                        # chunks, threads, smem
        + [ctypes.c_void_p]             # stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load the CUDA kernel now rather than at its first launch."""
    _kernel()


def takes(x: torch.Tensor, mode: str) -> bool:
    """True iff ``pool_nd`` sends this pool to K4: a float 2D or 3D MAX or
    AVE pool of a contiguous tensor on the card, with no gradient asked and
    no trace running."""
    return (x.device.type == "cuda" and x.dtype in _DTYPE and x.ndim in (4, 5)
            and mode in _MODE and x.is_contiguous()
            and not (torch.is_grad_enabled() and x.requires_grad)
            and not torch.compiler.is_compiling())


def launch(x: torch.Tensor, kernel, stride, pad, mode: str) -> torch.Tensor:
    """K4's pool of ``x``, unchecked: ``pool_nd``'s call once :func:`takes`
    has held, with ``kernel``, ``stride`` and ``pad`` tuples of ints, one a
    spatial axis.  A 3D window of one frame with stride 1 and no pad along T
    pools each frame alone: the 2D path over the (N * T, H, W, C) view."""
    if x.ndim == 4:
        return _pool2d(x, kernel, stride, pad, mode)
    if (kernel[0], stride[0], pad[0]) == (1, 1, 0):
        n, t = x.shape[:2]
        y = _pool2d(x.view(n * t, *x.shape[2:]), kernel[1:], stride[1:], pad[1:], mode)
        return y.view(n, t, *y.shape[1:])
    return _pool3d(x, kernel, stride, pad, mode)


def caffe_pool(x: torch.Tensor, kernel, stride, pad, mode: str) -> torch.Tensor:
    """Caffe ceil-mode MAX (``mode`` "max") or AVE ("ave") pool of a
    contiguous (N, H, W, C) or (N, T, H, W, C) float tensor on the card;
    ``kernel``, ``stride`` and ``pad`` have one entry a spatial axis."""
    if not takes(x, mode):
        raise ValueError(
            f"caffe_pool takes a contiguous (N, H, W, C) or (N, T, H, W, C) f32/bf16/f16 "
            f"tensor on the card with no gradient asked, mode 'max' or 'ave'; got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}, mode {mode!r}")
    kernel, stride, pad = (tuple(int(v) for v in a) for a in (kernel, stride, pad))
    if not len(kernel) == len(stride) == len(pad) == x.ndim - 2:
        raise ValueError(f"caffe_pool takes one kernel, stride and pad entry a spatial axis "
                         f"of {tuple(x.shape)}; got {kernel}, {stride}, {pad}")
    if min(kernel + stride) < 1 or min(pad) < 0:
        raise ValueError(f"caffe_pool takes kernel >= 1, stride >= 1 and pad >= 0; "
                         f"got {kernel}, {stride}, {pad}")
    return launch(x, kernel, stride, pad, mode)


def _pool2d(x: torch.Tensor, kernel, stride, pad, mode: str) -> torch.Tensor:
    """Launch the 2D path on what :func:`caffe_pool` checks."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    n, h, w, c = x.shape
    p = plan(x.shape, kernel, stride, pad, x.element_size(), x.data_ptr() % 16 == 0)
    out = torch.empty((n, p.ho, p.wo, c), dtype=x.dtype, device=x.device)
    err = _kernel()(
        x.data_ptr(), out.data_ptr(), n, h, w, c, p.ho, p.wo, kh, kw, sh, sw, ph, pw,
        _DTYPE[x.dtype], _MODE[mode], int(p.tiled), p.per, p.tx, p.toh, p.cv, *p.tiles,
        p.threads, p.smem, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"caffe_pool kernel launch failed (2D path): CUDA error {err}")
    COUNTS["k4.launches"] += 1
    return out


def _pool3d(x: torch.Tensor, kernel, stride, pad, mode: str) -> torch.Tensor:
    """Launch the 3D path on what :func:`caffe_pool` checks."""
    p = plan3d(x.shape, kernel, stride, pad, mode, x.element_size(), x.data_ptr() % 16 == 0)
    n, t, h, w, c = x.shape
    out = torch.empty((n, p.to, p.ho, p.wo, c), dtype=x.dtype, device=x.device)
    err = _kernel3()(
        x.data_ptr(), out.data_ptr(), n, t, h, w, c, p.to, p.ho, p.wo, *kernel, *stride, *pad,
        _DTYPE[x.dtype], _MODE[mode], int(p.tiled), p.per, p.tx, p.toh, p.cv, p.tt,
        *p.tiles, p.threads, p.smem, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"caffe_pool kernel launch failed (3D path): CUDA error {err}")
    COUNTS["k4.launches"] += 1
    COUNTS["k4.launches.3d"] += 1
    return out
