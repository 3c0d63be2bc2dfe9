"""Caffe ceil-mode 3x3 / stride-2 max pool with an optional affine + ReLU.

Twin of ``eco_tpu/ops/pallas/poolfuse.py`` (K2).  It is called directly:
no route of ``ops/pool.py:pool_nd`` takes it, because K4 (``ops/poolk.py``)
takes every float pool on the card, this one's 3x3/s2 windows included.

- ``fused_maxpool_3x3s2`` keeps the reference signature, less its TPU-only
  ``images_per_step`` and ``interpret``.  A CUDA tensor goes to the
  hand-written kernel ``csrc/poolfuse.cu`` (built with ``nvcc`` at first
  use) or the call raises; a CPU tensor goes to the plain version.
- ``fused_maxpool_3x3s2_reference`` is that plain PyTorch version.
- ``COUNTS["k2.launches"]`` (``utils/tracing.py``) counts kernel launches.

The kernel has no backward, because the reference's has none (``jax.grad``
through the Pallas call fails): asking for a gradient through it raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from eco_tpu_torch.ops import _build
from eco_tpu_torch.utils.tracing import COUNTS

_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the clipped last window's fill when no ReLU makes 0 the identity
_FILL = -3.0e38


@functools.cache
def _kernel():
    fn = _build.load("poolfuse").eco_fused_maxpool_3x3s2
    fn.argtypes = (
        [ctypes.c_void_p] * 4           # x, scale, shift, out
        + [ctypes.c_int] * 8            # n, h, w, c, dtype, affine, relu, vec
        + [ctypes.c_void_p]             # stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load the CUDA kernel now rather than at its first launch."""
    _kernel()


def supports(x_shape, kernel, stride, pad, mode: str) -> bool:
    """True iff fused_maxpool_3x3s2 implements this pooling config."""
    if len(x_shape) != 4 or mode.lower() != "max":
        return False
    n, h, w, c = x_shape
    return (
        tuple(kernel) == (3, 3) and tuple(stride) == (2, 2)
        and tuple(pad) == (0, 0) and h % 2 == 0 and w % 2 == 0 and w >= 4
    )


def _check(y, scale, shift, affine):
    if y.ndim != 4 or not supports(y.shape, (3, 3), (2, 2), (0, 0), "max"):
        raise ValueError(
            f"fused_maxpool_3x3s2 takes (N, H, W, C) with H, W even and W >= 4, "
            f"got {tuple(y.shape)}")
    if not y.dtype.is_floating_point:
        raise ValueError(f"fused_maxpool_3x3s2 takes floats, got {y.dtype}")
    if affine and (scale is None or shift is None):
        raise ValueError("affine=True needs scale and shift")
    if torch.is_grad_enabled() and y.requires_grad:
        raise NotImplementedError(
            "fused_maxpool_3x3s2 has no backward; the reference's Pallas kernel "
            "cannot be differentiated either")


def fused_maxpool_3x3s2_reference(y, scale=None, shift=None, *, affine: bool = False,
                                  relu: bool = False):
    """Plain PyTorch version: affine and ReLU in f32, pad the last row and
    column with the fill, then ``F.max_pool2d`` on the channels-last view."""
    z = y
    if affine:
        z = y.float() * scale.float() + shift.float()
    if relu or affine:
        z = torch.relu(z.float())
        fill = 0.0
    else:
        # the f32 fill cast to the input type, as the reference casts it
        # (-inf in f16, which -3e38 overflows)
        fill = torch.tensor(_FILL).to(y.dtype).item()
    z = F.pad(z, (0, 0, 0, 1, 0, 1), value=fill)
    out = F.max_pool2d(z.movedim(-1, 1), 3, 2).movedim(1, -1)
    return out.to(y.dtype).contiguous()


def _fused_maxpool_cuda(y, scale, shift, *, affine: bool, relu: bool):
    if y.dtype not in _DTYPE:
        raise ValueError(f"no fused_maxpool_3x3s2 kernel for {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("fused_maxpool_3x3s2 takes a contiguous tensor")
    n, h, w, c = y.shape
    out = torch.empty((n, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    sc = sh = None
    if affine:
        sc, sh = (torch.as_tensor(v, device=y.device).float().contiguous()
                  for v in (scale, shift))
        if tuple(sc.shape) != (c,) or tuple(sh.shape) != (c,):
            raise ValueError(f"scale and shift must have shape ({c},)")
    vec = (c * y.element_size()) % 16 == 0 and y.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    err = _kernel()(
        y.data_ptr(), sc.data_ptr() if affine else None,
        sh.data_ptr() if affine else None, out.data_ptr(),
        n, h, w, c, _DTYPE[y.dtype], int(affine), int(relu), int(vec),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_maxpool_3x3s2 kernel launch failed: CUDA error {err}")
    COUNTS["k2.launches"] += 1
    return out


def fused_maxpool_3x3s2(y, scale=None, shift=None, *, affine: bool = False,
                        relu: bool = False):
    """Ceil-mode 3x3/s2 max pool of (N, H, W, C), H and W even.

    ``affine``: apply per-channel f32 scale/shift (+ReLU) first -- the
    unfolded inference BN epilogue.  ``relu``: plain ReLU first.
    """
    _check(y, scale, shift, affine)
    if y.device.type == "cuda":
        return _fused_maxpool_cuda(y, scale, shift, affine=affine, relu=relu)
    if y.device.type == "cpu":
        return fused_maxpool_3x3s2_reference(y, scale, shift, affine=affine, relu=relu)
    raise ValueError(f"no fused_maxpool_3x3s2 for device {y.device}")
