"""Device-side preprocessing of raw uint8 frames: crop, mirror, mean, cast.

Twin of ``eco_tpu/ops/pallas/preprocess.py``.  The host ships raw uint8
frames ``(N, S, H, W, 3)`` BGR with per-video crop offsets and mirror flags;
one pass on the device produces model-ready clips ``(N, S, crop, crop, 3)``.

- ``preprocess_on_device`` keeps the reference signature.  A CUDA tensor goes
  to the hand-written kernel ``csrc/preprocess.cu`` (built with ``nvcc`` at
  first use) or the call raises; a CPU tensor goes to the plain version.
- ``crop_normalize_reference`` is that plain PyTorch version.
- ``COUNTS["k1.launches"]`` (``utils/tracing.py``) counts kernel launches;
  an ``eco.k1`` span covers ``preprocess_on_device``.
- ``_pack_aug`` hands the kernel the per-video offsets and mirror flags in
  one small tensor with no stream sync, from the host or from the card.

Crop offsets are clamped into the frame, as ``lax.dynamic_slice`` clamps in
the reference's portable twin (``convert/export_hlo.py:_crop_normalize_xla``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from eco_tpu_torch.ops import _build
from eco_tpu_torch.utils.tracing import COUNTS, span

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@functools.cache
def _kernel():
    fn = _build.load("preprocess").eco_crop_normalize
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int]    # frames, aug, aug is int64
        + [ctypes.c_void_p]                       # out
        + [ctypes.c_int] * 5                      # videos, segments, height, width, crop
        + [ctypes.c_float] * 3                    # mean (B, G, R)
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]  # kind, scale, stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load the CUDA kernel now rather than at its first launch."""
    _kernel()


def crop_normalize_reference(frames_u8, h_off, w_off, mirror, *, crop: int,
                             mean, out_dtype, act_scale: float | None = None):
    """Plain PyTorch version: indexing for the crop, ``flip`` for the mirror."""
    n, s, h, w, _ = frames_u8.shape
    dev = frames_u8.device
    ar = torch.arange(crop, device=dev)
    h0 = torch.as_tensor(h_off, device=dev).long().clamp(0, h - crop)
    w0 = torch.as_tensor(w_off, device=dev).long().clamp(0, w - crop)
    vid = torch.arange(n, device=dev)[:, None, None]
    rows = (h0[:, None] + ar)[:, :, None]
    cols = (w0[:, None] + ar)[:, None, :]
    win = frames_u8.permute(0, 2, 3, 1, 4)[vid, rows, cols]  # (N, crop, crop, S, 3)
    y = win.permute(0, 3, 1, 2, 4).float() - torch.tensor(
        mean, dtype=torch.float32, device=dev)
    if act_scale is not None:
        # A 0-d device tensor, not a Python float: CUDA's division by a CPU
        # scalar multiplies by its reciprocal, which can differ in the last bit.
        scale = torch.tensor(act_scale, dtype=torch.float32, device=dev)
        y = torch.clamp(torch.round(y / scale), -127, 127)
        out_dtype = torch.int8
    flip = torch.as_tensor(mirror, device=dev).bool().view(n, 1, 1, 1, 1)
    y = torch.where(flip, y.flip(3), y)
    return y.to(out_dtype).contiguous()


_INT32 = np.iinfo(np.int32)


def _pack_aug(h_off, w_off, mirror, n: int, device) -> torch.Tensor:
    """The per-video ``(h_off, w_off, mirror)`` as one ``(3, n)`` integer
    tensor on ``device``, made without a stream sync.

    Host values (numpy arrays, lists, CPU tensors) are packed into one int32
    tensor, in pinned memory when ``device`` is a card, and copied with
    ``non_blocking=True``: one small copy, whose pinned block PyTorch's
    caching host allocator keeps until the copy is done.  Offsets are
    clamped to the int32 range first (the kernel clamps them into the
    frame).  Tensors on a card are stacked where they lie, one launch; the
    stack keeps int32 or int64, so the kernel reads either."""
    vals = {"h_off": h_off, "w_off": w_off, "mirror": mirror}
    for name, v in vals.items():
        if tuple(np.shape(v)) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(np.shape(v))}")
    device = torch.device(device)
    if any(isinstance(v, torch.Tensor) and v.device.type != "cpu" for v in vals.values()):
        rows = [torch.as_tensor(v).to(device, non_blocking=True) for v in vals.values()]
        if rows[2].is_floating_point():
            rows[2] = rows[2] != 0
        packed = torch.stack(rows)
        return packed if packed.dtype in (torch.int32, torch.int64) else packed.to(torch.int32)
    packed = torch.empty((3, n), dtype=torch.int32, pin_memory=device.type == "cuda")
    rows = packed.numpy()
    rows[0] = np.clip(np.asarray(h_off), _INT32.min, _INT32.max)
    rows[1] = np.clip(np.asarray(w_off), _INT32.min, _INT32.max)
    rows[2] = np.asarray(mirror) != 0
    return packed.to(device, non_blocking=True)


def _crop_normalize_cuda(frames_u8, h_off, w_off, mirror, *, crop: int,
                         mean, out_dtype, act_scale: float | None):
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 5 or frames_u8.shape[-1] != 3:
        raise ValueError(
            f"frames must be uint8 (N, S, H, W, 3), got {frames_u8.dtype} "
            f"{tuple(frames_u8.shape)}")
    if not frames_u8.is_contiguous():
        raise ValueError("frames must be contiguous")
    n, s, h, w, _ = frames_u8.shape
    if not 0 < crop <= min(h, w):
        raise ValueError(f"crop {crop} does not fit frames of {h}x{w}")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if len(mean) != 3:
        raise ValueError(f"mean must have 3 entries, got {mean!r}")
    dev = frames_u8.device
    aug = _pack_aug(h_off, w_off, mirror, n, dev)
    out = torch.empty((n, s, crop, crop, 3), dtype=out_dtype, device=dev)
    err = _kernel()(
        frames_u8.data_ptr(), aug.data_ptr(), int(aug.dtype == torch.int64), out.data_ptr(),
        n, s, h, w, crop, float(mean[0]), float(mean[1]), float(mean[2]),
        _OUT_KIND[out_dtype], float(act_scale or 1.0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"crop_normalize kernel launch failed: CUDA error {err}")
    COUNTS["k1.launches"] += 1
    return out


def preprocess_on_device(frames_u8, h_off, w_off, mirror, *, crop: int = 224,
                         mean=(104.0, 117.0, 123.0), out_dtype=torch.bfloat16,
                         act_scale: float | None = None):
    """uint8 (N, S, H, W, 3) + per-video (h_off, w_off, mirror) -> clips.

    ``act_scale`` set -> int8 clips ``clip(round((x - mean) / act_scale))``,
    the input plane of int8-quantized graphs.
    """
    if act_scale is not None:
        out_dtype = torch.int8
    kw = dict(crop=crop, mean=mean, out_dtype=out_dtype, act_scale=act_scale)
    with span("eco.k1"):
        if frames_u8.device.type == "cuda":
            return _crop_normalize_cuda(frames_u8, h_off, w_off, mirror, **kw)
        if frames_u8.device.type == "cpu":
            return crop_normalize_reference(frames_u8, h_off, w_off, mirror, **kw)
    raise ValueError(f"no crop_normalize for device {frames_u8.device}")
