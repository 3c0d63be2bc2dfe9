"""Crop and bilinear resize on the device: the multi-scale raw plane.

Twin of ``eco_tpu/ops/resize.py``.  The reference's multi-scale augmentation
crops a sampled (crop_h, crop_w) window and resizes it to the net's input
with cv2 (data_transformer.cpp:83-144, 255-268).  Separable bilinear
interpolation is a pair of matrix products: for each video, row and column
sampling matrices R (cs x H) and C (cs x W), each two one-hots blended by
the fractional weight, give ``out = R @ frame @ C^T``, with static shapes
and a different window per video.  Here that is two batched products over
the videos of a batch.

Coordinates follow cv2.resize INTER_LINEAR (half-pixel centres, edge
clamp), so outputs agree with the host transform within OpenCV's
fixed-point rounding.  At (crop_h, crop_w) == (cs, cs) the matrices are
shifted identities and the op is an exact crop.

The products run in f32 at full precision whatever the process asks of f32
matmuls elsewhere (TF32, ``set_float32_matmul_precision``): the reference
pins ``Precision.HIGHEST``, since a 10-bit mantissa moves the outputs by
gray levels.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products at full precision inside, the caller's setting after."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def interp_matrix(offset: torch.Tensor, size: torch.Tensor, full: int,
                  out_size: int) -> torch.Tensor:
    """(N, out_size, full) bilinear sampling matrices, one per video, for a
    window of ``size[n]`` starting at ``offset[n]`` on a length-``full``
    axis."""
    i = torch.arange(out_size, dtype=torch.float32, device=size.device)
    # cv2 half-pixel rule: src = (dst + 0.5) * size/out - 0.5, edge-clamped.
    # The divisor is a tensor on the device: CUDA divides by a Python or CPU
    # scalar as a multiply by its reciprocal, which is off by an ulp, and a
    # full-size window would then blend neighbouring pixels
    out = torch.full((), float(out_size), device=size.device)
    y = (i + 0.5) * size.float()[:, None] / out - 0.5
    y0 = torch.floor(y)
    frac = y - y0
    top = (size - 1)[:, None]
    lo = torch.minimum(y0.long().clamp_min(0), top)
    hi = torch.minimum((y0.long() + 1).clamp_min(0), top)
    # callers keep offset + size <= full (the pipelines' samplers do); a
    # stray window is clamped to the image edge (border replication)
    lo = (offset[:, None] + lo).clamp(0, full - 1)
    hi = (offset[:, None] + hi).clamp(0, full - 1)
    one_hot = lambda idx: torch.nn.functional.one_hot(idx, full).float()
    return one_hot(lo) * (1.0 - frac)[..., None] + one_hot(hi) * frac[..., None]


def crop_resize(frames: torch.Tensor, h_off, w_off, crop_h, crop_w, *,
                out_size: int) -> torch.Tensor:
    """Per-video crop of (crop_h, crop_w) at (h_off, w_off) of ``frames``
    (N, S, H, W, C), uint8 or float, bilinearly resized to (out_size,
    out_size).  Returns f32 (N, S, out_size, out_size, C).  The offsets and
    sizes are (N,) integers, host or device."""
    n, s, h, w, c = frames.shape
    dev = frames.device
    as_long = lambda v: torch.as_tensor(v).to(dev, torch.int64)
    rows_m = interp_matrix(as_long(h_off), as_long(crop_h), h, out_size)  # (N, cs, H)
    cols_m = interp_matrix(as_long(w_off), as_long(crop_w), w, out_size)  # (N, cs, W)
    f = frames.float()
    with _full_f32_matmul():
        # rows: (N, cs, H) @ (N, H, S*W*C)
        rows = rows_m @ f.permute(0, 2, 1, 3, 4).reshape(n, h, s * w * c)
        rows = rows.reshape(n, out_size, s, w, c)
        # columns: (N, cs, W) @ (N, W, cs*S*C)
        cols = cols_m @ rows.permute(0, 3, 1, 2, 4).reshape(n, w, out_size * s * c)
    # (N, cs_w, cs_h, S, C) -> (N, S, cs_h, cs_w, C)
    return cols.reshape(n, out_size, out_size, s, c).permute(0, 3, 2, 1, 4).contiguous()


def preprocess_resize_on_device(frames_u8: torch.Tensor, h_off, w_off, crop_h, crop_w,
                                mirror, *, crop: int = 224,
                                mean=(104.0, 117.0, 123.0),
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Multi-scale analogue of ``ops.preprocess.preprocess_on_device``: raw
    uint8 (N, S, H, W, 3) BGR frames in, model-ready clips out (the sampled
    window resized to ``crop``, mirrored where ``mirror``, minus the mean,
    cast to ``out_dtype``)."""
    clips = crop_resize(frames_u8, h_off, w_off, crop_h, crop_w, out_size=crop)
    flip = torch.as_tensor(mirror).to(clips.device, torch.bool)[:, None, None, None, None]
    clips = torch.where(flip, clips.flip(3), clips)
    meanv = torch.tensor(mean, dtype=torch.float32).to(clips.device, non_blocking=True)
    return (clips - meanv).to(out_dtype)
