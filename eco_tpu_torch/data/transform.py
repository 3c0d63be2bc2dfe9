# A copy of eco_tpu/data/transform.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Per-sample augmentation -- DataTransformer parity (data_transformer.cpp).

ONE crop/scale/mirror decision is sampled per video and applied to the whole
segment stack (temporal consistency exactly as in the reference, where all
segments share the stacked datum's channels).

Semantics reproduced:
- multi-scale crop sizes ``min(H,W) * ratios`` for ratio pairs (h, w) with
  ``|h-w| <= max_distort``; sizes within 3px of the net input snap to it
  (fillCropSize, data_transformer.cpp:83-104);
- fixed-position crop grid: 5 offsets, or 13 with more_fix_crop
  (fillFixOffset, :50-75); otherwise uniform random offset;
- TEST: center crop of crop_size;
- cropped patch resized (bilinear) to crop_size when it differs (:255-268);
- mirror = horizontal flip; flow x-channels additionally become 255 - v
  (:280-301, the c < C/2 rule applied per flow pair here);
- mean subtraction: per-channel mean_values replicated across the stack
  (:177-195) or a full mean array; then ``* scale``.

Inception-style random area/aspect cropping for original images
(sampleRandomCropSize, :109-144) is ``sample_random_crop_size``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

DEFAULT_SCALE_RATIOS = (1.0, 0.875, 0.75, 0.66)


@dataclass
class TransformConfig:
    crop_size: int = 224
    mirror: bool = True
    fix_crop: bool = True
    more_fix_crop: bool = True
    multi_scale: bool = True
    max_distort: int = 1
    scale_ratios: Sequence[float] = DEFAULT_SCALE_RATIOS
    is_flow: bool = False
    mean_values: Sequence[float] = (104.0, 117.0, 123.0)  # BGR
    scale: float = 1.0


def fill_fix_offsets(h: int, w: int, crop_h: int, crop_w: int, more: bool):
    ho, wo = (h - crop_h) // 4, (w - crop_w) // 4
    offs = [
        (0, 0), (0, 4 * wo), (4 * ho, 0), (4 * ho, 4 * wo), (2 * ho, 2 * wo),
    ]
    if more:
        offs += [
            (0, 2 * wo), (4 * ho, 2 * wo), (2 * ho, 0), (2 * ho, 4 * wo),
            (ho, wo), (ho, 3 * wo), (3 * ho, wo), (3 * ho, 3 * wo),
        ]
    return offs


def fill_crop_sizes(h: int, w: int, net_h: int, net_w: int,
                    max_distort: int, ratios: Sequence[float]):
    base = min(h, w)
    sizes = []
    for i, rh in enumerate(ratios):
        crop_h = int(base * rh)
        crop_h = net_h if abs(crop_h - net_h) < 3 else crop_h
        for j, rw in enumerate(ratios):
            crop_w = int(base * rw)
            crop_w = net_w if abs(crop_w - net_w) < 3 else crop_w
            if abs(i - j) <= max_distort:
                sizes.append((crop_h, crop_w))
    return sizes


def sample_random_crop_size(
    h: int, w: int, rng: np.random.Generator,
    min_scale=0.08, max_scale=1.0, min_as=0.75, max_as=1.33,
):
    total = h * w
    for _ in range(10):
        target = total * rng.uniform(min_scale, max_scale)
        aspect = rng.uniform(min_as, max_as)
        ch = int(np.sqrt(target / aspect))
        cw = int(np.sqrt(target * aspect))
        if ch <= h and cw <= w:
            return ch, cw
    return h // 8 * 7, w // 8 * 7


def transform_stack(
    stack: np.ndarray,  # (T, H, W, C) uint8, one video's segment stack
    cfg: TransformConfig,
    *,
    train: bool,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Returns float32 (T, crop, crop, C)."""
    t, h, w, c = stack.shape
    cs = cfg.crop_size
    if h < cs or w < cs:
        raise ValueError(f"frame {h}x{w} smaller than crop {cs}")
    if train and rng is None:
        rng = np.random.default_rng()

    do_mirror = bool(cfg.mirror and train and rng.integers(0, 2))
    if train:
        if cfg.multi_scale:
            sizes = fill_crop_sizes(h, w, cs, cs, cfg.max_distort, cfg.scale_ratios)
            crop_h, crop_w = sizes[rng.integers(0, len(sizes))]
        else:
            crop_h, crop_w = cs, cs
        if cfg.fix_crop:
            offs = fill_fix_offsets(h, w, crop_h, crop_w, cfg.more_fix_crop)
            h_off, w_off = offs[rng.integers(0, len(offs))]
        else:
            h_off = int(rng.integers(0, h - crop_h + 1))
            w_off = int(rng.integers(0, w - crop_w + 1))
    else:
        crop_h, crop_w = cs, cs
        h_off, w_off = (h - cs) // 2, (w - cs) // 2

    patch = stack[:, h_off:h_off + crop_h, w_off:w_off + crop_w, :]
    if (crop_h, crop_w) != (cs, cs):
        patch = np.stack(
            [cv2.resize(fr, (cs, cs), interpolation=cv2.INTER_LINEAR) for fr in patch]
        )
        if patch.ndim == 3:
            patch = patch[..., None]
    out = patch.astype(np.float32)
    if do_mirror:
        out = out[:, :, ::-1, :]
        if cfg.is_flow:
            out[..., 0] = 255.0 - out[..., 0]  # flow_x negation under mirror

    mean = np.asarray(cfg.mean_values, np.float32)
    if mean.size == 1:
        mean = np.full((out.shape[-1],), float(mean.reshape(())), np.float32)
    elif mean.size != out.shape[-1]:
        # replicate the group across channels (data_transformer.cpp:186-193)
        reps = -(-out.shape[-1] // mean.size)
        mean = np.tile(mean, reps)[: out.shape[-1]]
    out = (out - mean) * cfg.scale
    return np.ascontiguousarray(out)
