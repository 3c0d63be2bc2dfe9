# A copy of eco_tpu/data/seg.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Semantic-segmentation data source -- SegDataLayer parity.

Reference: ``src/caffe/layers/seg_data_layer.cpp`` (list handling, the
hardcoded shuffle seed 17, the class-balance retry loop) and the seg
variant of ``DataTransformer::Transform(datum_data, datum_label, ...)``
(``src/caffe/data_transformer.cpp:330-460``): sample one scale ratio from
``scale_ratios=[lower, upper]``, resize the image bilinearly and the label
map nearest-neighbour by that ratio, floor the crop dims to a multiple of
``stride`` (clipped by ``upper_size`` / ``upper_height``+``upper_width``),
take ONE random crop + mirror shared by image and label, then mean/scale
the image only.

TPU-native redesign: a host-side numpy source; one sample per call (the
reference layer emits batch 1 -- seg_data_layer.cpp:77-82), channels-last
``(1, H, W, C)`` float32 data and ``(1, H, W)`` int32 label.  Output
spatial dims vary per sample with the sampled scale; pad/bucket on the
caller side if a fixed shape is needed under jit.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def parse_seg_list(source: str, root_dir: str = "") -> list:
    """Lines of ``img_path label_path`` (seg_data_layer.cpp:41-46)."""
    pairs = []
    with open(source) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"expected 'img label' pair, got {line!r}")
            pairs.append(
                (os.path.join(root_dir, parts[0]), os.path.join(root_dir, parts[1]))
            )
    return pairs


def transform_seg(
    img: np.ndarray,  # (H, W, C) uint8
    label: np.ndarray,  # (H, W) uint8/int
    *,
    rng: np.random.Generator,
    stride: int = 1,
    scale_ratios: Optional[Sequence[float]] = None,
    upper_size: Optional[int] = None,
    upper_height: Optional[int] = None,
    upper_width: Optional[int] = None,
    mirror: bool = False,
    mean_values: Optional[Sequence[float]] = None,
    scale: float = 1.0,
):
    """One joint image+label transform (data_transformer.cpp:330-460)."""
    if cv2 is None:  # pragma: no cover
        raise ImportError("cv2 is required for transform_seg")
    if img.shape[:2] != label.shape[:2]:
        raise ValueError(
            f"image {img.shape[:2]} and label {label.shape[:2]} disagree"
        )
    lower, upper = (1.0, 1.0)
    if scale_ratios is not None:
        if len(scale_ratios) != 2:
            raise ValueError("scale_ratios must be [lower, upper]")
        lower, upper = scale_ratios
    # Rand(int((u-l)*1000)+1)/1000 + lower  (:371)
    ratio = int(rng.integers(int((upper - lower) * 1000.0) + 1)) / 1000.0 + lower
    dh, dw = img.shape[:2]
    height = int(dh * ratio + 0.5)
    width = int(dw * ratio + 0.5)

    crop_height = height // stride * stride
    crop_width = width // stride * stride
    if upper_size is not None:
        crop_height = min(crop_height, upper_size)
        crop_width = min(crop_width, upper_size)
    elif upper_height is not None and upper_width is not None:
        crop_height = min(crop_height, upper_height)
        crop_width = min(crop_width, upper_width)

    h_off = int(rng.integers(height - crop_height + 1))
    w_off = int(rng.integers(width - crop_width + 1))
    do_mirror = bool(mirror and rng.integers(2))

    im = cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    if im.ndim == 2:
        im = im[:, :, None]
    im = im[h_off : h_off + crop_height, w_off : w_off + crop_width]
    lab = cv2.resize(
        label.astype(np.uint8), (width, height), interpolation=cv2.INTER_NEAREST
    )
    lab = lab[h_off : h_off + crop_height, w_off : w_off + crop_width]
    if do_mirror:
        im = im[:, ::-1]
        lab = lab[:, ::-1]

    out = im.astype(np.float32)
    if mean_values is not None:
        mv = np.asarray(mean_values, np.float32)
        if mv.size == 1:
            mv = np.repeat(mv, out.shape[2])
        out = out - mv.reshape(1, 1, -1)
    return out * scale, lab.astype(np.int32)


class SegSource:
    """Cycles a seg list file, one transformed sample per ``next_sample``.

    ``balance=True`` reproduces the retry loop (seg_data_layer.cpp:106-124):
    if one label value covers > 80% of the crop, re-transform (new random
    scale/crop) up to 10 times.
    """

    def __init__(
        self,
        source: str,
        *,
        root_dir: str = "",
        shuffle: bool = False,
        balance: bool = False,
        stride: int = 1,
        scale_ratios: Optional[Sequence[float]] = None,
        upper_size: Optional[int] = None,
        upper_height: Optional[int] = None,
        upper_width: Optional[int] = None,
        mirror: bool = False,
        mean_values: Optional[Sequence[float]] = None,
        scale: float = 1.0,
        seed: int = 17,  # the reference's hardcoded "magic number" (:49)
    ):
        self.lines = parse_seg_list(source, root_dir)
        if not self.lines:
            raise ValueError(f"empty seg list {source!r}")
        self.shuffle = shuffle
        self.balance = balance
        self.kwargs = dict(
            stride=stride,
            scale_ratios=scale_ratios,
            upper_size=upper_size,
            upper_height=upper_height,
            upper_width=upper_width,
            mirror=mirror,
            mean_values=mean_values,
            scale=scale,
        )
        self._rng = np.random.default_rng(seed)
        self._idx = 0
        if shuffle:
            self._rng.shuffle(self.lines)

    def next_sample(self):
        img_path, label_path = self.lines[self._idx]
        img = cv2.imread(img_path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(img_path)
        lab = cv2.imread(label_path, cv2.IMREAD_GRAYSCALE)
        if lab is None:
            raise FileNotFoundError(label_path)

        data, label = transform_seg(img, lab, rng=self._rng, **self.kwargs)
        if self.balance:
            for _ in range(10):
                counts = np.bincount(label.reshape(-1), minlength=256)
                if counts.max() <= 0.8 * label.size:
                    break
                data, label = transform_seg(
                    img, lab, rng=self._rng, **self.kwargs
                )

        # advance + wrap with reshuffle (:157-166)
        self._idx += 1
        if self._idx >= len(self.lines):
            self._idx = 0
            if self.shuffle:
                self._rng.shuffle(self.lines)
        return data[None], label[None]
