# A copy of eco_tpu/data/window.py (no framework code); tests/test_torch_data.py holds it to the original.
"""R-CNN style window data source -- WindowDataLayer parity.

Reference: ``src/caffe/layers/window_data_layer.cpp`` (whole file).  The
layer reads a *window file* describing per-image detection windows::

    # image_index
    img_path
    channels height width
    num_windows
    label overlap x1 y1 x2 y2        (one line per window)

Windows with ``overlap >= fg_threshold`` go to the foreground pool (label
must be > 0); windows with ``overlap < bg_threshold`` go to the background
pool with label forced to 0 (``window_data_layer.cpp:129-142``).  Each
batch samples ``batch_size*fg_fraction`` foreground and the rest background
windows (background first, then foreground -- ``:263-267``), crops each
window out of its image with optional *context padding* / square crop
expansion, warps it to ``crop_size x crop_size`` (``:296-386``), mirrors at
random, and subtracts the mean.

TPU-native redesign: a host-side numpy source emitting channels-last
``(B, crop, crop, C)`` float32 batches (the graph side treats the layer as
an input boundary, like the other data layers).  The per-window geometry --
context scaling, clipping, pad rescaling, the mirrored-padding quirk -- is
reproduced exactly; the RNG is numpy instead of Caffe's mt19937 stream.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _round(x: float) -> int:
    """C++ round(): half away from zero (Python's round is banker's)."""
    return int(math.floor(abs(x) + 0.5)) * (1 if x >= 0 else -1)


@dataclass(frozen=True)
class Window:
    """One candidate window (window_data_layer.cpp:120-127)."""

    image_index: int
    label: int
    overlap: float
    x1: int
    y1: int
    x2: int
    y2: int


@dataclass
class WindowDataset:
    """Parsed window file: image table + fg/bg pools."""

    images: list  # [(path, (channels, height, width)), ...]
    fg: list = field(default_factory=list)  # [Window]
    bg: list = field(default_factory=list)  # [Window]


def parse_window_file(
    source: str,
    *,
    fg_threshold: float = 0.5,
    bg_threshold: float = 0.5,
    root_folder: str = "",
) -> WindowDataset:
    """Parse the window-file format (window_data_layer.cpp:41-48,84-153).

    Foreground windows keep their label (must be > 0); background windows
    get label/overlap forced to 0.  Windows falling between the two
    thresholds are discarded, as in the reference.
    """
    ds = WindowDataset(images=[])
    with open(source) as f:
        tokens = f.read().split()
    it = iter(tokens)

    def nxt():
        return next(it)

    try:
        hashtag = nxt()
    except StopIteration:
        raise ValueError("Window file is empty")
    while True:
        if hashtag != "#":
            raise ValueError(f"expected '#', got {hashtag!r}")
        image_index = int(nxt())
        path = os.path.join(root_folder, nxt()) if root_folder else nxt()
        channels, height, width = int(nxt()), int(nxt()), int(nxt())
        if image_index != len(ds.images):
            raise ValueError(
                f"non-sequential image_index {image_index} (expected "
                f"{len(ds.images)})"
            )
        ds.images.append((path, (channels, height, width)))
        num_windows = int(nxt())
        for _ in range(num_windows):
            label = int(nxt())
            overlap = float(nxt())
            x1, y1, x2, y2 = int(nxt()), int(nxt()), int(nxt()), int(nxt())
            if overlap >= fg_threshold:
                if label <= 0:
                    raise ValueError(
                        f"foreground window must have label > 0, got {label}"
                    )
                ds.fg.append(Window(image_index, label, overlap, x1, y1, x2, y2))
            elif overlap < bg_threshold:
                ds.bg.append(Window(image_index, 0, 0.0, x1, y1, x2, y2))
        try:
            hashtag = nxt()
        except StopIteration:
            break
    return ds


def crop_window(
    img: np.ndarray,  # (H, W, C) uint8, BGR
    window: Window,
    *,
    crop_size: int,
    context_pad: int = 0,
    use_square: bool = False,
    do_mirror: bool = False,
    mean_values: Optional[Sequence[float]] = None,
    scale: float = 1.0,
) -> np.ndarray:
    """Crop + context-expand + warp one window (window_data_layer.cpp:296-416).

    Returns a float32 channels-last ``(crop_size, crop_size, C)`` array.
    Out-of-image context becomes zero padding *in output space* (the
    reference zero-fills the batch and only writes the warped region).
    """
    if cv2 is None:  # pragma: no cover
        raise ImportError("cv2 is required for crop_window")
    x1, y1, x2, y2 = window.x1, window.y1, window.x2, window.y2
    rows, cols = img.shape[:2]
    pad_h = pad_w = 0
    out_h = out_w = crop_size
    if context_pad > 0 or use_square:
        # Expand so that after warping to crop_size there are exactly
        # context_pad pixels of context on each side (:316-343).
        context_scale = crop_size / float(crop_size - 2 * context_pad)
        half_height = (y2 - y1 + 1) / 2.0
        half_width = (x2 - x1 + 1) / 2.0
        center_x = x1 + half_width
        center_y = y1 + half_height
        if use_square:
            half_width = half_height = max(half_height, half_width)
        x1 = _round(center_x - half_width * context_scale)
        x2 = _round(center_x + half_width * context_scale)
        y1 = _round(center_y - half_height * context_scale)
        y2 = _round(center_y + half_height * context_scale)

        # Clip to the image, remembering the out-of-image extent (:325-343).
        unclipped_height = y2 - y1 + 1
        unclipped_width = x2 - x1 + 1
        pad_x1 = max(0, -x1)
        pad_y1 = max(0, -y1)
        pad_x2 = max(0, x2 - cols + 1)
        pad_y2 = max(0, y2 - rows + 1)
        x1, x2 = x1 + pad_x1, x2 - pad_x2
        y1, y2 = y1 + pad_y1, y2 - pad_y2
        clipped_height = y2 - y1 + 1
        clipped_width = x2 - x1 + 1

        # Rescale the pads into warped coordinates (:348-371).
        scale_x = crop_size / float(unclipped_width)
        scale_y = crop_size / float(unclipped_height)
        out_w = _round(clipped_width * scale_x)
        out_h = _round(clipped_height * scale_y)
        pad_x1 = _round(pad_x1 * scale_x)
        pad_x2 = _round(pad_x2 * scale_x)
        pad_y1 = _round(pad_y1 * scale_y)
        pad_h = pad_y1
        # Mirroring mirrors the padding too (:366-371).
        pad_w = pad_x2 if do_mirror else pad_x1
        # Rounding can overflow the canvas; clamp (:373-380).
        out_h = min(out_h, crop_size - pad_h)
        out_w = min(out_w, crop_size - pad_w)

    if x1 < 0 or y1 < 0 or x2 >= cols or y2 >= rows or x2 < x1 or y2 < y1:
        # The reference would abort here too (cv::Mat rejects an
        # out-of-bounds cv::Rect); raise a window-specific error instead of
        # silently wrapping via Python negative indexing.
        raise ValueError(
            f"window ({window.x1},{window.y1},{window.x2},{window.y2}) out "
            f"of bounds for {rows}x{cols} image (clip proposals first or "
            "use context_pad)"
        )
    roi = img[y1 : y2 + 1, x1 : x2 + 1]
    warped = cv2.resize(roi, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    if warped.ndim == 2:
        warped = warped[:, :, None]
    if do_mirror:
        warped = warped[:, ::-1]

    channels = img.shape[2] if img.ndim == 3 else 1
    out = np.zeros((crop_size, crop_size, channels), np.float32)
    region = warped.astype(np.float32)
    if mean_values is not None:
        mv = np.asarray(mean_values, np.float32)
        if mv.size == 1:
            mv = np.repeat(mv, channels)
        region = region - mv.reshape(1, 1, channels)
    out[pad_h : pad_h + out_h, pad_w : pad_w + out_w] = region * scale
    return out


class WindowSource:
    """Batched window sampler (the WindowData layer's prefetch loop).

    ``next_batch()`` returns ``(data, label)`` with data channels-last
    ``(batch, crop, crop, C)`` float32 and label ``(batch,)`` int32, in the
    reference's background-then-foreground order
    (window_data_layer.cpp:258-267).
    """

    def __init__(
        self,
        source: str,
        *,
        batch_size: int,
        crop_size: int,
        fg_threshold: float = 0.5,
        bg_threshold: float = 0.5,
        fg_fraction: float = 0.25,
        context_pad: int = 0,
        crop_mode: str = "warp",
        mirror: bool = False,
        mean_values: Optional[Sequence[float]] = None,
        scale: float = 1.0,
        root_folder: str = "",
        cache_images: bool = False,
        seed: int = 0,
    ):
        if crop_size <= 0:
            raise ValueError("WindowData requires crop_size > 0")
        if crop_mode not in ("warp", "square"):
            raise ValueError(f"unknown crop_mode {crop_mode!r}")
        self.ds = parse_window_file(
            source,
            fg_threshold=fg_threshold,
            bg_threshold=bg_threshold,
            root_folder=root_folder,
        )
        if not self.ds.fg or not self.ds.bg:
            # The reference indexes rand % size and would divide by zero.
            raise ValueError(
                "window file must contain both foreground and background "
                f"windows (got fg={len(self.ds.fg)}, bg={len(self.ds.bg)})"
            )
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.fg_fraction = fg_fraction
        self.context_pad = context_pad
        self.use_square = crop_mode == "square"
        self.mirror = mirror
        self.mean_values = mean_values
        self.scale = scale
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[dict] = {} if cache_images else None

    def _read(self, image_index: int) -> np.ndarray:
        path, _ = self.ds.images[image_index]
        if self._cache is not None and image_index in self._cache:
            return self._cache[image_index]
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        if self._cache is not None:
            self._cache[image_index] = img
        return img

    def next_batch(self):
        num_fg = int(self.batch_size * self.fg_fraction)
        counts = (self.batch_size - num_fg, num_fg)  # bg first (:263)
        data = []
        labels = []
        for is_fg in (0, 1):
            pool = self.ds.fg if is_fg else self.ds.bg
            for _ in range(counts[is_fg]):
                window = pool[int(self._rng.integers(len(pool)))]
                do_mirror = bool(self.mirror and self._rng.integers(2))
                img = self._read(window.image_index)
                data.append(
                    crop_window(
                        img,
                        window,
                        crop_size=self.crop_size,
                        context_pad=self.context_pad,
                        use_square=self.use_square,
                        do_mirror=do_mirror,
                        mean_values=self.mean_values,
                        scale=self.scale,
                    )
                )
                labels.append(window.label)
        return np.stack(data), np.asarray(labels, np.int32)
