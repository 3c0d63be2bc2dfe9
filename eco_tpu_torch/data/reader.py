# A copy of eco_tpu/data/reader.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Frame readers -- io.cpp parity (ReadSegmentRGBToDatum* / Flow variants).

- frames are files ``name_pattern % (frame_index + 1)`` inside the video dir
  (1-based, video_data_layer.cpp name_pattern, e.g. ``img_%04d.jpg``);
- BGR channel order (cv2 native == Caffe/OpenCV native) -- the converted
  caffemodels expect BGR with means 104/117/123;
- optional resize to (new_height, new_width) with bilinear interpolation
  (io.cpp:379-386);
- missing/corrupt frames fall back to the last successfully read frame
  (io.cpp:446-453), the reference's data-side fault tolerance;
- FLOW modality reads ``flow_x/<pat>`` and ``flow_y/<pat>`` grayscale pairs
  (io.cpp:498-623), stacked x-then-y per frame.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _imread(path: str, *, grayscale: bool = False) -> Optional[np.ndarray]:
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR)
    return img


def _maybe_resize(img: np.ndarray, new_height: int, new_width: int) -> np.ndarray:
    if new_height > 0 and new_width > 0:
        img = cv2.resize(img, (new_width, new_height), interpolation=cv2.INTER_LINEAR)
    return img


def read_segment_rgb(
    video_path: str,
    frame_idx: np.ndarray,  # (S, L) 0-based
    *,
    name_pattern: str = "img_%04d.jpg",
    new_height: int = 0,
    new_width: int = 0,
    grayscale: bool = False,
) -> np.ndarray:
    """Returns uint8 (S*L, H, W, C) in BGR; raises if the FIRST frame of the
    video is unreadable (the reference then skips the video,
    video_data_layer.cpp:195-216)."""
    frames = []
    last = None
    for s in range(frame_idx.shape[0]):
        for j in range(frame_idx.shape[1]):
            path = os.path.join(video_path, name_pattern % (int(frame_idx[s, j]) + 1))
            img = _imread(path, grayscale=grayscale)
            if img is None:
                if last is None:
                    raise FileNotFoundError(path)
                img = last  # missing-frame fallback
            else:
                img = _maybe_resize(img, new_height, new_width)
                last = img
            if img.ndim == 2:
                img = img[:, :, None]
            frames.append(img)
    return np.stack(frames)


def read_segment_flow(
    video_path: str,
    frame_idx: np.ndarray,  # (S, L)
    *,
    name_pattern: str = "flow_%05d.jpg",
    new_height: int = 0,
    new_width: int = 0,
) -> np.ndarray:
    """Returns uint8 (S*L, H, W, 2): channel 0 = flow_x, 1 = flow_y."""
    frames = []
    last = None
    for s in range(frame_idx.shape[0]):
        for j in range(frame_idx.shape[1]):
            name = name_pattern % (int(frame_idx[s, j]) + 1)
            fx = _imread(os.path.join(video_path, "flow_x", name), grayscale=True)
            fy = _imread(os.path.join(video_path, "flow_y", name), grayscale=True)
            if fx is None or fy is None:
                if last is None:
                    raise FileNotFoundError(os.path.join(video_path, name))
                pair = last
            else:
                fx = _maybe_resize(fx, new_height, new_width)
                fy = _maybe_resize(fy, new_height, new_width)
                pair = np.stack([fx, fy], axis=-1)
                last = pair
            frames.append(pair)
    return np.stack(frames)
