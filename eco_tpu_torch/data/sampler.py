# A copy of eco_tpu/data/sampler.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Uniform segment sampling -- VideoDataLayer parity.

Reference semantics (video_data_layer.cpp:152-190):
- ``average_duration = n_frames / num_segments`` (float division, offsets
  floored through int casts);
- TRAIN: if average_duration >= new_length, each segment i gets offset
  ``i*avg + U{0 .. avg-new_length}``; else offset ``i*avg`` (floored);
- TEST: center offset ``(avg - new_length + 1)/2 + i*avg`` (int division),
  or 0 when the video is shorter than a clip;
- optional intra-clip striding: each of the ``new_length`` frames may skip
  ``step`` frames, with per-frame random skip when ``rand_step``
  (frames read at ``offset + j*step + skip[j]``, io.cpp:423-496).
"""

from __future__ import annotations

import numpy as np


def sample_offsets(
    n_frames: int,
    num_segments: int,
    new_length: int = 1,
    *,
    train: bool,
    rng: np.random.Generator | None = None,
    step: int = 1,
    rand_step: bool = False,
):
    """Returns (offsets[num_segments], skips[num_segments, new_length]),
    0-based frame offsets of each segment clip.

    NOTE: ``average_duration`` is an INTEGER in the reference --
    ``lines_duration_`` is vector<int>, so video_data_layer.cpp:156 computes
    int/int division before widening to double.  Frame indices therefore use
    the floored duration.
    """
    avg = n_frames // num_segments
    offsets = np.zeros(num_segments, np.int64)
    skips = np.zeros((num_segments, new_length), np.int64)
    for i in range(num_segments):
        if train:
            if avg >= new_length:
                assert rng is not None
                off = rng.integers(0, int(avg) - new_length + 1)
                offsets[i] = int(off + i * avg)
                if rand_step and step > 1:
                    skips[i] = rng.integers(0, step, new_length)
            else:
                offsets[i] = int(i * avg)
        else:
            if avg >= new_length:
                offsets[i] = int((avg - new_length + 1) / 2 + i * avg)
            else:
                offsets[i] = 0
    return offsets, skips


def frame_indices(offsets, skips, new_length: int = 1, step: int = 1):
    """Expand clip offsets to per-frame 0-based indices, shape (S, L)."""
    offsets = np.asarray(offsets)[:, None]
    j = np.arange(new_length)[None, :]
    return offsets + j * step + np.asarray(skips)


def streaming_allocation(num_windows: int, total: int = 16):
    """The online-recognition sampling-memory schedule
    (scripts/online_recognition/online_recognition.py:23): with k historical
    windows active, window j (oldest first) contributes algo[k-1][j] frames,
    newer windows contributing more.  For ``total != 16`` the 16-frame table
    is rescaled proportionally (newest window absorbs rounding)."""
    algo = [[16], [8, 8], [4, 4, 8], [2, 2, 4, 8], [1, 1, 2, 4, 8]]
    k = min(num_windows, len(algo))
    while k >= 1:
        alloc = algo[k - 1]
        if total != 16:
            alloc = [max(1, a * total // 16) for a in alloc]
            alloc[-1] += total - sum(alloc)
            if alloc[-1] < 1:
                # too few segments for this many windows: drop the oldest
                k -= 1
                continue
        return alloc
    raise ValueError(f"total={total} must be >= 1")


def subsample_window(frames, count: int):
    """linspace subsampling of one window's frames to ``count`` items --
    np.rint rounding exactly like the reference
    (online_recognition.py:74-77: rint(linspace(0, n-1, count)))."""
    n = len(frames)
    idx = np.rint(np.linspace(0, n - 1, count)).astype(np.int64)
    return [frames[i] for i in idx]
