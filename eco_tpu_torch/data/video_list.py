# A copy of eco_tpu/data/video_list.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Video list parsing: ``path n_frames label`` lines.

Format per reference README.md:58-62 and data_list/*.txt; the MATLAB list
builders (scripts/create_lists/create_list_kinetics.m:26-40) drop videos with
<= 5 frames -- exposed here as ``min_frames``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class VideoRecord:
    path: str
    num_frames: int
    label: int


def parse_video_list(
    source: str | os.PathLike,
    *,
    root: Optional[str] = None,
    min_frames: int = 0,
) -> List[VideoRecord]:
    records = []
    with open(source) as f:
        for ln, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                raise ValueError(f"{source}:{ln + 1}: expected 'path n_frames label'")
            path, n, label = parts[0], int(parts[1]), int(parts[2])
            if n <= min_frames:
                continue
            if root is not None:
                path = os.path.join(root, path)
            records.append(VideoRecord(path, n, label))
    return records
