# A copy of eco_tpu/tools/datasets.py (no framework code); tests/test_torch_cli.py holds it to the original.
"""Dataset tooling: list creation + ffmpeg frame extraction.

Python replacements for the reference's MATLAB/shell helpers:
- ``create_list``: walk a frame-root directory emitting ``path n_frames
  label`` lines, dropping videos with <= min_frames frames
  (scripts/create_lists/create_list_kinetics.m:26-40);
- ``extract_frames``: ffmpeg ``-qscale:v 2 -r <fps>`` to ``img_%04d.jpg``
  (scripts/extract_frames/extract_frames_frmRate.sh:19).
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Mapping, Optional, Sequence


def create_list(
    frames_root: str,
    class_to_label: Mapping[str, int],
    *,
    out_path: Optional[str] = None,
    min_frames: int = 5,
    frame_regex: str = r"img_\d+\.jpg$",
) -> list[str]:
    """Walk ``frames_root/<class>/<video>/img_*.jpg`` -> list lines."""
    pat = re.compile(frame_regex)
    lines = []
    for cls in sorted(os.listdir(frames_root)):
        cdir = os.path.join(frames_root, cls)
        if not os.path.isdir(cdir) or cls not in class_to_label:
            continue
        label = class_to_label[cls]
        for vid in sorted(os.listdir(cdir)):
            vdir = os.path.join(cdir, vid)
            if not os.path.isdir(vdir):
                continue
            n = sum(1 for f in os.listdir(vdir) if pat.search(f))
            if n <= min_frames:
                continue
            lines.append(f"{vdir} {n} {label}")
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return lines


def class_index(classes: Sequence[str]) -> dict[str, int]:
    """class name -> 0-based label (class_ind_*.txt equivalent)."""
    return {c: i for i, c in enumerate(sorted(classes))}


def load_class_index(path: str) -> dict[int, str]:
    """Parse a class-map file into {index: name}.

    Accepts the reference's ``class_ind_*.txt`` format -- lines of
    ``index<ws>'name'`` split on the first whitespace with quotes stripped
    (scripts/online_recognition/online_recognition.py:20-28) -- and plain
    one-name-per-line files (index = line number).
    """
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    # Indexed format iff every line leads with an integer and those
    # integers form one contiguous run -- this keeps plain files whose
    # names merely START with a number ("10 meter platform diving") from
    # being misparsed, and dense line-counting immune to blank lines.
    leads = []
    for line in lines:
        parts = line.split(None, 1)
        if len(parts) == 2 and parts[0].lstrip("-").isdigit():
            leads.append(int(parts[0]))
        else:
            leads = None
            break
    mapping: dict[int, str] = {}
    if leads is not None and lines and sorted(leads) == list(
        range(min(leads), min(leads) + len(leads))
    ):
        for line, idx in zip(lines, leads):
            mapping[idx] = line.split(None, 1)[1].strip().strip("'\"")
    else:
        for i, line in enumerate(lines):
            mapping[i] = line.strip("'\"")
    return mapping


def compute_image_mean(
    records,
    *,
    max_frames_per_video: int = 4,
) -> "np.ndarray":
    """Per-channel BGR mean over a dataset (tools/compute_image_mean.cpp).

    ``records``: iterable of VideoRecord-like (path, num_frames, label).
    Returns float64 (3,) channel means.
    """
    import cv2
    import numpy as np

    total = np.zeros(3, np.float64)
    count = 0
    for rec in records:
        step = max(1, rec.num_frames // max_frames_per_video)
        for f in range(0, rec.num_frames, step):
            img = cv2.imread(os.path.join(rec.path, "img_%04d.jpg" % (f + 1)))
            if img is None:
                continue
            total += img.reshape(-1, 3).mean(axis=0)
            count += 1
    return total / max(count, 1)


def extract_frames(
    video_path: str,
    out_dir: str,
    *,
    fps: int = 25,
    quality: int = 2,
    pattern: str = "img_%04d.jpg",
    ffmpeg: str = "ffmpeg",
) -> int:
    """Decode a video file to JPEG frames; returns the frame count."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [
        ffmpeg, "-y", "-i", video_path, "-qscale:v", str(quality),
        "-r", str(fps), os.path.join(out_dir, pattern),
        "-loglevel", "error",
    ]
    subprocess.run(cmd, check=True)
    return sum(1 for f in os.listdir(out_dir) if f.endswith(".jpg"))


def convert_imageset(
    root_folder: str,
    list_file: str,
    out_h5: str,
    *,
    gray: bool = False,
    shuffle: bool = False,
    resize_height: int = 0,
    resize_width: int = 0,
    seed: int = 0,
) -> int:
    """``convert_imageset`` parity (tools/convert_imageset.cpp), re-targeted
    at HDF5: read ``subfolder/file.JPEG label`` lines, optionally shuffle /
    resize / grayscale, and write one ``.h5`` with Caffe-convention NCHW
    uint8 "data" + int "label" datasets (readable by
    :class:`eco_tpu.data.hdf5.HDF5Source`, which converts to channels-last).

    The reference stores Datum records in LMDB/LevelDB; neither library
    exists in this image and frame-dir/HDF5 are this framework's actual
    data paths, so HDF5 is the native re-interpretation of "a packed
    random-access record store".  FLAGS_check_size is implied (a packed
    array needs uniform shapes).  Returns the number of records written.
    """
    import cv2
    import numpy as np

    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("convert_imageset requires h5py") from e

    pairs = []
    with open(list_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"expected 'path label' line, got {line!r}")
            pairs.append((parts[0], int(parts[1])))
    if shuffle:  # FLAGS_shuffle (:73-78)
        import random

        random.Random(seed).shuffle(pairs)

    # Stream into a resizable dataset: the reference's LMDB writer commits
    # in batches of 1000 (:108-117) precisely so dataset size never has to
    # fit in RAM; mirror that instead of stacking everything first.
    n = 0
    labels: list[int] = []
    first_shape = None
    with h5py.File(out_h5, "w") as f:
        dset = None
        for rel, label in pairs:
            path = os.path.join(root_folder, rel)
            img = _cv2_imread(cv2, path, gray)
            if img is None:
                # ReadImageToDatum logs and skips unreadable files (:90-95)
                continue
            if resize_height > 0 and resize_width > 0:
                img = cv2.resize(img, (resize_width, resize_height),
                                 interpolation=cv2.INTER_LINEAR)
            if img.ndim == 2:
                img = img[:, :, None]
            if first_shape is None:
                first_shape = img.shape
            elif img.shape != first_shape:
                # The reference's LMDB stores variable-size datums and only
                # FLAGS_check_size enforces uniformity; a packed HDF5 array
                # always needs it, so the check is unconditional here.
                raise ValueError(
                    f"{path}: shape {img.shape} != {first_shape}; HDF5 "
                    "needs uniform shapes -- pass resize_height/resize_width"
                )
            chw = np.transpose(img, (2, 0, 1)).astype(np.uint8)  # Caffe CHW
            if dset is None:
                dset = f.create_dataset(
                    "data", shape=(0,) + chw.shape,
                    maxshape=(None,) + chw.shape, dtype=np.uint8,
                    chunks=(1,) + chw.shape, compression="gzip",
                )
            dset.resize(n + 1, axis=0)
            dset[n] = chw
            n += 1
            labels.append(label)
        if n > 0:
            f.create_dataset("label", data=np.asarray(labels, np.int64))
    if n == 0:
        os.remove(out_h5)  # don't leave an empty store behind
        raise ValueError(f"no readable images in {list_file!r}")
    return n


def _cv2_imread(cv2, path, gray):
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    return cv2.imread(path, flag)
