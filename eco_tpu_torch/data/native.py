# A copy of eco_tpu/data/native.py (no framework code); tests/test_torch_data.py holds it to the original.
"""ctypes bindings for the native C++ data plane (native/ecodata.cpp).

``NativeVideoPipeline`` is a drop-in alternative to the Python
``VideoPipeline``: same batch dict contract, but list parsing, segment
sampling, JPEG decode, augmentation, and double-buffered prefetch all run in
C++ worker threads (the reference's VideoDataLayer/DataTransformer/
InternalThread stack was C++, SURVEY.md section 2.2).

The shared library is built on demand with the Makefile in ``native/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libecodata.so"))
_lib = None


def build_native(force: bool = False) -> str:
    """Compile libecodata.so if missing; returns its path."""
    src = os.path.join(_NATIVE_DIR, "ecodata.cpp")
    if force or not os.path.exists(_LIB_PATH) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    ):
        subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR)],
            check=True,
            capture_output=True,
        )
    return _LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.eco_loader_create.restype = ctypes.c_void_p
    lib.eco_loader_create.argtypes = [
        ctypes.c_char_p,  # list_path
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch,S,L,crop
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # threads, train, shuffle
        ctypes.c_uint64,  # seed
        ctypes.c_char_p,  # pattern
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # mean BGR
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        # fix_crop, more_fix_crop, multi_scale, max_distort, mirror
        ctypes.c_int, ctypes.c_int,  # new_height, new_width
        ctypes.c_int, ctypes.c_int,  # rank, world
        ctypes.c_int,  # raw
    ]
    lib.eco_loader_next.restype = ctypes.c_int
    lib.eco_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.eco_loader_next_raw.restype = ctypes.c_int
    lib.eco_loader_next_raw.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.eco_loader_num_videos.restype = ctypes.c_int
    lib.eco_loader_num_videos.argtypes = [ctypes.c_void_p]
    lib.eco_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeVideoPipeline:
    """Same interface as VideoPipeline, backed by libecodata."""

    def __init__(self, cfg, *, train: bool, seed: int = 0, rank: int = 0,
                 world: int = 1, num_workers: int = 8):
        lib = _load()
        t = cfg.transform
        # The C ABI covers the RGB/step-1 path only; refuse configs it
        # cannot honor instead of silently decoding the wrong data.
        if cfg.modality.upper() != "RGB":
            raise NotImplementedError(
                "NativeVideoPipeline supports RGB only; use VideoPipeline "
                "for FLOW"
            )
        if cfg.step != 1 or cfg.rand_step:
            raise NotImplementedError(
                "NativeVideoPipeline does not support step/rand_step; use "
                "VideoPipeline"
            )
        if t.scale != 1.0 or tuple(t.scale_ratios) != (1.0, 0.875, 0.75, 0.66):
            raise NotImplementedError(
                "NativeVideoPipeline supports the default scale/scale_ratios "
                "only; use VideoPipeline"
            )
        if cfg.raw and not (cfg.new_height and cfg.new_width):
            raise ValueError("raw mode needs new_height/new_width (fixed size)")
        # raw + multi_scale: the C++ loader samples (crop_h, crop_w) per
        # video and the device crops + resizes (ops/resize.py)
        self._raw_multi_scale = bool(cfg.raw and train and t.multi_scale)
        self.cfg = cfg
        self._lib = lib
        source = cfg.source
        if cfg.root:
            # the C ABI takes only the list path; resolve root-relative
            # entries into a temp list so paths stay correct
            import tempfile

            from eco_tpu_torch.data.video_list import parse_video_list

            recs = parse_video_list(cfg.source, root=cfg.root)
            tf = tempfile.NamedTemporaryFile(
                "w", suffix=".txt", delete=False, prefix="ecolist"
            )
            for r in recs:
                tf.write(f"{r.path} {r.num_frames} {r.label}\n")
            tf.close()
            source = tf.name
        self._handle = lib.eco_loader_create(
            source.encode(),
            cfg.batch_size, cfg.num_segments, cfg.new_length,
            t.crop_size, num_workers, int(train), int(cfg.shuffle),
            seed, cfg.name_pattern.encode(),
            float(t.mean_values[0]),
            float(t.mean_values[1 % len(t.mean_values)]),
            float(t.mean_values[2 % len(t.mean_values)]),
            int(t.fix_crop), int(t.more_fix_crop), int(t.multi_scale),
            int(t.max_distort), int(t.mirror),
            cfg.new_height, cfg.new_width, rank, world,
            int(cfg.raw),
        )
        if not self._handle:
            raise RuntimeError(f"failed to open video list {cfg.source!r}")
        T = cfg.num_segments * cfg.new_length
        if cfg.raw:
            self._data = np.empty(
                (cfg.batch_size, T, cfg.new_height, cfg.new_width, 3), np.uint8
            )
            self._offs = np.empty((cfg.batch_size, 4), np.int32)
            self._mirror = np.empty((cfg.batch_size,), np.uint8)
        else:
            self._data = np.empty(
                (cfg.batch_size, T, t.crop_size, t.crop_size, 3), np.float32
            )
        self._label = np.empty((cfg.batch_size,), np.int32)

    @property
    def num_videos(self) -> int:
        return self._lib.eco_loader_num_videos(self._handle)

    def next_batch(self):
        if self.cfg.raw:
            rc = self._lib.eco_loader_next_raw(
                self._handle,
                self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._mirror.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._label.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if rc != 0:
                raise RuntimeError("native loader stopped")
            batch = {
                "data": self._data.copy(),
                "h_off": self._offs[:, 0].copy(),
                "w_off": self._offs[:, 1].copy(),
                "mirror": self._mirror.astype(bool),
                "label": self._label.copy(),
            }
            if self._raw_multi_scale:
                batch["crop_h"] = self._offs[:, 2].copy()
                batch["crop_w"] = self._offs[:, 3].copy()
            return batch
        rc = self._lib.eco_loader_next(
            self._handle,
            self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._label.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError("native loader stopped")
        return {"data": self._data.copy(), "label": self._label.copy()}

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        if self._handle:
            self._lib.eco_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
