# A copy of eco_tpu/data/pipeline.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Prefetching video batch pipeline -- BasePrefetchingDataLayer parity.

The reference runs one InternalThread per data layer assembling the next
batch while the net computes, and shards data across MPI ranks by cursor
offset: start at ``rank*batch``, advance ``(world-1)*batch`` after each batch
(base_data_layer.cpp:42-45,83-86).  Here a worker pool decodes videos in
parallel (cv2 releases the GIL) and a depth-2 queue double-buffers batches;
the same cursor arithmetic shards across hosts.

Emits {"data": (N, S*L, crop, crop, C) float32, "label": (N,) int32} numpy
batches ready for device_put (channels-last, BGR, mean-subtracted).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np

from eco_tpu_torch.data.reader import read_segment_flow, read_segment_rgb
from eco_tpu_torch.data.sampler import frame_indices, sample_offsets
from eco_tpu_torch.data.transform import TransformConfig, transform_stack
from eco_tpu_torch.data.video_list import VideoRecord, parse_video_list


@dataclass
class VideoDataConfig:
    """video_data_param mirror (caffe.proto VideoDataParameter subset)."""

    source: str = ""
    batch_size: int = 16
    new_length: int = 1
    num_segments: int = 16
    modality: str = "RGB"  # RGB | FLOW
    shuffle: bool = False
    name_pattern: str = "img_%04d.jpg"
    new_height: int = 0
    new_width: int = 0
    step: int = 1
    rand_step: bool = False
    root: Optional[str] = None
    transform: TransformConfig = field(default_factory=TransformConfig)
    # raw mode: emit resized uint8 frames + per-video augment decisions and
    # let the device do crop/mirror/mean (eco_tpu.ops.pallas.preprocess /
    # apps.serving.UInt8Server).  Requires new_height/new_width; only the
    # fixed-crop-grid augmentation path is available on-device.
    raw: bool = False


class VideoPipeline:
    def __init__(
        self,
        cfg: VideoDataConfig,
        *,
        train: bool,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        num_workers: int = 8,
        records: Optional[Sequence[VideoRecord]] = None,
        prefetch_depth: int = 2,
    ):
        self.cfg = cfg
        self.train = train
        self.rank, self.world = rank, world
        self.records = list(
            records if records is not None else parse_video_list(cfg.source, root=cfg.root)
        )
        if not self.records:
            raise ValueError("empty video list")
        if cfg.raw and not (cfg.new_height and cfg.new_width):
            raise ValueError("raw mode needs new_height/new_width (fixed size)")
        # raw + multi_scale: the host samples (crop_h, crop_w) per video and
        # the device crops + bilinearly resizes inside the jitted step
        # (ops/resize.py); batches then carry crop_h/crop_w columns.
        self._raw_multi_scale = bool(
            cfg.raw and train and cfg.transform.multi_scale
        )
        # twin-seeded RNGs like the reference (video_data_layer.cpp:126-131)
        self._shuffle_rng = np.random.default_rng(seed)
        self._frame_rng = np.random.default_rng(seed + 1)
        if cfg.shuffle:
            self._shuffle()
        # MPI-style cursor sharding
        self._cursor = rank * cfg.batch_size
        self._error: Optional[Exception] = None
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- internals -----------------------------------------------------------

    def _shuffle(self):
        perm = self._shuffle_rng.permutation(len(self.records))
        self.records = [self.records[i] for i in perm]

    def _advance(self, n):
        self._cursor += n
        while self._cursor >= len(self.records):
            self._cursor -= len(self.records)
            if self.cfg.shuffle:
                self._shuffle()

    def _load_one(self, rec: VideoRecord, rng: np.random.Generator):
        cfg = self.cfg
        offsets, skips = sample_offsets(
            rec.num_frames, cfg.num_segments, cfg.new_length,
            train=self.train, rng=rng, step=cfg.step, rand_step=cfg.rand_step,
        )
        idx = frame_indices(offsets, skips, cfg.new_length, cfg.step)
        idx = np.minimum(idx, rec.num_frames - 1)
        if cfg.modality.upper() == "FLOW":
            stack = read_segment_flow(
                rec.path, idx, name_pattern=cfg.name_pattern,
                new_height=cfg.new_height, new_width=cfg.new_width,
            )
        else:
            stack = read_segment_rgb(
                rec.path, idx, name_pattern=cfg.name_pattern,
                new_height=cfg.new_height, new_width=cfg.new_width,
            )
        if cfg.raw:
            # sample the augment decision on host, apply it on device
            t = cfg.transform
            h, w = stack.shape[1:3]
            cs = t.crop_size
            crop_h = crop_w = cs
            if self.train:
                if self._raw_multi_scale:
                    from eco_tpu_torch.data.transform import fill_crop_sizes

                    sizes = fill_crop_sizes(h, w, cs, cs, t.max_distort,
                                            t.scale_ratios)
                    crop_h, crop_w = sizes[rng.integers(0, len(sizes))]
                if t.fix_crop:
                    from eco_tpu_torch.data.transform import fill_fix_offsets

                    offs = fill_fix_offsets(h, w, crop_h, crop_w,
                                            t.more_fix_crop)
                    h_off, w_off = offs[rng.integers(0, len(offs))]
                else:  # uniform random offsets, matching transform_stack
                    h_off = int(rng.integers(0, h - crop_h + 1))
                    w_off = int(rng.integers(0, w - crop_w + 1))
                mirror = bool(t.mirror and rng.integers(0, 2))
            else:
                h_off, w_off = (h - cs) // 2, (w - cs) // 2
                mirror = False
            return (stack, np.int32(h_off), np.int32(w_off), mirror,
                    np.int32(crop_h), np.int32(crop_w))
        return transform_stack(stack, cfg.transform, train=self.train, rng=rng)

    def _make_batch(self):
        """Assemble one batch, SKIPPING unreadable videos like the reference
        (video_data_layer.cpp:195-216) so data and labels always correspond."""
        cfg = self.cfg
        arrs, labels = [], []
        attempts = 0
        max_attempts = cfg.batch_size + len(self.records)
        while len(arrs) < cfg.batch_size and attempts < max_attempts:
            # submit a wave of candidates to keep workers busy
            need = cfg.batch_size - len(arrs)
            wave = []
            for _ in range(need):
                rec = self.records[self._cursor % len(self.records)]
                self._advance(1)
                rng = np.random.default_rng(self._frame_rng.integers(0, 2**63))
                wave.append((rec, self._pool.submit(self._load_one, rec, rng)))
                attempts += 1
            for rec, fut in wave:
                try:
                    arrs.append(fut.result())
                    labels.append(rec.label)
                except Exception:
                    continue  # skip the video, keep data/label aligned
        if len(arrs) < cfg.batch_size:
            raise RuntimeError(
                f"could not assemble a batch of {cfg.batch_size}: too many "
                f"unreadable videos in {cfg.source!r}"
            )
        # per-batch cursor skip for the other ranks
        self._advance((self.world - 1) * cfg.batch_size)
        if cfg.raw:
            stacks, h_off, w_off, mirror, crop_h, crop_w = zip(*arrs)
            batch = {
                "data": np.stack(stacks),  # uint8 (N, S*L, H, W, C)
                "h_off": np.asarray(h_off, np.int32),
                "w_off": np.asarray(w_off, np.int32),
                "mirror": np.asarray(mirror, bool),
                "label": np.asarray(labels, np.int32),
            }
            if self._raw_multi_scale:
                batch["crop_h"] = np.asarray(crop_h, np.int32)
                batch["crop_w"] = np.asarray(crop_w, np.int32)
            return batch
        return {
            "data": np.stack(arrs),
            "label": np.asarray(labels, np.int32),
        }

    def _producer(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except Exception as e:  # surface ANY failure to the consumer
                # (a silently dead producer would deadlock next_batch)
                self._error = e
                while not self._stop.is_set():
                    try:
                        self._queue.put(e, timeout=0.25)  # wake the consumer
                        break
                    except queue.Full:
                        continue
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    # -- public ---------------------------------------------------------------

    def next_batch(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def __iter__(self) -> Iterator:
        while True:
            yield self.next_batch()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)
