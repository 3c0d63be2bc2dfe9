# A copy of eco_tpu/data/db.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Classic ``Data``-layer pipeline: LMDB/LevelDB Datum databases feeding
the trainer/test loop (reference ``src/caffe/layers/data_layer.cpp``:
cursor -> DataTransformer -> prefetched top blobs).

``DBDataConfig`` is the parsed ``data_param`` + ``transform_param`` of a
``Data`` layer; ``DBPipeline`` exposes the same ``next_batch()/close()``
surface as :class:`~eco_tpu.data.pipeline.VideoPipeline`, so unmodified
classic-Caffe prototxts (``backend: LMDB`` or ``LEVELDB``) run through
``eco train``/``eco test`` exactly like VideoData graphs.

Transform semantics (data_transformer.cpp classic path): TRAIN = one
random crop + random mirror per sample; TEST = center crop, no mirror;
then mean subtraction and scale.  ``crop_size: 0`` means no crop (e.g.
CIFAR-shaped records).  Output is channels-last float32 ``(N, H, W, C)``
plus int32 labels -- the executor's layout policy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from eco_tpu_torch.data.transform import TransformConfig, transform_stack


@dataclasses.dataclass
class DBDataConfig:
    source: str
    batch_size: int = 8
    backend: Optional[str] = None  # "lmdb" | "leveldb" | None = sniff
    transform: TransformConfig = dataclasses.field(
        default_factory=lambda: TransformConfig(
            crop_size=0, mirror=False, fix_crop=False, more_fix_crop=False,
            multi_scale=False, mean_values=(0.0, 0.0, 0.0),
        )
    )
    raw: bool = False  # classic Data plane has no raw-uint8 mode


class DBPipeline:
    """Streaming batches from a Datum database with Caffe's classic
    transform; rank sharding by cursor offset (base_data_layer.cpp)."""

    def __init__(self, cfg: DBDataConfig, *, train: bool, seed: int = 0,
                 rank: int = 0, world: int = 1):
        from eco_tpu_torch.data.leveldb import LevelDBSource, sniff_backend
        from eco_tpu_torch.data.lmdb import LMDBSource

        self.cfg = cfg
        self.train = train
        self._rng = np.random.default_rng(seed + rank)
        backend = cfg.backend or sniff_backend(cfg.source)
        src_cls = {"lmdb": LMDBSource, "leveldb": LevelDBSource}[
            backend.lower()
        ]
        tc = cfg.transform
        per_sample = None
        if tc.crop_size:
            # The classic DataTransformer order (data_layer.cpp): crop/
            # mirror/mean each datum BEFORE batching, so variable-size
            # record databases stack fine once cropped.  Record dtype
            # passes through untouched -- float_data Datums stay float32
            # (a uint8 cast would wrap negatives), uint8 stays uint8 until
            # transform_stack's float32 output.
            def per_sample(img):
                return transform_stack(
                    img[None], tc, train=self.train, rng=self._rng
                )[0]
        self._it = iter(src_cls(
            cfg.source, batch_size=cfg.batch_size, rank=rank, world=world,
            transform=per_sample,
        ))

    def next_batch(self) -> dict:
        raw = next(self._it)
        tc = self.cfg.transform
        if tc.crop_size:  # per-sample transform already applied in-source
            return {"data": raw["data"], "label": raw["label"]}
        out = raw["data"].astype(np.float32)
        if tc.mirror and self.train:
            flip = self._rng.integers(0, 2, len(out)).astype(bool)
            out[flip] = out[flip, :, ::-1]
        out = (out - np.asarray(tc.mean_values[:out.shape[-1]],
                                np.float32)) * tc.scale
        return {"data": out, "label": raw["label"]}

    def close(self):
        self._it = None
