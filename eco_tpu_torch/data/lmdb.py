# A copy of eco_tpu/data/lmdb.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Pure-Python read-only LMDB cursor + Datum decoding -- the classic
``Data`` layer's backend (reference ``src/caffe/layers/data_layer.cpp`` +
``util/db_lmdb.cpp``), re-implemented without the lmdb C library (absent
from this image; VERDICT r3 missing #2).

Scope: read-only, single main database, no nested/dupsort DBs -- exactly
what ``convert_imageset``-style Caffe datasets use (sequential keys
``"%08d_..."`` mapped to serialized ``Datum`` protos).  The on-disk format
is LMDB 0.9's B+-tree (little-endian):

- pages 0/1 are meta pages; the live one has the larger ``mm_txnid``;
- the page size lives in ``mm_dbs[FREE].md_pad`` (lmdb.h's ``mm_psize``
  alias); the main DB root/entry count in ``mm_dbs[MAIN]``;
- a page = 16-byte header ``{pgno u64, pad u16, flags u16, lower u16,
  upper u16}`` + a ``u16`` node-offset array growing up from byte 16;
- a node = ``{lo u16, hi u16, flags u16, ksize u16, key..[, data..]}``;
  branch nodes pack a 48-bit child pgno into lo|hi<<16|flags<<32, leaf
  nodes a data size into lo|hi<<16; leaf flag 0x01 (BIGDATA) means the
  value lives on ``ceil(size/psize)`` contiguous overflow pages whose
  first pgno follows the key as a u64.

``Datum`` wire fields (caffe.proto): channels=1 height=2 width=3
data=4(bytes) label=5 float_data=6 encoded=7.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_P_LEAF2 = 0x20
_F_BIGDATA = 0x01
_MAGIC = 0xBEEFC0DE
_PAGEHDRSZ = 16


@dataclass
class Datum:
    """caffe.proto Datum subset (the Data layer's record type)."""

    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int = 0
    float_data: tuple = ()
    encoded: bool = False

    def array(self) -> np.ndarray:
        """Decode to a channels-last uint8/float32 HWC array (io.cpp's
        Datum->cv::Mat convention: stored CHW, BGR)."""
        if self.encoded:
            import cv2

            img = cv2.imdecode(
                np.frombuffer(self.data, np.uint8), cv2.IMREAD_COLOR
            )
            if img is None:
                raise ValueError("undecodable encoded Datum")
            return img
        if self.data:
            chw = np.frombuffer(self.data, np.uint8).reshape(
                self.channels, self.height, self.width
            )
            return np.transpose(chw, (1, 2, 0))
        chw = np.asarray(self.float_data, np.float32).reshape(
            self.channels, self.height, self.width
        )
        return np.transpose(chw, (1, 2, 0))


def parse_datum(buf) -> Datum:
    from eco_tpu_torch.convert.caffemodel import _fields

    d = Datum()
    floats: list[float] = []
    for field, wt, val in _fields(memoryview(bytes(buf))):
        if field == 1:
            d.channels = int(val)
        elif field == 2:
            d.height = int(val)
        elif field == 3:
            d.width = int(val)
        elif field == 4:
            d.data = bytes(val)
        elif field == 5:
            d.label = int(val)
        elif field == 6:
            if wt == 2:  # packed repeated float
                floats.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val))
                )
            else:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif field == 7:
            d.encoded = bool(val)
    d.float_data = tuple(floats)
    return d


class LMDBReader:
    """Read-only cursor over an LMDB environment's main database.

    ``path`` may be the environment directory (containing ``data.mdb``,
    the reference convention) or the data file itself.
    """

    def __init__(self, path: str):
        import os

        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._map = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = max(
            (self._meta(0), self._meta(1)), key=lambda m: m["txnid"]
        )
        self.psize = meta["psize"]
        self.entries = meta["entries"]
        self._root = meta["root"]

    # -- format internals --------------------------------------------------

    def _meta(self, pgno: int) -> dict:
        # meta pages use the default 4096 layout only to FIND psize; the
        # header offset of the meta struct is fixed at PAGEHDRSZ
        off = pgno * 4096 + _PAGEHDRSZ
        magic, version = struct.unpack_from("<II", self._map, off)
        if magic != _MAGIC:
            raise ValueError(
                f"not an LMDB data file (meta magic {magic:#x})"
            )
        # MDB_meta: magic,version,address,mapsize, dbs[2], last_pg, txnid
        free_db = struct.unpack_from("<IHHQQQQQ", self._map, off + 24)
        main_db = struct.unpack_from("<IHHQQQQQ", self._map, off + 24 + 48)
        last_pg, txnid = struct.unpack_from(
            "<QQ", self._map, off + 24 + 96
        )
        return {
            "psize": free_db[0] or 4096,  # mm_psize aliases free.md_pad
            "entries": main_db[6],
            "root": main_db[7],
            "txnid": txnid,
        }

    def _page(self, pgno: int) -> tuple[int, int, int, int]:
        """-> (byte offset, flags, lower, upper)."""
        off = pgno * self.psize
        flags, lower, upper = struct.unpack_from(
            "<HHH", self._map, off + 10
        )
        return off, flags, lower, upper

    def _nodes(self, pgno: int):
        off, flags, lower, _ = self._page(pgno)
        n = (lower - _PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{n}H", self._map, off + _PAGEHDRSZ)
        return off, flags, ptrs

    def _leaf_item(self, page_off: int, node_off: int) -> tuple[bytes, bytes]:
        lo, hi, nflags, ksize = struct.unpack_from(
            "<HHHH", self._map, page_off + node_off
        )
        kstart = page_off + node_off + 8
        key = self._map[kstart:kstart + ksize]
        dsize = lo | (hi << 16)
        if nflags & _F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from(
                "<Q", self._map, kstart + ksize
            )
            dstart = ovf_pgno * self.psize + _PAGEHDRSZ
            return key, self._map[dstart:dstart + dsize]
        dstart = kstart + ksize
        return key, self._map[dstart:dstart + dsize]

    def _walk(self, pgno: int) -> Iterator[tuple[bytes, bytes]]:
        off, flags, ptrs = self._nodes(pgno)
        if flags & _P_LEAF:
            if flags & _P_LEAF2:
                raise ValueError("LEAF2 (fixed-size dupsort) unsupported")
            for p in ptrs:
                yield self._leaf_item(off, p)
        elif flags & _P_BRANCH:
            for p in ptrs:
                lo, hi, nflags, _ = struct.unpack_from(
                    "<HHHH", self._map, off + p
                )
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        else:
            raise ValueError(f"unexpected page flags {flags:#x} @ {pgno}")

    # -- public ------------------------------------------------------------

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """(key, value) pairs in key order (the LMDB cursor order the
        reference Data layer iterates in, db_lmdb.cpp Next())."""
        if self._root == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty db
            return
        yield from self._walk(self._root)

    def __len__(self) -> int:
        return self.entries

    def datums(self) -> Iterator[Datum]:
        for _, v in self.items():
            yield parse_datum(v)

    def close(self):
        self._map.close()
        self._f.close()


class DatumBatchSource:
    """Shared cursor->batch plane for the classic ``Data`` layer backends
    (data_layer.cpp): endless key-order value stream with wrap-around (the
    cursor's MDB_FIRST/SeekToFirst reset), rank sharding by cursor offset
    (base_data_layer.cpp), O(batch) memory.  Only the records a batch
    consumes are decoded; records skipped by the rank stride advance the
    cursor without parsing.  Subclasses supply ``reader`` (anything whose
    ``.items()`` yields (key, value) in cursor order) and may override
    ``_epoch_end`` (called after each complete pass).

    ``transform``: optional per-sample ``(H, W, C) array -> array`` applied
    BEFORE batch stacking -- the reference's DataTransformer order
    (data_layer.cpp transforms each datum into the batch blob), which is
    what makes variable-size record databases work: a crop unifies shapes.
    Without it, a mixed-shape batch raises with a pointer at ``crop_size``.
    Emits {"data": (N, H, W, C), "label": (N,) int32} channels-last
    batches; dtype follows the records (uint8, or float32 for
    ``float_data`` Datums) and the transform.
    """

    def __init__(self, reader, *, batch_size: int, rank: int = 0,
                 world: int = 1, transform=None):
        self.reader = reader
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.transform = transform

    def _values(self) -> Iterator[bytes]:
        """Endless raw Datum-value stream in cursor order, rewinding at the
        end of the database."""
        while True:
            n = 0
            for _, v in self.reader.items():
                yield v
                n += 1
            if n == 0:
                raise ValueError("empty database")
            self._epoch_end()

    def _epoch_end(self):
        """Hook after each full pass (e.g. drop CRC re-verification)."""

    def __iter__(self):
        vals = self._values()
        for _ in range(self.rank * self.batch_size):
            next(vals)  # other ranks' records: advance, don't decode
        while True:
            imgs, labels = [], []
            for _ in range(self.batch_size):
                d = parse_datum(next(vals))
                arr = d.array()
                if self.transform is not None:
                    arr = self.transform(arr)
                imgs.append(arr)
                labels.append(d.label)
            for _ in range((self.world - 1) * self.batch_size):
                next(vals)
            if len({a.shape for a in imgs}) > 1:
                raise ValueError(
                    "variable-size Datum records in one batch; set "
                    "transform_param.crop_size so the per-sample crop "
                    "unifies shapes before stacking (data_transformer.cpp)"
                )
            yield {
                "data": np.stack(imgs),
                "label": np.asarray(labels, np.int32),
            }


class LMDBSource(DatumBatchSource):
    """``Data``-layer batches from an LMDB Datum database.

    STREAMING (round 5): the reference iterates a bounded-memory LMDB
    cursor precisely because these datasets exceed host RAM (db_lmdb.cpp
    Next()); this source mirrors that via :class:`DatumBatchSource` --
    wrap-around rewinds the B+-tree walk instead of caching the decoded
    dataset, and the mmap behind the walk is file-backed page cache the
    OS can evict.
    """

    def __init__(self, path: str, *, batch_size: int, rank: int = 0,
                 world: int = 1, transform=None):
        super().__init__(
            LMDBReader(path), batch_size=batch_size, rank=rank,
            world=world, transform=transform,
        )
