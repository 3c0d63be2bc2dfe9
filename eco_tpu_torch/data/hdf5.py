# A copy of eco_tpu/data/hdf5.py (no framework code); tests/test_torch_data.py holds it to the original.
"""HDF5 data source -- HDF5DataLayer parity (hdf5_data_layer.cpp).

Caffe's HDF5Data reads a text file listing ``.h5`` files, each holding
equal-length datasets (canonically "data" and "label"), and cycles through
them emitting fixed-size batches with optional shuffling.  Channels-last
conversion is applied to rank>=4 "data" arrays (Caffe HDF5 blobs are NCHW).

HDF5 *output* (the reference's HDF5Output layer) is :func:`save_hdf5`.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def _to_channels_last(arr: np.ndarray) -> np.ndarray:
    if arr.ndim >= 4:
        return np.moveaxis(arr, 1, -1)
    return arr


class HDF5Source:
    def __init__(
        self,
        source: str | Sequence[str],
        *,
        batch_size: int,
        keys: Sequence[str] = ("data", "label"),
        shuffle: bool = False,
        seed: int = 0,
        channels_last: bool = True,
    ):
        if h5py is None:
            raise ImportError("h5py is required for HDF5Source")
        if isinstance(source, str):
            if source.endswith((".h5", ".hdf5")):
                self.files = [source]
            else:
                self.files = [l.strip() for l in open(source) if l.strip()]
        else:
            self.files = list(source)
        self.batch_size = batch_size
        self.keys = tuple(keys)
        self.shuffle = shuffle
        self.channels_last = channels_last
        self._rng = np.random.default_rng(seed)
        self._file_idx = 0
        self._row = 0
        self._load(0)

    def _load(self, idx: int):
        with h5py.File(self.files[idx], "r") as f:
            self._arrays = {k: np.asarray(f[k]) for k in self.keys}
        n = len(next(iter(self._arrays.values())))
        if n == 0:
            raise ValueError(f"{self.files[idx]}: empty datasets")
        for k, v in self._arrays.items():
            if len(v) != n:
                raise ValueError(f"dataset {k!r} length {len(v)} != {n}")
        self._order = (
            self._rng.permutation(n) if self.shuffle else np.arange(n)
        )
        self._row = 0
        self._file_idx = idx

    def next_batch(self) -> dict[str, np.ndarray]:
        out = {k: [] for k in self.keys}
        need = self.batch_size
        while need:
            n = len(self._order)
            take = min(need, n - self._row)
            sel = self._order[self._row:self._row + take]
            for k in self.keys:
                out[k].append(self._arrays[k][sel])
            self._row += take
            need -= take
            if self._row >= n:
                self._load((self._file_idx + 1) % len(self.files))
        batch = {k: np.concatenate(v) for k, v in out.items()}
        if self.channels_last and "data" in batch:
            batch["data"] = np.ascontiguousarray(
                _to_channels_last(batch["data"])
            )
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def save_hdf5(path: str, arrays: dict, *, channels_first: bool = True) -> None:
    """HDF5Output parity: write named arrays (NCHW by default, like Caffe)."""
    if h5py is None:
        raise ImportError("h5py is required for save_hdf5")
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            v = np.asarray(v)
            if channels_first and v.ndim >= 4:
                v = np.moveaxis(v, -1, 1)
            f.create_dataset(k, data=v)
