"""eco_tpu_torch's data planes against eco_tpu's: the copied modules held to
their originals line for line, the samplers and transforms over seeds, the
``VideoPipeline`` (float and raw uint8 batches) on a JPEG frame tree, the
classic databases, the window and segmentation sources and the native loader
on the fixtures of the reference's own tests, and ``prefetch_to_device`` on
the CPU.  Host data is integer or float32 math on the same inputs, so every
comparison is exact."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import eco_tpu.data as jdata
import test_leveldb
import test_lmdb
from eco_tpu.data.db import DBDataConfig as JaxDBDataConfig
from eco_tpu.data.db import DBPipeline as JaxDBPipeline
from eco_tpu.data.hdf5 import HDF5Source as JaxHDF5Source
from eco_tpu.data.hdf5 import save_hdf5
from eco_tpu_torch import data
from eco_tpu_torch.data import (
    DBDataConfig,
    DBPipeline,
    HDF5Source,
    LevelDBSource,
    LMDBSource,
    SegSource,
    TransformConfig,
    VideoDataConfig,
    VideoPipeline,
    WindowSource,
    prefetch_to_device,
)

REPO = Path(__file__).resolve().parent.parent
COPIES = [f"data/{m}.py" for m in ("video_list", "sampler", "reader", "transform", "pipeline",
                                   "window", "seg", "hdf5", "lmdb", "leveldb", "db", "native")]
COPIES.append("convert/caffemodel.py")


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_original_with_its_imports_rewritten(path):
    """A note on the first line, then the reference's text with each
    ``from eco_tpu.`` import now ``from eco_tpu_torch.``."""
    original = (REPO / "eco_tpu" / path).read_text()
    note, copy = (REPO / "eco_tpu_torch" / path).read_text().split("\n", 1)
    assert note.startswith(f"# A copy of eco_tpu/{path} ")
    want = re.sub(r"^(\s*)from eco_tpu\.", r"\1from eco_tpu_torch.", original, flags=re.M)
    assert copy == want
    assert "import jax" not in copy and "from eco_tpu." not in copy


def test_data_package_exports_the_reference_names():
    names = [n for n, v in vars(jdata).items()
             if not n.startswith("_") and not isinstance(v, type(jdata))]
    assert len(names) > 20
    assert not [n for n in names if not hasattr(data, n)]


# --------------------------------------------------------------------------
# samplers and transforms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_samplers_equal_the_reference(seed):
    for n_frames, segments, length, step, rand_step in [
        (40, 4, 1, 1, False), (37, 16, 1, 1, False), (90, 3, 5, 2, True), (6, 16, 2, 1, False),
    ]:
        for train in (True, False):
            kw = dict(train=train, step=step, rand_step=rand_step)
            got = data.sample_offsets(n_frames, segments, length,
                                      rng=np.random.default_rng(seed), **kw)
            want = jdata.sample_offsets(n_frames, segments, length,
                                        rng=np.random.default_rng(seed), **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(data.frame_indices(*got, length, step),
                                          jdata.frame_indices(*want, length, step))
    for windows, total in [(1, 16), (3, 16), (7, 16), (4, 8), (5, 4)]:
        assert data.streaming_allocation(windows, total) == \
            jdata.streaming_allocation(windows, total)
    frames = list(range(16 + seed))
    for count in (1, 2, 4, 8, 16):
        assert data.subsample_window(frames, count) == jdata.subsample_window(frames, count)


@pytest.mark.parametrize("multi_scale,fix_crop,is_flow", [
    (True, True, False), (False, False, False), (False, True, True)])
@pytest.mark.parametrize("train", [True, False])
def test_transform_stack_equals_the_reference(multi_scale, fix_crop, is_flow, train):
    rng = np.random.default_rng(7)
    channels = 2 if is_flow else 3
    stack = rng.integers(0, 256, (4, 40, 52, channels), dtype=np.uint8)
    kw = dict(crop_size=32, multi_scale=multi_scale, fix_crop=fix_crop, is_flow=is_flow,
              mean_values=(128.0,) if is_flow else (104.0, 117.0, 123.0), scale=0.5)
    for seed in range(5):
        got = data.transform_stack(stack, TransformConfig(**kw), train=train,
                                   rng=np.random.default_rng(seed))
        want = jdata.transform_stack(stack, jdata.TransformConfig(**kw), train=train,
                                     rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    assert data.fill_crop_sizes(256, 340, 224, 224, 1, (1.0, 0.875, 0.75, 0.66)) == \
        jdata.fill_crop_sizes(256, 340, 224, 224, 1, (1.0, 0.875, 0.75, 0.66))


# --------------------------------------------------------------------------
# the video pipeline
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def video_list(tmp_path_factory):
    """6 videos of 12 noisy 64x80 JPEG frames, one unreadable, labels 0-2."""
    root = tmp_path_factory.mktemp("torch_videos")
    rng = np.random.default_rng(0)
    lines = []
    for v in range(6):
        d = root / f"vid{v}"
        d.mkdir()
        for f in range(12):
            img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
            cv2.imwrite(str(d / ("img_%04d.jpg" % (f + 1))), img)
        lines.append(f"{d} 12 {v % 3}")
    lines.append(f"{root / 'missing'} 12 1")
    lst = root / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


def _video_cfgs(lst, raw):
    kw = dict(source=lst, batch_size=3, num_segments=4, shuffle=True, raw=raw,
              new_height=64 if raw else 0, new_width=80 if raw else 0)
    tkw = dict(crop_size=48, multi_scale=not raw)
    return (VideoDataConfig(**kw, transform=TransformConfig(**tkw)),
            jdata.VideoDataConfig(**kw, transform=jdata.TransformConfig(**tkw)))


@pytest.mark.parametrize("raw", [False, True], ids=["float", "raw"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_video_pipeline_batches_equal_the_reference(video_list, raw, train):
    """Shuffle, skipped unreadable videos, rank sharding and the augment
    draws: four batches bit for bit, float clips or uint8 frames with their
    offsets and mirrors."""
    cfg, jcfg = _video_cfgs(video_list, raw)
    pipes = [VideoPipeline(cfg, train=train, seed=3, rank=1, world=2, num_workers=2),
             jdata.VideoPipeline(jcfg, train=train, seed=3, rank=1, world=2, num_workers=2)]
    try:
        for _ in range(4):
            got, want = (p.next_batch() for p in pipes)
            assert got.keys() == want.keys()
            assert set(got) == ({"data", "label", "h_off", "w_off", "mirror"} if raw
                                else {"data", "label"})
            assert got["data"].dtype == (np.uint8 if raw else np.float32)
            for k in got:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        for p in pipes:
            p.close()


def test_native_pipeline_equals_the_reference(video_list):
    """libecodata (native/) loaded by path from either package: the same
    batches; skipped, as tests/test_native_data.py is, without a toolchain."""
    from eco_tpu.data.native import NativeVideoPipeline as JaxNative
    from eco_tpu_torch.data.native import NativeVideoPipeline, build_native

    try:
        build_native()
    except Exception as e:  # noqa: BLE001 (the toolchain is optional)
        pytest.skip(f"native toolchain unavailable: {e}")
    lst = str(Path(video_list).with_name("native_list.txt"))
    Path(lst).write_text("".join(l + "\n" for l in Path(video_list).read_text().split("\n")
                                 if l and "missing" not in l))
    for raw in (False, True):
        cfg, jcfg = _video_cfgs(lst, raw)
        cfg = dataclasses.replace(cfg, transform=dataclasses.replace(cfg.transform,
                                                                     multi_scale=False))
        jcfg = dataclasses.replace(jcfg, transform=dataclasses.replace(jcfg.transform,
                                                                       multi_scale=False))
        pipes = [NativeVideoPipeline(cfg, train=True, seed=1), JaxNative(jcfg, train=True, seed=1)]
        try:
            for _ in range(2):
                got, want = (p.next_batch() for p in pipes)
                assert got.keys() == want.keys()
                for k in got:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        finally:
            for p in pipes:
                p.close()


# --------------------------------------------------------------------------
# classic databases, window and segmentation sources
# --------------------------------------------------------------------------


def _assert_batches_equal(got_it, want_it, n):
    for _ in range(n):
        got, want = next(got_it), next(want_it)
        if isinstance(got, dict):
            assert got.keys() == want.keys()
            got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def test_lmdb_source_equals_the_reference(tmp_path):
    datums = [test_lmdb._datum_bytes(3, 5 + i, 6, bytes((i * 7 + j) % 256 for j in
                                                        range(3 * (5 + i) * 6)), i)
              for i in range(3)]
    datums += [test_lmdb._float_datum_bytes(3, 4, 4, np.arange(48, dtype=np.float32) / 7, 9)]
    path = test_lmdb._mixed_size_lmdb(tmp_path, datums[3:] * 5)
    from eco_tpu.data.lmdb import LMDBSource as JaxLMDBSource

    for kw in (dict(batch_size=2), dict(batch_size=2, rank=1, world=2)):
        _assert_batches_equal(iter(LMDBSource(path, **kw)), iter(JaxLMDBSource(path, **kw)), 4)
    from eco_tpu_torch.data import parse_datum

    for d in datums:
        got, want = parse_datum(d), jdata.parse_datum(d)
        assert (got.channels, got.height, got.width, got.label) == \
            (want.channels, want.height, want.width, want.label)
        np.testing.assert_array_equal(got.array(), want.array())


def test_leveldb_source_and_db_pipeline_equal_the_reference(tmp_path):
    path = test_leveldb._datum_db(tmp_path)
    for kw in (dict(batch_size=4), dict(batch_size=3, rank=1, world=2)):
        _assert_batches_equal(iter(LevelDBSource(path, **kw)),
                              iter(jdata.LevelDBSource(path, **kw)), 5)
    tkw = dict(crop_size=8, mirror=True, fix_crop=False, more_fix_crop=False,
               multi_scale=False, mean_values=(104.0, 117.0, 123.0), scale=0.5)
    for train in (True, False):
        got = DBPipeline(DBDataConfig(source=path, batch_size=4,
                                      transform=TransformConfig(**tkw)), train=train, seed=2)
        want = JaxDBPipeline(JaxDBDataConfig(source=path, batch_size=4,
                                             transform=jdata.TransformConfig(**tkw)),
                             train=train, seed=2)
        _assert_batches_equal(iter(got.next_batch, None), iter(want.next_batch, None), 4)


def test_hdf5_source_equals_the_reference(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"part{i}.h5")
        save_hdf5(p, {"data": rng.standard_normal((5, 3, 6, 6)).astype(np.float32),
                      "label": np.arange(5, dtype=np.float32) + i * 5})
        paths.append(p)
    listing = tmp_path / "files.txt"
    listing.write_text("\n".join(paths) + "\n")
    for src, kw in ((str(listing), dict(batch_size=4)),
                    (paths[0], dict(batch_size=3, shuffle=True, seed=1))):
        got, want = HDF5Source(src, **kw), JaxHDF5Source(src, **kw)
        _assert_batches_equal(iter(got.next_batch, None), iter(want.next_batch, None), 4)


def test_window_and_seg_sources_equal_the_reference(tmp_path):
    from eco_tpu.data.seg import SegSource as JaxSegSource
    from eco_tpu.data.window import WindowSource as JaxWindowSource

    rng = np.random.default_rng(0)
    img = tmp_path / "img.png"
    cv2.imwrite(str(img), rng.integers(0, 255, (32, 48, 3), np.uint8))
    lines = ["# 0", str(img), "3", "32", "48", "4", "3 0.9 0 0 9 9", "5 0.8 10 10 29 25",
             "0 0.1 4 4 19 19", "0 0.2 20 2 43 17"]
    windows = tmp_path / "windows.txt"
    windows.write_text("\n".join(lines) + "\n")
    kw = dict(batch_size=8, crop_size=12, fg_fraction=0.25, mirror=True, seed=1,
              context_pad=2)
    _assert_batches_equal(iter(WindowSource(str(windows), **kw).next_batch, None),
                          iter(JaxWindowSource(str(windows), **kw).next_batch, None), 3)

    pairs = []
    for i in range(2):
        ip, lp = tmp_path / f"i{i}.png", tmp_path / f"l{i}.png"
        cv2.imwrite(str(ip), rng.integers(0, 255, (24, 30, 3), np.uint8))
        cv2.imwrite(str(lp), (rng.integers(0, 2, (24, 30), np.uint8) * 7).astype(np.uint8))
        pairs.append(f"i{i}.png l{i}.png")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(pairs) + "\n")
    kw = dict(root_dir=str(tmp_path), stride=8, mean_values=[104, 117, 123], balance=True,
              mirror=True, scale_ratios=[0.5, 1.5], seed=4)
    _assert_batches_equal(iter(SegSource(str(lst), **kw).next_sample, None),
                          iter(JaxSegSource(str(lst), **kw).next_sample, None), 4)


# --------------------------------------------------------------------------
# prefetch_to_device on the CPU
# --------------------------------------------------------------------------


def _host_batches(n):
    return ({"i": np.int32(i), "x": np.full((2, 3), i, np.float32),
             "nested": [np.arange(i, i + 2), (np.bool_(i % 2),)], "none": None}
            for i in range(n))


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_order_and_depth_and_drains(size):
    seen = []

    def source(n):
        for b in _host_batches(n):
            seen.append(int(b["i"]))
            yield b

    it = prefetch_to_device(source(4), size, device="cpu")
    first = next(it)
    # the batch handed out, and ``size`` more already put
    assert seen == list(range(min(4, size + 1)))
    got = [first] + list(it)
    assert [int(b["i"]) for b in got] == [0, 1, 2, 3]
    for i, b in enumerate(got):
        # leaves keep their shapes (a 0-d leaf stays 0-d) and None passes
        # through, as under the reference's jax.device_put
        assert b["i"].shape == () and b["i"].dtype == torch.int32 and b["none"] is None
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert torch.equal(b["nested"][0], torch.arange(i, i + 2))
        assert isinstance(b["nested"][1], tuple) and bool(b["nested"][1][0]) == bool(i % 2)
    assert list(prefetch_to_device(iter([]), size, device="cpu")) == []


def test_prefetch_put_fn_replaces_the_put_and_size_zero_raises():
    puts = []

    def put_fn(b):
        puts.append(int(b["i"]))
        return ("put", int(b["i"]))

    it = prefetch_to_device(_host_batches(5), size=2, put_fn=put_fn)
    assert next(it) == ("put", 0)
    assert puts == [0, 1, 2]
    assert list(it) == [("put", i) for i in range(1, 5)]
    with pytest.raises(ValueError, match="size"):
        next(prefetch_to_device(iter([]), size=0))
    # the reference's contract, on the same source
    ref = jdata.prefetch_to_device(_host_batches(5), size=2, put_fn=lambda b: int(b["i"]))
    assert list(ref) == [int(b[1]) for b in
                         prefetch_to_device(_host_batches(5), size=2, put_fn=put_fn)]
