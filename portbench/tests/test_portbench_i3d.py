"""I3D-RGB's files: its counts against a sum worked by hand, its reference
against the copy the program's tests use (``tests/reference_i3d.py``), the
pool reader on hand-made readings, and a whole run of its cell on the CPU
at a small size, float32, which has to come out correct.
"""

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import harness, weights
from portbench.tests.test_portbench_reference import small_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "i3d_batch8"


def _tests_reference():
    spec = importlib.util.spec_from_file_location("tests_reference_i3d",
                                                  ROOT / "tests" / "reference_i3d.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# i3d.py's convs at 64 x 224 x 224 by hand: (outputs T*H*W, C_out, C_in, taps)
STEM_AND_2 = [(32 * 112 * 112, 64, 3, 343), (32 * 56 * 56, 64, 64, 1),
              (32 * 56 * 56, 192, 64, 27)]
# Mixed modules: (T*H*W, C_in, (b0, b1a, b1b, b2a, b2b, b3))
MIXED = [(32 * 28 * 28, 192, (64, 96, 128, 16, 32, 32)),
         (32 * 28 * 28, 256, (128, 128, 192, 32, 96, 64)),
         (16 * 14 * 14, 480, (192, 96, 208, 16, 48, 64)),
         (16 * 14 * 14, 512, (160, 112, 224, 24, 64, 64)),
         (16 * 14 * 14, 512, (128, 128, 256, 24, 64, 64)),
         (16 * 14 * 14, 512, (112, 144, 288, 32, 64, 64)),
         (16 * 14 * 14, 528, (256, 160, 320, 32, 128, 128)),
         (8 * 7 * 7, 832, (256, 160, 320, 32, 128, 128)),
         (8 * 7 * 7, 832, (384, 192, 384, 48, 128, 128))]


def test_counts_by_hand():
    macs = sum(n * cout * cin * taps for n, cout, cin, taps in STEM_AND_2)
    for n, cin, (b0, b1a, b1b, b2a, b2b, b3) in MIXED:
        macs += n * cin * (b0 + b1a + b2a + b3) + n * 27 * (b1a * b1b + b2a * b2b)
    macs += 7 * 1024 * 400  # the logits conv over the 7 pooled steps
    cell = small_cell(CELL)
    cfg = {**cell.config, "num_segments": 64, "crop_size": 224}
    flops = cell.counts.forward_flops(cell.counts.net(cfg), cfg)
    assert flops == 2.0 * macs
    assert macs / 1e9 == pytest.approx(111.153143808, rel=1e-12)
    assert cell.counts.k1_bytes(8, cfg, 2) == 8 * 64 * 224 * 224 * 3 * 3


def test_reference_is_the_tests_copy():
    theirs = _tests_reference()
    cell = small_cell(CELL)
    mine = cell.reference
    cfg = {**cell.config, "num_segments": 16, "crop_size": 224}
    net = mine.net(cfg)
    layer = lambda l: (l.name, l.op, l.bottoms, l.top, l.attrs)  # noqa: E731
    assert [layer(l) for l in net] == [layer(l) for l in theirs.net(cfg)]
    ps, ss = mine.param_specs(net, cfg)
    tps, tss = theirs.param_specs(theirs.net(cfg), cfg)
    fields = lambda s: (s.layer, s.name, s.shape, s.low, s.high, s.laplace)  # noqa: E731
    assert [fields(s) for s in ps + ss] == [fields(s) for s in tps + tss]
    params, state = weights.make(ps, ss, 2**33 + 1, "cpu")
    frames = torch.randint(0, 256, (1, 16, 230, 236, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    args = (frames, [3], [9], [1])
    clips = mine.clips(cfg, *args)
    assert torch.equal(clips, theirs.clips(cfg, *args))
    assert clips.shape == (1, 3, 16, 224, 224) and clips.abs().max() <= 1.0
    with torch.no_grad():
        assert torch.equal(mine.forward(net, params, state, clips),
                           theirs.forward(net, params, state, clips))


def test_pool_reader_by_hand():
    read = small_cell(CELL).readers["pool_roofline.batch"].read
    peaks = {"hbm_bytes_per_s": 3.35e12}
    row = {"calls": 28, "device_ms": 8.0, "self_device_ms": 2.0, "launches": 84}
    r = NS(counts={"pool.bytes": 3.35e9}, spans={"eco.layer.pooling": row}, peaks=peaks)
    assert read(r) == pytest.approx(100.0 * 1e-3 / 8e-3)
    # nothing to read: a program without the counter (the parent), no pooling
    # span, a span with no device work (a CPU run)
    for counts, spans in (({}, {"eco.layer.pooling": row}), ({"pool.bytes": 1.0}, {}),
                          ({"pool.bytes": 1.0}, {"eco.layer.pooling": dict(row, device_ms=0.0)})):
        assert read(NS(counts=counts, spans=spans, peaks=peaks)) is None


def test_whole_run_on_the_cpu_is_correct():
    """16 frames, crop 224 (the least the 7x7 logits pool takes), one clip a
    request."""
    cell = small_cell(CELL, videos=1, pool=1, sample_requests=1)
    cell.config.update(num_segments=16, crop_size=224, frame_height=232, frame_width=240)
    numbers = {}
    result, lines = harness.run(CELL, 2**31 + 11, 0.3, False, device="cpu", cell=cell,
                                numbers=numbers)
    assert result["correct"], lines
    assert numbers["logit_rel_err_worst"] < 1e-4, lines
    assert math.isfinite(result["metrics"]["videos_per_s"]["value"])
