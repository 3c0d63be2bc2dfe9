"""Video Swin-B's files: its counts against sums worked by hand, its
reference against the copy the program's tests use
(``tests/reference_video_swin.py``) and through the harness's loader, its
configuration, traffic and limits, the two attention readers on hand-made
readings, and a whole run of its cell on the CPU at a small size.
"""

import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import harness, spec, weights
from portbench.reference import ParamSpec
from portbench.tests.test_portbench_reference import small_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "swin_b_batch12"
# widths small enough for the CPU, the head dimension kept at 32
TINY = dict(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8])


def _tests_reference():
    spec_ = importlib.util.spec_from_file_location("tests_reference_video_swin",
                                                   ROOT / "tests" / "reference_video_swin.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def _published(cell):
    return {**cell.config, "num_segments": 32, "crop_size": 224}


def test_counts_by_hand():
    """Swin-B at 32 x 224 x 224: tokens 16x56x56 = 50,176 at C = 128, then a
    quarter the tokens at twice the width each stage; 392 tokens a window."""
    tokens, c, macs, attn = 50176, 128, 0, 0
    macs += tokens * 128 * 3 * 2 * 4 * 4                     # patch embedding
    for depth in (2, 2, 18, 2):
        # qkv, proj, fc1, fc2: 12 C^2 a token; q k^T and AV: 2 x 392 x C
        macs += depth * tokens * 12 * c * c
        attn += depth * tokens * 2 * 392 * c
        if c < 1024:
            tokens //= 4
            macs += tokens * 4 * c * 2 * c                   # the merge's reduction
            c *= 2
    macs += 1024 * 400
    cell = small_cell(CELL)
    cfg = _published(cell)
    net = cell.counts.net(cfg)
    assert cell.counts.forward_flops(net, cfg) == 2.0 * (macs + attn)
    assert (macs + attn) / 1e9 == pytest.approx(281.33, abs=0.005)
    assert attn / 1e9 == pytest.approx(39.02, abs=0.005)
    assert cell.counts.attention_flops(net, cfg, 12) == 2.0 * attn * 12
    # q, k, v, out in bf16; each block's bias once: 1 x heads x 392^2 unshifted,
    # windows x heads x 392^2 shifted (128, 32, 8, 2 windows a clip)
    qkvo = sum(d * 12 * 4 * t * ch * 2 for d, t, ch in
               ((2, 50176, 128), (2, 12544, 256), (18, 3136, 512), (2, 784, 1024)))
    bias = sum((d // 2) * (1 + w) * h * 392 * 392 * 2 for d, w, h in
               ((2, 128, 4), (2, 32, 8), (18, 8, 16), (2, 2, 32)))
    assert cell.counts.attention_bytes(net, cfg, 12) == qkvo + bias
    assert cell.counts.k1_bytes(12, cfg, 2) == 12 * 32 * 224 * 224 * 3 * 3


def test_reference_is_the_tests_copy():
    theirs = _tests_reference()
    cell = small_cell(CELL)
    mine = cell.reference
    cfg = {**cell.config, **TINY, "num_segments": 8, "crop_size": 32}
    net = mine.net(cfg)
    assert vars(net) == vars(theirs.net(cfg))
    ps, ss = mine.param_specs(net, cfg)
    tps, tss = theirs.param_specs(theirs.net(cfg), cfg)
    fields = lambda s: (s.layer, s.name, s.shape, s.low, s.high, s.laplace)  # noqa: E731
    assert ss == tss == [] and [fields(s) for s in ps] == [fields(s) for s in tps]
    assert all(isinstance(s, ParamSpec) for s in ps)
    params, state = weights.make(ps, ss, 2**33 + 1, "cpu")
    frames = torch.randint(0, 256, (1, 8, 40, 44, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    args = (frames, [3], [9], [1])
    clips = mine.clips(cfg, *args)
    assert torch.equal(clips, theirs.clips(cfg, *args))
    assert clips.shape == (1, 3, 8, 32, 32)
    with torch.no_grad():
        assert torch.equal(mine.forward(net, params, state, clips),
                           theirs.forward(net, params, state, clips))
    text = (ROOT / "portbench" / "reference" / "video_swin_b_kinetics.py").read_text()
    assert "eco_tpu" not in text and "import jax" not in text


def test_files_of_the_cell():
    cell = spec.cell(CELL)
    cfg = cell.config
    assert cfg["model"] == "video_swin_b_kinetics" and cfg["reduced"] == []
    assert (cfg["num_segments"], cfg["crop_size"], cfg["frame_height"], cfg["frame_width"]) == (
        32, 224, 256, 340)
    assert cfg["mean_bgr"] == [103.53, 116.28, 123.675]
    assert cfg["std_rgb"] == [58.395, 57.12, 57.375] and cfg["precision"] == "bfloat16"
    net = cell.reference.net(cfg)
    assert (net.embed_dim, net.depths, net.num_heads, net.window_size, net.patch_size,
            net.mlp_ratio) == (128, (2, 2, 18, 2), (4, 8, 16, 32), (8, 7, 7), (2, 4, 4), 4.0)
    specs, _ = cell.reference.param_specs(net, cfg)
    assert sum(math.prod(s.shape) for s in specs) == 88_048_984
    assert cfg["fc_name"] in {s.layer for s in specs}
    traffic = cell.traffic
    assert (traffic["kind"], traffic["videos"], traffic["pool"], traffic["sample_requests"]) == (
        "closed", 12, 8, 11)
    eight = json.loads((ROOT / "portbench" / "traffic" / "closed_batch8.json").read_text())
    assert traffic["frames"] == eight["frames"]
    assert set(cell.limits) == {"logit_rel_err"} and 0 < cell.limits["logit_rel_err"] < 1
    names = {m["name"] for m in cell.per_layer}
    assert {"attn_roofline.batch", "window_ms.batch", "mfu.batch", "model_mfu.batch",
            "launches.batch", "epilogue_ms.batch"} <= names
    assert "pool_roofline.batch" not in names
    assert [m["name"] for m in cell.end_to_end] == ["videos_per_s", "setup_s"]


def _readings(counts, spans, requests=3):
    return NS(counts=counts, spans=spans, traced={"requests": requests},
              peaks={"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12})


def test_attention_readers_by_hand():
    cell = small_cell(CELL)
    roof = cell.readers["attn_roofline.batch"].read
    window = cell.readers["window_ms.batch"].read
    row = {"calls": 72, "device_ms": 10.0, "self_device_ms": 10.0, "launches": 72}
    # memory bound: 16.75 GB at 3.35 TB/s is 5 ms of the 10
    r = _readings({"attn.flops": 989e9, "attn.bytes": 16.75e9},
                  {"eco.attn": row, "eco.window": dict(row, device_ms=6.0)})
    assert roof(r) == pytest.approx(50.0)
    assert window(r) == pytest.approx(2.0)
    # compute bound: 2.967e12 at 989 TFLOP/s is 3 ms of the 10
    r = _readings({"attn.flops": 2.967e12, "attn.bytes": 1e6}, {"eco.attn": row})
    assert roof(r) == pytest.approx(30.0)
    # nothing to read: a program without the spans or counters (the parent),
    # a span with no device work (a CPU run), no traced request
    for counts, spans, req in (({}, {"eco.attn": row}, 3),
                               ({"attn.flops": 1.0}, {}, 3),
                               ({"attn.flops": 1.0}, {"eco.attn": dict(row, device_ms=0.0)}, 3)):
        assert roof(_readings(counts, spans, req)) is None
    for spans, req in (({}, 3), ({"eco.window": dict(row, device_ms=0.0)}, 3),
                       ({"eco.window": row}, 0)):
        assert window(_readings({}, spans, req)) is None


def test_whole_run_on_the_cpu():
    """8 frames at crop 32, C = 32, one clip a request, float32: the
    program's float32 against the reference's, through ``UInt8Server``,
    whose bfloat16 clips round ``x - mean`` by up to a quarter of a grey
    level (ImageNet's mean is no multiple of one half): 1.0e-3 to 1.4e-2 of
    these logits over three seeds; the limit is the cell's."""
    cell = small_cell(CELL, videos=1, pool=1, sample_requests=1)
    cell.config.update(num_segments=8, crop_size=32, frame_height=40, frame_width=44, **TINY)
    cell.config["model_args"] = {**cell.config["model_args"],
                                 **{k: k for k in ("embed_dim", "depths", "num_heads")}}
    numbers = {}
    result, lines = harness.run(CELL, 2**31 + 11, 0.3, False, device="cpu", cell=cell,
                                numbers=numbers)
    assert result["correct"], lines
    assert numbers["logit_rel_err_worst"] < 0.05, lines
    assert math.isfinite(result["metrics"]["videos_per_s"]["value"])
