"""MViTv2-B's files: its counts against sums worked by hand, its reference
against the copy the program's tests use (``tests/reference_mvit.py``) and
through the harness's loader, its configuration, traffic and limits, the
two pooled-attention readers on hand-made readings, and a whole run of its
cell on the CPU at a small size.
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
CELL = "mvit_b_batch10"
# widths small enough for the CPU: 4 blocks, d = 32, every ratio of q's
# grid to k's
TINY = dict(embed_dim=32, depth=4, num_heads=1, dim_mul_blocks=[1, 3], kv_stride=[1, 4, 4])


def _tests_reference():
    spec_ = importlib.util.spec_from_file_location("tests_reference_mvit",
                                                   ROOT / "tests" / "reference_mvit.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def _published(cell):
    return {**cell.config, "num_segments": 32, "crop_size": 224}


def test_counts_by_hand():
    """MViTv2-B at 32 x 224 x 224: a 16 x 56 x 56 grid at C = 96 and one
    head, a class token; q and k, v grids and widths by block as the
    published strides give them."""
    # (blocks, tokens in, queries, keys, C in, C out, heads)
    stages = [(2, 50177, 50177, 785, 96, 96, 1), (1, 50177, 12545, 3137, 96, 192, 2),
              (2, 12545, 12545, 785, 192, 192, 2), (1, 12545, 3137, 3137, 192, 384, 4),
              (15, 3137, 3137, 785, 384, 384, 4), (1, 3137, 785, 3137, 384, 768, 8),
              (2, 785, 785, 785, 768, 768, 8)]
    macs = 50176 * 96 * 3 * 3 * 7 * 7                           # patch embedding
    pattn = 0
    for blocks, tokens, lq, lk, cin, c, heads in stages:
        qg, kg = lq - 1, lk - 1
        k_sum = 16 + 2 * round(math.sqrt(kg / 16))             # kt + kh + kw
        per = tokens * cin * 3 * c                              # qkv
        per += tokens * cin * c if cin != c else 0              # the skip's proj
        per += c * 27 * (qg + 2 * kg)                           # q, k, v pooling
        per += lq * c * c + 2 * lq * c * 4 * c                  # proj, fc1, fc2
        macs += blocks * per
        pattn += blocks * c * (2 * lq * lk + qg * k_sum)        # q k^T, AV, positions
    macs += 768 * 400
    cell = small_cell(CELL)
    cfg = _published(cell)
    net = cell.counts.net(cfg)
    assert cell.counts.forward_flops(net, cfg) == 2.0 * (macs + pattn)
    assert (macs + pattn) / 1e9 == pytest.approx(224.47, abs=0.005)
    assert cell.counts.forward_flops(net, cfg) / 1e9 == pytest.approx(448.95, abs=0.01)
    assert cell.counts.pattn_flops(net, cfg, 10) == 2.0 * pattn * 10
    # q, k, v and the output in bf16, once; the tables (2 max(q, k) - 1 rows
    # a spatial axis, 31 along T, d = 96) once
    qkvo = sum(b * 10 * c * (2 * lq + 2 * lk) * 2 for b, _, lq, lk, _, c, _ in stages)
    rows = (2 * (2 * 111 + 31) + (2 * 55 + 31) + 2 * (2 * 55 + 31) + (2 * 27 + 31)
            + 15 * (2 * 27 + 31) + (2 * 27 + 31) + 2 * (2 * 13 + 31))
    assert cell.counts.pattn_bytes(net, cfg, 10) == qkvo + rows * 96 * 2
    assert cell.counts.k1_bytes(10, cfg, 2) == 10 * 32 * 224 * 224 * 3 * 3


def test_reference_is_the_tests_copy():
    theirs = _tests_reference()
    cell = small_cell(CELL)
    mine = cell.reference
    cfg = {**cell.config, **TINY, "num_segments": 8, "crop_size": 64}
    net = mine.net(cfg)
    assert vars(net) == vars(theirs.net(cfg))
    ps, ss = mine.param_specs(net, cfg)
    tps, tss = theirs.param_specs(theirs.net(cfg), cfg)
    fields = lambda s: (s.layer, s.name, s.shape, s.low, s.high, s.laplace)  # noqa: E731
    assert ss == tss == [] and [fields(s) for s in ps] == [fields(s) for s in tps]
    assert all(isinstance(s, ParamSpec) for s in ps)
    params, state = weights.make(ps, ss, 2**33 + 1, "cpu")
    frames = torch.randint(0, 256, (1, 8, 70, 74, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    args = (frames, [3], [9], [1])
    clips = mine.clips(cfg, *args)
    assert torch.equal(clips, theirs.clips(cfg, *args))
    assert clips.shape == (1, 3, 8, 64, 64)
    with torch.no_grad():
        assert torch.equal(mine.forward(net, params, state, clips),
                           theirs.forward(net, params, state, clips))
    text = (ROOT / "portbench" / "reference" / "mvit_v2_b_kinetics.py").read_text()
    assert "eco_tpu" not in text and "import jax" not in text


def test_files_of_the_cell():
    cell = spec.cell(CELL)
    cfg = cell.config
    assert cfg["model"] == "mvit_v2_b_kinetics" and cfg["reduced"] == []
    assert (cfg["num_segments"], cfg["crop_size"], cfg["frame_height"], cfg["frame_width"]) == (
        32, 224, 256, 340)
    assert cfg["mean_bgr"] == [114.75] * 3 and cfg["std_rgb"] == [57.375] * 3
    assert cfg["precision"] == "bfloat16" and cfg["fc_name"] == "head.projection"
    net = cell.reference.net(cfg)
    assert (net.embed_dim, net.depth, net.num_heads, net.dim_mul_blocks, net.patch_kernel,
            net.patch_stride, net.patch_padding, net.pool_kernel, net.kv_stride,
            net.mlp_ratio) == (96, 24, 1, (2, 5, 21), (3, 7, 7), (2, 4, 4), (1, 3, 3),
                               (3, 3, 3), (1, 8, 8), 4.0)
    specs, _ = cell.reference.param_specs(net, cfg)
    assert sum(math.prod(s.shape) for s in specs) == 51_230_128
    assert cfg["fc_name"] in {s.layer for s in specs}
    traffic = cell.traffic
    assert (traffic["kind"], traffic["videos"], traffic["pool"], traffic["sample_requests"]) == (
        "closed", 10, 8, 13)
    eight = json.loads((ROOT / "portbench" / "traffic" / "closed_batch8.json").read_text())
    assert traffic["frames"] == eight["frames"]
    assert set(cell.limits) == {"logit_rel_err"} and 0 < cell.limits["logit_rel_err"] < 1
    names = {m["name"] for m in cell.per_layer}
    assert {"pattn_roofline.batch", "qkv_pool_ms.batch", "mfu.batch", "model_mfu.batch",
            "launches.batch", "epilogue_ms.batch", "idle_share.batch", "h2d_ms.batch",
            "k1_roofline.batch"} == names
    assert [m["name"] for m in cell.end_to_end] == ["videos_per_s", "setup_s"]
    bench = spec.benchmark()
    work = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (work["config"], work["traffic"], work["chips"]) == (
        "mvit_v2_b_kinetics", "closed_batch10", 1)


def _readings(counts, spans, requests=3):
    return NS(counts=counts, spans=spans, traced={"requests": requests},
              peaks={"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12})


def test_pooled_attention_readers_by_hand():
    cell = small_cell(CELL)
    roof = cell.readers["pattn_roofline.batch"].read
    pool = cell.readers["qkv_pool_ms.batch"].read
    row = {"calls": 72, "device_ms": 10.0, "self_device_ms": 10.0, "launches": 600}
    # compute bound: 2.967e12 at 989 TFLOP/s is 3 ms of the 10
    r = _readings({"pattn.flops": 2.967e12, "pattn.bytes": 1e6, "pattn.bias_bytes": 5e8},
                  {"eco.pattn": row, "eco.qkv_pool": dict(row, device_ms=6.0)})
    assert roof(r) == pytest.approx(30.0)
    assert pool(r) == pytest.approx(2.0)
    # memory bound: 16.75 GB at 3.35 TB/s is 5 ms of the 10
    r = _readings({"pattn.flops": 989e9, "pattn.bytes": 16.75e9}, {"eco.pattn": row})
    assert roof(r) == pytest.approx(50.0)
    # the window attention's counters and spans are not the pooled one's
    r = _readings({"attn.flops": 1e12, "attn.bytes": 1e9}, {"eco.attn": row, "eco.window": row})
    assert roof(r) is None and pool(r) is None
    # nothing to read: a program without the spans or counters (the parent),
    # a span with no device work (a CPU run), no traced request
    for counts, spans, req in (({}, {"eco.pattn": row}, 3),
                               ({"pattn.flops": 1.0}, {}, 3),
                               ({"pattn.flops": 1.0}, {"eco.pattn": dict(row, device_ms=0.0)}, 3)):
        assert roof(_readings(counts, spans, req)) is None
    for spans, req in (({}, 3), ({"eco.qkv_pool": dict(row, device_ms=0.0)}, 3),
                       ({"eco.qkv_pool": row}, 0)):
        assert pool(_readings({}, spans, req)) is None


def test_whole_run_on_the_cpu():
    """8 frames at crop 64, the 4 tiny blocks, one clip a request, float32:
    the program's float32 against the reference's, through ``UInt8Server``,
    whose bfloat16 clips round ``x - 114.75``; the limit is the cell's."""
    cell = small_cell(CELL, videos=1, pool=1, sample_requests=1)
    cell.config.update(num_segments=8, crop_size=64, frame_height=72, frame_width=76, **TINY)
    cell.config["model_args"] = {**cell.config["model_args"], **{k: k for k in TINY}}
    numbers = {}
    result, lines = harness.run(CELL, 2**31 + 11, 0.3, False, device="cpu", cell=cell,
                                numbers=numbers)
    assert result["correct"], lines
    assert numbers["logit_rel_err_worst"] < cell.limits["logit_rel_err"], lines
    assert math.isfinite(result["metrics"]["videos_per_s"]["value"])
