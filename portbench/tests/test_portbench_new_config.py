"""A configuration added as files alone: a copy of the benchmark's tree
gains a config, its reference, its counts, a traffic mix, a limits file and
BENCHMARK.json entries, and nothing of the copy is edited but
BENCHMARK.json's lists.  The model is no ECO: a dense-clip 3D net with a
(3,7,7)/s2 stem, as C3D-ResNet-18's, a PReLU whose ``slope`` no ECO layer
has, and a builder that takes ``clip_len``, ``width`` and ``num_classes``.
Its builder is registered in the program's zoo for the test, as a new zoo
entry would be.  A whole run on the CPU, float32, has to come out correct.
"""

import json
import shutil
from pathlib import Path

import pytest

from portbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]
CELL = "tiny_c3d_batch2"

CONFIG = {
    "name": "tiny_c3d",
    "source": "a test's stand-in for a dense-clip 3D net (C3D-ResNet-18's stem)",
    "model": "tiny_c3d",
    "model_args": {"clip_len": "num_segments", "crop_size": "crop_size", "width": "width",
                   "num_classes": "num_classes"},
    "num_classes": 7,
    "width": 8,
    "fc_name": "fc8",
    "num_segments": 6,
    "crop_size": 32,
    "frame_height": 40,
    "frame_width": 44,
    "mean_bgr": [104.0, 117.0, 123.0],
    "precision": "float32",
    "reduced": [],
}

REFERENCE = '''"""The test's dense-clip 3D net in plain PyTorch: clips (N, 3, T, H, W)."""

import math

import torch
import torch.nn.functional as F

from portbench.reference import ParamSpec


def net(cfg):
    return {"width": cfg["width"], "classes": cfg["num_classes"], "fc": cfg["fc_name"]}


def param_specs(net, cfg):
    c, k, fc = net["width"], net["classes"], net["fc"]
    params = [ParamSpec("conv1", "w", (c, 3, 3, 7, 7), laplace=math.sqrt(1 / 441) / 75),
              ParamSpec("conv1", "b", (c,), -0.1, 0.1),
              ParamSpec("conv1_bn", "gamma", (c,), 0.8, 1.2),
              ParamSpec("conv1_bn", "beta", (c,), -0.2, 0.2),
              ParamSpec("conv1_prelu", "slope", (c,), 0.05, 0.3),
              ParamSpec(fc, "w", (k, c), laplace=math.sqrt(1 / c)),
              ParamSpec(fc, "b", (k,), -0.1, 0.1)]
    stats = [ParamSpec("conv1_bn", "mean", (c,), -0.2, 0.2),
             ParamSpec("conv1_bn", "var", (c,), 0.8, 1.25)]
    return params, stats


def clips(cfg, frames_u8, h_off, w_off, mirror):
    n, _, h, w, _ = frames_u8.shape
    crop = cfg["crop_size"]
    mean = torch.tensor(cfg["mean_bgr"], dtype=torch.float32, device=frames_u8.device)
    out = []
    for i in range(n):
        y0 = min(max(int(h_off[i]), 0), h - crop)
        x0 = min(max(int(w_off[i]), 0), w - crop)
        v = frames_u8[i, :, y0:y0 + crop, x0:x0 + crop].float() - mean
        out.append((v.flip(2) if bool(mirror[i]) else v).permute(3, 0, 1, 2))
    return torch.stack(out)


def forward(net, params, state, clips):
    view = (1, -1, 1, 1, 1)
    x = F.conv3d(clips, params["conv1"]["w"], params["conv1"]["b"], stride=2, padding=(1, 3, 3))
    bn, st = params["conv1_bn"], state["conv1_bn"]
    x = (x - st["mean"].view(view)) / torch.sqrt(st["var"].view(view) + 1e-5)
    x = x * bn["gamma"].view(view) + bn["beta"].view(view)
    x = torch.where(x > 0, x, params["conv1_prelu"]["slope"].view(view) * x)
    fc = params[net["fc"]]
    return F.linear(x.mean(dim=(2, 3, 4)), fc["w"], fc["b"])
'''

COUNTS = '''"""The test's dense-clip 3D net: FLOPs and K1's bytes from shapes."""


def net(cfg):
    return cfg


def forward_flops(net, cfg):
    t, s = (cfg["num_segments"] - 1) // 2 + 1, (cfg["crop_size"] - 1) // 2 + 1
    return 2.0 * (t * s * s * cfg["width"] * 3 * 3 * 7 * 7 + cfg["width"] * cfg["num_classes"])


def k1_bytes(videos, cfg, out_bytes):
    return float(videos * cfg["num_segments"] * cfg["crop_size"] ** 2 * 3 * (1 + out_bytes))
'''


def build_tiny_c3d(*, clip_len, crop_size, width, num_classes, batch=1):
    from eco_tpu_torch.spec.netspec import NetBuilder

    b = NetBuilder("tiny_c3d")
    x = b.input("data", (batch, clip_len, crop_size, crop_size, 3))
    x = b.conv("conv1", x, width, k=(3, 7, 7), s=(2, 2, 2), p=(1, 3, 3))
    x = b.bn("conv1_bn", x)
    x = b.layer("conv1_prelu", "prelu", x)
    x = b.layer("global_pool", "global_avg_pool", x)
    b.layer("probs", "softmax", b.fc("fc8", x, num_classes))
    return b.build()


def _tree(tmp: Path) -> Path:
    """A copy of the benchmark's tree with the configuration added as files."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp / "portbench"
    for rel, text in ((f"configs/{CONFIG['name']}.json", json.dumps(CONFIG)),
                      (f"reference/{CONFIG['name']}.py", REFERENCE),
                      (f"counts/{CONFIG['name']}.py", COUNTS),
                      (f"limits/{CELL}.json", json.dumps({"logit_rel_err": 1e-4}))):
        assert not (here / rel).exists()
        (here / rel).write_text(text)
    traffic = json.loads((here / "traffic/closed_batch32.json").read_text())
    traffic.update(videos=2, pool=2, sample_requests=2)
    (here / "traffic/closed_batch2.json").write_text(json.dumps(traffic))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG["name"], "source": CONFIG["source"],
                             "file": f"portbench/configs/{CONFIG['name']}.json",
                             "reduced": [], "why": "a dense-clip 3D net"})
    bench["workloads"].append({"name": CELL, "config": CONFIG["name"],
                               "traffic": "closed_batch2", "chips": 1,
                               "why": "a dense-clip 3D net, closed loop of 2 videos"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_a_configuration_added_as_files_runs_correct(tmp_path, monkeypatch):
    from eco_tpu_torch.models import zoo

    monkeypatch.setitem(zoo.REGISTRY, CONFIG["model"], build_tiny_c3d)
    cell = spec.cell(CELL, root=_tree(tmp_path))
    assert cell.reference.__file__.startswith(str(tmp_path))
    numbers = {}
    result, lines = harness.run(CELL, 2**31 + 3, 0.6, True, device="cpu", cell=cell,
                                numbers=numbers)
    assert result["correct"], lines
    assert numbers["logit_rel_err_worst"] < 1e-5, lines
    assert result["metrics"]["mfu.batch"]["value"] > 0
    with pytest.raises(KeyError):
        spec.cell(CELL)  # the repository's own tree has no such cell
