"""The benchmark's data: ``BENCHMARK.json`` and the files it names by name.

- configurations: ``portbench/configs/<config>.json``;
- traffic mixes: ``portbench/traffic/<traffic>.json`` (read by ``load.py``);
- limits of the check that decides ``correct``:
  ``portbench/limits/<workload>.json``;
- per-layer metric readers: ``portbench/metrics/<metric>.py``;
- FLOP and byte counts: ``portbench/counts/<config>.py``;
- plain references: ``portbench/reference/<config>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict         # per-layer metric name -> reader module
    counts: object        # counts module of the configuration
    reference: object     # reference module of the configuration


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """A workload of BENCHMARK.json with its limits and metrics."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    config, here = w["config"], root / "portbench"
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, config=_json(here / "configs" / f"{config}.json"),
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_json(here / "limits" / f"{name}.json"),
                end_to_end=end_to_end, per_layer=per_layer,
                readers={m["name"]: _module(here / "metrics" / f"{m['name']}.py",
                                            "portbench_metric_" + m["name"].replace(".", "_"))
                         for m in per_layer},
                counts=_module(here / "counts" / f"{config}.py", f"portbench_counts_{config}"),
                reference=_module(here / "reference" / f"{config}.py",
                                  f"portbench_reference_{config}"))
