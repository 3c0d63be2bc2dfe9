"""BENCHMARK.json against the benchmark's rules, and every cell's files."""

import json
import re
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    named = [w for w in BENCH["command"] if w.endswith(".py")]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert 2 * (s + 60) + 14 * 24 * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert _line(entry["why"])
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert entry["file"].startswith("portbench/configs/") and (ROOT / entry["file"]).is_file()
    assert entry["reduced"] == json.loads((ROOT / entry["file"]).read_text())["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(entry[k]) for k in ("name", "config", "traffic"))
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    reported = [m for m in BENCH["end_to_end"]
                if "workloads" not in m or entry["name"] in m["workloads"]]
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert any(m["moves"] in names and entry["name"] in m.get("workloads", WORKLOADS)
               for m in BENCH["per_layer"])


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert all(w in WORKLOADS for w in metric.get("workloads", []))
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_layers_are_named_alike():
    by_name = {}
    for m in BENCH["per_layer"]:
        by_name.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_name.values())


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves_to_its_files(name):
    cell = spec.cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == name)
    assert cell.traffic["kind"] == "closed"
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert cell.per_layer and callable(cell.reference.net)
    for m in cell.per_layer:
        reader = cell.readers[m["name"]]
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    for f in (ROOT / "portbench").rglob("*"):
        assert f.is_dir() or PATH.match(str(f.relative_to(ROOT)))
