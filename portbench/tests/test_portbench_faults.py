"""A whole run on the CPU with the timed path broken underneath: ``correct``
has to come out false.  Beside the faults, the same run unbroken comes out
true.  The card's check (``run.py``) is skipped; everything after it runs.

The faults a serving cell can have: an answer altered where it is produced
(each probability row rolled by one class), and half of the batch left out
(the server scores the first half of a request's videos).  A serving cell
keeps no state from step to step, and one card runs no exchange between
cards.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.test_portbench_reference import small_cell

ROOT = Path(__file__).resolve().parents[2]


def _serving_cell():
    cell = small_cell("lite_batch32", videos=2)
    cell.config["precision"] = "bfloat16"
    return cell


def test_sound_serving_run_is_correct():
    result, lines = harness.run("lite_batch32", 11, 0.5, False, device="cpu",
                                cell=_serving_cell())
    assert result["correct"], lines


def _altered(call):
    return lambda self, *a, **k: call(self, *a, **k).roll(1, dims=-1)


def _half(call):
    def half(self, frames, *, h_off, w_off, mirror):
        keep = len(frames) // 2
        return call(self, frames[:keep], h_off=h_off[:keep], w_off=w_off[:keep],
                    mirror=mirror[:keep])
    return half


@pytest.mark.parametrize("fault", [_altered, _half], ids=["altered_answer", "half_batch"])
def test_fault_is_caught(monkeypatch, fault):
    from eco_tpu_torch.apps import serving

    monkeypatch.setattr(serving.UInt8Server, "__call__", fault(serving.UInt8Server.__call__))
    result, lines = harness.run("lite_batch32", 11, 0.5, False, device="cpu",
                                cell=_serving_cell())
    assert not result["correct"], lines


def test_a_run_loads_no_jax():
    """A whole run in a fresh process, then its modules by top-level name."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import run, harness\n"
        "from portbench.tests.test_portbench_reference import small_cell\n"
        "res, _ = harness.run('lite_batch32', 1, 0.2, False, device='cpu',"
        " cell=small_cell('lite_batch32', videos=1))\n"
        "print(json.dumps([res['correct'], run.forbidden_modules()]))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and loaded == []


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device here: the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "lite_batch32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
