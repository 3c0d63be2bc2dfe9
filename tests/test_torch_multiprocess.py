"""Multi-process data-parallel training of eco_tpu_torch on the CPU, against
eco_tpu: two ranks over gloo must end with bitwise-identical params, equal
within 1e-4 (ROADMAP.md section 3's mini-graph bound) to the reference's
single-device training on the global batches, with snapshots from rank 0
only.

- ``Trainer(mesh=)`` on the mini graph, two ranks spawned in-process;
- ``eco train --dp 2`` and ``--tp 2`` on the CPU (the CLI spawns its ranks),
  against the reference CLI from one weights file;
- ``launch_simulated_multihost`` of ECO-Lite at crop 32 (two OS processes,
  cursor-sharded ``VideoPipeline``s), marked ``slow`` as the reference's
  ``tests/test_multiprocess.py`` is: two full ECO-Lite builds and steps.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import graph_from_json as jax_graph_from_json
from eco_tpu.tools import cli as jax_cli
from eco_tpu.tools.cli import main as jax_main
from eco_tpu.train import SolverConfig as JaxSolverConfig
from eco_tpu.train import init_train_state as jax_init_train_state
from eco_tpu.train import make_train_step as jax_make_train_step
from eco_tpu_torch.convert import params_from_jax
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.graph import graph_to_json
from eco_tpu_torch.spec.prototxt import graph_from_prototxt
from eco_tpu_torch.train import save_model
from test_cli_pipelines import NET_TMPL, SOLVER_TMPL
from test_torch_cli import _frames, _npz

from tests import _torch_dist_workers as workers

REPO = Path(__file__).resolve().parent.parent
TRAIN_REL = 1e-4


def test_two_rank_trainer_matches_the_reference(tmp_path):
    graph = workers.small_video_graph(True)
    jprog = JaxProgram(jax_graph_from_json(graph_to_json(graph)), train=True)
    rng = np.random.default_rng(5)
    batches = [{"data": rng.standard_normal((2, 8, 4, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 5, (2, 8)).astype(np.int32)} for _ in range(2)]
    params, state = jprog.init(jax.random.PRNGKey(0), {k: v[0] for k, v in batches[0].items()})
    tp, ts_ = params_from_jax(graph, params, state, device="cpu")
    ranks = workers.run("trainer_dp", {"params": workers.arrays(tp),
                                       "state": workers.arrays(ts_), "batches": batches,
                                       "dir": str(tmp_path)}, timeout=120)
    step = jax.jit(jax_make_train_step(jprog, JaxSolverConfig(**workers.MINI_SOLVER)))
    ts = jax_init_train_state(params, state)
    for b in batches:
        ts, _ = step(ts, b, jax.random.PRNGKey(0))
    want, _ = params_from_jax(graph, ts.params, ts.state, device="cpu")
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["it"] == ranks[1]["it"] == 2
    for ln, lp in want.items():
        for k, v in lp.items():
            got, v = ranks[0]["params"][ln][k].astype(np.float64), v.numpy().astype(np.float64)
            assert np.linalg.norm(got - v) <= TRAIN_REL * np.linalg.norm(v) + 1e-7 * np.sqrt(
                v.size), (ln, k)
    # only rank 0 wrote its snapshot
    assert sorted(os.listdir(tmp_path / "rank0")) == ["snap_iter_2.model.npz",
                                                      "snap_iter_2.solverstate.npz"]
    assert not (tmp_path / "rank1").exists()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _frames(tmp_path_factory.mktemp("mpds"), 6,
                   lambda rng, v: rng.integers(0, 255, (64, 80, 3), dtype=np.uint8))


def _two_rank_pipeline(make_pipeline):
    """The global batches that two cursor-sharded ranks read: the
    reference's own pipelines at rank 0 and 1 of 2, each of half the batch,
    side by side in rank order."""
    def merged(args, dcfg, *, train, seed=0, rank=0, world=1):
        half = dataclasses.replace(dcfg, batch_size=dcfg.batch_size // 2)
        pipes = [make_pipeline(args, half, train=train, seed=seed, rank=r, world=2)
                 for r in range(2)]

        class Merged:
            def next_batch(self):
                bs = [p.next_batch() for p in pipes]
                return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}

            def close(self):
                for p in pipes:
                    p.close()

        return Merged()
    return merged


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_cli_train_over_two_ranks_matches_the_jax_cli(flag, dataset, tmp_path, monkeypatch):
    """``eco train --dp 2`` / ``--tp 2`` on the CPU: the CLI spawns two gloo
    ranks; both log the same params digest, rank 0 writes the snapshot, and
    it equals the reference CLI's single-device one from the same weights.
    Under ``--dp`` each rank decodes only its own videos (cursor sharding),
    so the reference is fed the global batches its own pipelines read at
    rank 0 and 1 of 2; under ``--tp`` both ranks read the whole batch."""
    net = tmp_path / "net.prototxt"
    net.write_text(NET_TMPL.format(list=dataset).replace("batch_size: 3", "batch_size: 4"))
    graph = graph_from_prototxt(net.read_text())
    weights = str(tmp_path / "init.model.npz")
    save_model(weights, *Program(graph, train=True, device="cpu").init(
        torch.Generator().manual_seed(3), {"data": (4, 2, 32, 32, 3), "label": (4,)}))
    argv = {}
    for who in ("port", "ref"):
        solver = tmp_path / f"{who}_solver.prototxt"
        solver.write_text(SOLVER_TMPL.format(net=str(net), prefix=str(tmp_path / who))
                          .replace("snapshot: 0", "snapshot: 2"))
        argv[who] = ["train", "--solver", str(solver), "--net", str(net), "--weights", weights]
    if flag == "--dp":
        monkeypatch.setattr(jax_cli, "_make_pipeline", _two_rank_pipeline(jax_cli._make_pipeline))
    jax_main(argv["ref"])
    # the port's CLI in a process of its own, which spawns the two ranks
    proc = subprocess.run(
        [sys.executable, "-m", "eco_tpu_torch.tools.cli", *argv["port"], flag, "2",
         "--device", "cpu"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    digests = re.findall(r"rank (\d): params digest ([0-9a-f]{64})", proc.stderr)
    assert sorted(r for r, _ in digests) == ["0", "1"]
    assert len({d for _, d in digests}) == 1
    got, want = (_npz(tmp_path / f"{who}_iter_2.model.npz") for who in ("port", "ref"))
    assert got.keys() == want.keys() and len(got) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.slow
def test_two_process_training_identical_params(tmp_path):
    from eco_tpu_torch.parallel.multiprocess import launch_simulated_multihost
    from eco_tpu_torch.train import load_model

    info = launch_simulated_multihost(2, workdir=str(tmp_path), timeout=600, iters=2,
                                      device="cpu")
    assert info["ok"] and info["num_processes"] == 2 and len(info["digest"]) == 64
    assert info["snapshots"] == ["mh_iter_2.model.npz", "mh_iter_2.solverstate.npz"]
    params, _ = load_model(str(tmp_path / "snap" / "mh_iter_2.model.npz"), device="cpu")
    assert params and all(torch.isfinite(v).all() for lp in params.values() for v in lp.values())
    with pytest.raises(ValueError, match="devices_per_process"):
        launch_simulated_multihost(2, devices_per_process=4, workdir=str(tmp_path / "x"),
                                   device="cpu")
