"""eco_tpu_torch.parallel against eco_tpu on the CPU: the 16 cases of
tests/test_parallel.py, run as 2 ranks over gloo.

The reference runs one global program on the 8-device virtual CPU mesh; the
port runs 2 processes, each with its shard, and explicit collectives.  One
spawn (``_torch_dist_workers.parallel_suite``, a module fixture) runs every
2-rank check on numpy inputs made here; each test holds one part of it to
the reference's single-device numbers computed in this process (which
imports JAX; the ranks do not).  Bounds: train steps rel L2 1e-4 per leaf
(ROADMAP.md section 3's mini-graph bound), inference 1e-5, SyncBN 1e-4 rel
/ 1e-5 abs (tests/test_parallel.py:217-246).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eco_tpu import ops as jops
from eco_tpu.parallel import split_stages as jax_split_stages
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import graph_from_json as jax_graph_from_json
from eco_tpu.train import SolverConfig as JaxSolverConfig
from eco_tpu.train import init_train_state as jax_init_train_state
from eco_tpu.train import make_train_step as jax_make_train_step
from eco_tpu.train.loop import Trainer as JaxTrainer
from eco_tpu_torch.convert import params_from_jax
from eco_tpu_torch.parallel import make_pp_infer_fn, split_stages
from eco_tpu_torch.parallel.mesh import distributed_init, multihost_evidence
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.graph import graph_to_json

from tests import _torch_dist_workers as workers

TRAIN_REL = 1e-4
INFER_TOL = 1e-5


def _jax_graph(graph):
    return jax_graph_from_json(graph_to_json(graph))


def _torch_tree(graph, params, state):
    p, s = params_from_jax(graph, params, state, device="cpu")
    return workers.arrays(p), workers.arrays(s)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# A bias in front of a BN (c3d/b, fc_in/b) has a gradient of exactly zero:
# both packages leave f32 noise of ~1e-9 there, so each leaf's error is held
# to rel * |want| plus this RMS floor
NOISE_RMS = 1e-7


def _assert_trees(got, want, rel):
    assert got.keys() == want.keys()
    bad = []
    for ln in want:
        assert got[ln].keys() == want[ln].keys(), ln
        for k in want[ln]:
            a, b = np.asarray(got[ln][k], np.float64), np.asarray(want[ln][k], np.float64)
            assert a.shape == b.shape, (ln, k)
            err = np.linalg.norm(a - b)
            if err > rel * np.linalg.norm(b) + NOISE_RMS * np.sqrt(b.size):
                bad.append(f"{ln}/{k}: rel L2 {_rel(a, b):.3e}")
    assert not bad, bad


@pytest.fixture(scope="module")
def ref():
    """The reference's inputs and single-device numbers."""
    rng = np.random.default_rng(0)
    out = {}
    train_graph = workers.small_video_graph(True)
    test_graph = workers.small_video_graph(False)
    jtrain = JaxProgram(_jax_graph(train_graph), train=True)
    jtest = JaxProgram(_jax_graph(test_graph), train=False)
    batch = {"data": rng.standard_normal((2, 8, 4, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 5, (2, 8)).astype(np.int32)}
    params, state = jtrain.init(jax.random.PRNGKey(0), {k: v[0] for k, v in batch.items()})
    out["batch"] = batch
    out["mini_params"], out["mini_state"] = _torch_tree(train_graph, params, state)
    ts, m = jax.jit(jax_make_train_step(jtrain, JaxSolverConfig(**workers.MINI_SOLVER)))(
        jax_init_train_state(params, state), batch, jax.random.PRNGKey(7))
    out["step_params"], out["step_state"] = _torch_tree(train_graph, ts.params, ts.state)
    out["step_loss"] = float(m["loss"])
    out["infer_data"] = rng.standard_normal((8, 4, 16, 16, 3)).astype(np.float32)
    out["infer_probs"] = np.asarray(jtest.apply(params, state, {"data": out["infer_data"]})[0]
                                    ["probs"])
    out["seg_probs"] = np.asarray(jtest.apply(params, state,
                                              {"data": out["infer_data"][:2]})[0]["probs"])
    # the eval: two batches, metric tops averaged (Solver::Test)
    data = rng.standard_normal((8, 4, 16, 16, 3)).astype(np.float32)
    label = (np.arange(8) % 5).astype(np.int32)
    out["eval_batches"] = [{"data": data, "label": label},
                           {"data": data[::-1].copy(), "label": label[::-1].copy()}]
    jeval = JaxProgram(_jax_graph(train_graph), train=False)
    out["eval"] = JaxTrainer(jeval, JaxSolverConfig(), test_program=jeval,
                             log_fn=lambda *_: None).test(
        jax_init_train_state(params, state), iter(out["eval_batches"]))
    # SyncBN: the global batch's moments, values and gradients
    x = rng.standard_normal((16, 6, 6, 4)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    beta = rng.standard_normal(4).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    out.update(bn_x=x, bn_gamma=gamma, bn_beta=beta, bn_cot=cot)
    args = (jnp.zeros(4), jnp.ones(4))
    out["bn"] = [np.asarray(a) for a in jops.bn_train(x, gamma, beta, *args)]
    out["bn_grads"] = [np.asarray(g) for g in jax.grad(
        lambda x_, g_: jnp.sum(jops.bn_train(x_, g_, beta, *args)[0] * cot),
        argnums=(0, 1))(x, gamma)]
    # the Gather/Scatter section
    gtest, gtrain = workers.gather_section_graph(False), workers.gather_section_graph(True)
    jg = JaxProgram(_jax_graph(gtest), train=False)
    jgt = JaxProgram(_jax_graph(gtrain), train=True)
    gdata = rng.standard_normal((8, 6)).astype(np.float32)
    gbatch = {"data": gdata[None], "label": rng.integers(0, 4, (1, 8)).astype(np.int32)}
    gp, gs = jgt.init(jax.random.PRNGKey(1), {k: v[0] for k, v in gbatch.items()})
    out["gsec_params"], out["gsec_state"] = _torch_tree(gtrain, gp, gs)
    out["gsec_data"], out["gsec_batch"] = gdata, gbatch
    out["gsec_probs"] = np.asarray(jg.apply(gp, gs, {"data": gdata})[0]["probs"])
    gts, gm = jax.jit(jax_make_train_step(
        jgt, JaxSolverConfig(base_lr=0.1, lr_policy="fixed", iter_size=1)))(
        jax_init_train_state(gp, gs), gbatch, jax.random.PRNGKey(7))
    out["gsec_step_params"], out["gsec_step_state"] = _torch_tree(gtrain, gts.params,
                                                                  gts.state)
    out["gsec_step_loss"] = float(gm["loss"])
    out["eco_batch"] = {
        "data": rng.standard_normal((1, 8, 4, 64, 64, 3)).astype(np.float32),
        "label": rng.integers(0, 10, (1, 8)).astype(np.int32)}
    return out


@pytest.fixture(scope="module")
def ranks(ref):
    payload = {k: ref[k] for k in (
        "batch", "mini_params", "mini_state", "infer_data", "eval_batches", "bn_x",
        "bn_gamma", "bn_beta", "bn_cot", "gsec_params", "gsec_state", "gsec_data",
        "gsec_batch", "eco_batch")}
    return workers.run("parallel_suite", payload, timeout=240)


def _same_on_ranks(ranks, key):
    a, b = ranks[0][key], ranks[1][key]
    for ln in a["params"]:
        for k in a["params"][ln]:
            assert np.array_equal(a["params"][ln][k], b["params"][ln][k]), (key, ln, k)


def test_mesh_construction(ranks):
    for r in ranks:
        assert r["mesh"]["default"] == {"data": 2}
        assert r["mesh"]["segment"] == {"data": 1, "segment": 2}
        assert "do not cover 2 devices" in r["mesh"]["bad"]


def test_distributed_init_without_a_cluster(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost_evidence() is None
    distributed_init(device="cpu")  # no cluster detected: a no-op
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert multihost_evidence() is None  # a single-task allocation
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multihost_evidence() == "WORLD_SIZE=2"
    with pytest.raises(RuntimeError, match="multi-process job"):
        distributed_init(device="cpu")
    assert not torch.distributed.is_initialized()


def test_sharded_train_step_matches_single_device(ref, ranks):
    _same_on_ranks(ranks, "dp_step")
    got = ranks[0]["dp_step"]
    assert _rel(got["loss"], ref["step_loss"]) <= TRAIN_REL
    _assert_trees(got["params"], ref["step_params"], TRAIN_REL)
    # BN running stats: SyncBN over data == the global batch's moments
    _assert_trees(got["state"], ref["step_state"], TRAIN_REL)


def test_sharded_inference_matches_local(ref, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["dp_infer"], ref["infer_probs"], rtol=INFER_TOL,
                                   atol=INFER_TOL)


def test_eco_lite_multichip_dryrun(ranks):
    a, b = ranks[0]["eco_lite"], ranks[1]["eco_lite"]
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    assert a["it"] == 1
    assert a["digest"] == b["digest"]


def test_segment_sharded_inference_matches_local(ref, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["seg_infer"], ref["seg_probs"], rtol=INFER_TOL,
                                   atol=INFER_TOL)


def test_remat_train_step_matches_plain(ranks):
    for r in ranks:
        plain, remat = r["dp_step"], r["dp_step_remat"]
        assert remat["loss"] == plain["loss"]
        for ln, lp in plain["params"].items():
            for k, v in lp.items():
                assert np.array_equal(remat["params"][ln][k], v), (ln, k)


def test_mem_param_maps_to_remat_policy():
    from eco_tpu_torch.runtime.memory import remat_policy_from_graph
    from eco_tpu_torch.spec.prototxt import graph_from_prototxt

    g = graph_from_prototxt(
        'name: "x"\nmem_param { optimize_train: true }\n'
        'input: "data"\ninput_dim: 1\ninput_dim: 3\ninput_dim: 8\ninput_dim: 8\n')
    assert remat_policy_from_graph(g) == "dots"
    g2 = graph_from_prototxt(
        'name: "y"\ninput: "data"\ninput_dim: 1\ninput_dim: 3\ninput_dim: 8\ninput_dim: 8\n')
    assert remat_policy_from_graph(g2) is None


def test_gather_scatter_section_layers(ref, ranks):
    """Forward: the section on the whole batch; gradients: through the
    Gather's reduce-scatter and the Scatter's slice, against the reference's
    single-device step (its BN mixes the batch inside the section)."""
    for r in ranks:
        np.testing.assert_allclose(r["gsec_infer"], ref["gsec_probs"], rtol=INFER_TOL,
                                   atol=1e-6)
    _same_on_ranks(ranks, "gsec_step")
    got = ranks[0]["gsec_step"]
    assert _rel(got["loss"], ref["gsec_step_loss"]) <= TRAIN_REL
    _assert_trees(got["params"], ref["gsec_step_params"], TRAIN_REL)
    _assert_trees(got["state"], ref["gsec_step_state"], TRAIN_REL)


def test_syncbn_explicit_axis_name_matches_global(ref, ranks):
    y_ref, nm_ref, nv_ref = ref["bn"]
    gx_ref, gg_ref = ref["bn_grads"]
    halves = np.split(y_ref, 2), np.split(gx_ref, 2)
    for rank, r in enumerate(ranks):
        s = r["syncbn"]
        np.testing.assert_allclose(s["y"], halves[0][rank], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(s["mean"], nm_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(s["var"], nv_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(s["gx"], halves[1][rank], rtol=1e-4, atol=1e-5)
        assert s["mesh_dim_equal"]  # axis_name=mesh["data"] is the same group
        assert s["world1_equal"]  # a group of one is plain bn_train bit for bit
    # each rank's gamma gradient covers its half: their sum is the global one
    np.testing.assert_allclose(ranks[0]["syncbn"]["ggamma"] + ranks[1]["syncbn"]["ggamma"],
                               gg_ref, rtol=1e-4, atol=1e-5)


def test_tp_inference_matches_local(ref, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["tp_infer"], ref["infer_probs"], rtol=INFER_TOL,
                                   atol=INFER_TOL)


def test_tp_shards_hold_a_tp_th_of_each_sharded_leaf(ref, ranks):
    full = {**{f"{ln}/{k}": v.size for ln, lp in ref["mini_params"].items()
               for k, v in lp.items()},
            **{f"{ln}/{k}": v.size for ln, lp in ref["mini_state"].items()
               for k, v in lp.items()}}
    shapes = {**{f"{ln}/{k}": v.shape for ln, lp in ref["mini_params"].items()
                 for k, v in lp.items()},
              **{f"{ln}/{k}": v.shape for ln, lp in ref["mini_state"].items()
                 for k, v in lp.items()}}
    for r in ranks:
        for name, n in r["tp_numel"].items():
            sharded = shapes[name][0] % 2 == 0
            assert n == (full[name] // 2 if sharded else full[name]), name
    # conv1 w (8, 3, 3, 3) is sharded, fc w (5, 16) is not (5 % 2)
    assert ranks[0]["tp_numel"]["conv1/w"] == 8 * 27 // 2
    assert ranks[0]["tp_numel"]["fc/w"] == 5 * 16


def test_tp_train_step_matches_single_device(ref, ranks):
    _same_on_ranks(ranks, "tp_step")
    got = ranks[0]["tp_step"]
    assert _rel(got["loss"], ref["step_loss"]) <= TRAIN_REL
    _assert_trees(got["params"], ref["step_params"], TRAIN_REL)
    _assert_trees(got["state"], ref["step_state"], TRAIN_REL)
    # momentum history kept its channel sharding through the update
    assert got["shards"] == {"conv1_w": (4, 3, 3, 3), "conv1_w_history": (4, 3, 3, 3)}


def test_trainer_tp_mesh_wiring(ranks):
    for r in ranks:
        assert r["tp_trainer"] == {"it": 2, "conv1_w": (4, 3, 3, 3)}


def test_segment_sharded_train_step_matches_single_device(ref, ranks):
    _same_on_ranks(ranks, "seg_step")
    got = ranks[0]["seg_step"]
    assert _rel(got["loss"], ref["step_loss"]) <= TRAIN_REL
    _assert_trees(got["params"], ref["step_params"], TRAIN_REL)
    _assert_trees(got["state"], ref["step_state"], TRAIN_REL)


def test_pp_infer_matches_local(ref):
    graph = workers.small_video_graph(False)
    prog = Program(graph, device="cpu")
    params, state = workers.tensors(ref["mini_params"]), workers.tensors(ref["mini_state"])
    data = torch.from_numpy(ref["infer_data"])
    stages = split_stages(prog, {"data": data}, 3, params=params)
    assert len(stages) == 3
    assert [n for s in stages for n in s.layer_names] == [l.name for l in prog.exec_layers]
    for a, b in zip(stages, stages[1:]):
        assert set(b.in_names) <= set(a.out_names)
    # the reference's cut points on the same graph and weights
    jprog = JaxProgram(_jax_graph(graph), train=False)
    jp, _ = jprog.init(jax.random.PRNGKey(0), {"data": ref["infer_data"]})
    want = jax_split_stages(jprog, {"data": ref["infer_data"]}, 3, params=jp)
    assert [s.layer_names for s in stages] == [s.layer_names for s in want]
    infer = make_pp_infer_fn(prog, params, state, ["cpu"] * 3,
                             sample_inputs={"data": data}, microbatches=4)
    np.testing.assert_allclose(infer({"data": data}).numpy(), ref["infer_probs"],
                               rtol=INFER_TOL, atol=1e-6)


def test_pp_split_respects_shared_param_groups():
    from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec, ParamSpec

    g = GraphSpec(
        name="sharedpp",
        inputs={"a": (4, 6)},
        layers=[
            LayerSpec("ip1", "innerproduct", ("a",), ("y1",), {"num_output": 6},
                      params=(ParamSpec(name="sw"), ParamSpec())),
            LayerSpec("r1", "relu", ("y1",), ("y1",)),
            LayerSpec("ip2", "innerproduct", ("y1",), ("y2",), {"num_output": 6},
                      params=(ParamSpec(name="sw"), ParamSpec())),
            LayerSpec("ip3", "innerproduct", ("y2",), ("y3",), {"num_output": 3}),
            LayerSpec("sm", "softmax", ("y3",), ("p",)),
        ],
    )
    prog = Program(g, device="cpu")
    ins = {"a": torch.from_numpy(np.random.default_rng(3).standard_normal((4, 6))
                                 .astype(np.float32))}
    params, state = prog.init(torch.Generator().manual_seed(0), ins)
    want = prog.apply(params, state, ins)[0]["p"]
    stages = split_stages(prog, ins, 2, params=params)
    assert {"ip1", "ip2"} <= set(stages[0].layer_names)
    jprog = JaxProgram(jax_graph_from_json(graph_to_json(g)), train=False)
    jstages = jax_split_stages(jprog, {"a": ins["a"].numpy()}, 2)
    assert [s.layer_names for s in stages] == [s.layer_names for s in jstages]
    infer = make_pp_infer_fn(prog, params, state, ["cpu", "cpu"], sample_inputs=ins,
                             output="p", microbatches=2)
    np.testing.assert_allclose(infer(ins).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model,crop", [("eco_lite_kinetics", 64), ("eco_full_kinetics", 224)])
def test_split_stages_cut_points_match_reference(model, crop):
    """The meta-device cost model cuts where the reference's abstract
    evaluation does, including never inside ECO-Full's shared 3c span
    (ECO-Full at crop 224: its 2D branch ends in a 7x7 pool; a pass on the
    meta device costs no compute at any crop)."""
    from eco_tpu_torch.models import get_model

    graph = get_model(model, num_segments=4, with_loss=False, batch=2, crop_size=crop)
    sample = {"data": np.zeros((2, 4, crop, crop, 3), np.float32)}
    got = split_stages(Program(graph, device="cpu"), {"data": (2, 4, crop, crop, 3)}, 4)
    want = jax_split_stages(JaxProgram(_jax_graph(graph), train=False), sample, 4)
    assert [s.layer_names for s in got] == [s.layer_names for s in want]
    assert [s.in_names for s in got] == [s.in_names for s in want]


def test_trainer_sharded_eval_matches_single_device(ref, ranks):
    for r in ranks:
        assert r["eval"].keys() == ref["eval"].keys() and r["eval"]
        for k in ref["eval"]:
            np.testing.assert_allclose(r["eval"][k], ref["eval"][k], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["tp_step", "seg_step"])
def test_dp_x_tp_and_dp_x_segment_steps_on_four_ranks(ref, four_ranks, key):
    """The axes compose: data 2 x model 2 and data 2 x segment 2, against
    the reference's single-device step."""
    for r in four_ranks:
        got = r[key]
        assert _rel(got["loss"], ref["step_loss"]) <= TRAIN_REL
        _assert_trees(got["params"], ref["step_params"], TRAIN_REL)
        _assert_trees(got["state"], ref["step_state"], TRAIN_REL)
        for ln, lp in got["params"].items():
            for k, v in lp.items():
                assert np.array_equal(v, four_ranks[0][key]["params"][ln][k]), (key, ln, k)


@pytest.fixture(scope="module")
def four_ranks(ref):
    return workers.run("four_rank_suite", {k: ref[k] for k in (
        "batch", "mini_params", "mini_state")}, world=4, timeout=180)
