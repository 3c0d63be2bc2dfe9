"""eco_tpu_torch's training slice against eco_tpu's: train-mode BN, the loss
and accuracy, dropout, the lr policies, the solver step, the Trainer and the
checkpoint files, on the same numpy inputs and on weights carried across by
``params_from_jax``.

Tolerances (f32, both on the CPU): the two frameworks sum in other orders.
Single ops agree to ~1e-7 relative and are held to rtol 1e-5 / atol 1e-6;
the lr policies (libm vs XLA pow/exp) to rtol 1e-6.  Gradients and updates
of the mini ECO-shaped graph pass through train-mode BN, whose gradient
divides by the batch's standard deviation and amplifies rounding, and are
held to rtol 1e-4 / atol 1e-5 (measured: max abs error 1.0e-6 on gradients
of magnitude up to 0.52); three Nesterov steps on it land within rtol 1e-4 /
atol 1e-6 of the reference's params (measured: max abs error 1.5e-7, the
updates agree to 1.4e-6 relative L2).

ReLU's gradient at exactly 0 is 0.5 in the reference (``jnp.maximum``) and 0
in the port (Caffe's rule); inputs here are continuous random values, so no
pre-ReLU value is exactly 0.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eco_tpu import ops as jops
from eco_tpu.apps.serving import RawPreprocessProgram as JaxRawPreprocessProgram
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import GraphSpec
from eco_tpu.spec.netspec import NetBuilder
from eco_tpu.train import SolverConfig as JaxSolverConfig
from eco_tpu.train import checkpoint as jckpt
from eco_tpu.train import init_train_state as jax_init_train_state
from eco_tpu.train import learning_rate as jax_learning_rate
from eco_tpu.train import make_eval_step as jax_make_eval_step
from eco_tpu.train import make_train_step as jax_make_train_step
from eco_tpu.train.loop import solver_config_from_prototxt as jax_solver_from_prototxt
from eco_tpu_torch import ops
from eco_tpu_torch.apps import RawPreprocessProgram
from eco_tpu_torch.convert import params_from_jax, params_to_jax
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.train import (
    SolverConfig,
    Trainer,
    init_train_state,
    learning_rate,
    load_model,
    make_eval_step,
    make_train_step,
    polyak_average,
    restore,
    restore_weights,
    save_model,
    snapshot,
    solver_config_from_prototxt,
)

N, S, HW, CLASSES = 2, 4, 16, 5
RTOL, ATOL = 1e-5, 1e-6          # single ops
G_RTOL, G_ATOL = 1e-4, 1e-5      # gradients / one update through the graph


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _np_tree(tree):
    return {ln: {k: np.asarray(v) for k, v in lp.items()} for ln, lp in tree.items()}


def _assert_np_trees_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for ln in want:
        assert got[ln].keys() == want[ln].keys(), ln
        for k in want[ln]:
            np.testing.assert_allclose(np.asarray(got[ln][k]), np.asarray(want[ln][k]),
                                       rtol=rtol, atol=atol, err_msg=f"{ln}/{k}")


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 5, 4, 8), (2, 3, 4, 4, 16)])
def test_bn_train_matches_jax(shape):
    rng = _rng(0)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    gamma, beta = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    rm = rng.standard_normal(c).astype(np.float32)
    rv = (0.5 + rng.random(c)).astype(np.float32)
    want = jops.bn_train(*(jnp.asarray(a) for a in (x, gamma, beta, rm, rv)), momentum=0.8)
    got = ops.bn_train(*(torch.from_numpy(a) for a in (x, gamma, beta, rm, rv)), momentum=0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # SyncBN takes a process group or a mesh dimension (tests/test_torch_parallel.py);
    # a bare axis name names no group in torch
    with pytest.raises(TypeError, match="SyncBN"):
        ops.bn_train(*(torch.from_numpy(a) for a in (x, gamma, beta, rm, rv)), axis_name="data")


def test_bn_train_running_stats_are_biased_and_carry_no_gradient():
    x = torch.from_numpy(_rng(1).standard_normal((5, 3, 4)).astype(np.float32)).requires_grad_()
    y, mean, var = ops.bn_train(x, torch.ones(4), torch.zeros(4), torch.zeros(4), torch.ones(4))
    flat = x.detach().reshape(-1, 4)
    torch.testing.assert_close(mean, 0.1 * flat.mean(0))
    torch.testing.assert_close(var, 0.1 * flat.var(0, unbiased=False) + 0.9)
    assert y.requires_grad and not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("normalization", ["valid", "batch_size", "full", "none"])
@pytest.mark.parametrize("ignore_label", [None, 2, -1])
def test_softmax_cross_entropy_and_gradient_match_jax(normalization, ignore_label):
    rng = _rng(2)
    logits = (rng.standard_normal((7, 5)) * 3).astype(np.float32)
    labels = np.array([0, 2, 4, 2, 1, 3, 2], np.int32)
    if ignore_label == -1:
        labels[[1, 5]] = -1  # out of range: ignored rows must not index
    kw = dict(ignore_label=ignore_label, normalization=normalization)
    jloss = lambda z: jops.softmax_cross_entropy(z, jnp.asarray(labels), **kw)
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = ops.softmax_cross_entropy(z, torch.from_numpy(labels), **kw)
    (got_g,) = torch.autograd.grad(got, z)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ignore_label", [None, 1])
def test_topk_accuracy_matches_jax_with_ties(k, ignore_label):
    logits = np.array([[1, 3, 3, 0], [2, 2, 2, 2], [0, 1, 2, 3], [5, 4, 4, 9],
                       [1, 1, 0, 0]], np.float32)
    labels = np.array([2, 3, 1, 1, 1], np.int32)
    want = jops.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), k,
                              ignore_label=ignore_label)
    got = ops.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k,
                            ignore_label=ignore_label)
    assert got.item() == pytest.approx(float(want), abs=1e-7)


def test_dropout_train_keeps_a_fraction_and_scales_by_exactly_one_over_keep():
    x = torch.from_numpy(_rng(3).standard_normal((200, 500)).astype(np.float32))
    rate = 0.3
    gen = torch.Generator().manual_seed(0)
    y = ops.dropout(x, rate, train=True, generator=gen)
    kept = y != 0
    # 100k Bernoulli(0.7) draws: the kept share is 0.7 +- 0.0015 (1 sigma)
    assert abs(kept.float().mean().item() - 0.7) < 0.006
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    again = ops.dropout(x, rate, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    bf = x.to(torch.bfloat16)
    yb = ops.dropout(bf, rate, train=True, generator=gen)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0], (bf / (1 - rate))[yb != 0])


def test_maxpool_backward_routes_ties_to_the_first_maximum_like_jax():
    """Equal positive maxima inside a window (as after a ReLU clamps): both
    packages send the window's gradient to the first one in row-major
    order."""
    x = np.zeros((1, 6, 6, 2), np.float32)
    x[0, 0, 0] = x[0, 0, 1] = x[0, 1, 0] = 2.0   # three tied maxima in window (0, 0)
    x[0, 2, 4] = x[0, 3, 3] = 1.5                # tied across windows (1, 1), (1, 2)
    x[0, 5, 5] = x[0, 4, 5] = 0.5
    g = _rng(4).standard_normal((1, 3, 3, 2)).astype(np.float32)
    jpool = lambda z: jops.pool_nd(z, kernel=3, stride=2, mode="max")
    _, vjp = jax.vjp(jpool, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(ops.pool_nd(xt, kernel=3, stride=2, mode="max"), xt,
                                 torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0, 0].abs().sum() > 0 and got[0, 0, 1].abs().sum() == 0


# --------------------------------------------------------------------------
# lr policies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy,kw", [
    ("fixed", {}),
    ("step", dict(gamma=0.1, stepsize=30)),
    ("exp", dict(gamma=0.999)),
    ("inv", dict(gamma=1e-3, power=0.75)),
    ("multistep", dict(gamma=0.5, stepvalues=(10, 40, 41))),
    ("poly", dict(power=2.0, max_iter=200)),
    ("sigmoid", dict(gamma=-0.05, stepsize=50)),
    ("exp10", dict(stepsize=100)),
])
def test_lr_policies_match_jax(policy, kw):
    for it in (0, 1, 10, 40, 41, 99, 150):
        want = float(jax_learning_rate(JaxSolverConfig(base_lr=0.05, lr_policy=policy, **kw), it))
        got = learning_rate(SolverConfig(base_lr=0.05, lr_policy=policy, **kw), it)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, err_msg=f"it={it}")
    with pytest.raises(ValueError, match="lr_policy"):
        learning_rate(SolverConfig(lr_policy="cosine"), 0)


def test_solver_config_from_prototxt_matches_jax():
    text = """
    base_lr: 0.001  lr_policy: "multistep"  gamma: 0.1  stepvalue: 20  stepvalue: 40
    momentum: 0.9  weight_decay: 0.0005  clip_gradients: 40  iter_size: 4
    solver_type: NESTEROV  max_iter: 60  snapshot: 10  snapshot_prefix: "snap/eco"
    """
    got = dataclasses.asdict(solver_config_from_prototxt(text))
    want = dataclasses.asdict(jax_solver_from_prototxt(text))
    assert got == want and got["stepvalues"] == (20, 40)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def _small_graph() -> GraphSpec:
    """conv -> frozen BN -> ReLU -> conv -> train BN -> ReLU -> pool -> fc:
    every kind of lr/decay multiplier (conv 1/1 and 1/2, frozen BN 0/0,
    train BN 1/0, fc 1/1 and 2/0)."""
    b = NetBuilder("small")
    x = b.input("data", (4, 6, 6, 3))
    b.input("label", (4,))
    x = b.conv_bn_relu("c1", x, 4, k=3, p=1, frozen_bn=True)
    x = b.conv_bn_relu("c2", x, 6, k=3, s=2, p=1)
    x = b.layer("gpool", "global_avg_pool", x)
    logits = b.fc("fc", x, 3)
    b.layer("loss", "softmaxwithloss", (logits, "label"))
    return b.build()


def _mini_train_graph(dropout: float = 0.0) -> GraphSpec:
    """The ECO-shaped mini-graph of tests/test_torch_executor.py with a loss:
    fold, a 2D stem with a ceil-mode max pool, an inception block (concat,
    slice), r2Dto3D, a residual 3D block, global pool, dropout, fc,
    SoftmaxWithLoss and a TEST-phase accuracy; every BN trains."""
    b = NetBuilder("mini_train")
    x = b.layer("fold", "fold_segments", b.input("data", (N, S, HW, HW, 3)))
    b.input("label", (N,))
    x = b.conv_bn_relu("stem", x, 8, k=3, s=2, p=1)             # 8x8
    x = b.max_pool("pool1", x, k=3, s=2)                        # ceil: 4x4
    a = b.conv_bn_relu("blk_1x1", x, 8, k=1)
    r = b.conv_bn_relu("blk_3x3_reduce", x, 8, k=1)
    c = b.conv_bn_relu("blk_3x3", r, 12, k=3, p=1)
    p = b.avg_pool("blk_pool", x, k=3, s=1, p=1)
    pp = b.conv_bn_relu("blk_pool_proj", p, 8, k=1)
    x = b.concat("blk_out", [a, c, pp])                         # 28 channels
    lo, hi = b.layer("blk_slice", "slice", x, tops=("blk_lo", "blk_hi"),
                     axis=1, slice_point=[12])
    x = b.concat("blk_swap", [hi, lo])
    x = b.conv_bn_relu("to3d", x, 8, k=1)
    x = b.layer("r2Dto3D", "unfold_segments", x, num_segments=S)  # (N, S, 4, 4, 8)
    res = b.conv("res_a", x, 16, k=(3, 3, 3), p=(1, 1, 1), lr=(1, 2), decay=(1, 0))
    y = b.relu("res_a_relu", b.bn("res_a_bn", res))
    y = b.conv("res_b", y, 16, k=(3, 3, 3), s=(2, 2, 2), p=(1, 1, 1))
    down = b.conv("res_down", res, 16, k=(3, 3, 3), s=(2, 2, 2), p=(1, 1, 1))
    x = b.eltwise_sum("res_sum", [y, down])
    x = b.relu("res_sum_relu", b.bn("res_sum_bn", x))
    x = b.layer("gpool", "global_avg_pool", x)
    x = b.dropout("drop", x, dropout)
    logits = b.fc("fc", x, CLASSES)
    b.layer("loss", "softmaxwithloss", (logits, "label"))
    b.layer("top1", "accuracy", (logits, "label"), phase="test", top_k=1)
    return b.build()


def _randomize(params, state, seed):
    """Non-trivial BN params, biases and running statistics."""
    rng = _rng(seed)
    out_p, out_s = {}, {}
    for ln, lp in params.items():
        out_p[ln] = dict(lp)
        for pn, v in lp.items():
            if pn == "gamma":
                out_p[ln][pn] = jnp.asarray(1 + 0.2 * rng.standard_normal(np.shape(v)), jnp.float32)
            elif pn in ("beta", "b"):
                out_p[ln][pn] = jnp.asarray(0.1 * rng.standard_normal(np.shape(v)), jnp.float32)
    for ln, ls in state.items():
        c = np.shape(ls["mean"])
        out_s[ln] = {"mean": jnp.asarray(0.3 * rng.standard_normal(c), jnp.float32),
                     "var": jnp.asarray(0.5 + rng.random(c), jnp.float32)}
    return out_p, out_s


@functools.cache
def _reference_weights(graph_name, seed):
    graph = {"small": _small_graph, "mini_train": _mini_train_graph}[graph_name]()
    shapes = {k: jnp.zeros(v, jnp.float32) for k, v in graph.inputs.items()}
    params, state = JaxProgram(graph, train=True).init(jax.random.PRNGKey(seed), shapes)
    return _randomize(params, state, seed)


def _shared_weights(graph, seed=0):
    """Reference init of the TRAIN program, randomized (built once per
    graph: the reference's init traces every layer), and the same trees
    through the bridge."""
    params, state = _reference_weights(graph.name, seed)
    return (params, state), params_from_jax(graph, params, state, device="cpu")


def _batch(graph, iter_size, seed=1):
    rng = _rng(seed)
    data_shape = graph.inputs["data"]
    n = data_shape[0]
    return {
        "data": rng.standard_normal((iter_size,) + tuple(data_shape)).astype(np.float32),
        "label": rng.integers(0, CLASSES if graph.name == "mini_train" else 3,
                              (iter_size, n)).astype(np.int32),
    }


def _run_both(graph, cfg_kw, steps, seed=0):
    """``steps`` solver steps of the reference (jitted) and the port from
    shared weights on the same batches; returns both final states and the
    per-step metrics."""
    (jp, js), (tp, ts_) = _shared_weights(graph, seed)
    jcfg, tcfg = JaxSolverConfig(**cfg_kw), SolverConfig(**cfg_kw)
    jstep = jax.jit(jax_make_train_step(JaxProgram(graph, train=True), jcfg))
    tstep = make_train_step(Program(graph, train=True, device="cpu"), tcfg)
    jts, tts = jax_init_train_state(jp, js), init_train_state(tp, ts_)
    jm, tm = [], []
    for i in range(steps):
        batch = _batch(graph, tcfg.iter_size, seed=10 + i)
        jts, m = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(i))
        jm.append({k: float(v) for k, v in m.items()})
        tts, m = tstep(tts, {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.Generator().manual_seed(i))
        tm.append({k: float(v) for k, v in m.items()})
    return jts, tts, jm, tm


@pytest.mark.parametrize("solver_type", ["sgd", "nesterov", "adagrad"])
def test_one_step_matches_jax(solver_type):
    """iter_size 2, a clip that bites, L2 decay, the graph's lr/decay
    multipliers and a frozen BN."""
    g = _small_graph()
    cfg = dict(base_lr=0.1, lr_policy="step", gamma=0.5, stepsize=1, momentum=0.9,
               weight_decay=0.01, clip_gradients=0.05, iter_size=2,
               solver_type=solver_type)
    jts, tts, jm, tm = _run_both(g, cfg, steps=2)
    assert tm[0]["grad_norm"] > 0.05  # the clip acted
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys() == {"loss", "lr", "grad_norm"}
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=G_RTOL, err_msg=k)
    assert tts.it == int(jts.it) == 2
    want_p, want_s = _np_tree(jts.params), _np_tree(jts.state)
    got_p, got_s = params_to_jax(g, tts.params, tts.state)
    _assert_np_trees_close(got_p, want_p, G_RTOL, ATOL)
    _assert_np_trees_close(got_s, want_s, G_RTOL, ATOL)
    got_h, _ = params_to_jax(g, tts.history, {})
    _assert_np_trees_close(got_h, _np_tree(jts.history), G_RTOL, ATOL)
    # the frozen BN kept its running statistics and its params
    (jp, js), _ = _shared_weights(g)
    np.testing.assert_array_equal(got_s["c1_bn"]["mean"], np.asarray(js["c1_bn"]["mean"]))
    np.testing.assert_array_equal(got_p["c1_bn"]["gamma"], np.asarray(jp["c1_bn"]["gamma"]))


def test_train_step_computes_its_gradients_whatever_the_grad_mode():
    g = _small_graph()
    _, (tp, ts_) = _shared_weights(g)
    step = make_train_step(Program(g, train=True, device="cpu"), SolverConfig(base_lr=0.1, iter_size=2))
    batch = {k: torch.from_numpy(v) for k, v in _batch(g, 2).items()}
    want, _ = step(init_train_state(tp, ts_), batch)
    with torch.no_grad():
        got, metrics = step(init_train_state(tp, ts_), batch)
    assert metrics["loss"].item() > 0
    for ln in want.params:
        for k in want.params[ln]:
            assert torch.equal(got.params[ln][k], want.params[ln][k]), (ln, k)
    assert not torch.equal(got.params["fc"]["w"], tp["fc"]["w"])


def test_mini_graph_gradients_match_jax():
    g = _mini_train_graph()
    (jp, js), (tp, ts_) = _shared_weights(g)
    batch = {k: v[0] for k, v in _batch(g, 1).items()}
    jprog = JaxProgram(g, train=True)

    def jloss(p):
        outs, new_state = jprog.apply(p, js, {k: jnp.asarray(v) for k, v in batch.items()})
        return jprog.total_loss(outs), new_state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    prog = Program(g, train=True, device="cpu")
    leaves = {ln: {k: v.clone().requires_grad_() for k, v in lp.items()} for ln, lp in tp.items()}
    outs, tstate = prog.apply(leaves, ts_, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert prog.loss_names == ["loss"] and "top1" not in outs
    loss = prog.total_loss(outs)
    keys = [(ln, k) for ln, lp in leaves.items() for k in lp]
    grads = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    gtree: dict = {}
    for (ln, k), gr in zip(keys, grads):
        gtree.setdefault(ln, {})[k] = gr
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    got_g, got_s = params_to_jax(g, gtree, tstate)
    _assert_np_trees_close(got_g, _np_tree(jgrads), G_RTOL, G_ATOL)
    _assert_np_trees_close(got_s, _np_tree(jstate), RTOL, ATOL)


def test_three_nesterov_steps_land_on_the_jax_params():
    g = _mini_train_graph()
    cfg = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9, weight_decay=5e-4,
               clip_gradients=40.0, iter_size=1, solver_type="nesterov")
    jts, tts, jm, tm = _run_both(g, cfg, steps=3)
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=G_RTOL)
    got_p, got_s = params_to_jax(g, tts.params, tts.state)
    _assert_np_trees_close(got_p, _np_tree(jts.params), 1e-4, 1e-6)
    _assert_np_trees_close(got_s, _np_tree(jts.state), 1e-4, 1e-6)


def test_train_step_draws_dropout_per_layer_and_step():
    g = _mini_train_graph(dropout=0.5)
    _, (tp, ts_) = _shared_weights(g)
    prog = Program(g, train=True, device="cpu")
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(g, 1).items()}
    loss = lambda seed: prog.apply(tp, ts_, batch, generator=torch.Generator().manual_seed(seed))[0]["loss"]
    assert loss(0).item() == loss(0).item()
    assert loss(0).item() != loss(1).item()
    with pytest.raises(ValueError, match="generator"):
        prog.apply(tp, ts_, batch)
    # TEST phase: dropout is the identity, the accuracy top is there
    outs, state = Program(g, device="cpu").apply(tp, ts_, batch)
    assert set(outs) == {"loss", "top1"} and state == ts_


def test_step_rejects_what_is_not_ported():
    g = _mini_train_graph()
    with pytest.raises(ValueError, match="remat policy"):
        make_train_step(Program(g, train=True, device="cpu"), SolverConfig(), remat="dot")
    with pytest.raises(ValueError, match="solver_type"):
        make_train_step(Program(g, train=True, device="cpu"), SolverConfig(solver_type="adam"))
    # Trainer(mesh=) trains over a DeviceMesh (tests/test_torch_parallel.py)
    with pytest.raises(TypeError, match="make_mesh"):
        Trainer(Program(g, train=True, device="cpu"), SolverConfig(), mesh=object())


def _raw_batch(iter_size, seed=3):
    """uint8 frames larger than the crop, per-video offsets at both edges
    and one mirror, with a leading micro-batch axis."""
    rng = _rng(seed)
    return {
        "data": rng.integers(0, 256, (iter_size, N, S, HW + 4, HW + 6, 3), dtype=np.uint8),
        "h_off": np.tile(np.array([0, 4], np.int32), (iter_size, 1)),
        "w_off": np.tile(np.array([6, 1], np.int32), (iter_size, 1)),
        "mirror": np.tile(np.array([True, False]), (iter_size, 1)),
        "label": rng.integers(0, CLASSES, (iter_size, N)).astype(np.int32),
    }


def test_raw_plane_train_and_eval_steps_match_jax():
    """The slice end to end on the mini-graph: uint8 frames through the
    crop/normalize plain version into a Nesterov step (iter_size 2), and a
    test pass, against the reference's RawPreprocessProgram with its Pallas
    kernel in interpret mode."""
    g = _mini_train_graph()
    (jp, js), (tp, ts_) = _shared_weights(g)
    cfg = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9, weight_decay=5e-4,
               clip_gradients=40.0, iter_size=2, solver_type="nesterov")
    batch = _raw_batch(2)
    jraw = JaxRawPreprocessProgram(JaxProgram(g, train=True), crop=HW)
    jts, jm = jax.jit(jax_make_train_step(jraw, JaxSolverConfig(**cfg)))(
        jax_init_train_state(jp, js), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    raw = RawPreprocessProgram(Program(g, train=True, device="cpu"), crop=HW)
    assert raw.loss_names == ["loss"] and raw.train and raw.graph is raw.inner.graph
    tts, tm = make_train_step(raw, SolverConfig(**cfg))(
        init_train_state(tp, ts_), {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=G_RTOL)
    got_p, got_s = params_to_jax(g, tts.params, tts.state)
    _assert_np_trees_close(got_p, _np_tree(jts.params), G_RTOL, 1e-6)
    _assert_np_trees_close(got_s, _np_tree(jts.state), G_RTOL, 1e-6)

    micro = {k: v[0] for k, v in batch.items()}
    want = jax_make_eval_step(JaxRawPreprocessProgram(JaxProgram(g, train=False), crop=HW))(
        jts.params, jts.state, {k: jnp.asarray(v) for k, v in micro.items()})
    got = make_eval_step(RawPreprocessProgram(Program(g, device="cpu"), crop=HW))(
        tts.params, tts.state, {k: torch.from_numpy(v) for k, v in micro.items()})
    assert got.keys() == want.keys() == {"loss", "top1"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=G_RTOL, err_msg=k)


def test_raw_plane_init_and_what_it_does_not_take():
    g = _mini_train_graph()
    raw = RawPreprocessProgram(Program(g, train=True, device="cpu"), crop=HW)
    batch = {k: torch.from_numpy(v[0]) for k, v in _raw_batch(1).items()}
    params, state = raw.init(torch.Generator().manual_seed(0), batch)
    want_p, _ = Program(g, train=True, device="cpu").init(torch.Generator().manual_seed(0),
                                            {"data": (N, S, HW, HW, 3), "label": (N,)})
    assert {ln: {k: tuple(v.shape) for k, v in lp.items()} for ln, lp in params.items()} == \
        {ln: {k: tuple(v.shape) for k, v in lp.items()} for ln, lp in want_p.items()}
    outs, _ = raw.apply(params, state, batch)
    assert outs["loss"].ndim == 0
    # a multi-scale batch takes the resize; at a full-size window it is the
    # same crop
    full = torch.full((N,), HW, dtype=torch.int32)
    scaled, _ = raw.apply(params, state, {**batch, "crop_h": full, "crop_w": full})
    assert torch.equal(scaled["loss"], outs["loss"])


# --------------------------------------------------------------------------
# checkpoints and the Trainer
# --------------------------------------------------------------------------


def test_checkpoints_cross_between_the_packages(tmp_path):
    g = _mini_train_graph()
    (jp, js), (tp, ts_) = _shared_weights(g)
    # port -> reference
    save_model(str(tmp_path / "port.model.npz"), tp, ts_)
    p, s = jckpt.load_model(str(tmp_path / "port.model.npz"))
    _assert_np_trees_close(p, _np_tree(jp), 0, 0)
    _assert_np_trees_close(s, _np_tree(js), 0, 0)
    # reference -> port
    jckpt.save_model(str(tmp_path / "ref.model.npz"), jp, js)
    p, s = load_model(str(tmp_path / "ref.model.npz"), device="cpu")
    for got, want in ((p, tp), (s, ts_)):
        for ln in want:
            for k in want[ln]:
                assert torch.equal(got[ln][k], want[ln][k]), (ln, k)
    # a solverstate written by the port resumes in the reference, and back
    ts = dataclasses.replace(init_train_state(tp, ts_), it=7)
    ts.history["fc"]["w"] = torch.ones_like(ts.history["fc"]["w"])
    _, sp = snapshot(str(tmp_path / "snap" / "eco"), ts, 7)
    jts = jckpt.restore(sp, jax_init_train_state(jp, js))
    assert int(jts.it) == 7
    np.testing.assert_array_equal(np.asarray(jts.history["fc"]["w"]),
                                  np.ones_like(np.asarray(jp["fc"]["w"])))
    _, sp2 = jckpt.snapshot(str(tmp_path / "jsnap" / "eco"), jts, 9)
    back = restore(sp2, init_train_state(tp, ts_))
    assert back.it == 9 and torch.equal(back.history["fc"]["w"], ts.history["fc"]["w"])
    assert torch.equal(back.params["stem"]["w"], tp["stem"]["w"])


def test_restore_weights_and_polyak(tmp_path):
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    half = {ln: {k: v * 0.5 for k, v in lp.items()} for ln, lp in tp.items()}
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_model(a, tp, ts_)
    save_model(b, {"fc": half["fc"], "unknown": {"w": torch.zeros(2, 2)}}, {})
    new_p, new_s, loaded = restore_weights(f"{a},{b}", half, ts_)
    assert loaded == sorted(tp)
    assert torch.equal(new_p["stem"]["w"], tp["stem"]["w"])     # from a
    assert torch.equal(new_p["fc"]["w"], half["fc"]["w"])       # b wins
    bad = {"fc": {"w": torch.zeros(3, 3), "b": torch.zeros(3)}}
    save_model(b, bad, {})
    with pytest.raises(ValueError, match="shape"):
        restore_weights([b], tp, ts_)
    save_model(b, half, ts_)
    avg_p, _ = polyak_average([a, b], out_path=str(tmp_path / "avg.npz"), device="cpu")
    torch.testing.assert_close(avg_p["fc"]["w"], tp["fc"]["w"] * 0.75)
    assert os.path.exists(tmp_path / "avg.npz")


def _trainer_batches(g, n, poison_at=None):
    for i in range(n):
        batch = {k: torch.from_numpy(v) for k, v in _batch(g, 1, seed=20 + i).items()}
        if i == poison_at:
            batch["data"] = torch.full_like(batch["data"], float("nan"))
        yield batch


def test_trainer_solves_tests_and_snapshots(tmp_path):
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    logs = []
    cfg = SolverConfig(base_lr=0.05, lr_policy="fixed", max_iter=4, display=2,
                       average_loss=2, snapshot=3, test_interval=2,
                       snapshot_prefix=str(tmp_path / "eco"))
    trainer = Trainer(Program(g, train=True, device="cpu"), cfg, test_program=Program(g, device="cpu"),
                      log_fn=logs.append)
    seen = []
    ts = trainer.solve(init_train_state(tp, ts_), _trainer_batches(g, 4),
                       test_iter_fn=lambda: (
                           {k: v[0] for k, v in b.items()} for b in _trainer_batches(g, 2)),
                       hooks=[lambda it, ts, m: seen.append((it, ts.it))])
    assert ts.it == 4 and seen == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert sum(l.startswith("Test: loss") for l in logs) == 1
    assert sum(l.startswith("Iteration") for l in logs) == 2
    assert sorted(os.listdir(tmp_path)) == [
        "eco_iter_3.model.npz", "eco_iter_3.solverstate.npz",
        "eco_iter_4.model.npz", "eco_iter_4.solverstate.npz"]
    metrics = trainer.test(ts, ({k: v[0] for k, v in b.items()} for b in _trainer_batches(g, 2)))
    assert set(metrics) == {"loss", "top1"} and np.isfinite(metrics["loss"])
    resumed = Trainer(Program(g, train=True, device="cpu"), dataclasses.replace(cfg, max_iter=5),
                      log_fn=logs.append).solve(
        init_train_state(tp, ts_), _trainer_batches(g, 1),
        resume_from=str(tmp_path / "eco_iter_4.solverstate.npz"))
    assert resumed.it == 5


@pytest.mark.parametrize("metrics_lag", [0, 1])
def test_trainer_non_finite_guard_snapshots_the_last_good_state(tmp_path, metrics_lag):
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    cfg = SolverConfig(base_lr=0.05, lr_policy="fixed", max_iter=6, snapshot=2,
                       snapshot_prefix=str(tmp_path / "eco"))
    trainer = Trainer(Program(g, train=True, device="cpu"), cfg, log_fn=lambda s: None,
                      metrics_lag=metrics_lag)
    # the NaN batch is step 1; its loss is read before the snapshot at it=2
    with pytest.raises(FloatingPointError, match="iteration 1"):
        trainer.solve(init_train_state(tp, ts_), _trainer_batches(g, 6, poison_at=1))
    files = sorted(os.listdir(tmp_path))
    assert not any(f.startswith("eco_iter") for f in files)
    if metrics_lag == 0:
        assert files == ["eco_lastgood_iter_1.model.npz", "eco_lastgood_iter_1.solverstate.npz"]
        p, _ = load_model(str(tmp_path / "eco_lastgood_iter_1.model.npz"), device="cpu")
        assert all(torch.isfinite(v).all() for lp in p.values() for v in lp.values())
    else:
        assert files == []  # the reference cannot re-read the pre-step state either
    with pytest.raises(ValueError, match="metrics_lag"):
        Trainer(Program(g, train=True, device="cpu"), cfg, metrics_lag=2)


def test_eval_step_returns_the_scalar_tops():
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(g, 1).items()}
    out = make_eval_step(Program(g, device="cpu"))(tp, ts_, batch)
    assert set(out) == {"loss", "top1"} and not out["loss"].requires_grad
