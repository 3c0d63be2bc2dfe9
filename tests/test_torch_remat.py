"""Rematerialization (``eco_tpu_torch/runtime/memory.py``) against the plain
step and against ``eco_tpu``'s ``make_train_step(remat=...)``.

On the CPU a recomputed region runs the same ops on the same inputs, so a
remat step gives the plain step's bits (``torch.equal``): the losses, the
updated params and the BN running statistics.  Against the reference the
mini-graph bound of ``tests/test_torch_train.py`` holds (a Nesterov step:
rtol 1e-4 / atol 1e-6 on the params).
"""

import dataclasses
import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.train import SolverConfig as JaxSolverConfig
from eco_tpu.train import init_train_state as jax_init_train_state
from eco_tpu.train import make_train_step as jax_make_train_step
from eco_tpu_torch.apps import RawPreprocessProgram
from eco_tpu_torch.apps import serving
from eco_tpu_torch.convert import params_to_jax
from eco_tpu_torch.runtime import Program, memory
from eco_tpu_torch.spec.graph import GraphSpec
from eco_tpu_torch.train import SolverConfig, Trainer, init_train_state, make_train_step
from test_torch_train import (
    HW,
    _assert_np_trees_close,
    _batch,
    _mini_train_graph,
    _np_tree,
    _raw_batch,
    _shared_weights,
)

CFG = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9, weight_decay=5e-4,
           clip_gradients=40.0, iter_size=2, solver_type="nesterov")


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


def _step(graph, remat, tp, ts_, batch, seed=3, wrap=None, cfg=CFG):
    prog = Program(graph, train=True, device="cpu")
    step = make_train_step(wrap(prog) if wrap else prog, SolverConfig(**cfg), remat=remat)
    return step(init_train_state(tp, ts_), {k: torch.as_tensor(v) for k, v in batch.items()},
                torch.Generator().manual_seed(seed))


def _assert_equal_trees(a, b):
    assert a.keys() == b.keys()
    for ln in a:
        assert a[ln].keys() == b[ln].keys(), ln
        for k in a[ln]:
            assert torch.equal(a[ln][k], b[ln][k]), (ln, k)


@functools.cache
def _dropout_steps(policy):
    """One step of the mini-graph with dropout 0.5 and iter_size 2."""
    g = _mini_train_graph(dropout=0.5)
    _, (tp, ts_) = _shared_weights(g)
    return _step(g, policy, tp, ts_, _batch(g, 2))


@pytest.mark.parametrize("policy", ["dots", "nothing", "everything"])
def test_remat_step_equals_the_plain_step(policy):
    """Dropout 0.5 and iter_size 2: a seed drawn inside a region would give
    the recomputed forward other masks, and the gradients would differ."""
    want, wm = _dropout_steps(None)
    got, gm = _dropout_steps(policy)
    assert torch.equal(gm["loss"], wm["loss"]) and torch.equal(gm["grad_norm"], wm["grad_norm"])
    _assert_equal_trees(got.params, want.params)
    _assert_equal_trees(got.history, want.history)
    _assert_equal_trees(got.state, want.state)


def test_remat_gradients_with_dropout_equal_the_plain_gradients():
    g = _mini_train_graph(dropout=0.5)
    _, (tp, ts_) = _shared_weights(g)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(g, 1).items()}
    grads = {}
    for policy in (None, "dots", "nothing"):
        prog = Program(g, train=True, device="cpu")
        leaves = {ln: {k: v.clone().requires_grad_() for k, v in lp.items()}
                  for ln, lp in tp.items()}
        apply = memory.apply_with_remat(prog, policy)
        outs, _ = apply(leaves, ts_, batch, generator=torch.Generator().manual_seed(5))
        flat = [leaves[ln][k] for ln in sorted(leaves) for k in sorted(leaves[ln])]
        grads[policy] = torch.autograd.grad(prog.total_loss(outs), flat)
    for policy in ("dots", "nothing"):
        assert all(torch.equal(a, b) for a, b in zip(grads[policy], grads[None])), policy


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_step_lands_on_the_jax_remat_params(policy):
    g = _mini_train_graph()
    (jp, js), (tp, ts_) = _shared_weights(g)
    cfg = {**CFG, "iter_size": 1}
    jstep = jax.jit(jax_make_train_step(JaxProgram(g, train=True), JaxSolverConfig(**cfg),
                                        remat=policy))
    tstep = make_train_step(Program(g, train=True, device="cpu"), SolverConfig(**cfg),
                            remat=policy)
    batch = _batch(g, 1, seed=10)
    jts, jm = jstep(jax_init_train_state(jp, js), {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(0))
    tts, tm = tstep(init_train_state(tp, ts_), {k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    got_p, got_s = params_to_jax(g, tts.params, tts.state)
    _assert_np_trees_close(got_p, _np_tree(jts.params), 1e-4, 1e-6)
    _assert_np_trees_close(got_s, _np_tree(jts.state), 1e-4, 1e-6)


class _Products(TorchDispatchMode):
    """Weak references to the memory of the products "dots" keeps (their
    storages: the checkpoint caches detached aliases), and a count of the
    forward convolutions run."""

    def __init__(self):
        super().__init__()
        self.outputs, self.convs = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                    torch.ops.aten.addmm.default):
            self.outputs.append(weakref.ref(out.untyped_storage()))
            self.convs += func is torch.ops.aten.convolution.default
        return out


@pytest.mark.parametrize("policy,kept", [(None, 0), ("dots", 10), ("nothing", 0)])
def test_dots_keeps_the_products_and_no_policy_runs_a_conv_again(policy, kept):
    """After the forward pass of the mini-graph (9 convolutions and the fc's
    product, each before its bias), "dots" holds all 10 products and the
    other policies none.  The backward pass runs no forward convolution
    under any policy: a region closes with its conv or fc, whose backward
    needs its inputs, not its output, and the recompute stops once the last
    saved tensor is back."""
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(g, 1).items()}
    prog = Program(g, train=True, device="cpu")
    leaves = {ln: {k: v.clone().requires_grad_() for k, v in lp.items()}
              for ln, lp in tp.items()}
    with _Products() as forward:
        outs, _ = memory.apply_with_remat(prog, policy)(leaves, ts_, batch)
    assert forward.convs == 9 and len(forward.outputs) == 10
    assert sum(ref() is not None for ref in forward.outputs) == kept
    with _Products() as backward:
        prog.total_loss(outs).backward()
    assert backward.convs == 0


def test_regions_end_at_every_conv_and_fc():
    g = _mini_train_graph()
    layers = Program(g, train=True, device="cpu").exec_layers
    parts = memory.regions(layers)
    assert [i for part in parts for i in part] == list(range(len(layers)))
    assert len(parts) == 11  # 9 convolutions, the fc, then the loss
    for part in parts[:-1]:
        assert layers[part[-1]].type in ("convolution", "innerproduct")
        assert all(layers[i].type not in ("convolution", "innerproduct") for i in part[:-1])


def test_the_crop_kernel_stays_outside_the_regions(monkeypatch):
    """The raw plane's clips are made before the wrapped program runs: a
    backward pass never launches the crop kernel again."""
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    calls = []
    kernel = serving.preprocess_on_device
    monkeypatch.setattr(serving, "preprocess_on_device",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    wrap = lambda prog: RawPreprocessProgram(prog, crop=HW)
    cfg = {**CFG, "iter_size": 1}
    want, _ = _step(g, None, tp, ts_, _raw_batch(1), wrap=wrap, cfg=cfg)
    assert len(calls) == 1
    got, _ = _step(g, "dots", tp, ts_, _raw_batch(1), wrap=wrap, cfg=cfg)
    assert len(calls) == 2
    _assert_equal_trees(got.params, want.params)


def test_trainer_auto_picks_dots_from_mem_param_and_rejects_unknown_policies():
    g = _mini_train_graph()
    mem = GraphSpec(g.name, dict(g.inputs), list(g.layers),
                    {"mem_param": {"optimize_train": True}})
    assert Trainer(Program(mem, train=True, device="cpu"), SolverConfig()).remat == "dots"
    assert Trainer(Program(g, train=True, device="cpu"), SolverConfig()).remat is None
    assert memory.remat_policy_from_graph(
        dataclasses.replace(g, options={"mem_param": {"optimize_test": True}})) is None
    with pytest.raises(ValueError, match="remat policy"):
        make_train_step(Program(g, train=True, device="cpu"), SolverConfig(), remat="dot")


def test_remat_keeps_the_first_forward_bn_statistics():
    """A recompute writes its BN statistics into a context of its own: what
    apply returned is the first forward's, and the state the step hands on
    equals the plain step's (checked above); here the returned tree is not
    changed by the backward pass."""
    g = _mini_train_graph()
    _, (tp, ts_) = _shared_weights(g)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(g, 1).items()}
    prog = Program(g, train=True, device="cpu")
    leaves = {ln: {k: v.clone().requires_grad_() for k, v in lp.items()}
              for ln, lp in tp.items()}
    outs, state = memory.apply_with_remat(prog, "nothing")(leaves, ts_, batch)
    before = {ln: {k: v.clone() for k, v in ls.items()} for ln, ls in state.items()}
    prog.total_loss(outs).backward()
    _assert_equal_trees(state, before)
