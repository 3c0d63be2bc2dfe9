"""ECO-Full in eco_tpu_torch against eco_tpu, and its segment consensus.

ECO-Full at 7 classes, S=4, crop 224 (its 7x7 average pool needs 224),
batch 1, f32: the port runs the reference's own graph, before and after
``optimize_for_inference``, on weights carried over by ``params_from_jax``
with the BN statistics perturbed so that the fold matters.  The logits (the
fc top: random-weight probabilities sit near uniform) agree to a max abs
error of 1.7e-6 plain and 1.1e-6 optimized, on logits of magnitude ~4.5
(~180 f32 layers summed in other orders); held to rtol 1e-4 / atol 1e-5,
where the worst element uses 0.12 of its tolerance.  The reference's eager
apply of this graph takes ~10 s, so one result is shared by the module.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eco_tpu.convert import optimize_for_inference as jax_optimize
from eco_tpu.models import build_eco_full
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import GraphSpec, LayerSpec
from eco_tpu_torch.convert import optimize_for_inference, params_from_jax, params_to_jax
from eco_tpu_torch.runtime import Program

from tests.test_torch_executor import _layers, _randomize

S, CROP = 4, 224


@pytest.fixture(scope="module")
def full():
    """ECO-Full, its weights in the reference's layout (drawn by the port's
    seeded init, BN perturbed from a numpy seed), a numpy input, and the
    reference's logits."""
    g = build_eco_full(7, S, crop_size=CROP, batch=1)
    tp, ts = Program(g, device="cpu").init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]})
    params, state = _randomize(*params_to_jax(g, tp, ts), seed=0)
    x = (np.random.default_rng(1).standard_normal(g.inputs["data"]) * 50).astype(np.float32)
    want = JaxProgram(g, train=False).apply(params, state, {"data": jnp.asarray(x)},
                                            capture=["fc8N"])[0]["fc8N"]
    return g, params, state, x, np.asarray(want)


@pytest.mark.parametrize("optimized", [False, True])
def test_eco_full_matches_jax(full, optimized):
    g, params, state, x, want = full
    tp, ts = params_from_jax(g, params, state, device="cpu")
    if optimized:
        g_opt, tp, ts = optimize_for_inference(g, tp, ts)
        assert _layers(g_opt) == _layers(jax_optimize(g, params, state)[0])
        g = g_opt
    prog = Program(g, device="cpu")
    if optimized:
        assert len(prog.exec_layers) == 179
    with torch.no_grad():
        got = prog.apply(tp, ts, {"data": torch.from_numpy(x)}, capture=["fc8N"])[0]
    assert tuple(got["fc8N"].shape) == (1, 7) and tuple(got["probs"].shape) == (1, 7)
    np.testing.assert_allclose(got["fc8N"].numpy(), want, rtol=1e-4, atol=1e-5)


def test_eco_full_graph_shape():
    """The pieces the port had to run: the shared 3c double-3x3-1 top feeds
    both the 3D head and the 2D branch, the 2D features come first in the
    concat before the fc, and the 2D branch ends in a 7x7 AVE pool and the
    segment consensus."""
    g = build_eco_full(7, S, crop_size=CROP, batch=1)
    shared = "inception_3c_double_3x3_1_bn"
    assert {l.name for l in g.layers if shared in l.bottoms} >= {
        "r2Dto3D", "inception_3c_double_3x3_2"}
    assert g.layer("gn02_concat").bottoms[0] == g.layer("segment_consensus_st2").tops[0]
    pool = g.layer("global_pool2D")
    assert (pool.opt("pool"), pool.opt("kernel_size")) == ("ave", 7)
    out, _ = Program(g, device="cpu").apply(
        *Program(g, device="cpu").init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]}),
        {"data": torch.zeros(g.inputs["data"])}, capture=["global_pool2D", "pool_fusion_st2D"])
    assert tuple(out["global_pool2D"].shape) == (S, 1, 1, 1024)
    assert tuple(out["pool_fusion_st2D"].shape) == (1, 1024)


@pytest.mark.parametrize("shape", [(2 * 3, 2, 3, 5), (2 * 3, 5)])
def test_segment_consensus_matches_jax_with_gradient(shape):
    """The executor layer (global average pool when rank > 2, then the mean
    over 3 segments) and its gradient against jax.grad."""
    g = GraphSpec("consensus", {"x": shape}, [
        LayerSpec("cons", "segment_consensus", ("x",), ("y",), {"num_segments": 3})])
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal((2, 5)).astype(np.float32)
    jprog = JaxProgram(g, train=False)

    def loss(v):
        return jnp.sum(jprog.apply({}, {}, {"x": v})[0]["y"] * cot)

    want_y = np.asarray(jprog.apply({}, {}, {"x": jnp.asarray(x)})[0]["y"])
    want_dx = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        y = Program(g, device="cpu").apply({}, {}, {"x": tx})[0]["y"]
        (dx,) = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), tx)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-6, atol=1e-8)
