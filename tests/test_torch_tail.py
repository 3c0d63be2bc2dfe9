"""The rest of Caffe's layer catalogue in eco_tpu_torch against eco_tpu: the
35 layer types the port's executor had no implementation for, their ops,
the CaffeNet-shaped path, ``mini_flow.prototxt``'s TRAIN step, the
``online`` subcommand and the weight bridge over every tail layer with
params.

Every case runs the JAX function (or ``eco_tpu``'s ``Program``) and its port
on the same seeded numpy inputs, on the CPU, with the reference's params
carried across by ``params_from_jax``; gradients are held where the layer
has them (a random cotangent on every float output, through the params and
the float inputs).

Tolerances (f32, both on the CPU): layers that move or select values
(permute, silence, gather, scatter, threshold, argmax, im2col, filter, ROI
max, SPP's max, constant DummyData) must be equal.  Everything else is held
to rtol 1e-5 / atol 1e-6 (XLA and ATen sum and take libm functions in other
orders: single layers agree to a few ulps), unless its case states more:
MVN and Normalize divide by a root of a sum (rtol 1e-4), the deconvolutions
and LRN sum many terms (rtol/atol 1e-5 and 2e-5), and their gradients, which
sum over the batch and the kernel, are held to rtol 1e-4 / atol 1e-5.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from eco_tpu import ops as jops
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.runtime.executor import IMPLS as JAX_IMPLS
from eco_tpu.runtime.init import _fans as jax_fans
from eco_tpu.spec.graph import GraphSpec as JaxGraphSpec
from eco_tpu.spec.graph import LayerSpec as JaxLayerSpec
from eco_tpu.spec.prototxt import graph_from_prototxt as jax_graph_from_prototxt
from eco_tpu.train import SolverConfig as JaxSolverConfig
from eco_tpu.train import init_train_state as jax_init_train_state
from eco_tpu.train import make_train_step as jax_make_train_step
from eco_tpu_torch import ops
from eco_tpu_torch.convert import params_from_jax, params_to_jax
from eco_tpu_torch.runtime import IMPLS, Program, get_impl
from eco_tpu_torch.runtime import memory
from eco_tpu_torch.runtime.executor import Context
from eco_tpu_torch.runtime.init import _fans, fill
from eco_tpu_torch.spec.graph import LayerSpec
from eco_tpu_torch.spec.prototxt import graph_from_prototxt
from eco_tpu_torch.train import SolverConfig, init_train_state, make_train_step

RTOL, ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-5
CTX = Context(device="cpu")


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(shape, seed=0, scale=1.0, shift=0.0):
    return np.asarray(_rng(seed).standard_normal(shape) * scale + shift, np.float32)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _vjp_both(jfn, tfn, args, cot_seed=7):
    """Values and input gradients of ``jfn`` (JAX) and ``tfn`` (the port) on
    the same numpy ``args`` under one random cotangent."""
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    cot = _f32(np.shape(want), cot_seed)
    want_g = vjp(jnp.asarray(cot))
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tfn(*xs)
    got_g = torch.autograd.grad(got, xs, torch.from_numpy(cot))
    return (np.asarray(want), want_g), (got, got_g)


# --------------------------------------------------------------------------
# ops (the cases of tests/test_ops.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("groups,shape,w_shape,kw", [
    (1, (2, 7, 7, 6), (6, 8, 4, 4), dict(stride=2, pad=1)),
    (2, (2, 5, 5, 6), (6, 2, 3, 3), dict(stride=2, pad=1)),
    (2, (2, 3, 4, 5, 4), (4, 3, 2, 3, 3), dict(stride=(1, 2, 2), pad=(0, 1, 1), dilation=(1, 2, 1))),
])
def test_deconv_and_grouped_deconv_match_jax(groups, shape, w_shape, kw):
    """Caffe/torch ConvTranspose, out = s*(in-1) + d*(k-1) + 1 - 2p; the port's
    weight (C_in, C_out/g, *k) is the reference's (*k, C_in, C_out/g)
    transposed.  Values and gradients of x and w (rtol/atol 1e-5, 1e-4/1e-5)."""
    x, w = _f32(shape, 1), _f32(w_shape, 2, 0.1)
    nsp = len(shape) - 2
    to_jax = tuple(range(2, 2 + nsp)) + (0, 1)
    (want, want_g), (got, got_g) = _vjp_both(
        lambda x, w: jops.conv_nd(x, jnp.transpose(w, to_jax), groups=groups, transposed=True,
                                  **kw),
        lambda x, w: ops.conv_nd(x, w, groups=groups, transposed=True, **kw), [x, w])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(wg), rtol=G_RTOL, atol=G_ATOL)


def test_conv2d_and_conv3d_are_the_reference_names():
    x2, w2 = _f32((2, 6, 6, 3), 1), _f32((4, 3, 3, 3), 2)
    x3, w3 = _f32((2, 3, 5, 5, 3), 3), _f32((4, 3, 2, 3, 3), 4)
    np.testing.assert_allclose(
        _np(ops.conv2d(torch.from_numpy(x2), torch.from_numpy(w2), pad=1)),
        np.asarray(jops.conv2d(jnp.asarray(x2), jnp.asarray(w2.transpose(2, 3, 1, 0)), pad=1)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _np(ops.conv3d(torch.from_numpy(x3), torch.from_numpy(w3), stride=(1, 2, 2))),
        np.asarray(jops.conv3d(jnp.asarray(x3), jnp.asarray(w3.transpose(2, 3, 4, 1, 0)),
                               stride=(1, 2, 2))),
        rtol=RTOL, atol=ATOL)


def test_threshold_and_bnll_match_jax():
    x = np.asarray([[-2.0, -0.1, 0.0, 0.1, 3.0]], np.float32)
    for t in (0.0, 0.5):
        np.testing.assert_array_equal(_np(ops.threshold(torch.from_numpy(x), t)),
                                      np.asarray(jops.threshold(jnp.asarray(x), t)))
    big = np.asarray([[-50.0, -3.0, 0.0, 0.7, 50.0]], np.float32)
    (want, want_g), (got, got_g) = _vjp_both(jops.bnll, ops.bnll, [big])
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got_g[0]), np.asarray(want_g[0]), rtol=RTOL, atol=ATOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("kw", [{}, {"across_channels": True},
                                {"normalize_variance": False}, {"eps": 1e-3}])
def test_mvn_matches_jax(kw):
    """eps outside the sqrt, var = E[x^2] - E[x]^2 (rtol 1e-4: a division by
    the root of a difference of sums)."""
    x = _f32((2, 4, 5, 3), 4, 2.0, 1.0)
    (want, want_g), (got, got_g) = _vjp_both(lambda x: jops.mvn(x, **kw),
                                             lambda x: ops.mvn(x, **kw), [x])
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got_g[0]), np.asarray(want_g[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(local_size=5, alpha=1e-4, beta=0.75),
                                dict(local_size=3, alpha=2.0, beta=0.5, k=2.0)])
def test_lrn_matches_jax(kw):
    x = _f32((2, 5, 4, 9), 5, 3.0)
    (want, want_g), (got, got_g) = _vjp_both(lambda x: jops.elementwise.lrn(x, **kw),
                                             lambda x: ops.lrn(x, **kw), [x])
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got_g[0]), np.asarray(want_g[0]), rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("shape,k,kw", [((2, 7, 7, 3), 3, dict(stride=2, pad=1)),
                                        ((1, 6, 5, 2), (2, 3), dict(dilation=2)),
                                        ((1, 3, 5, 4, 2), 2, dict(stride=(1, 2, 1)))])
def test_im2col_matches_jax(shape, k, kw):
    x = _f32(shape, 6)
    want = np.asarray(jops.im2col(jnp.asarray(x), k, **kw))
    got = ops.im2col(torch.from_numpy(x), k, **kw)
    np.testing.assert_array_equal(_np(got), want)


def _labels(n, classes, seed=8):
    return _rng(seed).integers(0, classes, n).astype(np.int32)


def test_hinge_loss_matches_jax():
    x, labels = _f32((4, 5), 9), _labels(4, 5)
    for norm in ("L1", "L2"):
        (want, want_g), (got, got_g) = _vjp_both(
            lambda x: jops.hinge_loss(x, jnp.asarray(labels), norm=norm),
            lambda x: ops.hinge_loss(x, torch.from_numpy(labels), norm=norm), [x])
        np.testing.assert_allclose(_np(got), want, rtol=RTOL)
        np.testing.assert_allclose(_np(got_g[0]), np.asarray(want_g[0]), rtol=RTOL, atol=ATOL)


def test_sigmoid_cross_entropy_matches_jax():
    x = _f32((3, 6), 10, 3.0)
    t = (_rng(11).uniform(size=(3, 6)) > 0.5).astype(np.float32)
    (want, want_g), (got, got_g) = _vjp_both(jops.sigmoid_cross_entropy,
                                             ops.sigmoid_cross_entropy, [x, t])
    np.testing.assert_allclose(_np(got), want, rtol=RTOL)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(wg), rtol=RTOL, atol=ATOL)


def test_infogain_loss_matches_jax():
    probs = np.abs(_f32((3, 4), 12)) + 0.1
    probs /= probs.sum(-1, keepdims=True)
    labels = np.asarray([1, 0, 3], np.int32)
    for H in (np.eye(4, dtype=np.float32), np.abs(_f32((4, 4), 13))):
        (want, want_g), (got, got_g) = _vjp_both(
            lambda p, h: jops.infogain_loss(p, jnp.asarray(labels), h),
            lambda p, h: ops.infogain_loss(p, torch.from_numpy(labels), h), [probs, H])
        np.testing.assert_allclose(_np(got), want, rtol=RTOL)
        for g, wg in zip(got_g, want_g):
            np.testing.assert_allclose(_np(g), np.asarray(wg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("legacy", [False, True])
def test_contrastive_loss_matches_jax(legacy):
    a, b = _f32((4, 6), 14), _f32((4, 6), 15)
    y = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    kw = dict(margin=1.5 if not legacy else 20.0, legacy=legacy)
    (want, want_g), (got, got_g) = _vjp_both(
        lambda a, b: jops.contrastive_loss(a, b, jnp.asarray(y), **kw),
        lambda a, b: ops.contrastive_loss(a, b, torch.from_numpy(y), **kw), [a, b])
    np.testing.assert_allclose(_np(got), want, rtol=RTOL)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(wg), rtol=RTOL, atol=ATOL)


def test_stochastic_pool_test_mode_matches_jax():
    """StoPoolForwardTest over the windows of extract_pool_windows, the
    clipped last window included."""
    x = np.abs(_f32((2, 5, 5, 3), 16))
    for k, s in ((2, 2), (3, 2)):
        np.testing.assert_allclose(
            _np(ops.stochastic_pool(torch.from_numpy(x), k, s, train=False)),
            np.asarray(jops.stochastic_pool(jnp.asarray(x), k, s, train=False)),
            rtol=RTOL, atol=ATOL)
    from eco_tpu.ops.pool import extract_pool_windows as jax_windows

    np.testing.assert_array_equal(
        _np(ops.pool.extract_pool_windows(torch.from_numpy(x), 3, 2)),
        np.asarray(jax_windows(jnp.asarray(x), 3, 2)))


def test_max_and_avg_pool_are_the_reference_names():
    x = _f32((2, 9, 9, 3), 17)
    np.testing.assert_array_equal(_np(ops.max_pool(torch.from_numpy(x), 3, 2)),
                                  np.asarray(jops.max_pool(jnp.asarray(x), 3, 2)))
    np.testing.assert_allclose(_np(ops.avg_pool(torch.from_numpy(x), 3, 2, 1)),
                               np.asarray(jops.avg_pool(jnp.asarray(x), 3, 2, 1)),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# The 35 layer types through both Programs
# --------------------------------------------------------------------------


def _graph(layers, inputs):
    return JaxGraphSpec("tail", {k: tuple(np.shape(v)) for k, v in inputs.items()},
                        [JaxLayerSpec(*l) for l in layers])


def _randomize(params, seed):
    """Every param drawn anew (fillers leave biases and slopes constant)."""
    rng = _rng(seed)
    return {ln: {k: jnp.asarray(0.5 * rng.standard_normal(np.shape(v)), jnp.float32)
                 for k, v in lp.items()} for ln, lp in params.items()}


def _state_randomize(state, seed):
    rng = _rng(seed)
    return {ln: {k: jnp.asarray((0.3 * rng.standard_normal(np.shape(v)) if k == "mean"
                                 else 0.5 + rng.random(np.shape(v))), jnp.float32)
                 for k, v in ls.items()} for ln, ls in state.items()}


def _tree(keys, values):
    out: dict = {}
    for (ln, k), v in zip(keys, values):
        out.setdefault(ln, {})[k] = v if v is not None else None
    return out


def run_both(layers, inputs, *, train=False, wrt=(), seed=0):
    """The graph of ``layers`` over ``inputs`` in both Programs on shared
    (randomized) params; the outputs, new states and gradients of both."""
    graph = _graph(layers, inputs)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jprog = JaxProgram(graph, train=train)
    jp, js = jprog.init(jax.random.PRNGKey(0), jin)
    jp, js = _randomize(jp, seed), _state_randomize(js, seed + 1)
    tp, ts = params_from_jax(graph, jp, js, device="cpu")
    tprog = Program(graph, train=train, device="cpu")

    def jfn(p, xs):
        return jprog.apply(p, js, {**jin, **xs}, rng=jax.random.PRNGKey(1))

    jouts, jstate = jfn(jp, {k: jin[k] for k in wrt})
    keys = [(ln, k) for ln, lp in tp.items() for k in lp]
    leaves = [tp[ln][k].clone().requires_grad_() for ln, k in keys]
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    xs = [tin[k].clone().requires_grad_() for k in wrt]
    touts, tstate = tprog.apply(_tree(keys, leaves), ts, {**tin, **dict(zip(wrt, xs))})
    assert set(touts) == set(jouts), (set(touts), set(jouts))
    floats = [k for k in jouts if jnp.issubdtype(jouts[k].dtype, jnp.floating)]
    result = {"outs": (jouts, touts), "state": (jstate, tstate), "graph": graph}
    if (keys or wrt) and floats:
        cots = {k: _f32(np.shape(jouts[k]), 100 + i) for i, k in enumerate(floats)}

        def jscalar(p, xs):
            outs, _ = jfn(p, xs)
            return sum(jnp.sum(outs[k] * cots[k]) for k in floats)

        jg_p, jg_x = jax.grad(jscalar, argnums=(0, 1))(jp, {k: jin[k] for k in wrt})
        tscalar = sum((touts[k] * torch.from_numpy(cots[k])).sum() for k in floats)
        grads = torch.autograd.grad(tscalar, leaves + xs, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves + xs, grads)]
        result["grads"] = ((jg_p, jg_x),
                           (_tree(keys, grads[:len(keys)]), dict(zip(wrt, grads[len(keys):]))))
    return result


def assert_both_agree(result, *, exact=False, rtol=RTOL, atol=ATOL, g_rtol=RTOL, g_atol=ATOL):
    jouts, touts = result["outs"]
    for k in jouts:
        want, got = np.asarray(jouts[k]), touts[k].detach()
        assert tuple(got.shape) == want.shape, (k, tuple(got.shape), want.shape)
        if exact or want.dtype == bool:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(_np(got), want.astype(np.float32), rtol=rtol, atol=atol,
                                       err_msg=k)
    jstate, tstate = result["state"]
    _, got_s = params_to_jax(result["graph"], {}, tstate)
    for ln in jstate:
        for k in jstate[ln]:
            np.testing.assert_allclose(got_s[ln][k], np.asarray(jstate[ln][k]), rtol=rtol,
                                       atol=atol, err_msg=f"state {ln}/{k}")
    if "grads" in result:
        (jg_p, jg_x), (tg_p, tg_x) = result["grads"]
        got_p, _ = params_to_jax(result["graph"], tg_p, {})
        for ln in jg_p:
            for k in jg_p[ln]:
                np.testing.assert_allclose(got_p[ln][k], np.asarray(jg_p[ln][k]), rtol=g_rtol,
                                           atol=g_atol, err_msg=f"grad {ln}/{k}")
        for k in jg_x:
            np.testing.assert_allclose(_np(tg_x[k]), np.asarray(jg_x[k]), rtol=g_rtol,
                                       atol=g_atol, err_msg=f"grad {k}")


X2 = _f32((2, 6, 7, 4), 20)           # (N, H, W, C)
X3 = _f32((2, 3, 5, 5, 4), 21)        # (N, D, H, W, C)
POS = np.abs(_f32((2, 6, 7, 4), 22)) + 0.5
LOGITS = _f32((4, 5), 23, 2.0)
LABELS = _labels(4, 5)
PROBS = (np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)).astype(np.float32)
ROIS = np.array([[0, 1, 2, 8, 6], [1, 0, 0, 10, 8], [0, 5, 5, 5, 5], [1, 3, 1, 4, 7]],
                np.float32)
FM = _f32((2, 9, 11, 4), 24)


def _one(ltype, bottoms=("x",), tops=("y",), **opts):
    return [("l", ltype, tuple(bottoms), tuple(tops), opts)]


# name: (layers, inputs, the float inputs to differentiate, train, tolerances)
LAYER_CASES = {
    "deconvolution_2d": (_one("deconvolution", num_output=6, kernel_size=4, stride=2, pad=1),
                         {"x": X2}, ("x",), False, dict(rtol=1e-5, atol=1e-5, g_rtol=G_RTOL,
                                                        g_atol=G_ATOL)),
    "deconvolution_grouped": (_one("deconvolution", num_output=6, kernel_size=3, stride=2,
                                   pad=1, group=2),
                              {"x": X2}, ("x",), False, dict(rtol=1e-5, atol=1e-5,
                                                             g_rtol=G_RTOL, g_atol=G_ATOL)),
    "deconvolution_3d": (_one("deconvolution", num_output=3, kernel_size=[2, 3, 3],
                              stride=[1, 2, 2], pad=[0, 1, 1], bias_term=False),
                         {"x": X3}, ("x",), False, dict(rtol=1e-5, atol=1e-5, g_rtol=G_RTOL,
                                                        g_atol=G_ATOL)),
    "permute_2d": (_one("permute", order=[0, 2, 3, 1]), {"x": X2}, ("x",), False,
                   dict(exact=True)),
    "permute_3d": (_one("permute", order=[0, 2, 1, 3, 4]), {"x": X3}, ("x",), False,
                   dict(exact=True)),
    "power": (_one("power", power=2.0, scale=0.5, shift=1.5), {"x": X2}, ("x",), False, {}),
    "power_linear": (_one("power", scale=-2.0, shift=0.25), {"x": X2}, ("x",), False, {}),
    "silence": (_one("silence", tops=()), {"x": X2}, (), False, {}),
    "bias_param": (_one("bias"), {"x": X2}, ("x",), False, {}),
    "bias_param_tail_axes": (_one("bias", axis=1, num_axes=-1), {"x": X2}, ("x",), False, {}),
    "bias_two_bottoms": (_one("bias", bottoms=("x", "b"), axis=0),
                         {"x": X2, "b": _f32((2,), 25)}, ("x", "b"), False, {}),
    "gather": (_one("gather"), {"x": X2}, ("x",), False, dict(exact=True)),
    "scatter": (_one("scatter"), {"x": X2}, ("x",), False, dict(exact=True)),
    "sigmoid": (_one("sigmoid"), {"x": X2}, ("x",), False, {}),
    "tanh": (_one("tanh"), {"x": X2}, ("x",), False, {}),
    "absval": (_one("absval"), {"x": X2}, ("x",), False, {}),
    "exp": (_one("exp"), {"x": X2}, ("x",), False, {}),
    "exp_base": (_one("exp", base=2.0, scale=0.5, shift=0.1), {"x": X2}, ("x",), False, {}),
    "log": (_one("log"), {"x": POS}, ("x",), False, {}),
    "log_base": (_one("log", base=10.0, scale=2.0, shift=5.0), {"x": POS}, ("x",), False, {}),
    "bnll": (_one("bnll"), {"x": X2 * 20}, ("x",), False, {}),
    "threshold": (_one("threshold", threshold=0.1), {"x": X2}, (), False, dict(exact=True)),
    "argmax": (_one("argmax"), {"x": X2}, (), False, dict(exact=True)),
    "lrn": (_one("lrn", local_size=3, alpha=0.5, beta=0.75), {"x": X2}, ("x",), False,
            dict(rtol=1e-5, atol=2e-5, g_rtol=G_RTOL, g_atol=G_ATOL)),
    "mvn": (_one("mvn"), {"x": X2}, ("x",), False, dict(rtol=1e-4, atol=1e-5, g_rtol=1e-4,
                                                        g_atol=1e-4)),
    "mvn_across_channels": (_one("mvn", across_channels=True, eps=1e-3), {"x": X3}, ("x",),
                            False, dict(rtol=1e-4, atol=1e-5, g_rtol=1e-4, g_atol=1e-4)),
    "prelu": (_one("prelu"), {"x": X2}, ("x",), False, {}),
    "prelu_channel_shared": (_one("prelu", channel_shared=True), {"x": X3}, ("x",), False, {}),
    "batchnorm_train": (_one("batchnorm", moving_average_fraction=0.9), {"x": X2}, ("x",), True,
                        dict(rtol=1e-5, atol=1e-5, g_rtol=G_RTOL, g_atol=G_ATOL)),
    "batchnorm_global_stats": (_one("batchnorm", use_global_stats=True), {"x": X3}, ("x",),
                               True, {}),
    "batchnorm_test": (_one("batchnorm"), {"x": X2}, ("x",), False, {}),
    "euclideanloss": (_one("euclideanloss", bottoms=("a", "b")),
                      {"a": LOGITS, "b": _f32((4, 5), 26)}, ("a", "b"), False, {}),
    "hingeloss_l1": (_one("hingeloss", bottoms=("x", "label")),
                     {"x": LOGITS, "label": LABELS}, ("x",), False, {}),
    "hingeloss_l2": (_one("hingeloss", bottoms=("x", "label"), norm="L2"),
                     {"x": LOGITS, "label": LABELS}, ("x",), False, {}),
    "sigmoidcrossentropyloss": (_one("sigmoidcrossentropyloss", bottoms=("x", "t")),
                                {"x": LOGITS,
                                 "t": (_rng(27).random((4, 5)) > 0.5).astype(np.float32)},
                                ("x",), False, {}),
    "infogainloss": (_one("infogainloss", bottoms=("p", "label", "H")),
                     {"p": PROBS, "label": LABELS, "H": np.abs(_f32((5, 5), 28))},
                     ("p", "H"), False, {}),
    "contrastiveloss": (_one("contrastiveloss", bottoms=("a", "b", "sim"), margin=3.0),
                        {"a": LOGITS, "b": _f32((4, 5), 29),
                         "sim": np.asarray([1, 0, 0, 1], np.float32)}, ("a", "b"), False, {}),
    "multinomiallogisticloss": (_one("multinomiallogisticloss", bottoms=("p", "label")),
                                {"p": PROBS, "label": LABELS}, ("p",), False, {}),
    "smoothl1loss": (_one("smoothl1loss", bottoms=("a", "b")),
                     {"a": LOGITS, "b": _f32((4, 5), 30)}, ("a", "b"), False, {}),
    "smoothl1loss_weighted": (_one("smoothl1loss", bottoms=("a", "b", "w")),
                              {"a": LOGITS, "b": _f32((4, 5), 30), "w": np.abs(_f32((4, 5), 31))},
                              ("a", "b", "w"), False, {}),
    "spp_max": (_one("spp", pyramid_height=3), {"x": _f32((2, 8, 9, 3), 32)}, ("x",), False,
                dict(exact=True)),
    "spp_ave": (_one("spp", pyramid_height=2, pool="ave"), {"x": _f32((2, 7, 7, 3), 33)},
                ("x",), False, {}),
    "roipooling": (_one("roipooling", bottoms=("x", "rois"), pooled_h=3, pooled_w=2,
                        spatial_scale=0.5),
                   {"x": FM, "rois": ROIS}, ("x",), False, dict(exact=True)),
    "filter": ([("l", "filter", ("x", "z", "sel"), ("y", "zy", "valid"), {"capacity": 3})],
               {"x": _f32((5, 3, 2, 4), 34), "z": _f32((5, 2), 35),
                "sel": np.asarray([0, 1, 0, 1, 1], np.float32)}, ("x", "z"), False,
               dict(exact=True)),
    "filter_overflow": ([("l", "filter", ("x", "sel"), ("y",), {"capacity": 2})],
                        {"x": _f32((5, 3), 36), "sel": np.asarray([1, 1, 0, 1, 1], np.float32)},
                        ("x",), False, dict(exact=True)),
    "im2col": (_one("im2col", kernel_size=3, stride=2, pad=1), {"x": X2}, ("x",), False,
               dict(exact=True)),
    "reduction_sum": (_one("reduction", axis=1), {"x": X2}, ("x",), False, {}),
    "reduction_asum_axis3": (_one("reduction", operation="asum", axis=3), {"x": X2}, ("x",),
                             False, {}),
    "reduction_sumsq": (_one("reduction", operation="sumsq", axis=2, coeff=0.5), {"x": X3},
                        ("x",), False, {}),
    "reduction_mean": (_one("reduction", operation="mean"), {"x": X2}, ("x",), False, {}),
    "normalize": (_one("normalize"), {"x": X2}, ("x",), False, dict(rtol=1e-4, atol=1e-6,
                                                                     g_rtol=1e-4, g_atol=1e-5)),
    "batchreduction_mean": (_one("batchreduction", reduction_param={"operation": "MEAN",
                                                                    "axis": 2}, level=[1]),
                            {"x": _f32((2, 8, 3), 37)}, ("x",), False, {}),
    "batchreduction_topk": (_one("batchreduction", reduction_param={"operation": "TOPK",
                                                                    "axis": 2, "k": 3}),
                            {"x": _f32((2, 8, 3), 38)}, ("x",), False, {}),
    "batchreduction_levels": (_one("batchreduction", reduction_param={"operation": "SUM",
                                                                      "axis": 2},
                                   level=[1, 2]), {"x": _f32((2, 5, 3), 39)}, ("x",), False, {}),
    "batchreduction_pos": (_one("batchreduction", reduction_param={"operation": "MEAN",
                                                                   "axis": 1}, pos=True),
                           {"x": _f32((2, 4, 4), 40)}, ("x",), False, {}),
    "dummydata": ([("l", "dummydata", (), ("a", "b"),
                    {"shape": [{"dim": [2, 3, 4, 5]}, {"dim": [2, 6]}],
                     "data_filler": [{"type": "constant", "value": 1.5},
                                     {"type": "constant", "value": -2.0}]})],
                  {}, (), False, dict(exact=True)),
    "hdf5output": (_one("hdf5output", bottoms=("x", "z"), tops=()),
                   {"x": X2, "z": LOGITS}, (), False, {}),
}

TAIL_TYPES = {
    "deconvolution", "permute", "power", "silence", "bias", "gather", "scatter",
    "sigmoid", "tanh", "absval", "exp", "log", "bnll", "threshold", "argmax",
    "lrn", "mvn", "prelu", "batchnorm",
    "euclideanloss", "hingeloss", "sigmoidcrossentropyloss", "infogainloss",
    "contrastiveloss", "multinomiallogisticloss", "smoothl1loss",
    "spp", "roipooling", "filter", "im2col", "reduction", "normalize", "batchreduction",
    "dummydata", "hdf5output",
}


def test_the_cases_cover_the_35_tail_types():
    assert len(TAIL_TYPES) == 35
    assert {layers[0][1] for layers, *_ in LAYER_CASES.values()} == TAIL_TYPES


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    layers, inputs, wrt, train, tol = LAYER_CASES[case]
    result = run_both(layers, inputs, train=train, wrt=wrt)
    assert_both_agree(result, **tol)
    if layers[0][1] in ("silence", "hdf5output"):
        assert result["outs"][1] == {}


# layer types the port has and the reference does not: I3D's input transform
# (held to tests/reference_i3d.py by tests/test_torch_i3d.py), the
# space-to-depth its optimized stem reads (tests/test_torch_i3d.py too) and
# Video Swin's token layers (held to tests/reference_video_swin.py by
# tests/test_torch_video_swin.py) and MViTv2's (held to tests/reference_mvit.py
# by tests/test_torch_mvit.py)
PORT_ONLY = {"input_transform", "space_to_depth", "layer_norm", "gelu", "window_pad",
             "window_attention", "patch_merging", "cls_token", "pooled_attention",
             "token_pool", "cls_select"}


def test_every_reference_layer_has_an_equivalent():
    """Every key of the reference's IMPLS is a key of the port's (so every
    layer of Caffe's src/caffe/layers/ that the reference maps, per
    tests/test_layer_tail_v2.py, runs in the port), and no more but the
    port's own."""
    assert set(JAX_IMPLS) <= set(IMPLS)
    assert set(IMPLS) - PORT_ONLY == set(JAX_IMPLS)
    for key in JAX_IMPLS:
        assert get_impl(key) is IMPLS[key]


def test_tail_prototxt_chain_matches_jax():
    """tests/test_layer_tail_v2.py's ``tail2`` chain, Log -> PReLU -> Bias ->
    Normalize -> SPP -> Reduction, imported by both packages and run
    through both Programs (rtol 1e-4: Normalize divides by a root of a sum)."""
    text = """
name: "tail2"
input: "data" input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8
layer { name: "lg" type: "Log" bottom: "data" top: "lg"
  log_param { base: 10 scale: 2 shift: 5 } }
layer { name: "pr" type: "PReLU" bottom: "lg" top: "pr" }
layer { name: "bi" type: "Bias" bottom: "pr" top: "bi" bias_param { axis: 1 } }
layer { name: "nm" type: "Normalize" bottom: "bi" top: "nm" }
layer { name: "spp" type: "SPP" bottom: "nm" top: "spp"
  spp_param { pyramid_height: 3 } }
layer { name: "rd" type: "Reduction" bottom: "spp" top: "rd"
  reduction_param { operation: MEAN axis: 1 } }
"""
    jg, tg = jax_graph_from_prototxt(text), graph_from_prototxt(text)
    x = np.abs(_f32((2, 8, 8, 3), 41)) + 1
    jprog = JaxProgram(jg, train=False)
    jp, js = jprog.init(jax.random.PRNGKey(0), {"data": jnp.asarray(x)})
    jp = _randomize(jp, 3)
    want, _ = jprog.apply(jp, js, {"data": jnp.asarray(x)}, capture=["lg", "nm", "spp"])
    tp, ts = params_from_jax(tg, jp, js, device="cpu")
    got, _ = Program(tg, device="cpu").apply(tp, ts, {"data": torch.from_numpy(x)},
                                             capture=["lg", "nm", "spp"])
    assert set(got) == set(want) == {"rd", "lg", "nm", "spp"}
    assert tuple(got["spp"].shape) == (2, 3 * 21) and tuple(got["rd"].shape) == (2,)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pool_matches_jax_at_two_scales(scale):
    """Equal values; the input's gradient equal too (no ties in random
    data: each bin's max is one cell)."""
    (want, want_g), (got, got_g) = _vjp_both(
        lambda x: jops.roi_max_pool(x, jnp.asarray(ROIS), pooled_h=3, pooled_w=3,
                                    spatial_scale=scale),
        lambda x: ops.roi_max_pool(x, torch.from_numpy(ROIS), pooled_h=3, pooled_w=3,
                                   spatial_scale=scale), [FM])
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got_g[0]), np.asarray(want_g[0]))


def test_roi_pool_empty_bins_and_rounding():
    """An ROI past the map's edge gives empty bins (0), and coordinates that
    land on .5 round away from zero, as C's round()."""
    rois = np.array([[0, 30, 30, 40, 40], [1, 1.5, 2.5, 6.5, 7.5], [0, -3, -3, 2, 2]],
                    np.float32)
    want = np.asarray(jops.roi_max_pool(jnp.asarray(FM), jnp.asarray(rois), pooled_h=2,
                                        pooled_w=3))
    got = ops.roi_max_pool(torch.from_numpy(FM), torch.from_numpy(rois), pooled_h=2,
                           pooled_w=3)
    np.testing.assert_array_equal(_np(got), want)
    assert not want[0].any()


def test_prelu_negative_slope_and_shared():
    """tests/test_layer_tail_v2.py's case; the port's gradient at exactly 0
    is the slope, as Caffe's backward."""
    x = torch.tensor([[-2.0, 3.0], [-1.0, -4.0]])
    spec = LayerSpec("l", "prelu", ("x",), ("y",), {})
    (y,) = get_impl("prelu").apply(spec, {"slope": torch.tensor([0.5, 0.1])}, {}, [x], CTX)
    np.testing.assert_allclose(y.numpy(), [[-1.0, 3.0], [-0.5, -0.4]])
    assert get_impl("prelu").param_specs(
        LayerSpec("l", "prelu", ("x",), ("y",), {"channel_shared": True}), [(2, 2)]
    )["slope"][0] == (1,)
    z = torch.zeros(1, 2, requires_grad=True)
    (y,) = get_impl("prelu").apply(spec, {"slope": torch.tensor([0.5, 0.1])}, {}, [z], CTX)
    (g,) = torch.autograd.grad(y.sum(), z)
    np.testing.assert_allclose(g.numpy(), [[0.5, 0.1]])


def test_filter_refuses_without_capacity_as_the_reference():
    spec = LayerSpec("l", "filter", ("x", "sel"), ("y",), {})
    with pytest.raises(NotImplementedError, match="static shapes"):
        get_impl("filter").apply(spec, {}, {}, [torch.zeros(2, 2)] * 2, CTX)
    jspec = JaxLayerSpec("l", "filter", ("x", "sel"), ("y",), {})
    with pytest.raises(NotImplementedError, match="static shapes"):
        JAX_IMPLS["filter"].apply(jspec, {}, {}, [jnp.zeros((2, 2))] * 2, None)


def test_reduction_output_is_physical_channels_last():
    """axis=3 of logical (N,C,H,W) -> logical (N,C,H) -> physical (N,H,C)."""
    phys = np.arange(24, dtype=np.float32).reshape(1, 4, 2, 3)
    spec = LayerSpec("l", "reduction", ("x",), ("y",), {"operation": "sum", "axis": 3})
    (y,) = get_impl("reduction").apply(spec, {}, {}, [torch.from_numpy(phys)], CTX)
    np.testing.assert_array_equal(y.numpy(), np.moveaxis(np.moveaxis(phys, -1, 1).sum(3), 1, -1))


RAISING = {
    "batchreduction_asum": ("batchreduction",
                            {"reduction_param": {"operation": "ASUM", "axis": 1}},
                            [(1, 3)], NotImplementedError, "NOT_IMPLEMENTED"),
    "batchreduction_pos_rank": ("batchreduction",
                                {"reduction_param": {"operation": "SUM", "axis": 1}, "pos": True},
                                [(2, 3)], ValueError, "logical dims"),
    "batchreduction_levels_cover": ("batchreduction",
                                    {"reduction_param": {"axis": 2}, "level": [2]},
                                    [(1, 5, 2)], ValueError, "do not cover"),
    "roipooling_pooled_dims": ("roipooling", {}, [(1, 4, 4, 2), (1, 5)], ValueError,
                               "pooled_h/pooled_w"),
    "spp_oversized_pyramid": ("spp", {"pyramid_height": 4}, [(1, 6, 6, 2)], ValueError,
                              "exceed"),
    "dummydata_fillers": ("dummydata", {"shape": [{"dim": [1, 2]}, {"dim": [3]}],
                                        "data_filler": [{"type": "constant"}] * 3},
                          [], ValueError, "data_fillers"),
    "reduction_operation": ("reduction", {"operation": "max"}, [(2, 3)], ValueError,
                            "unknown reduction"),
}


@pytest.mark.parametrize("case", sorted(RAISING))
def test_raises_where_the_reference_raises(case):
    ltype, opts, shapes, exc, match = RAISING[case]
    bottoms = tuple(f"b{i}" for i in range(len(shapes)))
    with pytest.raises(exc, match=match):
        JAX_IMPLS[ltype].apply(JaxLayerSpec("l", ltype, bottoms, ("y",), opts), {}, {},
                               [jnp.ones(s) for s in shapes], None)
    with pytest.raises(exc, match=match):
        get_impl(ltype).apply(LayerSpec("l", ltype, bottoms, ("y",), opts), {}, {},
                              [torch.ones(s) for s in shapes], CTX)


def test_dummydata_draws_from_the_layer_generator_on_the_program_device():
    """Gaussian and uniform tops: the declared shapes made physical, on the
    program's device, drawn from a generator of the layer, its top and the
    step's seed (not jax.random's bits: the distribution only)."""
    g = _graph([("d", "dummydata", (), ("a", "b"),
                 {"shape": [{"dim": [64, 8, 16, 16]}, {"dim": [4096]}],
                  "data_filler": [{"type": "gaussian", "mean": 1.0, "std": 2.0},
                                  {"type": "uniform", "min": -1.0, "max": 3.0}]})], {})
    prog = Program(g, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(0), {})
    assert params == {} and state == {}
    a, b = (prog.apply({}, {}, {})[0][k] for k in ("a", "b"))
    assert tuple(a.shape) == (64, 16, 16, 8) and tuple(b.shape) == (4096,)
    assert a.device.type == "cpu"
    assert abs(a.mean().item() - 1.0) < 0.05 and abs(a.std().item() - 2.0) < 0.05
    assert b.min() >= -1 and b.max() <= 3 and abs(b.mean().item() - 1.0) < 0.1
    again = Program(g, device="cpu").apply({}, {}, {})[0]["a"]
    assert torch.equal(a, again)
    train = Program(g, train=True, device="cpu")
    drawn = [train.apply({}, {}, {}, generator=torch.Generator().manual_seed(s))[0]["a"]
             for s in (1, 1, 2)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])


def test_infogain_reads_h_from_its_source(tmp_path):
    """``infogain_param { source }``: H from a BlobProto file into the
    layer's state at init, as the reference reads it."""
    from eco_tpu_torch.convert.write import _blob

    H = np.abs(_f32((5, 5), 42))
    src = tmp_path / "H.binaryproto"
    src.write_bytes(_blob(H))
    layers = [("l", "infogainloss", ("p", "label"), ("loss",), {"source": str(src)})]
    result = run_both(layers, {"p": PROBS, "label": LABELS}, wrt=("p",))
    assert_both_agree(result)


# --------------------------------------------------------------------------
# The weight bridge, the fillers and remat over the tail
# --------------------------------------------------------------------------


def _param_graph():
    return _graph([
        ("up", "deconvolution", ("x",), ("up",), {"num_output": 6, "kernel_size": 4,
                                                   "stride": 2, "pad": 1, "group": 2}),
        ("up3", "deconvolution", ("v",), ("up3",), {"num_output": 2, "kernel_size": [1, 2, 2],
                                                     "stride": [1, 2, 2]}),
        ("pr", "prelu", ("up",), ("pr",), {}),
        ("prs", "prelu", ("pr",), ("prs",), {"channel_shared": True}),
        ("bi", "bias", ("prs",), ("bi",), {"axis": 1, "num_axes": -1}),
        ("bn", "batchnorm", ("bi",), ("bn",), {}),
        ("sc", "scale", ("bn",), ("sc",), {}),
        ("fc", "innerproduct", ("sc",), ("fc",), {"num_output": 3}),
    ], {"x": X2, "v": X3})


def test_bridge_round_trip_over_every_tail_layer_with_params():
    g = _param_graph()
    jp, js = JaxProgram(g, train=False).init(jax.random.PRNGKey(0),
                                             {"x": jnp.asarray(X2), "v": jnp.asarray(X3)})
    jp, js = _randomize(jp, 4), _state_randomize(js, 5)
    tp, ts = params_from_jax(g, jp, js, device="cpu")
    assert tuple(tp["up"]["w"].shape) == (4, 3, 4, 4)          # (C_in, C_out/g, *k)
    assert tuple(tp["up3"]["w"].shape) == (4, 2, 1, 2, 2)
    np.testing.assert_array_equal(tp["up"]["w"].numpy(),
                                  np.asarray(jp["up"]["w"]).transpose(2, 3, 0, 1))
    back_p, back_s = params_to_jax(g, tp, ts)
    for tree, want in ((back_p, jp), (back_s, js)):
        assert tree.keys() == want.keys()
        for ln in want:
            assert tree[ln].keys() == want[ln].keys()
            for k in want[ln]:
                np.testing.assert_array_equal(tree[ln][k], np.asarray(want[ln][k]))
    # the port's own init gives the reference's shapes through the bridge
    own_p, own_s = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                                 {"x": X2.shape, "v": X3.shape})
    shapes = lambda t: {ln: {k: tuple(np.shape(v)) for k, v in lp.items()} for ln, lp in t.items()}
    assert shapes(params_to_jax(g, own_p, own_s)[0]) == shapes(jp)
    assert shapes(own_s) == shapes(js)


@pytest.mark.parametrize("jax_shape,torch_shape", [
    ((4, 4, 192, 48), (192, 48, 4, 4)),
    ((3, 4, 4, 96, 48), (96, 48, 3, 4, 4)),
])
def test_deconv_fans_match_jax(jax_shape, torch_shape):
    """A deconv weight (C_in, C_out/g, *k) has the reference's fans of
    (*k, C_in, C_out/g); so xavier draws within the reference's bound."""
    assert _fans(torch_shape, transposed=True) == jax_fans(jax_shape)
    fan_in, _ = jax_fans(jax_shape)
    t = fill(torch.Generator().manual_seed(0), torch_shape, torch.float32, {"type": "xavier"},
             transposed=True)
    bound = (3 / fan_in) ** 0.5
    assert t.abs().max() <= bound and t.abs().max() > 0.9 * bound
    g = _graph(_one("deconvolution", num_output=96, kernel_size=4, stride=2), {"x": _f32(
        (1, 3, 3, 192), 0)})
    w = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                      {"x": (1, 3, 3, 192)})[0]["l"]["w"]
    bound = (3 / jax_fans((4, 4, 192, 96))[0]) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound


def test_remat_regions_close_at_a_deconvolution():
    layers = [LayerSpec("a", "relu", ("x",), ("a",), {}),
              LayerSpec("up", "deconvolution", ("a",), ("up",), {}),
              LayerSpec("b", "sigmoid", ("up",), ("b",), {}),
              LayerSpec("fc", "innerproduct", ("b",), ("fc",), {})]
    assert memory.regions(layers) == [[0, 1], [2, 3]]


def test_remat_step_with_a_deconvolution_equals_the_plain_step():
    g = _graph([
        ("up", "deconvolution", ("x",), ("up",), {"num_output": 4, "kernel_size": 2, "stride": 2}),
        ("lrn", "lrn", ("up",), ("lrn",), {"local_size": 3, "alpha": 0.5}),
        ("pr", "prelu", ("lrn",), ("pr",), {}),
        ("fc", "innerproduct", ("pr",), ("fc",), {"num_output": 5}),
        ("loss", "softmaxwithloss", ("fc", "label"), ("loss",), {}),
    ], {"x": X2, "label": _labels(2, 5)})
    prog = Program(g, train=True, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(0),
                              {"x": X2.shape, "label": (2,)})
    batch = {"x": torch.from_numpy(X2)[None], "label": torch.from_numpy(_labels(2, 5)).long()[None]}
    cfg = SolverConfig(base_lr=0.1, momentum=0.9)
    want, _ = make_train_step(prog, cfg)(init_train_state(params, state), batch)
    for policy in ("dots", "nothing"):
        got, _ = make_train_step(prog, cfg, remat=policy)(init_train_state(params, state), batch)
        for ln in want.params:
            for k in want.params[ln]:
                assert torch.equal(got.params[ln][k], want.params[ln][k]), (policy, ln, k)


# --------------------------------------------------------------------------
# Graphs: CaffeNet-shaped, mini_flow.prototxt
# --------------------------------------------------------------------------

# 67 is the least input CaffeNet's layers take: conv1 gives 15, pool1 7, pool2
# 3, pool5 1 (at 35, pool2 gives 1 and Caffe's ceil formula gives pool5 none)
CAFFENET_MINI = dict(batch=2, crop=67, widths=(8, 16, 24, 24, 16, 32, 32), classes=5,
                     dropout=0.0)


def _step_both(text, data, labels, cfg_kw, seed=0):
    """One solver step of the reference (jitted) and the port on the same
    prototxt and batch, from the reference's randomized weights."""
    jg, tg = jax_graph_from_prototxt(text), graph_from_prototxt(text)
    sample = {"data": jnp.asarray(data), "label": jnp.asarray(labels)}
    jp, js = JaxProgram(jg, train=True).init(jax.random.PRNGKey(seed), sample)
    jp = {ln: {k: v * 30.0 if k == "w" else v for k, v in lp.items()} for ln, lp in jp.items()}
    tp, ts = params_from_jax(tg, jp, js, device="cpu")
    # one micro-batch: the steps take a leading iter_size axis
    jts, jm = jax.jit(jax_make_train_step(JaxProgram(jg, train=True), JaxSolverConfig(**cfg_kw)))(
        jax_init_train_state(jp, js), {k: v[None] for k, v in sample.items()},
        jax.random.PRNGKey(1))
    tts, tm = make_train_step(Program(tg, train=True, device="cpu"), SolverConfig(**cfg_kw))(
        init_train_state(tp, ts),
        {"data": torch.from_numpy(data)[None], "label": torch.from_numpy(labels).long()[None]},
        torch.Generator().manual_seed(1))
    return (jg, jp, jts, jm), (tg, tp, tts, tm)


def _assert_steps_agree(jax_side, torch_side, rtol=G_RTOL):
    (jg, jp, jts, jm), (tg, tp, tts, tm) = jax_side, torch_side
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
    got_p, _ = params_to_jax(tg, tts.params, tts.state)
    for ln in jp:
        for k in jp[ln]:
            want_u = np.asarray(jts.params[ln][k]) - np.asarray(jp[ln][k])
            got_u = got_p[ln][k] - np.asarray(jp[ln][k])
            np.testing.assert_allclose(got_u, want_u, rtol=rtol,
                                       atol=rtol * np.abs(want_u).max() + 1e-9,
                                       err_msg=f"update {ln}/{k}")


def test_caffenet_shaped_mini_graph_matches_jax():
    """chip_smoke.py's CaffeNet prototxt at narrow widths, 67x67 input,
    dropout 0: LRN twice, grouped convs, ceil-mode pools.  TEST forward
    (logits within 1e-5 relative) and one SGD step (the published solver:
    lr 0.01, momentum 0.9, decay 5e-4, lr_mult 2 on biases): loss within
    1e-5, each param's update within 1e-4 of its largest entry."""
    text = chip_smoke.caffenet_prototxt(**CAFFENET_MINI)
    data = _f32((2, 67, 67, 3), 43, 50.0)
    labels = _labels(2, 5)
    jg, tg = jax_graph_from_prototxt(text), graph_from_prototxt(text)
    assert [l.type for l in tg.layers].count("lrn") == 2
    assert sum(l.type == "convolution" and l.opt("group") == 2 for l in tg.layers) == 3
    sample = {"data": jnp.asarray(data), "label": jnp.asarray(labels)}
    jprog = JaxProgram(jg, train=False)
    jp, js = jprog.init(jax.random.PRNGKey(0), sample)
    want, _ = jprog.apply(jp, js, sample, capture=["fc8", "norm1", "norm2"])
    tp, ts = params_from_jax(tg, jp, js, device="cpu")
    got, _ = Program(tg, device="cpu").apply(
        tp, ts, {"data": torch.from_numpy(data), "label": torch.from_numpy(labels)},
        capture=["fc8", "norm1", "norm2"])
    assert set(got) == set(want) == {"loss", "accuracy", "fc8", "norm1", "norm2"}
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)
    _assert_steps_agree(*_step_both(text, data, labels, chip_smoke.CAFFENET_SOLVER))


def test_mini_flow_train_loss_and_step_match_jax():
    """tests/fixtures/mini_flow.prototxt at TRAIN through both Programs: the
    segment fold and consensus of the importer, the loss (within 1e-5) and
    one step's update (within 1e-4 of each param's largest entry)."""
    from pathlib import Path

    text = (Path(__file__).parent / "fixtures" / "mini_flow.prototxt").read_text()
    data = _f32((2, 2, 32, 32, 2), 44)
    labels = np.asarray([0, 1], np.int32)
    jax_side, torch_side = _step_both(text, data, labels,
                                      dict(base_lr=0.1, momentum=0.9, weight_decay=5e-4))
    assert [l.type for l in torch_side[0].filtered("train").layers] == [
        "fold_segments", "convolution", "pooling", "segment_consensus", "innerproduct",
        "softmaxwithloss"]
    assert float(torch_side[3]["loss"]) > 0
    _assert_steps_agree(jax_side, torch_side)


# --------------------------------------------------------------------------
# The online subcommand
# --------------------------------------------------------------------------

ONLINE_NET = """
name: "tiny_online"
input: "data"
input_shape { dim: 1 dim: 3 dim: 4 dim: 224 dim: 224 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 6 kernel_size: [1, 8, 8] stride: [1, 8, 8] } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
  pooling_param { pool: AVE global_pooling: true } }
layer { name: "fc" type: "InnerProduct" bottom: "pool" top: "fc"
  inner_product_param { num_output: 5 } }
layer { name: "probs" type: "Softmax" bottom: "fc" top: "probs" }
"""


def test_online_subcommand_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``online --frames DIR`` through both CLIs (bf16, the uint8 plane) on
    one weights file and one seeded stream of 20 frames (five windows of 4
    segments): the same printed labels, and the smoothed scores each window
    returns within 2e-2 (bf16 keeps 8 bits; measured 1.6e-3)."""
    cv2 = pytest.importorskip("cv2")
    from eco_tpu.apps import online as jax_online
    from eco_tpu.tools.cli import main as jax_main
    from eco_tpu.train import save_model as jax_save_model
    from eco_tpu_torch.apps import online
    from eco_tpu_torch.tools.cli import main

    net = tmp_path / "net.prototxt"
    net.write_text(ONLINE_NET)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = _rng(45)
    for i in range(20):
        img = np.clip(rng.integers(0, 255, (240, 320, 3)) * (0.3 + 0.7 * (i // 4) / 4),
                      0, 255).astype(np.uint8)
        cv2.imwrite(str(frames / f"img_{i:05d}.png"), img)
    g = jax_graph_from_prototxt(ONLINE_NET)
    jp, js = JaxProgram(g, train=False).init(jax.random.PRNGKey(0),
                                             {"data": jnp.zeros(g.inputs["data"])})
    jp = _randomize(jp, 6)
    weights = str(tmp_path / "w.model.npz")
    jax_save_model(weights, jp, js)

    scores = {}
    for name, module, run, extra in (("jax", jax_online, jax_main, []),
                                     ("torch", online, main, ["--device", "cpu"])):
        seen = scores.setdefault(name, [])
        push = module.OnlineRecognizer.push_frame

        def recording(self, frame, push=push, seen=seen):
            res = push(self, frame)
            if res is not None:
                seen.append(np.asarray(res[1], np.float32))
            return res

        monkeypatch.setattr(module.OnlineRecognizer, "push_frame", recording)
        run(["online", "--net", str(net), "--segments", "4", "--frames", str(frames),
             "--weights", weights, *extra])
        scores[name + "_out"] = [l for l in capsys.readouterr().out.splitlines()
                                 if l.startswith("frame ")]
    assert len(scores["torch"]) == len(scores["jax"]) == 5
    assert scores["torch_out"] == scores["jax_out"] and len(scores["jax_out"]) == 5
    for got, want in zip(scores["torch"], scores["jax"]):
        np.testing.assert_allclose(got, want, atol=2e-2)
        assert np.argmax(got) == np.argmax(want)
