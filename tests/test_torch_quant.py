"""eco_tpu_torch's int8 serving slice against eco_tpu's: the quantize ops,
K3's plain version (``ops/qconv.py``), post-training quantization
(``convert/quantize.py``), the int8 executor layers and the int8 input plane
of ``UInt8Server``.

The reference runs on the CPU, as ``tests/test_quantize.py`` runs it.  K3's
plain version and the reference's XLA int8 conv give equal int32
accumulators, int8 outputs and float outputs: XLA's CPU does not contract
the epilogue's multiply and add into an FMA here, so no ulp of slack is
needed.  Calibrated scales are maxima of f32 activations that the two
packages sum in other orders, so they agree to ~1e-7 relative and are held
to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eco_tpu.apps.serving import UInt8Server as JaxUInt8Server
from eco_tpu.convert.quantize import chain_int8 as jax_chain_int8
from eco_tpu.convert.quantize import int8_input_rewrite as jax_int8_input_rewrite
from eco_tpu.convert.quantize import quantize_for_serving as jax_quantize_for_serving
from eco_tpu.ops import quant as jq
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import GraphSpec, LayerSpec
from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import (
    calibrate,
    chain_int8,
    int8_input_rewrite,
    params_from_jax,
    params_to_jax,
    quantize_for_serving,
    quantize_graph,
)
from eco_tpu_torch.ops import qconv
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.ops.quant import (
    conv_nd_int8,
    inner_product_int8,
    quantize_act,
    quantize_weight,
)
from eco_tpu_torch.runtime import Program

from tests.test_parallel import _small_video_graph
from tests.test_torch_executor import _mini_graph, _randomize

SCALE_RTOL = 1e-6
_OUT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch_w(w):
    """A JAX-layout conv weight (*k, C_in/g, C_out) as numpy -> torch layout."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(w, (-1, -2), (0, 1))))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


@pytest.mark.parametrize("shape", [(3, 3, 4, 8), (3, 3, 3, 16, 12), (7, 7, 3, 64), (40, 10)])
def test_quantize_weight_and_act_match_jax(shape):
    """Per-output-channel int8 and its scales equal the reference's, with a
    zero channel (scale 1) among them; the port's weights are in its own
    layout (output channel on axis 0)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * np.linspace(0.1, 3, shape[-1])).astype(np.float32)
    w[..., 1] = 0.0
    w_q, scale = jq.quantize_weight(jnp.asarray(w))
    tw = _to_torch_w(w) if len(shape) > 2 else torch.from_numpy(np.ascontiguousarray(w.T))
    tw_q, tscale = quantize_weight(tw)
    assert tw_q.dtype == torch.int8 and tscale.dtype == torch.float32
    want_q = np.moveaxis(np.asarray(w_q), (-1, -2), (0, 1)) if len(shape) > 2 \
        else np.asarray(w_q).T
    np.testing.assert_array_equal(tw_q.numpy(), want_q)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    assert float(tscale[1]) == 1.0 and not tw_q[1].any()

    x = (rng.standard_normal((2, 5, 5, 4)) * 40).astype(np.float32)
    x[0, 0, 0, :2] = (300.0, 0.5)  # a clip and a tie, rounded to even
    for s in (0.37, 1.0, 0.0123):
        np.testing.assert_array_equal(quantize_act(torch.from_numpy(x), s).numpy(),
                                      np.asarray(jq.quantize_act(jnp.asarray(x), s)))


def _conv_case(rng, nsp, groups, int8_in):
    c_in, c_out = 8, 6
    sp = (9,) * nsp if nsp == 2 else (5, 7, 6)
    if int8_in:
        x = rng.integers(-127, 128, (2, *sp, c_in)).astype(np.int8)
    else:
        x = (rng.standard_normal((2, *sp, c_in)) * 3).astype(np.float32)
    w = rng.standard_normal((*(3,) * nsp, c_in // groups, c_out)).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("nsp", [2, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("groups", [1, 2])
def test_conv_nd_int8_plain_matches_jax(nsp, stride, pad, dilation, groups):
    """Over int8 and float inputs, int8 out (out_scale set) and f32/bf16
    out: with unit scales and no bias the int32 accumulators are equal, and
    every output is equal."""
    rng = np.random.default_rng(100 * nsp + 10 * stride + 4 * pad + 2 * dilation + groups)
    geo = dict(stride=stride, pad=pad, dilation=dilation, groups=groups)
    x, w, b = _conv_case(rng, nsp, groups, True)
    w_q = rng.integers(-127, 128, w.shape).astype(np.int8)
    acc = np.asarray(jq.conv_nd_int8(jnp.asarray(x), jnp.asarray(w_q), jnp.ones(w.shape[-1]),
                                     act_scale=1.0, out_dtype=jnp.float32, **geo))
    tw_q = qconv.kernel_layout(_to_torch_w(w_q))
    got_acc = qconv.conv_acc_reference(torch.from_numpy(x), tw_q, **geo)
    assert got_acc.dtype == torch.int32 and got_acc.is_contiguous()
    np.testing.assert_array_equal(got_acc.numpy(), acc.astype(np.int32))

    for int8_in in (True, False):
        x, w, b = _conv_case(rng, nsp, groups, int8_in)
        jw_q, jw_s = jq.quantize_weight(jnp.asarray(w))
        tw_q, tw_s = quantize_weight(_to_torch_w(w))
        for out_scale in (None, 0.37):
            for out in ("f32", "bf16"):
                kw = dict(act_scale=0.05, out_scale=out_scale, **geo)
                want = jq.conv_nd_int8(jnp.asarray(x), jw_q, jw_s, jnp.asarray(b),
                                       out_dtype=_OUT[out][0], **kw)
                got = conv_nd_int8(torch.from_numpy(x), qconv.kernel_layout(tw_q), tw_s,
                                   torch.from_numpy(b), out_dtype=_OUT[out][1], **kw)
                assert got.dtype == (torch.int8 if out_scale else _OUT[out][1])
                np.testing.assert_array_equal(got.float().numpy(), _np(want).astype(np.float32))


@pytest.mark.parametrize("int8_in", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_inner_product_int8_plain_matches_jax(int8_in, bias):
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (4, 48)).astype(np.int8) if int8_in \
        else (rng.standard_normal((4, 48)) * 2).astype(np.float32)
    w = rng.standard_normal((48, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32) if bias else None
    jw_q, jw_s = jq.quantize_weight(jnp.asarray(w))
    tw_q, tw_s = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    for out_scale in (None, 0.21):
        for out in ("f32", "bf16"):
            kw = dict(act_scale=0.03, out_scale=out_scale)
            want = jq.inner_product_int8(jnp.asarray(x), jw_q, jw_s,
                                         None if b is None else jnp.asarray(b),
                                         out_dtype=_OUT[out][0], **kw)
            got = inner_product_int8(torch.from_numpy(x), tw_q, tw_s,
                                     None if b is None else torch.from_numpy(b),
                                     out_dtype=_OUT[out][1], **kw)
            assert tuple(got.shape) == (4, 10)
            np.testing.assert_array_equal(got.float().numpy(), _np(want).astype(np.float32))


def test_kernel_layout_keeps_values_and_reorders_memory():
    w = torch.randint(-127, 128, (6, 4, 3, 2), dtype=torch.int8)
    wk = qconv.kernel_layout(w)
    assert torch.equal(wk, w) and wk.shape == w.shape
    assert wk.movedim(1, -1).is_contiguous()  # memory (C_out, *k, C_in/g)


# -- post-training quantization --------------------------------------------

def _jax_and_port(graph, data, seed=0, perturb=True):
    """The reference's Program and weights (BN perturbed, so the fold
    matters) and the port's, carried over by the bridge."""
    jprog = JaxProgram(graph, train=False)
    p, s = jprog.init(jax.random.PRNGKey(seed), {next(iter(graph.inputs)): jnp.asarray(data)})
    if perturb:
        p, s = _randomize(p, s, seed)
    return jprog, p, s, Program(graph, device="cpu"), *params_from_jax(graph, p, s, device="cpu")


def _layer_opts(graph):
    return [(l.name, l.type, l.bottoms, l.tops, dict(l.options)) for l in graph.layers]


def _assert_same_qgraph(got, want):
    """Same layers, types and options; scale options within SCALE_RTOL."""
    assert got.name == want.name and got.inputs == want.inputs
    for g, w in zip(_layer_opts(got), _layer_opts(want), strict=True):
        assert g[:4] == w[:4] and g[4].keys() == w[4].keys(), (g, w)
        for k, v in w[4].items():
            if k in ("act_scale", "out_scale", "in_scale"):
                assert g[4][k] == pytest.approx(v, rel=SCALE_RTOL), (g[0], k)
            elif k == "in_scales":
                assert g[4][k] == [None if s is None else pytest.approx(s, rel=SCALE_RTOL)
                                   for s in v], g[0]
            else:
                assert g[4][k] == v, (g[0], k)


@pytest.mark.parametrize("which", ["small_video", "mini"])
def test_quantize_for_serving_matches_jax(which):
    """fold BN -> calibrate -> rewrite -> int8 chains: the same quantized and
    chained layers, act scales within 1e-6, the same q-graph; int8 weights
    within one step of the reference's (they quantize BN-folded weights that
    the two packages fold with their own f32 ops); the q-programs agree on
    argmax and probs within 1e-3."""
    g = _small_video_graph(with_loss=False) if which == "small_video" else _mini_graph()
    data = (np.random.default_rng(5).standard_normal(g.inputs["data"]) * 3).astype(np.float32)
    jprog, p, s, tprog, tp, ts = _jax_and_port(g, data)
    jq_prog, jqp, jqs, jrep = jax_quantize_for_serving(jprog, p, s, [{"data": jnp.asarray(data)}])
    tq_prog, tqp, tqs, trep = quantize_for_serving(tprog, tp, ts, [{"data": torch.from_numpy(data)}])
    assert trep["quantized"] == jrep["quantized"] and trep["chained"] == jrep["chained"]
    assert len(trep["chained"]) >= 2
    assert trep["act_scales"].keys() == jrep["act_scales"].keys()
    for k, v in jrep["act_scales"].items():
        assert trep["act_scales"][k] == pytest.approx(v, rel=SCALE_RTOL), k
    _assert_same_qgraph(tq_prog.graph, jq_prog.graph)
    want_p, _ = params_from_jax(jq_prog.graph, jqp, jqs, device="cpu")
    for lname in trep["quantized"]:
        assert tqp[lname]["w"].dtype == torch.int8
        assert (tqp[lname]["w"].int() - want_p[lname]["w"].int()).abs().max() <= 1
        torch.testing.assert_close(tqp[lname]["w_scale"], want_p[lname]["w_scale"],
                                   rtol=SCALE_RTOL, atol=0)
    want = np.asarray(jq_prog.apply(jqp, jqs, {"data": jnp.asarray(data)})[0]["probs"])
    got = tq_prog.apply(tqp, tqs, {"data": torch.from_numpy(data)})[0]["probs"].numpy()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_quantized_programs_agree_on_the_same_qgraph_and_weights():
    """The reference's q-graph and int8 weights carried over by the bridge:
    the port's int8 executor gives the reference's probs (only the float ops
    between int8 layers sum in other orders)."""
    g = _mini_graph()
    data = (np.random.default_rng(6).standard_normal(g.inputs["data"]) * 3).astype(np.float32)
    jprog, p, s, *_ = _jax_and_port(g, data)
    jq_prog, jqp, jqs, _ = jax_quantize_for_serving(jprog, p, s, [{"data": jnp.asarray(data)}])
    tqp, tqs = params_from_jax(jq_prog.graph, jqp, jqs, device="cpu")
    want, _ = jq_prog.apply(jqp, jqs, {"data": jnp.asarray(data)}, capture=["fc"])
    got, _ = Program(jq_prog.graph, device="cpu").apply(tqp, tqs, {"data": torch.from_numpy(data)},
                                          capture=["fc"])
    for name in ("fc", "probs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)


def test_q_program_init_and_bridge_round_trip():
    """Program.init declares int8 weights (zero) and unit w_scales in the
    reference's shapes; the bridge carries a q-program's params both ways,
    conv weights in K3's memory order."""
    g = _small_video_graph(with_loss=False)
    data = np.random.default_rng(8).standard_normal(g.inputs["data"]).astype(np.float32)
    jprog, p, s, *_ = _jax_and_port(g, data, perturb=False)
    jq_prog, jqp, jqs, _ = jax_quantize_for_serving(jprog, p, s, [{"data": jnp.asarray(data)}])
    tqp, tqs = params_from_jax(jq_prog.graph, jqp, jqs, device="cpu")
    assert tqp["conv1"]["w"].movedim(1, -1).is_contiguous()
    back_p, back_s = params_to_jax(jq_prog.graph, tqp, tqs)
    for lname, lp in jqp.items():
        for pname, v in lp.items():
            assert back_p[lname][pname].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(back_p[lname][pname], np.asarray(v))
    init_p, _ = Program(jq_prog.graph, device="cpu").init(torch.Generator().manual_seed(0),
                                            {"data": g.inputs["data"]})
    for lname in ("conv1", "c3d", "fc"):
        assert init_p[lname]["w"].dtype == torch.int8 and not init_p[lname]["w"].any()
        # init makes int8 conv weights in kernel_layout, as the bridge does
        assert init_p[lname]["w"].movedim(1, -1).is_contiguous()
        assert bool((init_p[lname]["w_scale"] == 1).all())
        assert {k: tuple(v.shape) for k, v in init_p[lname].items()} == \
            {k: tuple(v.shape) for k, v in tqp[lname].items()}


def test_calibrate_takes_max_over_batches():
    g = _small_video_graph(with_loss=False)
    prog = Program(g, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]})
    small = {"data": torch.full(g.inputs["data"], 0.5)}
    big = {"data": torch.full(g.inputs["data"], 2.0)}
    assert calibrate(prog, params, state, [small, big])["conv1"] == pytest.approx(2.0)


def test_quantize_graph_skips_degenerate_and_transposed():
    g = GraphSpec("skips", {"a": (2, 8, 8, 3)}, [
        LayerSpec("dead", "convolution", ("a",), ("y",), {"num_output": 4, "kernel_size": 3}),
        LayerSpec("up", "deconvolution", ("y",), ("z",), {"num_output": 4, "kernel_size": 2}),
    ])
    params = {"dead": {"w": torch.ones(4, 3, 3, 3)}, "up": {"w": torch.ones(4, 4, 2, 2)}}
    qgraph, _, quantized = quantize_graph(g, params, {"dead": 0.0, "up": 3.0})
    assert quantized == [] and [l.type for l in qgraph.layers] == ["convolution", "deconvolution"]


def test_quantized_layers_refuse_train_mode():
    g = _small_video_graph(with_loss=False)
    prog = Program(g, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": g.inputs["data"]})
    data = torch.ones(g.inputs["data"])
    qprog, qp, qs, _ = quantize_for_serving(prog, params, state, [{"data": data}])
    for ltype in ("qconvolution", "qinnerproduct"):
        assert any(l.type == ltype for l in qprog.graph.layers)
    with pytest.raises(ValueError, match="serving-only"):
        Program(qprog.graph, train=True, device="cpu").apply(qp, qs, {"data": data})
    fc_only = GraphSpec("fc_only", {"a": (2, 16)}, [
        LayerSpec("fc", "qinnerproduct", ("a",), ("y",), {"num_output": 4, "act_scale": 0.1})])
    fp, fs = Program(fc_only, device="cpu").init(torch.Generator(), {"a": (2, 16)})
    with pytest.raises(ValueError, match="serving-only"):
        Program(fc_only, train=True, device="cpu").apply(fp, fs, {"a": torch.ones(2, 16)})


# -- int8 chains and the int8 input plane -----------------------------------

def _chain_graph():
    """tests/test_quantize.py's chain graph: conv1 -> relu -> conv2 ->
    eltwise(+skip) -> relu -> conv3, and an AVE-pool branch off t1 into
    conv4."""
    return GraphSpec(
        name="chain",
        inputs={"a": (2, 8, 8, 4)},
        layers=[
            LayerSpec("conv1", "convolution", ("a",), ("t1",),
                      {"num_output": 8, "kernel_size": 3, "pad": 1}),
            LayerSpec("relu1", "relu", ("t1",), ("t1",), {}),
            LayerSpec("conv2", "convolution", ("t1",), ("t2",),
                      {"num_output": 8, "kernel_size": 3, "pad": 1}),
            LayerSpec("add", "eltwise", ("t1", "t2"), ("t3",), {"operation": "sum"}),
            LayerSpec("relu3", "relu", ("t3",), ("t3",), {}),
            LayerSpec("conv3", "convolution", ("t3",), ("t5",),
                      {"num_output": 8, "kernel_size": 1}),
            LayerSpec("pool", "pooling", ("t1",), ("t4",),
                      {"pool": "ave", "kernel_size": 2, "stride": 2}),
            LayerSpec("conv4", "convolution", ("t4",), ("t6",),
                      {"num_output": 8, "kernel_size": 1}),
        ],
    )


def _chain_data(seed):
    return {"a": np.random.default_rng(seed).standard_normal((2, 8, 8, 4)).astype(np.float32)}


def test_chain_int8_rewrites_like_jax_and_matches_unchained():
    """tests/test_quantize.py:409: conv1 and conv2 chain; the eltwise and the
    AVE pool dequantize in-op; chaining adds little error.  The port's
    rewrite equals the reference's on the same calibration."""
    g = _chain_graph()
    data = _chain_data(3)
    jprog, p, s, tprog, tp, ts = _jax_and_port(g, data["a"], perturb=False)
    jdata = {"a": jnp.asarray(data["a"])}
    tdata = {"a": torch.from_numpy(data["a"])}
    j2, _, _, jr2 = jax_quantize_for_serving(jprog, p, s, [jdata], fold=False, chain=True)
    q1, p1, s1, r1 = quantize_for_serving(tprog, tp, ts, [tdata], fold=False, chain=False)
    q2, p2, s2, r2 = quantize_for_serving(tprog, tp, ts, [tdata], fold=False, chain=True)
    assert set(r1["quantized"]) == {"conv1", "conv2", "conv3", "conv4"} and r1["chained"] == []
    assert r2["chained"] == jr2["chained"] and set(r2["chained"]) == {"conv1", "conv2"}
    _assert_same_qgraph(q2.graph, j2.graph)
    by_name = {l.name: l for l in q2.graph.layers}
    assert by_name["conv3"].opt("out_scale") is None
    assert by_name["conv2"].opt("act_scale") == by_name["conv1"].opt("out_scale")
    assert by_name["add"].opt("in_scales") is not None
    assert by_name["pool"].opt("in_scale") == by_name["conv1"].opt("out_scale")
    o1 = q1.apply(p1, s1, tdata)[0]["t5"].numpy()
    o2 = q2.apply(p2, s2, tdata)[0]["t5"].numpy()
    ref = tprog.apply(tp, ts, tdata)[0]["t5"].numpy()
    assert np.abs(o2 - ref).max() <= max(2 * np.abs(o1 - ref).max(), 0.05 * np.abs(ref).max())


def test_chain_int8_intermediate_tensors_are_int8():
    """The wire is int8: the chained conv's top, the int8 max pool of the
    mini graph, and the segment unfold before the 3D convs."""
    g = _chain_graph()
    data = {"a": torch.from_numpy(_chain_data(4)["a"])}
    prog = Program(g, device="cpu")
    p, s = prog.init(torch.Generator().manual_seed(0), {"a": g.inputs["a"]})
    q2, p2, s2, _ = quantize_for_serving(prog, p, s, [data], fold=False, chain=True)
    assert q2.apply(p2, s2, data, capture=["t2"])[0]["t2"].dtype == torch.int8

    mg = _mini_graph()
    mdata = {"data": torch.randn(mg.inputs["data"], generator=torch.Generator().manual_seed(1))}
    prog = Program(mg, device="cpu")
    p, s = prog.init(torch.Generator().manual_seed(0), {"data": mg.inputs["data"]})
    mq, mp, ms, _ = quantize_for_serving(prog, p, s, [mdata])
    outs, _ = mq.apply(mp, ms, mdata, capture=["pool1", "r2Dto3D", "res_a"])
    assert outs["pool1"].dtype == outs["r2Dto3D"].dtype == outs["res_a"].dtype == torch.int8
    assert outs["r2Dto3D"].ndim == 5 and outs["r2Dto3D"].is_contiguous()


def test_chain_int8_respects_float_consumer_boundary():
    g = GraphSpec("edge", {"a": (2, 16)}, [
        LayerSpec("fc1", "innerproduct", ("a",), ("h",), {"num_output": 8}),
        LayerSpec("fc2", "innerproduct", ("h",), ("y",), {"num_output": 4}),
        LayerSpec("prob", "softmax", ("y",), ("p",), {}),
    ])
    data = {"a": torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16))
                                  .astype(np.float32))}
    prog = Program(g, device="cpu")
    p, s = prog.init(torch.Generator().manual_seed(0), {"a": (2, 16)})
    q, qp, qs, r = quantize_for_serving(prog, p, s, [data], fold=False, chain=True)
    assert r["chained"] == ["fc1"]
    assert {l.name: l for l in q.graph.layers}["fc2"].opt("out_scale") is None
    np.testing.assert_allclose(q.apply(qp, qs, data)[0]["p"].numpy(),
                               prog.apply(p, s, data)[0]["p"].numpy(), atol=0.05)


def _q(name, bottom, top, scale):
    return LayerSpec(name, "qconvolution", (bottom,), (top,),
                     {"num_output": 4, "kernel_size": 1, "act_scale": scale})


@pytest.mark.parametrize("case", ["plain", "fed_by_data_layer", "float_graph", "mixed",
                                  "through_relu", "top_reuses_input_name"])
def test_int8_input_rewrite_matches_jax(case):
    """tests/test_quantize.py:181 and :484, and the reference's two open
    findings, matched rather than fixed: the rewrite does not pass through
    ReLU, and a quantized consumer whose top reuses the tracked name leaves
    it tracked (its consumer is rewritten too)."""
    inputs = {"data": (2, 4, 4, 3)}
    layers = {
        "plain": [LayerSpec("r", "reshape", ("data",), ("d2",), {"dims": [0, -1, 4, 4]}),
                  _q("c1", "d2", "y1", 0.5), _q("c2", "data", "y2", 0.8)],
        "fed_by_data_layer": [LayerSpec("feed", "videodata", (), ("data", "label"), {}),
                              _q("c1", "data", "y1", 0.5)],
        "float_graph": [LayerSpec("c1", "convolution", ("data",), ("y1",), {"num_output": 4})],
        "mixed": [_q("c1", "data", "y1", 0.5),
                  LayerSpec("peek", "softmax", ("data",), ("peeked",), {})],
        "through_relu": [LayerSpec("r", "relu", ("data",), ("d2",), {}),
                         _q("c1", "d2", "y1", 0.5)],
        "top_reuses_input_name": [_q("c1", "data", "data", 0.5), _q("c2", "data", "y2", 0.9)],
    }[case]
    g = GraphSpec(case, {} if case == "fed_by_data_layer" else inputs, layers)
    got, scale = int8_input_rewrite(g)
    want, jscale = jax_int8_input_rewrite(g)
    assert scale == jscale
    assert _layer_opts(got) == _layer_opts(want)
    expected = {"plain": 0.8, "fed_by_data_layer": 0.5, "top_reuses_input_name": 0.9}
    assert scale == expected.get(case)
    if scale is None:
        assert got is g
    else:
        assert all(l.opt("act_scale") == scale for l in got.layers if l.type == "qconvolution")


def test_chain_int8_on_a_qgraph_matches_jax():
    """chain_int8 alone on the reference's unchained q-graph of the mini
    graph, with and without calibrated top ranges."""
    g = _mini_graph()
    data = (np.random.default_rng(9).standard_normal(g.inputs["data"]) * 3).astype(np.float32)
    jprog, p, s, *_ = _jax_and_port(g, data)
    jq_prog, *_ = jax_quantize_for_serving(jprog, p, s, [{"data": jnp.asarray(data)}],
                                           chain=False)
    tops = {l.tops[0]: 1.0 + i for i, l in enumerate(jq_prog.graph.layers)
            if l.type in ("qconvolution", "qinnerproduct")}
    for top_maxes in (None, tops):
        got, chained = chain_int8(jq_prog.graph, top_maxes)
        want, jchained = jax_chain_int8(jq_prog.graph, top_maxes)
        assert chained == jchained and chained
        assert _layer_opts(got) == _layer_opts(want)


# -- the int8 input plane of UInt8Server ------------------------------------

def _server_setup(seed=13, crop=16):
    g = _small_video_graph(with_loss=False)
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (4, 4, 24, 28, 3), dtype=np.uint8)
    calib = (rng.standard_normal((4, 4, crop, crop, 3)) * 120).astype(np.float32)
    jprog, p, s, tprog, tp, ts = _jax_and_port(g, calib, perturb=False)
    return g, frames, calib, (jprog, p, s), (tprog, tp, ts)


def test_uint8_server_int8_input_plane_exact():
    """tests/test_quantize.py:213: int8_input on and off agree exactly at
    f32, the wire into conv1 is K1's int8 output, and it equals the q-layer's
    own quantize of the float clips."""
    crop = 16
    g, frames, calib, _, (tprog, tp, ts) = _server_setup()
    qprog, qp, qs, _ = quantize_for_serving(tprog, tp, ts, [{"data": torch.from_numpy(calib)}])
    s_off = UInt8Server(qprog, qp, qs, crop=crop, int8_input=False)
    s_on = UInt8Server(qprog, qp, qs, crop=crop)
    assert s_off.in_scale is None and s_on.in_scale is not None
    assert s_on.in_scale == max(l.opt("act_scale") for l in s_on.program.graph.layers
                                if l.name == "conv1")
    f = torch.from_numpy(frames)
    fed = []
    for server in (s_off, s_on):
        apply = server.program.apply
        server.program.apply = lambda p, s, inputs, _apply=apply, **kw: (
            fed.append(inputs["data"].dtype), _apply(p, s, inputs, **kw))[1]
    assert torch.equal(s_off(f), s_on(f))
    # the wire into conv1: the float plane's bf16 clips (integers below 256,
    # so exact) against K1's int8
    assert fed == [torch.bfloat16, torch.int8]
    n = frames.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32)
    mirror = torch.tensor([True, False, True, False])
    f32 = preprocess_on_device(f, zeros, zeros, mirror, crop=crop, out_dtype=torch.float32)
    q = preprocess_on_device(f, zeros, zeros, mirror, crop=crop, act_scale=s_on.in_scale)
    assert q.dtype == torch.int8
    assert torch.equal(q, quantize_act(f32, s_on.in_scale))
    # the float graph: no quantized consumer of the input, the plane is off
    assert UInt8Server(Program(g, device="cpu"), tp, ts, crop=crop).in_scale is None


def test_int8_uint8_server_matches_jax():
    """tests/test_quantize.py:155 across the packages: the reference's
    quantized graph and weights through the bridge, served from the same
    uint8 frames with the int8 input plane on both sides (the reference's
    Pallas kernel in interpret mode), f32."""
    crop = 16
    _, frames, calib, (jprog, p, s), _ = _server_setup(seed=14)
    jq_prog, jqp, jqs, _ = jax_quantize_for_serving(jprog, p, s, [{"data": jnp.asarray(calib)}])
    jserver = JaxUInt8Server(jq_prog, jqp, jqs, crop=crop, interpret=True)
    want = np.asarray(jserver(jnp.asarray(frames)))
    tqp, tqs = params_from_jax(jq_prog.graph, jqp, jqs, device="cpu")
    tserver = UInt8Server(Program(jq_prog.graph, device="cpu"), tqp, tqs, crop=crop)
    assert tserver.in_scale == jserver._in_scale
    got = tserver(torch.from_numpy(frames)).numpy()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
