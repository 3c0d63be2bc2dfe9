"""The port's ``eco`` CLI (``python -m eco_tpu_torch.tools.cli``) against the
reference's, on the CPU (``--device cpu``): ``train`` on
``tests/test_cli_pipelines.py``'s tiny net over the ``python`` and ``raw``
planes, a snapshot from one ``--weights`` file held to the JAX CLI's within
1e-4 (the mini-graph bound of ``tests/test_torch_train.py``), ``quantize``
then ``test``, ``convert``/``parity``/``export``/``fold`` on
``tests/fixtures/mini_eco.*`` against ``eco_tpu``'s, ``upgrade``/``plot``/
``draw`` output equal to the reference's, cross-layer shared params and the
stochastic layers against ``eco_tpu``'s executor, the CLI's exits for
``--dp``/``--tp``, and the copied modules held line for line."""

import json
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eco_tpu.convert import import_caffe_weights as jax_import_caffe_weights
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import GraphSpec as JaxGraphSpec
from eco_tpu.spec.graph import LayerSpec as JaxLayerSpec
from eco_tpu.spec.prototxt import graph_from_prototxt as jax_graph_from_prototxt
from eco_tpu.tools.cli import main as jax_main
from eco_tpu_torch.convert import import_caffe_weights, params_from_jax
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.runtime.profiler import format_layer_times, time_layers
from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec, graph_to_json
from eco_tpu_torch.spec.netspec import NetBuilder
from eco_tpu_torch.spec.prototxt import graph_from_prototxt
from eco_tpu_torch.tools.cli import main
from eco_tpu_torch.train import save_model
from test_cli_pipelines import NET_TMPL, SOLVER_TMPL
from test_torch_train import _mini_train_graph
from test_weights_recipe import FIXTURE_MODEL, FIXTURE_NET

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
COPIES = ["convert/write.py", "tools/datasets.py", "tools/logparse.py", "tools/draw.py"]


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_original_with_its_imports_rewritten(path):
    original = (REPO / "eco_tpu" / path).read_text()
    note, copy = (REPO / "eco_tpu_torch" / path).read_text().split("\n", 1)
    assert note.startswith(f"# A copy of eco_tpu/{path} ")
    assert copy == re.sub(r"^(\s*)from eco_tpu\.", r"\1from eco_tpu_torch.", original,
                          flags=re.M)
    assert "import jax" not in copy and "from eco_tpu." not in copy


def _frames(root, videos, frame, seed=0):
    """``videos`` directories of 10 JPEG frames made by ``frame(rng, v)``,
    64x80, and their list file."""
    rng = np.random.default_rng(seed)
    lines = []
    for v in range(videos):
        d = root / f"v{v}"
        d.mkdir(parents=True)
        for f in range(10):
            cv2.imwrite(str(d / ("img_%04d.jpg" % (f + 1))), frame(rng, v))
        lines.append(f"{d} 10 {v % 3}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return str(root / "list.txt")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``tests/test_cli_pipelines.py``'s noise videos."""
    return _frames(tmp_path_factory.mktemp("clids"), 6,
                   lambda rng, v: rng.integers(0, 255, (64, 80, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def color_dataset(tmp_path_factory):
    """``tests/test_weights_recipe.py``'s solid-colour videos (label = the
    dominant BGR channel), which the mini_eco fixture classifies."""

    def frame(rng, v):
        color = [30, 30, 30]
        color[v % 3] = 200
        img = np.full((64, 80, 3), color, np.int32) + rng.integers(-10, 10, (64, 80, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    return _frames(tmp_path_factory.mktemp("colors"), 6, frame)


def _cfg(tmp_path, dataset, prefix, snapshot=2):
    net = tmp_path / "net.prototxt"
    net.write_text(NET_TMPL.format(list=dataset))
    solver = tmp_path / f"{prefix}_solver.prototxt"
    solver.write_text(SOLVER_TMPL.format(net=str(net), prefix=str(tmp_path / prefix))
                      .replace("snapshot: 0", f"snapshot: {snapshot}"))
    return str(net), str(solver)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("pipeline", ["python", "raw"])
def test_train_on_the_python_and_raw_planes(pipeline, dataset, tmp_path, capsys):
    """The raw plane of the tiny net samples multi-scale windows, so its
    steps run the resize of ops/resize.py."""
    net, solver = _cfg(tmp_path, dataset, "snap")
    ts = main(["train", "--solver", solver, "--net", net, "--pipeline", pipeline, *CPU])
    assert ts.it == 2 and ts.params["fc"]["w"].device.type == "cpu"
    out = capsys.readouterr().out
    assert "Iteration 1, loss = " in out and "Snapshotting to" in out
    assert Path(tmp_path / "snap_iter_2.model.npz").exists()


def test_snapshot_from_one_weights_file_matches_the_jax_cli(dataset, tmp_path):
    net, _ = _cfg(tmp_path, dataset, "unused")
    graph = graph_from_prototxt(open(net).read())
    prog = Program(graph, train=True, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(3),
                              {"data": (3, 2, 32, 32, 3), "label": (3,)})
    weights = str(tmp_path / "init.model.npz")
    save_model(weights, params, state)
    for who, run in (("port", lambda a: main(a + CPU)), ("ref", jax_main)):
        _, solver = _cfg(tmp_path, dataset, who)
        run(["train", "--solver", solver, "--net", net, "--weights", weights])
    got, want = (_npz(tmp_path / f"{who}_iter_2.model.npz") for who in ("port", "ref"))
    assert got.keys() == want.keys() and len(got) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert not np.array_equal(got["params/fc/w"], _npz(weights)["params/fc/w"])


def test_quantize_then_test(dataset, tmp_path, capsys):
    net, solver = _cfg(tmp_path, dataset, "snap")
    main(["train", "--solver", solver, "--net", net, *CPU])
    out = str(tmp_path / "int8")
    main(["quantize", "--net", net, "--weights", str(tmp_path / "snap_iter_2.model.npz"),
          "--list", dataset, "--calib-batches", "2", "-o", out, *CPU])
    assert "Quantized 2 layers" in capsys.readouterr().out
    qgraph = json.load(open(out + ".graph.json"))
    assert {"qconvolution", "qinnerproduct"} <= {l["type"] for l in qgraph["layers"]}
    means = main(["test", "--net", out + ".graph.json", "--list", dataset,
                  "--weights", out + ".npz", "--iterations", "2", *CPU])
    assert set(means) == {"loss", "top1"} and all(np.isfinite(list(means.values())))


def test_extract_matches_the_jax_cli(tmp_path):
    """A deploy-style graph (declared input, the CLI's zoo data defaults:
    crop 224) with the same weights in both CLIs."""
    b = NetBuilder("tiny224")
    x = b.layer("fold", "fold_segments", b.input("data", (3, 2, 224, 224, 3)))
    x = b.relu("relu1", b.conv("conv1", x, 8, k=3, s=4, p=1))
    b.fc("fc", b.layer("gpool", "global_avg_pool", x), 3)
    graph = b.build()
    net = tmp_path / "tiny.graph.json"
    net.write_text(graph_to_json(graph))
    weights = str(tmp_path / "w.model.npz")
    save_model(weights, *Program(graph, device="cpu").init(
        torch.Generator().manual_seed(0), {"data": graph.inputs["data"]}))
    big = _frames(tmp_path / "big", 3, lambda rng, v: rng.integers(0, 255, (240, 256, 3),
                                                                 dtype=np.uint8))
    for who, run in (("port", lambda a: main(a + CPU)), ("ref", jax_main)):
        run(["extract", "--net", str(net), "--list", big, "--batch", "3", "--segments", "2",
             "--weights", weights, "--blobs", "conv1,fc", "-o", str(tmp_path / f"{who}.npz")])
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "ref.npz")
    assert got.keys() == want.keys() == {"conv1", "fc"}
    assert got["fc"].shape == (6, 3)  # 3 videos x 2 segments, one row a frame
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_convert_parity_export_and_fold_match_the_reference(color_dataset, tmp_path, capsys):
    got, want = str(tmp_path / "port.model.npz"), str(tmp_path / "ref.model.npz")
    main(["convert", "--caffemodel", FIXTURE_MODEL, "--net", FIXTURE_NET, "-o", got, *CPU])
    jax_main(["convert", "--caffemodel", FIXTURE_MODEL, "--net", FIXTURE_NET, "-o", want])
    a, b = _npz(got), _npz(want)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in b)
    assert capsys.readouterr().out.count("Converted 3 layers (0 skipped)") == 2

    # the API: the port's import equals the reference's, carried across
    graph, jgraph = (f(open(FIXTURE_NET).read()) for f in
                     (graph_from_prototxt, jax_graph_from_prototxt))
    sample = {"data": (3, 2, 32, 32, 3), "label": (3,)}
    p, s = Program(graph, device="cpu").init(torch.Generator().manual_seed(0), sample)
    p, s, report = import_caffe_weights(graph, p, s, FIXTURE_MODEL)
    jp, js = JaxProgram(jgraph, train=False).init(jax.random.PRNGKey(0),
                                    {k: jnp.zeros(v) for k, v in sample.items()})
    jp, js, jreport = jax_import_caffe_weights(jgraph, jp, js, FIXTURE_MODEL)
    wp, ws = params_from_jax(graph, jp, js, device="cpu")
    assert report == jreport
    for tree, want_tree in ((p, wp), (s, ws)):
        assert tree.keys() == want_tree.keys()
        for ln in tree:
            for k in tree[ln]:
                assert torch.equal(tree[ln][k], want_tree[ln][k]), (ln, k)

    means = main(["test", "--net", FIXTURE_NET, "--weights", got, "--list", color_dataset,
                  "--iterations", "4", *CPU])
    assert means["top1"] == 1.0
    verdict = main(["parity", "--caffemodel", FIXTURE_MODEL, "--net", FIXTURE_NET,
                    "--list", color_dataset, "--iterations", "4", "--expect-top1", "1.0",
                    "--int8", "-o", str(tmp_path / "verdict.json"), *CPU])
    assert verdict["pass"] is True
    gates = verdict["gates"]
    assert gates["int8_quantization"]["argmax_agreement"] == 1.0
    assert gates["bn_fold_consistency"]["max_abs_diff"] <= 1e-5
    jverdict = jax_main(["parity", "--caffemodel", FIXTURE_MODEL, "--net", FIXTURE_NET,
                         "-o", str(tmp_path / "jverdict.json")])
    np.testing.assert_allclose(
        np.load(gates["fixed_input_logits"]["dumped"])["logits"],
        np.load(jverdict["gates"]["fixed_input_logits"]["dumped"])["logits"],
        rtol=1e-5, atol=1e-5)

    for who, run in (("port", lambda a: main(a + CPU)), ("ref", jax_main)):
        run(["export", "--net", FIXTURE_NET, "--weights", got, "-o",
             str(tmp_path / f"{who}.caffemodel")])
        run(["fold", "--net", FIXTURE_NET, "--weights", got, "-o",
             str(tmp_path / f"{who}_folded.npz")])
    assert (tmp_path / "port.caffemodel").read_bytes() == \
        (tmp_path / "ref.caffemodel").read_bytes()
    assert (tmp_path / "port_folded.graph.json").read_text() == \
        (tmp_path / "ref_folded.graph.json").read_text()
    a, b = _npz(tmp_path / "port_folded.npz"), _npz(tmp_path / "ref_folded.npz")
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7, err_msg=k)


V1_NET = '''
name: "v1net"
input: "data"
input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "prob" type: SOFTMAX bottom: "pool1" top: "prob" }
'''


def test_upgrade_plot_and_draw_write_what_the_reference_writes(dataset, tmp_path, capsys):
    (tmp_path / "v1.prototxt").write_text(V1_NET)
    net, solver = _cfg(tmp_path, dataset, "snap")
    main(["train", "--solver", solver, "--net", net, *CPU])
    log = capsys.readouterr().out
    for who, run in (("port", main), ("ref", jax_main)):
        d = tmp_path / who
        d.mkdir()
        run(["upgrade", str(tmp_path / "v1.prototxt"), str(d / "v2.prototxt")])
        (d / "train.log").write_text(log)
        run(["plot", str(d / "train.log")])
        run(["draw", "--net", net, "-o", str(d / "net.dot")])
    for name in ("v2.prototxt", "train.log.train", "train.log.test", "net.dot"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "ref" / name).read_text()
    assert len((tmp_path / "port" / "train.log.train").read_text().splitlines()) == 3


def test_what_is_not_ported_exits_naming_its_roadmap_item(dataset, tmp_path, capsys):
    """Everything is ported now (``aot``, ``--dp``/``--tp``:
    tests/test_torch_export.py, tests/test_torch_multiprocess.py); the exits
    left are the reference's own, for a batch ``--dp`` does not divide and
    for more ranks than devices."""
    net, solver = _cfg(tmp_path, dataset, "snap")
    for argv, match in (
            (["train", "--solver", solver, "--net", net, "--dp", "2", *CPU],
             "--dp 2 must divide the batch size 3"),
            (["train", "--solver", solver, "--net", net, "--dp", "3", "--tp", "100000", *CPU],
             "exceeds the"),
            (["test", "--net", net, "--weights", "w.npz", "--dp", "4", *CPU],
             "--dp 4 must divide the batch size 3")):
        with pytest.raises(SystemExit, match=match):
            main(argv)
    # --dp 0 means every visible device: one here
    assert main(["train", "--solver", solver, "--net", net, "--dp", "0", *CPU]).it == 2
    main(["device-query"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("device 0: ")


def test_time_prints_the_layer_table_on_the_cpu(tmp_path, capsys):
    """``time`` on a graph that declares its input; the profiler's rows in
    forward and backward (the floor check holds on the card only)."""
    g = _mini_train_graph()
    net = tmp_path / "mini.graph.json"
    net.write_text(graph_to_json(GraphSpec(g.name, {"data": g.inputs["data"]},
                                           [l for l in g.layers if l.type != "softmaxwithloss"
                                            and l.type != "accuracy"])))
    rows = main(["time", "--net", str(net), "--iters", "1", "--backward", *CPU])
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["layer", "type", "fwd", "ms", "bwd", "ms"]
    assert "TOTAL (sum of isolated layers)" in out
    prog = Program(g, train=True, device="cpu")
    assert [r[0] for r in rows] == [l.name for l in prog.exec_layers
                                    if l.type != "softmaxwithloss"]
    assert all(len(r) == 4 and r[2] >= 0 for r in rows)
    assert all(r[3] >= 0 for r in rows if r[1] != "fold_segments")
    tp, ts_ = Program(g, device="cpu").init(torch.Generator().manual_seed(0),
                                            {"data": g.inputs["data"], "label": (2,)})
    fwd = time_layers(Program(g, device="cpu"), tp, ts_,
                      {"data": torch.zeros(g.inputs["data"]), "label": torch.zeros(2).long()},
                      iters=1, warmup=0)
    assert len(fwd[0]) == 3 and len(format_layer_times(fwd).splitlines()) == len(fwd) + 2


SHARED_NET = '''
name: "shared"
input: "data"
input_dim: 2 input_dim: 4 input_dim: 8 input_dim: 8
layers {
  name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  param: "shared_conv_w" param: "shared_conv_b"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 }
}
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers {
  name: "conv2" type: CONVOLUTION bottom: "conv1" top: "conv2"
  param: "shared_conv_w" param: "shared_conv_b"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 }
}
layers { name: "pool1" type: POOLING bottom: "conv2" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "fc" type: INNER_PRODUCT bottom: "pool1" top: "fc"
  inner_product_param { num_output: 5 } }
layers { name: "prob" type: SOFTMAX bottom: "fc" top: "prob" }
'''


def test_shared_params_match_the_reference():
    """``tests/test_convert.py:484``'s ``param: "shared_conv_w"`` net with a
    second conv naming the same blobs: the first conv owns them, the second
    aliases them and has no entry; outputs and the owner's gradients (the
    sum over both uses) within 1e-6."""
    graph, jgraph = graph_from_prototxt(SHARED_NET), jax_graph_from_prototxt(SHARED_NET)
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    jprog = JaxProgram(jgraph, train=False)
    jp, js = jprog.init(jax.random.PRNGKey(0), {"data": jnp.asarray(x)})
    prog = Program(graph, device="cpu")
    own_p, _ = prog.init(torch.Generator().manual_seed(0), {"data": x.shape})
    assert set(own_p) == set(jp) == {"conv1", "fc"}
    tp, ts_ = params_from_jax(graph, jp, js, device="cpu")
    weights = np.arange(5, dtype=np.float32)

    def jloss(p):
        return jnp.sum(jprog.apply(p, js, {"data": jnp.asarray(x)})[0]["prob"] * weights)

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = {ln: {k: v.clone().requires_grad_() for k, v in lp.items()} for ln, lp in tp.items()}
    outs, _ = prog.apply(leaves, ts_, {"data": torch.from_numpy(x)})
    loss = (outs["prob"] * torch.from_numpy(weights)).sum()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    keys = [(ln, k) for ln in leaves for k in leaves[ln]]
    grads = torch.autograd.grad(loss, [leaves[ln][k] for ln, k in keys])
    gtree: dict = {}
    for (ln, k), g in zip(keys, grads):
        gtree.setdefault(ln, {})[k] = g
    want, _ = params_from_jax(graph, jg, {}, device="cpu")
    for ln, k in keys:
        np.testing.assert_allclose(gtree[ln][k].numpy(), want[ln][k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{ln}/{k}")


def _stochastic_graph(spec_cls, graph_cls, pad=0):
    layers = [
        spec_cls("relu", "relu", ("data",), ("r",)),
        spec_cls("spool", "pooling", ("r",), ("p",),
                 {"pool": "STOCHASTIC", "kernel_size": 3, "stride": 2, "pad": pad}),
        spec_cls("half", "pooling", ("r",), ("q",),
                 {"pool": "MAX", "kernel_size": 3, "stride": 2}),
        spec_cls("ssum", "eltwise", ("p", "q"), ("y",),
                 {"operation": "STOCHASTIC_SUM", "coeffs": [0.3, 0.8]}),
    ]
    return graph_cls("stochastic", {"data": (2, 7, 9, 3)}, layers)


def test_stochastic_pool_and_sum_match_the_reference_at_test():
    x = np.random.default_rng(1).standard_normal((2, 7, 9, 3)).astype(np.float32)
    jg = _stochastic_graph(JaxLayerSpec, JaxGraphSpec)
    jprog = JaxProgram(jg, train=False)
    jp, js = jprog.init(jax.random.PRNGKey(0), {"data": jnp.asarray(x)})
    want = jprog.apply(jp, js, {"data": jnp.asarray(x)}, capture=["p"])[0]
    got = Program(_stochastic_graph(LayerSpec, GraphSpec), device="cpu").apply(
        {}, {}, {"data": torch.from_numpy(x)}, capture=["p"])[0]
    for k in ("p", "y"):
        assert got[k].shape == tuple(want[k].shape) == (2, 3, 4, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_stochastic_layers_draw_from_the_step_seed_in_train_and_reject_a_pad():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 7, 9, 3))
                         .astype(np.float32))
    prog = Program(_stochastic_graph(LayerSpec, GraphSpec), train=True, device="cpu")
    run = lambda seed: prog.apply({}, {}, {"data": x}, capture=["p", "q"],
                                  generator=torch.Generator().manual_seed(seed))[0]
    a, b = run(0), run(0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # each pooled value is one of its window's values (the windows of the
    # max pool beside it hold them all)
    assert (a["p"] <= a["q"]).all() and (a["p"] >= 0).all()
    # the sum keeps each bottom or drops it
    assert any(torch.equal(a["y"], y) for y in (a["p"], a["q"], a["p"] + a["q"],
                                                torch.zeros_like(a["q"])))
    with pytest.raises(ValueError, match="generator"):
        prog.apply({}, {}, {"data": x})
    bad = Program(_stochastic_graph(LayerSpec, GraphSpec, pad=1), device="cpu")
    with pytest.raises(ValueError, match="pad"):
        bad.apply({}, {}, {"data": x})
