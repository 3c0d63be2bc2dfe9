"""eco_tpu_torch's online and 10-crop apps, and its fed train path, against
eco_tpu's on the CPU, on weights carried across by ``params_from_jax``.

- Online recognition, single and multi-stream, both window memories, the
  f32 and uint8 planes: the labels equal and the smoothed logits within
  rtol 1e-4 / atol 1e-5 (f32 convolutions summed in other orders, ~1e-7).
  The reference's uint8 plane runs its Pallas crop/normalize kernel in
  interpret mode; the port's takes the kernel's plain version.
- The int8 plane: each package quantizes the tiny graph itself; the smoothed
  logits agree within relative L2 2.2e-2, the int8 end-to-end bound of
  PERF.md section 2 (one-ulp float differences flip int8 roundings).
- 10-crop evaluation within 1e-5; ``ten_crop`` and ``ten_crop_flow`` equal.
- Training fed by the port's ``VideoPipeline(raw=True)`` through
  ``prefetch_to_device``, against the reference's ``eco train`` composition
  on the same batches: losses within 1e-4 (the mini-graph bound).
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eco_tpu.apps import online as jonline
from eco_tpu.apps import tsn_eval as jtsn
from eco_tpu.apps.serving import RawPreprocessProgram as JaxRawPreprocessProgram
from eco_tpu.convert.quantize import quantize_for_serving as jax_quantize_for_serving
from eco_tpu.data import VideoPipeline as JaxVideoPipeline
from eco_tpu.data import prefetch_to_device as jax_prefetch_to_device
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import graph_to_json as jax_graph_to_json
from eco_tpu.spec.netspec import NetBuilder
from eco_tpu.spec.prototxt import graph_from_prototxt as jax_graph_from_prototxt
from eco_tpu.tools.cli import _data_cfg_from_graph
from eco_tpu.train import SolverConfig as JaxSolverConfig
from eco_tpu.train import init_train_state as jax_init_train_state
from eco_tpu.train.loop import Trainer as JaxTrainer
from eco_tpu_torch.apps import (
    MultiStreamRecognizer,
    OnlineRecognizer,
    OversampleEvaluator,
    RawPreprocessProgram,
    ten_crop,
)
from eco_tpu_torch.apps import online, tsn_eval
from eco_tpu_torch.convert import params_from_jax, quantize_for_serving
from eco_tpu_torch.data import (
    TransformConfig,
    VideoDataConfig,
    VideoPipeline,
    VideoRecord,
    prefetch_to_device,
)
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.graph import graph_from_json
from eco_tpu_torch.spec.prototxt import graph_from_prototxt
from eco_tpu_torch.train import SolverConfig, Trainer, init_train_state
from test_apps_tools import _tiny_video_model

FIXTURES = Path(__file__).resolve().parent / "fixtures"
S, CROP, CLASSES = 4, 32, 4
RTOL, ATOL = 1e-4, 1e-5
INT8_REL_L2_BOUND = 2.2e-2


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    the fed train path needs it on."""
    with torch.enable_grad():
        yield


def _port_graph(graph):
    return graph_from_json(jax_graph_to_json(graph))


@functools.cache
def _tiny_pair(kind="online"):
    """The reference's tiny model (the online one, or a 10-crop RGB or flow
    one) and its weights, and the port's; made once, used read-only."""
    g = {"online": lambda: _tiny_video_model(num_classes=CLASSES, S=S, crop=CROP),
         "rgb": lambda: _eval_graph("rgb", 3, S),
         "flow": lambda: _eval_graph("flow", 4, 3)}[kind]()
    shape = g.inputs["data"]
    jprog = JaxProgram(g, train=False)
    p, s = jprog.init(jax.random.PRNGKey(0), {"data": jnp.zeros(shape)})
    gp = _port_graph(g)
    tp, ts = params_from_jax(gp, p, s, device="cpu")
    return (jprog, p, s), (Program(gp, device="cpu"), tp, ts)


def _frames(seed, n, hw=(256, 340)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _assert_same_tick(got, want):
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("plane", ["f32", "uint8"])
@pytest.mark.parametrize("memory", ["destructive", "full"])
def test_online_recognizer_matches_the_reference(plane, memory):
    """Seven windows: the whole allocation schedule, then five windows kept;
    one frame of another size goes through the resize."""
    (jprog, p, s), (tprog, tp, ts) = _tiny_pair()
    kw = dict(num_segments=S, crop_size=CROP, window_memory=memory, plane=plane)
    want = jonline.OnlineRecognizer(jprog, p, s, **kw)
    got = OnlineRecognizer(tprog, tp, ts, **kw)
    frames = _frames(1, 7 * S)
    frames[5] = _frames(2, 1, (240, 320))[0]
    ticks = 0
    for frame in frames:
        w = want.push_frame(frame)
        _assert_same_tick(got.push_frame(frame), w)
        ticks += w is not None
    assert ticks == 7 and got._stream.n_forwards == 7
    assert [len(w) for w in got._stream.windows] == [len(w) for w in want._stream.windows]
    if plane == "uint8":
        assert got._stream.windows[-1][0].dtype == np.uint8


@pytest.mark.parametrize("plane,memory,workers", [
    ("f32", "destructive", 0), ("uint8", "destructive", 2), ("uint8", "full", 0)])
def test_multi_stream_recognizer_matches_the_reference(plane, memory, workers):
    """Three streams of different frames, six ticks each, one batched forward
    a tick padded to the fixed batch."""
    (jprog, p, s), (tprog, tp, ts) = _tiny_pair()
    kw = dict(num_streams=3, num_segments=S, crop_size=CROP, window_memory=memory,
              plane=plane, num_workers=workers)
    want = jonline.MultiStreamRecognizer(jprog, p, s, **kw)
    calls = []
    with MultiStreamRecognizer(tprog, tp, ts, **kw) as got:
        forward = got.single._forward
        got.single._forward = lambda clips, batch=1: (calls.append((len(clips), batch)),
                                                      forward(clips, batch))[1]
        for i in range(6 * S):
            frames = _frames(100 + i, 3)
            for g, w in zip(got.push_frames(frames), want.push_frames(frames)):
                _assert_same_tick(g, w)
    want.close()
    assert calls == [(3, 3)] * 6
    assert got._pool is None


def test_a_padded_tick_keeps_each_stream_result():
    """A tick with fewer clips than streams is padded with zero clips to the
    fixed batch: at one batch size a clip's logits do not depend on the rows
    beside it (across batch sizes the convolutions may pick other
    algorithms, which is why the batch is fixed)."""
    _, (tprog, tp, ts) = _tiny_pair()
    rec = OnlineRecognizer(tprog, tp, ts, num_segments=S, crop_size=CROP, plane="uint8")
    clip, other = ([online.preprocess_frame_u8(f, crop_size=CROP) for f in _frames(seed, S)]
                   for seed in (5, 6))
    padded = rec._forward([clip], 3)
    assert padded.shape == (3, CLASSES)
    np.testing.assert_array_equal(padded[1], padded[2])
    np.testing.assert_array_equal(padded[0], rec._forward([clip, other, other], 3)[0])
    zeros = [np.zeros_like(f) for f in clip]
    np.testing.assert_array_equal(padded[1], rec._forward([clip, zeros, other], 3)[1])
    np.testing.assert_allclose(padded[0], rec._forward([clip])[0], rtol=RTOL, atol=ATOL)


def test_online_int8_plane_matches_the_reference():
    """Each package quantizes the tiny graph on the same calibration clips;
    the uint8 plane then feeds conv1 int8 from the crop/normalize kernel."""
    (jprog, p, s), (tprog, tp, ts) = _tiny_pair()
    calib = (np.random.default_rng(4).standard_normal((2, S, CROP, CROP, 3)) * 60
             ).astype(np.float32)
    jq, jqp, jqs, _ = jax_quantize_for_serving(jprog, p, s, [{"data": jnp.asarray(calib)}])
    tq, tqp, tqs, rep = quantize_for_serving(tprog, tp, ts, [{"data": torch.from_numpy(calib)}])
    assert "conv1" in rep["quantized"]
    kw = dict(num_segments=S, crop_size=CROP, plane="uint8")
    want = jonline.OnlineRecognizer(jq, jqp, jqs, **kw)
    got = OnlineRecognizer(tq, tqp, tqs, **kw)
    assert got.in_scale is not None and got.in_scale == pytest.approx(want.program.graph.layer(
        "conv1").opt("act_scale"), rel=1e-6)
    fed = []
    apply = got.program.apply
    got.program.apply = lambda p, s, inputs, **kw: (fed.append(inputs["data"].dtype),
                                                    apply(p, s, inputs, **kw))[1]
    worst = 0.0
    for frame in _frames(6, 3 * S):
        w, g = want.push_frame(frame), got.push_frame(frame)
        assert (g is None) == (w is None)
        if w is not None:
            worst = max(worst, float(np.linalg.norm(g[1] - w[1]) / np.linalg.norm(w[1])))
    assert worst <= INT8_REL_L2_BOUND
    assert fed == [torch.int8] * 3


def test_run_capture_loop_over_a_frame_directory(tmp_path):
    """The reference's headless webcam loop over ``_FrameDirCapture``: the
    same ticks, labels and callbacks; a non-image file is skipped."""
    for i, frame in enumerate(_frames(7, 2 * S + 1)):
        cv2.imwrite(str(tmp_path / f"frame_{i:03d}.jpg"), frame)
    (tmp_path / "notes.txt").write_text("not an image")
    (jprog, p, s), (tprog, tp, ts) = _tiny_pair()
    names = ["jump", "run", "swim", "dive"]
    seen = []
    got = online.run_capture_loop(
        OnlineRecognizer(tprog, tp, ts, num_segments=S, crop_size=CROP),
        online._FrameDirCapture(str(tmp_path)), class_names=names,
        on_prediction=lambda *tick: seen.append(tick))
    want = jonline.run_capture_loop(
        jonline.OnlineRecognizer(jprog, p, s, num_segments=S, crop_size=CROP),
        jonline._FrameDirCapture(str(tmp_path)), class_names=names)
    assert got == want and seen == got
    assert [t[0] for t in got] == [S, 2 * S]
    short = online.run_capture_loop(
        OnlineRecognizer(tprog, tp, ts, num_segments=S, crop_size=CROP),
        online._FrameDirCapture(str(tmp_path)), max_frames=S - 1)
    assert short == []


# --------------------------------------------------------------------------
# 10-crop evaluation
# --------------------------------------------------------------------------


def test_ten_crops_equal_the_reference():
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ten_crop(img, 48), jtsn.ten_crop(img, 48))
    stack = rng.integers(0, 256, (64, 80, 6)).astype(np.float32)
    np.testing.assert_array_equal(tsn_eval.ten_crop_flow(stack, 48),
                                  jtsn.ten_crop_flow(stack, 48))


def _eval_graph(name, channels, samples):
    b = NetBuilder(name)
    x = b.input("data", (10, samples, CROP, CROP, channels))
    x = b.layer("fold", "fold_segments", x)
    x = b.conv("c", x, 4, k=3, s=2, p=1)
    x = b.layer("unfold", "unfold_segments", x, num_segments=samples)
    x = b.layer("gap", "global_avg_pool", x)
    y = b.fc("fc", x, 3)
    b.layer("probs", "softmax", y)
    return b.build()


def test_oversample_evaluator_matches_the_reference(tmp_path):
    rng = np.random.default_rng(9)
    vdir = tmp_path / "vid"
    (vdir / "flow_x").mkdir(parents=True)
    (vdir / "flow_y").mkdir(parents=True)
    for f in range(20):
        cv2.imwrite(str(vdir / ("img_%04d.jpg" % (f + 1))),
                    rng.integers(0, 256, (60, 70, 3), dtype=np.uint8))
        for axis in ("flow_x", "flow_y"):
            cv2.imwrite(str(vdir / axis / ("flow_%05d.jpg" % (f + 1))),
                        rng.integers(0, 256, (60, 70), dtype=np.uint8))
    rgb = dict(num_frames=10, num_segments=S, crop=CROP, resize_hw=(48, 56))
    (jprog, p, s), (tprog, tp, ts) = _tiny_pair("rgb")
    want = jtsn.OversampleEvaluator(jprog, p, s).predict_video(str(vdir), 20, **rgb)
    got = OversampleEvaluator(tprog, tp, ts).predict_video(str(vdir), 20, **rgb)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tsn_eval.oversample_video(str(vdir), 20, **rgb),
                                  jtsn.oversample_video(str(vdir), 20, **rgb))

    flow = dict(num_samples=3, optical_flow_frames=2, crop=CROP, resize_hw=(48, 56))
    (jprog, p, s), (tprog, tp, ts) = _tiny_pair("flow")
    want = jtsn.OversampleEvaluator(jprog, p, s).predict_flow_video(str(vdir), 20, **flow)
    got = OversampleEvaluator(tprog, tp, ts).predict_flow_video(str(vdir), 20, **flow)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    acc = OversampleEvaluator(tprog, tp, ts).evaluate(
        [VideoRecord(str(vdir), 20, int(np.argmax(got)))], modality="FLOW", **flow)
    assert acc == 1.0


# --------------------------------------------------------------------------
# the fed train path
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mini_video_list(tmp_path_factory):
    root = tmp_path_factory.mktemp("fed_videos")
    rng = np.random.default_rng(10)
    lines = []
    for v in range(6):
        d = root / f"vid{v}"
        d.mkdir()
        for f in range(8):
            cv2.imwrite(str(d / ("img_%04d.jpg" % (f + 1))),
                        rng.integers(0, 256, (64, 80, 3), dtype=np.uint8))
        lines.append(f"{d} 8 {v % 3}")
    lst = root / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


def test_fed_training_matches_the_reference_train_composition(mini_video_list):
    """``eco train``'s composition (tools/cli.py): the prototxt's VideoData
    layer on the raw uint8 plane, micro-batches, ``prefetch_to_device`` at
    depth 1 and ``Trainer(metrics_lag=1)``, four SGD steps with momentum,
    in both packages from shared weights; each side's own pipeline and
    prefetch feed its trainer."""
    text = (FIXTURES / "mini_eco.prototxt").read_text()
    jgraph, graph = jax_graph_from_prototxt(text), graph_from_prototxt(text)
    jcfg = dataclasses.replace(_data_cfg_from_graph(jgraph, "train", mini_video_list), raw=True)
    cfg = VideoDataConfig(**{**{f.name: getattr(jcfg, f.name) for f in
                                dataclasses.fields(jcfg)},
                             "transform": TransformConfig(**dataclasses.asdict(jcfg.transform))})
    crop, mean = cfg.transform.crop_size, cfg.transform.mean_values
    n = cfg.batch_size
    shapes = {"data": (n, cfg.num_segments, crop, crop, 3), "label": (n,)}
    p, s = JaxProgram(jgraph, train=True).init(
        jax.random.PRNGKey(0), {k: jnp.zeros(v) for k, v in shapes.items()})
    tp, ts = params_from_jax(graph, p, s, device="cpu")
    solver = dict(base_lr=0.1, lr_policy="fixed", momentum=0.9, weight_decay=5e-4, max_iter=4,
                  display=0, snapshot=0)

    def micro(pipe):
        while True:
            yield {k: v[None] for k, v in pipe.next_batch().items()}

    losses = {}
    jpipe = JaxVideoPipeline(jcfg, train=True, seed=0, num_workers=2)
    try:
        trainer = JaxTrainer(JaxRawPreprocessProgram(JaxProgram(jgraph, train=True), crop=crop,
                                                     mean=mean),
                             JaxSolverConfig(**solver), metrics_lag=1, log_fn=lambda _: None)
        seen = []
        trainer.solve(jax_init_train_state(p, s), jax_prefetch_to_device(micro(jpipe), 1),
                      hooks=[lambda it, _ts, m: seen.append(float(m["loss"]))])
        losses["reference"] = seen
    finally:
        jpipe.close()
    pipe = VideoPipeline(cfg, train=True, seed=0, num_workers=2)
    try:
        prog = RawPreprocessProgram(Program(graph, train=True, device="cpu"), crop=crop,
                                    mean=mean)
        trainer = Trainer(prog, SolverConfig(**solver), metrics_lag=1, log_fn=lambda _: None)
        seen = []
        trainer.solve(init_train_state(tp, ts), prefetch_to_device(micro(pipe), 1, device="cpu"),
                      hooks=[lambda it, _ts, m: seen.append(float(m["loss"]))])
        losses["port"] = seen
    finally:
        pipe.close()
    assert len(losses["port"]) == 4
    np.testing.assert_allclose(losses["port"], losses["reference"], rtol=1e-4)
    assert losses["port"][-1] != losses["port"][0]
