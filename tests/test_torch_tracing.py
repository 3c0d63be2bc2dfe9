"""The program's spans and counters (``eco_tpu_torch/utils/tracing.py``) on
the CPU: what a ``UInt8Server`` call records under ``torch.profiler``, that
it computes the same with the profiler on and off, that no span enters a
``torch.export`` artifact, and the table ``runtime/profiler.py`` makes of
the spans.  The server is ECO-Lite, optimized for inference, at crop 64 and
2 segments, as the other ``test_torch_*`` files shrink it.
"""

import json
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import export_serving, optimize_for_inference
from eco_tpu_torch.models import get_model
from eco_tpu_torch.runtime import Program, profiler
from eco_tpu_torch.utils import tracing
from eco_tpu_torch.utils.tracing import COUNTS, span

N, S, CROP, H, W = 2, 2, 64, 72, 90


@pytest.fixture(scope="module")
def lite():
    graph = get_model("eco_lite_kinetics", batch=N, num_segments=S, crop_size=CROP)
    params, state = Program(graph, device="cpu").init(
        torch.Generator().manual_seed(0), {"data": graph.inputs["data"]})
    return optimize_for_inference(graph, params, state)


@pytest.fixture(scope="module")
def server(lite):
    return UInt8Server(Program(lite[0], device="cpu"), lite[1], lite[2], crop=CROP)


def _request(seed=1):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (N, S, H, W, 3), dtype=np.uint8))
    return frames, dict(h_off=[0, H - CROP], w_off=[W - CROP, 3], mirror=[True, False])


def _profiled(server):
    frames, aug = _request()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = server(frames, **aug)
    return out, prof.events()


def test_span_is_the_shared_no_op_without_a_profiler(server):
    assert not torch.autograd._profiler_enabled()
    assert span("eco.serve") is span("eco.apply") is tracing._OFF
    before = COUNTS.copy()
    frames, aug = _request()
    server(frames, **aug)
    server(frames[:1], h_off=aug["h_off"][:1], w_off=aug["w_off"][:1], mirror=aug["mirror"][:1])
    assert COUNTS["serve.requests"] - before["serve.requests"] == 2
    assert COUNTS["serve.videos"] - before["serve.videos"] == N + 1


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def test_a_call_records_the_span_tree(server):
    _, events = _profiled(server)
    eco = [e for e in events if e.name.startswith("eco.")]
    (serve,) = [e for e in eco if e.name == "eco.serve"]
    assert serve.cpu_parent is None
    assert {c.name for c in serve.cpu_children} == {"eco.serve.h2d", "eco.k1", "eco.apply"}
    (apply_,) = [e for e in eco if e.name == "eco.apply"]
    layers = [e for e in eco if e.name.startswith("eco.layer.")]
    assert all(e.cpu_parent is apply_ for e in layers)
    executed = server.program.exec_layers
    assert len(layers) == len(executed)
    assert sorted(e.name for e in layers) == sorted(
        "eco.layer." + layer.type.lower() for layer in executed)
    for leaf in ("eco.cast", "eco.bias"):
        parents = {e.cpu_parent.name for e in eco if e.name == leaf}
        assert parents == {"eco.layer.convolution", "eco.layer.innerproduct"}, leaf
    weighted = sum(layer.type.lower() in ("convolution", "innerproduct") for layer in executed)
    assert sum(e.name == "eco.cast" for e in eco) == weighted
    # every leaf span lies inside the request's span
    assert all(serve in _ancestors(e) for e in eco if e is not serve)
    assert {e.name for e in eco if e.name in ("eco.pad", "eco.layout")} == {"eco.pad",
                                                                            "eco.layout"}


def test_outputs_are_bit_identical_with_the_profiler_on_and_off(server):
    frames, aug = _request()
    off = server(frames, **aug)
    on, _ = _profiled(server)
    assert torch.equal(off, on)


def test_export_holds_no_profiler_node(lite):
    prog = Program(lite[0], device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        exported = export_serving(prog, lite[1], lite[2], batch=N, segments=S, crop=CROP,
                                  uint8=True, frame_hw=(H, W))
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_trace_writes_a_chrome_trace_and_the_span_table(server, tmp_path):
    frames, aug = _request()
    with profiler.trace(str(tmp_path)):
        server(frames, **aug)
    chrome = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in chrome["traceEvents"]}
    assert {"eco.serve", "eco.apply", "eco.k1"} <= names
    table = json.loads((tmp_path / "spans.json").read_text())
    assert table["spans"]["eco.serve"]["calls"] == 1
    assert table["spans"]["eco.layer.convolution"]["calls"] == sum(
        layer.type.lower() == "convolution" for layer in server.program.exec_layers)
    assert table["spans"]["eco.apply"]["host_ms"] <= table["spans"]["eco.serve"]["host_ms"]
    # no device: no device time and no idle to label
    assert table["idle_ms"] == {} and table["busy_ms"] == 0.0


def test_span_table_by_hand():
    """Device time goes to every span above the op that launched it, and as
    self time to the innermost; a caller's range drawn on the device is not
    work; each idle gap goes to the innermost span at its middle, or to the
    caller outside every span."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, start, end, dev=cpu, parent=None, kernels=(), annotation=False):
        return NS(name=name, time_range=NS(start=start, end=end), device_type=dev,
                  cpu_parent=parent, is_user_annotation=annotation,
                  kernels=[NS(name=k, duration=d) for k, d in kernels])

    serve = ev("eco.serve", 0, 100)
    h2d = ev("eco.serve.h2d", 2, 8, parent=serve)
    copy = ev("aten::copy_", 3, 7, parent=h2d, kernels=[("Memcpy HtoD", 20)])
    k1 = ev("eco.k1", 10, 15, parent=serve, kernels=[("crop_normalize", 10)])
    apply_ = ev("eco.apply", 20, 90, parent=serve)
    layer = ev("eco.layer.convolution", 22, 60, parent=apply_)
    conv = ev("aten::conv2d", 24, 30, parent=layer, kernels=[("cudnn", 15)])
    bias = ev("eco.bias", 30, 40, parent=layer)
    add = ev("aten::add", 31, 39, parent=bias, kernels=[("add", 5)])
    out = ev("aten::copy_", 105, 110, kernels=[("Memcpy DtoH", 5)])
    device = [ev("Memcpy HtoD", 10, 30, cuda), ev("crop_normalize", 30, 40, cuda),
              ev("cudnn", 50, 65, cuda), ev("add", 70, 75, cuda),
              ev("Memcpy DtoH", 120, 125, cuda), ev("sum", 130, 140, cuda),
              ev("serve.call", 5, 118, cuda, annotation=True)]
    table = profiler.span_table([serve, h2d, copy, k1, apply_, layer, conv, bias, add, out]
                                + device)
    spans = table["spans"]
    assert spans["eco.serve"]["device_ms"] == pytest.approx(0.050)
    assert spans["eco.serve"]["launches"] == 4 and spans["eco.serve"]["self_launches"] == 0
    assert spans["eco.apply"]["device_ms"] == pytest.approx(0.020)
    assert spans["eco.layer.convolution"]["self_device_ms"] == pytest.approx(0.015)
    assert spans["eco.bias"]["device_ms"] == pytest.approx(0.005)
    assert spans["eco.serve.h2d"]["launches"] == 1 and spans["eco.k1"]["calls"] == 1
    assert spans["eco.serve"]["host_ms"] == pytest.approx(0.1)
    assert table["busy_ms"] == pytest.approx(0.065)
    assert table["window_ms"] == pytest.approx(0.140)
    # the gaps and the span at each one's middle: 0-10 (5: eco.serve.h2d),
    # 40-50 (45: the conv layer), 65-70 (67.5: eco.apply), 75-120 (97.5:
    # eco.serve), 125-130 (127.5: the caller's copy, in no span)
    assert table["idle_ms"] == pytest.approx({
        "eco.serve.h2d": 0.010, "eco.layer.convolution": 0.010, "eco.apply": 0.005,
        "eco.serve": 0.045, "caller": 0.005})
