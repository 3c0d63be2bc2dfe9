"""The program's spans and counters (``eco_tpu_torch/utils/tracing.py``)
against the benchmark's reading of a profile: the spans change none of the
numbers ``trace.reduce`` gives, the benchmark's table of them agrees with
sums by hand and with the program's own ``span_table``, the readers of the
table read it, and the program's counters agree with the benchmark's log of
a traced stretch.
"""

import time
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import harness, load, serve, spec, trace, weights
from portbench.tests.test_portbench_reference import small_cell

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, dev, annotation=False):
    return NS(name=name, time_range=NS(start=start, end=end), device_type=dev,
              is_user_annotation=annotation)


def _stretch(with_spans: bool):
    """Two requests: the benchmark's spans, ATen ops and device work, and
    with ``with_spans`` the program's spans on the host, and copies of them
    on the device's timeline flagged as annotations, as the profiler draws
    ``record_function`` ranges."""
    events = []
    for t in (0, 200):
        events += [_ev("serve.call", t, t + 150, CPU), _ev("serve.call", t + 5, t + 160, CUDA),
                   _ev("aten::copy_", t + 2, t + 6, CPU),
                   _ev("Memcpy HtoD (Pinned -> Device)", t + 10, t + 40, CUDA),
                   _ev("crop_normalize", t + 40, t + 50, CUDA),
                   _ev("aten::add", t + 60, t + 62, CPU), _ev("add", t + 70, t + 90, CUDA),
                   _ev("serve.copy_out", t + 150, t + 180, CPU),
                   _ev("Memcpy DtoH", t + 165, t + 170, CUDA)]
        if with_spans:
            events += [_ev("eco.serve", t + 1, t + 140, CPU),
                       _ev("eco.serve.h2d", t + 1, t + 7, CPU),
                       _ev("eco.k1", t + 8, t + 12, CPU), _ev("eco.apply", t + 13, t + 139, CPU),
                       _ev("eco.layer.convolution", t + 14, t + 138, CPU),
                       _ev("eco.bias", t + 59, t + 63, CPU)]
            events += [_ev(e.name, e.time_range.start + 3, e.time_range.end + 20, CUDA, True)
                       for e in events[-6:]]
    return events


def test_program_spans_leave_the_reduction_alone():
    plain, spanned = trace.reduce(_stretch(False), 1.0), trace.reduce(_stretch(True), 1.0)
    assert spanned.busy_s == pytest.approx(plain.busy_s)
    assert spanned.kernels == plain.kernels
    assert spanned.htod_s == pytest.approx(plain.htod_s)
    assert spanned.window_s == pytest.approx(plain.window_s)
    assert not [name for *_, name in spanned.device_ops if name.startswith("eco.")]
    assert sum(spanned.idle_by_host_op.values()) == pytest.approx(
        sum(plain.idle_by_host_op.values()))
    assert plain.spans == {} and spanned.spans["eco.serve"]["calls"] == 2


def _host(name, start, end, parent, kernels=()):
    return NS(name=name, time_range=NS(start=start, end=end), device_type=CPU,
              is_user_annotation=False, cpu_parent=parent,
              kernels=[NS(duration=us) for us in kernels])


def _linked_request():
    """One request's host ops, each with its parent and the durations (us)
    of the device ops the profiler linked to it, and those device ops."""
    call = _host("serve.call", 0, 101, None)
    serve_ = _host("eco.serve", 0, 100, call)
    h2d = _host("eco.serve.h2d", 1, 8, serve_)
    apply = _host("eco.apply", 10, 95, serve_)
    conv_layer = _host("eco.layer.convolution", 11, 60, apply)
    bias = _host("eco.bias", 41, 50, conv_layer)
    relu_layer = _host("eco.layer.relu", 61, 70, apply)
    host = [call, serve_, h2d, _host("aten::copy_", 2, 6, h2d, [20]), apply, conv_layer,
            _host("aten::cudnn_convolution", 12, 40, conv_layer, [30, 4]), bias,
            _host("aten::add", 42, 49, bias, [5]), relu_layer,
            _host("aten::relu", 62, 69, relu_layer, [3]), _host("aten::to", 96, 99, call, [2])]
    device = [_ev("Memcpy HtoD (Pinned -> Device)", 5, 25, CUDA), _ev("conv", 25, 55, CUDA),
              _ev("conv_epilogue", 55, 59, CUDA), _ev("add", 59, 64, CUDA),
              _ev("relu", 70, 73, CUDA), _ev("Memcpy DtoH", 100, 102, CUDA)]
    return host, device


def test_span_table_by_hand():
    """Device ms and launches by span: an inner span's work counts in its
    parents' totals and in none's own; work launched outside every span
    counts nowhere."""
    host, device = _linked_request()
    spans = trace.reduce(host + device, 1.0).spans
    want = {"eco.serve": (1, 62, 0, 5), "eco.serve.h2d": (1, 20, 20, 1),
            "eco.apply": (1, 42, 0, 4), "eco.layer.convolution": (1, 39, 34, 3),
            "eco.bias": (1, 5, 5, 1), "eco.layer.relu": (1, 3, 3, 1)}
    assert set(spans) == set(want)
    for name, (calls, device_us, self_us, launches) in want.items():
        row = spans[name]
        assert (row["calls"], row["launches"]) == (calls, launches), name
        assert row["device_ms"] == pytest.approx(device_us * 1e-3), name
        assert row["self_device_ms"] == pytest.approx(self_us * 1e-3), name


def test_span_table_matches_the_programs():
    """The benchmark's reduction gives what the program's own
    ``runtime/profiler.py:span_table`` gives on the same events."""
    from eco_tpu_torch.runtime.profiler import span_table

    host, device = _linked_request()
    mine, theirs = trace.reduce(host + device, 1.0).spans, span_table(host + device)["spans"]
    assert set(mine) == set(theirs)
    for name, row in mine.items():
        for key, value in row.items():
            assert value == pytest.approx(theirs[name][key]), (name, key)


def test_span_table_leaves_the_profile_alone():
    host, device = _linked_request()
    spanned = trace.reduce(host + device, 1.0)
    plain = trace.reduce([e for e in host if not e.name.startswith("eco.")] + device, 1.0)
    assert (spanned.busy_s, spanned.kernels, spanned.htod_s, spanned.window_s,
            spanned.device_ops) == (plain.busy_s, plain.kernels, plain.htod_s,
                                     plain.window_s, plain.device_ops)
    assert sum(spanned.idle_by_host_op.values()) == pytest.approx(
        sum(plain.idle_by_host_op.values()))


def test_span_readers_by_hand():
    readers = spec.cell("lite_batch32").readers
    launches, epilogue = readers["launches.batch"].read, readers["epilogue_ms.batch"].read
    row = dict.fromkeys(("calls", "device_ms", "self_device_ms", "launches"), 0)
    spans = {"eco.serve": dict(row, calls=4, device_ms=80.0, launches=956),
             "eco.bias": dict(row, calls=116, device_ms=16.2, self_device_ms=16.2, launches=116),
             "eco.layer.relu": dict(row, calls=4, device_ms=7.9, launches=4)}
    r = NS(spans=spans, traced={"requests": 4, "videos": 128})
    assert launches(r) == pytest.approx(239.0)
    assert epilogue(r) == pytest.approx((16.2 + 7.9) / 4)
    # a model with no ReLU layer: the bias adds alone
    r.spans = {k: v for k, v in spans.items() if k != "eco.layer.relu"}
    assert epilogue(r) == pytest.approx(16.2 / 4)
    # nothing to read: no span, spans with no device work (a CPU run), no request
    for spans_, requests in (({}, 4), ({k: dict(row) for k in spans}, 4), (spans, 0)):
        r = NS(spans=spans_, traced={"requests": requests, "videos": 32 * requests})
        assert launches(r) is None and epilogue(r) is None


def test_request_counter_matches_the_traced_log():
    from eco_tpu_torch.utils.tracing import COUNTS

    cell = small_cell("lite_batch32", videos=2)
    cfg, traffic = cell.config, cell.traffic
    params, state = weights.for_cell(cell, 5, "cpu")
    server = serve.build(cell, params, state, "cpu")
    frames = load.frame_pool(2, (2, cfg["num_segments"], cfg["frame_height"],
                                 cfg["frame_width"], 3), 5, "cpu", traffic["frames"])
    reqs = load.requests(traffic, 5, frame_hw=(cfg["frame_height"], cfg["frame_width"]),
                         crop=cfg["crop_size"])
    log, profiles = serve.Log(), []
    serve.warm_up(server, reqs, frames, "cpu")
    before = COUNTS.copy()
    with trace.profiled("cpu", profiles):
        serve.closed_loop(server, reqs, frames, log, 0, time.perf_counter() + 0.3)
    assert COUNTS["serve.requests"] - before["serve.requests"] == len(log.served) > 0
    assert COUNTS["serve.videos"] - before["serve.videos"] == sum(
        r.videos for r, *_ in log.served)


def test_readings_carry_the_traced_counts_and_spans(monkeypatch):
    """A whole traced run on the CPU: ``Readings`` holds the change of the
    program's counters over the traced stretch and its span calls, and both
    agree with the benchmark's log of that stretch."""
    loop = serve.closed_loop

    def at_least_one(server, reqs, frames, log, start, until):
        # a slow CPU request can outlast the host-timed stretch and the
        # traced one: serve one in each all the same
        i = loop(server, reqs, frames, log, start, until)
        if i == start:
            log.serve(server, reqs[i], frames)
            i += 1
        return i

    monkeypatch.setattr(serve, "closed_loop", at_least_one)
    cell = small_cell("lite_batch32", videos=2)
    seen = []
    cell.readers = {**cell.readers, "launches.batch": NS(read=seen.append)}
    result, lines = harness.run("lite_batch32", 2**32 + 9, 0.6, True, device="cpu", cell=cell)
    assert result["correct"], lines
    (r,) = seen
    assert r.counts["serve.requests"] == r.traced["requests"] > 0
    assert r.counts["serve.videos"] == r.traced["videos"] == 2 * r.traced["requests"]
    assert r.spans["eco.serve"]["calls"] == r.traced["requests"]
    assert "launches.batch" not in result["metrics"]
