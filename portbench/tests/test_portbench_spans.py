"""The program's spans and counters (``eco_tpu_torch/utils/tracing.py``)
against the benchmark's reading of a profile: the spans change none of the
numbers ``trace.reduce`` gives, and the program's request counter agrees
with the benchmark's log of a traced stretch.
"""

import time
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import load, serve, trace, weights
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
