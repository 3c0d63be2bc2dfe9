"""Profiling: ``caffe time`` and ``debug_info`` on the card.

Twin of ``eco_tpu/runtime/profiler.py``:

- :func:`time_layers`: per-layer forward (and, with ``backward=True``,
  backward) times, each layer run alone on its real input from the layers
  before it (tools/caffe.cpp time(), :276-360).  On the card each layer is
  timed by CUDA events around ``iters`` calls after ``warmup`` calls; on the
  CPU (tests) by the host's clock.  The sum of isolated layers is an upper
  bound on the whole pass, which overlaps nothing but skips nothing either.
- The floor check: on the card every row is held against its floors, the
  layer's FLOPs at the H100's peak rate for its type and its bytes (inputs,
  params and outputs once each) at 3.35 TB/s.  A time below both floors
  is impossible, so it means the instrument is wrong, and it raises.
- :func:`debug_info`: per-blob L1-mean of activations (Net::ForwardDebugInfo,
  net.cpp:708-783).
- :func:`memory_analysis`: the peak of ``torch.cuda.max_memory_allocated``
  around one call.
- :func:`trace`: ``torch.profiler`` around a block, a Chrome trace and the
  table of :func:`span_table` written to a directory.
- :func:`span_table`: the program's ``eco.*`` spans (``utils/tracing.py``)
  in a profile: host time, the device time and launches each span caused,
  and the device's idle time by the span the host was in.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Mapping

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from eco_tpu_torch.runtime.executor import Context

# The H100's published dense peaks (SXM, 700 W; NVIDIA's data sheet), by the
# type a layer computes in: f32 at the TF32 rate, which cuDNN may use for
# f32 convolutions by default, so that the floor is never too high
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 495e12,
                  torch.int8: 1979e12}
HBM_BYTES_PER_S = 3.35e12


def _context(program, seed):
    if seed is None and program.train:
        seed = 0  # dropout and stochastic layers need a seed in train mode
    return Context(train=program.train, seed=seed, compute_dtype=program.compute_dtype,
                   device=program.device)


def _inputs(program, inputs):
    return {k: program.cast_input(torch.as_tensor(v).to(program.device))
            for k, v in inputs.items()}


def _run_collect(program, params, state, inputs, *, seed=None):
    """Eager forward capturing every blob value."""
    ctx = _context(program, seed)
    blobs = _inputs(program, inputs)
    shared: dict = {}
    with torch.no_grad():
        for layer, impl in zip(program.exec_layers, program._impls):
            ins = [blobs[b] for b in layer.bottoms]
            lp = program._layer_params(layer, impl, params, ins, shared)
            outs = impl.apply(layer, lp, state.get(layer.name, {}), ins, ctx)
            blobs.update(zip(layer.tops, outs))
    return blobs


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def floor_ms(flops: float, moved_bytes: float, dtype: torch.dtype) -> tuple[float, float]:
    """(FLOP floor, byte floor) in ms on the H100 for a layer's work."""
    peak = PEAK_OPS_PER_S.get(dtype, PEAK_OPS_PER_S[torch.float32])
    return flops / peak * 1e3, moved_bytes / HBM_BYTES_PER_S * 1e3


def _check_floor(name: str, what: str, ms: float, flops: float, moved: float, dtype):
    by_flops, by_bytes = floor_ms(flops, moved, dtype)
    if ms < by_flops and ms < by_bytes:
        raise RuntimeError(
            f"{name} {what}: {ms:.4f} ms is below both its FLOP floor ({by_flops:.4f} ms, "
            f"{flops / 1e9:.3f} GFLOP) and its byte floor ({by_bytes:.4f} ms, "
            f"{moved / 1e6:.1f} MB): the timer, not the card, is wrong")


class _Clock:
    """ms per call of ``fn``, the least of ``repeats`` blocks of ``iters``
    calls after ``warmup`` calls: CUDA events around a block on the card
    (``method`` "auto" or "device_loop"), else the host's clock with a
    synchronisation after every call ("host", and always on the CPU)."""

    def __init__(self, device: torch.device, iters: int, warmup: int, method: str = "auto",
                 repeats: int = 1):
        if method not in ("auto", "host", "device_loop"):
            raise ValueError(f"unknown timing method {method!r}")
        self.cuda = device.type == "cuda"
        self.events = self.cuda and method != "host"
        self.iters, self.warmup, self.repeats = iters, warmup, max(repeats, 1)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _block(self, fn) -> float:
        if self.events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / self.iters
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
            self._sync()
        return (time.perf_counter() - t0) / self.iters * 1e3

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        self._sync()
        return min(self._block(fn) for _ in range(self.repeats))


def time_layers(program, params, state, inputs: Mapping, *, iters: int = 10,
                warmup: int = 2, seed=None, backward: bool = False, method: str = "auto",
                repeats: int = 1):
    """Per-layer micro-benchmark on the program's device.

    Returns [(layer_name, type, fwd_ms)] or, with ``backward=True``,
    [(layer_name, type, fwd_ms, bwd_ms)], where bwd is the time of the
    layer's gradient with respect to its float inputs and params (what
    ``caffe time`` reports per layer, tools/caffe.cpp:318-357), its forward
    time taken off; NaN for a layer with nothing to differentiate.
    ``method`` and ``repeats`` pick the clock (see ``_Clock``).  On the card
    each time is held to the layer's floors (see the module note).
    """
    ctx = _context(program, seed)
    clock = _Clock(program.device, iters, warmup, method, repeats)
    rows = []
    # free each blob after its last consumer was timed: holding every
    # intermediate of a full-size pass at once would need far more memory
    remaining: dict = {}
    for layer in program.exec_layers:
        for b in layer.bottoms:
            remaining[b] = remaining.get(b, 0) + 1
    blobs = _inputs(program, inputs)
    shared: dict = {}
    for layer, impl in zip(program.exec_layers, program._impls):
        ins = [blobs[b] for b in layer.bottoms]
        lp = program._layer_params(layer, impl, params, ins, shared)
        ls = state.get(layer.name, {})
        fwd = lambda lp=lp, ins=ins: impl.apply(layer, lp, ls, ins, ctx)
        with torch.no_grad():
            with FlopCounterMode(display=False) as counter:
                outs = fwd()
            fwd_ms = clock(fwd)
        flops = counter.get_total_flops()
        moved = _nbytes(ins) + _nbytes(lp.values()) + _nbytes(outs)
        dtype = next((x.dtype for x in ins if x.is_floating_point()), torch.float32)
        if clock.cuda:
            _check_floor(layer.name, "forward", fwd_ms, flops, moved, dtype)
        row = (layer.name, layer.type, fwd_ms)
        if backward:
            row += (_time_backward(layer, impl, lp, ls, ins, ctx, clock, fwd_ms, dtype),)
        rows.append(row)
        del ins
        for b in layer.bottoms:
            remaining[b] -= 1
            if remaining[b] == 0:
                blobs.pop(b, None)  # free before in-place tops re-assign
        blobs.update(zip(layer.tops, outs))
    return rows


def _time_backward(layer, impl, lp, ls, ins, ctx, clock, fwd_ms, dtype) -> float:
    """The layer's gradient time: forward and gradient timed together, the
    forward's time taken off; NaN where nothing is differentiable."""
    leaves = [x.detach().requires_grad_() if x.is_floating_point() else x for x in ins]
    lpg = {k: v.detach().requires_grad_() if v.is_floating_point() else v
           for k, v in lp.items()}
    wrt = [t for t in leaves + list(lpg.values()) if t.requires_grad]

    def fwd_bwd():
        with torch.enable_grad():
            outs = [o for o in impl.apply(layer, lpg, ls, leaves, ctx) if o.requires_grad]
            if not outs:
                return None
            return torch.autograd.grad(sum(o.float().sum() for o in outs), wrt,
                                       allow_unused=True)

    with FlopCounterMode(display=False) as counter:
        grads = fwd_bwd()
    if grads is None:
        return float("nan")
    both_ms = clock(fwd_bwd)
    if clock.cuda:
        moved = _nbytes(ins) + _nbytes(lp.values()) + _nbytes(g for g in grads if g is not None)
        _check_floor(layer.name, "forward + backward", both_ms, counter.get_total_flops(),
                     moved, dtype)
    return max(both_ms - fwd_ms, 0.0)


def format_layer_times(rows) -> str:
    has_bwd = rows and len(rows[0]) == 4
    hdr = f"{'layer':40s} {'type':18s} {'fwd ms':>9s}"
    if has_bwd:
        hdr += f" {'bwd ms':>9s}"
    lines = [hdr]
    for row in rows:
        line = f"{row[0]:40s} {row[1]:18s} {row[2]:9.3f}"
        if has_bwd:
            line += f" {row[3]:9.3f}"
        lines.append(line)
    total = sum(r[2] for r in rows)
    lines.append(f"{'TOTAL (sum of isolated layers)':59s} {total:9.3f}")
    return "\n".join(lines)


def debug_info(program, params, state, inputs, *, seed=None):
    """[(blob, shape, L1-mean)] for every activation (net.cpp debug_info)."""
    blobs = _run_collect(program, params, state, inputs, seed=seed)
    return [(name, tuple(v.shape), float(np.abs(v.float().cpu().numpy()).mean()))
            for name, v in blobs.items()]


def memory_analysis(fn, *args, device=None, **kwargs) -> dict:
    """Device memory of one ``fn(*args, **kwargs)`` on the card: bytes
    allocated before it, the peak during it above that, and what its results
    hold after it (``torch.cuda.max_memory_allocated``)."""
    device = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    after = torch.cuda.memory_allocated(device)
    del out
    return {"argument_size_in_bytes": before, "temp_size_in_bytes": peak - before,
            "output_size_in_bytes": after - before, "peak_bytes": peak}


def _innermost_span(e):
    while e is not None and not e.name.startswith("eco."):
        e = e.cpu_parent
    return e


def span_table(events) -> dict:
    """The ``eco.*`` spans of a profile's events (``prof.events()``; times in
    microseconds), in milliseconds.

    ``spans`` maps each span name to its ``calls``, ``host_ms`` (summed
    durations on the host), ``device_ms`` and ``launches`` (the kernels,
    copies and fills launched inside it, by the profiler's link of each
    device op to the host op that launched it) and ``self_device_ms`` and
    ``self_launches`` (those with no inner span between).  ``idle_ms`` maps
    the innermost span the host was in at the middle of each gap in the
    device's activity to the gaps' summed length, ``caller`` where it was
    in none; the gaps are those of ``[first event, last event]`` outside the
    union of the device's ops.  ``busy_ms`` is that union, ``window_ms`` that
    interval.  Spans are taken to nest, as those of one thread do.
    """
    cuda = torch.autograd.DeviceType.CUDA
    table = collections.defaultdict(lambda: dict.fromkeys(
        ("calls", "host_ms", "device_ms", "launches", "self_device_ms", "self_launches"), 0))
    spans, device, host = [], [], []
    for e in events:
        if e.device_type == cuda:
            # the profiler also draws a caller's record_function ranges on
            # the device's timeline; they are no work
            if not e.is_user_annotation:
                device.append((e.time_range.start, e.time_range.end))
            continue
        host.append((e.time_range.start, e.time_range.end))
        if e.name.startswith("eco."):
            spans.append((e.time_range.start, e.time_range.end, e.name))
            row = table[e.name]
            row["calls"] += 1
            row["host_ms"] += (e.time_range.end - e.time_range.start) * 1e-3
        kernels = [k.duration for k in e.kernels]
        owner = _innermost_span(e) if kernels else None
        if owner is None:
            continue
        ms = sum(kernels) * 1e-3
        table[owner.name]["self_device_ms"] += ms
        table[owner.name]["self_launches"] += len(kernels)
        while owner is not None:
            table[owner.name]["device_ms"] += ms
            table[owner.name]["launches"] += len(kernels)
            owner = _innermost_span(owner.cpu_parent)
    out = {"spans": {k: dict(v) for k, v in table.items()}, "idle_ms": {},
           "busy_ms": 0.0, "window_ms": 0.0}
    if not device:
        return out
    busy = []
    for s, e in sorted(device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    t_first = min([s for s, _ in host] + [busy[0][0]])
    t_last = max([e for _, e in host] + [busy[-1][1]])
    idle, stack, i = collections.defaultdict(float), [], 0
    spans.sort()
    edges = [t_first] + [x for se in busy for x in se] + [t_last]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        t = (a + b) / 2
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        idle[stack[-1][2] if stack else "caller"] += (b - a) * 1e-3
    out.update(idle_ms=dict(idle), busy_ms=sum(e - s for s, e in busy) * 1e-3,
               window_ms=(t_last - t_first) * 1e-3)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU and CUDA activity); the Chrome
    trace goes to ``logdir/trace.json``, the block's :func:`span_table` to
    ``logdir/spans.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(span_table(prof.events()), f, indent=1)
