"""What a traced stretch of the window did on the device, from ``torch.profiler``.

The profiler records host operations (with the benchmark's own spans,
``record_function``, ``SPANS``, and the program's, ``eco.*``) and the
device's kernels, copies and fills.  This module reduces one profile to a
``Profile``: the device's busy time (the union of its activity intervals,
also without some of them), time by kernel name, host-to-device copy time,
the idle gaps, each labelled by the innermost host operation running at its
middle, and the device work each of the program's spans launched.  The
reduction is the benchmark's own, so that no change to the program can move
a reading; ``portbench/tests/test_portbench_spans.py`` holds it to the program's
``runtime/profiler.py:span_table``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from dataclasses import dataclass, field

import torch

@dataclass
class Profile:
    window_s: float
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)   # name -> (seconds, count)
    htod_s: float = 0.0
    idle_by_host_op: dict = field(default_factory=dict)  # label -> seconds
    device_ops: list = field(default_factory=list)  # (start us, end us, name)
    # program span -> calls, device_ms and launches of the device work
    # launched inside it, self_device_ms of that outside its inner spans
    spans: dict = field(default_factory=dict)

    def kernel_time(self, part: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name holds ``part``."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def busy_without(self, parts) -> float:
        """Seconds in which the device ran something whose name holds none
        of ``parts``."""
        keep = ((s, e) for s, e, name in self.device_ops if not any(p in name for p in parts))
        return sum(e - s for s, e in _union(keep)) * 1e-6

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


# the benchmark's spans around calls into the program's layers; the profiler
# also draws each on the device's timeline, where it is no device work
SPANS = ("serve.call", "serve.copy_out")
# the prefix of the program's spans (``eco_tpu_torch/utils/tracing.py``)
PROGRAM_SPANS = "eco."


def _device_events(events):
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type != cuda:
            host.append((start, end, e.name))
        elif not (getattr(e, "is_user_annotation", False) or e.name in SPANS):
            dev.append((start, end, e.name))
    return dev, host


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(host_sorted, starts, t, scan=4000):
    """The innermost host operation running at ``t``: of those that cover
    it, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        s, e, name = host_sorted[j]
        if e >= t:
            return name
    return "host (no operation)"


def _innermost_span(e):
    while e is not None and not e.name.startswith(PROGRAM_SPANS):
        e = e.cpu_parent
    return e


def span_table(events) -> dict:
    """The program's spans by name: ``calls``; ``device_ms`` and
    ``launches`` of the kernels, copies and fills launched inside the span,
    by the profiler's link of each device op to the host op that launched
    it; ``self_device_ms`` of those with no inner span between.  Spans nest,
    as those of one thread do, so an inner span's work counts in each
    outer span's total and in none's own."""
    cuda = torch.autograd.DeviceType.CUDA
    table = collections.defaultdict(lambda: dict.fromkeys(
        ("calls", "device_ms", "self_device_ms", "launches"), 0))
    for e in events:
        if e.device_type == cuda:
            continue
        if e.name.startswith(PROGRAM_SPANS):
            table[e.name]["calls"] += 1
        kernels = getattr(e, "kernels", ())
        owner = _innermost_span(e) if kernels else None
        if owner is None:
            continue
        ms = sum(k.duration for k in kernels) * 1e-3
        table[owner.name]["self_device_ms"] += ms
        while owner is not None:
            table[owner.name]["device_ms"] += ms
            table[owner.name]["launches"] += len(kernels)
            owner = _innermost_span(owner.cpu_parent)
    return {k: dict(v) for k, v in table.items()}


def reduce(events, window_s: float) -> Profile:
    """A ``Profile`` of the profiler's events (times in microseconds); its
    window is the events' span, or ``window_s`` (the host's) without device
    events."""
    dev, host = _device_events(events)
    prof = Profile(window_s=window_s, spans=span_table(events))
    if not dev:
        return prof
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        d = (e - s) * 1e-6
        if name.startswith("Memcpy HtoD"):
            prof.htod_s += d
        kernels[name][0] += d
        kernels[name][1] += 1
    prof.kernels = {k: (v[0], v[1]) for k, v in kernels.items()}
    prof.device_ops = dev
    busy = _union((s, e) for s, e, _ in dev)
    prof.busy_s = sum(e - s for s, e in busy) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.defaultdict(float)
    t_first = min([h[0] for h in host] + [busy[0][0]])
    t_last = max([h[1] for h in host] + [busy[-1][1]])
    edges = [t_first] + [x for se in busy for x in se] + [t_last]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle[_label(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    prof.idle_by_host_op = dict(idle)
    # busy and window on the profiler's one timeline: the host's clock and
    # the device's, mapped onto it, drift apart by milliseconds over seconds
    prof.window_s = (t_last - t_first) * 1e-6
    return prof


def warm(device) -> None:
    """Start and stop the profiler once: its first start takes seconds."""
    with profiled(device, []):
        torch.ones(1, device=device).add_(1)


@contextlib.contextmanager
def profiled(device, out: list):
    """Profile the block; appends a ``Profile`` to ``out`` when it ends.
    The block's length is the host's, from the start to the device's end
    of its work."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as p:
        t0 = time.perf_counter()
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    out.append(reduce(p.events(), window))
