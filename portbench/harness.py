"""One run of one cell: set-up, the measured window, the check, the result.

``run`` returns the result object that ``run.py`` prints as its last line,
and the lines for standard error, which end with each number the check
compared beside its limit.  With ``trace`` the window's last stretch
(``TRACE_SECONDS``, at most half the window) runs under ``torch.profiler``;
host-timed per-layer metrics come from the stretch before it, so the
profiler's cost does not enter them, and the result carries the cell's
per-layer metrics in place of its end-to-end ones.
"""

from __future__ import annotations

import gc
import json
import statistics
import time
from pathlib import Path

import torch

from portbench import check, load, serve, spec, trace, weights

TRACE_SECONDS = 2.0
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


class Readings:
    """What a per-layer reader reads: the profile of the traced stretch, the
    program's spans in it (``profile.spans``, or none without a profile) and
    the change of its counters over it (``COUNTS`` of
    ``eco_tpu_torch/utils/tracing.py``), the host-timed stretch before it,
    the cell's counts and the card's peaks."""

    def __init__(self, cell, profile, host, traced, counts):
        self.profile, self.host, self.traced = profile, host, traced
        self.spans = profile.spans if profile is not None else {}
        self.counts = counts
        self.peaks = PEAKS
        cfg = cell.config
        self.flops_per_video = cell.counts.forward_flops(cell.counts.net(cfg), cfg)
        self.k1_bytes_per_video = cell.counts.k1_bytes(1, cfg, 2)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _device(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _serving(cell, seed, seconds, tracing, device, notes):
    traffic, cfg = cell.traffic, cell.config
    params, state = weights.for_cell(cell, seed, device)
    ref_params, ref_state = weights.clone(params), weights.clone(state)
    server = serve.build(cell, params, state, device)
    del params, state
    frames = load.frame_pool(int(traffic["pool"]),
                             (int(traffic["videos"]), cfg["num_segments"], cfg["frame_height"],
                              cfg["frame_width"], 3), seed, device, traffic["frames"])
    reqs = load.requests(traffic, seed, frame_hw=(cfg["frame_height"], cfg["frame_width"]),
                         crop=cfg["crop_size"])
    serve.warm_up(server, reqs, frames, device)
    ready = time.perf_counter()

    log, profiles, counts = serve.Log(), [], {}
    host_s = seconds - (min(TRACE_SECONDS, seconds / 2) if tracing else 0.0)
    t0 = time.perf_counter()
    i = serve.closed_loop(server, reqs, frames, log, 0, t0 + host_s)
    _sync(device)
    t_host, n_host = time.perf_counter(), len(log.served)
    if tracing:
        from eco_tpu_torch.utils.tracing import COUNTS

        before = COUNTS.copy()
        with trace.profiled(device, profiles):
            serve.closed_loop(server, reqs, frames, log, i, t0 + seconds)
        counts = dict(COUNTS - before)
    t_end = time.perf_counter()
    device_info = _device(device, 1)

    served = log.served
    videos = sum(r.videos for r, *_ in served)
    lat_ms = [(done - start) * 1e3 for _, start, done in served]
    e2e = {"videos_per_s": videos / (t_end - t0)}
    host = {"seconds": t_host - t0, "videos": sum(r.videos for r, *_ in served[:n_host]),
            "requests": n_host}
    traced = {"requests": len(served) - n_host,
              "videos": sum(r.videos for r, *_ in served[n_host:])}
    notes.append(f"window {t_end - t0:.3f} s: {len(served)} requests, {videos} videos; "
                 f"request ms median {statistics.median(lat_ms):.3f}, max {max(lat_ms):.3f}")

    del server
    _free(device)
    picked = serve.sample(log, traffic, seed)
    ref = serve.reference_logits(cell, ref_params, ref_state, picked, frames, device)
    numbers = check.numbers([(log.outputs[r.index].float(), z) for r, z in zip(picked, ref)])
    notes.append(f"check: {len(picked)} requests, {sum(r.videos for r in picked)} videos; "
                 + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items())
                 + f"; reference logits std {float(torch.cat(ref).std()):.4g}")
    failed = sum(1 for r, *_ in served if log.outputs[r.index].shape[0] != r.videos)
    return dict(ready=ready, e2e=e2e, host=host, traced=traced, profiles=profiles,
                counts=counts, device=device_info, numbers=numbers, attempted=len(served),
                failed=failed)


def run(cell_name: str, seed: int, seconds: float, tracing: bool, *, device="cuda",
        t_start: float | None = None, cell=None,
        numbers: dict | None = None) -> tuple[dict, list[str]]:
    """One run of the cell; returns the result and the lines for stderr.
    ``numbers``, where given, gets every number of the check, also those
    the cell holds to no limit."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or spec.cell(cell_name)
    device = torch.device(device)
    notes: list[str] = []
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the allocator keeps no stats before its first use
        torch.cuda.reset_peak_memory_stats(device)
        torch.backends.cudnn.benchmark = True
        from eco_tpu_torch.ops import preprocess
        preprocess.build_kernel()
    if tracing:
        trace.warm(device)
    out = _serving(cell, seed, seconds, tracing, device, notes)
    setup_s = out["ready"] - t_start
    result = {"correct": False, "attempted": out["attempted"], "failed": out["failed"]}
    if tracing:
        prof = out["profiles"][0] if out["profiles"] else None
        readings = Readings(cell, prof, out["host"], out["traced"], out["counts"])
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        device_info = dict(out["device"])
        if prof is not None:
            device_info.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["device"] = device_info
        if prof is not None:
            result["breakdown"] = prof.breakdown()
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = out["device"]
    notes.insert(0, f"set-up {setup_s:.3f} s; device {out['device']}")
    if numbers is not None:
        numbers.update(out["numbers"])
    ok, lines = check.verdict(out["numbers"], cell.limits)
    result["correct"] = bool(ok and out["failed"] == 0)
    result["checks"] = {k: {"value": out["numbers"].get(k), "limit": v}
                        for k, v in cell.limits.items()}
    return result, notes + lines
