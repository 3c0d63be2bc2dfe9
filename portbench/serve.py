"""Serving cells: ``UInt8Server`` over the inference-optimised graph.

The window drives ``UInt8Server.__call__`` (K1's crop, mirror, mean and
cast, then the folded and merged graph up to the probabilities) and copies
each request's probabilities to the host.  A closed loop sends the next
request when the last one's probabilities are on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import load

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cell, params, state, device):
    """The server of the cell's configuration on the given weights: the zoo's
    builder of ``model`` gets the request's ``batch`` and, for each entry of
    ``model_args``, the value of the configuration key it names."""
    from eco_tpu_torch.apps.serving import UInt8Server
    from eco_tpu_torch.convert import optimize_for_inference
    from eco_tpu_torch.models.zoo import get_model
    from eco_tpu_torch.runtime.executor import Program

    cfg = cell.config
    graph = get_model(cfg["model"], batch=int(cell.traffic["videos"]),
                      **{arg: cfg[key] for arg, key in cfg["model_args"].items()})
    g, p, s = optimize_for_inference(graph, params, state)
    return UInt8Server(Program(g, compute_dtype=DTYPES[cfg["precision"]], device=device), p, s,
                       crop=cfg["crop_size"], mean=tuple(cfg["mean_bgr"]))


class Log:
    """What the window did, request by request."""

    def __init__(self):
        self.served = []   # (request, start, done) host times
        self.outputs = {}  # request index -> probabilities on the host

    def serve(self, server, req, frames):
        start = time.perf_counter()
        with record_function("serve.call"):
            probs = server(frames[req.pool][:req.videos], h_off=req.h_off, w_off=req.w_off,
                           mirror=req.mirror)
        with record_function("serve.copy_out"):
            out = probs.cpu()
        self.outputs[req.index] = out
        self.served.append((req, start, time.perf_counter()))


def warm_up(server, reqs, frames, device):
    """The mix's request, twice (cuDNN picks its algorithms at a shape's
    first call)."""
    log = Log()
    for r in reqs[:2]:
        log.serve(server, r, frames)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(server, reqs, frames, log: Log, start_index: int, until: float) -> int:
    """Serve requests back to back from ``start_index`` until the host clock
    passes ``until``; returns the next index."""
    i = start_index
    while time.perf_counter() < until:
        log.serve(server, reqs[i], frames)
        i += 1
    return i


def sample(log: Log, traffic: dict, seed: int) -> list:
    """Requests for the check, drawn from the seed."""
    served = [r for r, *_ in log.served]
    rng = np.random.default_rng(load.derive(seed, 4))
    k = min(int(traffic["sample_requests"]), len(served))
    return [served[i] for i in rng.choice(len(served), size=k, replace=False)]


def reference_logits(cell, params, state, reqs, frames, device):
    """The reference's logits of every video of ``reqs``, float32, TF32 off,
    a block of at most 8 videos at a time."""
    cfg, ref = cell.config, cell.reference
    net = ref.net(cfg)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        with torch.no_grad():
            for r in reqs:
                rows = []
                for lo in range(0, r.videos, 8):
                    hi = min(lo + 8, r.videos)
                    f = frames[r.pool][lo:hi].to(device)
                    clips = ref.clips(cfg, f, r.h_off[lo:hi], r.w_off[lo:hi], r.mirror[lo:hi])
                    rows.append(ref.forward(net, params, state, clips).double().cpu())
                out.append(torch.cat(rows))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return out
