"""Train-step memory per remat policy: the mem_param evidence tool.

Twin of ``eco_tpu/tools/memreport.py``.  The reference Caffe's activation
memory optimizer (net.cpp:1080-1277, ``mem_param { optimize_train: true }``)
becomes rematerialization here (``runtime/memory.py``).  This tool runs the
ECO-Lite training step on the card under each policy and prints its peak
device memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``) and its step time (CUDA events):

    python -m eco_tpu_torch.tools.memreport [--batch 16 --segments 16 --crop 224]

Prints one JSON line per policy.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from eco_tpu_torch.train.solver import make_train_step


def policy_rows(program, cfg, ts, batch, policies, *, steps: int = 3, seed: int = 1):
    """One train step from ``ts`` on ``batch`` under each remat policy, on the
    card: its peak memory, then ``steps`` more steps timed by CUDA events.
    Returns one dict a policy: ``policy``, ``peak_bytes`` (the device's peak
    during the first step), ``peak_above_start_bytes`` (that peak less what
    was allocated before the step), ``step_ms``, ``loss`` (a tensor), and
    ``params``, the params after the first step copied to the host, so that
    no policy's results sit on the card while the next one is measured."""
    dev = program.device
    rows = []
    for policy in policies:
        step = make_train_step(program, cfg, remat=policy)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)
        new_ts, metrics = step(ts, batch, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        timed = new_ts
        start.record()
        for _ in range(steps):
            timed, _ = step(timed, batch, torch.Generator().manual_seed(seed))
        end.record()
        end.synchronize()
        rows.append({"policy": policy or "none", "peak_bytes": peak,
                     "peak_above_start_bytes": peak - start_bytes,
                     "step_ms": start.elapsed_time(end) / steps,
                     "loss": metrics["loss"].cpu(),
                     "params": {ln: {k: v.cpu() for k, v in lp.items()}
                                for ln, lp in new_ts.params.items()}})
        del new_ts, timed, metrics
    return rows


def report(batch=16, segments=16, crop=224, num_classes=400,
           policies=(None, "dots", "nothing"), device="cuda"):
    from eco_tpu_torch.models import build_eco_lite
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train.solver import SolverConfig, init_train_state

    g = build_eco_lite(num_classes=num_classes, num_segments=segments, crop_size=crop,
                       with_loss=True, batch=batch)
    prog = Program(g, train=True, device=device)
    cfg = SolverConfig(iter_size=1, solver_type="nesterov", clip_gradients=40.0)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((1, batch, segments, crop, crop, 3))
                            .astype(np.float32)).to(device, torch.bfloat16)
    label = torch.from_numpy(rng.integers(0, num_classes, (1, batch))).to(device)
    params, state = prog.init(torch.Generator().manual_seed(0),
                              {"data": data[0], "label": label[0]})
    ts = init_train_state(params, state)
    rows = []
    for row in policy_rows(prog, cfg, ts, {"data": data, "label": label}, policies):
        row.pop("params")
        row["loss"] = float(row["loss"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--segments", type=int, default=16)
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("--classes", type=int, default=400)
    args = p.parse_args(argv)
    report(args.batch, args.segments, args.crop, args.classes)


if __name__ == "__main__":
    main()
