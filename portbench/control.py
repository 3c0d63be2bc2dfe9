"""Readings that set the check's limits from above: the control.

    python3 -m portbench.control --workload <cell> --seeds <n> <n> <n> [--seconds 2] [--sound]

The control is the program's own int8 path (``convert.quantize_for_serving``,
K3), one precision below the bf16 that the configuration states: the cell's
server with that path switched on, calibrated on two requests of the cell's
traffic drawn from another seed, serves a short window at the cell's load,
and the cell's check runs on what it served; this prints every number of
the check.  ``--sound`` reads the program's own numbers on the same
seeds in the same process, for the lower end of each limit.  Runs on the
card; ``portbench/tests`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, load, serve, spec

# the bf16 server, which the int8 path starts from while a reading has put
# a control in ``serve.build``'s place
BF16 = serve.build


def int8_server(cell, params, state, device, seed: int, calib_requests: int = 2):
    """The cell's server with the program's int8 path switched on:
    calibrated on the K1 float32 clips of requests drawn from the seed."""
    from eco_tpu_torch.apps.serving import UInt8Server
    from eco_tpu_torch.convert.quantize import quantize_for_serving
    from eco_tpu_torch.ops.preprocess import preprocess_on_device

    bf16 = BF16(cell, params, state, device)
    cfg, traffic = cell.config, cell.traffic
    frames = load.frame_pool(calib_requests, (int(traffic["videos"]), cfg["num_segments"],
                                              cfg["frame_height"], cfg["frame_width"], 3),
                             seed + 1, device, traffic["frames"])
    calib = []
    for f in frames:
        n, _, h, w, _ = f.shape
        c = preprocess_on_device(f.to(device), [(h - cfg["crop_size"]) // 2] * n,
                                 [(w - cfg["crop_size"]) // 2] * n, [False] * n,
                                 crop=cfg["crop_size"], mean=tuple(cfg["mean_bgr"]),
                                 out_dtype=torch.float32)
        calib.append({"data": c})
    prog = bf16.program
    qprog, qp, qs, _ = quantize_for_serving(prog, bf16.params, bf16.state, calib, fold=False,
                                            compute_dtype=prog.compute_dtype)
    return UInt8Server(qprog, qp, qs, crop=cfg["crop_size"], mean=tuple(cfg["mean_bgr"]))


def readings(cell, seed: int, seconds: float, device, server=None) -> dict:
    """Every number of the cell's check after a window of ``seconds``, with
    ``server`` (a function of the cell, weights and device) in the bf16
    server's place; the program's own without it."""
    real, numbers = serve.build, {}
    if server is not None:
        serve.build = server
    try:
        harness.run(cell.name, seed, seconds, False, device=device, cell=cell, numbers=numbers)
    finally:
        serve.build = real
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    device = "cuda:0"
    for seed in args.seeds:
        t0 = time.perf_counter()
        sides = {"int8": lambda c, p, s, d, seed=seed: int8_server(c, p, s, d, seed)}
        if args.sound:
            sides["sound"] = None
        rec = {k: readings(cell, seed, args.seconds, device, v) for k, v in sides.items()}
        rec.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
