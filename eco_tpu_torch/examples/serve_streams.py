"""Online serving: N concurrent camera streams, one batched forward a tick.

Twin of ``examples/serve_streams.py``: the reference's online recognition
(a sliding window, the sampling memory and running-mean scores, driven one
window at a time by its ``online_recognition.py``) run batched by
``apps.online.MultiStreamRecognizer``.  Every stream ticks together, and one
fixed-shape forward of the optimized bf16 ECO-Lite Kinetics scores every
ready window.  Frames are synthetic 256x340 BGR camera output; the host
centre-crops them and subtracts the mean (the f32 plane, which needs
``cv2``).

    python -m eco_tpu_torch.examples.serve_streams [--streams 16] \
        [--segments 8] [--ticks 3] [--workers 0] [--crop 224] [--device cuda]

Small defaults, as the reference's; ``--streams 64 --segments 16`` is the
reference benchmark's online shape.  ``--crop`` (224, the reference's fixed
crop) only shrinks a rehearsal.  windows/s is the host's clock over the
timed ticks, host preprocessing included, as in the reference.  The last
line printed is the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from eco_tpu_torch.apps.online import MultiStreamRecognizer
from eco_tpu_torch.convert import optimize_for_inference
from eco_tpu_torch.models import get_model
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.utils.tracing import COUNTS


def inference_program(graph, params, state, device, compute_dtype=torch.bfloat16):
    """BN folded and sibling 1x1s merged: the inference form, as a Program."""
    graph, params, state = optimize_for_inference(graph, params, state)
    return Program(graph, compute_dtype=compute_dtype, device=device), params, state


def cameras(streams: int) -> list:
    """One synthetic 256x340 BGR frame a stream, seed 0, as the reference's."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (256, 340, 3), np.uint8) for _ in range(streams)]


def run_streams(prog, params, state, cams, *, segments: int, ticks: int, workers: int = 0,
                crop: int = 224) -> tuple[list, float]:
    """A warm-up tick, then ``ticks`` timed ones; each feeds every stream one
    full window.  Returns the last tick's ``(label, smoothed)`` a stream and
    the timed ticks' seconds a tick (the host's clock)."""
    with MultiStreamRecognizer(prog, params, state, num_streams=len(cams),
                               num_segments=segments, crop_size=crop,
                               num_workers=workers) as rec:
        def tick():
            for _ in range(segments):
                res = rec.push_frames(cams)
            return res

        res = tick()
        t0 = time.perf_counter()
        for _ in range(ticks):
            res = tick()
        return res, (time.perf_counter() - t0) / ticks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=3,
                    help="window predictions per stream after warmup")
    ap.add_argument("--workers", type=int, default=0,
                    help="host preprocessing threads (0 = inline)")
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.streams < 1 or args.segments < 1 or args.ticks < 1:
        ap.error("--streams/--segments/--ticks must all be >= 1")
    device = torch.device(args.device)

    graph = get_model("eco_lite_kinetics", num_segments=args.segments, batch=args.streams,
                      crop_size=args.crop)
    params, state = Program(graph, device=device).init(torch.Generator().manual_seed(0),
                                                       {"data": graph.inputs["data"]})
    prog, params, state = inference_program(graph, params, state, device)

    k1_0, k3_0 = COUNTS["k1.launches"], COUNTS["k3.launches"]
    res, dt = run_streams(prog, params, state, cameras(args.streams), segments=args.segments,
                          ticks=args.ticks, workers=args.workers, crop=args.crop)
    for i, (label, smoothed) in enumerate(res[:4]):
        print(f"stream {i}: class {label} (smoothed score {smoothed[label]:.5f})")
    print(f"{args.streams} streams -> {args.streams / dt:.1f} window predictions/s "
          f"(full loop incl. host preprocessing)")
    result = {
        "labels": [label for label, _ in res],
        "top_scores": [float(smoothed[label]) for label, smoothed in res],
        "num_classes": len(res[0][1]),
        "windows_per_s": args.streams / dt,
        "tick_s": dt,
        "k1_launches": COUNTS["k1.launches"] - k1_0,
        "k3_launches": COUNTS["k3.launches"] - k3_0,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
