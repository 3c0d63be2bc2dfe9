"""Train ECO-Lite on a synthetic frame dataset, then test it.

Twin of ``examples/train_synthetic.py``: writes class-coloured JPEG frame
directories in the reference's ``path n_frames label`` list layout, feeds
them through the data pipeline (``data.VideoPipeline``, or the C++ plane
``data.native.NativeVideoPipeline`` under ``--native``), and trains the
ECO-Lite TRAIN graph with the Caffe solver semantics of the reference's
``train_action_recognition_rgb.sh`` launch (Nesterov, lr 0.005, gradients
clipped at 40) through ``train.Trainer``, then runs ``Trainer.test``.

    python -m eco_tpu_torch.examples.train_synthetic [--native] [--iters 15] \
        [--segments 4] [--batch 4] [--crop 224] [--device cuda]

Writing the frames needs ``cv2``.  ``--crop`` (224, the reference's fixed
crop) only shrinks a rehearsal.  The train rate is the host's clock over
the solver's steps, the data feed included.  The last line printed is the
result as JSON: the losses, the final test metrics, the rate.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import time

import numpy as np
import torch

from eco_tpu_torch.data import TransformConfig, VideoDataConfig, VideoPipeline
from eco_tpu_torch.models import build_eco_lite
from eco_tpu_torch.ops import preprocess, qconv
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.train import SolverConfig, Trainer


def make_dataset(root, num_videos=12, frames=24, classes=3):
    import cv2

    rng = np.random.default_rng(0)
    colors = [(30, 30, 200), (30, 200, 30), (200, 30, 30)]
    lines = []
    for v in range(num_videos):
        d = os.path.join(root, f"v{v:03d}")
        os.makedirs(d, exist_ok=True)
        color = colors[v % classes]
        for f in range(frames):
            img = np.full((256, 340, 3), color, np.uint8)
            img += rng.integers(0, 25, img.shape, dtype=np.uint8)
            cv2.imwrite(os.path.join(d, "img_%04d.jpg" % (f + 1)), img)
        lines.append(f"{d} {frames} {v % classes}")
    lst = os.path.join(root, "train.txt")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst


def build_graph(segments: int, batch: int, crop: int = 224):
    """The example's TRAIN graph: ECO-Lite over the 3 colour classes."""
    return build_eco_lite(num_classes=3, num_segments=segments, with_loss=True, batch=batch,
                          crop_size=crop)


def solver_config(iters: int) -> SolverConfig:
    return SolverConfig(
        base_lr=0.005, lr_policy="fixed", momentum=0.9, weight_decay=5e-4,
        clip_gradients=40.0, iter_size=1, solver_type="nesterov",
        max_iter=iters, display=5, snapshot=0, average_loss=5,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--native", action="store_true",
                    help="use the C++ data plane (libecodata)")
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.native:
        from eco_tpu_torch.data.native import NativeVideoPipeline as Pipeline
    else:
        Pipeline = VideoPipeline

    with tempfile.TemporaryDirectory(prefix="eco_example") as root:
        lst = make_dataset(root)
        print(f"dataset: {lst}")
        cfg = VideoDataConfig(
            source=lst, batch_size=args.batch, num_segments=args.segments,
            shuffle=True, transform=TransformConfig(crop_size=args.crop),
        )
        graph = build_graph(args.segments, args.batch, args.crop)
        trainer = Trainer(Program(graph, train=True, device=device), solver_config(args.iters),
                          test_program=Program(graph, train=False, device=device))
        k1_0, k3_0 = preprocess.crop_normalize_launches, qconv.qconv_launches
        pipe = Pipeline(cfg, train=True, seed=0)
        try:
            def batches():
                while True:
                    b = pipe.next_batch()
                    yield {"data": b["data"][None], "label": b["label"][None]}

            it = batches()
            first = next(it)
            ts = trainer.init_state({k: v[0] for k, v in first.items()})
            losses = []
            t0 = time.perf_counter()
            ts = trainer.solve(ts, itertools.chain([first], it),
                               hooks=[lambda i, _ts, m: losses.append(float(m["loss"]))])
            train_s = time.perf_counter() - t0
        finally:
            pipe.close()
        eval_pipe = Pipeline(cfg, train=False, seed=1)
        try:
            metrics = trainer.test(ts, (eval_pipe.next_batch() for _ in range(4)))
        finally:
            eval_pipe.close()
    print(f"final: {metrics}")
    result = {
        "losses": losses,
        "metrics": metrics,
        "train_s": train_s,
        "videos_per_s": args.iters * args.batch / train_s,
        "k1_launches": preprocess.crop_normalize_launches - k1_0,
        "k3_launches": qconv.qconv_launches - k3_0,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
