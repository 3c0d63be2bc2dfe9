"""Real multi-PROCESS distributed training (simulated multi-host).

Twin of ``eco_tpu/parallel/multiprocess.py``.  The reference's launch mode
is N OS processes under mpirun, each owning one GPU, exchanging gradients
over MPI (examples/action_recognition/train_action_recognition_rgb.sh:1-8,
solver.cpp:293-304 rank-0 snapshot + barrier).  Here N processes each join
one ``torch.distributed`` process group (NCCL with one card a process,
the default; gloo with ``--device cpu``) and train data-parallel with
SyncBN (``parallel/shard.py``).

- :func:`worker_main` is the per-process body: ``distributed_init`` ->
  ``data`` mesh -> per-process :class:`VideoPipeline` with MPI-style cursor
  sharding (rank*batch start, (world-1)*batch skip) -> ``Trainer.solve`` on
  the data-parallel step, process 0 alone snapshotting -> a params digest
  written for cross-process comparison.
- :func:`launch_simulated_multihost` launches the job: builds a synthetic
  frame dataset, spawns N workers (real OS processes on the CPU), waits,
  and checks that every process ended with bitwise-identical parameters and
  that only process 0 wrote snapshots.  On the CPU (``--device cpu``) it
  simulates a multi-host job on one host, as the reference's does.

Divergence from the reference: one process is one rank and owns one
device, so ``devices_per_process`` takes only 1 (the reference gives each
process a virtual ``devices_per_process``-device CPU platform).

Run directly:  ``python -m eco_tpu_torch.parallel.multiprocess -n 2``
(two cards), or ``... -n 2 --device cpu``
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_synthetic_dataset(root: str, *, num_videos: int = 8,
                           frames_per_video: int = 12, num_classes: int = 4,
                           size=(48, 64)) -> str:
    """Frame-dir dataset + list file (path n_frames label per line,
    README.md:58-62 format).  Frames encode (video, frame) in their pixels
    so sampling bugs surface as accuracy noise, not silence."""
    import cv2

    lines = []
    rng = np.random.default_rng(0)
    for v in range(num_videos):
        vdir = os.path.join(root, f"vid{v}")
        os.makedirs(vdir, exist_ok=True)
        base = rng.integers(0, 128, (size[0], size[1], 3), np.uint8)
        for f in range(frames_per_video):
            img = np.clip(base.astype(np.int32) + f * 3, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(vdir, "img_%04d.jpg" % (f + 1)), img)
        lines.append(f"{vdir} {frames_per_video} {v % num_classes}")
    list_path = os.path.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_path


def params_digest(params) -> str:
    """sha256 of every param's bytes, in sorted layer and name order."""
    h = hashlib.sha256()
    for lname in sorted(params):
        for pname in sorted(params[lname]):
            h.update(np.ascontiguousarray(params[lname][pname].detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def worker_main(
    process_id: int,
    num_processes: int,
    coordinator: str,
    workdir: str,
    *,
    iters: int = 3,
    iter_size: int = 2,
    per_process_batch: int = 4,
    num_segments: int = 4,
    crop: int = 32,
    num_classes: int = 4,
    device: str = "cuda",
) -> None:
    import torch

    from eco_tpu_torch.data.pipeline import VideoDataConfig, VideoPipeline
    from eco_tpu_torch.data.transform import TransformConfig
    from eco_tpu_torch.models import build_eco_lite
    from eco_tpu_torch.parallel.mesh import DATA_AXIS, distributed_init, make_mesh
    from eco_tpu_torch.runtime import Program
    from eco_tpu_torch.train import SolverConfig
    from eco_tpu_torch.train.loop import Trainer

    if torch.device(device).type == "cuda":
        device = f"cuda:{process_id}"  # one card a process, NCCL
    else:  # gloo, the host's cores shared out
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_processes))
    distributed_init(device=device, init_method=f"tcp://{coordinator}",
                     world_size=num_processes, rank=process_id)
    assert torch.distributed.get_rank() == process_id
    mesh = make_mesh({DATA_AXIS: num_processes})
    global_batch = per_process_batch * num_processes

    graph = build_eco_lite(num_classes=num_classes, num_segments=num_segments,
                           crop_size=crop, with_loss=True, batch=global_batch)
    prog = Program(graph, train=True, device=device)
    cfg = SolverConfig(
        base_lr=1e-3, lr_policy="fixed", momentum=0.9, iter_size=iter_size,
        clip_gradients=40.0, solver_type="nesterov", max_iter=iters,
        snapshot=iters, display=1,
        snapshot_prefix=os.path.join(workdir, "snap", "mh"),
        random_seed=7,
    )
    # per-process data plane with the reference's cursor sharding
    pipe = VideoPipeline(
        VideoDataConfig(
            source=os.path.join(workdir, "data", "train.txt"),
            batch_size=per_process_batch,
            num_segments=num_segments,
            shuffle=False,
            new_height=40, new_width=52,
            transform=TransformConfig(crop_size=crop, mirror=True,
                                      mean_values=(104.0, 117.0, 123.0)),
        ),
        train=True, rank=process_id, world=num_processes, num_workers=2,
    )

    def local_batches():
        """iter_size micro-batches of this process's shard."""
        while True:
            micro = [pipe.next_batch() for _ in range(iter_size)]
            yield {
                "data": torch.from_numpy(np.stack([
                    m["data"].reshape(per_process_batch, num_segments, crop, crop, 3)
                    for m in micro])),
                "label": torch.from_numpy(np.stack([m["label"] for m in micro])),
            }

    trainer = Trainer(prog, cfg, mesh=mesh,
                      log_fn=lambda m: print(f"[rank {process_id}] {m}", flush=True))
    sample = {"data": (per_process_batch, num_segments, crop, crop, 3),
              "label": (per_process_batch,)}
    ts = trainer.init_state(sample, seed=0)
    try:
        ts = trainer.solve(ts, local_batches())
    finally:
        pipe.close()
    digest = params_digest(ts.params)
    with open(os.path.join(workdir, f"digest_rank{process_id}.json"), "w") as f:
        json.dump({"digest": digest, "iters": int(ts.it), "world": num_processes,
                   "local_devices": 1}, f)
    print(f"[rank {process_id}] done digest={digest[:12]}", flush=True)
    torch.distributed.destroy_process_group()


def launch_simulated_multihost(
    num_processes: int = 2,
    *,
    devices_per_process: int = 1,
    workdir: Optional[str] = None,
    timeout: float = 900.0,
    iters: int = 3,
    device: str = "cuda",
) -> dict:
    """Spawn the N-process job and verify the run end-to-end: one card a
    process on ``cuda`` (as many cards as processes), or N processes on the
    host's cores with ``device="cpu"``.

    Returns {"digest": ..., "ok": True, ...}; raises on any divergence,
    worker failure, or mis-placed snapshot.
    """
    if devices_per_process != 1:
        raise ValueError("one process is one rank on one device: devices_per_process "
                         f"must be 1, got {devices_per_process}")
    if device.startswith("cuda"):
        import torch

        if num_processes > torch.cuda.device_count():
            raise ValueError(f"{num_processes} processes need {num_processes} cards, "
                             f"{torch.cuda.device_count()} visible")
    workdir = workdir or tempfile.mkdtemp(prefix="eco_multihost_")
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)
    make_synthetic_dataset(os.path.join(workdir, "data"))
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs, logs = [], []
    for i in range(num_processes):
        log = open(os.path.join(workdir, f"worker{i}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "eco_tpu_torch.parallel.multiprocess",
             "--worker", "--process-id", str(i),
             "--num-processes", str(num_processes),
             "--coordinator", f"localhost:{port}",
             "--workdir", workdir, "--iters", str(iters), "--device", device],
            env=env, cwd=repo_root, stdout=log, stderr=subprocess.STDOUT,
        ))
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        tails = {}
        for i in range(num_processes):
            with open(os.path.join(workdir, f"worker{i}.log")) as f:
                tails[i] = f.read()[-2000:]
        raise RuntimeError(f"worker exit codes {rcs}; log tails: {tails}")

    infos = []
    for i in range(num_processes):
        with open(os.path.join(workdir, f"digest_rank{i}.json")) as f:
            infos.append(json.load(f))
    digests = [d["digest"] for d in infos]
    if len(set(digests)) != 1:
        raise RuntimeError(f"params diverged across processes: {digests}")
    snaps = glob.glob(os.path.join(workdir, "snap", "*"))
    if not any(f"_iter_{iters}.model.npz" in s for s in snaps):
        raise RuntimeError(f"process-0 snapshot missing: {snaps}")
    return {
        "ok": True,
        "num_processes": num_processes,
        "devices_per_process": devices_per_process,
        "device": device,
        "digest": digests[0],
        "iters": iters,
        "snapshots": sorted(os.path.basename(s) for s in snaps),
        "workdir": workdir,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda: one card a process over NCCL; cpu: gloo on the host")
    args = ap.parse_args(argv)
    if args.worker:
        worker_main(args.process_id, args.num_processes, args.coordinator,
                    args.workdir, iters=args.iters, device=args.device)
    else:
        info = launch_simulated_multihost(
            args.num_processes, devices_per_process=args.devices_per_process,
            iters=args.iters, device=args.device)
        print(json.dumps(info))


if __name__ == "__main__":
    main()
