#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (every failure raises; the exit code is then non-zero):

1. The card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels ``eco_tpu_torch/csrc/{preprocess,poolfuse}.cu``, one nvcc each,
   started together.
2. The kernel against its plain PyTorch version on the card at the serving
   shape (8, 16, 256, 340, 3) uint8, random in-range offsets and mirrors, in
   bf16, f32 and int8: the outputs must be equal (``torch.equal``).  Both are
   timed with CUDA events.
3. Full-width ECO-Lite Kinetics (400 classes, 16 segments, 224 crop) at
   batch 8 with seeded random weights, optimized for inference, served by
   the bf16 ``UInt8Server`` from uint8 frames in pinned host memory: one
   warm-up request and ten timed ones.  Probabilities must be finite,
   (8, 400) and sum to 1; the kernel must have launched once per request.
   The logits are compared with an f32 run of the same server (TF32 off),
   and that run with the f32 server on the CPU for two of the videos.
4. K2, the fused 3x3/s2 max pool, against its plain PyTorch version at
   ECO-Lite's pool1 (128, 112, 112, 64) and pool2 (128, 56, 56, 192) shapes,
   in bf16 and f32, plain, with ReLU and with a seeded affine: equal
   (``torch.equal``).  Then K2, its plain version and the ``pool_nd`` route
   it replaces (pad + ``max_pool2d``) timed in bf16.
5. Training at full width: the ECO-Lite Kinetics TRAIN graph (dropout 0.3)
   through ``RawPreprocessProgram`` (K1 in the step) and the ``Trainer``,
   bf16, Nesterov as ``examples/train_synthetic.py``, on one repeated batch
   of uint8 frames from pinned host memory: a warm-up step and ten timed
   ones.  Losses and gradient norms finite, the loss falling, K1 once per
   step, K2 never (``ECO_PALLAS_POOL`` unset).
6. One f32 train step (TF32 off, dropout 0) of the same two videos on the
   card and on the CPU: the parameter updates agree within a stated bound.
7. The Trainer's test pass over two batches with the trained weights,
   without and with ``ECO_PALLAS_POOL=1``: K2 launches twice a batch (pool1
   and pool2) and the test metrics agree within 1e-6 relative.
8. The bf16 serving requests again, alternately without and with
   ``ECO_PALLAS_POOL=1`` (K2 twice a request): median request times side by
   side.

Prints a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from eco_tpu_torch.apps import RawPreprocessProgram, UInt8Server
from eco_tpu_torch.convert import optimize_for_inference
from eco_tpu_torch.models import build_eco_lite, get_model
from eco_tpu_torch.ops import _build, pool, poolfuse, preprocess
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.train import SolverConfig, Trainer, init_train_state, make_train_step

SEED = 0
BATCH, SEGMENTS, HEIGHT, WIDTH, CROP = 8, 16, 256, 340, 224
MEAN = (104.0, 117.0, 123.0)
ACT_SCALE = 0.37
TIMED_REQUESTS = 10
# bf16 serving against f32 serving of the same weights and frames: bf16 keeps
# 8 bits of mantissa, and ~40 layers of rounding leave ~1e-2 relative error
# in the logits (7.4e-3 at crop 64 on the CPU).
BF16_LOGITS_REL_L2_BOUND = 3e-2
# f32 on the card (TF32 off) against f32 on the CPU: the same math summed in
# other orders, ~1e-6 relative after ~40 layers.
F32_CARD_VS_CPU_REL_L2_BOUND = 1e-4
PROBS_SUM_TOL = 1e-2
POOL_SHAPES = {"pool1": (BATCH * SEGMENTS, 112, 112, 64),
               "pool2": (BATCH * SEGMENTS, 56, 56, 192)}
TRAIN_STEPS = 10
NUM_CLASSES = 400
# examples/train_synthetic.py's solver
SOLVER = dict(base_lr=0.005, lr_policy="fixed", momentum=0.9, weight_decay=5e-4,
              clip_gradients=40.0, iter_size=1, solver_type="nesterov")
# One f32 step, card (TF32 off) against CPU: relative L2 of the parameter
# updates.  The f32 step is sensitive to the order of its sums (train-mode
# BN's f32 moments): on the CPU, this port and the reference differ by
# 9.7e-3 in the update at crop 64, S=4, N=2, and the reference's f32
# gradients by up to 9.0e-3 from its own f64 ones; the card sums in yet
# other orders.
F32_UPDATE_REL_L2_BOUND = 5e-2
TEST_METRIC_REL_TOL = 1e-6


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _ms_per_call(fn, iters: int = 100) -> float:
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(dev) -> dict:
    """K1 against its plain version at the serving shape; returns its largest
    error and both times."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randint(0, 256, (BATCH, SEGMENTS, HEIGHT, WIDTH, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    h_off = torch.randint(0, HEIGHT - CROP + 1, (BATCH,), device=dev, generator=gen)
    w_off = torch.randint(0, WIDTH - CROP + 1, (BATCH,), device=dev, generator=gen)
    mirror = torch.randint(0, 2, (BATCH,), device=dev, generator=gen).bool()
    max_err = 0.0
    for dtype, act_scale in ((torch.bfloat16, None), (torch.float32, None),
                             (torch.int8, ACT_SCALE)):
        kw = dict(crop=CROP, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
        got = preprocess.preprocess_on_device(frames, h_off, w_off, mirror, **kw)
        want = preprocess.crop_normalize_reference(frames, h_off, w_off, mirror, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"K1 {str(dtype):15s} kernel vs plain: equal={torch.equal(got, want)} "
              f"max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"K1 disagrees with its plain version in {dtype}")
        max_err = max(max_err, err)

    kw = dict(crop=CROP, mean=MEAN, out_dtype=torch.bfloat16)
    kernel = lambda: preprocess.preprocess_on_device(frames, h_off, w_off, mirror, **kw)
    plain = lambda: preprocess.crop_normalize_reference(frames, h_off, w_off, mirror, **kw)
    # plain, kernel, kernel, plain: drift in clocks hits both alike
    p1, k1, k2, p2 = (_ms_per_call(f) for f in (plain, kernel, kernel, plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    moved = BATCH * SEGMENTS * CROP * CROP * 3 * (1 + 2)  # uint8 read + bf16 write
    print(f"K1 bf16 {tuple(frames.shape)}, 100 launches per block: "
          f"kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), "
          f"plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); kernel moves "
          f"{moved / 1e6:.1f} MB -> {moved / ms / 1e6:.1f} GB/s")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _requests(count: int):
    """uint8 frames in pinned host memory, as a decoder would hand them over;
    the first request is center-cropped, the others get random offsets and
    mirrors."""
    gen = torch.Generator().manual_seed(SEED + 1)
    reqs = []
    for i in range(count):
        frames = torch.randint(0, 256, (BATCH, SEGMENTS, HEIGHT, WIDTH, 3),
                               dtype=torch.uint8, generator=gen).pin_memory()
        aug = {}
        if i > 0:
            aug = dict(
                h_off=torch.randint(0, HEIGHT - CROP + 1, (BATCH,), generator=gen),
                w_off=torch.randint(0, WIDTH - CROP + 1, (BATCH,), generator=gen),
                mirror=torch.randint(0, 2, (BATCH,), generator=gen).bool(),
            )
        reqs.append((frames, aug))
    return reqs


def serve(dev, card: str):
    """The main path at full width; returns the kernel's launch count, and
    the server and its requests for phase 8."""
    t0 = time.perf_counter()
    graph = get_model("eco_lite_kinetics", batch=BATCH, num_segments=SEGMENTS,
                      crop_size=CROP)
    params, state = Program(graph, device=dev).init(
        torch.Generator().manual_seed(SEED), {"data": graph.inputs["data"]})
    g_opt, p_opt, s_opt = optimize_for_inference(graph, params, state)
    server = UInt8Server(Program(g_opt, device=dev), p_opt, s_opt, crop=CROP, mean=MEAN)
    reqs = _requests(1 + TIMED_REQUESTS)
    torch.cuda.synchronize()
    print(f"setup: {len(server.program.exec_layers)} layers after optimize, "
          f"{time.perf_counter() - t0:.1f} s")

    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(reqs))]
    preprocess.crop_normalize_launches = 0
    t0 = time.perf_counter()
    frames, aug = reqs[0]
    outs = [server(frames, **aug)]  # warm-up (cuDNN autotune)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    events[0].record()
    for i, (frames, aug) in enumerate(reqs[1:], start=1):
        outs.append(server(frames, **aug))
        events[i].record()
    torch.cuda.synchronize()
    launches = preprocess.crop_normalize_launches
    if launches != len(reqs):
        raise AssertionError(f"K1 launched {launches} times for {len(reqs)} requests")
    per_req = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    total = events[0].elapsed_time(events[-1])
    print(f"serving: {len(reqs)} requests ({BATCH} videos each), K1 launches "
          f"{launches}; warm-up {warm_s:.2f} s; timed requests (ms, in order) "
          f"{[round(t, 3) for t in per_req]}, median "
          f"{statistics.median(per_req):.3f} ms; "
          f"{TIMED_REQUESTS * BATCH / (total / 1e3):.1f} videos/s bf16, "
          f"host->device copy included; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {card}")

    for probs in outs:
        probs = probs.float()
        if tuple(probs.shape) != (BATCH, 400):
            raise AssertionError(f"probs shape {tuple(probs.shape)}")
        if not torch.isfinite(probs).all():
            raise AssertionError("non-finite probabilities")
        worst = (probs.sum(-1) - 1).abs().max().item()
        if worst > PROBS_SUM_TOL:
            raise AssertionError(f"probability rows sum to 1 +- {worst}")
    print(f"probs: dtype {outs[0].dtype}, shape {tuple(outs[0].shape)}, finite, "
          f"rows sum to 1 within {PROBS_SUM_TOL}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames, aug = reqs[1]
    logits16 = UInt8Server(Program(g_opt, device=dev), p_opt, s_opt, crop=CROP,
                           mean=MEAN, output="fc8")(frames, **aug).float()
    logits32 = UInt8Server(Program(g_opt, compute_dtype=torch.float32, device=dev),
                           p_opt, s_opt, crop=CROP, mean=MEAN, output="fc8")(frames, **aug)
    rel = ((logits16 - logits32).norm() / logits32.norm()).item()
    print(f"logits bf16 vs f32 (TF32 off): rel L2 {rel:.6f} "
          f"(bound {BF16_LOGITS_REL_L2_BOUND}); f32 |logits| max "
          f"{logits32.abs().max().item():.4f}")
    if not rel <= BF16_LOGITS_REL_L2_BOUND:
        raise AssertionError(f"bf16 logits off f32 by rel L2 {rel}")

    # The same f32 server on the CPU (the path the tests hold against the
    # JAX reference) for two of the videos.
    cpu_p = {ln: {k: v.cpu() for k, v in d.items()} for ln, d in p_opt.items()}
    cpu_s = {ln: {k: v.cpu() for k, v in d.items()} for ln, d in s_opt.items()}
    logits_cpu = UInt8Server(Program(g_opt, compute_dtype=torch.float32), cpu_p, cpu_s,
                             crop=CROP, mean=MEAN, output="fc8")(
        frames[:2], **{k: v[:2] for k, v in aug.items()})
    rel_cpu = ((logits32[:2].cpu() - logits_cpu).norm() / logits_cpu.norm()).item()
    print(f"logits f32 card vs f32 CPU, 2 videos: rel L2 {rel_cpu:.3e} "
          f"(bound {F32_CARD_VS_CPU_REL_L2_BOUND})")
    if not rel_cpu <= F32_CARD_VS_CPU_REL_L2_BOUND:
        raise AssertionError(f"f32 logits on the card off the CPU's by rel L2 {rel_cpu}")
    return launches, server, reqs


@contextlib.contextmanager
def _pallas_pool(on: bool):
    """``ECO_PALLAS_POOL=1`` (K2 on the pool route) inside, unset otherwise."""
    old = os.environ.pop("ECO_PALLAS_POOL", None)
    if on:
        os.environ["ECO_PALLAS_POOL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("ECO_PALLAS_POOL", None)
        if old is not None:
            os.environ["ECO_PALLAS_POOL"] = old


def _reset_counts():
    preprocess.crop_normalize_launches = 0
    poolfuse.fused_maxpool_launches = 0


def _counts():
    torch.cuda.synchronize()
    return preprocess.crop_normalize_launches, poolfuse.fused_maxpool_launches


def check_pool_kernel(dev) -> dict:
    """K2 against its plain version at ECO-Lite's two pool shapes; returns
    its largest error and the times of K2, its plain version and the
    ``pool_nd`` route, summed over the two shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    times = {}
    for name, shape in POOL_SHAPES.items():
        base = torch.randn(shape, device=dev, generator=gen) - 0.5
        scale = torch.randn(shape[-1], device=dev, generator=gen) * 0.3 + 1.0
        shift = torch.randn(shape[-1], device=dev, generator=gen) * 0.2
        for dtype in (torch.bfloat16, torch.float32):
            y = base.to(dtype)
            for variant in ("plain", "relu", "affine"):
                kw = dict(relu=variant == "relu", affine=variant == "affine")
                args = (scale, shift) if variant == "affine" else ()
                got = poolfuse.fused_maxpool_3x3s2(y, *args, **kw)
                want = poolfuse.fused_maxpool_3x3s2_reference(y, *args, **kw)
                torch.cuda.synchronize()
                equal = torch.equal(got, want)
                err = (got.float() - want.float()).abs().max().item()
                print(f"K2 {name} {str(dtype):14s} {variant:6s} kernel vs plain: "
                      f"equal={equal} max_abs_err={err}")
                if not equal:
                    raise AssertionError(f"K2 disagrees with its plain version: "
                                         f"{name} {dtype} {variant}")
                max_err = max(max_err, err)
        y = base.to(torch.bfloat16)
        del base
        kernel = lambda: poolfuse.fused_maxpool_3x3s2(y)
        plain = lambda: poolfuse.fused_maxpool_3x3s2_reference(y)
        route = lambda: pool.pool_nd(y, kernel=3, stride=2, mode="max")
        # plain, route, kernel, kernel, route, plain: drift hits all alike
        p1, r1, k1, k2, r2, p2 = (_ms_per_call(f) for f in
                                  (plain, route, kernel, kernel, route, plain))
        t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "pool_nd_route_ms": (r1 + r2) / 2}
        n, h, w, c = shape
        moved = n * h * w * c * 2 + n * (h // 2) * (w // 2) * c * 2  # bf16 read + write
        print(f"K2 bf16 {name} {shape}, 100 launches per block: kernel {t['ms']:.4f} ms "
              f"({k1:.4f}, {k2:.4f}), plain {t['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f}), "
              f"pool_nd route (pad + max_pool2d) {t['pool_nd_route_ms']:.4f} ms "
              f"({r1:.4f}, {r2:.4f}); kernel moves {moved / 1e6:.1f} MB -> "
              f"{moved / t['ms'] / 1e6:.1f} GB/s, plain {moved / t['plain_ms'] / 1e6:.1f} "
              f"GB/s, route {moved / t['pool_nd_route_ms'] / 1e6:.1f} GB/s of 3350")
        times[name] = t
    total = {k: sum(t[k] for t in times.values()) for k in ("ms", "plain_ms", "pool_nd_route_ms")}
    return {"max_abs_err": max_err, **total, "by_shape": times}


def _train_batch(seed: int, videos: int = BATCH):
    """One micro-batch of the raw train plane in pinned host memory, with a
    leading micro-batch axis of 1: uint8 frames, random offsets, mirrors
    and labels."""
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "data": torch.randint(0, 256, (1, videos, SEGMENTS, HEIGHT, WIDTH, 3),
                              dtype=torch.uint8, generator=gen),
        "h_off": torch.randint(0, HEIGHT - CROP + 1, (1, videos), generator=gen),
        "w_off": torch.randint(0, WIDTH - CROP + 1, (1, videos), generator=gen),
        "mirror": torch.randint(0, 2, (1, videos), generator=gen).bool(),
        "label": torch.randint(0, NUM_CLASSES, (1, videos), generator=gen),
    }
    return {k: v.pin_memory() for k, v in batch.items()}


def train(dev, card: str):
    """Full-width ECO-Lite training through the Trainer on one repeated
    batch; returns the trainer, the trained state, the batch and K1's
    launch count."""
    t0 = time.perf_counter()
    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True, batch=BATCH)
    train_prog = RawPreprocessProgram(
        Program(graph, train=True, compute_dtype=torch.bfloat16, device=dev), crop=CROP, mean=MEAN)
    test_prog = RawPreprocessProgram(
        Program(graph, compute_dtype=torch.bfloat16, device=dev), crop=CROP, mean=MEAN)
    cfg = SolverConfig(**SOLVER, max_iter=1 + TRAIN_STEPS, display=0, snapshot=0)
    step = make_train_step(train_prog, cfg)
    events = []

    def timed_step(ts, batch, generator):
        out = step(ts, batch, generator)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    trainer = Trainer(train_prog, cfg, test_program=test_prog, step_fn=timed_step,
                      log_fn=print, metrics_lag=1)
    batch = _train_batch(SEED + 2)
    ts = trainer.init_state({k: v[0] for k, v in batch.items()}, seed=SEED)
    torch.cuda.synchronize()
    print(f"train setup: {sum(v.numel() for lp in ts.params.values() for v in lp.values())} "
          f"params, {len(train_prog.exec_layers)} TRAIN layers, "
          f"dropout {graph.layer('dropout').opt('dropout_ratio')}, "
          f"{time.perf_counter() - t0:.1f} s")

    seen = []
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    ts = trainer.solve(ts, itertools.repeat(batch), hooks=[
        lambda it, _ts, m: seen.append((it, float(m["loss"]), float(m["grad_norm"])))])
    k1, k2 = _counts()
    wall = time.perf_counter() - t0
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    total = events[0].elapsed_time(events[-1])
    losses = [l for _, l, _ in seen]
    norms = [g for _, _, g in seen]
    print(f"training: {len(seen)} steps of {BATCH} videos x {SEGMENTS} segments, bf16, "
          f"Nesterov lr {SOLVER['base_lr']}; losses {[round(l, 4) for l in losses]}; "
          f"grad norms {[round(g, 2) for g in norms]}")
    print(f"training: timed steps (ms, in order) {[round(t, 3) for t in per_step]}, median "
          f"{statistics.median(per_step):.3f} ms; {TRAIN_STEPS * BATCH / (total / 1e3):.1f} "
          f"train videos/s bf16; wall {wall:.2f} s with the warm-up step; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; K1 launches {k1}, "
          f"K2 launches {k2}; {card}")
    if [it for it, _, _ in seen] != list(range(1 + TRAIN_STEPS)):
        raise AssertionError(f"steps seen {[it for it, _, _ in seen]}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError("non-finite loss or gradient norm")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    if k1 != 1 + TRAIN_STEPS or k2 != 0:
        raise AssertionError(f"training launched K1 {k1} and K2 {k2} times")
    return trainer, ts, batch, k1


def f32_step_card_vs_cpu(dev, batch):
    """One f32 Nesterov step of the same two videos on the card and on the
    CPU from the same weights, dropout 0, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True, batch=2,
                           dropout_ratio=0.0)
    params, state = Program(graph, train=True).init(
        torch.Generator().manual_seed(SEED),
        {"data": (2, SEGMENTS, CROP, CROP, 3), "label": (2,)})
    micro = {k: v[:, :2] for k, v in batch.items()}
    updates, notes = [], []
    for where in ("cpu", dev):
        t0 = time.perf_counter()
        p = {ln: {k: v.to(where) for k, v in d.items()} for ln, d in params.items()}
        s = {ln: {k: v.to(where) for k, v in d.items()} for ln, d in state.items()}
        prog = RawPreprocessProgram(Program(graph, train=True, device=where), crop=CROP, mean=MEAN)
        ts, m = make_train_step(prog, SolverConfig(**SOLVER))(init_train_state(p, s), micro)
        updates.append(torch.cat([(ts.params[ln][k] - p[ln][k]).flatten().cpu()
                                  for ln in sorted(p) for k in sorted(p[ln])]))
        notes.append(f"{where}: loss {float(m['loss']):.6f}, grad norm "
                     f"{float(m['grad_norm']):.4f}, {time.perf_counter() - t0:.1f} s")
    rel = ((updates[1] - updates[0]).norm() / updates[0].norm()).item()
    print(f"f32 train step card vs CPU, 2 videos, TF32 off: update rel L2 {rel:.3e} "
          f"(bound {F32_UPDATE_REL_L2_BOUND}); " + "; ".join(notes))
    if not rel <= F32_UPDATE_REL_L2_BOUND:
        raise AssertionError(f"f32 update on the card off the CPU's by rel L2 {rel}")
    return rel


def test_pass(trainer, ts, batches) -> int:
    """The Trainer's test pass without and with K2; returns K2's launches."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    results = {}
    for on in (False, True):
        with _pallas_pool(on):
            _reset_counts()
            results[on] = trainer.test(ts, batches)
            k1, k2 = _counts()
        print(f"test pass ECO_PALLAS_POOL={int(on)}: {len(batches)} batches of {BATCH} "
              f"videos, {results[on]}; K1 launches {k1}, K2 launches {k2}")
        if k1 != len(batches) or k2 != (2 * len(batches) if on else 0):
            raise AssertionError(f"test pass launched K1 {k1} and K2 {k2} times")
    torch.backends.cudnn.deterministic = deterministic
    for key in ("top1", "top5", "loss"):
        a, b = results[False][key], results[True][key]
        if not abs(a - b) <= TEST_METRIC_REL_TOL * max(abs(a), abs(b)):
            raise AssertionError(f"test {key} {a} without K2, {b} with it")
    print(f"test metrics with K2 equal those without within {TEST_METRIC_REL_TOL} relative")
    return k2


def serve_with_pool_kernel(server, reqs, card: str) -> tuple[int, int]:
    """The serving requests in blocks without, with, with and without K2;
    returns K1's and K2's launches in the blocks with it."""
    times = {False: [], True: []}
    launches = [0, 0]
    outs = {}
    for on in (False, True, True, False):
        with _pallas_pool(on):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(reqs) + 1)]
            _reset_counts()
            events[0].record()
            for i, (frames, aug) in enumerate(reqs, start=1):
                outs[on] = server(frames, **aug)
                events[i].record()
            k1, k2 = _counts()
        times[on] += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        if k1 != len(reqs) or k2 != (2 * len(reqs) if on else 0):
            raise AssertionError(f"serving launched K1 {k1} and K2 {k2} times")
        if on:
            launches = [launches[0] + k1, launches[1] + k2]
    probs = outs[True].float()
    if not torch.isfinite(probs).all() or (probs.sum(-1) - 1).abs().max() > PROBS_SUM_TOL:
        raise AssertionError("serving with K2 gave bad probabilities")
    print(f"serving with K2 (ECO_PALLAS_POOL=1): median "
          f"{statistics.median(times[True]):.3f} ms per request of {BATCH} videos "
          f"({len(times[True])} requests) against {statistics.median(times[False]):.3f} ms "
          f"without ({len(times[False])}), blocks off/on/on/off; K2 launches "
          f"{launches[1]} = 2 per request; last request's probs equal without K2: "
          f"{torch.equal(outs[True], outs[False])}; {card}")
    return launches[0], launches[1]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on the GPU")
    os.environ.pop("ECO_PALLAS_POOL", None)
    dev = torch.device("cuda", 0)
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all(["preprocess", "poolfuse"])
    preprocess.build_kernel()
    poolfuse.build_kernel()
    print(f"K1 + K2 build (two nvcc together) and load: {time.perf_counter() - t0:.2f} s")

    checked = check_kernel(dev)
    _reset_counts()
    launches, server, reqs = serve(dev, card)
    k2_in_serve = _counts()[1]
    if k2_in_serve:
        raise AssertionError(f"K2 launched {k2_in_serve} times with ECO_PALLAS_POOL unset")
    pool_checked = check_pool_kernel(dev)
    trainer, ts, batch, k1_train = train(dev, card)
    f32_step_card_vs_cpu(dev, batch)
    test_batches = [{k: v[0] for k, v in b.items()} for b in (batch, _train_batch(SEED + 3))]
    k2_test = test_pass(trainer, ts, test_batches)
    k1_k2serve, k2_serve = serve_with_pool_kernel(server, reqs, card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    k1_paths = {"serve": launches, "train": k1_train, "test": len(test_batches),
                "serve_k2": k1_k2serve}
    k2_paths = {"test": k2_test, "serve_k2": k2_serve}
    records = [
        {
            "name": "crop_normalize",
            "route": "cuda",
            "source": "eco_tpu_torch/csrc/preprocess.cu",
            "replaces": "eco_tpu/ops/pallas/preprocess.py:40",
            "launches": sum(k1_paths.values()),
            "launches_by_path": k1_paths,
            **checked,
        },
        {
            "name": "fused_maxpool_3x3s2",
            "route": "cuda",
            "source": "eco_tpu_torch/csrc/poolfuse.cu",
            "replaces": "eco_tpu/ops/pallas/poolfuse.py:73",
            "launches": sum(k2_paths.values()),
            "launches_by_path": k2_paths,
            **pool_checked,
        },
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
