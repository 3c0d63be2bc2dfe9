#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (every failure raises; the exit code is then non-zero):

1. The card's name and power limit (nvidia-smi), and the build of the
   crop/normalize CUDA kernel from ``eco_tpu_torch/csrc/preprocess.cu``.
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

Prints a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import optimize_for_inference
from eco_tpu_torch.models import get_model
from eco_tpu_torch.ops import preprocess
from eco_tpu_torch.runtime import Program

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


def serve(dev, card: str) -> int:
    """The main path at full width; returns the kernel's launch count."""
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
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on the GPU")
    dev = torch.device("cuda", 0)
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    preprocess.build_kernel()
    print(f"K1 build and load: {time.perf_counter() - t0:.2f} s")

    checked = check_kernel(dev)
    launches = serve(dev, card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    record = {
        "name": "crop_normalize",
        "route": "cuda",
        "source": "eco_tpu_torch/csrc/preprocess.cu",
        "replaces": "eco_tpu/ops/pallas/preprocess.py:40",
        "launches": launches,
        **checked,
    }
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
