#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--k1-baseline PREPROCESS_CU] [--k3-baseline QCONV_CU]
                          [--k3-table DIR]

Phases (every failure raises; the exit code is then non-zero):

1. The card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels ``eco_tpu_torch/csrc/{preprocess,poolfuse,qconv}.cu``, one nvcc
   each, started together.
2. K1 against its plain PyTorch version on the card at the serving shape
   (8, 16, 256, 340, 3) uint8, random in-range offsets and mirrors, from the
   device and from the host, in bf16, f32 and int8: the outputs must be
   equal (``torch.equal``).  K1 is timed as device time in CUDA graphs in
   each type beside its bound (its bytes at 3.35 TB/s), and, with
   ``--k1-baseline``, an earlier K1 source with the previous C interface in
   turns with it; the wrapper with host offsets (and the previous wrapper's
   path in front of the baseline) and the plain version on the host's clock.
3. Full-width ECO-Lite Kinetics (400 classes, 16 segments, 224 crop) at
   batch 8 with seeded random weights, optimized for inference, served by
   the bf16 ``UInt8Server`` from uint8 frames in pinned host memory: one
   warm-up request and ten timed ones.  Probabilities must be finite,
   (8, 400) and sum to 1; the kernel must have launched once per request.
   The logits are compared with an f32 run of the same server (TF32 off),
   and that run with the f32 server on the CPU for two of the videos.
4. K2, the fused 3x3/s2 max pool, against its plain PyTorch version at the
   four shapes serving gives it: pool1 (128, 112, 112, 64) and pool2
   (128, 56, 56, 192), and ECO-Full's inception_3c_pool (128, 28, 28, 320)
   and inception_4e_pool (128, 14, 14, 608), in bf16 and f32, plain, with
   ReLU and with a seeded affine: equal (``torch.equal``).  Then K2, its
   plain version, the ``pool_nd`` route it replaces (pad + ``max_pool2d``)
   and ``max_pool2d(ceil_mode=True)`` timed in bf16, beside K2's bound.
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
   side, and the probabilities with K2 equal those without (max pool is
   exact).
9. K3, the int8 convolution, against its plain PyTorch version at the shapes
   of quantized ECO-Lite at batch 8 (conv1 on K1's int8 output, a 2D 3x3, a
   3D 3x3x3/s2, res5's 3x3x3 and the fc) and of ECO-Full's 2D branch (a
   merged 1x1 and two 3x3/s2 at 14x14), in f32, bf16 and int8 out: equal
   (``torch.equal``).  Then K3, the bf16 cuDNN conv of the same shape and,
   at the 1x1 and fc shapes, ``torch._int_mm`` timed in CUDA graphs, its
   plain version on the host's clock, beside K3's bound.
10. Full-width ECO-Full Kinetics (``fc8N``) served as in phase 3, with the
    same checks, then again without and with ``ECO_PALLAS_POOL=1`` (K2 four
    times a request: pool1, pool2, inception_3c_pool and inception_4e_pool).
11. int8 serving of ECO-Lite and of ECO-Full: ``quantize_for_serving`` of the
    optimized graph, calibrated on two batches of K1's f32 clips, served in
    bf16 by ``UInt8Server(int8_input=True)`` (K1 emits int8 into conv1): K1
    once and K3 once per int8 layer a request.  One more request holds every
    K3 call against its plain version on the same operands (``torch.equal``),
    and K3 is timed at every int8 layer of that request in CUDA graphs beside
    its bound, the bf16 cuDNN conv and ``torch._int_mm`` (and, with
    ``--k3-baseline``, an earlier K3 source with the previous C interface,
    in turns), with the request's sums; with ``--k3-table DIR`` the
    per-layer table goes to ``DIR/k3_layers_<model>.json``.
    The int8 program in f32 on two videos, layer by layer on the card's
    inputs, card against CPU: int8 tops equal, float tops within a stated
    bound.  End to end, its f32 logits, card against CPU, agree within a
    stated bound, and in argmax where the top-1 margin is clear; its bf16
    logits are held to the float server's.

Prints a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
from eco_tpu_torch.convert import optimize_for_inference, quantize_for_serving
from eco_tpu_torch.models import build_eco_lite, get_model
from eco_tpu_torch.ops import _build, pool, poolfuse, preprocess, qconv
from eco_tpu_torch.runtime import Program, get_impl
from eco_tpu_torch.runtime.executor import Context
from eco_tpu_torch.train import SolverConfig, Trainer, init_train_state, make_train_step
from eco_tpu_torch.utils.shapes import normalize_spatial_param

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
# every max pool that K2 takes on the serving paths (ECO-Full has all four)
POOL_SHAPES = {"pool1": (BATCH * SEGMENTS, 112, 112, 64),
               "pool2": (BATCH * SEGMENTS, 56, 56, 192),
               "inception_3c_pool": (BATCH * SEGMENTS, 28, 28, 320),
               "inception_4e_pool": (BATCH * SEGMENTS, 14, 14, 608)}
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
# K3's checks and timings, at the shapes of quantized full-width ECO-Lite and
# ECO-Full at batch 8: (input, C_out, kernel, stride, pad); the fc runs as a
# 1x1 conv, and the 1x1 is inception_4a's three sibling 1x1s merged by
# optimize_for_inference (224 + 64 + 96 outputs)
QCONV_SHAPES = {
    "conv1_7x7_s2": ((BATCH * SEGMENTS, CROP, CROP, 3), 64, (7, 7), 2, 3),
    "inception_3a_3x3": ((BATCH * SEGMENTS, 28, 28, 64), 64, (3, 3), 1, 1),
    "res4a_1": ((BATCH, SEGMENTS, 28, 28, 128), 256, (3, 3, 3), 2, 1),
    "fc8": ((BATCH, 1, 1, 512), NUM_CLASSES, (1, 1), 1, 0),
    "inception_4a_1x1__merged": ((BATCH * SEGMENTS, 14, 14, 576), 384, (1, 1), 1, 0),
    "inception_4e_double_3x3_2": ((BATCH * SEGMENTS, 14, 14, 256), 256, (3, 3), 2, 1),
    "inception_4e_3x3": ((BATCH * SEGMENTS, 14, 14, 128), 192, (3, 3), 2, 1),
    "res5b_1": ((BATCH, 4, 7, 7, 512), 512, (3, 3, 3), 1, 1),
}
QCONV_ITERS = 100
# K3 at every int8 layer of one request: launches per timed block
LAYER_ITERS = 20
# The card's published peaks (H100 SXM, dense; NVIDIA's data sheet) for the
# bounds: the least time for a kernel's bytes or its operations
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
CALIB_BATCHES = 2
# The int8 program in f32, layer by layer, each layer on the card's inputs on
# the card and on the CPU: int8 tops equal, float tops (average and global
# pools, softmax: sums in other orders) within this relative L2; 1.7e-7 the
# largest measured at full width on an H100
INT8_LAYER_F32_REL_L2_BOUND = 1e-6
# The same program end to end, card against CPU: those last-bit differences
# flip int8 values by 1 at the next quantize, and the flips compound layer
# after layer.  3x the largest relative L2 of the logits measured on an H100
# over 4 requests of 2 videos, ECO-Lite and ECO-Full (0 to 7.4e-3)
INT8_CARD_VS_CPU_REL_L2_BOUND = 2.2e-2
# ...and the argmax must agree for every video whose CPU top-1 margin is above
# this (3x the largest max |difference| of the logits measured, 0.108).
# Random-weight ECO-Full logits sit near uniform: a top-1 margin of 7.7e-5
# was measured, and there the card's argmax may be the runner-up.
INT8_ARGMAX_MARGIN = 0.33
# int8 logits against the float server's, both bf16: 3x the largest relative
# L2 measured on the CPU over 4 requests of 2 videos, S=4, f32 and bf16 with
# the same calibration: 3.25e-2 for ECO-Lite at crop 64, 2.09e-2 for ECO-Full
# at crop 224 (its 7x7 pool needs 224)
INT8_VS_FLOAT_REL_L2_BOUND = {"eco_lite_kinetics": 9.8e-2, "eco_full_kinetics": 6.3e-2}


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


def _graph_ms(fn, iters: int) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    the graph replayed five times between CUDA events.  The host's cost per
    call (Python, ctypes) is left out, so a small kernel is timed, not the
    interpreter in front of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _bound_ms(moved_bytes: float, ops: float = 0.0, ops_per_s: float = INT8_OPS_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger; and which it is."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


K1_ITERS = 100
K1_TYPES = {"bf16": (torch.bfloat16, None), "f32": (torch.float32, None),
            "int8": (torch.int8, ACT_SCALE)}


def _k1_call(fn, frames, offsets, out, act_scale, baseline: bool):
    """One launch of K1 (``baseline``: an earlier K1 with the previous
    C interface) on packed int32 device offsets, without the wrapper."""
    n, s, h, w, _ = frames.shape
    kind = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[out.dtype]
    aug = ((offsets[0].data_ptr(), offsets[1].data_ptr(), offsets[2].data_ptr()) if baseline
           else (offsets.data_ptr(), 0))
    err = fn(frames.data_ptr(), *aug, out.data_ptr(), n, s, h, w, out.shape[2], *MEAN, kind,
             float(act_scale or 1.0), torch.cuda.current_stream(frames.device).cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    return out


def _build_k1_baseline(path: str):
    """An earlier K1 source with the previous C interface (``eco_crop_normalize``
    on separate int32 h_off, w_off and uint8 mirror arrays), built into the
    build directory and loaded."""
    out = _build.BUILD_DIR / "libpreprocess_baseline.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path],
                   check=True, timeout=600)
    fn = ctypes.CDLL(str(out)).eco_crop_normalize
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _baseline_wrapper(fn, frames, h_off, w_off, mirror, out_dtype):
    """The previous wrapper's path in front of the baseline kernel: each of the
    offsets and the mirror made a device tensor with ``torch.as_tensor``,
    which for host values is a blocking copy from pageable memory."""
    dev = frames.device
    per_video = [torch.as_tensor(v, device=dev).to(dt).contiguous()
                 for v, dt in ((h_off, torch.int32), (w_off, torch.int32), (mirror, torch.uint8))]
    out = torch.empty((*frames.shape[:2], CROP, CROP, 3), dtype=out_dtype, device=dev)
    return _k1_call(fn, frames, per_video, out, None, baseline=True)


def check_kernel(dev, card: str, baseline=None) -> dict:
    """K1 against its plain version at the serving shape in bf16, f32 and
    int8 (``torch.equal``).  Then K1 timed as device time in CUDA graphs in
    each type beside its bound (in turns with ``baseline``, an earlier K1,
    where given), the plain version and the wrapper on the host's clock,
    the latter with host offsets as a server gets them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randint(0, 256, (BATCH, SEGMENTS, HEIGHT, WIDTH, 3),
                           dtype=torch.uint8, device=dev, generator=gen)
    h_off = torch.randint(0, HEIGHT - CROP + 1, (BATCH,), device=dev, generator=gen)
    w_off = torch.randint(0, WIDTH - CROP + 1, (BATCH,), device=dev, generator=gen)
    mirror = torch.randint(0, 2, (BATCH,), device=dev, generator=gen).bool()
    host = (h_off.cpu(), w_off.cpu(), mirror.cpu())
    max_err = 0.0
    for name, (dtype, act_scale) in K1_TYPES.items():
        kw = dict(crop=CROP, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
        want = preprocess.crop_normalize_reference(frames, h_off, w_off, mirror, **kw)
        for where, offsets in (("device int64", (h_off, w_off, mirror)), ("host int64", host)):
            got = preprocess.preprocess_on_device(frames, *offsets, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f"K1 {name:4s} kernel vs plain, {where} offsets: "
                  f"equal={torch.equal(got, want)} max_abs_err={err}")
            if not torch.equal(got, want):
                raise AssertionError(f"K1 disagrees with its plain version in {name}")
            max_err = max(max_err, err)

    kernel_fn = preprocess._kernel()
    packed = preprocess._pack_aug(h_off.int(), w_off.int(), mirror.int(), BATCH, dev)
    per_video = (h_off.int(), w_off.int(), mirror.to(torch.uint8))
    ms, bound, base_ms = {}, {}, {}
    for name, (dtype, act_scale) in K1_TYPES.items():
        out = torch.empty((BATCH, SEGMENTS, CROP, CROP, 3), dtype=dtype, device=dev)
        kernel = lambda: _k1_call(kernel_fn, frames, packed, out, act_scale, baseline=False)
        fns = [kernel]
        if baseline is not None:
            base_out = torch.empty_like(out)
            old = lambda: _k1_call(baseline, frames, per_video, base_out, act_scale, baseline=True)
            old()
            if not torch.equal(base_out, kernel()):
                raise AssertionError(f"baseline K1 and K1 differ in {name}")
            fns = [old, kernel]
        # [baseline,] kernel, kernel[, baseline]
        first = [_graph_ms(f, K1_ITERS) for f in fns]
        second = [_graph_ms(f, K1_ITERS) for f in reversed(fns)][::-1]
        ms[name] = (first[-1] + second[-1]) / 2
        if baseline is not None:
            base_ms[name] = (first[0] + second[0]) / 2
        moved = BATCH * SEGMENTS * CROP * CROP * 3 * (1 + out.element_size())
        bound[name], _ = _bound_ms(moved)
        print(f"K1 {name:4s} device time (CUDA graphs, {K1_ITERS} launches a graph): "
              f"{ms[name]:.4f} ms ({first[-1]:.4f}, {second[-1]:.4f}), bound "
              f"{bound[name]:.4f} ms (bytes: {moved / 1e6:.1f} MB at 3.35 TB/s), "
              f"{bound[name] / ms[name]:.1%} of it"
              + (f"; baseline kernel {base_ms[name]:.4f} ms ({first[0]:.4f}, {second[0]:.4f}), "
                 f"{base_ms[name] / ms[name]:.2f}x K1's time" if baseline is not None else "")
              + f"; {card}")

    kw = dict(crop=CROP, mean=MEAN, out_dtype=torch.bfloat16)
    wrapper = lambda: preprocess.preprocess_on_device(frames, *host, **kw)
    plain = lambda: preprocess.crop_normalize_reference(frames, h_off, w_off, mirror, **kw)
    fns = [plain, wrapper]
    if baseline is not None:
        fns.append(lambda: _baseline_wrapper(baseline, frames, *host, torch.bfloat16))
    # on the host's clock, in turns: plain, wrapper[, baseline], [baseline,] wrapper, plain
    first = [_ms_per_call(f) for f in fns]
    second = [_ms_per_call(f) for f in reversed(fns)][::-1]
    host_ms = [(a + b) / 2 for a, b in zip(first, second)]
    print(f"K1 bf16 host's clock, 100 calls a block, host int64 offsets and bool mirror: "
          f"wrapper {host_ms[1]:.4f} ms a call ({first[1]:.4f}, {second[1]:.4f})"
          + (f", the previous wrapper and baseline kernel {host_ms[2]:.4f} ms "
             f"({first[2]:.4f}, {second[2]:.4f})" if baseline is not None else "")
          + f"; plain {host_ms[0]:.4f} ms ({first[0]:.4f}, {second[0]:.4f}); no single "
          f"PyTorch call computes it")
    rec = {"max_abs_err": max_err, "ms": ms["bf16"], "plain_ms": host_ms[0],
           "bound_ms": bound["bf16"], "bound_by": "bytes", "library_ms": None,
           "ms_by_dtype": ms, "bound_ms_by_dtype": bound, "host_ms_per_call": host_ms[1]}
    if baseline is not None:
        rec["baseline_ms_by_dtype"] = base_ms
        rec["baseline_host_ms_per_call"] = host_ms[2]
    return rec


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


def _timed_requests(server, reqs):
    """One warm-up request (cuDNN autotune), then the others timed with CUDA
    events; returns the outputs, the timed requests' ms in order, videos/s
    over them, and the warm-up's seconds."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(reqs))]
    t0 = time.perf_counter()
    frames, aug = reqs[0]
    outs = [server(frames, **aug)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    events[0].record()
    for i, (frames, aug) in enumerate(reqs[1:], start=1):
        outs.append(server(frames, **aug))
        events[i].record()
    torch.cuda.synchronize()
    per_req = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    videos_s = (len(reqs) - 1) * BATCH / (events[0].elapsed_time(events[-1]) / 1e3)
    return outs, per_req, videos_s, warm_s


def _check_probs(outs):
    for probs in outs:
        probs = probs.float()
        if tuple(probs.shape) != (BATCH, NUM_CLASSES):
            raise AssertionError(f"probs shape {tuple(probs.shape)}")
        if not torch.isfinite(probs).all():
            raise AssertionError("non-finite probabilities")
        worst = (probs.sum(-1) - 1).abs().max().item()
        if worst > PROBS_SUM_TOL:
            raise AssertionError(f"probability rows sum to 1 +- {worst}")
    print(f"probs: dtype {outs[0].dtype}, shape {tuple(outs[0].shape)}, finite, "
          f"rows sum to 1 within {PROBS_SUM_TOL}")


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _to(tree, dev):
    return {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in tree.items()}


def _f32_logits_card_and_cpu(dev, graph, params, state, request, fc: str):
    """The f32 server (TF32 off) of ``graph`` on the card, and on the CPU for
    two of the videos; returns both logits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames, aug = request
    card = UInt8Server(Program(graph, compute_dtype=torch.float32, device=dev), params, state,
                       crop=CROP, mean=MEAN, output=fc)(frames, **aug)
    cpu = UInt8Server(Program(graph, compute_dtype=torch.float32, device="cpu"), _to(params, "cpu"),
                      _to(state, "cpu"), crop=CROP, mean=MEAN, output=fc)(
        frames[:2], **{k: v[:2] for k, v in aug.items()})
    return card, cpu


def serve_float(dev, card: str, model: str, fc: str, reqs):
    """Full-width bf16 serving of ``model``, optimized for inference; returns
    the server, its graph, params and state, K1's launches and the bf16
    logits of the second request."""
    t0 = time.perf_counter()
    graph = get_model(model, batch=BATCH, num_segments=SEGMENTS, crop_size=CROP)
    params, state = Program(graph, device=dev).init(
        torch.Generator().manual_seed(SEED), {"data": graph.inputs["data"]})
    g_opt, p_opt, s_opt = optimize_for_inference(graph, params, state)
    server = UInt8Server(Program(g_opt, device=dev), p_opt, s_opt, crop=CROP, mean=MEAN)
    torch.cuda.synchronize()
    print(f"{model} setup: {len(server.program.exec_layers)} layers after optimize, "
          f"{time.perf_counter() - t0:.1f} s")

    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    outs, per_req, videos_s, warm_s = _timed_requests(server, reqs)
    launches = _counts()
    if launches != (len(reqs), 0, 0):
        raise AssertionError(f"{model} serving launched K1, K2, K3 {launches} times "
                             f"for {len(reqs)} requests")
    print(f"{model} serving: {len(reqs)} requests ({BATCH} videos each), K1 launches "
          f"{launches[0]}; warm-up {warm_s:.2f} s; timed requests (ms, in order) "
          f"{[round(t, 3) for t in per_req]}, median "
          f"{statistics.median(per_req):.3f} ms; {videos_s:.1f} videos/s bf16, "
          f"host->device copy included; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {card}")
    _check_probs(outs)

    logits32, logits_cpu = _f32_logits_card_and_cpu(dev, g_opt, p_opt, s_opt, reqs[1], fc)
    frames, aug = reqs[1]
    logits16 = UInt8Server(Program(g_opt, device=dev), p_opt, s_opt, crop=CROP,
                           mean=MEAN, output=fc)(frames, **aug)
    rel = _rel_l2(logits16, logits32)
    print(f"{model} logits bf16 vs f32 (TF32 off): rel L2 {rel:.6f} "
          f"(bound {BF16_LOGITS_REL_L2_BOUND}); f32 |logits| max "
          f"{logits32.abs().max().item():.4f}")
    if not rel <= BF16_LOGITS_REL_L2_BOUND:
        raise AssertionError(f"{model} bf16 logits off f32 by rel L2 {rel}")
    # the f32 server on the CPU: the path the tests hold against the reference
    rel_cpu = _rel_l2(logits32[:2].cpu(), logits_cpu)
    print(f"{model} logits f32 card vs f32 CPU, 2 videos: rel L2 {rel_cpu:.3e} "
          f"(bound {F32_CARD_VS_CPU_REL_L2_BOUND})")
    if not rel_cpu <= F32_CARD_VS_CPU_REL_L2_BOUND:
        raise AssertionError(f"{model} f32 logits on the card off the CPU's by rel L2 {rel_cpu}")
    return server, (g_opt, p_opt, s_opt), launches[0], logits16


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
    qconv.qconv_launches = 0


def _counts():
    """K1's, K2's and K3's launches since ``_reset_counts``."""
    torch.cuda.synchronize()
    return (preprocess.crop_normalize_launches, poolfuse.fused_maxpool_launches,
            qconv.qconv_launches)


def check_pool_kernel(dev) -> dict:
    """K2 against its plain version at POOL_SHAPES; returns its largest
    error and the times of K2, its plain version and the ``pool_nd`` route,
    summed over the shapes."""
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
        # ATen's pool on the channels-last NCHW view: with pad 0 and even H
        # and W, ceil mode is Caffe's rule
        library = lambda: torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 3, 2,
                                                         ceil_mode=True)
        if not torch.equal(library().permute(0, 2, 3, 1), poolfuse.fused_maxpool_3x3s2(y)):
            raise AssertionError(f"max_pool2d(ceil_mode=True) is not K2's function at {name}")
        # plain, route, library, kernel, kernel, library, route, plain
        p1, r1, l1, k1, k2, l2, r2, p2 = (_ms_per_call(f) for f in
                                          (plain, route, library, kernel, kernel, library,
                                           route, plain))
        t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "pool_nd_route_ms": (r1 + r2) / 2,
             "library_ms": (l1 + l2) / 2}
        n, h, w, c = shape
        moved = n * h * w * c * 2 + n * (h // 2) * (w // 2) * c * 2  # bf16 read + write
        t["bound_ms"], _ = _bound_ms(moved)
        print(f"K2 bf16 {name} {shape}, 100 launches per block: kernel {t['ms']:.4f} ms "
              f"({k1:.4f}, {k2:.4f}), plain {t['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f}), "
              f"pool_nd route (pad + max_pool2d) {t['pool_nd_route_ms']:.4f} ms "
              f"({r1:.4f}, {r2:.4f}); kernel moves {moved / 1e6:.1f} MB -> "
              f"{moved / t['ms'] / 1e6:.1f} GB/s, plain {moved / t['plain_ms'] / 1e6:.1f} "
              f"GB/s, route {moved / t['pool_nd_route_ms'] / 1e6:.1f} GB/s of 3350; "
              f"max_pool2d(ceil_mode=True) {t['library_ms']:.4f} ms ({l1:.4f}, {l2:.4f}); "
              f"bound {t['bound_ms']:.4f} ms (bytes), kernel at "
              f"{t['bound_ms'] / t['ms']:.1%} of it")
        times[name] = t
    keys = ("ms", "plain_ms", "pool_nd_route_ms", "library_ms", "bound_ms")
    total = {k: sum(t[k] for t in times.values()) for k in keys}
    return {"max_abs_err": max_err, **total, "bound_by": "bytes", "by_shape": times}


def _qconv_case(dev, gen, name):
    """Seeded int8 operands of K3 at one of QCONV_SHAPES: conv1's input is
    K1's int8 output, the others uniform int8."""
    shape, c_out, kernel, stride, pad = QCONV_SHAPES[name]
    if name == "conv1_7x7_s2":
        frames = torch.randint(0, 256, (BATCH, SEGMENTS, HEIGHT, WIDTH, 3),
                               dtype=torch.uint8, device=dev, generator=gen)
        centre = torch.full((BATCH,), (HEIGHT - CROP) // 2, device=dev)
        x = preprocess.preprocess_on_device(
            frames, centre, torch.full((BATCH,), (WIDTH - CROP) // 2, device=dev),
            torch.zeros(BATCH, dtype=torch.bool, device=dev), crop=CROP, mean=MEAN,
            act_scale=ACT_SCALE).reshape(shape)
    else:
        x = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)
    w = torch.randint(-127, 128, (c_out, shape[-1], *kernel), dtype=torch.int8,
                      device=dev, generator=gen)
    scale_vec = torch.rand(c_out, device=dev, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(c_out, device=dev, generator=gen)
    kw = dict(stride=stride, pad=pad)
    y = qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw)
    # int8 out at half the f32 range: some outputs clip, most round
    out_scale = y.abs().max().item() / 127 / 2
    return x, qconv.kernel_layout(w), scale_vec, bias, kw, out_scale


def _k3_work(x, w, out):
    """Operations and bytes of one K3 call: 2 x MACs, and its int8 input and
    weights read once, its output written once (scale_vec and bias too)."""
    macs = math.prod(out.shape[:-1]) * w.shape[0] * math.prod(w.shape[1:])
    moved = (x.numel() + w.numel() + out.numel() * out.element_size()
             + 2 * 4 * w.shape[0])
    return 2 * macs, moved


def _cudnn_bf16(x, w, bias, kw):
    """The bf16 cuDNN conv of the same shape (a yardstick, not K3's
    function): channels-last NCHW operands made once."""
    nsp = x.ndim - 2
    x16 = x.movedim(-1, 1).to(torch.bfloat16)
    w16 = w.to(torch.bfloat16)
    b16 = bias.to(torch.bfloat16) if bias is not None else None
    conv = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
            3: torch.nn.functional.conv3d}[nsp]
    return lambda: conv(x16, w16, b16, stride=kw.get("stride", 1), padding=kw.get("pad", 0),
                        dilation=kw.get("dilation", 1), groups=kw.get("groups", 1))


def _int_mm(x, w, kw):
    """``torch._int_mm``, the same int32 product without the epilogue, where
    the conv is a plain matrix product (1x1, stride 1, no pad, one group) and
    the op takes the shape; else None."""
    nsp = x.ndim - 2
    if (math.prod(w.shape[2:]) != 1 or kw.get("groups", 1) != 1
            or set(normalize_spatial_param(kw.get("pad", 0), nsp)) != {0}
            or set(normalize_spatial_param(kw.get("stride", 1), nsp, default=1)) != {1}):
        return None
    a = x.reshape(-1, x.shape[-1])
    b = w.reshape(w.shape[0], -1).t()
    try:
        torch._int_mm(a, b)
    except RuntimeError:
        return None
    return lambda: torch._int_mm(a, b)


def check_qconv_kernel(dev) -> dict:
    """K3 against its plain version at QCONV_SHAPES in f32, bf16 and int8 out
    (``torch.equal``); then K3, its plain version, the bf16 cuDNN conv of the
    same shape and, at the 1x1 and fc shapes, ``torch._int_mm`` timed, bf16
    out, beside K3's bound.  Returns its largest error and the times summed
    over the shapes (``library_ms``: cuDNN's)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    times = {}
    for name in QCONV_SHAPES:
        x, w, scale_vec, bias, kw, out_scale = _qconv_case(dev, gen, name)
        for out in (torch.float32, torch.bfloat16, torch.int8):
            okw = dict(out_scale=out_scale) if out == torch.int8 else dict(out_dtype=out)
            got = qconv.qconv_nd(x, w, scale_vec, bias, **kw, **okw)
            want = qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw, **okw)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            err = (got.float() - want.float()).abs().max().item()
            print(f"K3 {name} {tuple(x.shape)} -> {tuple(got.shape)} {str(out):14s} "
                  f"kernel vs plain: equal={equal} max_abs_err={err}")
            if not equal:
                raise AssertionError(f"K3 disagrees with its plain version: {name} {out}")
            max_err = max(max_err, err)
        kernel = lambda: qconv.qconv_nd(x, w, scale_vec, bias, **kw, out_dtype=torch.bfloat16)
        plain = lambda: qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw,
                                                 out_dtype=torch.bfloat16)
        cudnn = _cudnn_bf16(x, w, bias, kw)
        int_mm = _int_mm(x, w, kw)
        # plain, cuDNN, [_int_mm,] kernel, kernel, [_int_mm,] cuDNN, plain;
        # the plain version on the host's clock, the others in CUDA graphs
        fns = [plain, cudnn] + ([int_mm] if int_mm else []) + [kernel]
        timer = lambda f: _ms_per_call(f, QCONV_ITERS) if f is plain else _graph_ms(f, QCONV_ITERS)
        first = [timer(f) for f in fns]
        second = [timer(f) for f in reversed(fns)][::-1]
        avg = [(a + b) / 2 for a, b in zip(first, second)]
        ops, moved = _k3_work(x, w, kernel())
        bound_ms, bound_by = _bound_ms(moved, ops)
        t = {"ms": avg[-1], "plain_ms": avg[0], "library_ms": avg[1],
             "int_mm_ms": avg[2] if int_mm else None, "bound_ms": bound_ms,
             "bound_by": bound_by}
        print(f"K3 bf16-out {name}, {QCONV_ITERS} launches per timing: kernel "
              f"{t['ms']:.4f} ms ({first[-1]:.4f}, {second[-1]:.4f}), plain (f64 conv) "
              f"{t['plain_ms']:.4f} ms, cuDNN bf16 conv {t['library_ms']:.4f} ms, _int_mm "
              + (f"{t['int_mm_ms']:.4f} ms" if int_mm else "n/a")
              + f"; {ops / 1e9:.4g} GOP, {moved / 1e6:.1f} MB -> kernel "
              f"{ops / t['ms'] / 1e9:.1f} TOP/s of 1979 int8; bound {bound_ms:.4f} ms "
              f"({bound_by}), kernel at {bound_ms / t['ms']:.1%} of it")
        times[name] = t
    total = {k: sum(t[k] for t in times.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {t["bound_by"] for t in times.values()}
    return {"max_abs_err": max_err, **total,
            "bound_by": by.pop() if len(by) == 1 else "operations", "by_shape": times}


def _build_k3_baseline(path: str):
    """An earlier K3 source with the previous C interface (``eco_qconv`` without
    the plan arguments), built into the build directory and loaded."""
    out = _build.BUILD_DIR / "libqconv_baseline.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path],
                   check=True, timeout=600)
    fn = ctypes.CDLL(str(out)).eco_qconv
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 22
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _baseline_call(fn, x, w, scale_vec, b, out_dtype, out_scale, kw):
    """One launch of the baseline kernel on a K3 call's operands."""
    nsp = x.ndim - 2
    geo = [normalize_spatial_param(kw.get(k, d), nsp, default=d)
           for k, d in (("stride", 1), ("pad", 0), ("dilation", 1))]
    n, *spatial, c_in = x.shape
    kernel = tuple(w.shape[2:])
    out_sp = [(i + 2 * p - dl * (k - 1) - 1) // s + 1
              for i, k, s, p, dl in zip(spatial, kernel, *geo)]
    kind = torch.int8 if out_scale is not None else out_dtype
    out = torch.empty((n, *out_sp, w.shape[0]), dtype=kind, device=x.device)
    pad3 = lambda vals, fill: [fill] * (3 - nsp) + [int(v) for v in vals]
    err = fn(x.data_ptr(), w.movedim(1, -1).data_ptr(), scale_vec.data_ptr(),
             b.data_ptr() if b is not None else None, out.data_ptr(), n, *pad3(spatial, 1),
             c_in, w.shape[0], kw.get("groups", 1), *pad3(kernel, 1), *pad3(geo[0], 1),
             *pad3(geo[1], 0), *pad3(geo[2], 1), *pad3(out_sp, 1),
             {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[kind],
             float(out_scale if out_scale is not None else 1.0),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"baseline K3 launch failed: CUDA error {err}")
    return out


def k3_request_layers(server, request, model: str, card: str, baseline=None,
                      cache=None, table_dir=None) -> dict:
    """K3 at every int8 layer of one request of ``server``: the calls are
    recorded on their real operands, then each distinct geometry is timed
    (blocks: [baseline,] cuDNN bf16, [_int_mm,] K3, K3, [_int_mm,] cuDNN,
    [baseline]), and the request's sums reported beside K3's bound.
    ``cache`` shares timings between models by geometry; with ``table_dir``
    the per-layer table is written there as JSON."""
    calls = []
    kernel = qconv.qconv_nd

    def record(x_q, w_q, scale_vec, b=None, **kw):
        calls.append((x_q, w_q, scale_vec, b, dict(kw)))
        return kernel(x_q, w_q, scale_vec, b, **kw)

    qconv.qconv_nd = record
    try:
        frames, aug = request
        server(frames, **aug)
        torch.cuda.synchronize()
    finally:
        qconv.qconv_nd = kernel
    names = [l.name for l in server.program.exec_layers
             if l.type.lower() in ("qconvolution", "qinnerproduct")]
    if len(names) != len(calls):
        raise AssertionError(f"{model}: {len(calls)} K3 calls for {len(names)} int8 layers")
    cache = {} if cache is None else cache
    rows = []
    for name, (x, w, sv, b, kw) in zip(names, calls):
        key = (tuple(x.shape), tuple(w.shape), b is not None,
               tuple(sorted((k, str(v)) for k, v in kw.items() if k != "out_scale")),
               kw.get("out_scale") is not None)
        if key not in cache:
            fn = lambda: kernel(x, w, sv, b, **kw)
            out = fn()
            if baseline is not None and not torch.equal(
                    out, _baseline_call(baseline, x, w, sv, b, kw.get("out_dtype"),
                                        kw.get("out_scale"), kw)):
                raise AssertionError(f"{model} {name}: baseline K3 and K3 differ")
            fns = ([lambda: _baseline_call(baseline, x, w, sv, b, kw.get("out_dtype"),
                                           kw.get("out_scale"), kw)] if baseline else [])
            int_mm = _int_mm(x, w, kw)
            fns += [_cudnn_bf16(x, w, b, kw)] + ([int_mm] if int_mm else []) + [fn]
            first = [_graph_ms(f, LAYER_ITERS) for f in fns]
            second = [_graph_ms(f, LAYER_ITERS) for f in reversed(fns)][::-1]
            avg = [(u + v) / 2 for u, v in zip(first, second)]
            ops, moved = _k3_work(x, w, out)
            bound, by = _bound_ms(moved, ops)
            cache[key] = {
                "ms": avg[-1], "baseline_ms": avg[0] if baseline else None,
                "cudnn_bf16_ms": avg[1 if baseline else 0],
                "int_mm_ms": avg[-2] if int_mm else None,
                "bound_ms": bound, "bound_by": by, "gop": ops / 1e9,
                "x": tuple(x.shape), "w": tuple(w.shape), "out": str(out.dtype),
                "plan": qconv.plan_for(x, w, **{k: v for k, v in kw.items() if k in
                                                ("stride", "pad", "dilation", "groups")}).mode,
            }
        rows.append({"layer": name, **cache[key]})
    sums = {k: sum(r[k] for r in rows) for k in ("ms", "cudnn_bf16_ms", "bound_ms")}
    if baseline is not None:
        sums["baseline_ms"] = sum(r["baseline_ms"] for r in rows)
    for r in rows:
        print(f"K3 {model} {r['layer']} {r['x']} x {r['w']} -> {r['out']} ({r['plan']}): "
              f"{r['ms']:.4f} ms, {r['gop'] / r['ms']:.1f} TOP/s, {r['bound_ms'] / r['ms']:.1%} "
              f"of bound {r['bound_ms']:.4f} ms ({r['bound_by']}); cuDNN bf16 "
              f"{r['cudnn_bf16_ms']:.4f} ms"
              + (f"; _int_mm {r['int_mm_ms']:.4f} ms" if r["int_mm_ms"] is not None else "")
              + (f"; baseline kernel {r['baseline_ms']:.4f} ms" if r["baseline_ms"] is not None
                 else ""))
    print(f"K3 {model} one int8 request, {len(rows)} calls, device time (CUDA graphs): K3 "
          f"{sums['ms']:.4f} ms, bound "
          f"{sums['bound_ms']:.4f} ms ({sums['bound_ms'] / sums['ms']:.1%}), cuDNN bf16 "
          f"{sums['cudnn_bf16_ms']:.4f} ms"
          + (f", baseline kernel {sums['baseline_ms']:.4f} ms "
             f"({sums['baseline_ms'] / sums['ms']:.2f}x K3's time)" if baseline else "")
          + f"; {LAYER_ITERS} launches a graph; {card}")
    if table_dir:
        os.makedirs(table_dir, exist_ok=True)
        with open(os.path.join(table_dir, f"k3_layers_{model}.json"), "w") as f:
            json.dump({"card": card, "sums": sums, "layers": rows}, f, indent=1)
    return sums


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
    k1, k2, k3 = _counts()
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
    if k1 != 1 + TRAIN_STEPS or k2 != 0 or k3 != 0:
        raise AssertionError(f"training launched K1 {k1}, K2 {k2} and K3 {k3} times")
    return trainer, ts, batch, k1


def f32_step_card_vs_cpu(dev, batch):
    """One f32 Nesterov step of the same two videos on the card and on the
    CPU from the same weights, dropout 0, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True, batch=2,
                           dropout_ratio=0.0)
    params, state = Program(graph, train=True, device="cpu").init(
        torch.Generator().manual_seed(SEED),
        {"data": (2, SEGMENTS, CROP, CROP, 3), "label": (2,)})
    micro = {k: v[:, :2] for k, v in batch.items()}
    updates, notes = [], []
    for where in ("cpu", dev):
        t0 = time.perf_counter()
        p, s = _to(params, where), _to(state, where)
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
            k1, k2, k3 = _counts()
        print(f"test pass ECO_PALLAS_POOL={int(on)}: {len(batches)} batches of {BATCH} "
              f"videos, {results[on]}; K1 launches {k1}, K2 launches {k2}")
        if k1 != len(batches) or k2 != (2 * len(batches) if on else 0) or k3:
            raise AssertionError(f"test pass launched K1 {k1} and K2 {k2} times")
    torch.backends.cudnn.deterministic = deterministic
    for key in ("top1", "top5", "loss"):
        a, b = results[False][key], results[True][key]
        if not abs(a - b) <= TEST_METRIC_REL_TOL * max(abs(a), abs(b)):
            raise AssertionError(f"test {key} {a} without K2, {b} with it")
    print(f"test metrics with K2 equal those without within {TEST_METRIC_REL_TOL} relative")
    return k2


def serve_with_pool_kernel(server, reqs, card: str, model: str,
                           k2_per_request: int) -> tuple[int, int]:
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
            k1, k2, k3 = _counts()
        times[on] += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        if k1 != len(reqs) or k2 != (k2_per_request * len(reqs) if on else 0) or k3:
            raise AssertionError(f"{model} serving launched K1 {k1}, K2 {k2} and K3 {k3} times")
        if on:
            launches = [launches[0] + k1, launches[1] + k2]
    probs = outs[True].float()
    if not torch.isfinite(probs).all() or (probs.sum(-1) - 1).abs().max() > PROBS_SUM_TOL:
        raise AssertionError(f"{model} serving with K2 gave bad probabilities")
    # max pool is exact: K2 and the route it replaces give the same bits
    if not torch.equal(outs[True], outs[False]):
        raise AssertionError(f"{model} probs with K2 differ from those without")
    print(f"{model} serving with K2 (ECO_PALLAS_POOL=1): median "
          f"{statistics.median(times[True]):.3f} ms per request of {BATCH} videos "
          f"({len(times[True])} requests) against {statistics.median(times[False]):.3f} ms "
          f"without ({len(times[False])}), blocks off/on/on/off; K2 launches "
          f"{launches[1]} = {k2_per_request} per request; last request's probs equal "
          f"without K2: True; {card}")
    return launches[0], launches[1]


def _calibration_batches(dev):
    """CALIB_BATCHES batches of K1's f32 center crops of seeded uint8 frames."""
    gen = torch.Generator().manual_seed(SEED + 4)
    centre = [torch.full((BATCH,), (size - CROP) // 2, device=dev) for size in (HEIGHT, WIDTH)]
    batches = []
    for _ in range(CALIB_BATCHES):
        frames = torch.randint(0, 256, (BATCH, SEGMENTS, HEIGHT, WIDTH, 3), dtype=torch.uint8,
                               generator=gen).to(dev)
        batches.append({"data": preprocess.preprocess_on_device(
            frames, *centre, torch.zeros(BATCH, dtype=torch.bool, device=dev), crop=CROP,
            mean=MEAN, out_dtype=torch.float32)})
    return batches


def _k3_held_to_plain(server, request) -> list:
    """One request of ``server`` with every K3 call held against its plain
    version on the same operands (``torch.equal``); returns the input
    shapes checked, one per call."""
    kernel = qconv.qconv_nd
    checked = []

    def held(x_q, w_q, scale_vec, b=None, **kw):
        got = kernel(x_q, w_q, scale_vec, b, **kw)
        if not torch.equal(got, qconv.qconv_nd_reference(x_q, w_q, scale_vec, b, **kw)):
            raise AssertionError(f"K3 disagrees with its plain version at input "
                                 f"{tuple(x_q.shape)}, weights {tuple(w_q.shape)}, {kw}")
        checked.append(tuple(x_q.shape))
        return got

    qconv.qconv_nd = held
    try:
        frames, aug = request
        server(frames, **aug)
        torch.cuda.synchronize()
    finally:
        qconv.qconv_nd = kernel
    return checked


def _int8_layers_card_vs_cpu(dev, graph, params, state, request) -> tuple[int, float]:
    """The f32 int8 server's program on two videos of ``request``, layer by
    layer: each layer runs on the card, and on the CPU on a copy of the
    card's inputs, so a difference cannot compound.  int8 tops must be equal
    and float tops within INT8_LAYER_F32_REL_L2_BOUND; returns the number of
    int8 tops and the largest relative L2 of a float top."""
    server = UInt8Server(Program(graph, compute_dtype=torch.float32, device=dev), params,
                         state, crop=CROP, mean=MEAN)
    prog = server.program
    params_cpu, state_cpu = _to(params, "cpu"), _to(state, "cpu")
    frames, aug = request
    clips = preprocess.preprocess_on_device(
        frames[:2].to(dev), *(aug[k][:2].to(dev) for k in ("h_off", "w_off", "mirror")),
        crop=CROP, mean=MEAN, act_scale=server.in_scale)
    ctx = Context(compute_dtype=prog.compute_dtype)
    blobs = {"data": prog.cast_input(clips)}
    n_int8, worst = 0, 0.0
    for layer in prog.exec_layers:
        impl = get_impl(layer.type)
        ins = [blobs[b] for b in layer.bottoms]
        want = impl.apply(layer, params_cpu.get(layer.name, {}), state_cpu.get(layer.name, {}),
                          [x.cpu() for x in ins], ctx)
        got = impl.apply(layer, params.get(layer.name, {}), state.get(layer.name, {}), ins, ctx)
        for top, g, w in zip(layer.tops, got, want):
            g = g.cpu()
            if g.dtype != w.dtype:
                raise AssertionError(f"{top}: {g.dtype} on the card, {w.dtype} on the CPU")
            if g.dtype == torch.int8:
                n_int8 += 1
                if not torch.equal(g, w):
                    raise AssertionError(f"int8 top {top} ({layer.type}) on the card differs "
                                         f"from the CPU's in {int((g != w).sum())} values")
            else:
                rel = ((g.double() - w.double()).norm().item()
                       / max(w.double().norm().item(), 1e-30))
                worst = max(worst, rel)
                if not rel <= INT8_LAYER_F32_REL_L2_BOUND:
                    raise AssertionError(f"float top {top} ({layer.type}) on the card off the "
                                         f"CPU's by rel L2 {rel}")
        blobs.update(zip(layer.tops, got))
    return n_int8, worst


def serve_int8(dev, card: str, model: str, fc: str, float_side, reqs):
    """int8 post-training quantization of the optimized float graph, then
    bf16 serving through ``UInt8Server(int8_input=True)``; returns K1's and
    K3's launches on that path, and the server."""
    graph, params, state, float_logits16 = float_side
    t0 = time.perf_counter()
    qprog, qp, qs, report = quantize_for_serving(
        Program(graph, compute_dtype=torch.bfloat16, device=dev), params, state,
        _calibration_batches(dev), fold=False, compute_dtype=torch.bfloat16)
    server = UInt8Server(qprog, qp, qs, crop=CROP, mean=MEAN)
    torch.cuda.synchronize()
    n_q = len(report["quantized"])
    if server.in_scale is None:
        raise AssertionError(f"{model} int8: the int8 input plane is off")
    print(f"{model} int8: {n_q} layers quantized, {len(report['chained'])} chained; int8 "
          f"input plane on (K1 emits int8 at scale {server.in_scale:.6g}); quantize "
          f"({CALIB_BATCHES} calibration batches) {time.perf_counter() - t0:.1f} s")

    _reset_counts()
    outs, per_req, videos_s, warm_s = _timed_requests(server, reqs)
    launches = _counts()
    if launches != (len(reqs), 0, n_q * len(reqs)):
        raise AssertionError(f"{model} int8 serving launched K1, K2, K3 {launches} times for "
                             f"{len(reqs)} requests of {n_q} int8 layers")
    print(f"{model} int8 serving: {len(reqs)} requests ({BATCH} videos each), K1 (int8 "
          f"out) launches {launches[0]}, K3 launches {launches[2]} = {n_q} per request; "
          f"warm-up {warm_s:.2f} s; timed requests (ms, in order) "
          f"{[round(t, 3) for t in per_req]}, median {statistics.median(per_req):.3f} ms; "
          f"{videos_s:.1f} videos/s int8 + bf16, host->device copy included; {card}")
    _check_probs(outs)
    checked = _k3_held_to_plain(server, reqs[1])
    if len(checked) != n_q:
        raise AssertionError(f"{model} int8: {len(checked)} K3 calls held to the plain "
                             f"version, {n_q} int8 layers")
    print(f"{model} int8: each of the {n_q} K3 calls of one request equals its plain "
          f"version on the same operands ({len(set(checked))} input shapes)")

    n_int8, worst = _int8_layers_card_vs_cpu(dev, qprog.graph, qp, qs, reqs[1])
    print(f"{model} int8 program in f32, layer by layer on the card's inputs, card vs CPU, "
          f"2 videos: {n_int8} int8 tops equal, float tops within rel L2 {worst:.3e} (bound "
          f"{INT8_LAYER_F32_REL_L2_BOUND})")
    card32, cpu32 = _f32_logits_card_and_cpu(dev, qprog.graph, qp, qs, reqs[1], fc)
    card32 = card32[:2].cpu()
    rel_cpu = _rel_l2(card32, cpu32)
    top2 = cpu32.topk(2, -1).values
    margin = top2[:, 0] - top2[:, 1]
    held = margin > INT8_ARGMAX_MARGIN
    same = torch.equal(card32.argmax(-1)[held], cpu32.argmax(-1)[held])
    print(f"{model} int8 logits f32 end to end, card vs CPU, 2 videos: rel L2 {rel_cpu:.3e} "
          f"(bound {INT8_CARD_VS_CPU_REL_L2_BOUND}), max |diff| "
          f"{(card32 - cpu32).abs().max().item():.4f}; argmax card "
          f"{card32.argmax(-1).tolist()}, CPU {cpu32.argmax(-1).tolist()}, CPU top-1 margins "
          f"{[round(m, 5) for m in margin.tolist()]}: equal on the {int(held.sum())} above "
          f"{INT8_ARGMAX_MARGIN}: {same}")
    if not (same and rel_cpu <= INT8_CARD_VS_CPU_REL_L2_BOUND):
        raise AssertionError(f"{model} int8 f32 logits on the card off the CPU's")
    frames, aug = reqs[1]
    logits8 = UInt8Server(qprog, qp, qs, crop=CROP, mean=MEAN, output=fc)(frames, **aug)
    rel = _rel_l2(logits8, float_logits16)
    print(f"{model} logits int8 vs float, bf16, {BATCH} videos: rel L2 {rel:.4f} (bound "
          f"{INT8_VS_FLOAT_REL_L2_BOUND[model]}); argmax agrees on "
          f"{int((logits8.argmax(-1) == float_logits16.argmax(-1)).sum())} of {BATCH}")
    if not rel <= INT8_VS_FLOAT_REL_L2_BOUND[model]:
        raise AssertionError(f"{model} int8 logits off the float server's by rel L2 {rel}")
    return launches[0], launches[2], server


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--k3-baseline", metavar="QCONV_CU",
                        help="an earlier qconv.cu (the previous C interface, without the "
                             "plan arguments) to time in turns with K3 at every int8 layer")
    parser.add_argument("--k3-table", metavar="DIR",
                        help="write K3's per-layer table of each int8 request to DIR as JSON")
    parser.add_argument("--k1-baseline", metavar="PREPROCESS_CU",
                        help="an earlier preprocess.cu (the previous C interface, separate "
                             "offset arrays) to time in turns with K1")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on the GPU")
    os.environ.pop("ECO_PALLAS_POOL", None)
    dev = torch.device("cuda", 0)
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all(["preprocess", "poolfuse", "qconv"])
    preprocess.build_kernel()
    poolfuse.build_kernel()
    qconv.build_kernel()
    print(f"K1 + K2 + K3 build (three nvcc together) and load: {time.perf_counter() - t0:.2f} s")
    baseline = _build_k3_baseline(args.k3_baseline) if args.k3_baseline else None
    k1_baseline = _build_k1_baseline(args.k1_baseline) if args.k1_baseline else None

    checked = check_kernel(dev, card, k1_baseline)
    reqs = _requests(1 + TIMED_REQUESTS)
    server, lite, k1_serve, lite_logits16 = serve_float(dev, card, "eco_lite_kinetics", "fc8",
                                                        reqs)
    pool_checked = check_pool_kernel(dev)
    trainer, ts, batch, k1_train = train(dev, card)
    f32_step_card_vs_cpu(dev, batch)
    test_batches = [{k: v[0] for k, v in b.items()} for b in (batch, _train_batch(SEED + 3))]
    k2_test = test_pass(trainer, ts, test_batches)
    k1_k2serve, k2_serve = serve_with_pool_kernel(server, reqs, card, "eco_lite_kinetics", 2)
    del trainer, ts, server
    qconv_checked = check_qconv_kernel(dev)
    server, full, k1_full, full_logits16 = serve_float(dev, card, "eco_full_kinetics", "fc8N",
                                                       reqs)
    k1_full_k2, k2_full = serve_with_pool_kernel(server, reqs, card, "eco_full_kinetics", 4)
    del server
    k1_int8_lite, k3_int8_lite, server = serve_int8(dev, card, "eco_lite_kinetics", "fc8",
                                                    lite + (lite_logits16,), reqs)
    timed = {}
    k3_request = {"eco_lite_kinetics": k3_request_layers(server, reqs[1], "eco_lite_kinetics",
                                                         card, baseline, timed, args.k3_table)}
    del server
    k1_int8_full, k3_int8_full, server = serve_int8(dev, card, "eco_full_kinetics", "fc8N",
                                                    full + (full_logits16,), reqs)
    k3_request["eco_full_kinetics"] = k3_request_layers(server, reqs[1], "eco_full_kinetics",
                                                        card, baseline, timed, args.k3_table)
    del server
    for name in ("jax", "eco_tpu"):
        if name in sys.modules:
            raise AssertionError(f"the port imported {name}")
    k1_paths = {"serve": k1_serve, "train": k1_train, "test": len(test_batches),
                "serve_k2": k1_k2serve, "serve_full": k1_full, "serve_full_k2": k1_full_k2,
                "serve_int8_lite": k1_int8_lite, "serve_int8_full": k1_int8_full}
    k2_paths = {"test": k2_test, "serve_k2": k2_serve, "serve_full_k2": k2_full}
    k3_paths = {"serve_int8_lite": k3_int8_lite, "serve_int8_full": k3_int8_full}
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
        {
            "name": "qconv_nd",
            "route": "cuda",
            "source": "eco_tpu_torch/csrc/qconv.cu",
            "replaces": "eco_tpu/ops/quant.py:69 conv_nd_int8 (XLA int8 conv)",
            "launches": sum(k3_paths.values()),
            "launches_by_path": k3_paths,
            **qconv_checked,
            "request_ms": k3_request,
        },
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
