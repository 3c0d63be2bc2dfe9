#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--k1-baseline PREPROCESS_CU] [--k3-baseline QCONV_CU]
                          [--k3-table DIR] [--cli-tables DIR]

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
12. Online recognition (and, in phase 2, K1 at the online shape (64, 16,
    224, 224, 3) -> 224, offsets 0, in bf16, int8 and f32: equal, and
    timed): ``MultiStreamRecognizer`` of 64 streams of seeded uint8 256x340
    frames over the optimized bf16 ECO-Lite on the uint8 plane, a warm-up
    tick then three timed (windows/s, the card's ms a tick in CUDA events,
    host ms); the first tick held stream by stream to a 64-stream f32 tick
    (logits and labels); one tick of phase 11's int8 ECO-Lite with every K3
    call held to its plain version; one tick of 2 streams in f32, card
    against CPU, and streams 0-1 of the 64-stream f32 tick against it.
13. The fed train path: the bf16 ECO-Lite TRAIN graph through
    ``RawPreprocessProgram`` and ``Trainer(metrics_lag=1)``, fed by
    ``VideoPipeline(raw=True)`` over a JPEG frame tree written to a temp
    directory (``cv2`` is needed), serially and through
    ``prefetch_to_device`` at depths 1 and 2 in interleaved blocks; the feed
    alone, and the steps on a resident batch beside the decoding feed and
    with it closed; the put of one batch; and the race check: from one saved
    state on the same batches,
    serial (twice) and prefetched runs give equal losses under
    ``cudnn.deterministic``.

14. Phase ``cli``: the multi-scale plane's crop and resize (two batched f32
    products, ``ops/resize.py``) at the train shape, card against CPU on
    sampled windows, equal to K1's f32 crop at a full-size window, and timed;
    rematerialization: one bf16 train step of ECO-Lite and of ECO-Full at
    batch 8 from one state with no remat, ``"dots"`` and ``"nothing"`` under
    ``cudnn.deterministic`` (losses and updated params equal), each with its
    peak device memory and its step time (ECO-Lite's ``"dots"`` peak at least
    a quarter below the plain step's); then the port's CLI in this process
    (``tools.cli.main``): ``device-query``, ``train`` from a solver file over
    the JPEG tree on the raw plane with the zoo's multi-scale default and
    ``mem_param { optimize_train: true }`` (so remat ``"dots"``), ``test`` of
    the snapshot (K1), ``time --bf16`` and ``time --backward`` (the ten
    slowest layers and the totals; ``--cli-tables DIR`` writes the tables),
    ``quantize`` and ``test`` of the int8 graph with every K3 call held to
    its plain version.  Prints one ``{"cli": ...}`` line.

15. Phase ``tail``: K1 at CaffeNet's input, (32, 1, 256, 256, 3) -> 227 (a
    prime crop), random in-range offsets and mirrors, equal to its plain
    version in bf16, f32 and int8 and timed in CUDA graphs beside its bound;
    every one of the 35 layer types ported last (Deconvolution, LRN, MVN,
    PReLU, BatchNorm, the losses, SPP, ROIPooling, Filter, ...) once on the
    card against the same layer on the CPU at ECO-Lite's full widths (2D
    layers on pool2's output (128, 28, 28, 192), 3D on the head's input (8,
    16, 28, 28, 96), losses on (8, 400) logits), f32 with TF32 off, forward
    and, where the layer has params or is a loss, backward: equal where it
    moves or selects values, else within a stated bound; the 2D set once in
    bf16 (finite); each timed on the card.  Then BVLC CaffeNet at its
    published widths (``caffenet_prototxt``) trained from uint8 images
    through K1 by the ``Trainer`` with its published solver: a warm-up and
    ten timed bf16 steps at batch 32 (losses finite and falling, K1 once a
    step), the test pass of two batches, one f32 step card against CPU;
    and the CLI's ``time --bf16`` of its deploy form.  Prints one
    ``{"tail": ...}`` line.

16. Phase ``parallel``: a world-1 NCCL process group on the card and its
    mesh; full-width bf16 ECO-Lite trained through K1 by the plain
    ``Trainer`` and by ``Trainer(mesh=)`` (data parallel, SyncBN) from one
    state under ``cudnn.deterministic``, a warm-up and ten timed steps each:
    losses, params and BN state equal, the two step medians side by side,
    and one step of each under ``torch.profiler`` (its all-reduces and their
    host ms, the device's busy ms);
    full-width bf16 inference on K1's clips through the sharded,
    tensor-parallel and segment-sharded inference of a world of one and a
    2-stage pipeline on the one card, each equal to ``Program.apply`` (the
    pipeline on the same four microbatches); two spawned ranks on the one
    card over gloo (NCCL takes one rank a card), 4 videos each, one f32 DP
    + SyncBN step: equal params on both, and within a stated bound of one
    process's step over the 8 videos; the uint8 bf16 ECO-Lite serving
    artifact (``torch.export``) at batch 8, a dynamic-batch one and the int8
    one, loaded and run on the card by a fresh ``python3`` that cannot
    import eco_tpu_torch, eco_tpu or jax, held to the servers' outputs and
    timed beside ``UInt8Server``; and the bf16 artifact loaded by a fresh
    ``python3`` that imports eco_tpu_torch and builds ``UInt8Server`` for the
    same graph and weights on its own cuDNN state: their logits equal
    (``torch.equal``).  Prints one ``{"parallel": ...}`` line.

17. Phase ``examples``: first one int8 forward of ``quantized_serving``'s
    graph at the phase's width, in this process, each K3 call equal to its
    plain version.  Then the four workflows of ``eco_tpu_torch.examples``,
    each run as a user runs it, ``python3 -m eco_tpu_torch.examples.<name>
    --device cuda``, at published widths: ``train_synthetic`` (16 segments,
    batch 8, 15 iterations: losses finite and falling, test metrics finite),
    ``serve_streams`` (64 streams, 16 segments, 3 ticks: every stream a label
    in the class range), ``quantized_serving`` (crop 224, 16 segments, batch
    8: int8 and bf16 agree in argmax on every video whose bf16 margin is
    above ``QS_ARGMAX_MARGIN``, and in logits within the int8-vs-float
    bound, K3 once an int8 layer a forward) and ``aot_artifact`` (the same
    width, ``--dynamic-batch``: the destination's probs within 1e-2, its
    logits artifact equal to the live program's logits, both dynamic batch
    sizes).  Each reports its K1 and K3 launches from its own counters.
    Prints one ``{"examples": ...}`` line.
18. Phase ``int8_probe``: K3 at the probe's conv, (1536, 28, 28, 96) 3x3 pad
    1 -> 96 with the int8-out epilogue, equal to its plain version; one
    request of the probe's batch-96 servers, built in this process, through
    each: K1's bf16 and int8 clips and every K3 call equal to their plain
    versions; then ``python3 -m eco_tpu_torch.tools.int8_probe --device
    cuda`` at the reference's defaults (4096^3 products, that conv, ECO-Lite
    at batch 96 in bf16 and int8: K1 once a request, K3 once an int8 layer).
    Prints one ``{"int8_probe": ...}`` line.

Prints a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import io
import itertools
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from eco_tpu_torch.apps import MultiStreamRecognizer, RawPreprocessProgram, UInt8Server
from eco_tpu_torch.apps import online
from eco_tpu_torch.convert import (
    export_serving,
    optimize_for_inference,
    quantize_for_serving,
    save_serving_artifact,
)
from eco_tpu_torch.data import (
    TransformConfig,
    VideoDataConfig,
    VideoPipeline,
    prefetch_to_device,
)
from eco_tpu_torch.models import build_eco_lite, get_model
from eco_tpu_torch.apps import serving
from eco_tpu_torch.examples import quantized_serving
from eco_tpu_torch.ops import _build, pool, poolfuse, preprocess, qconv, resize
from eco_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    SEGMENT_AXIS,
    distributed_init,
    make_mesh,
    make_pp_infer_fn,
    make_segment_sharded_infer_fn,
    make_sharded_infer_fn,
    make_sharded_train_step,
    make_tp_infer_fn,
    mesh_shape,
    shard_batch,
    shard_tp_tree,
    split_stages,
)
from eco_tpu_torch.runtime import Program, get_impl, memory
from eco_tpu_torch.runtime.executor import Context
from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec, graph_to_json
from eco_tpu_torch.spec.prototxt import graph_from_prototxt
from eco_tpu_torch.tools import cli, int8_probe, memreport
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
# Online recognition: 64 concurrent streams (the reference bench's
# bench_online), one warm-up tick then ONLINE_TICKS timed ones; stream k's
# frame t is ONLINE_FRAMES[(7 k + t) % len]
ONLINE_STREAMS, ONLINE_TICKS, ONLINE_FRAME_POOL = 64, 3, 48
# The fed train path: the frame tree of bench.py's bench_train_e2e (24
# videos x 24 frames), serial / depth-1 / depth-2 blocks of E2E_BLOCK steps in
# E2E_ROUNDS interleaved rounds, and RACE_STEPS steps for the race check
E2E_VIDEOS, E2E_FRAMES = 24, 24
E2E_ROUNDS, E2E_BLOCK, RACE_STEPS, PUT_REPS = 3, 6, 3, 5
# The cli phase.  The resize on the card against the CPU: the same f32 sums
# of two one-hot-weighted terms, in other orders (FMA or not): ~1 ulp of 255
RESIZE_CARD_VS_CPU_BOUND = 1e-4
RESIZE_ITERS = 20
# the card's published f32 rate outside the tensor cores (the resize pins
# full f32 precision: no TF32)
F32_OPS_PER_S = 67e12
# remat: timed steps after the measured one; ECO-Lite's "dots" peak must be
# at most this share of the plain step's
REMAT_STEPS, REMAT_PEAK_SHARE = 3, 0.75
REMAT_POLICIES = (None, "dots", "nothing")
# the CLI's solver: examples/train_synthetic.py's, 4 iterations, a snapshot
# at the end
CLI_SOLVER = f"""
base_lr: {SOLVER['base_lr']}
lr_policy: "fixed"
momentum: {SOLVER['momentum']}
weight_decay: {SOLVER['weight_decay']}
clip_gradients: {SOLVER['clip_gradients']}
solver_type: NESTEROV
max_iter: 4
display: 1
snapshot: 4
snapshot_prefix: "{{prefix}}"
random_seed: {SEED}
"""
CLI_TEST_ITERATIONS, CLI_CALIB_BATCHES, CLI_TIME_ITERS = 2, 2, 5
# The tail phase.  BVLC CaffeNet (models/bvlc_reference_caffenet/
# train_val.prototxt) at its published widths: batch 32 of 227 crops of
# 256x256 uint8 images, 1000 classes, and its solver (solver.prototxt)
CAFFENET_WIDTHS = (96, 256, 384, 384, 256, 4096, 4096)
CAFFENET_BATCH, CAFFENET_SIZE, CAFFENET_CROP, CAFFENET_CLASSES = 32, 256, 227, 1000
CAFFENET_SOLVER = dict(base_lr=0.01, lr_policy="fixed", momentum=0.9, weight_decay=5e-4)
CAFFENET_STEPS, CAFFENET_F32_VIDEOS = 10, 4


def caffenet_prototxt(batch: int = CAFFENET_BATCH, crop: int = CAFFENET_CROP,
                      widths=CAFFENET_WIDTHS, classes: int = CAFFENET_CLASSES,
                      dropout: float = 0.5, deploy: bool = False) -> str:
    """BVLC CaffeNet's TRAIN/TEST graph (bvlc_reference_caffenet/
    train_val.prototxt) as prototxt text, its fillers, biases and lr/decay
    multipliers as published; ``input`` blobs stand in for the LMDB Data
    layer, the K1 crop for its transform.  ``widths`` are the outputs of
    conv1-5, fc6 and fc7; ``deploy`` gives the deploy form (no label, a
    Softmax "prob" in place of the loss and the accuracy)."""
    def conv(name, bottom, n, k, std, bias, stride=1, pad=0, group=1):
        return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{name}"\n'
                f'  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}\n'
                f'  convolution_param {{ num_output: {n} kernel_size: {k} stride: {stride} '
                f'pad: {pad} group: {group}\n'
                f'    weight_filler {{ type: "gaussian" std: {std} }}\n'
                f'    bias_filler {{ type: "constant" value: {bias} }} }} }}\n'
                f'layer {{ name: "relu{name[-1]}" type: "ReLU" bottom: "{name}" top: "{name}" }}\n')

    def fc(name, bottom, n, std, bias):
        return (f'layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" top: "{name}"\n'
                f'  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}\n'
                f'  inner_product_param {{ num_output: {n}\n'
                f'    weight_filler {{ type: "gaussian" std: {std} }}\n'
                f'    bias_filler {{ type: "constant" value: {bias} }} }} }}\n')

    def pool(name, bottom):
        return (f'layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" top: "{name}"\n'
                f'  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}\n')

    def lrn(name, bottom):
        return (f'layer {{ name: "{name}" type: "LRN" bottom: "{bottom}" top: "{name}"\n'
                f'  lrn_param {{ local_size: 5 alpha: 0.0001 beta: 0.75 }} }}\n')

    def relu_drop(n):
        return (f'layer {{ name: "relu{n}" type: "ReLU" bottom: "fc{n}" top: "fc{n}" }}\n'
                f'layer {{ name: "drop{n}" type: "Dropout" bottom: "fc{n}" top: "fc{n}"\n'
                f'  dropout_param {{ dropout_ratio: {dropout} }} }}\n')

    c1, c2, c3, c4, c5, f6, f7 = widths
    text = (f'name: "CaffeNet"\ninput: "data"\n'
            f'input_shape {{ dim: {batch} dim: 3 dim: {crop} dim: {crop} }}\n')
    if not deploy:
        text += f'input: "label"\ninput_shape {{ dim: {batch} }}\n'
    text += (conv("conv1", "data", c1, 11, 0.01, 0, stride=4) + pool("pool1", "conv1")
             + lrn("norm1", "pool1")
             + conv("conv2", "norm1", c2, 5, 0.01, 1, pad=2, group=2) + pool("pool2", "conv2")
             + lrn("norm2", "pool2")
             + conv("conv3", "norm2", c3, 3, 0.01, 0, pad=1)
             + conv("conv4", "conv3", c4, 3, 0.01, 1, pad=1, group=2)
             + conv("conv5", "conv4", c5, 3, 0.01, 1, pad=1, group=2) + pool("pool5", "conv5")
             + fc("fc6", "pool5", f6, 0.005, 1) + relu_drop(6)
             + fc("fc7", "fc6", f7, 0.005, 1) + relu_drop(7)
             + fc("fc8", "fc7", classes, 0.01, 0))
    if deploy:
        return text + 'layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }\n'
    return text + ('layer { name: "accuracy" type: "Accuracy" bottom: "fc8" bottom: "label"\n'
                   '  top: "accuracy" include { phase: TEST } }\n'
                   'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" bottom: "label"\n'
                   '  top: "loss" }\n')


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


@contextlib.contextmanager
def _k3_held():
    """Inside, every K3 call is held against its plain version on the same
    operands (``torch.equal``); yields the list of the input shapes checked,
    one per call."""
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
        yield checked
        torch.cuda.synchronize()
    finally:
        qconv.qconv_nd = kernel


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
    with _k3_held() as checked:
        frames, aug = reqs[1]
        server(frames, **aug)
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
    return launches[0], launches[2], server, (qprog, qp, qs)


def check_k1_online(dev, card: str) -> dict:
    """K1 at the online app's shape: frames already center-cropped on the host,
    (64, 16, 224, 224, 3) -> 224 at offsets 0, in bf16, int8 and f32, against
    its plain version (``torch.equal``), then timed as device time in CUDA
    graphs beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n = ONLINE_STREAMS
    frames = torch.randint(0, 256, (n, SEGMENTS, CROP, CROP, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    zeros, flags = [0] * n, [False] * n
    packed = preprocess._pack_aug(zeros, zeros, flags, n, dev)
    kernel_fn = preprocess._kernel()
    max_err, ms, bound = 0.0, {}, {}
    for name in ("bf16", "int8", "f32"):
        dtype, act_scale = K1_TYPES[name]
        kw = dict(crop=CROP, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
        got = preprocess.preprocess_on_device(frames, zeros, zeros, flags, **kw)
        want = preprocess.crop_normalize_reference(frames, zeros, zeros, flags, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 disagrees with its plain version at the online shape "
                                 f"in {name}")
        max_err = max(max_err, err)
        out = torch.empty_like(got)
        del got, want
        call = lambda: _k1_call(kernel_fn, frames, packed, out, act_scale, baseline=False)
        first, second = _graph_ms(call, K1_ITERS // 4), _graph_ms(call, K1_ITERS // 4)
        ms[name] = (first + second) / 2
        moved = frames.numel() * (1 + out.element_size())
        bound[name], _ = _bound_ms(moved)
        print(f"K1 {name:4s} online shape {tuple(frames.shape)} -> {CROP}, offsets 0: kernel "
              f"vs plain equal=True max_abs_err={err}; device time (CUDA graphs) "
              f"{ms[name]:.4f} ms ({first:.4f}, {second:.4f}), bound {bound[name]:.4f} ms "
              f"(bytes: {moved / 1e6:.1f} MB at 3.35 TB/s), {bound[name] / ms[name]:.1%} of it; "
              f"{card}")
        del out
    return {"online_max_abs_err": max_err, "online_ms_by_dtype": ms,
            "online_bound_ms_by_dtype": bound}


def _tick(rec, pool, tick: int, streams: int):
    """One window tick of ``rec``: SEGMENTS pushes of one frame per stream;
    returns the last push's results (one per stream)."""
    for t in range(SEGMENTS):
        i = tick * SEGMENTS + t
        out = rec.push_frames([pool[(7 * k + i) % len(pool)] for k in range(streams)])
    return out


def _check_tick(results, streams: int, what: str):
    if len(results) != streams or any(r is None for r in results):
        raise AssertionError(f"{what}: a tick gave {results if len(results) < 4 else '...'}")
    for label, smoothed in results:
        if smoothed.shape != (NUM_CLASSES,) or not np.isfinite(smoothed).all():
            raise AssertionError(f"{what}: smoothed logits {smoothed.shape}, finite "
                                 f"{np.isfinite(smoothed).all()}")
        if label != int(np.argmax(smoothed)):
            raise AssertionError(f"{what}: label {label} is not the argmax")


@contextlib.contextmanager
def _online_device_time(rec, spans: list):
    """CUDA events from K1's launch (after the frames' copy) to the tick's
    logits on the host, and the host's clock inside the forward call, one
    pair a forward, appended to ``spans`` as (device ms, forward call ms)."""
    k1, forward = online.preprocess_on_device, rec.single._forward

    def timed_k1(*args, **kw):
        timed_k1.start = torch.cuda.Event(enable_timing=True)
        timed_k1.start.record()
        return k1(*args, **kw)

    def timed_forward(*args, **kw):
        t0 = time.perf_counter()
        out = forward(*args, **kw)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        spans.append((timed_k1.start.elapsed_time(end), (time.perf_counter() - t0) * 1e3))
        return out

    online.preprocess_on_device, rec.single._forward = timed_k1, timed_forward
    try:
        yield
    finally:
        online.preprocess_on_device = k1
        del rec.single._forward


def online_phase(dev, card: str, lite, int8_lite) -> dict:
    """64-stream online recognition of full-width ECO-Lite, optimized, bf16,
    on the uint8 plane (K1 in every tick's forward), its first tick held
    stream by stream to a 64-stream f32 tick; one tick of the int8 ECO-Lite
    with every K3 call held to its plain version; one tick of 2 streams in
    f32, card against CPU.  Returns K1's and K3's launches by path."""
    graph, params, state = lite
    pool = [np.random.default_rng(SEED + 7 + i).integers(0, 256, (HEIGHT, WIDTH, 3),
                                                         dtype=np.uint8)
            for i in range(ONLINE_FRAME_POOL)]
    rec = MultiStreamRecognizer(Program(graph, compute_dtype=torch.bfloat16, device=dev),
                                params, state, num_streams=ONLINE_STREAMS,
                                num_segments=SEGMENTS, crop_size=CROP, plane="uint8",
                                output="fc8")
    spans, walls = [], []
    _reset_counts()
    with _online_device_time(rec, spans):
        for tick in range(1 + ONLINE_TICKS):
            t0 = time.perf_counter()
            results = _tick(rec, pool, tick, ONLINE_STREAMS)
            walls.append((time.perf_counter() - t0) * 1e3)
            _check_tick(results, ONLINE_STREAMS, "online bf16")
            if tick == 0:
                first = np.stack([r[1] for r in results])
    launches = _counts()
    if launches != (1 + ONLINE_TICKS, 0, 0):
        raise AssertionError(f"online launched K1, K2, K3 {launches} times in "
                             f"{1 + ONLINE_TICKS} ticks")
    timed = walls[1:]
    windows_s = ONLINE_STREAMS * ONLINE_TICKS / (sum(timed) / 1e3)
    device = [d for d, _ in spans[1:]]
    call = [c for _, c in spans[1:]]
    host = [w - c for w, c in zip(timed, call)]
    print(f"online: {ONLINE_STREAMS} streams of uint8 {HEIGHT}x{WIDTH} frames, ECO-Lite bf16, "
          f"{SEGMENTS}-frame windows; warm-up tick {walls[0]:.1f} ms; {ONLINE_TICKS} timed ticks "
          f"(ms, in order) {[round(t, 2) for t in timed]}: {windows_s:.1f} windows/s, full loop; "
          f"K1 + forward on the card (CUDA events, K1's launch to the logits on the host) "
          f"{[round(t, 3) for t in device]} ms a tick, median {statistics.median(device):.3f}; "
          f"the forward call on the host's clock {[round(t, 2) for t in call]} ms; host ms a "
          f"tick outside it (per-frame crops, windows) {[round(t, 2) for t in host]}; K1 "
          f"launches {launches[0]}; {card}")

    # the timed bf16 tick held, stream by stream, to a 64-stream f32 tick
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec32 = MultiStreamRecognizer(Program(graph, compute_dtype=torch.float32, device=dev),
                                  params, state, num_streams=ONLINE_STREAMS,
                                  num_segments=SEGMENTS, crop_size=CROP, plane="uint8",
                                  output="fc8")
    _reset_counts()
    results = _tick(rec32, pool, 0, ONLINE_STREAMS)
    k1_32 = _counts()[0]
    del rec32
    _check_tick(results, ONLINE_STREAMS, "online f32")
    first32 = np.stack([r[1] for r in results])
    rel16 = np.linalg.norm(first - first32, axis=1) / np.linalg.norm(first32, axis=1)
    # a label may change only where the f32 top-1 margin is within twice the
    # stream's largest |bf16 - f32| logit difference
    top2 = np.sort(first32, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * np.abs(first - first32).max(axis=1)
    same = (first.argmax(1) == first32.argmax(1))[clear].all()
    print(f"online bf16 tick vs a {ONLINE_STREAMS}-stream f32 tick on the card (TF32 off), "
          f"stream by stream: smoothed logits rel L2 max {rel16.max():.3e}, median "
          f"{np.median(rel16):.3e} (bound {BF16_LOGITS_REL_L2_BOUND}); labels equal on the "
          f"{int(clear.sum())} streams whose f32 margin exceeds twice their largest "
          f"difference: {same}; streams with distinct f32 logits "
          f"{len(np.unique(first32.round(4), axis=0))}")
    if not (rel16.max() <= BF16_LOGITS_REL_L2_BOUND and same and k1_32 == 1):
        raise AssertionError(f"online bf16 tick off the f32 tick: per-stream rel L2 {rel16} "
                             f"(K1 launches {k1_32})")

    qprog, qp, qs = int8_lite
    rec8 = MultiStreamRecognizer(qprog, qp, qs, num_streams=ONLINE_STREAMS,
                                 num_segments=SEGMENTS, crop_size=CROP, plane="uint8",
                                 output="fc8")
    n_q = sum(l.type.lower() in ("qconvolution", "qinnerproduct") for l in qprog.exec_layers)
    _reset_counts()
    with _k3_held() as checked:
        results = _tick(rec8, pool, 0, ONLINE_STREAMS)
    k1_8, k2_8, k3_8 = _counts()
    _check_tick(results, ONLINE_STREAMS, "online int8")
    if rec8.single.in_scale is None or (k1_8, k2_8, k3_8) != (1, 0, n_q) or len(checked) != n_q:
        raise AssertionError(f"online int8 tick: input plane scale {rec8.single.in_scale}, "
                             f"K1 {k1_8}, K2 {k2_8}, K3 {k3_8} launches, {len(checked)} held, "
                             f"{n_q} int8 layers")
    logits8 = np.stack([r[1] for r in results])
    rel8 = float(np.linalg.norm(logits8 - first) / np.linalg.norm(first))
    print(f"online int8 tick ({ONLINE_STREAMS} streams, int8 ECO-Lite, bf16 between int8 "
          f"layers): K1 (int8 out) launches {k1_8}, K3 launches {k3_8} = {n_q} int8 layers, each "
          f"equal to its plain version on the same operands; logits vs the bf16 float tick: "
          f"rel L2 {rel8:.4f} (bound {INT8_VS_FLOAT_REL_L2_BOUND['eco_lite_kinetics']})")
    if not rel8 <= INT8_VS_FLOAT_REL_L2_BOUND["eco_lite_kinetics"]:
        raise AssertionError(f"online int8 logits off the float tick's by rel L2 {rel8}")

    smoothed = []
    _reset_counts()
    for where, p, s in ((dev, params, state), ("cpu", _to(params, "cpu"), _to(state, "cpu"))):
        pair = MultiStreamRecognizer(Program(graph, compute_dtype=torch.float32, device=where),
                                     p, s, num_streams=2, num_segments=SEGMENTS,
                                     crop_size=CROP, plane="uint8", output="fc8")
        results = _tick(pair, pool, 0, 2)
        _check_tick(results, 2, f"online f32 on {where}")
        smoothed.append(np.stack([r[1] for r in results]))
    k1_pair = _counts()[0]
    rel = float(np.linalg.norm(smoothed[0] - smoothed[1]) / np.linalg.norm(smoothed[1]))
    # streams 0 and 1 of the 64-stream f32 tick saw the same frames
    rel64 = float(np.linalg.norm(first32[:2] - smoothed[1]) / np.linalg.norm(smoothed[1]))
    print(f"online f32 tick, 2 streams, card vs CPU (TF32 off): smoothed logits rel L2 "
          f"{rel:.3e}, streams 0-1 of the {ONLINE_STREAMS}-stream card tick vs CPU {rel64:.3e} "
          f"(bound {F32_CARD_VS_CPU_REL_L2_BOUND}); labels card "
          f"{smoothed[0].argmax(-1).tolist()}, CPU {smoothed[1].argmax(-1).tolist()}")
    if not max(rel, rel64) <= F32_CARD_VS_CPU_REL_L2_BOUND or k1_pair != 1:
        raise AssertionError(f"online f32 on the card off the CPU's by rel L2 {rel}, {rel64} "
                             f"(K1 launches {k1_pair})")
    return {"windows_s": windows_s, "k1": {"online": launches[0], "online_f32": k1_32,
                                           "online_int8": k1_8,
                                           "online_card_vs_cpu": k1_pair},
            "k3": {"online_int8": k3_8}}


def _frame_tree(root: str, cv2) -> str:
    """bench.py's bench_train_e2e data set: E2E_VIDEOS directories of
    E2E_FRAMES JPEG frames, 256x340, and their list file."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 200, (HEIGHT, WIDTH, 3), np.uint8)
    lines = []
    for v in range(E2E_VIDEOS):
        d = os.path.join(root, f"vid{v}")
        os.makedirs(d)
        for f in range(E2E_FRAMES):
            img = np.clip(base.astype(np.int16) + int(v * 3 + f) % 40, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, "img_%04d.jpg" % (f + 1)), img)
        lines.append(f"{d} {E2E_FRAMES} {v % 10}")
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst


def _put_times(host, dev, card: str):
    """One batch to the card, on the host's clock to the copy's end, PUT_REPS
    times in turns: ``prefetch_to_device``'s put (pin, side-stream copy),
    its two parts alone, and a pageable ``.to(device)``."""
    def pin():
        return {k: torch.from_numpy(v).pin_memory() for k, v in host.items()}

    pinned = pin()
    kinds = {"prefetch put": lambda: next(prefetch_to_device(iter([host]), 1, device=dev)),
             "pin_memory alone": pin,
             "pinned copy alone": lambda: {k: v.to(dev, non_blocking=True)
                                           for k, v in pinned.items()},
             "pageable .to(device)": lambda: {k: torch.from_numpy(v).to(dev)
                                              for k, v in host.items()}}
    times = {k: [] for k in kinds}
    for _ in range(PUT_REPS):
        for kind, fn in kinds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
    mb = sum(v.nbytes for v in host.values()) / 1e6
    print(f"train_e2e put of one batch ({mb:.1f} MB), host's clock to the copy's end, "
          f"{PUT_REPS} reps in turns: " + "; ".join(
              f"{k} {[round(t, 2) for t in v]} ms, median {statistics.median(v):.2f}"
              for k, v in times.items()) + f"; {card}")


def _micro(batch):
    return {k: v[None] for k, v in batch.items()}


def _e2e_block(prog, cfg, ts, feed, steps: int):
    """``steps`` steps of a fresh ``Trainer(metrics_lag=1)`` from ``ts`` on
    ``feed``; returns the state, the ms between the CUDA events recorded after
    consecutive steps (the first step, which builds the trainer and starts the
    feed, left out; the ``train`` phase's measure) and the losses."""
    step = make_train_step(prog, cfg)
    events = []

    def timed_step(ts, batch, generator):
        out = step(ts, batch, generator)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    trainer = Trainer(prog, dataclasses.replace(cfg, max_iter=ts.it + steps), step_fn=timed_step,
                      metrics_lag=1, log_fn=lambda _: None)
    losses = []
    ts = trainer.solve(ts, feed, hooks=[lambda it, _ts, m: losses.append(float(m["loss"]))])
    torch.cuda.synchronize()
    return ts, [a.elapsed_time(b) for a, b in zip(events, events[1:])], losses


def _ms(times) -> str:
    return f"{[round(t, 1) for t in times]} (median {statistics.median(times):.2f})"


def train_e2e(dev, card: str) -> dict:
    """The fed train path: the bf16 ECO-Lite TRAIN graph through
    ``RawPreprocessProgram`` and ``Trainer(metrics_lag=1)``, fed by
    ``VideoPipeline(raw=True)`` over a JPEG frame tree, serially and through
    ``prefetch_to_device`` at depths 1 and 2, in interleaved blocks; the feed
    alone, the steps on a resident batch beside the decoding feed and with the
    feed closed; the put of one batch, pinned and pageable; and the race
    check.  Returns K1's launches on the fed path and in the race check."""
    import cv2

    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True, batch=BATCH)
    prog = RawPreprocessProgram(
        Program(graph, train=True, compute_dtype=torch.bfloat16, device=dev), crop=CROP, mean=MEAN)
    cfg = SolverConfig(**SOLVER, display=0, snapshot=0)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dcfg = VideoDataConfig(
            source=_frame_tree(root, cv2), batch_size=BATCH, num_segments=SEGMENTS,
            new_height=HEIGHT, new_width=WIDTH, shuffle=True, raw=True,
            transform=TransformConfig(crop_size=CROP, multi_scale=False, mean_values=MEAN))
        src = VideoPipeline(dcfg, train=True, seed=SEED)
        tree_s = time.perf_counter() - t0
        try:
            first = _micro(src.next_batch())
            ts = init_train_state(*prog.init(torch.Generator().manual_seed(SEED),
                                             {k: v[0] for k, v in first.items()}))
            _reset_counts()
            ts, _, _ = _e2e_block(prog, cfg, ts, iter([first]), 1)
            times = {"serial": [], 1: [], 2: []}
            losses = []
            for _ in range(E2E_ROUNDS):
                for mode in times:
                    batches = (_micro(src.next_batch()) for _ in range(E2E_BLOCK))
                    feed = batches if mode == "serial" else prefetch_to_device(batches, mode,
                                                                               device=dev)
                    ts, ms, got = _e2e_block(prog, cfg, ts, feed, E2E_BLOCK)
                    times[mode] += ms
                    losses += got
            k1, k2, k3 = _counts()
            steps = 1 + E2E_ROUNDS * 3 * E2E_BLOCK
            if (k1, k2, k3) != (steps, 0, 0) or not all(map(math.isfinite, losses)):
                raise AssertionError(f"train_e2e: K1, K2, K3 launched {(k1, k2, k3)} times in "
                                     f"{steps} steps; losses {losses}")
            print(f"train_e2e: feed VideoPipeline(raw=True) over {E2E_VIDEOS} videos x "
                  f"{E2E_FRAMES} JPEG frames (cv2 {cv2.__version__}; tree written in "
                  f"{tree_s:.1f} s); bf16 ECO-Lite, batch {BATCH} x {SEGMENTS}, "
                  f"Trainer(metrics_lag=1); ms a step, CUDA events between steps, "
                  f"{E2E_ROUNDS} interleaved rounds of {E2E_BLOCK}-step blocks (each block's "
                  f"first step left out): serial {_ms(times['serial'])}; prefetch depth 1 "
                  f"{_ms(times[1])}; depth 2 {_ms(times[2])}; "
                  f"{BATCH / statistics.median(times[1]) * 1e3:.1f} train videos/s at depth 1; "
                  f"losses finite; K1 launches {k1}; {card}")

            # the feed alone, drained without steps past the batches its
            # queue holds (two deep)
            for _ in range(2):
                src.next_batch()
            t0 = time.perf_counter()
            for _ in range(2 * E2E_BLOCK):
                host = src.next_batch()
            drain_ms = (time.perf_counter() - t0) * 1e3 / (2 * E2E_BLOCK)
            race = [_micro(src.next_batch()) for _ in range(RACE_STEPS)]
            # steps on a batch resident on the card while another thread
            # drains the decoding feed, its batches dropped
            resident = next(prefetch_to_device(iter([_micro(host)]), 1, device=dev))
            beside_ms = []

            def drain():
                t0 = time.perf_counter()
                for _ in range(2 * E2E_BLOCK):
                    src.next_batch()
                beside_ms.append((time.perf_counter() - t0) * 1e3 / (2 * E2E_BLOCK))

            drainer = threading.Thread(target=drain)
            drainer.start()
            ts, beside, _ = _e2e_block(prog, cfg, ts, itertools.repeat(resident), E2E_BLOCK)
            drainer.join()
        finally:
            src.close()
    # the same steps with the feed closed: no decode thread left on the host
    ts, alone, _ = _e2e_block(prog, cfg, ts, itertools.repeat(resident), 2 * E2E_BLOCK)
    del resident
    print(f"train_e2e apart: the feed drained without steps {drain_ms:.2f} ms a batch "
          f"({BATCH / drain_ms * 1e3:.1f} videos/s); steps on a resident batch beside the "
          f"decoding feed {_ms(beside)} ms (the feed meanwhile {beside_ms[0]:.2f} ms a batch), "
          f"with the feed closed {_ms(alone)} ms; {card}")
    _put_times(host, dev, card)

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    _reset_counts()
    try:
        runs = {}
        for name, feed in (("serial", lambda: iter(race)), ("serial again", lambda: iter(race)),
                           ("prefetch depth 1", lambda: prefetch_to_device(iter(race), 1,
                                                                          device=dev)),
                           ("prefetch depth 2", lambda: prefetch_to_device(iter(race), 2,
                                                                          device=dev))):
            _, _, runs[name] = _e2e_block(prog, cfg, ts, feed(), RACE_STEPS)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    race_k1 = _counts()[0]
    print(f"train_e2e race check, {RACE_STEPS} steps from one saved state on the same batches, "
          f"cudnn.deterministic: " + "; ".join(f"{k} {v}" for k, v in runs.items()))
    if len({tuple(v) for v in runs.values()}) != 1 or race_k1 != len(runs) * RACE_STEPS:
        raise AssertionError(f"train_e2e: the losses differ between the runs {runs} "
                             f"(K1 launches {race_k1})")
    return {"train_e2e": k1, "train_e2e_race": race_k1}


def check_resize(dev, card: str) -> dict:
    """The multi-scale plane's crop and resize at the train shape, f32 out:
    per-video sampled windows (the scale ratios of 256 the pipeline picks),
    card against CPU; a full-size window against K1's f32 crop, which it
    must equal; and its time beside its bound."""
    gen = torch.Generator().manual_seed(SEED + 8)
    frames = torch.randint(0, 256, (BATCH, SEGMENTS, HEIGHT, WIDTH, 3), dtype=torch.uint8,
                           generator=gen)
    sizes = torch.tensor([256, 224, 192, 168])
    crop_h = sizes[torch.randint(0, 4, (BATCH,), generator=gen)]
    crop_w = sizes[torch.randint(0, 4, (BATCH,), generator=gen)]
    aug = (torch.randint(0, 2**20, (BATCH,), generator=gen) % (HEIGHT - crop_h + 1),
           torch.randint(0, 2**20, (BATCH,), generator=gen) % (WIDTH - crop_w + 1),
           crop_h, crop_w, torch.randint(0, 2, (BATCH,), generator=gen).bool())
    kw = dict(crop=CROP, mean=MEAN, out_dtype=torch.float32)
    card_frames = frames.to(dev)
    card_aug = [t.to(dev) for t in aug]
    got = resize.preprocess_resize_on_device(card_frames, *card_aug, **kw)
    want = resize.preprocess_resize_on_device(frames, *aug, **kw)
    err = (got.cpu() - want).abs().max().item()
    h_off, w_off = (torch.randint(0, size - CROP + 1, (BATCH,), generator=gen).to(dev)
                    for size in (HEIGHT, WIDTH))
    full = torch.full((BATCH,), CROP, device=dev)
    exact = torch.equal(
        resize.preprocess_resize_on_device(card_frames, h_off, w_off, full, full, card_aug[4],
                                           **kw),
        preprocess.preprocess_on_device(card_frames, h_off, w_off, card_aug[4], **kw))
    call = lambda: resize.preprocess_resize_on_device(card_frames, *card_aug, **kw)
    ms = (_ms_per_call(call, RESIZE_ITERS) + _ms_per_call(call, RESIZE_ITERS)) / 2
    ops = (2 * BATCH * CROP * HEIGHT * SEGMENTS * WIDTH * 3
           + 2 * BATCH * CROP * WIDTH * CROP * SEGMENTS * 3)
    bound, by = _bound_ms(frames.numel() + got.numel() * 4, ops, F32_OPS_PER_S)
    print(f"resize (ops/resize.py, two batched f32 products) {tuple(frames.shape)} -> {CROP}, "
          f"windows h {crop_h.tolist()} w {crop_w.tolist()}: card vs CPU max |diff| {err:.3e} "
          f"(bound {RESIZE_CARD_VS_CPU_BOUND}); at a full-size window equal to K1's f32 crop: "
          f"{exact}; {ms:.4f} ms a call (CUDA events, {RESIZE_ITERS} calls a block, two "
          f"blocks), bound {bound:.4f} ms ({by}: {ops / 1e9:.1f} GFLOP at 67 TFLOP/s f32), "
          f"{bound / ms:.1%} of it; {card}")
    if not (err <= RESIZE_CARD_VS_CPU_BOUND and exact):
        raise AssertionError(f"resize: card vs CPU {err}, equal to K1 at a full window {exact}")
    return {"max_abs_err": err, "ms": ms, "bound_ms": bound}


@contextlib.contextmanager
def _cudnn_flags(**flags):
    """``torch.backends.cudnn`` flags set inside (a decorator too), and put
    back after."""
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


@_cudnn_flags(deterministic=True, benchmark=False)
def remat_phase(dev, card: str) -> dict:
    """One bf16 train step of ECO-Lite and of ECO-Full at batch 8 through the
    raw plane from one state, with each remat policy, under
    ``cudnn.deterministic``: losses and updated params must be equal; peak
    memory and step times printed.  Returns K1's launches and the figures."""
    out = {"k1": 0}
    for model in ("eco_lite_kinetics", "eco_full_kinetics"):
        graph = get_model(model, num_segments=SEGMENTS, crop_size=CROP, with_loss=True,
                          batch=BATCH)
        prog = RawPreprocessProgram(
            Program(graph, train=True, compute_dtype=torch.bfloat16, device=dev),
            crop=CROP, mean=MEAN)
        batch = _train_batch(SEED + 2)
        ts = init_train_state(*prog.init(torch.Generator().manual_seed(SEED),
                                         {k: v[0] for k, v in batch.items()}))
        _reset_counts()
        rows = memreport.policy_rows(prog, SolverConfig(**SOLVER), ts, batch,
                                     REMAT_POLICIES, steps=REMAT_STEPS)
        k1, k2, k3 = _counts()
        del ts
        plain = rows[0]
        for row in rows:
            same = torch.equal(row["loss"], plain["loss"]) and all(
                torch.equal(v, plain["params"][ln][k])
                for ln, lp in row["params"].items() for k, v in lp.items())
            print(f"remat {model} bf16, batch {BATCH}, policy {row['policy']}: loss "
                  f"{float(row['loss']):.6f}, loss and updated params equal to the plain "
                  f"step's: {same}; peak memory {row['peak_bytes'] / 2**30:.3f} GiB "
                  f"({row['peak_bytes'] / plain['peak_bytes']:.1%} of the plain step's), "
                  f"{row['peak_above_start_bytes'] / 2**30:.3f} GiB above the state and "
                  f"batch; step {row['step_ms']:.2f} ms (CUDA events over {REMAT_STEPS} "
                  f"steps, cudnn.deterministic); {card}")
            if not same:
                raise AssertionError(f"remat {model} {row['policy']}: the step differs")
        steps = len(rows) * (1 + REMAT_STEPS)
        if (k1, k2, k3) != (steps, 0, 0):
            raise AssertionError(f"remat {model}: K1, K2, K3 launched {(k1, k2, k3)} times "
                                 f"in {steps} steps")
        share = rows[1]["peak_bytes"] / plain["peak_bytes"]
        if model == "eco_lite_kinetics" and not share <= REMAT_PEAK_SHARE:
            raise AssertionError(f"remat: ECO-Lite's dots peak is {share:.1%} of the plain "
                                 f"step's (at most {REMAT_PEAK_SHARE:.0%})")
        out["k1"] += k1
        out[model] = {r["policy"]: {"peak_gib": r["peak_bytes"] / 2**30,
                                    "step_ms": r["step_ms"]} for r in rows}
        del rows, plain
    return out


@contextlib.contextmanager
def _captured(echo: bool = True):
    """The block's standard output, kept, then printed after it if ``echo``
    (and always if the block fails)."""
    buf = io.StringIO()
    failed = True
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
        failed = False
    finally:
        if echo or failed:
            print(buf.getvalue(), end="")


def _slowest(rows, n=10):
    key = (lambda r: r[2] + r[3]) if len(rows[0]) == 4 else (lambda r: r[2])
    return [[r[0], r[1], *[round(x, 4) for x in r[2:]]]
            for r in sorted(rows, key=key, reverse=True)[:n]]


@_cudnn_flags(benchmark=False)  # a CLI user's default; earlier phases turned it on
def cli_phase(card: str, tables=None) -> dict:
    """The port's CLI in this process, as a user drives it: ``device-query``;
    ``train`` of the zoo's ECO-Lite TRAIN graph (written as ``graph.json``
    with ``mem_param { optimize_train: true }``) from a solver file on the
    raw plane over a JPEG tree, the zoo's multi-scale default on; ``test``
    of the snapshot (K1); ``time --bf16`` and ``time --backward``;
    ``quantize`` and ``test`` of the int8 graph, every K3 call held to its
    plain version.  Returns K1's and K3's launches."""
    def run(*argv):
        return cli.main([str(a) for a in argv])

    import cv2

    data = ["--batch", BATCH, "--segments", SEGMENTS]
    with _captured() as out:
        run("device-query")
    if torch.cuda.get_device_name(0) not in out.getvalue():
        raise AssertionError(f"device-query printed {out.getvalue()!r}")
    with tempfile.TemporaryDirectory() as root:
        lst = _frame_tree(root, cv2)
        graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True,
                               batch=BATCH)
        graph.options["mem_param"] = {"optimize_train": True}
        net, solver = os.path.join(root, "graph.json"), os.path.join(root, "solver.prototxt")
        with open(net, "w") as f:
            f.write(graph_to_json(graph))
        with open(solver, "w") as f:
            f.write(CLI_SOLVER.format(prefix=os.path.join(root, "eco")))

        policies, scaled = [], []
        run_with_remat, clips = memory.run_with_remat, serving.RawPreprocessProgram._clips

        def remat_seen(steps, blobs, keep, policy, run_):
            policies.append(policy)
            return run_with_remat(steps, blobs, keep, policy, run_)

        def clips_seen(self, inputs):
            if self.train:
                scaled.append("crop_h" in inputs)
            return clips(self, inputs)

        memory.run_with_remat, serving.RawPreprocessProgram._clips = remat_seen, clips_seen
        _reset_counts()
        t0 = time.perf_counter()
        try:
            with _captured() as out:
                ts = run("train", "--solver", solver, "--net", net, "--list", lst, *data,
                         "--pipeline", "raw")
        finally:
            memory.run_with_remat, serving.RawPreprocessProgram._clips = run_with_remat, clips
        train_s = time.perf_counter() - t0
        k1_train = _counts()[0]
        log = out.getvalue()
        losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+) ", log)]
        step_s = [float(v) for v in re.findall(r", ([0-9.]+)s\)", log)]
        snap = os.path.join(root, "eco_iter_4.model.npz")
        print(f"cli train: {ts.it} iterations of ECO-Lite f32, batch {BATCH} x {SEGMENTS}, raw "
              f"plane, multi-scale windows in {sum(scaled)} of {len(scaled)} batches, remat "
              f"{sorted(set(map(str, policies)))} in {len(policies)} steps; losses {losses}; "
              f"the Trainer's display intervals (host's clock) {step_s} s; {train_s:.1f} s with "
              f"set-up and the snapshot; K1 launches {k1_train}; {card}")
        if not (ts.it == 4 and len(losses) == 4 and all(map(math.isfinite, losses))
                and policies == ["dots"] * 4 and scaled == [True] * 4 and k1_train == 0
                and os.path.exists(snap)):
            raise AssertionError("cli train: not the run asked for")

        _reset_counts()
        means = run("test", "--net", net, "--weights", snap, "--list", lst, *data,
                    "--pipeline", "raw", "--iterations", CLI_TEST_ITERATIONS)
        k1_test, k2_test, k3_test = _counts()
        if (k1_test, k2_test, k3_test) != (CLI_TEST_ITERATIONS, 0, 0) or not all(
                map(math.isfinite, means.values())):
            raise AssertionError(f"cli test: {means}, K1, K2, K3 "
                                 f"{(k1_test, k2_test, k3_test)}")

        times = {}
        for name, flags in (("bf16", ["--bf16"]), ("backward", ["--backward"])):
            with _captured(echo=False) as out:
                rows = run("time", "--zoo", "eco_lite_kinetics", *data, "--iters",
                           CLI_TIME_ITERS, *flags)
            if tables:
                os.makedirs(tables, exist_ok=True)
                with open(os.path.join(tables, f"cli_time_{name}.txt"), "w") as f:
                    f.write(f"{card}\n{out.getvalue()}")
            totals = [round(sum(r[i] for r in rows if math.isfinite(r[i])), 3)
                      for i in range(2, len(rows[0]))]
            times[name] = {"totals_ms": totals, "slowest": _slowest(rows)}
            print(f"cli time --{name}: {len(rows)} layers, totals (fwd[, bwd]) {totals} ms, "
                  f"every row above a floor; ten slowest {times[name]['slowest']}; {card}")

        int8 = os.path.join(root, "int8")
        with _captured() as out:
            run("quantize", "--net", net, "--weights", snap, "--list", lst, *data,
                "--calib-batches", CLI_CALIB_BATCHES, "-o", int8)
        qgraph = json.load(open(int8 + ".graph.json"))
        n_q = sum(l["type"] in ("qconvolution", "qinnerproduct") for l in qgraph["layers"])
        _reset_counts()
        with _k3_held() as checked:
            means8 = run("test", "--net", int8 + ".graph.json", "--weights", int8 + ".npz",
                         "--list", lst, *data, "--pipeline", "raw", "--iterations",
                         CLI_TEST_ITERATIONS)
        k1_8, k2_8, k3_8 = _counts()
        print(f"cli quantize + int8 test: {n_q} int8 layers; {CLI_TEST_ITERATIONS} batches, "
              f"{means8}; K1 launches {k1_8}, K3 launches {k3_8}, each equal to its plain "
              f"version ({len(checked)} held); float test {means}")
        if not (n_q and (k1_8, k2_8, k3_8) == (CLI_TEST_ITERATIONS, 0, n_q * CLI_TEST_ITERATIONS)
                and len(checked) == k3_8 and all(map(math.isfinite, means8.values()))):
            raise AssertionError(f"cli int8 test: K1, K2, K3 {(k1_8, k2_8, k3_8)}, "
                                 f"{len(checked)} held, {n_q} int8 layers")
    print(json.dumps({"cli": {"train_losses": losses, "remat": "dots",
                              "display_intervals_s": step_s, "train_s": train_s,
                              "test": means, "int8_test": means8, "int8_layers": n_q,
                              "time": times, "card": card}}))
    return {"k1": {"cli_test": k1_test, "cli_test_int8": k1_8},
            "k3": {"cli_test_int8": k3_8}}


# -- phase tail ---------------------------------------------------------------

# The 35 layer types ported last, each once on the card against the CPU at
# ECO-Lite Kinetics' full widths at batch 8 x 16 segments: 2D layers on
# pool2's output, 3D layers on the 3D head's input, losses on the logits
TAIL_2D, TAIL_3D = (BATCH * SEGMENTS, 28, 28, 192), (BATCH, SEGMENTS, 28, 28, 96)
TAIL_ROIS, TAIL_FILTER_CAPACITY, TAIL_ITERS = 256, 8, 5
# Relative L2 of each value, card (f32, TF32 off) against CPU, by what the
# layer computes: 0 is torch.equal (layers that move or select values);
# pointwise maths take libm functions of other precision; sums and the
# deconvolutions' products add in other orders.  Gradients (of the layers
# with params, and of the losses) are held to TAIL_GRAD_BOUND.
TAIL_POINTWISE_BOUND, TAIL_SUM_BOUND, TAIL_GRAD_BOUND = 1e-6, 1e-5, 1e-4
# One f32 CaffeNet step, card (TF32 off) against CPU: relative L2 of the
# parameter updates; no BN here, so only the sums' order differs
CAFFENET_F32_UPDATE_REL_L2_BOUND = 1e-3


def check_k1_caffenet(dev, card: str) -> dict:
    """K1 at CaffeNet's input, (32, 1, 256, 256, 3) -> 227 (a prime crop: the
    rows split 57/57/57/56; 681 values a row), random in-range offsets and
    mirrors, against its plain version in bf16, f32 and int8 (torch.equal,
    device and host offsets), then timed as device time in CUDA graphs
    beside its bound."""
    n, size, crop = CAFFENET_BATCH, CAFFENET_SIZE, CAFFENET_CROP
    gen = torch.Generator(device=dev).manual_seed(SEED + 227)
    frames = torch.randint(0, 256, (n, 1, size, size, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    h_off = torch.randint(0, size - crop + 1, (n,), device=dev, generator=gen)
    w_off = torch.randint(0, size - crop + 1, (n,), device=dev, generator=gen)
    mirror = torch.randint(0, 2, (n,), device=dev, generator=gen).bool()
    host = (h_off.cpu(), w_off.cpu(), mirror.cpu())
    packed = preprocess._pack_aug(h_off.int(), w_off.int(), mirror.int(), n, dev)
    ms, bound = {}, {}
    for name, (dtype, act_scale) in K1_TYPES.items():
        kw = dict(crop=crop, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
        want = preprocess.crop_normalize_reference(frames, h_off, w_off, mirror, **kw)
        for where, offsets in (("device", (h_off, w_off, mirror)), ("host", host)):
            got = preprocess.preprocess_on_device(frames, *offsets, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K1 at crop {crop} disagrees with its plain version in "
                                     f"{name}, {where} offsets")
        out = torch.empty_like(want)
        kernel = lambda: _k1_call(preprocess._kernel(), frames, packed, out, act_scale, False)
        ms[name] = (_graph_ms(kernel, K1_ITERS) + _graph_ms(kernel, K1_ITERS)) / 2
        bound[name], _ = _bound_ms(n * crop * crop * 3 + n * crop * crop * 3 * out.element_size())
        print(f"K1 {name:4s} at ({n}, 1, {size}, {size}, 3) -> {crop}: equal to its plain "
              f"version (device and host offsets); device time {ms[name]:.4f} ms (CUDA graphs), "
              f"bound {bound[name]:.4f} ms, {bound[name] / ms[name]:.1%} of it; {card}")
    return {"ms_by_dtype_crop227": ms, "bound_ms_by_dtype_crop227": bound}


def _tail_inputs():
    """The tail cases' inputs, on the CPU, from the seed."""
    gen = torch.Generator().manual_seed(SEED + 9)
    x2 = torch.randn(TAIL_2D, generator=gen)
    logits = torch.randn((BATCH, NUM_CLASSES), generator=gen) * 2
    x1 = torch.randint(0, CROP - 32, (TAIL_ROIS,), generator=gen)
    y1 = torch.randint(0, CROP - 32, (TAIL_ROIS,), generator=gen)
    rois = torch.stack([
        torch.randint(0, TAIL_2D[0], (TAIL_ROIS,), generator=gen), x1, y1,
        (x1 + torch.randint(8, 128, (TAIL_ROIS,), generator=gen)).clamp(max=CROP - 1),
        (y1 + torch.randint(8, 128, (TAIL_ROIS,), generator=gen)).clamp(max=CROP - 1),
    ], dim=1).float()
    return {
        "x2": x2, "x3": torch.randn(TAIL_3D, generator=gen), "pos": x2.abs() + 0.5,
        "b": torch.randn(TAIL_2D[0], generator=gen), "rois": rois,
        "sel": (torch.rand(TAIL_2D[0], generator=gen) < 0.05).float(),
        "logits": logits, "label": torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen),
        "probs": torch.softmax(logits, -1), "target": torch.randn(logits.shape, generator=gen),
        "binary": (torch.rand(logits.shape, generator=gen) > 0.5).float(),
        "H": torch.rand((NUM_CLASSES, NUM_CLASSES), generator=gen),
        "sim": torch.randint(0, 2, (BATCH,), generator=gen).float(),
        "weight": torch.rand(logits.shape, generator=gen),
    }


def _tail_cases():
    """name -> (type, options, bottoms, tops, train, the bottoms to
    differentiate, bound).  The gradients of every case with params or a
    loss are checked."""
    eq, pw, sm = 0.0, TAIL_POINTWISE_BOUND, TAIL_SUM_BOUND
    gauss = {"type": "gaussian", "std": 0.5}
    one = ("y",)
    loss2 = lambda t, **o: (t, o, ("logits", "target"), one, False, ("logits", "target"), sm)
    return {
        "deconvolution": ("deconvolution", dict(num_output=96, kernel_size=4, stride=2, pad=1,
                                                bias_filler=gauss), ("x2",), one, False,
                          ("x2",), sm),
        "deconvolution_group2": ("deconvolution", dict(num_output=96, kernel_size=4, stride=2,
                                                       pad=1, group=2), ("x2",), one, False,
                                 ("x2",), sm),
        "deconvolution_3d": ("deconvolution", dict(num_output=48, kernel_size=[3, 4, 4],
                                                   stride=[1, 2, 2], pad=[1, 1, 1]),
                             ("x3",), one, False, ("x3",), sm),
        "permute_3d": ("permute", dict(order=[0, 2, 1, 3, 4]), ("x3",), one, False, (), eq),
        "power": ("power", dict(power=2.0, scale=0.5, shift=1.5), ("x2",), one, False, (), pw),
        "silence": ("silence", {}, ("x2",), (), False, (), eq),
        "bias": ("bias", dict(filler=gauss), ("x2",), one, False, ("x2",), pw),
        "bias_two_bottoms": ("bias", dict(axis=0), ("x2", "b"), one, False, ("x2", "b"), pw),
        "gather": ("gather", {}, ("x2",), one, False, (), eq),
        "scatter": ("scatter", {}, ("x2",), one, False, (), eq),
        "sigmoid": ("sigmoid", {}, ("x2",), one, False, (), pw),
        "tanh": ("tanh", {}, ("x2",), one, False, (), pw),
        "absval": ("absval", {}, ("x2",), one, False, (), eq),
        "exp": ("exp", dict(scale=0.5), ("x2",), one, False, (), pw),
        "log": ("log", {}, ("pos",), one, False, (), pw),
        "bnll": ("bnll", {}, ("x2",), one, False, (), pw),
        "threshold": ("threshold", dict(threshold=0.1), ("x2",), one, False, (), eq),
        "argmax": ("argmax", {}, ("x2",), one, False, (), eq),
        "lrn": ("lrn", dict(local_size=5, alpha=1e-4, beta=0.75), ("x2",), one, False, (), pw),
        "mvn": ("mvn", {}, ("x2",), one, False, (), sm),
        "prelu": ("prelu", {}, ("x2",), one, False, ("x2",), pw),
        "batchnorm_train": ("batchnorm", {}, ("x2",), one, True, ("x2",), sm),
        "batchnorm_train_3d": ("batchnorm", {}, ("x3",), one, True, ("x3",), sm),
        "euclideanloss": loss2("euclideanloss"),
        "hingeloss": ("hingeloss", {}, ("logits", "label"), one, False, ("logits",), sm),
        "sigmoidcrossentropyloss": ("sigmoidcrossentropyloss", {}, ("logits", "binary"), one,
                                    False, ("logits",), sm),
        "infogainloss": ("infogainloss", {}, ("probs", "label", "H"), one, False,
                         ("probs", "H"), sm),
        "contrastiveloss": ("contrastiveloss", dict(margin=20.0),
                            ("logits", "target", "sim"), one, False, ("logits", "target"), sm),
        "multinomiallogisticloss": ("multinomiallogisticloss", {}, ("probs", "label"), one,
                                    False, ("probs",), sm),
        "smoothl1loss": ("smoothl1loss", {}, ("logits", "target", "weight"), one, False,
                         ("logits", "target"), sm),
        "spp": ("spp", dict(pyramid_height=3), ("x2",), one, False, (), eq),
        "roipooling": ("roipooling", dict(pooled_h=7, pooled_w=7, spatial_scale=1 / 8),
                       ("x2", "rois"), one, False, (), eq),
        "filter": ("filter", dict(capacity=TAIL_FILTER_CAPACITY), ("x2", "sel"),
                   ("y", "valid"), False, (), eq),
        "im2col": ("im2col", dict(kernel_size=3, pad=1), ("x2",), one, False, (), eq),
        "reduction": ("reduction", dict(operation="mean", axis=1), ("x2",), one, False, (), sm),
        "normalize": ("normalize", {}, ("x2",), one, False, (), sm),
        "batchreduction": ("batchreduction", dict(reduction_param={"operation": "topk",
                                                                   "axis": 2, "k": 3}),
                           ("x2",), one, False, (), sm),
        "dummydata": ("dummydata", dict(shape=[{"dim": [TAIL_2D[0], TAIL_2D[3], 28, 28]}],
                                        data_filler={"type": "constant", "value": 0.5}),
                      (), one, False, (), eq),
        "hdf5output": ("hdf5output", {}, ("x2", "logits"), (), False, (), eq),
    }


def _tail_run(graph, train, params, state, inputs, wrt, cots, dev):
    """One case on ``dev``, on copies of the CPU's params and inputs: the
    outputs, the new state, and (with ``cots``) the gradients of sum(out *
    cot) by the params ("layer/name") and the ``wrt`` inputs."""
    grad = bool(cots)
    p = {ln: {k: v.detach().to(dev, copy=True).requires_grad_(grad) for k, v in lp.items()}
         for ln, lp in params.items()}
    xs = {k: v.detach().to(dev, copy=True).requires_grad_(grad and k in wrt)
          for k, v in inputs.items()}
    with torch.set_grad_enabled(grad):
        outs, new_state = Program(graph, train=train, device=dev).apply(p, _to(state, dev), xs)
    grads = {}
    if grad:
        leaves = {f"{ln}/{k}": v for ln, lp in p.items() for k, v in lp.items()}
        leaves.update({k: xs[k] for k in wrt})
        total = sum((outs[k].float() * c.to(dev)).sum() for k, c in cots.items())
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    return outs, new_state, grads


def _tail_ms(graph, train, params, state, inputs, wrt, cots, dev):
    """The case's forward on the card, and its forward and backward, in ms a
    call (CUDA events; the Program's host work included)."""
    prog = Program(graph, train=train, device=dev)
    p, s = _to(params, dev), _to(state, dev)
    xs = {k: v.to(dev) for k, v in inputs.items()}

    def fwd():
        with torch.no_grad():
            return prog.apply(p, s, xs)

    fwd_ms = _ms_per_call(fwd, TAIL_ITERS)
    if not cots:
        return fwd_ms, None
    leaves = [v.requires_grad_() for lp in p.values() for v in lp.values()]
    leaves += [xs[k].requires_grad_() for k in wrt]
    cots = {k: c.to(dev) for k, c in cots.items()}

    def fwd_bwd():
        outs, _ = prog.apply(p, s, xs)
        return torch.autograd.grad(sum((outs[k].float() * c).sum() for k, c in cots.items()),
                                   leaves)

    return fwd_ms, _ms_per_call(fwd_bwd, TAIL_ITERS) - fwd_ms


def _held(what: str, got, want, bound: float) -> float:
    """``got`` (the card's) against ``want`` (the CPU's): equal where the
    bound is 0, else within the bound in relative L2; returns the error."""
    got = got.detach().cpu()
    want = want.detach()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} on the card, "
                             f"{want.dtype} {tuple(want.shape)} on the CPU")
    if bound == 0.0:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the card's differs from the CPU's in "
                                 f"{int((got != want).sum())} values")
        return 0.0
    err = ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()
    if not err <= bound:
        raise AssertionError(f"{what}: card vs CPU relative L2 {err:.3e} above {bound}")
    return err


@_cudnn_flags(allow_tf32=False)
def tail_layers(dev, card: str) -> dict:
    """Every one of the 35 layer types on the card against the same layer on
    the CPU (forward, and backward where it has params or is a loss), then
    the 2D set once in bf16 (finite), and each case timed on the card by
    the profiler (forward, and backward where checked)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _tail_inputs()
    found, times, t0 = {}, [], time.perf_counter()
    for i, (name, (ltype, opts, bottoms, tops, train, wrt, bound)) in enumerate(
            _tail_cases().items()):
        ins = {k: inputs[k] for k in bottoms}
        graph = GraphSpec(name, {k: tuple(v.shape) for k, v in ins.items()},
                          [LayerSpec(name, ltype, tuple(bottoms), tuple(tops), opts)])
        params, state = Program(graph, train=train, device="cpu").init(
            torch.Generator().manual_seed(SEED + i), {k: v.shape for k, v in ins.items()})
        card_outs, card_state, _ = _tail_run(graph, train, params, state, ins, wrt, {}, dev)
        cpu_outs, cpu_state, _ = _tail_run(graph, train, params, state, ins, wrt, {}, "cpu")
        if set(card_outs) != set(cpu_outs) or set(card_outs) != set(tops):
            raise AssertionError(f"{name}: tops {sorted(card_outs)} on the card, "
                                 f"{sorted(cpu_outs)} on the CPU")
        errs = [_held(f"{name} {k}", card_outs[k], cpu_outs[k], bound) for k in tops]
        errs += [_held(f"{name} state {ln}/{k}", card_state[ln][k], cpu_state[ln][k],
                       TAIL_SUM_BOUND) for ln in cpu_state for k in cpu_state[ln]]
        grad_err, cots = None, {}
        if params or wrt:
            gen = torch.Generator().manual_seed(SEED + 100 + i)
            cots = {k: torch.randn(cpu_outs[k].shape, generator=gen) for k in tops}
            _, _, card_g = _tail_run(graph, train, params, state, ins, wrt, cots, dev)
            _, _, cpu_g = _tail_run(graph, train, params, state, ins, wrt, cots, "cpu")
            grad_err = max(_held(f"{name} gradient {k}", card_g[k], cpu_g[k], TAIL_GRAD_BOUND)
                           for k in cpu_g)
            del card_g, cpu_g
        fwd_ms, bwd_ms = _tail_ms(graph, train, params, state, ins, wrt, cots, dev)
        times.append((name, fwd_ms, bwd_ms))
        found[name] = {"type": ltype, "bound": bound, "max_rel_l2": max(errs, default=0.0),
                       "grad_rel_l2": grad_err, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
        print(f"tail {name}: card vs CPU {'equal' if bound == 0 else 'rel L2 %.3e (bound %g)' % (max(errs, default=0.0), bound)}"
              + (f", gradients rel L2 {grad_err:.3e} (bound {TAIL_GRAD_BOUND})"
                 if grad_err is not None else "")
              + f"; card forward {fwd_ms:.4f} ms" + (f", backward {bwd_ms:.4f} ms"
                                                     if bwd_ms is not None else ""))
        del card_outs, cpu_outs
    types = {f["type"] for f in found.values()}
    if len(types) != 35:
        raise AssertionError(f"tail checked {len(types)} layer types, not 35")
    # the 2D set once in bf16: finite
    x2 = inputs["x2"].to(dev)
    bf16 = []
    for i, (name, (ltype, opts, bottoms, tops, train, _, _)) in enumerate(_tail_cases().items()):
        if not bottoms or bottoms[0] != "x2" or not tops:
            continue
        ins = {k: (x2 if k == "x2" else inputs[k].to(dev)) for k in bottoms}
        graph = GraphSpec(name, {k: tuple(v.shape) for k, v in ins.items()},
                          [LayerSpec(name, ltype, tuple(bottoms), tuple(tops), opts)])
        prog = Program(graph, train=train, compute_dtype=torch.bfloat16, device=dev)
        params, state = prog.init(torch.Generator().manual_seed(SEED + i),
                                  {k: v.shape for k, v in ins.items()})
        with torch.no_grad():
            outs, _ = prog.apply(params, state, ins)
        for k, v in outs.items():
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"tail {name} bf16: non-finite {k}")
        bf16.append(name)
    slowest = sorted(times, key=lambda t: t[1] + (t[2] or 0.0), reverse=True)[:8]
    print(f"tail: {len(found)} cases of {len(types)} layer types, card vs CPU within their "
          f"bounds; bf16 finite in {len(bf16)} 2D cases; slowest on the card (fwd, bwd ms) "
          f"{[(n, round(f, 4), None if b is None else round(b, 4)) for n, f, b in slowest]}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    return {"layers": found, "bf16_finite": bf16,
            "slowest": [[n, f, b] for n, f, b in slowest]}


def _caffenet_batch(seed: int, images: int = CAFFENET_BATCH):
    """One micro-batch of one-frame videos in pinned host memory, with a
    leading micro-batch axis of 1: uint8 256x256 images, random in-range
    227 offsets, mirrors and labels."""
    gen = torch.Generator().manual_seed(seed)
    size, crop = CAFFENET_SIZE, CAFFENET_CROP
    batch = {
        "data": torch.randint(0, 256, (1, images, 1, size, size, 3), dtype=torch.uint8,
                              generator=gen),
        "h_off": torch.randint(0, size - crop + 1, (1, images), generator=gen),
        "w_off": torch.randint(0, size - crop + 1, (1, images), generator=gen),
        "mirror": torch.randint(0, 2, (1, images), generator=gen).bool(),
        "label": torch.randint(0, CAFFENET_CLASSES, (1, images), generator=gen),
    }
    return {k: v.pin_memory() for k, v in batch.items()}


def caffenet_train(dev, card: str) -> dict:
    """Full-width CaffeNet from uint8 images through K1: a warm-up step and
    ten timed bf16 train steps (the published solver), the test pass of two
    batches, and one f32 step card against CPU."""
    t0 = time.perf_counter()
    net = dict(crop=CAFFENET_CROP, widths=CAFFENET_WIDTHS, classes=CAFFENET_CLASSES)
    graph = graph_from_prototxt(caffenet_prototxt(CAFFENET_BATCH, **net))
    crop = CAFFENET_CROP
    train_prog = RawPreprocessProgram(
        Program(graph, train=True, compute_dtype=torch.bfloat16, device=dev), crop=crop,
        mean=MEAN)
    test_prog = RawPreprocessProgram(
        Program(graph, compute_dtype=torch.bfloat16, device=dev), crop=crop, mean=MEAN)
    cfg = SolverConfig(**CAFFENET_SOLVER, max_iter=1 + CAFFENET_STEPS, display=0, snapshot=0)
    step = make_train_step(train_prog, cfg)
    events = []

    def timed_step(ts, batch, generator):
        out = step(ts, batch, generator)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    trainer = Trainer(train_prog, cfg, test_program=test_prog, step_fn=timed_step,
                      log_fn=print, metrics_lag=1)
    batch = _caffenet_batch(SEED + 11)
    ts = trainer.init_state({k: v[0] for k, v in batch.items()}, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for lp in ts.params.values() for v in lp.values())
    setup_s = time.perf_counter() - t0
    seen = []
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    ts = trainer.solve(ts, itertools.repeat(batch), hooks=[
        lambda it, _ts, m: seen.append((it, float(m["loss"])))])
    k1_train, k2, k3 = _counts()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [l for _, l in seen]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"caffenet: {n_params} params, set-up {setup_s:.1f} s; {len(seen)} bf16 steps of "
          f"{CAFFENET_BATCH} images (one repeated batch), SGD lr {CAFFENET_SOLVER['base_lr']}, "
          f"momentum {CAFFENET_SOLVER['momentum']}; losses {[round(l, 4) for l in losses]}")
    print(f"caffenet: timed steps (ms, in order) {[round(t, 3) for t in per_step]}, median "
          f"{statistics.median(per_step):.3f} ms, "
          f"{CAFFENET_STEPS * CAFFENET_BATCH / (sum(per_step) / 1e3):.1f} images/s bf16; "
          f"peak memory {peak:.2f} GiB; K1 launches {k1_train}, K2 {k2}, K3 {k3}; {card}")
    if [it for it, _ in seen] != list(range(1 + CAFFENET_STEPS)):
        raise AssertionError(f"caffenet steps seen {[it for it, _ in seen]}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError("caffenet: non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"caffenet: loss did not fall: {losses[0]} -> {losses[-1]}")
    if (k1_train, k2, k3) != (1 + CAFFENET_STEPS, 0, 0):
        raise AssertionError(f"caffenet training launched K1 {k1_train}, K2 {k2}, K3 {k3} times")

    test_batches = [{k: v[0] for k, v in b.items()}
                    for b in (batch, _caffenet_batch(SEED + 12))]
    _reset_counts()
    means = trainer.test(ts, test_batches)
    k1_test = _counts()[0]
    if k1_test != len(test_batches) or not all(map(math.isfinite, means.values())):
        raise AssertionError(f"caffenet test: {means}, K1 launches {k1_test}")
    del trainer, ts, train_prog, test_prog

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = CAFFENET_F32_VIDEOS
    g32 = graph_from_prototxt(caffenet_prototxt(images, **net, dropout=0.0))
    params, state = Program(g32, train=True, device="cpu").init(
        torch.Generator().manual_seed(SEED), {"data": (images, crop, crop, 3), "label": (images,)})
    micro = {k: v[:, :images] for k, v in batch.items()}
    updates, notes = [], []
    for where in ("cpu", dev):
        t1 = time.perf_counter()
        p, s = _to(params, where), _to(state, where)
        prog = RawPreprocessProgram(Program(g32, train=True, device=where), crop=crop, mean=MEAN)
        ts32, m = make_train_step(prog, SolverConfig(**CAFFENET_SOLVER))(
            init_train_state(p, s), micro)
        updates.append(torch.cat([(ts32.params[ln][k] - p[ln][k]).flatten().cpu()
                                  for ln in sorted(p) for k in sorted(p[ln])]))
        notes.append(f"{where}: loss {float(m['loss']):.6f}, {time.perf_counter() - t1:.1f} s")
    rel = ((updates[1] - updates[0]).norm() / updates[0].norm()).item()
    print(f"caffenet f32 step card vs CPU, {images} images, TF32 off, dropout 0: update rel L2 "
          f"{rel:.3e} (bound {CAFFENET_F32_UPDATE_REL_L2_BOUND}); " + "; ".join(notes))
    if not rel <= CAFFENET_F32_UPDATE_REL_L2_BOUND:
        raise AssertionError(f"caffenet f32 update on the card off the CPU's by {rel}")
    return {"params": n_params, "losses": losses, "step_ms": per_step,
            "median_step_ms": statistics.median(per_step), "peak_gib": peak, "test": means,
            "f32_update_rel_l2": rel, "k1": {"caffenet_train": k1_train,
                                             "caffenet_test": k1_test}}


@_cudnn_flags(benchmark=False)
def caffenet_cli_time(card: str, tables=None) -> dict:
    """The CLI's ``time --bf16`` on CaffeNet's deploy form: the per-layer
    table (LRN among its rows)."""
    with tempfile.TemporaryDirectory() as root:
        net = os.path.join(root, "caffenet_deploy.prototxt")
        with open(net, "w") as f:
            f.write(caffenet_prototxt(CAFFENET_BATCH, CAFFENET_CROP, CAFFENET_WIDTHS,
                                      CAFFENET_CLASSES, deploy=True))
        with _captured(echo=False) as out:
            rows = cli.main(["time", "--net", net, "--iters", str(CLI_TIME_ITERS), "--bf16"])
    if tables:
        os.makedirs(tables, exist_ok=True)
        with open(os.path.join(tables, "cli_time_caffenet_bf16.txt"), "w") as f:
            f.write(f"{card}\n{out.getvalue()}")
    lrn = [[r[0], round(r[2], 4)] for r in rows if r[1] == "lrn"]
    total = sum(r[2] for r in rows)
    print(f"cli time --bf16 CaffeNet deploy, batch {CAFFENET_BATCH}: {len(rows)} layers, forward "
          f"total {total:.3f} ms; LRN {lrn}; ten slowest {_slowest(rows)}; {card}")
    if len(lrn) != 2:
        raise AssertionError(f"the time table has LRN rows {lrn}")
    return {"layers": len(rows), "forward_total_ms": total, "lrn_ms": lrn,
            "slowest": _slowest(rows)}


def tail_phase(dev, card: str, tables=None) -> dict:
    """Phase ``tail``: K1 at crop 227, the 35 tail layer types card against
    CPU, CaffeNet trained from K1, and the CLI's time table of CaffeNet.
    Prints one ``{"tail": ...}`` line; returns K1's record additions and
    its launches."""
    t0 = time.perf_counter()
    k1 = check_k1_caffenet(dev, card)
    layers = tail_layers(dev, card)
    caffenet = caffenet_train(dev, card)
    cli_time = caffenet_cli_time(card, tables)
    seconds = time.perf_counter() - t0
    print(json.dumps({"tail": {"k1_crop227": k1, "layers": layers,
                               "caffenet": {k: v for k, v in caffenet.items() if k != "k1"},
                               "cli_time": cli_time, "seconds": seconds, "card": card}}))
    return {"k1_record": k1, "k1": caffenet["k1"]}


# ---------------------------------------------------------------------------
# Phase parallel: data parallelism with SyncBN, inference over a mesh, two
# ranks on the one card, and the torch.export serving artifacts
# ---------------------------------------------------------------------------

# the two-rank check: 4 videos a rank, one f32 step (TF32 off, dropout 0),
# held to one process's step over the global batch of 8 by the relative L2
# of the update: PERF.md section 2's bound for full-width f32 order
# sensitivity (F32_UPDATE_REL_L2_BOUND)
TWO_RANK_VIDEOS = 4
TWO_RANK_TIMEOUT_S = 600
# the artifacts: timed requests a path, and the loader's process time limit
ARTIFACT_REQUESTS, ARTIFACT_TIMEOUT_S = 5, 600
# the artifact's loader: a fresh python3 where eco_tpu_torch, eco_tpu and jax
# cannot be imported; torch alone loads and runs each artifact on the card
_ARTIFACT_LOADER = r"""
import json, sys, time
for m in ("eco_tpu_torch", "eco_tpu", "jax"):
    sys.modules[m] = None
import torch
from torch.export.passes import move_to_device_pass
paths, inputs, out_path, device, requests = sys.argv[1:6]
paths, requests = json.loads(paths), int(requests)
d = torch.load(inputs)
if device == "cuda":
    d["frames"] = d["frames"].pin_memory()  # as the server's requests come
aug = [d["h_off"].to(device, torch.int32), d["w_off"].to(device, torch.int32),
       d["mirror"].to(device, torch.bool)]
out = {}
for name, path in paths.items():
    t0 = time.perf_counter()
    mod = move_to_device_pass(torch.export.load(path), device).module()
    out[name + "_load_s"] = time.perf_counter() - t0
    if name == "dynamic":
        for n in (4, 8):
            out[f"dynamic{n}"] = mod(d["frames"][:n].to(device), *(a[:n] for a in aug)).cpu()
        continue
    ms = []
    for i in range(1 + requests):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = mod(d["frames"].to(device, non_blocking=True), *aug)
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out[name] = y.cpu()
    out[name + "_ms"] = ms[1:]
torch.save(out, out_path)
assert not [m for m, v in sys.modules.items() if m.startswith(("eco_tpu", "jax")) and v]
"""


# the artifact beside UInt8Server in one process: a fresh python3 that imports
# eco_tpu_torch, builds the server for the same graph and weights under its
# own cuDNN state (no autotuning), and runs one request through both
_ARTIFACT_BESIDE_SERVER = r"""
import sys
import torch
from torch.export.passes import move_to_device_pass
from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.graph import graph_from_json
path, weights, inputs, out_path, device, crop = sys.argv[1:7]
w, d = torch.load(weights), torch.load(inputs)
to = lambda tree: {ln: {k: v.to(device) for k, v in lp.items()} for ln, lp in tree.items()}
server = UInt8Server(Program(graph_from_json(w["graph"]), device=device), to(w["params"]),
                     to(w["state"]), crop=int(crop), mean=tuple(w["mean"]), output="fc8")
with torch.no_grad():
    want = server(d["frames"], h_off=d["h_off"], w_off=d["w_off"], mirror=d["mirror"])
    mod = move_to_device_pass(torch.export.load(path), device).module()
    got = mod(d["frames"].to(device), d["h_off"].to(device, torch.int32),
              d["w_off"].to(device, torch.int32), d["mirror"].to(device, torch.bool))
torch.save({"server": want.cpu(), "artifact": got.cpu()}, out_path)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _same_trees(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[ln].keys() == b[ln].keys() and all(torch.equal(a[ln][k], b[ln][k]) for k in a[ln])
        for ln in a)


def _profile_step(step, ts, batch) -> dict:
    """One step under ``torch.profiler``: its wall ms (host clock, to the
    end of the device's work), the device's busy ms (kernel time summed),
    and the host ms and count of the all-reduces it issues (c10d ops)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(ts, batch, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    reduces = [e for e in events if e.key == "c10d::allreduce_"]
    # the kernels' own entries: a CPU op's device time repeats its kernels'
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "all_reduces": sum(e.count for e in reduces),
            "all_reduce_host_ms": sum(e.cpu_time_total for e in reduces) / 1e3}


@_cudnn_flags(deterministic=True, benchmark=False)
def _dp_train(dev, card: str, mesh) -> dict:
    """Full-width bf16 ECO-Lite through K1, the plain Trainer and
    ``Trainer(mesh=)`` (data parallel, SyncBN) from one state: a warm-up and
    TRAIN_STEPS timed steps each; losses and params must be equal."""
    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True, batch=BATCH)
    prog = RawPreprocessProgram(
        Program(graph, train=True, compute_dtype=torch.bfloat16, device=dev), crop=CROP,
        mean=MEAN)
    cfg = SolverConfig(**SOLVER, max_iter=1 + TRAIN_STEPS, display=0, snapshot=0)
    batch = _train_batch(SEED + 5)
    ts0 = init_train_state(*prog.init(torch.Generator().manual_seed(SEED),
                                      {k: v[0] for k, v in batch.items()}))
    runs = {}
    for name, m in (("plain", None), ("dp", mesh)):
        trainer = Trainer(prog, cfg, mesh=m, log_fn=print, metrics_lag=1)
        inner, events, losses = trainer.step, [], []

        def timed(ts, b, g, inner=inner, events=events):
            out = inner(ts, b, g)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            return out

        trainer.step = timed
        _reset_counts()
        ts = trainer.solve(ts0, itertools.repeat(batch),
                           hooks=[lambda it, _ts, mt, losses=losses: losses.append(
                               float(mt["loss"]))])
        k1 = _counts()[0]
        per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        runs[name] = dict(ts=ts, losses=losses, ms=per_step, k1=k1,
                          profile=_profile_step(inner, ts0, batch))
        print(f"parallel {name} train: {len(losses)} bf16 steps of {BATCH} x {SEGMENTS}, "
              f"losses {[round(l, 4) for l in losses]}; timed steps (ms) "
              f"{[round(t, 3) for t in per_step]}; K1 launches {k1}; one step under "
              f"torch.profiler {runs[name]['profile']}")
    plain, dp = runs["plain"], runs["dp"]
    equal = (plain["losses"] == dp["losses"] and _same_trees(plain["ts"].params, dp["ts"].params)
             and _same_trees(plain["ts"].state, dp["ts"].state))
    medians = {k: statistics.median(runs[k]["ms"]) for k in runs}
    print(f"parallel train under cudnn.deterministic: the world-1 DP + SyncBN step against "
          f"the plain step, median {medians['dp']:.3f} vs {medians['plain']:.3f} ms a step; "
          f"losses, params and BN state equal: {equal}; {card}")
    if not equal:
        raise AssertionError("the world-1 data-parallel step differs from the plain step")
    for name, r in runs.items():
        if r["k1"] != 1 + TRAIN_STEPS or not all(map(math.isfinite, r["losses"])):
            raise AssertionError(f"parallel {name} train: K1 {r['k1']}, losses {r['losses']}")
    return {"k1_plain": plain["k1"], "k1_dp": dp["k1"], "dp_ms": medians["dp"],
            "plain_ms": medians["plain"], "profile": {k: r["profile"] for k, r in runs.items()}}


@_cudnn_flags(deterministic=True, benchmark=False)
def _mesh_infer(dev, card: str, reqs) -> dict:
    """Full-width bf16 ECO-Lite inference on K1's clips of one request,
    through the sharded, tensor-parallel and segment-sharded inference of a
    world of one and a 2-stage pipeline on the one card: each equal to
    ``Program.apply`` (the pipeline: on the same 4 microbatches)."""
    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=False, batch=BATCH)
    prog = Program(graph, compute_dtype=torch.bfloat16, device=dev)
    params, state = prog.init(torch.Generator().manual_seed(SEED), {"data": graph.inputs["data"]})
    frames, aug = reqs[1]
    _reset_counts()
    clips = preprocess.preprocess_on_device(frames.to(dev), aug["h_off"], aug["w_off"],
                                            aug["mirror"], crop=CROP, mean=MEAN)
    k1 = _counts()[0]
    with torch.no_grad():
        want = prog.apply(params, state, {"data": clips})[0]["probs"]
        micro = torch.cat([prog.apply(params, state, {"data": c})[0]["probs"]
                           for c in clips.chunk(4)])
    tpm, segm = make_mesh({DATA_AXIS: 1, MODEL_AXIS: 1}), make_mesh({DATA_AXIS: 1,
                                                                      SEGMENT_AXIS: 1})
    stages = split_stages(prog, {"data": clips}, 2, params=params)
    got = {
        "sharded": make_sharded_infer_fn(prog, make_mesh())(params, state, clips),
        "tp": make_tp_infer_fn(prog, tpm)(shard_tp_tree(tpm, params), shard_tp_tree(tpm, state),
                                          clips),
        "segment": make_segment_sharded_infer_fn(prog, segm)(params, state, clips),
        "pp": make_pp_infer_fn(prog, params, state, [dev, dev], sample_inputs={"data": clips},
                               microbatches=4)({"data": clips}),
    }
    equal = {k: bool(torch.equal(v, micro if k == "pp" else want)) for k, v in got.items()}
    pp_rel = _rel_l2(got["pp"], want)
    print(f"parallel inference, bf16, {BATCH} videos: equal to Program.apply {equal}; the "
          f"pipeline's 2 stages of {[len(s.layer_names) for s in stages]} layers on one card, "
          f"4 microbatches, against the whole batch's apply: rel L2 {pp_rel:.3e}; {card}")
    if not all(equal.values()):
        raise AssertionError(f"mesh inference differs from Program.apply: {equal}")
    return {"k1": k1, "pp_vs_batch_rel_l2": pp_rel,
            "pp_stage_layers": [len(s.layer_names) for s in stages]}


def _two_rank_setup(dev, videos: int):
    """ECO-Lite TRAIN at full width, f32, dropout 0, through K1; the seeded
    initial state and a seeded global batch of ``videos`` videos."""
    graph = build_eco_lite(NUM_CLASSES, SEGMENTS, crop_size=CROP, with_loss=True, batch=videos,
                           dropout_ratio=0.0)
    prog = RawPreprocessProgram(Program(graph, train=True, device=dev), crop=CROP, mean=MEAN)
    batch = _train_batch(SEED + 6, videos=videos)
    ts = init_train_state(*prog.init(torch.Generator().manual_seed(SEED),
                                     {k: v[0] for k, v in batch.items()}))
    return prog, ts, batch


def _two_rank_worker(rank: int, device: str, port: int, outdir: str):
    """One of two ranks on the one card over gloo (NCCL takes one rank a
    card): one data-parallel f32 step with SyncBN on its 4 videos."""
    from eco_tpu_torch.parallel.multiprocess import params_digest

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    distributed_init(device=device, backend="gloo", init_method=f"tcp://localhost:{port}",
                     world_size=2, rank=rank)
    try:
        mesh = make_mesh()
        prog, ts, batch = _two_rank_setup(dev, 2 * TWO_RANK_VIDEOS)
        step = make_sharded_train_step(prog, SolverConfig(**SOLVER), mesh)
        _reset_counts()
        t0 = time.perf_counter()
        ts, m = step(ts, shard_batch(mesh, batch, batch_axis=1))
        k1 = _counts()[0]
        torch.save({"params": _to(ts.params, "cpu"), "loss": float(m["loss"]),
                    "digest": params_digest(ts.params), "k1": k1,
                    "s": time.perf_counter() - t0}, os.path.join(outdir, f"{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _two_ranks(dev, card: str) -> dict:
    """Two spawned processes train one step on the one card over gloo; their
    params must be equal, and within F32_UPDATE_REL_L2_BOUND of one process's
    f32 step over the global batch."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="eco_two_ranks_") as outdir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_two_rank_worker, args=(str(dev), _free_port(), outdir),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the two ranks still run after {TWO_RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(outdir, f"{r}.pt")) for r in range(2)]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    prog, ts0, batch = _two_rank_setup(dev, 2 * TWO_RANK_VIDEOS)
    _reset_counts()
    one, m = make_train_step(prog, SolverConfig(**SOLVER))(ts0, batch)
    k1 = _counts()[0]
    keys = [(ln, k) for ln in sorted(ts0.params) for k in sorted(ts0.params[ln])]
    start = torch.cat([ts0.params[ln][k].flatten().cpu() for ln, k in keys])
    want = torch.cat([one.params[ln][k].flatten().cpu() for ln, k in keys]) - start
    got = torch.cat([ranks[0]["params"][ln][k].flatten() for ln, k in keys]) - start
    rel = ((got - want).norm() / want.norm()).item()
    same = ranks[0]["digest"] == ranks[1]["digest"]
    print(f"two ranks on one card over gloo, f32 (TF32 off), {TWO_RANK_VIDEOS} videos a rank, "
          f"one DP + SyncBN step: params digests equal {same} ({ranks[0]['digest'][:12]}); "
          f"losses {ranks[0]['loss']:.6f} / {ranks[1]['loss']:.6f} against one process's "
          f"{float(m['loss']):.6f}; update rel L2 against one process's step over the global "
          f"batch {rel:.3e} (bound {F32_UPDATE_REL_L2_BOUND}); ranks' step "
          f"{ranks[0]['s']:.2f} / {ranks[1]['s']:.2f} s with the first launches, {wall:.1f} s "
          f"for both processes; {card}")
    if not same or not rel <= F32_UPDATE_REL_L2_BOUND:
        raise AssertionError(f"two ranks: digests equal {same}, update rel L2 {rel}")
    return {"k1_ranks": ranks[0]["k1"] + ranks[1]["k1"], "k1_one": k1, "update_rel_l2": rel}


def _artifacts(dev, card: str, reqs, lite, int8_lite) -> dict:
    """The uint8 bf16 ECO-Lite artifact at batch 8, a dynamic-batch one and
    the uint8 int8 one, exported and saved here, loaded and run on the card
    in a fresh python3 that cannot import eco_tpu_torch, eco_tpu or jax.
    Each returns the ``fc8`` logits, held to UInt8Server's: bf16 within
    BF16_LOGITS_REL_L2_BOUND, int8 within INT8_CARD_VS_CPU_REL_L2_BOUND.
    The bf16 artifact must also be nearer its server than the server fed
    either of two planted faults (mirror flipped, mean off by one), and
    equal (``torch.equal``) to the UInt8Server that a fresh python3 with
    eco_tpu_torch builds for the same graph and weights beside it: one
    process, one cuDNN state, so any gap to this process's server is that
    server's algorithm choice, not the artifact."""
    graph, params, state = lite
    prog16 = Program(graph, compute_dtype=torch.bfloat16, device=dev)
    kw = dict(batch=BATCH, segments=SEGMENTS, crop=CROP, uint8=True, frame_hw=(HEIGHT, WIDTH),
              mean=MEAN, output="fc8")
    qprog, qp, qs = int8_lite
    frames, aug = reqs[1]
    with tempfile.TemporaryDirectory(prefix="eco_artifacts_") as tmp:
        paths, sizes, export_s = {}, {}, {}
        for name, prog, p, s, extra in (
                ("static", prog16, params, state, {}),
                ("dynamic", prog16, params, state, {"dynamic_batch": True}),
                ("int8", qprog, qp, qs, {})):
            t0 = time.perf_counter()
            paths[name] = os.path.join(tmp, f"{name}.pt2")
            sizes[name] = save_serving_artifact(export_serving(prog, p, s, **kw, **extra),
                                                paths[name])
            export_s[name] = time.perf_counter() - t0
        torch.save({"frames": frames, **aug}, os.path.join(tmp, "inputs.pt"))
        server = UInt8Server(Program(graph, device=dev), params, state, crop=CROP, mean=MEAN,
                             output="fc8")
        torch.backends.cudnn.benchmark = True
        outs, per_req, _, _ = _timed_requests(server, [reqs[1]] * (1 + ARTIFACT_REQUESTS))
        want = outs[-1].float().cpu()
        want8 = UInt8Server(qprog, qp, qs, crop=CROP, mean=MEAN, output="fc8")(frames, **aug)
        faulty = {
            "mirror_flipped": server(frames, **{**aug, "mirror": ~aug["mirror"]}),
            "mean_plus_1": UInt8Server(Program(graph, device=dev), params, state, crop=CROP,
                                       mean=tuple(m + 1 for m in MEAN), output="fc8")(
                                           frames, **aug)}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_LOADER, json.dumps(paths),
             os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "outputs.pt"), dev.type,
             str(ARTIFACT_REQUESTS)],
            capture_output=True, text=True, timeout=ARTIFACT_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"the artifact loader failed: {proc.stderr[-3000:]}")
        loader_s = time.perf_counter() - t0
        got = torch.load(os.path.join(tmp, "outputs.pt"))
        torch.save({"graph": graph_to_json(graph), "params": _to(params, "cpu"),
                    "state": _to(state, "cpu"), "mean": MEAN}, os.path.join(tmp, "weights.pt"))
        proc = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_BESIDE_SERVER, paths["static"],
             os.path.join(tmp, "weights.pt"), os.path.join(tmp, "inputs.pt"),
             os.path.join(tmp, "beside.pt"), dev.type, str(CROP)],
            capture_output=True, text=True, timeout=ARTIFACT_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"the artifact beside its server failed: {proc.stderr[-3000:]}")
        beside = torch.load(os.path.join(tmp, "beside.pt"))
    # one process, one cuDNN state: the artifact must give its server's logits
    beside_equal = torch.equal(beside["artifact"], beside["server"])
    rel = {"static": _rel_l2(got["static"], want),
           "dynamic4": _rel_l2(got["dynamic4"], want[:4]),
           "dynamic8": _rel_l2(got["dynamic8"], want),
           "int8": _rel_l2(got["int8"], want8.cpu())}
    probs_rel = _rel_l2(torch.softmax(got["static"].float(), -1), torch.softmax(want, -1))
    fault_rel = {k: _rel_l2(got["static"], v.float().cpu()) for k, v in faulty.items()}
    medians = {"artifact": statistics.median(got["static_ms"]),
               "int8_artifact": statistics.median(got["int8_ms"]),
               "server": statistics.median(per_req)}
    print(f"artifacts (torch.export, plain K1/K3 inside): sizes "
          f"{ {k: round(v / 2**20, 1) for k, v in sizes.items()} } MiB, export + save "
          f"{ {k: round(v, 1) for k, v in export_s.items()} } s; loaded in a python3 without "
          f"eco_tpu_torch ({loader_s:.1f} s, load "
          f"{ {k: round(got[k + '_load_s'], 1) for k in paths} } s); in a python3 with "
          f"eco_tpu_torch, the bf16 artifact and UInt8Server on its own cuDNN state give equal "
          f"fc8 logits: {beside_equal} (that server {_rel_l2(beside['server'], want):.3e} off "
          f"this process's, whose cuDNN flags are benchmark {torch.backends.cudnn.benchmark}, "
          f"deterministic {torch.backends.cudnn.deterministic}, allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}); fc8 logits rel L2 against "
          f"the servers {rel} (bounds {BF16_LOGITS_REL_L2_BOUND} bf16, "
          f"{INT8_CARD_VS_CPU_REL_L2_BOUND} int8); the bf16 artifact's probs {probs_rel:.3e} "
          f"off the server's; its logits {fault_rel} off the server fed a planted fault; "
          f"ms a request of {BATCH} on the host's clock, copy included: artifact "
          f"{medians['artifact']:.3f} ({[round(t, 3) for t in got['static_ms']]}), int8 "
          f"artifact {medians['int8_artifact']:.3f}, UInt8Server {medians['server']:.3f} "
          f"({[round(t, 3) for t in per_req]}); {card}")
    bounds = {"static": BF16_LOGITS_REL_L2_BOUND, "dynamic4": BF16_LOGITS_REL_L2_BOUND,
              "dynamic8": BF16_LOGITS_REL_L2_BOUND, "int8": INT8_CARD_VS_CPU_REL_L2_BOUND}
    if not all(rel[k] <= bounds[k] for k in bounds):
        raise AssertionError(f"an artifact is off its server: {rel}")
    if not beside_equal:
        raise AssertionError("the bf16 artifact and UInt8Server in one process differ: rel L2 "
                             f"{_rel_l2(beside['artifact'], beside['server'])}")
    if not rel["static"] < min(fault_rel.values()):
        raise AssertionError(f"the bf16 artifact ({rel['static']}) is nearer a planted fault "
                             f"than its server: {fault_rel}")
    if tuple(got["dynamic4"].shape) != (4, NUM_CLASSES):
        raise AssertionError(f"the dynamic artifact gave {tuple(got['dynamic4'].shape)}")
    return {"rel_l2": rel, "probs_rel_l2": probs_rel, "fault_rel_l2": fault_rel, "ms": medians,
            "beside_server_equal": beside_equal,
            "beside_server_vs_autotuned_rel_l2": _rel_l2(beside["server"], want)}


def parallel_phase(dev, card: str, reqs, lite, int8_lite) -> dict:
    """Phase ``parallel``: a world-1 NCCL group and its mesh; full-width bf16
    ECO-Lite trained by ``Trainer(mesh=)`` (DP + SyncBN, K1 every step)
    equal to the plain Trainer; mesh and pipeline inference equal to
    ``Program.apply``; two ranks on the one card over gloo; the serving
    artifacts.  Prints one ``{"parallel": ...}`` line and returns K1's
    launches by path."""
    t0 = time.perf_counter()
    distributed_init(device=str(dev), init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    try:
        backend = torch.distributed.get_backend()
        mesh = make_mesh()
        print(f"parallel: process group {backend}, world {torch.distributed.get_world_size()}, "
              f"mesh {mesh_shape(mesh)} on {mesh.device_type}")
        if dev.type == "cuda" and backend != "nccl":
            raise AssertionError(f"the card's process group is {backend}, not nccl")
        train = _dp_train(dev, card, mesh)
        infer = _mesh_infer(dev, card, reqs)
    finally:
        torch.distributed.destroy_process_group()
    two = _two_ranks(dev, card)
    art = _artifacts(dev, card, reqs, lite, int8_lite)
    seconds = time.perf_counter() - t0
    print(json.dumps({"parallel": {
        "backend": backend, "dp_step_ms": train["dp_ms"], "plain_step_ms": train["plain_ms"],
        "step_profile": train["profile"],
        "two_rank_update_rel_l2": two["update_rel_l2"], "artifact_rel_l2": art["rel_l2"],
        "artifact_probs_rel_l2": art["probs_rel_l2"], "artifact_fault_rel_l2": art["fault_rel_l2"],
        "artifact_beside_server_equal": art["beside_server_equal"],
        "beside_server_vs_autotuned_rel_l2": art["beside_server_vs_autotuned_rel_l2"],
        "artifact_ms": art["ms"], "pp_vs_batch_rel_l2": infer["pp_vs_batch_rel_l2"],
        "seconds": seconds, "card": card}}))
    return {"k1": {"parallel_plain": train["k1_plain"], "parallel_dp": train["k1_dp"],
                   "parallel_infer": infer["k1"], "parallel_two_ranks": two["k1_ranks"],
                   "parallel_one_process": two["k1_one"]}}


# Phase ``examples``: each workflow as a user runs it, in its own python3, at
# published widths (train_synthetic's classes and crop are its own)
EXAMPLES = {
    "train_synthetic": ["--segments", "16", "--batch", "8", "--iters", "15"],
    "serve_streams": ["--streams", "64", "--segments", "16", "--ticks", "3"],
    "quantized_serving": ["--crop", "224", "--segments", "16", "--batch", "8"],
    "aot_artifact": ["--crop", "224", "--segments", "16", "--batch", "8", "--dynamic-batch"],
}
# what the {"examples": ...} line keeps of each workflow's result
EXAMPLE_RATES = {"train_synthetic": ["videos_per_s"], "serve_streams": ["windows_per_s"],
                 "quantized_serving": ["bf16_videos_per_s", "int8_videos_per_s"],
                 "aot_artifact": ["max_abs_diff", "logits_max_abs_diff"]}
EXAMPLE_TIMEOUT_S = 600
# quantized_serving's argmax, int8 against bf16, is held on every video whose
# bf16 top-1 margin is above this: 3x the largest max |int8 - bf16| logit
# difference measured at the phase's width (0.158 on an H100 80GB HBM3 at
# 700 W, where the margins were 3.1-3.4)
QS_ARGMAX_MARGIN = 0.5
# Phase ``int8_probe``: the probe's conv, the reference's serving shape, and
# the batch of its end-to-end serving
PROBE_CONV = dict(n=1536, hw=28, c=96)
PROBE_BATCH = 96


def _run_module(module: str, args, device: str) -> tuple[dict, float]:
    """``python3 -m module args --device device`` in a fresh process: its
    last line of output as JSON, and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args, "--device", device],
                          capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), seconds


def _falling(losses) -> bool:
    """The mean of the last third of the losses below that of the first."""
    k = max(1, len(losses) // 3)
    return statistics.fmean(losses[-k:]) < statistics.fmean(losses[:k])


def _flag(name: str, flag: str) -> int:
    """The value of ``flag`` in the phase's arguments of workflow ``name``."""
    args = EXAMPLES[name]
    return int(args[args.index(flag) + 1])


def _check_example(name: str, r: dict) -> None:
    """Each workflow's result held as the phase states it.  aot_artifact's
    destination process asserts its probs within 1e-2 (the reference's
    bound) and exits non-zero otherwise; here its logits must be equal."""
    if name == "train_synthetic":
        ok = (all(map(math.isfinite, r["losses"])) and _falling(r["losses"])
              and all(map(math.isfinite, r["metrics"].values())))
    elif name == "serve_streams":
        ok = (len(r["labels"]) == _flag(name, "--streams")
              and all(0 <= label < r["num_classes"] for label in r["labels"]))
    elif name == "quantized_serving":
        held = [m > QS_ARGMAX_MARGIN for m in r["float_top1_margin"]]
        ok = (2 * sum(held) >= len(held)
              and all(eq for eq, h in zip(r["argmax_equal"], held) if h)
              and r["logits_rel_l2"] <= INT8_VS_FLOAT_REL_L2_BOUND["eco_lite_kinetics"]
              and r["k3_launches"] == r["quantized_layers"] * r["int8_forwards"] > 0)
    else:
        batch = _flag(name, "--batch")
        ok = (r["logits_equal"]
              and r["dynamic_shapes"] == {str(b): [b, NUM_CLASSES] for b in (2, batch + 2)})
    if not ok:
        raise AssertionError(f"example {name}: {r}")


def _quantized_serving_held(dev) -> int:
    """One int8 forward of the graph ``quantized_serving`` builds at the
    phase's width, in this process, with every K3 call held to its plain
    version (``torch.equal``).  Returns the calls held."""
    name = "quantized_serving"
    prog, params, state, data = quantized_serving.build(
        _flag(name, "--segments"), _flag(name, "--batch"), _flag(name, "--crop"), dev)
    r, (qprog, qp, qs, _) = quantized_serving.quantize_and_compare(prog, params, state, data)
    with _k3_held() as checked, torch.no_grad():
        qprog.apply(qp, qs, {"data": data})
    if len(checked) != r["quantized_layers"]:
        raise AssertionError(f"{name}: {len(checked)} K3 calls held to the plain version, "
                             f"{r['quantized_layers']} int8 layers")
    print(f"{name}'s int8 graph at {tuple(data.shape)}: each of the {len(checked)} K3 calls "
          f"of one forward equals its plain version ({len(set(checked))} input shapes)")
    return len(checked)


def examples_phase(dev, card: str) -> dict:
    """Phase ``examples``: the four workflows of ``eco_tpu_torch.examples``,
    each run as ``python3 -m`` on the card at published widths and held to
    its checks; K1's and K3's launches as each process counted them.
    Prints one ``{"examples": ...}`` line and returns K3's launches."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    held = _quantized_serving_held(dev)
    torch.cuda.empty_cache()
    runs = {}
    for name, args in EXAMPLES.items():
        r, seconds = _run_module(f"eco_tpu_torch.examples.{name}", args, dev.type)
        _check_example(name, r)
        runs[name] = {"seconds": seconds, **{k: r[k] for k in EXAMPLE_RATES[name]},
                      "k1_launches": r["k1_launches"], "k3_launches": r["k3_launches"]}
        print(f"example {name} {' '.join(args)}: {seconds:.1f} s; "
              f"{ {k: v for k, v in r.items() if k not in ('labels', 'top_scores')} }; {card}")
    print(json.dumps({"examples": {**runs, "quantized_serving_k3_held": held,
                                   "seconds": time.perf_counter() - t0, "card": card}}))
    return {"k3": {"examples_quantized_serving": runs["quantized_serving"]["k3_launches"]}}


def _probe_serving_held(dev) -> dict:
    """The probe's batch-``PROBE_BATCH`` request, built in this process as the
    probe builds it (``int8_probe.serving_setup``), through each server in
    its two steps: K1's clips against its plain version, then the program
    with every K3 call held to its plain version (all ``torch.equal``).
    Returns the K1 and K3 calls held by server."""
    servers, request, report = int8_probe.serving_setup(PROBE_BATCH, dev)
    n, _, h, w, _ = request.shape
    held = {}
    for name, server in servers.items():
        with torch.no_grad():
            clips = server.clips(request)
            want = preprocess.crop_normalize_reference(
                request, [(h - server.crop) // 2] * n, [(w - server.crop) // 2] * n,
                [False] * n, crop=server.crop, mean=server.mean, out_dtype=torch.bfloat16,
                act_scale=server.in_scale)
            k1_equal = torch.equal(clips, want)
            with _k3_held() as checked:
                server.program.apply(server.params, server.state, {"data": clips},
                                     capture=[server.output])
        k3_want = len(report["quantized"]) if name == "int8" else 0
        print(f"int8_probe's {name} request {tuple(request.shape)}: K1 {clips.dtype} out "
              f"{tuple(clips.shape)} equal to its plain version {k1_equal}; {len(checked)} K3 "
              f"calls, each equal to its plain version ({len(set(checked))} input shapes)")
        if not (k1_equal and clips.dtype == K1_TYPES[name][0] and len(checked) == k3_want):
            raise AssertionError(f"int8_probe's {name} request: K1 equal {k1_equal} in "
                                 f"{clips.dtype}, {len(checked)} K3 calls held of {k3_want}")
        held[name] = {"k1": 1, "k3": len(checked)}
        del clips, want
    return held


def int8_probe_phase(dev, card: str) -> dict:
    """Phase ``int8_probe``: K3 held to its plain version at the probe's conv
    shape, and K1 and K3 on one request of the probe's batch-96 serving
    (``torch.equal``); then ``python3 -m eco_tpu_torch.tools.int8_probe`` at
    the reference's defaults on the card.  Prints one ``{"int8_probe": ...}``
    line and returns K1's and K3's launches."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, _, x, w = int8_probe.conv_operands(**PROBE_CONV, device=dev)
    ones = torch.ones(PROBE_CONV["c"], dtype=torch.float32, device=dev)
    got = int8_probe.int8_conv_step(x, w, ones)
    want = qconv.qconv_nd_reference(x, w, ones, None, pad=1,
                                    out_scale=int8_probe.CONV_OUT_SCALE)
    equal = torch.equal(got, want)
    ops, moved = _k3_work(x, w, got)
    bound_ms, bound_by = _bound_ms(moved, ops)
    print(f"K3 at the probe's conv {tuple(x.shape)} 3x3 pad 1 -> {PROBE_CONV['c']}, int8 out "
          f"at {int8_probe.CONV_OUT_SCALE}: equal to its plain version {equal}; bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    if not equal:
        raise AssertionError("K3 disagrees with its plain version at the probe's conv")
    del x, w, got, want
    torch.cuda.empty_cache()
    held = _probe_serving_held(dev)
    torch.cuda.empty_cache()
    r, seconds = _run_module("eco_tpu_torch.tools.int8_probe", [], dev.type)
    n_q = r["int8_quantized_layers"]
    launches = {"k1": r["e2e_k1_launches"], "k3": {**r["e2e_k3_launches"],
                                                   "conv": r["conv_k3_launches"]}}
    numbers = [v for k, v in r.items() if isinstance(v, float)]
    if not (all(math.isfinite(v) and v > 0 for v in numbers)
            and launches["k1"] == {"bf16": r["e2e_requests"], "int8": r["e2e_requests"]}
            and launches["k3"]["bf16"] == 0 and launches["k3"]["int8"] == n_q * r["e2e_requests"]
            and held["int8"]["k3"] == n_q and launches["k3"]["conv"] > 0):
        raise AssertionError(f"int8_probe: {r}")
    print(f"int8_probe ({seconds:.1f} s): {r}; {card}")
    print(json.dumps({"int8_probe": {**r, "conv_bound_ms": bound_ms, "held": held, "seconds":
                                     time.perf_counter() - t0, "card": card}}))
    return {"k1": {"int8_probe_bf16": launches["k1"]["bf16"],
                   "int8_probe_int8": launches["k1"]["int8"]},
            "k3": {"int8_probe_conv": launches["k3"]["conv"],
                   "int8_probe_int8": launches["k3"]["int8"]},
            "probe": {"matmul_int8_tops": r["matmul_int8_tops"],
                      "conv_int8_ms": r["conv_int8_ms"], "conv_bound_ms": bound_ms}}


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
    parser.add_argument("--cli-tables", metavar="DIR",
                        help="write the cli phase's per-layer time tables to DIR")
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
    checked.update(check_k1_online(dev, card))
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
    k1_int8_lite, k3_int8_lite, server, int8_lite = serve_int8(
        dev, card, "eco_lite_kinetics", "fc8", lite + (lite_logits16,), reqs)
    timed = {}
    k3_request = {"eco_lite_kinetics": k3_request_layers(server, reqs[1], "eco_lite_kinetics",
                                                         card, baseline, timed, args.k3_table)}
    del server
    online_counts = online_phase(dev, card, lite, int8_lite)
    k1_int8_full, k3_int8_full, server, _ = serve_int8(dev, card, "eco_full_kinetics", "fc8N",
                                                       full + (full_logits16,), reqs)
    k3_request["eco_full_kinetics"] = k3_request_layers(server, reqs[1], "eco_full_kinetics",
                                                        card, baseline, timed, args.k3_table)
    del server
    k1_e2e = train_e2e(dev, card)
    resize_checked = check_resize(dev, card)
    remat = remat_phase(dev, card)
    cli_counts = cli_phase(card, args.cli_tables)
    tail = tail_phase(dev, card, args.cli_tables)
    checked.update(tail["k1_record"])
    parallel = parallel_phase(dev, card, reqs, lite, int8_lite)
    del reqs, lite, int8_lite
    examples = examples_phase(dev, card)
    probe = int8_probe_phase(dev, card)
    for name in ("jax", "eco_tpu"):
        if name in sys.modules:
            raise AssertionError(f"the port imported {name}")
    k1_paths = {"serve": k1_serve, "train": k1_train, "test": len(test_batches),
                "serve_k2": k1_k2serve, "serve_full": k1_full, "serve_full_k2": k1_full_k2,
                "serve_int8_lite": k1_int8_lite, "serve_int8_full": k1_int8_full,
                **online_counts["k1"], **k1_e2e, "remat": remat["k1"], **cli_counts["k1"],
                **tail["k1"], **parallel["k1"], **probe["k1"]}
    k2_paths = {"test": k2_test, "serve_k2": k2_serve, "serve_full_k2": k2_full}
    k3_paths = {"serve_int8_lite": k3_int8_lite, "serve_int8_full": k3_int8_full,
                **online_counts["k3"], **cli_counts["k3"], **examples["k3"], **probe["k3"]}
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
            "probe": probe["probe"],
        },
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
