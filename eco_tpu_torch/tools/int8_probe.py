"""int8 on the card's tensor cores: matmul and conv rates, and int8 serving.

    python -m eco_tpu_torch.tools.int8_probe [-o out.json] [--skip-e2e] [--device cuda]

Twin of ``eco_tpu/tools/int8_probe.py``, written for the H100's tensor cores
instead of the TPU's MXU.  It separates the dtype's own speedup from the
rest of an int8 request:

- ``matmul_ratio``: a chain of 4096x4096 products in bf16 (``torch.matmul``)
  against the same chain in int8 (``torch._int_mm``, int32 out, ``>> 8`` back
  to int8, as the reference's step), and the int8 product alone (int32 out,
  no shift or cast): what the card gives through its library, the
  yardstick for K3.  No kernel of the port runs here.
- ``conv_ratio``: the reference's serving-shape conv, a 3x3 conv, pad 1,
  (1536, 28, 28, 96) -> 96 channels, in bf16 through cuDNN (channels-last)
  against int8 through K3 (``ops.qconv.qconv_nd``) with an int8-out epilogue
  at ``out_scale`` 1024 standing in for the reference's ``>> 10``: K3
  requantizes by ``clip(round(acc / 1024), -127, 127)`` where the reference
  shifts and wraps, the same bytes and operations.
- the end-to-end part: ECO-Lite Kinetics at the reference's batch 96 served
  by ``UInt8Server`` from uint8 frames resident on the device, first in bf16,
  then int8 (K1 emits int8 into conv1, K3 runs every int8 layer),
  calibrated on two batches of K1's f32 clips; both videos/s and
  ``int8_speedup_vs_bf16``.

Each rate comes with its share of the H100 SXM's dense peak (NVIDIA's data
sheet: 989 TFLOP/s bf16, 1,979 TOP/s int8).  Times are CUDA events after a
warm-up on the card (the host's clock with ``--device cpu``); a chain step's
time is a K-step chain's less a 1-step chain's, over K - 1, as the
reference's device loop.  Prints the results as JSON on the last line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from eco_tpu_torch.ops import preprocess, qconv
from eco_tpu_torch.runtime.profiler import _Clock

BF16_PEAK = 989e12
INT8_PEAK = 1979e12
MEAN = (104.0, 117.0, 123.0)
# conv_ratio's int8-out epilogue: acc / 2**10, as the reference's ``>> 10``
CONV_OUT_SCALE = 1024.0


def _timed_chain(x, w, step, K=16, repeats=3) -> float:
    """ms a step: the best of ``repeats`` K-step chains less the best 1-step
    chain, over K - 1 (each step's output is the next one's input)."""
    def run(k):
        a = x
        for _ in range(k):
            a = step(a, w)
        return a

    # one warm-up chain first: handles, workspaces, algorithm choice, builds
    best = {k: _Clock(x.device, 1, warmup=1, repeats=repeats)(lambda k=k: run(k))
            for k in (1, K)}
    return (best[K] - best[1]) / (K - 1)


def bf16_matmul_step(a, w):
    return torch.matmul(a, w)


def int8_matmul_step(a, w):
    """int8 x int8 -> int32, ``>> 8``, cast to int8 (wrapping, as XLA's
    convert in the reference)."""
    return (torch._int_mm(a, w) >> 8).to(torch.int8)


def matmul_operands(n: int, device):
    """The reference's operands (seed 0): bf16 normals, then int8 integers.
    The int8 right-hand side is column-major, the layout cuBLASLt's int8
    product takes; the values are the same."""
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((n, n))).to(device, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((n, n))).to(device, torch.bfloat16)
    xi = torch.from_numpy(rng.integers(-127, 128, (n, n))).to(device, torch.int8)
    wi = torch.from_numpy(rng.integers(-127, 128, (n, n))).to(device, torch.int8)
    return xb, wb, xi, wi.t().contiguous().t()


def matmul_ratio(n: int = 4096, device="cuda") -> dict:
    """bf16 and int8 product chains at n x n x n: ms a step, T(FL)OP/s, their
    shares of the dense peaks, and bf16 time over int8 time."""
    xb, wb, xi, wi = matmul_operands(n, torch.device(device))
    ops = 2 * n**3
    tb = _timed_chain(xb, wb, bf16_matmul_step)
    ti = _timed_chain(xi, wi, int8_matmul_step)
    tp = _Clock(xi.device, 16, warmup=1)(lambda: torch._int_mm(xi, wi))
    return {
        "matmul_bf16_ms": tb, "matmul_bf16_tops": ops / tb / 1e9,
        "matmul_bf16_peak_share": ops / tb * 1e3 / BF16_PEAK,
        "matmul_int8_ms": ti, "matmul_int8_tops": ops / ti / 1e9,
        "matmul_int8_peak_share": ops / ti * 1e3 / INT8_PEAK,
        "int8_matmul_ratio": tb / ti,
        "int_mm_ms": tp, "int_mm_tops": ops / tp / 1e9,
        "int_mm_peak_share": ops / tp * 1e3 / INT8_PEAK,
    }


def bf16_conv_step(a, w):
    """cuDNN, channels-last bf16 (NCHW view of an NHWC tensor)."""
    return F.conv2d(a, w, padding=1)


def int8_conv_step(a, w, scale_vec):
    """K3: int8 x int8 -> int32 conv, then int8 at ``out_scale`` 1024."""
    return qconv.qconv_nd(a, w, scale_vec, None, pad=1, out_scale=CONV_OUT_SCALE)


def conv_operands(n: int, hw: int, c: int, device):
    """The reference's operands (seed 1) in the port's layouts: bf16 input
    channels-last, weights OIHW; int8 input NHWC, weights in K3's layout."""
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(rng.standard_normal((n, hw, hw, c))).to(device, torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((3, 3, c, c)) * 0.1).to(device, torch.bfloat16)
    xi = torch.from_numpy(rng.integers(-127, 128, (n, hw, hw, c))).to(device, torch.int8)
    wi = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, c))).to(device, torch.int8)
    return (xb.movedim(-1, 1), wb.permute(3, 2, 0, 1).contiguous(), xi,
            qconv.kernel_layout(wi.permute(3, 2, 0, 1)))


def conv_ratio(n: int = 1536, hw: int = 28, c: int = 96, device="cuda") -> dict:
    """int8:bf16 on the serving-shape conv: the inception 3x3 trunk shape at
    batch 96 x 16 segments, (1536, 28, 28, 96) -> 96 channels."""
    device = torch.device(device)
    xb, wb, xi, wi = conv_operands(n, hw, c, device)
    ones = torch.ones(c, dtype=torch.float32, device=device)
    ops = 2 * n * hw * hw * 9 * c * c
    tb = _timed_chain(xb, wb, bf16_conv_step, K=8)
    k3_0 = qconv.qconv_launches
    ti = _timed_chain(xi, wi, lambda a, w: int8_conv_step(a, w, ones), K=8)
    return {
        "conv_bf16_ms": tb, "conv_bf16_tops": ops / tb / 1e9,
        "conv_bf16_peak_share": ops / tb * 1e3 / BF16_PEAK,
        "conv_int8_ms": ti, "conv_int8_tops": ops / ti / 1e9,
        "conv_int8_peak_share": ops / ti * 1e3 / INT8_PEAK,
        "int8_conv_ratio": tb / ti,
        "conv_k3_launches": qconv.qconv_launches - k3_0,
    }


def serving_setup(batch: int = 96, device="cuda", *, segments: int = 16, crop: int = 224,
                  frame_hw=(256, 340)) -> tuple[dict, torch.Tensor, dict]:
    """ECO-Lite Kinetics, optimized for inference, served at ``batch`` by
    two ``UInt8Server`` instances: bf16, and int8 quantized on two batches
    of K1's f32 center crops of seeded uint8 frames.  Returns the servers
    by name, one request of seeded uint8 frames on the device, and the
    quantization report."""
    from eco_tpu_torch.apps import UInt8Server
    from eco_tpu_torch.convert import optimize_for_inference, quantize_for_serving
    from eco_tpu_torch.models import get_model
    from eco_tpu_torch.runtime import Program

    device = torch.device(device)
    graph = get_model("eco_lite_kinetics", batch=batch, num_segments=segments, crop_size=crop)
    params, state = Program(graph, device=device).init(torch.Generator().manual_seed(0),
                                                       {"data": graph.inputs["data"]})
    graph, params, state = optimize_for_inference(graph, params, state)
    gen = torch.Generator(device).manual_seed(1)
    shape = (batch, segments, *frame_hw, 3)

    def frames():
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)

    centre = [[(size - crop) // 2] * batch for size in frame_hw]
    calib = [{"data": preprocess.preprocess_on_device(
        frames(), *centre, [False] * batch, crop=crop, mean=MEAN, out_dtype=torch.float32)}
        for _ in range(2)]
    prog = Program(graph, compute_dtype=torch.bfloat16, device=device)
    qprog, qp, qs, report = quantize_for_serving(prog, params, state, calib, fold=False,
                                                 compute_dtype=torch.bfloat16)
    del calib
    servers = {"bf16": UInt8Server(prog, params, state, crop=crop, mean=MEAN),
               "int8": UInt8Server(qprog, qp, qs, crop=crop, mean=MEAN)}
    return servers, frames(), report


def serving_ratio(batch: int = 96, device="cuda", *, segments: int = 16, crop: int = 224,
                  frame_hw=(256, 340), iters: int = 10) -> dict:
    """The servers of :func:`serving_setup`, each timed over its request: a
    warm-up, then ``iters`` timed; the launches count all ``1 + iters``."""
    device = torch.device(device)
    servers, request, report = serving_setup(batch, device, segments=segments, crop=crop,
                                             frame_hw=frame_hw)
    out = {}
    for name, server in servers.items():
        def serve(server=server):
            with torch.no_grad():
                return server(request)

        k1_0, k3_0 = preprocess.crop_normalize_launches, qconv.qconv_launches
        ms = _Clock(device, iters, warmup=1)(serve)
        out[name] = {"ms": ms, "videos_per_sec": batch / ms * 1e3,
                     "k1": preprocess.crop_normalize_launches - k1_0,
                     "k3": qconv.qconv_launches - k3_0}
    return {
        "eco_lite_bf16_videos_per_sec": out["bf16"]["videos_per_sec"],
        "eco_lite_bf16_ms": out["bf16"]["ms"],
        "int8_videos_per_sec": out["int8"]["videos_per_sec"],
        "int8_ms": out["int8"]["ms"],
        "int8_quantized_layers": len(report["quantized"]),
        "int8_chained_layers": len(report["chained"]),
        "int8_batch": batch,
        "int8_speedup_vs_bf16": out["int8"]["videos_per_sec"] / out["bf16"]["videos_per_sec"],
        "e2e_requests": 1 + iters,
        "e2e_k1_launches": {k: v["k1"] for k, v in out.items()},
        "e2e_k3_launches": {k: v["k3"] for k, v in out.items()},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--skip-e2e", action="store_true",
                    help="only the raw matmul and conv ratios (fast)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # cuDNN picks by timing, as XLA's autotuner
    results = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                          else "cpu")}
    print("device:", results["device"], flush=True)
    results.update(matmul_ratio(device=device))
    print(json.dumps(results), flush=True)
    results.update(conv_ratio(device=device))
    print(json.dumps(results), flush=True)
    if not args.skip_e2e:
        results.update(serving_ratio(96, device))
    print(json.dumps(results), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
