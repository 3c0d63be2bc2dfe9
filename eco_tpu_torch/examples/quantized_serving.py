"""int8 serving: quantize ECO-Lite and compare its predictions with bf16.

Twin of ``examples/quantized_serving.py``.  Post-training quantization of
the zoo's ECO-Lite UCF101 graph on one synthetic calibration batch
(``convert.quantize_for_serving``: BN folded, per-channel int8 weights,
calibrated activation scales, int8 chains), then the bf16 and int8 graphs
side by side on that batch: the quantized-layer count, the argmax agreement,
the max |prob difference|, the logits' relative L2 and each path's videos/s.
On the card every int8 conv and fc runs through K3 (``ops/qconv.py``), once
a layer a forward.

    python -m eco_tpu_torch.examples.quantized_serving [--segments 8] \
        [--batch 8] [--crop 128] [--iters 5] [--device cuda]

Small defaults, as the reference's; ``--crop 224 --segments 16`` is the
published width.  ``--device cpu`` runs K3's plain version.  Times come
from CUDA events after a warm-up on the card, from the host's clock on the
CPU.  The last line printed is the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from eco_tpu_torch.convert import quantize_for_serving
from eco_tpu_torch.models import get_model
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.runtime.profiler import _Clock
from eco_tpu_torch.utils.tracing import COUNTS


def logits_blob(graph) -> str:
    """The blob the softmax reads: the graph's logits."""
    (name,) = [l.bottoms[0] for l in graph.layers if l.type == "softmax"]
    return name


def calibration_data(shape, device, dtype) -> torch.Tensor:
    """The reference's synthetic batch: standard normal times 60, seed 7."""
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32) * 60.0
    return torch.from_numpy(x).to(device, dtype)


def build(segments: int, batch: int, crop: int, device) -> tuple:
    """The bf16 ECO-Lite UCF101 program at this size, its seeded weights and
    the calibration batch: ``(prog, params, state, data)``."""
    graph = get_model("eco_lite_ucf101", num_segments=segments, batch=batch, crop_size=crop)
    prog = Program(graph, compute_dtype=torch.bfloat16, device=device)
    params, state = prog.init(torch.Generator().manual_seed(0),
                              {"data": graph.inputs["data"]})
    return prog, params, state, calibration_data(graph.inputs["data"], device, torch.bfloat16)


def quantize_and_compare(prog, params, state, data) -> tuple[dict, tuple]:
    """Quantize ``prog`` on ``data`` and run both graphs on it.  Returns the
    comparison and ``(qprog, qparams, qstate, report)``."""
    quantized = quantize_for_serving(prog, params, state, [{"data": data}],
                                     compute_dtype=prog.compute_dtype)
    qprog, qp, qs, report = quantized
    fc = logits_blob(prog.graph)
    with torch.no_grad():
        ref = prog.apply(params, state, {"data": data}, capture=[fc])[0]
        out = qprog.apply(qp, qs, {"data": data}, capture=[fc])[0]
    ref_logits, logits = ref[fc].float(), out[fc].float()
    top2 = ref_logits.topk(2, -1).values
    result = {
        "quantized_layers": len(report["quantized"]),
        "chained_layers": len(report["chained"]),
        "argmax_agreement": (ref["probs"].argmax(-1) == out["probs"].argmax(-1))
        .float().mean().item(),
        "argmax_equal": (ref_logits.argmax(-1) == logits.argmax(-1)).tolist(),
        "float_top1_margin": (top2[:, 0] - top2[:, 1]).tolist(),
        "max_prob_diff": (ref["probs"].float() - out["probs"].float()).abs().max().item(),
        "logits_max_abs_diff": (ref_logits - logits).abs().max().item(),
        "logits_rel_l2": ((logits - ref_logits).norm() / ref_logits.norm()).item(),
    }
    return result, quantized


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    prog, params, state, data = build(args.segments, args.batch, args.crop, device)

    k1_0, k3_0 = COUNTS["k1.launches"], COUNTS["k3.launches"]
    t0 = time.perf_counter()
    result, (qprog, qp, qs, _) = quantize_and_compare(prog, params, state, data)
    result["quantize_and_compare_s"] = time.perf_counter() - t0
    print(f"quantized {result['quantized_layers']} conv/fc layers "
          f"({result['chained_layers']} chained) in {result['quantize_and_compare_s']:.1f}s")
    print(f"argmax agreement: {result['argmax_agreement']:.3f}   "
          f"max |prob diff|: {result['max_prob_diff']:.4f}   "
          f"logits rel L2: {result['logits_rel_l2']:.4f}")

    for name, p_, p, s in (("bf16", prog, params, state), ("int8", qprog, qp, qs)):
        def forward(p_=p_, p=p, s=s):
            with torch.no_grad():
                return p_.apply(p, s, {"data": data})[0]["probs"]

        ms = _Clock(device, args.iters, warmup=1)(forward)
        result[f"{name}_videos_per_s"] = args.batch / ms * 1e3
        result[f"{name}_ms"] = ms
        print(f"{name}: {args.batch / ms * 1e3:8.1f} videos/s  ({ms:.2f} ms)")
    # one int8 forward in the comparison, one warm-up and ``iters`` timed
    result["int8_forwards"] = 2 + args.iters
    result["k1_launches"] = COUNTS["k1.launches"] - k1_0
    result["k3_launches"] = COUNTS["k3.launches"] - k3_0
    result["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
