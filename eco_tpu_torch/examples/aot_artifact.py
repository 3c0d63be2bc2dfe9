"""Ahead-of-time serving: export ECO-Lite as one ``torch.export`` artifact.

Twin of ``examples/aot_artifact.py``.  The inference program, weights baked
in, is traced once (``convert.export_serving``) and written as one ``.pt2``
file (``save_serving_artifact``); then a destination process in which
``eco_tpu_torch``, ``eco_tpu`` and ``jax`` cannot be imported loads it with
``torch.export.load`` and ``move_to_device_pass`` onto ``--device``, runs it
on the same clips, and checks its probabilities against the live program's
(max |difference| below 1e-2, the reference's assertion).  The destination
needs ``torch`` only: no model code, no prototxt, no Caffe runtime.

A second artifact, the same program exported at its logits blob (the
softmax's input), goes to the destination beside the first: it reports how
far those logits sit from the live program's (``logits_max_abs_diff``,
``logits_equal``).  Probabilities of random weights over 400 classes all sit
near 1/400, so the 1e-2 bound on them would not see an artifact that lost
its weights; the logits would.

The artifact has no ``platforms``, unlike the reference's StableHLO one:
``move_to_device_pass`` picks the device when the file is loaded.  It is
traced on the CPU, so it carries the plain versions of the port's kernels,
never the CUDA ones.

    python -m eco_tpu_torch.examples.aot_artifact [--segments 8] [--crop 128] \
        [--batch 4] [--dynamic-batch] [--device cuda]

``--crop 224 --segments 16`` is the published width.  ``--dynamic-batch``
exports one artifact with a symbolic batch dimension, and the destination
also calls it at batch 2 and at batch + 2.  The last line printed is the
result as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import torch

from eco_tpu_torch.convert import export_serving, optimize_for_inference, save_serving_artifact
from eco_tpu_torch.examples.quantized_serving import logits_blob
from eco_tpu_torch.models import get_model
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.utils.tracing import COUNTS

# the reference's bound on the destination's probabilities (aot_artifact.py)
MAX_PROB_DIFF = 1e-2
DESTINATION_TIMEOUT_S = 900

# The destination process: torch alone.  argv: the artifact, the logits
# artifact, clips (f32 .npy), the live program's probs and logits (.npy),
# device, input dtype, batches to call the dynamic artifact at (JSON), where
# to write its probs, the bound on the probs.
_DESTINATION = textwrap.dedent("""
    import json, sys
    for m in ("eco_tpu_torch", "eco_tpu", "jax"):
        sys.modules[m] = None  # an import would raise
    import numpy as np, torch
    from torch.export.passes import move_to_device_pass
    path, logits_path, data, ref, ref_logits, device, dtype, batches, out_path = sys.argv[1:10]
    load = lambda p: move_to_device_pass(torch.export.load(p), device).module()
    mod = load(path)
    dtype = getattr(torch, dtype)
    x = torch.from_numpy(np.load(data)).to(device, dtype)
    with torch.no_grad():
        out = mod(x).float().cpu().numpy()
        logits = load(logits_path)(x).float().cpu().numpy()
        shapes = {}
        for b in json.loads(batches):
            d = np.random.default_rng(b).standard_normal((b,) + x.shape[1:]).astype(np.float32)
            shapes[b] = list(mod(torch.from_numpy(d).to(device, dtype)).shape)
    ref = np.load(ref)
    np.save(out_path, out)
    diff = float(np.abs(out - ref).max())
    print("destination-process max|diff|:", diff)
    assert diff < float(sys.argv[10]), diff
    assert not [m for m, v in sys.modules.items() if m.startswith(("eco_tpu", "jax")) and v]
    ref_logits = np.load(ref_logits)
    print(json.dumps({"max_abs_diff": diff,
                      "top1_agreement": float((out.argmax(-1) == ref.argmax(-1)).mean()),
                      "logits_max_abs_diff": float(np.abs(logits - ref_logits).max()),
                      "logits_equal": bool(np.array_equal(logits, ref_logits)),
                      "dynamic_shapes": shapes}))
""")


def export_and_check(prog, params, state, data: np.ndarray, *, device, dynamic_batch: bool,
                     workdir: str) -> dict:
    """Export ``prog`` for clips shaped like ``data``, and at its logits
    blob, save both under ``workdir``, and run them in a destination process
    on ``device``.  Returns the artifact's size, the destination's report
    and its probs."""
    batch, segments, crop = data.shape[:3]
    fc = logits_blob(prog.graph)
    exported = export_serving(prog, params, state, batch=batch, segments=segments, crop=crop,
                              dynamic_batch=dynamic_batch)
    path, logits_path = (os.path.join(workdir, f) for f in ("eco_lite.pt2", "logits.pt2"))
    nbytes = save_serving_artifact(exported, path)
    save_serving_artifact(export_serving(prog, params, state, batch=batch, segments=segments,
                                         crop=crop, output=fc), logits_path)
    dtype = prog.compute_dtype or torch.float32
    with torch.no_grad():
        want = prog.apply(params, state, {"data": torch.from_numpy(data).to(prog.device, dtype)},
                          capture=[fc])[0]
    files = {k: os.path.join(workdir, f"{k}.npy") for k in ("data", "ref", "ref_logits", "out")}
    np.save(files["data"], data)
    np.save(files["ref"], want["probs"].float().cpu().numpy())
    np.save(files["ref_logits"], want[fc].float().cpu().numpy())
    batches = [2, batch + 2] if dynamic_batch else []
    proc = subprocess.run(
        [sys.executable, "-c", _DESTINATION, path, logits_path, files["data"], files["ref"],
         files["ref_logits"], str(device), str(dtype).removeprefix("torch."),
         json.dumps(batches), files["out"], str(MAX_PROB_DIFF)],
        capture_output=True, text=True, timeout=DESTINATION_TIMEOUT_S)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise RuntimeError(f"the destination process failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"artifact_mb": nbytes / 1e6, **report, "probs": np.load(files["out"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--dynamic-batch", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    graph = get_model("eco_lite_kinetics", num_segments=args.segments, batch=args.batch,
                      crop_size=args.crop)
    data = np.random.default_rng(0).standard_normal(graph.inputs["data"]).astype(np.float32)
    params, state = Program(graph, device=device).init(torch.Generator().manual_seed(0),
                                                       {"data": graph.inputs["data"]})
    graph, params, state = optimize_for_inference(graph, params, state)
    prog = Program(graph, compute_dtype=torch.bfloat16, device=device)
    k1_0, k3_0 = COUNTS["k1.launches"], COUNTS["k3.launches"]
    with tempfile.TemporaryDirectory(prefix="eco_aot_") as tmp:
        result = export_and_check(prog, params, state, data, device=device,
                                  dynamic_batch=args.dynamic_batch, workdir=tmp)
    del result["probs"]
    print(f"artifact: {result['artifact_mb']:.1f} MB; destination max |prob diff| "
          f"{result['max_abs_diff']:.3g}, top-1 agreement {result['top1_agreement']:.3f}; "
          f"logits artifact max |diff| {result['logits_max_abs_diff']:.3g}")
    for b, shape in result["dynamic_shapes"].items():
        print(f"dynamic batch b={b}: out shape {tuple(shape)}")
    result["k1_launches"] = COUNTS["k1.launches"] - k1_0
    result["k3_launches"] = COUNTS["k3.launches"] - k3_0
    result["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
