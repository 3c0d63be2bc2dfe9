"""eco_tpu_torch.convert.export (``torch.export`` serving artifacts) against
eco_tpu's StableHLO artifacts on the CPU: the 9 cases of
tests/test_export_hlo.py, the out-of-range offsets, and a loader in a
process where eco_tpu_torch, eco_tpu and jax cannot be imported.

Weights are the reference's, carried over by ``params_from_jax``; the
port's artifact is held to the reference's numbers within 1e-5 (float
graphs: the same math summed in other orders) and to the port's own
``Program.apply`` within 1e-6.
"""

import json
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eco_tpu.convert import export_serving as jax_export_serving
from eco_tpu.convert import load_serving_artifact as jax_load_serving_artifact
from eco_tpu.runtime import Program as JaxProgram
from eco_tpu.spec.graph import graph_from_json as jax_graph_from_json
from eco_tpu_torch.convert import (
    export_serving,
    load_serving_artifact,
    params_from_jax,
    save_serving_artifact,
)
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.spec.graph import graph_to_json

from tests import _torch_dist_workers as workers

REF_TOL = 1e-5
SELF_TOL = 1e-6


@pytest.fixture(scope="module")
def prog_and_weights():
    graph = workers.small_video_graph(False)
    jprog = JaxProgram(jax_graph_from_json(graph_to_json(graph)), train=False)
    data = np.random.default_rng(0).standard_normal((8, 4, 16, 16, 3)).astype(np.float32)
    jp, js = jprog.init(jax.random.PRNGKey(0), {"data": data})
    params, state = params_from_jax(graph, jp, js, device="cpu")
    return Program(graph, device="cpu"), params, state, torch.from_numpy(data), (jprog, jp, js)


def _probs(prog, params, state, data):
    return prog.apply(params, state, {"data": torch.as_tensor(data)})[0]["probs"].numpy()


def _ref_probs(ref, data):
    jprog, jp, js = ref
    return np.asarray(jprog.apply(jp, js, {"data": jnp.asarray(data)})[0]["probs"])


def _user_inputs(exported):
    return [n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in exported.graph_signature.user_inputs]


def test_roundtrip_matches_program(tmp_path, prog_and_weights):
    prog, params, state, data, ref = prog_and_weights
    exported = export_serving(prog, params, state, batch=8, segments=4, crop=16)
    path = str(tmp_path / "mini.pt2")
    assert save_serving_artifact(exported, path) > 0
    serve = load_serving_artifact(path, device="cpu")
    got = serve(data).numpy()
    np.testing.assert_allclose(got, _probs(prog, params, state, data), atol=SELF_TOL)
    np.testing.assert_allclose(got, _ref_probs(ref, data.numpy()), atol=REF_TOL)
    # weights are baked in: the artifact takes ONLY the clips tensor
    (spec,) = _user_inputs(serve.exported)
    assert tuple(spec.shape) == (8, 4, 16, 16, 3)


def test_dynamic_batch_polymorphism(tmp_path, prog_and_weights):
    """One artifact serves any batch size (symbolic leading dim)."""
    prog, params, state, _, ref = prog_and_weights
    exported = export_serving(prog, params, state, segments=4, crop=16, dynamic_batch=True)
    path = str(tmp_path / "dyn.pt2")
    save_serving_artifact(exported, path)
    serve = load_serving_artifact(path, device="cpu")
    rng = np.random.default_rng(1)
    for b in (3, 5):
        data = rng.standard_normal((b, 4, 16, 16, 3)).astype(np.float32)
        got = serve(torch.from_numpy(data)).numpy()
        assert got.shape == (b, 5)
        np.testing.assert_allclose(got, _probs(prog, params, state, data), atol=SELF_TOL)
        np.testing.assert_allclose(got, _ref_probs(ref, data), atol=REF_TOL)


def _frames_case(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (2, 4, 20, 24, 3), dtype=np.uint8)


def test_uint8_artifact_bakes_preprocess(tmp_path, prog_and_weights):
    """uint8 mode: raw frames + (h_off, w_off, mirror) in, probs out; the
    plain crop/mean/mirror inside the artifact matches doing it by hand."""
    prog, params, state, _, ref = prog_and_weights
    mean = (104.0, 117.0, 123.0)
    exported = export_serving(prog, params, state, batch=2, segments=4, crop=16, uint8=True,
                              frame_hw=(20, 24), mean=mean)
    path = str(tmp_path / "mini_u8.pt2")
    save_serving_artifact(exported, path)
    serve = load_serving_artifact(path, device="cpu")
    frames = _frames_case(2)
    h_off, w_off = np.array([1, 3], np.int32), np.array([5, 0], np.int32)
    mirror = np.array([False, True])
    got = serve(frames, h_off, w_off, mirror).numpy()
    clips = np.stack([frames[i, :, h_off[i]:h_off[i] + 16, w_off[i]:w_off[i] + 16, :]
                      for i in range(2)]).astype(np.float32) - np.asarray(mean, np.float32)
    clips[1] = clips[1][:, :, ::-1, :]
    np.testing.assert_allclose(got, _probs(prog, params, state, clips), atol=SELF_TOL)
    np.testing.assert_allclose(got, _ref_probs(ref, clips), atol=REF_TOL)


def test_uint8_offsets_past_the_far_edge_match_the_reference_artifact(tmp_path,
                                                                      prog_and_weights):
    """Offsets past H - crop (or W - crop) clamp to the last window, as
    ``lax.dynamic_slice`` clamps them in the reference's own artifact."""
    prog, params, state, _, (jprog, jp, js) = prog_and_weights
    kw = dict(batch=2, segments=4, crop=16, uint8=True, frame_hw=(20, 24))
    path = str(tmp_path / "edge.pt2")
    save_serving_artifact(export_serving(prog, params, state, **kw), path)
    serve = load_serving_artifact(path, device="cpu")
    jserve_path = str(tmp_path / "edge.stablehlo")
    from eco_tpu.convert import save_serving_artifact as jax_save

    jax_save(jax_export_serving(jprog, jp, js, platforms=("cpu",), **kw), jserve_path)
    jserve = jax_load_serving_artifact(jserve_path)
    frames = _frames_case(4)
    mirror = np.array([True, False])
    for h_off, w_off in (([5, 99], [9, 12]), ([4, 2 ** 30], [8, 2 ** 31 - 1])):
        h, w = np.array(h_off, np.int32), np.array(w_off, np.int32)
        got = serve(frames, h, w, mirror).numpy()
        want = np.asarray(jserve(frames, h, w, mirror))
        np.testing.assert_allclose(got, want, atol=REF_TOL)
        # and the clamp is the last window, by hand
        last = np.minimum(h, 4), np.minimum(w, 8)
        clips = np.stack([frames[i, :, last[0][i]:last[0][i] + 16, last[1][i]:last[1][i] + 16]
                          for i in range(2)]).astype(np.float32) - np.float32([104, 117, 123])
        clips[0] = clips[0][:, :, ::-1, :]
        np.testing.assert_allclose(got, _probs(prog, params, state, clips), atol=SELF_TOL)


def test_int8_graph_exports(tmp_path, prog_and_weights):
    """An int8-quantized graph exports the same way: its int8 layers are
    traced from their plain versions (K3's is an f64 convolution)."""
    prog, params, state, data, ref = prog_and_weights
    from eco_tpu_torch.convert.quantize import quantize_for_serving

    with torch.no_grad():
        qprog, qp, qs, _ = quantize_for_serving(prog, params, state, [{"data": data}])
    exported = export_serving(qprog, qp, qs, batch=8, segments=4, crop=16)
    path = str(tmp_path / "mini_int8.pt2")
    save_serving_artifact(exported, path)
    got = load_serving_artifact(path, device="cpu")(data).numpy()
    np.testing.assert_allclose(got, _probs(qprog, qp, qs, data), atol=SELF_TOL)
    assert any(v.dtype == torch.int8 for v in exported.constants.values())
    # the reference's quantization of the same weights on the same batch
    from eco_tpu.convert.quantize import quantize_for_serving as jax_quantize

    jprog, jp, js = ref
    jq, jqp, jqs, _ = jax_quantize(jprog, jp, js, [{"data": jnp.asarray(data.numpy())}])
    want = np.asarray(jq.apply(jqp, jqs, {"data": jnp.asarray(data.numpy())})[0]["probs"])
    np.testing.assert_allclose(got, want, atol=REF_TOL)


def test_mesh_sharded_artifact(tmp_path, prog_and_weights):
    """mesh= exports the per-rank shard (batch / world); on every rank the
    loader's callable runs its shard of the global batch and all-gathers the
    output.  Two ranks over gloo."""
    prog, params, state, data, ref = prog_and_weights
    (r0, r1) = workers.run("export_mesh", {
        "params": workers.arrays(params), "state": workers.arrays(state),
        "data": data.numpy(), "dir": str(tmp_path)}, timeout=120)
    want = _ref_probs(ref, data.numpy())
    for r in (r0, r1):
        assert r["in_shape"] == (4, 4, 16, 16, 3)
        np.testing.assert_allclose(r["probs"], want, atol=REF_TOL)
        np.testing.assert_allclose(r["probs"], _probs(prog, params, state, data),
                                   atol=SELF_TOL)
        assert "not divisible" in r["errors"]["batch"]
        assert "mutually exclusive" in r["errors"]["dynamic"]


def test_uint8_rejects_frames_smaller_than_crop(prog_and_weights):
    prog, params, state, _, _ = prog_and_weights
    with pytest.raises(ValueError, match="smaller than crop"):
        export_serving(prog, params, state, batch=2, segments=4, crop=16, uint8=True,
                       frame_hw=(12, 20))


def test_loader_needs_only_torch(tmp_path, prog_and_weights):
    """A process where eco_tpu_torch, eco_tpu and jax cannot be imported
    loads the artifact with torch alone and gets the program's probs."""
    prog, params, state, data, _ = prog_and_weights
    path = tmp_path / "mini.pt2"
    save_serving_artifact(export_serving(prog, params, state, batch=8, segments=4, crop=16),
                          str(path))
    np.save(tmp_path / "x.npy", data.numpy())
    code = f"""
import sys
for m in ("eco_tpu_torch", "eco_tpu", "jax"):
    sys.modules[m] = None
import numpy as np, torch
from torch.export.passes import move_to_device_pass
ep = move_to_device_pass(torch.export.load({str(path)!r}), "cpu")
y = ep.module()(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))
np.save({str(tmp_path / 'y.npy')!r}, y.numpy())
assert not [m for m, v in sys.modules.items() if m.startswith(("eco_tpu", "jax")) and v]
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               _probs(prog, params, state, data), atol=SELF_TOL)


def _cli_files(tmp_path, prog, params, state):
    from eco_tpu_torch.train.checkpoint import save_model

    gpath = tmp_path / "mini.graph.json"
    gpath.write_text(graph_to_json(prog.graph))
    wpath = str(tmp_path / "mini.npz")
    save_model(wpath, params, state)
    return str(gpath), wpath


def test_cli_aot(tmp_path, prog_and_weights):
    """eco aot --net graph.json --weights model.npz -o artifact."""
    prog, params, state, data, ref = prog_and_weights
    from eco_tpu_torch.tools.cli import main

    gpath, wpath = _cli_files(tmp_path, prog, params, state)
    out = str(tmp_path / "mini.pt2")
    classes = tmp_path / "classes.txt"
    classes.write_text("".join(f"class_{i}\n" for i in range(5)))
    main(["aot", "--net", gpath, "--weights", wpath, "--batch", "8", "--segments", "4",
          "--no-optimize", "--classes", str(classes), "-o", out, "--device", "cpu"])
    # the deploy-contract sidecar: calling convention + class map
    meta = json.load(open(out + ".json"))
    assert meta["classes"] == [f"class_{i}" for i in range(5)]
    assert meta["in_avals"][0]["shape"] == ["8", "4", "16", "16", "3"]
    got = load_serving_artifact(out, device="cpu")(data).numpy()
    np.testing.assert_allclose(got, _probs(prog, params, state, data), atol=SELF_TOL)
    np.testing.assert_allclose(got, _ref_probs(ref, data.numpy()), atol=REF_TOL)


def test_cli_aot_int8(tmp_path, prog_and_weights):
    """eco aot --int8 --uint8: PTQ baked into the artifact, the int8 input
    plane in the baked preprocess; the artifact IS the quantized program."""
    prog, params, state, _, _ = prog_and_weights
    from eco_tpu_torch.convert.quantize import quantize_for_serving
    from eco_tpu_torch.tools.cli import main

    gpath, wpath = _cli_files(tmp_path, prog, params, state)
    out = str(tmp_path / "mini_int8.pt2")
    main(["aot", "--net", gpath, "--weights", wpath, "--batch", "2", "--segments", "4",
          "--no-optimize", "--uint8", "--frame-h", "20", "--frame-w", "24",
          "--mean", "0,0,0", "--int8", "-o", out, "--device", "cpu"])
    assert json.load(open(out + ".json"))["int8"] is True
    frames = _frames_case(5)
    zeros = np.zeros(2, np.int32)
    got = load_serving_artifact(out, device="cpu")(frames, zeros, zeros,
                                                   np.zeros(2, bool)).numpy()
    # the CLI's calibration (seeded random data), reproduced
    gen = torch.Generator().manual_seed(0)
    calib = {name: 60.0 * torch.randn(shape, generator=gen)
             for name, shape in prog.graph.inputs.items()}
    with torch.no_grad():
        qprog, qp, qs, _ = quantize_for_serving(prog, params, state, [calib])
    clips = frames[:, :, :16, :16, :].astype(np.float32)
    np.testing.assert_allclose(got, _probs(qprog, qp, qs, clips), atol=1e-5)


def test_cli_aot_mean_flag_baked_into_uint8(tmp_path, prog_and_weights):
    """--mean overrides the preprocess mean baked into --uint8 artifacts and
    is recorded in the sidecar; blank class lines are dropped."""
    prog, params, state, _, ref = prog_and_weights
    from eco_tpu_torch.tools.cli import main

    gpath, wpath = _cli_files(tmp_path, prog, params, state)
    out = str(tmp_path / "mini_u8.pt2")
    classes = tmp_path / "classes.txt"
    classes.write_text("a\n\nb\nc\nd\ne\n\n")
    main(["aot", "--net", gpath, "--weights", wpath, "--batch", "2", "--segments", "4",
          "--no-optimize", "--uint8", "--frame-h", "20", "--frame-w", "24",
          "--mean", "128,128,128", "--classes", str(classes), "-o", out, "--device", "cpu"])
    meta = json.load(open(out + ".json"))
    assert meta["mean_bgr"] == [128.0, 128.0, 128.0]
    assert meta["classes"] == ["a", "b", "c", "d", "e"]
    frames = _frames_case(3)
    zeros = np.zeros(2, np.int32)
    got = load_serving_artifact(out, device="cpu")(frames, zeros, zeros,
                                                   np.zeros(2, bool)).numpy()
    clips = frames[:, :, :16, :16, :].astype(np.float32) - 128.0
    np.testing.assert_allclose(got, _probs(prog, params, state, clips), atol=SELF_TOL)
    np.testing.assert_allclose(got, _ref_probs(ref, clips), atol=REF_TOL)


def test_two_exports_of_an_ave_pool_graph_in_one_process(tmp_path):
    """The AVE divisor grid is cached per geometry; a grid made inside one
    trace must not reach the next one (it would be a stale traced tensor)."""
    from eco_tpu_torch.ops import pool
    from eco_tpu_torch.spec.netspec import NetBuilder

    b = NetBuilder("avepool")
    x = b.layer("fold", "fold_segments", b.input("data", (2, 2, 12, 12, 3)))
    x = b.layer("pool", "pooling", x, pool="AVE", kernel_size=3, stride=2, pad=1)
    b.layer("probs", "softmax", b.fc("fc", b.layer("gap", "global_avg_pool", x), 4))
    graph = b.build()
    prog = Program(graph, device="cpu")
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": (2, 2, 12, 12, 3)})
    data = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 2, 12, 12, 3))
                            .astype(np.float32))
    pool.ave_divisors.cache_clear()
    paths = [str(tmp_path / f"{i}.pt2") for i in range(2)]
    for path, dynamic in zip(paths, (False, True)):
        save_serving_artifact(export_serving(prog, params, state, batch=2, segments=2, crop=12,
                                             dynamic_batch=dynamic), path)
    assert pool.ave_divisors.cache_info().currsize == 0  # nothing cached while tracing
    for path in paths:
        got = load_serving_artifact(path, device="cpu")(data).numpy()
        np.testing.assert_allclose(got, _probs(prog, params, state, data), atol=SELF_TOL)
