"""The multi-scale raw plane (``eco_tpu_torch/ops/resize.py``) against
``eco_tpu/ops/resize.py`` and cv2, as ``tests/test_resize.py`` holds the
reference: within 1e-4 of the reference (both are two one-hot-blended f32
products; measured equal on these inputs), within 1.5 gray levels of cv2
(its INTER_LINEAR uses 5-bit fixed-point weights), exact at a full-size
window.  Then ``RawPreprocessProgram`` on a multi-scale
``VideoPipeline(raw=True)`` batch through a train step."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eco_tpu.data import TransformConfig as JaxTransformConfig
from eco_tpu.data import VideoDataConfig as JaxVideoDataConfig
from eco_tpu.data import VideoPipeline as JaxVideoPipeline
from eco_tpu.ops.resize import crop_resize as jax_crop_resize
from eco_tpu.ops.resize import preprocess_resize_on_device as jax_preprocess_resize
from eco_tpu_torch.apps import RawPreprocessProgram
from eco_tpu_torch.data import TransformConfig, VideoDataConfig, VideoPipeline
from eco_tpu_torch.ops.resize import crop_resize, preprocess_resize_on_device
from eco_tpu_torch.runtime import Program
from eco_tpu_torch.train import SolverConfig, init_train_state, make_train_step
from test_resize import _host_crop_resize
from test_torch_train import HW, _mini_train_graph

RNG = np.random.default_rng(7)
MEAN = (104.0, 117.0, 123.0)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


def _windows():
    stack = RNG.integers(0, 256, (2, 3, 48, 56, 3), np.uint8)
    ho, wo = np.asarray([4, 9], np.int32), np.asarray([0, 11], np.int32)
    ch, cw = np.asarray([40, 36], np.int32), np.asarray([44, 36], np.int32)
    return stack, ho, wo, ch, cw


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_crop_resize_matches_jax_and_cv2_whatever_the_f32_matmul_setting(precision):
    cs = 32
    stack, ho, wo, ch, cw = _windows()
    want = np.asarray(jax_crop_resize(*(jnp.asarray(a) for a in (stack, ho, wo, ch, cw)),
                                      out_size=cs))
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        got = crop_resize(torch.from_numpy(stack), ho, wo, torch.from_numpy(ch),
                          torch.from_numpy(cw), out_size=cs)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(old)
    assert got.dtype == torch.float32 and got.shape == (2, 3, cs, cs, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    for n in range(2):
        ref = _host_crop_resize(stack[n], int(ho[n]), int(wo[n]), int(ch[n]), int(cw[n]), cs)
        np.testing.assert_allclose(got[n].numpy(), ref, atol=1.5)


def test_crop_resize_is_an_exact_crop_at_a_full_size_window():
    cs = 32
    stack = RNG.integers(0, 256, (2, 2, 48, 56, 3), np.uint8)
    got = crop_resize(torch.from_numpy(stack), [5, 16], [7, 24], [cs, cs], [cs, cs],
                      out_size=cs).numpy()
    np.testing.assert_array_equal(got[0], stack[0, :, 5:5 + cs, 7:7 + cs].astype(np.float32))
    np.testing.assert_array_equal(got[1], stack[1, :, 16:16 + cs, 24:24 + cs].astype(np.float32))


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_preprocess_resize_mirror_and_mean_match_jax(dtype, jdtype):
    cs = 32
    stack, ho, wo, ch, cw = _windows()
    mirror = np.asarray([False, True])
    want = np.asarray(jax_preprocess_resize(
        *(jnp.asarray(a) for a in (stack, ho, wo, ch, cw, mirror)), crop=cs, mean=MEAN,
        out_dtype=jdtype).astype(jnp.float32))
    got = preprocess_resize_on_device(torch.from_numpy(stack), ho, wo, ch, cw, mirror,
                                      crop=cs, mean=MEAN, out_dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-4)


def _pipeline_batch(tmp_path, pipeline_cls, data_cfg, transform_cfg):
    """One multi-scale raw train batch over 4 videos of 8 JPEG frames,
    24x28, crop 16 (the mini-graph's)."""
    rng = np.random.default_rng(0)
    lines = []
    for v in range(4):
        d = tmp_path / f"v{v}"
        d.mkdir(exist_ok=True)
        for f in range(8):
            cv2.imwrite(str(d / ("img_%04d.jpg" % (f + 1))),
                        rng.integers(0, 255, (24, 28, 3), np.uint8))
        lines.append(f"{d} 8 {v % 5}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    cfg = data_cfg(
        source=str(tmp_path / "list.txt"), batch_size=2, num_segments=4, new_height=24,
        new_width=28, raw=True, shuffle=True,
        transform=transform_cfg(crop_size=HW, mirror=True, fix_crop=True, more_fix_crop=True,
                                multi_scale=True, max_distort=1))
    pipe = pipeline_cls(cfg, train=True, seed=0, num_workers=1)
    try:
        return pipe.next_batch()
    finally:
        pipe.close()


def test_raw_plane_trains_on_multi_scale_batches(tmp_path):
    """VideoPipeline(raw=True) with the stock ECO augmentation (multi_scale,
    fix_crop, mirror; ECO_Lite.prototxt:15-27) puts crop_h/crop_w in the
    batch, as the reference's does (its batch, bit for bit);
    RawPreprocessProgram crops and resizes those windows on the device, and
    a Nesterov step trains on them (tests/test_resize.py:75)."""
    batch = _pipeline_batch(tmp_path, VideoPipeline, VideoDataConfig, TransformConfig)
    jbatch = _pipeline_batch(tmp_path, JaxVideoPipeline, JaxVideoDataConfig,
                             JaxTransformConfig)
    assert "crop_h" in batch and batch["data"].dtype == np.uint8
    assert batch.keys() == jbatch.keys()
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    assert (batch["crop_h"] != HW).any()
    g = _mini_train_graph()
    prog = RawPreprocessProgram(Program(g, train=True, device="cpu"), crop=HW)
    micro = {k: torch.from_numpy(v[None]) for k, v in batch.items()}
    params, state = prog.init(torch.Generator().manual_seed(0), {k: v[0] for k, v in micro.items()})
    cfg = SolverConfig(base_lr=0.05, lr_policy="fixed", clip_gradients=40.0, iter_size=1)
    ts, metrics = make_train_step(prog, cfg)(init_train_state(params, state), micro,
                                             torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert not torch.equal(ts.params["fc"]["w"], params["fc"]["w"])
    clips = prog._clips({k: v[0] for k, v in micro.items()})
    assert clips.shape == (2, 4, HW, HW, 3) and clips.dtype == torch.float32
