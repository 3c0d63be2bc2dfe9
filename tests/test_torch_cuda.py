"""eco_tpu_torch on a CUDA device: the hand-written kernels (K1-K7)
against their plain versions, the serving path and a train step on the
card against the same on the CPU, and the world-1 NCCL data-parallel step
against the plain one.

These tests need an NVIDIA GPU and nvcc, and skip without them.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import I3D_POOLS, K4_FRAMES, K4_POOLS, MVIT_BLOCKS, MVIT_CLIPS
from eco_tpu_torch.apps import RawPreprocessProgram, UInt8Server
from eco_tpu_torch.data import prefetch_to_device
from eco_tpu_torch.convert import optimize_for_inference, quantize_for_serving
from eco_tpu_torch.models import build_eco_lite, get_model
from eco_tpu_torch.ops import pool, poolfuse, poolk, preprocess, qconv, s2d
from eco_tpu_torch.ops.quant import conv_nd_int8, inner_product_int8, quantize_weight
from eco_tpu_torch.ops.pool import pool_nd
from eco_tpu_torch.ops.resize import preprocess_resize_on_device
from eco_tpu_torch.runtime import Program, profiler
from eco_tpu_torch.train import SolverConfig, init_train_state, make_train_step
from eco_tpu_torch.utils.tracing import COUNTS

pytestmark = pytest.mark.cuda

MEAN = (104.0, 117.0, 123.0)
F32_UPDATE_REL_L2_BOUND = 5e-2


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda", 0)


def _batch(dev, n, s, h, w, crop, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randint(0, 256, (n, s, h, w, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    h_off = torch.randint(0, h - crop + 1, (n,), device=dev, generator=gen)
    w_off = torch.randint(0, w - crop + 1, (n,), device=dev, generator=gen)
    mirror = torch.randint(0, 2, (n,), device=dev, generator=gen).bool()
    return frames, h_off, w_off, mirror


@pytest.mark.parametrize("dtype,act_scale", [
    (torch.float32, None), (torch.bfloat16, None), (torch.int8, 0.37), (torch.int8, 2.0),
])
def test_kernel_equals_plain_version(cuda, dtype, act_scale):
    args = _batch(cuda, 8, 16, 256, 340, 224)
    kw = dict(crop=224, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
    before = COUNTS["k1.launches"]
    got = preprocess.preprocess_on_device(*args, **kw)
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] == before + 1
    assert torch.equal(got, preprocess.crop_normalize_reference(*args, **kw))


def test_kernel_clamps_offsets_like_plain_version(cuda):
    frames, _, _, mirror = _batch(cuda, 4, 3, 20, 24, 16, seed=1)
    h_off = torch.tensor([-7, 0, 5, 1000], device=cuda)
    w_off = torch.tensor([100, -1, 8, 3], device=cuda)
    kw = dict(crop=16, mean=MEAN, out_dtype=torch.float32)
    got = preprocess.preprocess_on_device(frames, h_off, w_off, mirror, **kw)
    want = preprocess.crop_normalize_reference(frames, h_off, w_off, mirror, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("crop", [7, 16, 224])
@pytest.mark.parametrize("dtype,act_scale", [
    (torch.float32, None), (torch.bfloat16, None), (torch.int8, 0.37), (torch.int8, 2.0),
])
@pytest.mark.parametrize("mirror", ["off", "on"])
def test_kernel_equals_plain_version_over_a_grid(cuda, crop, dtype, act_scale, mirror):
    """W*3 = 3*crop + 9 bytes a row: no frame row is 16-byte aligned; the last
    video's window ends at the tensor's last byte; at crop 7, 21 values a row
    (no 16-byte store lines up with a row) and N*S*crop = 63 rows, no whole
    number of row groups."""
    n, s, h, w = 3, 3, crop + 5, crop + 3
    frames, h_off, w_off, _ = _batch(cuda, n, s, h, w, crop, seed=crop)
    h_off[-1], w_off[-1] = h - crop, w - crop
    flags = torch.full((n,), mirror == "on", device=cuda)
    kw = dict(crop=crop, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
    before = COUNTS["k1.launches"]
    got = preprocess.preprocess_on_device(frames, h_off, w_off, flags, **kw)
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] == before + 1
    assert torch.equal(got, preprocess.crop_normalize_reference(frames, h_off, w_off, flags, **kw))


@pytest.mark.parametrize("dtype,act_scale", [
    (torch.float32, None), (torch.bfloat16, None), (torch.int8, 0.37)])
def test_kernel_at_crop_227_equals_plain_version(cuda, dtype, act_scale):
    """CaffeNet's input: (32, 1, 256, 256, 3) -> 227 crops, random in-range
    offsets and mirrors.  227 is prime (the rows split 57/57/57/56) and a row
    is 681 values, a multiple of no 16-byte unit."""
    args = _batch(cuda, 32, 1, 256, 256, 227, seed=227)
    kw = dict(crop=227, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
    before = COUNTS["k1.launches"]
    got = preprocess.preprocess_on_device(*args, **kw)
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] == before + 1
    assert torch.equal(got, preprocess.crop_normalize_reference(*args, **kw))


@pytest.mark.parametrize("n,s,size", [(2, 16, 224), (64, 16, 224), (3, 4, 7)])
@pytest.mark.parametrize("dtype,act_scale", [
    (torch.float32, None), (torch.bfloat16, None), (torch.int8, 0.37)])
def test_kernel_on_frames_already_cropped(cuda, n, s, size, dtype, act_scale):
    """The online app's shape: frames center-cropped on the host, so H = W =
    crop and the offsets are 0 (one row group a plane, a 672-byte row at
    224); at 7, 21-byte rows."""
    gen = torch.Generator(device=cuda).manual_seed(size + n)
    frames = torch.randint(0, 256, (n, s, size, size, 3), dtype=torch.uint8, device=cuda,
                           generator=gen)
    zeros, flags = [0] * n, [False] * n
    kw = dict(crop=size, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
    before = COUNTS["k1.launches"]
    got = preprocess.preprocess_on_device(frames, zeros, zeros, flags, **kw)
    torch.cuda.synchronize()
    assert COUNTS["k1.launches"] == before + 1
    assert torch.equal(got, preprocess.crop_normalize_reference(frames, zeros, zeros, flags, **kw))


def test_prefetch_to_device_hands_over_copied_batches_in_order(cuda):
    """The side-stream copies of 64 MB batches, two ahead: a kernel that the
    consumer launches at once reads the whole batch (its stream waits on the
    copy), and the batches' memory is not handed to the next ones while the
    consumer's kernels may still read it (``record_stream``)."""
    n = 6
    host = [{"x": np.full((16, 1 << 22), i, np.uint8), "i": np.asarray([i, -i], np.int32)}
            for i in range(n)]
    sums = []
    for b in prefetch_to_device(iter(host), 2, device=cuda):
        assert b["x"].device.type == "cuda" and b["x"].is_pinned() is False
        sums.append(b["x"].sum(dtype=torch.int64))
        del b
    for i, (got, want) in enumerate(zip(sums, host)):
        assert got.item() == want["x"].size * i


def test_kernel_takes_frames_at_an_odd_address(cuda):
    """A contiguous view at storage offset 1: no source row is 16-byte
    aligned and the first chunk starts before the tensor; the kernel reads
    only the tensor's bytes and equals the plain version."""
    frames, h_off, w_off, mirror = _batch(cuda, 2, 3, 20, 24, 16, seed=3)
    base = torch.zeros(1 + frames.numel(), dtype=torch.uint8, device=cuda)
    base[1:] = frames.flatten()
    view = base[1:].view(frames.shape)
    assert view.data_ptr() % 16 != 0
    h_off[0], w_off[0] = 0, 0  # the window at the tensor's first byte
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        kw = dict(crop=16, mean=MEAN, out_dtype=dtype,
                  act_scale=0.37 if dtype == torch.int8 else None)
        assert torch.equal(preprocess.preprocess_on_device(view, h_off, w_off, mirror, **kw),
                           preprocess.crop_normalize_reference(frames, h_off, w_off, mirror,
                                                               **kw))


def test_kernel_with_host_offsets_never_syncs_the_stream(cuda):
    """CPU int64 offsets and a bool mirror (as a server gets them), and the
    server's preprocessing step: no stream sync, and on the card only K1 and
    one copy of the packed offsets."""
    frames, h_off, w_off, mirror = _batch(cuda, 2, 4, 80, 96, 64, seed=4)
    host = (h_off.cpu(), w_off.cpu(), mirror.cpu())
    kw = dict(crop=64, mean=MEAN)
    want = preprocess.crop_normalize_reference(frames, *host, out_dtype=torch.bfloat16, **kw)
    graph = get_model("eco_lite_kinetics", batch=2, num_segments=4, crop_size=64)
    server = UInt8Server(Program(graph, device=cuda), {}, {}, crop=64)
    pinned = frames.cpu().pin_memory()
    preprocess.preprocess_on_device(frames, *host, **kw)  # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = preprocess.preprocess_on_device(frames, *host, **kw)
        clips = server.clips(pinned, h_off=host[0], w_off=host[1], mirror=host[2])
        centre = server.clips(pinned)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        preprocess.preprocess_on_device(frames, *host, **kw)
        torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(clips, want)
    assert torch.equal(centre, preprocess.crop_normalize_reference(
        frames, [8, 8], [16, 16], [False, False], out_dtype=torch.bfloat16, **kw))
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("crop_normalize" in nm for nm in names) == 1 and len(names) <= 2, names


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    frames, h_off, w_off, mirror = _batch(cuda, 2, 2, 20, 24, 16)
    with pytest.raises(ValueError, match="contiguous"):
        preprocess.preprocess_on_device(frames.transpose(2, 3), h_off, w_off, mirror, crop=16)
    with pytest.raises(ValueError, match="crop"):
        preprocess.preprocess_on_device(frames, h_off, w_off, mirror, crop=32)
    with pytest.raises(ValueError, match="h_off"):
        preprocess.preprocess_on_device(frames, h_off[:1], w_off, mirror, crop=16)


def test_server_on_card_matches_cpu(cuda):
    """Full-width ECO-Lite at crop 64, S=4, f32 with TF32 off: cuDNN and the
    CPU sum in other orders, so the logits agree to ~1e-5 relative."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = get_model("eco_lite_kinetics", batch=2, num_segments=4, crop_size=64)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                        {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    frames, h_off, w_off, mirror = (t.cpu() for t in _batch(cuda, 2, 4, 80, 96, 64))
    outs = []
    for dev in ("cpu", cuda):
        to = {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in p.items()}
        st = {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in s.items()}
        server = UInt8Server(Program(g, compute_dtype=torch.float32, device=dev), to, st,
                             crop=64, output="fc8")
        outs.append(server(frames, h_off=h_off, w_off=w_off, mirror=mirror).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)


def _card_and_cpu_logits(cuda, graph, params, state, crop, fc, frames, aug):
    outs = []
    for dev in ("cpu", cuda):
        to = {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in params.items()}
        st = {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in state.items()}
        server = UInt8Server(Program(graph, compute_dtype=torch.float32, device=dev), to, st,
                             crop=crop, output=fc)
        outs.append(server(frames, **aug).cpu())
    return outs


def test_eco_full_server_on_card_matches_cpu(cuda):
    """ECO-Full at crop 224 (its 7x7 pool needs it), S=4, N=2, f32 with TF32
    off: as test_server_on_card_matches_cpu, ~180 layers deep."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = get_model("eco_full_kinetics", batch=2, num_segments=4, crop_size=224)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                        {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    frames, h_off, w_off, mirror = (t.cpu() for t in _batch(cuda, 2, 4, 240, 256, 224))
    aug = dict(h_off=h_off, w_off=w_off, mirror=mirror)
    cpu, card = _card_and_cpu_logits(cuda, g, p, s, 224, "fc8N", frames, aug)
    torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-4)


def test_int8_server_on_card_matches_cpu(cuda):
    """int8 ECO-Lite at crop 64, S=4, N=2, f32 between int8 layers, int8
    input plane on: K3 equals its plain version, so only the float ops
    between int8 layers sum in other orders, and a one-ulp difference can
    flip an int8 value downstream; argmax equal and relative L2 within 1e-2,
    as chip_smoke.py holds the full-width model."""
    graph = get_model("eco_lite_kinetics", batch=2, num_segments=4, crop_size=64)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                        {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    frames, h_off, w_off, mirror = (t.cpu() for t in _batch(cuda, 2, 4, 80, 96, 64))
    clips = preprocess.preprocess_on_device(frames, h_off, w_off, mirror, crop=64, mean=MEAN,
                                            out_dtype=torch.float32)
    qprog, qp, qs, report = quantize_for_serving(Program(g, device="cpu"), p, s,
                                                 [{"data": clips}], fold=False)
    assert len(report["quantized"]) == 29
    before = COUNTS["k3.launches"]
    cpu, card = _card_and_cpu_logits(cuda, qprog.graph, qp, qs, 64, "fc8", frames,
                                     dict(h_off=h_off, w_off=w_off, mirror=mirror))
    assert COUNTS["k3.launches"] == before + 29
    assert torch.equal(card.argmax(-1), cpu.argmax(-1))
    assert ((card - cpu).norm() / cpu.norm()).item() < 1e-2


@pytest.mark.parametrize("shape", [(4, 112, 112, 64), (2, 56, 56, 192), (3, 8, 12, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("variant", ["plain", "relu", "affine"])
def test_fused_maxpool_equals_plain_version(cuda, shape, dtype, variant):
    """(3, 8, 12, 5): C is no whole 16-byte vector, the kernel's scalar path."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    y = (torch.randn(shape, device=cuda, generator=gen) - 1.0).to(dtype)
    scale = torch.randn(shape[-1], device=cuda, generator=gen) * 0.3 + 1.0
    shift = torch.randn(shape[-1], device=cuda, generator=gen) * 0.2
    kw = dict(relu=variant == "relu", affine=variant == "affine")
    args = (scale, shift) if variant == "affine" else ()
    before = COUNTS["k2.launches"]
    got = poolfuse.fused_maxpool_3x3s2(y, *args, **kw)
    torch.cuda.synchronize()
    assert COUNTS["k2.launches"] == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, poolfuse.fused_maxpool_3x3s2_reference(y, *args, **kw))


def test_fused_maxpool_scalar_path_on_an_unaligned_view(cuda):
    base = torch.randn(1 + 2 * 16 * 16 * 8, device=cuda).to(torch.bfloat16)
    y = base[1:].view(2, 16, 16, 8)  # 2-byte offset: no 16-byte vectors
    assert y.data_ptr() % 16 != 0
    assert torch.equal(poolfuse.fused_maxpool_3x3s2(y),
                       poolfuse.fused_maxpool_3x3s2_reference(y))


def test_fused_maxpool_propagates_nan_like_plain_version(cuda):
    y = torch.randn(1, 8, 8, 8, device=cuda)
    y[0, 4, 4, 2] = float("nan")  # in the windows (1|2, 1|2)
    got = poolfuse.fused_maxpool_3x3s2(y)
    want = poolfuse.fused_maxpool_3x3s2_reference(y)
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == 4
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_pool_nd_takes_k4_not_k2_at_a_k2_shape(cuda):
    """``pool_nd`` at a K2 shape launches K4 once and K2 never, equal to K2's
    plain version; K2 runs only when called, and raises under a gradient."""
    x = torch.randn(2, 16, 16, 8, device=cuda)
    want = poolfuse.fused_maxpool_3x3s2_reference(x)
    k2, k4 = COUNTS["k2.launches"], COUNTS["k4.launches"]
    assert torch.equal(pool_nd(x, kernel=3, stride=2, mode="max"), want)
    assert (COUNTS["k2.launches"], COUNTS["k4.launches"]) == (k2, k4 + 1)
    with pytest.raises(NotImplementedError, match="backward"):
        poolfuse.fused_maxpool_3x3s2(x.clone().requires_grad_())
    with pytest.raises(ValueError, match="contiguous"):
        poolfuse.fused_maxpool_3x3s2(x.transpose(1, 2))
    assert COUNTS["k2.launches"] == k2


FLOATS = [torch.float32, torch.bfloat16, torch.float16]


def _k4_held(x, k, s, p, mode):
    """``pool_nd`` of ``x`` takes K4 once and no route, and equals the plain
    route on the card bit for bit."""
    k4, route = COUNTS["k4.launches"], COUNTS["pool.route"]
    got = pool.pool_nd(x, kernel=k, stride=s, pad=p, mode=mode)
    torch.cuda.synchronize()
    assert COUNTS["k4.launches"] == k4 + 1 and COUNTS["pool.route"] == route
    want = pool.padded_pool(x, (k, k), (s, s), (p, p), mode)
    assert got.dtype == x.dtype and got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("name", sorted(K4_POOLS))
def test_k4_equals_plain_route_at_every_eco_and_caffenet_pool(cuda, name, dtype):
    """At 32 videos x 16 frames, the batch of the benchmark's cells."""
    (h, w, c), k, s, p, mode, _, _ = K4_POOLS[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((K4_FRAMES, h, w, c), device=cuda, generator=gen).to(dtype)
    _k4_held(x, k, s, p, mode)


@pytest.mark.parametrize("mode", ["max", "ave"])
@pytest.mark.parametrize("shape,k,s,p", [
    ((4, 13, 13, 256), 13, 13, 0), ((4, 9, 11, 16), 2, 2, 1), ((4, 10, 10, 32), 5, 3, 2),
    ((3, 9, 11, 5), 3, 2, 1), ((3, 8, 12, 12), 3, 1, 1), ((3, 9, 9, 16), 3, 2, 2)])
def test_k4_generic_and_scalar_paths_equal_plain_route(cuda, shape, k, s, p, mode):
    """Windows outside the specialised three (the generic tile path); C of
    5 bf16 or 12 f16 channels, no whole 16-byte vector (the scalar path);
    a pad over half the window, where the route's AVE sums on the
    zero-padded tensor rather than in ATen's pool with its own pads."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    base = torch.randn(shape, device=cuda, generator=gen)
    for dtype in FLOATS:
        _k4_held(base.to(dtype), k, s, p, mode)


@pytest.mark.parametrize("mode", ["max", "ave"])
def test_k4_scalar_path_on_an_unaligned_view(cuda, mode):
    base = torch.randn(1 + 2 * 16 * 16 * 8, device=cuda).to(torch.bfloat16)
    x = base[1:].view(2, 16, 16, 8)  # 2-byte offset: no 16-byte vectors
    assert x.data_ptr() % 16 != 0
    assert not poolk.plan(x.shape, (3, 3), (2, 2), (0, 0), 2, aligned=False).tiled
    _k4_held(x, 3, 2, 0, mode)



@pytest.mark.parametrize("shape,k,s,p", [((4, 8, 8, 192), 3, 1, 1), ((4, 28, 28, 16), 3, 1, 1),
                                         ((2, 7, 7, 32), 7, 1, 0), ((2, 11, 9, 8), 3, 2, 1)])
def test_ave_route_gradient_on_card_matches_cpu(cuda, shape, k, s, p):
    """Under a gradient (training, where K4 does not run) the AVE route's
    values and input gradient on the card equal the CPU's to f32 rounding;
    ATen's CUDA backward of its padded ceil-mode pool did not."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=gen)
    out = [pool.caffe_pool_out_dim(n, k, s, p)[0] for n in shape[1:3]]
    w = torch.randn([shape[0], *out, shape[3]], generator=gen)
    got = []
    for dev in ("cpu", cuda):
        xx = x.to(dev).detach().requires_grad_()
        y = pool_nd(xx, kernel=k, stride=s, pad=p, mode="ave")
        (y * w.to(dev)).sum().backward()
        got.append((y.detach().cpu(), xx.grad.cpu()))
    torch.testing.assert_close(got[1][0], got[0][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1][1], got[0][1], rtol=1e-6, atol=1e-6)

@pytest.mark.parametrize("k,s,p", [(3, 2, 0), (3, 1, 1)])
def test_k4_max_propagates_nan_like_plain_route(cuda, k, s, p):
    x = torch.randn(1, 8, 8, 8, device=cuda)
    x[0, 4, 4, 2] = float("nan")
    got = poolk.caffe_pool(x, (k, k), (s, s), (p, p), "max")
    want = pool.padded_pool(x, (k, k), (s, s), (p, p), "max")
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == (4 if s == 2 else 9)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("rank", [4, 5])
def test_k4_wrapper_rejects_what_the_kernel_does_not_take(cuda, rank):
    x = torch.randn((2, 4, 8, 8, 8)[5 - rank:], device=cuda)
    k, s, p = (3,) * (rank - 2), (1,) * (rank - 2), (1,) * (rank - 2)
    other_rank = x[None] if rank == 4 else x[0]
    bad = [x.transpose(-3, -2), x.to(torch.int8), other_rank, x.cpu(), x.clone().requires_grad_()]
    for y in bad:
        with pytest.raises(ValueError, match="caffe_pool takes"):
            poolk.caffe_pool(y, k, s, p, "max")
    with pytest.raises(ValueError, match="mode"):
        poolk.caffe_pool(x, k, s, p, "stochastic")
    with pytest.raises(ValueError, match="pad >= 0"):
        poolk.caffe_pool(x, k, s, (-1,) + p[1:], "max")


def _k4_held3(x, k, s, p, mode):
    """``pool_nd`` of the 5D ``x`` takes K4 once (its 3D path unless the
    window along T is one frame, with stride 1 and no pad) and no route, and
    equals the plain route on the card bit for bit."""
    k4, k4_3d, route = COUNTS["k4.launches"], COUNTS["k4.launches.3d"], COUNTS["pool.route"]
    got = pool.pool_nd(x, kernel=k, stride=s, pad=p, mode=mode)
    torch.cuda.synchronize()
    path3d = (k[0], s[0], p[0]) != (1, 1, 0)
    assert (COUNTS["k4.launches"], COUNTS["k4.launches.3d"], COUNTS["pool.route"]) == (
        k4 + 1, k4_3d + path3d, route)
    want = pool.padded_pool(x, k, s, p, mode)
    assert got.dtype == x.dtype and got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["max", "ave"])
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("name", sorted(I3D_POOLS))
def test_k4_3d_equals_plain_route_at_every_i3d_pool(cuda, name, dtype, mode):
    """At each of I3D's pool geometries, 2 clips, in both modes (I3D's own
    are 13 MAX and the logits' AVE)."""
    (t, h, w, c), k, s, p, _, _ = I3D_POOLS[name]
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, t, h, w, c), device=cuda, generator=gen).to(dtype)
    _k4_held3(x, k, s, p, mode)


@pytest.mark.parametrize("mode", ["max", "ave"])
@pytest.mark.parametrize("shape,k,s,p", [
    ((2, 5, 9, 11, 16), (2, 3, 3), (1, 2, 2), (1, 1, 1)),
    ((2, 6, 8, 8, 32), (3, 2, 2), (3, 2, 2), (0, 0, 0)),
    ((2, 5, 6, 6, 8), (4, 3, 3), (2, 1, 1), (2, 1, 1)),
    ((2, 7, 9, 9, 16), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((2, 7, 8, 8, 16), (3, 3, 3), (2, 2, 2), (2, 2, 0)),
    ((2, 9, 10, 13, 16), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 5, 7, 7, 24), (2, 7, 7), (1, 1, 1), (0, 0, 0)),
    ((2, 7, 9, 11, 24), (2, 2, 2), (2, 2, 2), (1, 0, 1)),
    ((2, 5, 9, 11, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 4, 8, 12, 12), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
    ((3, 4, 9, 9, 16), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((3, 5, 9, 9, 16), (1, 3, 3), (2, 2, 2), (0, 1, 1))])
def test_k4_3d_generic_and_scalar_paths_equal_plain_route(cuda, shape, k, s, p, mode):
    """Windows outside the tile path's four, and its four in the mode it is
    not instantiated for (the scalar path); its four with pads, ragged tiles
    and ceil-mode clips in all three axes; C of 5 (bf16, f16 and f32) or 12
    (bf16 and f16) with no whole 16-byte vector (the scalar path); a window
    of one frame (K4's 2D path over the frames), and of one frame with
    stride 2 (the 3D path's scalar kernel)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    base = torch.randn(shape, device=cuda, generator=gen)
    for dtype in FLOATS:
        _k4_held3(base.to(dtype), k, s, p, mode)


@pytest.mark.parametrize("mode", ["max", "ave"])
def test_k4_3d_scalar_path_on_an_unaligned_view(cuda, mode):
    base = torch.randn(1 + 2 * 4 * 8 * 8 * 8, device=cuda).to(torch.bfloat16)
    x = base[1:].view(2, 4, 8, 8, 8)  # 2-byte offset: no 16-byte vectors
    assert x.data_ptr() % 16 != 0
    assert not poolk.plan3d(x.shape, (3, 3, 3), (1, 1, 1), (1, 1, 1), mode, 2,
                            aligned=False).tiled
    _k4_held3(x, (3, 3, 3), (1, 1, 1), (1, 1, 1), mode)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("k,s,p", [((3, 3, 3), (1, 1, 1), (1, 1, 1)),
                                   ((3, 3, 3), (2, 2, 2), (0, 0, 0)),
                                   ((2, 2, 2), (2, 2, 2), (0, 0, 0)),
                                   ((2, 3, 3), (1, 2, 2), (1, 1, 1))])
def test_k4_3d_max_propagates_nan_like_plain_route(cuda, k, s, p, dtype):
    x = torch.randn(1, 6, 8, 8, 16, device=cuda).to(dtype)
    x[0, 3, 4, 4, 2] = float("nan")
    x[0, 0, 0, 7, 9] = float("nan")
    got = poolk.caffe_pool(x, k, s, p, "max")
    want = pool.padded_pool(x, k, s, p, "max")
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() >= 2
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_bf16_i3d_serving_request_takes_k4_at_every_pool(cuda):
    """I3D at 16 frames and 224 (the same 14 pool layers, 12 with a window of
    more than one frame): K4 at every pool, none on the route."""
    graph = get_model("i3d_rgb_kinetics", batch=1, num_frames=16, crop_size=224)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                                      {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    p = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in p.items()}
    s = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in s.items()}
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s,
                         crop=224, mean=(127.5, 127.5, 127.5))
    frames, h_off, w_off, mirror = _batch(cuda, 1, 16, 240, 256, 224)
    k4, k4_3d, route = COUNTS["k4.launches"], COUNTS["k4.launches.3d"], COUNTS["pool.route"]
    with torch.no_grad():  # as the benchmark's server
        probs = server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
    torch.cuda.synchronize()
    assert torch.isfinite(probs.float()).all()
    assert (COUNTS["k4.launches"] - k4, COUNTS["k4.launches.3d"] - k4_3d,
            COUNTS["pool.route"] - route) == (14, 12, 0)


# K5 at I3D's stem (2 clips of 64 frames at 224: TF's (2, 3) pads, the
# last cell completed with zeros) and at an odd size (225: symmetric pads),
# and at small shapes of 1, 2 and 4 channels (padded extents even and odd)
K5_CASES = {
    "i3d_stem": ((2, 64, 224, 224, 3), ((2, 3), (2, 3), (2, 3))),
    "odd_225": ((2, 16, 225, 225, 3), ((2, 3), (3, 3), (3, 3))),
    "one_channel": ((2, 5, 9, 11, 1), ((0, 1), (1, 2), (2, 3))),
    "two_channels": ((1, 6, 7, 8, 2), ((1, 1), (0, 1), (1, 1))),
    "four_channels": ((1, 6, 7, 8, 4), ((3, 3), (2, 3), (1, 1))),
}


@pytest.mark.parametrize("channels", [None, 32])
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_equals_plain_version(cuda, case, dtype, channels):
    shape, pads = K5_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    if channels and channels * x.element_size() > s2d.MAX_CELL_BYTES:
        channels = 8 * shape[-1]
    before = COUNTS["s2d.launches"]
    got = s2d.space_to_depth(x, (2, 2, 2), pads, channels)
    torch.cuda.synchronize()
    assert COUNTS["s2d.launches"] == before + 1
    want = s2d.space_to_depth_reference(x, (2, 2, 2), pads, channels)
    assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, want)


def test_bf16_i3d_serving_request_runs_the_stem_on_k5(cuda):
    """The optimized stem reads K5's cells: one launch a request, and no
    ``eco.pad`` (the stem's asymmetric pad is K5's index arithmetic)."""
    graph = get_model("i3d_rgb_kinetics", batch=1, num_frames=16, crop_size=224)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                                      {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    p = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in p.items()}
    s = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in s.items()}
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s,
                         crop=224, mean=(127.5, 127.5, 127.5))
    frames, h_off, w_off, mirror = _batch(cuda, 1, 16, 240, 256, 224)
    before = COUNTS["s2d.launches"]
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        probs = server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
        torch.cuda.synchronize()
    assert torch.isfinite(probs.float()).all()
    names = [e.name for e in prof.events()]
    assert COUNTS["s2d.launches"] - before == 1
    assert names.count("eco.s2d") == 1 and names.count("eco.pad") == 0


@pytest.mark.parametrize("model,fc,pools", [("eco_lite_kinetics", "fc8", 4),
                                            ("eco_full_kinetics", "fc8N", 13)])
def test_bf16_serving_request_takes_k4_at_every_pool(cuda, model, fc, pools):
    graph = get_model(model, batch=2, num_segments=4, crop_size=224)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                                      {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    p = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in p.items()}
    s = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in s.items()}
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s,
                         crop=224, output=fc)
    frames, h_off, w_off, mirror = _batch(cuda, 2, 4, 240, 256, 224)
    k4, k4_3d, route = COUNTS["k4.launches"], COUNTS["k4.launches.3d"], COUNTS["pool.route"]
    s2d_launches = COUNTS["s2d.launches"]
    with torch.no_grad():  # as the benchmark's server
        probs = server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
    torch.cuda.synchronize()
    assert torch.isfinite(probs.float()).all()
    assert COUNTS["k4.launches"] - k4 == pools and COUNTS["pool.route"] == route
    assert COUNTS["k4.launches.3d"] == k4_3d  # every ECO pool is 2D
    assert COUNTS["s2d.launches"] == s2d_launches  # no ECO conv is a 3D stride-2 stem


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 Nesterov step of full-width ECO-Lite at crop 64, S=4, N=2,
    dropout 0, through the raw uint8 plane, TF32 off, card against CPU.

    The bound is F32_UPDATE_REL_L2_BOUND: at this size the f32 step is
    sensitive to the order of its sums (train-mode BN's f32 moments over few
    values).  On the CPU, the same step of this port and of the reference
    differ by 9.7e-3 relative L2 in the update, and the reference's f32
    gradients differ from its own f64 ones by up to 9.0e-3 (the port's by
    5.5e-3); the card sums in yet other orders."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = build_eco_lite(400, 4, crop_size=64, with_loss=True, batch=2, dropout_ratio=0.0)
    params, state = Program(graph, train=True, device="cpu").init(
        torch.Generator().manual_seed(0), {"data": graph.inputs["data"], "label": (2,)})
    frames, h_off, w_off, mirror = (t.cpu() for t in _batch(cuda, 2, 4, 80, 96, 64))
    batch = {"data": frames[None], "h_off": h_off[None], "w_off": w_off[None],
             "mirror": mirror[None], "label": torch.tensor([[3, 397]])}
    cfg = SolverConfig(base_lr=0.005, lr_policy="fixed", momentum=0.9, weight_decay=5e-4,
                       clip_gradients=40.0, solver_type="nesterov")
    updates = []
    for dev in ("cpu", cuda):
        p = {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in params.items()}
        s = {ln: {k: v.to(dev) for k, v in d.items()} for ln, d in state.items()}
        raw = RawPreprocessProgram(Program(graph, train=True, device=dev), crop=64)
        k4, route = COUNTS["k4.launches"], COUNTS["pool.route"]
        ts, metrics = make_train_step(raw, cfg)(init_train_state(p, s), batch)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
        # K4 has no backward: the four pools of the train step keep the route
        assert COUNTS["k4.launches"] == k4
        assert COUNTS["pool.route"] - route == (4 if dev == cuda else 0)
        updates.append(torch.cat([(ts.params[ln][k] - p[ln][k]).flatten().cpu()
                                  for ln in sorted(p) for k in sorted(p[ln])]))
    rel = ((updates[1] - updates[0]).norm() / updates[0].norm()).item()
    assert rel < F32_UPDATE_REL_L2_BOUND, rel


def _qconv_operands(dev, shape, c_out, kernel, groups, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)
    w = torch.randint(-127, 128, (c_out, shape[-1] // groups, *kernel), dtype=torch.int8,
                      device=dev, generator=gen)
    scale_vec = torch.rand(c_out, device=dev, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(c_out, device=dev, generator=gen)
    return x, qconv.kernel_layout(w), scale_vec, bias


@pytest.mark.parametrize("nsp", [1, 2, 3])
@pytest.mark.parametrize("c_in,groups", [(3, 1), (32, 1), (64, 2), (24, 3)])
@pytest.mark.parametrize("stride,pad,dilation", [(1, 0, 1), (2, 1, 1), (1, 2, 2)])
@pytest.mark.parametrize("out", ["f32", "bf16", "int8"])
def test_qconv_equals_plain_version(cuda, nsp, c_in, groups, stride, pad, dilation, out):
    """C_in/g of 32 takes the kernel's cp.async ring (VEC), 3 its tap-row
    path (SPAN; GATHER with dilation), 8 its byte gather (GATHER); C_out 70
    and the output pixels leave ragged tiles."""
    x, w, scale_vec, bias = _qconv_operands(cuda, (2,) + (9,) * nsp + (c_in,), 72 if groups == 3
                                            else 70, (3,) * nsp, groups)
    kw = dict(stride=stride, pad=pad, dilation=dilation, groups=groups)
    if out == "int8":
        kw["out_scale"] = qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw).abs().max().item() / 200
    else:
        kw["out_dtype"] = torch.float32 if out == "f32" else torch.bfloat16
    before = COUNTS["k3.launches"]
    got = qconv.qconv_nd(x, w, scale_vec, bias, **kw)
    torch.cuda.synchronize()
    assert COUNTS["k3.launches"] == before + 1
    assert got.is_contiguous()
    assert torch.equal(got, qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw))


def _qconv_held(x, w, scale_vec, bias, **kw):
    for okw in (dict(out_dtype=torch.float32), dict(out_dtype=torch.bfloat16),
                dict(out_scale=qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw)
                     .abs().max().item() / 200)):
        got = qconv.qconv_nd(x, w, scale_vec, bias, **kw, **okw)
        torch.cuda.synchronize()
        assert torch.equal(got, qconv.qconv_nd_reference(x, w, scale_vec, bias, **kw, **okw)), okw


@pytest.mark.parametrize("shape,c_out,kernel,pad", [
    ((2, 4, 7, 7, 256), 256, (3, 3, 3), 1),   # res5-like: 4 M tiles x 2 N tiles
    ((8, 1, 1, 512), 400, (1, 1), 0),         # the fc: one M tile
    ((3, 5, 5, 96), 70, (3, 3), 1),           # BK 32, ragged N: 9 splits of 3 chunks
])
def test_qconv_split_k_equals_plain_version(cuda, shape, c_out, kernel, pad):
    x, w, scale_vec, bias = _qconv_operands(cuda, shape, c_out, kernel, 1)
    p = qconv.plan_for(x, w, pad=pad)
    assert p.mode == "vec" and p.splits > 1, p
    _qconv_held(x, w, scale_vec, bias, pad=pad)


@pytest.mark.parametrize("shape,stride,pad,offset", [
    ((2, 30, 31, 3), 2, 3, 0),    # conv1's 7x7/s2: taps past every image edge
    ((1, 9, 8, 3), 1, 3, 4),      # a 4-byte offset view: aligned words, not 16 bytes
    ((2, 12, 13, 4), 2, 0, 0),    # C_in 4: 28 bytes a tap row, no padding taps
])
def test_qconv_span_path_masks_the_image_edges(cuda, shape, stride, pad, offset):
    x, w, scale_vec, bias = _qconv_operands(cuda, shape, 64, (7, 7), 1)
    if offset:
        base = torch.zeros(offset + x.numel(), dtype=torch.int8, device=cuda)
        base[offset:] = x.flatten()
        x = base[offset:].view(x.shape)
    assert qconv.plan_for(x, w, stride=stride, pad=pad).mode == "span"
    _qconv_held(x, w, scale_vec, bias, stride=stride, pad=pad)


# Every distinct int8 layer of ECO-Lite and ECO-Full Kinetics at batch 8, 16
# segments, crop 224 (the optimized graphs): input, C_out, kernel, stride, pad
ECO_INT8_LAYERS = {
    "conv1_7x7_s2": ((128, 224, 224, 3), 64, (7, 7), 2, 3),
    "conv2_3x3_reduce": ((128, 56, 56, 64), 64, (1, 1), 1, 0),
    "conv2_3x3": ((128, 56, 56, 64), 192, (3, 3), 1, 1),
    "inception_3a_1x1__merged": ((128, 28, 28, 192), 192, (1, 1), 1, 0),
    "inception_3a_3x3": ((128, 28, 28, 64), 64, (3, 3), 1, 1),
    "inception_3a_double_3x3_1": ((128, 28, 28, 64), 96, (3, 3), 1, 1),
    "inception_3a_double_3x3_2": ((128, 28, 28, 96), 96, (3, 3), 1, 1),
    "inception_3a_pool_proj": ((128, 28, 28, 192), 32, (1, 1), 1, 0),
    "inception_3b_1x1__merged": ((128, 28, 28, 256), 192, (1, 1), 1, 0),
    "inception_3b_pool_proj": ((128, 28, 28, 256), 64, (1, 1), 1, 0),
    "inception_3c_double_3x3_reduce": ((128, 28, 28, 320), 64, (1, 1), 1, 0),
    "inception_3c_double_3x3_reduce__merged": ((128, 28, 28, 320), 192, (1, 1), 1, 0),
    "res3a_2n": ((8, 16, 28, 28, 96), 128, (3, 3, 3), 1, 1),
    "res3b_1": ((8, 16, 28, 28, 128), 128, (3, 3, 3), 1, 1),
    "res4a_1": ((8, 16, 28, 28, 128), 256, (3, 3, 3), 2, 1),
    "res4a_2": ((8, 8, 14, 14, 256), 256, (3, 3, 3), 1, 1),
    "res5a_1": ((8, 8, 14, 14, 256), 512, (3, 3, 3), 2, 1),
    "res5a_2": ((8, 4, 7, 7, 512), 512, (3, 3, 3), 1, 1),
    "fc8": ((8, 1, 1, 512), 400, (1, 1), 1, 0),
    "inception_3c_3x3": ((128, 28, 28, 128), 160, (3, 3), 2, 1),
    "inception_3c_double_3x3_2": ((128, 28, 28, 96), 96, (3, 3), 2, 1),
    "inception_4a_1x1__merged": ((128, 14, 14, 576), 384, (1, 1), 1, 0),
    "inception_4a_3x3": ((128, 14, 14, 64), 96, (3, 3), 1, 1),
    "inception_4a_double_3x3_1": ((128, 14, 14, 96), 128, (3, 3), 1, 1),
    "inception_4a_double_3x3_2": ((128, 14, 14, 128), 128, (3, 3), 1, 1),
    "inception_4a_pool_proj": ((128, 14, 14, 576), 128, (1, 1), 1, 0),
    "inception_4c_1x1__merged": ((128, 14, 14, 576), 416, (1, 1), 1, 0),
    "inception_4c_3x3": ((128, 14, 14, 128), 160, (3, 3), 1, 1),
    "inception_4c_double_3x3_2": ((128, 14, 14, 160), 160, (3, 3), 1, 1),
    "inception_4d_1x1__merged": ((128, 14, 14, 608), 384, (1, 1), 1, 0),
    "inception_4d_3x3": ((128, 14, 14, 128), 192, (3, 3), 1, 1),
    "inception_4d_double_3x3_1": ((128, 14, 14, 160), 192, (3, 3), 1, 1),
    "inception_4d_double_3x3_2": ((128, 14, 14, 192), 192, (3, 3), 1, 1),
    "inception_4d_pool_proj": ((128, 14, 14, 608), 128, (1, 1), 1, 0),
    "inception_4e_3x3_reduce__merged": ((128, 14, 14, 608), 320, (1, 1), 1, 0),
    "inception_4e_3x3": ((128, 14, 14, 128), 192, (3, 3), 2, 1),
    "inception_4e_double_3x3_1": ((128, 14, 14, 192), 256, (3, 3), 1, 1),
    "inception_4e_double_3x3_2": ((128, 14, 14, 256), 256, (3, 3), 2, 1),
    "inception_5a_1x1__merged": ((128, 7, 7, 1056), 704, (1, 1), 1, 0),
    "inception_5a_3x3": ((128, 7, 7, 192), 320, (3, 3), 1, 1),
    "inception_5a_double_3x3_1": ((128, 7, 7, 160), 224, (3, 3), 1, 1),
    "inception_5a_double_3x3_2": ((128, 7, 7, 224), 224, (3, 3), 1, 1),
    "inception_5a_pool_proj": ((128, 7, 7, 1056), 128, (1, 1), 1, 0),
    "inception_5b_1x1__merged": ((128, 7, 7, 1024), 736, (1, 1), 1, 0),
    "inception_5b_3x3": ((128, 7, 7, 192), 320, (3, 3), 1, 1),
    "inception_5b_double_3x3_1": ((128, 7, 7, 192), 224, (3, 3), 1, 1),
    "inception_5b_pool_proj": ((128, 7, 7, 1024), 128, (1, 1), 1, 0),
    "fc8N": ((8, 1, 1, 1536), 400, (1, 1), 1, 0),
}


@pytest.mark.parametrize("name", sorted(ECO_INT8_LAYERS))
def test_qconv_at_every_eco_int8_layer_equals_plain_version(cuda, name):
    shape, c_out, kernel, stride, pad = ECO_INT8_LAYERS[name]
    x, w, scale_vec, bias = _qconv_operands(cuda, shape, c_out, kernel, 1)
    assert qconv.plan_for(x, w, stride=stride, pad=pad).mode == (
        "span" if shape[-1] == 3 else "vec")
    _qconv_held(x, w, scale_vec, bias, stride=stride, pad=pad)


def test_qconv_without_bias_and_on_an_unaligned_input(cuda):
    """A 1-byte offset view: no 16-byte copies, the kernel's byte gather."""
    x, w, scale_vec, _ = _qconv_operands(cuda, (2, 6, 7, 32), 16, (3, 3), 1)
    base = torch.zeros(1 + x.numel(), dtype=torch.int8, device=cuda)
    base[1:] = x.flatten()
    xu = base[1:].view(x.shape)
    assert xu.data_ptr() % 16 != 0
    for xx in (x, xu):
        got = qconv.qconv_nd(xx, w, scale_vec, None, pad=1)
        assert torch.equal(got, qconv.qconv_nd_reference(x, w, scale_vec, None, pad=1))


def test_int8_ops_take_the_kernel_on_the_card(cuda):
    """ops.quant's conv and fc both launch K3, and equal their CPU results."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 8, 8, 16, generator=gen)
    w_q, w_scale = quantize_weight(torch.randn(24, 16, 3, 3, 3, generator=gen))
    fx = torch.randn(4, 40, generator=gen)
    fw_q, fw_scale = quantize_weight(torch.randn(10, 40, generator=gen))
    b = torch.randn(24, generator=gen)
    for out_scale in (None, 0.05):
        before = COUNTS["k3.launches"]
        got = [conv_nd_int8(x.to(cuda), qconv.kernel_layout(w_q).to(cuda), w_scale.to(cuda),
                            b.to(cuda), act_scale=0.02, pad=1, out_scale=out_scale),
               inner_product_int8(fx.to(cuda), fw_q.to(cuda), fw_scale.to(cuda),
                                  act_scale=0.03, out_scale=out_scale)]
        assert COUNTS["k3.launches"] == before + 2
        want = [conv_nd_int8(x, w_q, w_scale, b, act_scale=0.02, pad=1, out_scale=out_scale),
                inner_product_int8(fx, fw_q, fw_scale, act_scale=0.03, out_scale=out_scale)]
        for g, wt in zip(got, want):
            assert torch.equal(g.cpu(), wt)


def test_qconv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w, scale_vec, bias = _qconv_operands(cuda, (2, 6, 7, 32), 16, (3, 3), 1)
    with pytest.raises(ValueError, match="contiguous"):
        qconv.qconv_nd(x.transpose(1, 2), w, scale_vec, bias)
    with pytest.raises(ValueError, match="scale_vec"):
        qconv.qconv_nd(x, w, scale_vec.double(), bias)
    with pytest.raises(ValueError, match="int8"):
        qconv.qconv_nd(x.float(), w, scale_vec, bias)
    with pytest.raises(ValueError, match="groups"):
        qconv.qconv_nd(x, w, scale_vec, bias, groups=3)
    with pytest.raises(ValueError, match="kernel_layout"):
        qconv.qconv_nd(x, w.contiguous(), scale_vec, bias)


@pytest.mark.parametrize("shape,kernel,stride,pad", [
    ((4, 112, 112, 64), 3, 2, 0), ((2, 28, 28, 96), 3, 1, 1), ((2, 15, 15, 8), 3, 2, 0)])
def test_int8_max_pool_on_card_matches_cpu(cuda, shape, kernel, stride, pad):
    """The int8 max pool of the int8 chains (integer-minimum padding, no K2)
    equals the CPU's."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen)
    want = pool_nd(x, kernel=kernel, stride=stride, pad=pad, mode="max")
    before = COUNTS["k2.launches"]
    got = pool_nd(x.to(cuda), kernel=kernel, stride=stride, pad=pad, mode="max")
    assert COUNTS["k2.launches"] == before
    assert got.dtype == torch.int8 and torch.equal(got.cpu(), want)


def test_resize_on_card_matches_cpu_with_tf32_switched_on(cuda):
    """The multi-scale plane's two products run in full f32 whatever the
    process asks of f32 matmuls: with TF32 on everywhere the card equals
    the CPU within 1e-4 on sampled windows, and at a full-size window it is
    K1's f32 crop, bit for bit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        frames, h_off, w_off, mirror = _batch(cuda, 2, 4, 256, 340, 224)
        gen = torch.Generator().manual_seed(1)
        crop_h = torch.randint(168, 257, (2,), generator=gen)
        crop_w = torch.randint(168, 257, (2,), generator=gen)
        args = (torch.randint(0, 257, (2,), generator=gen) % (257 - crop_h),
                torch.randint(0, 341, (2,), generator=gen) % (341 - crop_w),
                crop_h, crop_w, mirror.cpu())
        kw = dict(crop=224, mean=MEAN, out_dtype=torch.float32)
        got = preprocess_resize_on_device(frames, *args, **kw)
        want = preprocess_resize_on_device(frames.cpu(), *args, **kw)
        assert torch.get_float32_matmul_precision() == "high"
        assert (got.cpu() - want).abs().max().item() <= 1e-4
        full = torch.full((2,), 224)
        k1 = preprocess.preprocess_on_device(frames, h_off, w_off, mirror, **kw)
        assert torch.equal(preprocess_resize_on_device(frames, h_off, w_off, full, full,
                                                       mirror, **kw), k1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = old[:2]
        torch.set_float32_matmul_precision(old[2])


def test_remat_step_on_card_equals_the_plain_step(cuda):
    """ECO-Lite at crop 64, S=4, N=2, bf16, dropout 0.5, through the raw
    plane under cudnn.deterministic: the "dots" and "nothing" steps give the
    plain step's loss and params bit for bit."""
    graph = build_eco_lite(400, 4, crop_size=64, with_loss=True, batch=2, dropout_ratio=0.5)
    prog = RawPreprocessProgram(
        Program(graph, train=True, compute_dtype=torch.bfloat16, device=cuda), crop=64)
    frames, h_off, w_off, mirror = _batch(cuda, 2, 4, 80, 96, 64)
    batch = {"data": frames[None], "h_off": h_off[None], "w_off": w_off[None],
             "mirror": mirror[None], "label": torch.tensor([[3, 397]], device=cuda)}
    ts = init_train_state(*prog.init(torch.Generator().manual_seed(0),
                                     {k: v[0] for k, v in batch.items()}))
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for policy in (None, "dots", "nothing"):
            step = make_train_step(prog, SolverConfig(clip_gradients=40.0), remat=policy)
            runs[policy] = step(ts, batch, torch.Generator().manual_seed(7))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    want, wm = runs[None]
    for policy in ("dots", "nothing"):
        got, gm = runs[policy]
        assert torch.equal(gm["loss"], wm["loss"]), policy
        for ln in want.params:
            for k in want.params[ln]:
                assert torch.equal(got.params[ln][k], want.params[ln][k]), (policy, ln, k)


def test_world1_nccl_dp_step_equals_the_plain_step(cuda):
    """A world-1 NCCL group on the card: the data-parallel step (SyncBN, the
    gradient all-reduce before the clip) gives the plain step's loss, params
    and BN statistics bit for bit under cudnn.deterministic: every
    all-reduce of one rank is the identity and the division by 1 is exact."""
    import socket

    from eco_tpu_torch.parallel import distributed_init, make_mesh, make_sharded_train_step

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    graph = build_eco_lite(400, 4, crop_size=64, with_loss=True, batch=2, dropout_ratio=0.5)
    prog = RawPreprocessProgram(
        Program(graph, train=True, compute_dtype=torch.bfloat16, device=cuda), crop=64)
    frames, h_off, w_off, mirror = _batch(cuda, 2, 4, 80, 96, 64)
    batch = {"data": frames[None], "h_off": h_off[None], "w_off": w_off[None],
             "mirror": mirror[None], "label": torch.tensor([[3, 397]], device=cuda)}
    ts = init_train_state(*prog.init(torch.Generator().manual_seed(0),
                                     {k: v[0] for k, v in batch.items()}))
    cfg = SolverConfig(clip_gradients=40.0)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    distributed_init(device="cuda:0", init_method=f"tcp://localhost:{port}", world_size=1,
                     rank=0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        want, wm = make_train_step(prog, cfg)(ts, batch, torch.Generator().manual_seed(7))
        got, gm = make_sharded_train_step(prog, cfg, make_mesh())(
            ts, batch, torch.Generator().manual_seed(7))
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    assert torch.equal(gm["loss"], wm["loss"])
    for tree in ("params", "state"):
        for ln, lp in getattr(want, tree).items():
            for k, v in lp.items():
                assert torch.equal(getattr(got, tree)[ln][k], v), (tree, ln, k)


def _every_card_rank(rank, world, port, outdir):
    """One rank a card over NCCL: one f32 data-parallel step with SyncBN of
    ECO-Lite at crop 64 on its 2 videos of the seeded global batch."""
    from eco_tpu_torch.parallel import (
        distributed_init, make_mesh, make_sharded_train_step, shard_batch,
    )
    from eco_tpu_torch.parallel.multiprocess import params_digest

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = f"cuda:{rank}"
    distributed_init(device=dev, init_method=f"tcp://localhost:{port}", world_size=world,
                     rank=rank)
    try:
        prog, ts, batch = _every_card_setup(dev, 2 * world)
        mesh = make_mesh()
        ts, m = make_sharded_train_step(prog, SolverConfig(clip_gradients=40.0), mesh)(
            ts, shard_batch(mesh, batch, batch_axis=1))
        torch.save({"digest": params_digest(ts.params), "loss": float(m["loss"]),
                    "params": {ln: {k: v.cpu() for k, v in lp.items()}
                               for ln, lp in ts.params.items()}},
                   f"{outdir}/{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _every_card_setup(dev, videos):
    graph = build_eco_lite(400, 4, crop_size=64, with_loss=True, batch=videos,
                           dropout_ratio=0.0)
    prog = Program(graph, train=True, device=dev)
    gen = torch.Generator().manual_seed(0)
    batch = {"data": torch.randn((1, videos, 4, 64, 64, 3), generator=gen) * 50,
             "label": torch.randint(0, 400, (1, videos), generator=gen)}
    ts = init_train_state(*prog.init(torch.Generator().manual_seed(0),
                                     {k: v[0] for k, v in batch.items()}))
    return prog, ts, batch


def test_nccl_data_parallel_over_every_card(tmp_path):
    """One rank a card over NCCL (needs two cards or more): every rank ends
    with the same params, and the update is within 5e-2 of one process's
    f32 step over the global batch (the f32 order bound)."""
    import socket

    import torch.multiprocessing as mp

    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2:
        pytest.skip("needs two CUDA devices or more")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_every_card_rank, args=(world, port, str(tmp_path)), nprocs=world,
                       start_method="spawn")
    ranks = [torch.load(tmp_path / f"{r}.pt") for r in range(world)]
    assert len({r["digest"] for r in ranks}) == 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    prog, ts, batch = _every_card_setup("cuda:0", 2 * world)
    one, _ = make_train_step(prog, SolverConfig(clip_gradients=40.0))(ts, batch)
    keys = [(ln, k) for ln in sorted(ts.params) for k in sorted(ts.params[ln])]
    start = torch.cat([ts.params[ln][k].flatten().cpu() for ln, k in keys])
    want = torch.cat([one.params[ln][k].flatten().cpu() for ln, k in keys]) - start
    got = torch.cat([ranks[0]["params"][ln][k].flatten() for ln, k in keys]) - start
    assert ((got - want).norm() / want.norm()).item() <= F32_UPDATE_REL_L2_BOUND


def test_multiprocess_trains_one_process_a_card(cuda, tmp_path):
    """``python -m eco_tpu_torch.parallel.multiprocess`` on its default
    device: one process a card over NCCL, cursor-sharded pipelines, equal
    params digests and snapshots from process 0 alone."""
    from eco_tpu_torch.parallel.multiprocess import launch_simulated_multihost

    n = torch.cuda.device_count()
    info = launch_simulated_multihost(n, workdir=str(tmp_path), timeout=300, iters=2)
    assert info["ok"] and info["device"] == "cuda" and info["num_processes"] == n
    assert info["snapshots"] == ["mh_iter_2.model.npz", "mh_iter_2.solverstate.npz"]
    with pytest.raises(ValueError, match="cards"):
        launch_simulated_multihost(n + 1, workdir=str(tmp_path / "x"))


def test_aot_optimizes_and_calibrates_on_the_card(cuda, tmp_path):
    """``eco aot`` on its default device: the weights load, fold and
    calibrate on the card, the trace runs on CPU copies.  The float artifact
    equals the one made with ``--device cpu`` within the f32 card-vs-CPU
    bound (1e-4).  The ``--int8`` one (plain K3 inside) equals, within the
    int8 card bound (2.2e-2), the program that the CLI's calibration gives
    on the card, run through K3: calibrated on the card (TF32 convs), its
    scales are not the CPU's."""
    from eco_tpu_torch.convert import load_serving_artifact
    from eco_tpu_torch.spec.graph import graph_to_json
    from eco_tpu_torch.tools.cli import main
    from eco_tpu_torch.train import load_model, save_model

    graph = build_eco_lite(10, 4, crop_size=64, with_loss=False, batch=2)
    gpath = tmp_path / "lite.graph.json"
    gpath.write_text(graph_to_json(graph))
    wpath = str(tmp_path / "lite.npz")
    save_model(wpath, *Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                                         {"data": graph.inputs["data"]}))
    clips = torch.randn((2, 4, 64, 64, 3), generator=torch.Generator().manual_seed(1)) * 50
    argv = ["aot", "--net", str(gpath), "--weights", wpath, "--batch", "2", "--segments", "4"]

    def artifact(name, *extra):
        main([*argv, "-o", str(tmp_path / name), *extra])
        return load_serving_artifact(str(tmp_path / name), device="cuda")(clips).float().cpu()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    card = artifact("card.pt2")
    assert tuple(card.shape) == (2, 10) and torch.isfinite(card).all()
    assert rel(card, artifact("cpu.pt2", "--device", "cpu")) <= 1e-4
    # the CLI's int8 path on the card, reproduced: fold, calibrate on its
    # seeded random batch, quantize
    got = artifact("int8.pt2", "--int8")
    folded = optimize_for_inference(graph, *load_model(wpath, device=cuda))
    calib = {"data": (60.0 * torch.randn(graph.inputs["data"],
                                         generator=torch.Generator().manual_seed(0))).to(cuda)}
    with torch.no_grad():
        qprog, qp, qs, _ = quantize_for_serving(Program(folded[0], device=cuda), *folded[1:],
                                                [calib])
        want = qprog.apply(qp, qs, {"data": clips.to(cuda)})[0]["probs"].float().cpu()
    assert rel(got, want) <= 2.2e-2


def test_time_layers_on_card_is_above_every_floor(cuda):
    """Each layer's forward and backward time of a small bf16 ECO-Lite on
    the card: finite, and above at least one of its floors (time_layers
    raises otherwise); a time below both raises."""
    graph = build_eco_lite(400, 4, crop_size=112, batch=4)
    prog = Program(graph, train=True, compute_dtype=torch.bfloat16, device=cuda)
    data = torch.randn(graph.inputs["data"], device=cuda)
    params, state = prog.init(torch.Generator().manual_seed(0), {"data": data})
    rows = profiler.time_layers(prog, params, state, {"data": data}, iters=3, backward=True)
    assert [r[0] for r in rows] == [l.name for l in prog.exec_layers]
    assert all(np.isfinite(r[2]) and r[2] > 0 for r in rows)
    convs = [r for r in rows if r[1] == "convolution"]
    assert convs and all(np.isfinite(r[3]) for r in convs)
    with pytest.raises(RuntimeError, match="timer"):
        profiler._check_floor("conv", "forward", 1e-6, 1e9, 1e9, torch.bfloat16)


def test_int8_probe_conv_step_equals_plain_version(cuda):
    """The int8 probe's conv on the card: K3 at the reference's serving
    shape, (1536, 28, 28, 96) 3x3 pad 1 -> 96, with the int8-out epilogue,
    equal to its plain version; the probe's matmul step's shape is one
    ``torch._int_mm`` takes."""
    from eco_tpu_torch.tools import int8_probe

    _, _, x, w = int8_probe.conv_operands(1536, 28, 96, cuda)
    ones = torch.ones(96, dtype=torch.float32, device=cuda)
    k3_0 = COUNTS["k3.launches"]
    got = int8_probe.int8_conv_step(x, w, ones)
    assert COUNTS["k3.launches"] == k3_0 + 1
    want = qconv.qconv_nd_reference(x, w, ones, None, pad=1,
                                    out_scale=int8_probe.CONV_OUT_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _, _, xi, wi = int8_probe.matmul_operands(256, cuda)
    step = int8_probe.int8_matmul_step(xi, wi)
    assert torch.equal(step.cpu(), int8_probe.int8_matmul_step(xi.cpu(), wi.cpu()))


# -- Video Swin on the card ------------------------------------------------------

SWIN_SMALL = dict(embed_dim=64, depths=[2, 2, 2, 2], num_heads=[2, 4, 8, 16])
SWIN_MEAN = (103.53, 116.28, 123.675)
SWIN_STD = (58.395, 57.12, 57.375)


def _swin_case(dev, frames=16, crop=112, n=2):
    """A small Video Swin (head dimension 32, the published window), its
    reference's weights on ``dev``, smooth frames and the f32 reference's
    logits with TF32 off: stage grids (8, 28, 28) ... (8, 4, 4), shifted
    and masked windows in the first two stages, clipped ones after."""
    import reference_video_swin as ref
    from portbench import load

    cfg = dict(num_classes=400, num_segments=frames, crop_size=crop, mean_bgr=list(SWIN_MEAN),
               std_rgb=list(SWIN_STD), **SWIN_SMALL)
    net = ref.net(cfg)
    g = torch.Generator().manual_seed(2**31 + 29)
    params = {}
    for s in ref.param_specs(net, cfg)[0]:
        u = torch.rand(s.shape, generator=g)
        v = (-s.laplace * (u - 0.5).sign() * torch.log1p(-2 * (u - 0.5).abs())
             if s.laplace > 0 else u * (s.high - s.low) + s.low)
        params.setdefault(s.layer, {})[s.name] = v.to(dev)
    spec = {"kind": "smooth", "scales": [[4, 5, 1.0], [12, 16, 0.6], [40, 53, 0.35]],
            "drift": 0.5, "chroma": 0.35, "brightness": [60, 190], "contrast": [8, 64],
            "noise": 3.0}
    raw = load.smooth_frames((n, frames, crop + 16, crop + 20, 3), spec,
                             torch.Generator(device=dev).manual_seed(3), dev)
    aug = ([5, 11][:n], [0, 17][:n], [1, 0][:n])
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = ref.forward(net, params, {}, ref.clips(cfg, raw, *aug)).double()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    graph = get_model("video_swin_b_kinetics", num_frames=frames, crop_size=crop, batch=n,
                      **SWIN_SMALL)
    return graph, params, raw, aug, want


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_bf16_video_swin_serving_against_the_f32_reference(cuda):
    """The bf16 program through ``UInt8Server`` on the card: within 0.1 of
    the f32 reference's logits (bf16 over 8 blocks of random weights, and
    the bf16 clips' rounding of x - mean), and each attention core on the
    card once a block."""
    graph, params, raw, aug, want = _swin_case(cuda)
    g, p, s = optimize_for_inference(graph, params, {})
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s, crop=112,
                         mean=SWIN_MEAN, output="cls_head.fc_cls")
    before = COUNTS["attn.flops"]
    with torch.no_grad():
        got = server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
    assert got.dtype == torch.bfloat16
    assert COUNTS["attn.flops"] > before
    assert _rel(got.float().cpu(), want.cpu()) < 0.1


def test_f32_video_swin_program_on_the_card_equals_the_reference(cuda):
    """f32 clips through the f32 program on the card (TF32 off, the library's
    attention in f32) against the f32 reference on the card: within 1e-4."""
    graph, params, raw, aug, want = _swin_case(cuda)
    g, p, s = optimize_for_inference(graph, params, {})
    clips = preprocess.preprocess_on_device(raw, *aug, crop=112, mean=SWIN_MEAN,
                                            out_dtype=torch.float32)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            outs, _ = Program(g, compute_dtype=torch.float32, device=cuda).apply(
                p, s, {"data": clips}, capture=["cls_head.fc_cls"])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert _rel(outs["cls_head.fc_cls"], want) < 1e-4


@pytest.mark.parametrize("shift", [(0, 0, 0), (4, 3, 3)], ids=["plain", "shifted"])
def test_window_attention_bf16_on_the_card_against_f32(cuda, shift):
    """The window attention op at stage 1's geometry (2 clips of a 16 x 56 x
    56 grid, 4 heads, d 32) in bf16 on the card against the op in f32 on
    the card: within 2e-2 (bf16 inputs and outputs, the softmax in f32
    inside the fused kernel)."""
    from eco_tpu_torch.ops import attention

    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((2, 16, 56, 56, 384), generator=g, device=cuda)
    table = torch.rand((15 * 13 * 13, 4), generator=g, device=cuda) * 2 - 1
    kw = dict(heads=4, window=(8, 7, 7), shift=shift, table_window=(8, 7, 7),
              size=(16, 56, 56))
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = attention.window_attention(qkv, table, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    got = attention.window_attention(qkv.bfloat16(), table, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 56, 56, 128)
    assert _rel(got.float(), want) < 2e-2


# -- K6: the window attention kernel -----------------------------------------------

# Swin-B's stage geometries at 2 clips: grid, heads, the shifted block's shift
SWIN_B_STAGES = {
    "stage1": ((16, 56, 56), 4, (4, 3, 3)),
    "stage2": ((16, 28, 28), 8, (4, 3, 3)),
    "stage3": ((16, 14, 14), 16, (4, 3, 3)),
    "stage4": ((16, 7, 7), 32, (4, 0, 0)),
}


def _k6_case(dev, grid, heads, table_window=(8, 7, 7), n=2, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((n, *grid, 3 * heads * 32), generator=g, device=dev) * 1.5
    rows = (2 * table_window[0] - 1) * (2 * table_window[1] - 1) * (2 * table_window[2] - 1)
    table = torch.rand((rows, heads), generator=g, device=dev) * 2 - 1
    return qkv, table


def _k6_against_the_route(qkv, table, dtype, **kw):
    """K6 and the route in ``dtype``, each against the route in f32 (TF32
    off); K6 must launch once and come within 1.25x the route's own error
    plus 1e-4, and within 1e-2 (bf16) / 1.5e-3 (f16) of the route."""
    from eco_tpu_torch.ops import attention

    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = attention.window_attention_reference(qkv, table, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    x = qkv.to(dtype)
    before = COUNTS.copy()
    got = attention.window_attention(x, table, **kw)
    torch.cuda.synchronize()
    counts = {k: COUNTS[k] - before[k] for k in ("k6.launches", "attn.flops", "attn.bytes")}
    assert counts["k6.launches"] == 1
    before = COUNTS.copy()
    lib = attention.window_attention_reference(x, table, **kw)
    # the same work counted, whichever route runs
    assert {k: COUNTS[k] - before[k] for k in ("attn.flops", "attn.bytes")} == {
        k: counts[k] for k in ("attn.flops", "attn.bytes")}
    assert got.dtype == dtype and got.shape == lib.shape
    err, lib_err = _rel(got.float(), want), _rel(lib.float(), want)
    assert err <= 1.25 * lib_err + 1e-4, (err, lib_err)
    assert _rel(got.float(), lib.float()) < (1e-2 if dtype == torch.bfloat16 else 1.5e-3)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("stage", sorted(SWIN_B_STAGES))
def test_k6_equals_the_route_at_swin_b_stages(cuda, stage, shifted, dtype):
    """K6 at each Swin-B stage's geometry (2 clips, d 32), unshifted and
    shifted, against the route, with the same counters."""
    grid, heads, shift = SWIN_B_STAGES[stage]
    qkv, table = _k6_case(cuda, grid, heads)
    _k6_against_the_route(qkv, table, dtype, heads=heads, window=(8, 7, 7),
                          shift=shift if shifted else (0, 0, 0), table_window=(8, 7, 7),
                          size=grid)


@pytest.mark.parametrize("case", ["clipped", "unequal", "padded", "bf16_table"])
def test_k6_clipped_unequal_and_padded_windows(cuda, case):
    """K6 with a window clipped below its table window (the bias of the
    table's first L rows and columns), unequal windows with a shift on two
    axes, a padded grid cropped by index, and a bf16 table."""
    grid, window, shift, tw, size, heads = {
        "clipped": ((8, 4, 4), (8, 4, 4), (4, 0, 0), (8, 7, 7), (8, 4, 4), 2),
        "unequal": ((6, 8, 10), (2, 4, 5), (1, 0, 2), (3, 4, 5), (6, 8, 10), 3),
        "padded": ((16, 14, 14), (8, 7, 7), (4, 3, 3), (8, 7, 7), (10, 12, 13), 2),
        "bf16_table": ((16, 14, 14), (8, 7, 7), (4, 3, 3), (8, 7, 7), (16, 14, 14), 2),
    }[case]
    qkv, table = _k6_case(cuda, grid, heads, tw)
    if case == "bf16_table":
        table = table.bfloat16()
    got = _k6_against_the_route(qkv, table, torch.bfloat16, heads=heads, window=window,
                                shift=shift, table_window=tw, size=size)
    assert got.shape == (2, *size, heads * 32)


@pytest.mark.parametrize("case", ["f32", "grad", "head_width_64", "cpu_table"])
def test_k6_leaves_what_it_does_not_take_to_the_route(cuda, case):
    """f32 tokens, a gradient, a head width other than 32 and a table on
    another device take the route: no K6 launch, the route's result."""
    from eco_tpu_torch.ops import attention

    heads = 2
    qkv, table = _k6_case(cuda, (8, 14, 14), heads)
    if case == "head_width_64":
        qkv = torch.cat([qkv, qkv], dim=-1)  # 2 heads of 64
    qkv = qkv if case == "f32" else qkv.bfloat16()
    if case == "grad":
        qkv.requires_grad_(True)
    if case == "cpu_table":
        table = table.cpu()
    kw = dict(heads=heads, window=(8, 7, 7), shift=(4, 3, 3), table_window=(8, 7, 7),
              size=(8, 14, 14))
    before = COUNTS["k6.launches"]
    if case == "cpu_table":
        with pytest.raises(RuntimeError):  # the route too wants the table on the card
            attention.window_attention(qkv, table, **kw)
    else:
        got = attention.window_attention(qkv, table, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, attention.window_attention_reference(qkv, table, **kw))
    assert COUNTS["k6.launches"] == before


def test_k6_entry_refuses_a_geometry_it_does_not_take(cuda):
    """The C entry point launches nothing and returns cudaErrorInvalidValue
    (1) for a grid that is not whole windows, a shift not under the window,
    an output larger than the grid and a misaligned pointer."""
    from eco_tpu_torch.ops import attention

    qkv, table = _k6_case(cuda, (8, 14, 14), 2)
    qkv = qkv.bfloat16()
    out = torch.zeros((2, 8, 14, 14, 64), dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ok = (2, 8, 14, 14, 2, 8, 7, 7, 4, 3, 3, 8, 7, 7, 8, 14, 14, 1)
    call = lambda q, args: attention._kernel()(q, table.data_ptr(), out.data_ptr(), *args,
                                              stream)
    assert call(qkv.data_ptr(), ok) == 0
    torch.cuda.synchronize()
    for args in (ok[:1] + (8, 14, 13) + ok[4:14] + (8, 14, 13, 1),    # W not whole windows
                 ok[:8] + (8, 3, 3) + ok[11:],                       # shift = window
                 ok[:14] + (9, 14, 14, 1)):                          # output over the grid
        assert call(qkv.data_ptr(), args) == 1
    assert call(qkv.data_ptr() + 2, ok) == 1
    torch.cuda.synchronize()


def test_k6_in_serving_requests(cuda):
    """A bf16 Video Swin request through ``UInt8Server`` launches K6 once a
    block, makes no ``eco.window`` span and no library attention call, and
    keeps no shifted bias; an ECO request launches K6 0 times."""
    from eco_tpu_torch.ops import attention

    graph, params, raw, aug, _ = _swin_case(cuda)
    g, p, s = optimize_for_inference(graph, params, {})
    blocks = sum(layer.type == "window_attention" for layer in g.layers)
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s, crop=112,
                         mean=SWIN_MEAN, output="cls_head.fc_cls")
    cached = len(attention._BIAS)
    before = COUNTS["k6.launches"]
    with torch.no_grad(), torch.profiler.profile() as prof:
        server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
        torch.cuda.synchronize()
    assert COUNTS["k6.launches"] - before == blocks == 8, (COUNTS["k6.launches"] - before, blocks)
    names = {e.name for e in prof.events()}
    assert "eco.window" not in names and "eco.attn" in names, sorted(names)
    assert not [n for n in names if "scaled_dot_product" in n or "sdpa" in n], sorted(names)
    assert len(attention._BIAS) == cached, (len(attention._BIAS), cached)

    graph = get_model("eco_lite_kinetics", batch=2, num_segments=4, crop_size=224)
    params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                                      {"data": graph.inputs["data"]})
    g, p, s = optimize_for_inference(graph, params, state)
    p = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in p.items()}
    s = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in s.items()}
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s, crop=224)
    frames, h_off, w_off, mirror = _batch(cuda, 2, 4, 240, 256, 224)
    before = COUNTS["k6.launches"]
    with torch.no_grad():
        server(frames, h_off=h_off, w_off=w_off, mirror=mirror)
    torch.cuda.synchronize()
    assert COUNTS["k6.launches"] == before
    # nor has I3D a window attention layer to launch it
    i3d = get_model("i3d_rgb_kinetics", batch=1, num_frames=16, crop_size=112)
    assert not any(layer.type == "window_attention" for layer in i3d.layers)


# -- MViTv2 on the card ------------------------------------------------------------

MVIT_SMALL = dict(embed_dim=96, depth=4, num_heads=1, dim_mul_blocks=[1, 3], kv_stride=[1, 4, 4])
MVIT_MEAN = (114.75,) * 3


def _mvit_case(dev, frames=16, crop=64, n=2):
    """A small MViTv2 (d 96 in every block; grids (8, 16, 16), (8, 8, 8),
    (8, 4, 4); keys coarser than queries, equal, and finer), its
    reference's weights on ``dev``, smooth frames and the f32 reference's
    logits with TF32 off."""
    import reference_mvit as ref
    from portbench import load

    cfg = dict(num_classes=400, num_segments=frames, crop_size=crop, mean_bgr=list(MVIT_MEAN),
               std_rgb=[57.375] * 3, **MVIT_SMALL)
    net = ref.net(cfg)
    g = torch.Generator().manual_seed(2**31 + 25)
    params = {}
    for s in ref.param_specs(net, cfg)[0]:
        u = torch.rand(s.shape, generator=g)
        v = (-s.laplace * (u - 0.5).sign() * torch.log1p(-2 * (u - 0.5).abs())
             if s.laplace > 0 else u * (s.high - s.low) + s.low)
        params.setdefault(s.layer, {})[s.name] = v.to(dev)
    spec = {"kind": "smooth", "scales": [[4, 5, 1.0], [12, 16, 0.6], [40, 53, 0.35]],
            "drift": 0.5, "chroma": 0.35, "brightness": [60, 190], "contrast": [8, 64],
            "noise": 3.0}
    raw = load.smooth_frames((n, frames, crop + 16, crop + 20, 3), spec,
                             torch.Generator(device=dev).manual_seed(3), dev)
    aug = ([5, 11][:n], [0, 17][:n], [1, 0][:n])
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = ref.forward(net, params, {}, ref.clips(cfg, raw, *aug)).double()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    graph = get_model("mvit_v2_b_kinetics", num_frames=frames, crop_size=crop, batch=n,
                      **MVIT_SMALL)
    return graph, params, raw, aug, want


def test_bf16_mvit_serving_against_the_f32_reference(cuda):
    """The bf16 program through ``UInt8Server`` on the card: within 0.1 of
    the f32 reference's logits (bf16 over 4 blocks of random weights, and
    the bf16 clips' rounding of x - 114.75); every core counted, the skip
    pools on K4, the q/k/v pooling on K7 (once a block: no depthwise conv,
    no layout conversion)."""
    graph, params, raw, aug, want = _mvit_case(cuda)
    g, p, s = optimize_for_inference(graph, params, {})
    server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s, crop=64,
                         mean=MVIT_MEAN, output="head.projection")
    before = COUNTS.copy()
    with torch.no_grad(), torch.profiler.profile() as prof:
        got = server(raw, h_off=aug[0], w_off=aug[1], mirror=aug[2])
        torch.cuda.synchronize()
    counts = COUNTS - before
    assert got.dtype == torch.bfloat16
    assert counts["pattn.flops"] > 0 and counts["k4.launches"] == 2 and not counts["pool.route"]
    assert counts["k7.launches"] == 4
    kernels = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("qkv_pool_kernel" in k for k in kernels), sorted(kernels)
    assert not any("conv_depthwise3d" in k for k in kernels), sorted(kernels)
    assert not any("tensorTransform" in k for k in kernels), sorted(kernels)
    assert _rel(got.float().cpu(), want.cpu()) < 0.1


def test_f32_mvit_program_on_the_card_equals_the_reference(cuda):
    """f32 clips through the f32 program on the card (TF32 off, the
    library's attention in f32) against the f32 reference on the card:
    within 1e-4."""
    graph, params, raw, aug, want = _mvit_case(cuda)
    g, p, s = optimize_for_inference(graph, params, {})
    clips = preprocess.preprocess_on_device(raw, *aug, crop=64, mean=MVIT_MEAN,
                                            out_dtype=torch.float32)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            outs, _ = Program(g, compute_dtype=torch.float32, device=cuda).apply(
                p, s, {"data": clips}, capture=["head.projection"])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert _rel(outs["head.projection"], want) < 1e-4


@pytest.mark.parametrize("heads,size,stride_q,stride_kv", [
    (1, (16, 56, 56), (1, 1, 1), (1, 8, 8)),
    (2, (16, 56, 56), (1, 2, 2), (1, 4, 4)),
    (8, (16, 14, 14), (1, 2, 2), (1, 1, 1)),
], ids=["block0", "block2", "block21"])
def test_pooled_attention_bf16_on_the_card_against_f32(cuda, heads, size, stride_q, stride_kv):
    """The pooled attention op at MViTv2-B's geometries (2 clips, d 96:
    keys coarser than queries, both strided, queries coarser) in bf16 on
    the card against the op in f32 on the card: within 2e-2 (bf16 inputs,
    position columns and outputs, the softmax in f32 inside the fused
    kernel)."""
    from eco_tpu_torch.ops import pooled_attention as pa

    g = torch.Generator(device=cuda).manual_seed(5)
    d, n = 96, 2
    c = heads * d
    qkv = torch.randn((n, 1 + math.prod(size), 3 * c), generator=g, device=cuda)
    q, k = (pa.pooled_size(size, (3, 3, 3), s, (1, 1, 1)) for s in (stride_q, stride_kv))
    params = {}
    for s in "qkv":
        params[f"pool_{s}.w"] = torch.randn((d, 1, 3, 3, 3), generator=g, device=cuda) / 5
        params[f"norm_{s}.gamma"] = torch.rand(d, generator=g, device=cuda) + 0.5
        params[f"norm_{s}.beta"] = torch.rand(d, generator=g, device=cuda) - 0.5
    for axis, qs, ks in zip("thw", q, k):
        params[f"rel_pos_{axis}"] = (torch.rand((2 * max(qs, ks) - 1, d), generator=g,
                                                device=cuda) - 0.5) * 0.14
    kw = dict(heads=heads, size=size, stride_q=stride_q, stride_kv=stride_kv, kernel=(3, 3, 3),
              eps=1e-6)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want, want_size = pa.pooled_attention(qkv, params, **kw)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    with torch.no_grad():
        got, got_size = pa.pooled_attention(qkv.bfloat16(), params, **kw)
    assert got_size == want_size == q
    assert got.dtype == torch.bfloat16 and got.shape == (n, 1 + math.prod(q), c)
    assert _rel(got.float(), want) < 2e-2


# -- K7: MViTv2's q/k/v pooling ------------------------------------------------------


def _k7_case(dev, size, heads, d=96, n=MVIT_CLIPS, seed=7, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((n, 1 + math.prod(size), 3 * heads * d), generator=g, device=dev)
    params = {}
    for s in "qkv":
        params[f"pool_{s}.w"] = torch.randn((d, 1, 3, 3, 3), generator=g, device=dev) / 5
        params[f"norm_{s}.gamma"] = torch.rand(d, generator=g, device=dev) + 0.5
        params[f"norm_{s}.beta"] = torch.rand(d, generator=g, device=dev) - 0.5
    return qkv.to(dtype), params


def _k7_against_its_plain_version(qkv, params, **kw):
    """K7 once, against its plain version on the same rows: the same grids,
    within 2e-4 in relative L2 (both sum and norm in f32 and round once; the
    order of the sums differs, so a value now and then rounds to the next
    bf16 or f16 step), the same ``qkv_pool.bytes`` as the route counts; the
    route within 1e-2 of the plain version (it rounds the conv's output and
    gamma and beta to the rows' type)."""
    from eco_tpu_torch.ops import pooled_attention as pa

    before = COUNTS.copy()
    with torch.no_grad():
        got = pa.pool_qkv(qkv, params, **kw)
        torch.cuda.synchronize()
        counted = {k: COUNTS[k] - before[k] for k in ("k7.launches", "qkv_pool.bytes")}
        plain = pa.pool_qkv_plain(qkv, params, **kw)
        before = COUNTS["qkv_pool.bytes"]
        route = pa.pool_qkv(qkv.float(), params, **kw)  # f32 takes the route
    assert counted["k7.launches"] == 1
    assert counted["qkv_pool.bytes"] == 2 * (COUNTS["qkv_pool.bytes"] - before) // 4
    assert got[3:] == plain[3:]
    for mine, want, lib in zip(got[:3], plain[:3], route[:3]):
        assert mine.dtype == qkv.dtype and mine.shape == want.shape
        assert _rel(mine.float(), want.float()) < 2e-4
        assert _rel(lib.float(), want.float()) < 1e-2
    return got


@pytest.mark.parametrize("block", sorted(MVIT_BLOCKS))
def test_k7_equals_its_plain_version_at_mvit_b_blocks(cuda, block):
    """K7 in bf16 at each kind of MViTv2-B block (every one of the 24 is one
    of these: ``chip_smoke.MVIT_BLOCKS``), 10 clips, d 96."""
    size, heads, stride_q, stride_kv, _ = MVIT_BLOCKS[block]
    qkv, params = _k7_case(cuda, size, heads)
    _k7_against_its_plain_version(qkv, params, heads=heads, size=size, stride_q=stride_q,
                                  stride_kv=stride_kv, kernel=(3, 3, 3), eps=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("case", ["odd", "long_t", "narrow", "one_frame"])
def test_k7_odd_grids_stretches_of_t_and_narrow_heads(cuda, case, dtype):
    """K7 at odd grids (tiles cut by the grid's edge), a T that the host
    splits into stretches with a short last one (17 frames, few tiles), a
    head of 16 channels and a clip of one frame, in bf16 and f16."""
    size, heads, d, stride_q, stride_kv = {
        "odd": ((3, 9, 11), 2, 96, (1, 2, 2), (1, 8, 8)),
        "long_t": ((17, 9, 11), 2, 96, (1, 1, 1), (1, 4, 4)),
        "narrow": ((4, 13, 6), 3, 16, (1, 1, 1), (1, 2, 2)),
        "one_frame": ((1, 15, 15), 1, 96, (1, 2, 2), (1, 4, 4)),
    }[case]
    qkv, params = _k7_case(cuda, size, heads, d=d, n=3, dtype=dtype)
    _k7_against_its_plain_version(qkv, params, heads=heads, size=size, stride_q=stride_q,
                                  stride_kv=stride_kv, kernel=(3, 3, 3), eps=1e-6)


@pytest.mark.parametrize("case", ["f32", "grad", "kernel_133", "stride_3", "head_width_104"])
def test_k7_leaves_what_it_does_not_take_to_the_route(cuda, case):
    """f32 rows, a gradient, another kernel, another stride and a head wider
    than K7's take the route: no K7 launch, the route's result."""
    from eco_tpu_torch.ops import pooled_attention as pa

    heads, size, d = 2, (4, 14, 14), 104 if case == "head_width_104" else 96
    qkv, params = _k7_case(cuda, size, heads, d=d, n=2,
                           dtype=torch.float32 if case == "f32" else torch.bfloat16)
    kw = dict(heads=heads, size=size, stride_q=(1, 2, 2), stride_kv=(1, 4, 4), kernel=(3, 3, 3),
              eps=1e-6)
    if case == "kernel_133":
        kw["kernel"] = (1, 3, 3)
        for s in "qkv":
            params[f"pool_{s}.w"] = params[f"pool_{s}.w"][:, :, 1:2].contiguous()
    if case == "stride_3":
        kw["stride_kv"] = (1, 3, 3)
    if case == "grad":
        qkv.requires_grad_(True)
    before = COUNTS["k7.launches"]
    got = pa.pool_qkv(qkv, params, **kw)
    torch.cuda.synchronize()
    want = pa.pool_qkv_route(qkv, params, **kw)
    assert COUNTS["k7.launches"] == before
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))


def test_k7_entry_refuses_a_geometry_it_does_not_take(cuda):
    """The C entry point launches nothing and returns cudaErrorInvalidValue
    (1) for a head wider than 96, a width not a multiple of 8, a stride it
    is not built for and a misaligned pointer."""
    from eco_tpu_torch.ops import pooled_attention as pa

    size, heads = (4, 14, 14), 2
    qkv, params = _k7_case(cuda, size, heads, n=2)
    out = torch.zeros((3, 2, 1 + math.prod(size), heads, 96), dtype=torch.bfloat16, device=cuda)
    ptrs = [params[f"{k}_{s}.{p}"].data_ptr() for k, p in (("pool", "w"), ("norm", "gamma"),
                                                          ("norm", "beta")) for s in "qkv"]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ok = (2, *size, heads, 96, 1, 2)
    call = lambda q, args: pa._kernel()(q, *ptrs, *(o.data_ptr() for o in out), *args, 1e-6, 1,
                                       stream)
    assert call(qkv.data_ptr(), ok) == 0
    torch.cuda.synchronize()
    for args in (ok[:5] + (104,) + ok[6:],       # wider than K7's head
                 ok[:5] + (44,) + ok[6:],        # not a multiple of 8
                 ok[:7] + (3,)):                 # a stride K7 is not built for
        assert call(qkv.data_ptr(), args) == 1
    assert call(qkv.data_ptr() + 2, ok) == 1
    torch.cuda.synchronize()


def test_k7_in_serving_requests(cuda):
    """A bf16 request of the published MViTv2-B (one clip of 32 x 224 x 224)
    launches K7 once a block, 24 times; an ECO-Lite, an I3D and a Video Swin
    request launch it 0 times."""
    def launches(graph, crop, frames, mean, fc, state=None):
        params, state = Program(graph, device="cpu").init(torch.Generator().manual_seed(0),
                                                          {"data": graph.inputs["data"]})
        g, p, s = optimize_for_inference(graph, params, state)
        p = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in p.items()}
        s = {ln: {k: v.to(cuda) for k, v in d.items()} for ln, d in s.items()}
        server = UInt8Server(Program(g, compute_dtype=torch.bfloat16, device=cuda), p, s,
                             crop=crop, mean=mean, output=fc)
        n = graph.inputs["data"][0]
        raw = torch.randint(0, 256, (n, frames, crop + 16, crop + 20, 3), dtype=torch.uint8,
                            device=cuda)
        before = COUNTS["k7.launches"]
        with torch.no_grad():
            server(raw, h_off=[0] * n, w_off=[0] * n, mirror=[0] * n)
        torch.cuda.synchronize()
        return COUNTS["k7.launches"] - before

    mvit = get_model("mvit_v2_b_kinetics", batch=1)
    assert launches(mvit, 224, 32, MVIT_MEAN, "head.projection") == 24
    lite = get_model("eco_lite_kinetics", batch=2, num_segments=4, crop_size=224)
    assert launches(lite, 224, 4, MEAN, "fc8") == 0
    i3d = get_model("i3d_rgb_kinetics", batch=1, num_frames=16, crop_size=224)
    assert launches(i3d, 224, 16, (127.5,) * 3, "Conv3d_0c_1x1") == 0
    swin = get_model("video_swin_b_kinetics", batch=1, num_frames=8, crop_size=64, embed_dim=32,
                     depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8])
    assert launches(swin, 64, 8, SWIN_MEAN, "cls_head.fc_cls") == 0
