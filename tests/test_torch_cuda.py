"""eco_tpu_torch on a CUDA device: the hand-written kernels (K1, K2, K3)
against their plain versions, the serving path and a train step on the
card against the same on the CPU, and the world-1 NCCL data-parallel step
against the plain one.

These tests need an NVIDIA GPU and nvcc, and skip without them.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from eco_tpu_torch.apps import RawPreprocessProgram, UInt8Server
from eco_tpu_torch.data import prefetch_to_device
from eco_tpu_torch.convert import optimize_for_inference, quantize_for_serving
from eco_tpu_torch.models import build_eco_lite, get_model
from eco_tpu_torch.ops import poolfuse, preprocess, qconv
from eco_tpu_torch.ops.quant import conv_nd_int8, inner_product_int8, quantize_weight
from eco_tpu_torch.ops.pool import pool_nd
from eco_tpu_torch.ops.resize import preprocess_resize_on_device
from eco_tpu_torch.runtime import Program, profiler
from eco_tpu_torch.train import SolverConfig, init_train_state, make_train_step

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
    before = preprocess.crop_normalize_launches
    got = preprocess.preprocess_on_device(*args, **kw)
    torch.cuda.synchronize()
    assert preprocess.crop_normalize_launches == before + 1
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
    before = preprocess.crop_normalize_launches
    got = preprocess.preprocess_on_device(frames, h_off, w_off, flags, **kw)
    torch.cuda.synchronize()
    assert preprocess.crop_normalize_launches == before + 1
    assert torch.equal(got, preprocess.crop_normalize_reference(frames, h_off, w_off, flags, **kw))


@pytest.mark.parametrize("dtype,act_scale", [
    (torch.float32, None), (torch.bfloat16, None), (torch.int8, 0.37)])
def test_kernel_at_crop_227_equals_plain_version(cuda, dtype, act_scale):
    """CaffeNet's input: (32, 1, 256, 256, 3) -> 227 crops, random in-range
    offsets and mirrors.  227 is prime (the rows split 57/57/57/56) and a row
    is 681 values, a multiple of no 16-byte unit."""
    args = _batch(cuda, 32, 1, 256, 256, 227, seed=227)
    kw = dict(crop=227, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
    before = preprocess.crop_normalize_launches
    got = preprocess.preprocess_on_device(*args, **kw)
    torch.cuda.synchronize()
    assert preprocess.crop_normalize_launches == before + 1
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
    before = preprocess.crop_normalize_launches
    got = preprocess.preprocess_on_device(frames, zeros, zeros, flags, **kw)
    torch.cuda.synchronize()
    assert preprocess.crop_normalize_launches == before + 1
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
    before = qconv.qconv_launches
    cpu, card = _card_and_cpu_logits(cuda, qprog.graph, qp, qs, 64, "fc8", frames,
                                     dict(h_off=h_off, w_off=w_off, mirror=mirror))
    assert qconv.qconv_launches == before + 29
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
    before = poolfuse.fused_maxpool_launches
    got = poolfuse.fused_maxpool_3x3s2(y, *args, **kw)
    torch.cuda.synchronize()
    assert poolfuse.fused_maxpool_launches == before + 1
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


def test_pool_route_takes_kernel_only_when_asked_and_never_under_a_gradient(cuda, monkeypatch):
    x = torch.randn(2, 16, 16, 8, device=cuda)
    want = poolfuse.fused_maxpool_3x3s2_reference(x)
    before = poolfuse.fused_maxpool_launches
    assert torch.equal(pool_nd(x, kernel=3, stride=2, mode="max"), want)
    assert poolfuse.fused_maxpool_launches == before  # variable unset: ATen
    monkeypatch.setenv("ECO_PALLAS_POOL", "1")
    assert torch.equal(pool_nd(x, kernel=3, stride=2, mode="max"), want)
    assert poolfuse.fused_maxpool_launches == before + 1
    # not supported (odd H), integer, or pad: the route stays on ATen
    pool_nd(x[:, :15], kernel=3, stride=2, mode="max")
    pool_nd(x.to(torch.int8), kernel=3, stride=2, mode="max")
    pool_nd(x, kernel=3, stride=2, pad=1, mode="max")
    assert poolfuse.fused_maxpool_launches == before + 1
    with pytest.raises(NotImplementedError, match="backward"):
        pool_nd(x.requires_grad_(), kernel=3, stride=2, mode="max")
    with pytest.raises(ValueError, match="contiguous"):
        poolfuse.fused_maxpool_3x3s2(x.detach().transpose(1, 2))


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
        ts, metrics = make_train_step(raw, cfg)(init_train_state(p, s), batch)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
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
    before = qconv.qconv_launches
    got = qconv.qconv_nd(x, w, scale_vec, bias, **kw)
    torch.cuda.synchronize()
    assert qconv.qconv_launches == before + 1
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
        before = qconv.qconv_launches
        got = [conv_nd_int8(x.to(cuda), qconv.kernel_layout(w_q).to(cuda), w_scale.to(cuda),
                            b.to(cuda), act_scale=0.02, pad=1, out_scale=out_scale),
               inner_product_int8(fx.to(cuda), fw_q.to(cuda), fw_scale.to(cuda),
                                  act_scale=0.03, out_scale=out_scale)]
        assert qconv.qconv_launches == before + 2
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
    """The int8 max pool of the int8 chains (integer-minimum padding, no K2
    even when it is asked for) equals the CPU's."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen)
    want = pool_nd(x, kernel=kernel, stride=stride, pad=pad, mode="max")
    before = poolfuse.fused_maxpool_launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ECO_PALLAS_POOL", "1")
        got = pool_nd(x.to(cuda), kernel=kernel, stride=stride, pad=pad, mode="max")
    assert poolfuse.fused_maxpool_launches == before
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
    k3_0 = qconv.qconv_launches
    got = int8_probe.int8_conv_step(x, w, ones)
    assert qconv.qconv_launches == k3_0 + 1
    want = qconv.qconv_nd_reference(x, w, ones, None, pad=1,
                                    out_scale=int8_probe.CONV_OUT_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _, _, xi, wi = int8_probe.matmul_operands(256, cuda)
    step = int8_probe.int8_matmul_step(xi, wi)
    assert torch.equal(step.cpu(), int8_probe.int8_matmul_step(xi.cpu(), wi.cpu()))
