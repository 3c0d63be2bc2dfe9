"""eco_tpu_torch on a CUDA device: the hand-written kernel against its plain
version, and the serving path on the card against the same path on the CPU.

These tests need an NVIDIA GPU and nvcc, and skip without them.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from eco_tpu_torch.apps import UInt8Server
from eco_tpu_torch.convert import optimize_for_inference
from eco_tpu_torch.models import get_model
from eco_tpu_torch.ops import preprocess
from eco_tpu_torch.runtime import Program

pytestmark = pytest.mark.cuda

MEAN = (104.0, 117.0, 123.0)


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
    params, state = Program(graph).init(torch.Generator().manual_seed(0),
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
