"""eco_tpu_torch.ops against their eco_tpu.ops twins, on the same numpy inputs.

Tolerances: f32 convolutions, matmuls and sums run in another order in XLA's
CPU kernels than in ATen's, so they agree to a few f32 ulps of the largest
term (rtol/atol 1e-5); max pools, layout moves, concat and relu select
existing values and must agree exactly.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import BATCH, I3D_POOLS, K4_FRAMES, K4_POOLS
from eco_tpu import ops as jops
from eco_tpu_torch import ops
from eco_tpu_torch.utils.shapes import caffe_pool_out_dim
from eco_tpu_torch.utils.tracing import COUNTS

RTOL = ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


# -- convolution -------------------------------------------------------------

CONV_CASES = {
    "2d_k3_p1": dict(x=(2, 9, 11, 6), k=(3, 3), cout=8, stride=1, pad=1),
    "2d_stem_k7_s2_p3": dict(x=(2, 16, 16, 3), k=(7, 7), cout=8, stride=2, pad=3),
    "2d_1x1": dict(x=(2, 7, 7, 8), k=(1, 1), cout=12, stride=1, pad=0),
    "2d_dilation_groups": dict(x=(2, 12, 10, 8), k=(3, 3), cout=6, stride=1, pad=2,
                               dilation=2, groups=2),
    "2d_per_axis": dict(x=(2, 8, 9, 4), k=(1, 3), cout=5, stride=(1, 2), pad=(0, 1)),
    "3d_k3_s1": dict(x=(2, 4, 7, 7, 6), k=(3, 3, 3), cout=8, stride=1, pad=1),
    "3d_k3_s2": dict(x=(2, 4, 7, 7, 6), k=(3, 3, 3), cout=8, stride=2, pad=1),
    "3d_no_bias": dict(x=(1, 5, 6, 6, 4), k=(3, 3, 3), cout=4, stride=(1, 2, 2),
                       pad=(1, 0, 1), bias=False),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_nd_matches_jax(case):
    c = dict(CONV_CASES[case])
    rng = _rng(1)
    groups = c.get("groups", 1)
    x = rng.standard_normal(c["x"]).astype(np.float32)
    w = rng.standard_normal(c["k"] + (c["x"][-1] // groups, c["cout"])).astype(np.float32)
    b = rng.standard_normal(c["cout"]).astype(np.float32) if c.get("bias", True) else None
    kw = dict(stride=c["stride"], pad=c["pad"], dilation=c.get("dilation", 1), groups=groups)
    want = jops.conv_nd(jnp.asarray(x), jnp.asarray(w),
                        None if b is None else jnp.asarray(b), **kw)
    nsp = len(c["k"])
    w_t = np.transpose(w, (nsp + 1, nsp) + tuple(range(nsp)))  # -> (Cout, Cin/g, *k)
    got = ops.conv_nd(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w_t)),
                      None if b is None else torch.from_numpy(b), **kw)
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    _close(got, want)


def test_conv_bf16_policy_matches_jax():
    """bf16 in: weight cast to bf16, output rounded to bf16, bias added in
    bf16.  Both sides accumulate in f32 and round once per step, so they may
    differ by one bf16 ulp (2^-8 relative) where the f32 sums straddle a
    rounding boundary."""
    rng = _rng(2)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = jops.conv_nd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), pad=1)
    got = ops.conv_nd(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                      torch.from_numpy(b), pad=1)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), rtol=2 ** -7, atol=2 ** -7)


def test_transposed_conv_not_ported():
    """Transposed convolution is ported now (the name is kept from when it
    raised): a dilated, grouped 2D case against the reference, each in its
    own weight layout, (C_in, C_out/g, *k) and (*k, C_in, C_out/g)."""
    rng = _rng(3)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 2)).astype(np.float32)  # (C_in, C_out/g, 3, 2)
    kw = dict(stride=2, pad=1, dilation=2, groups=2)
    want = jops.conv_nd(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 0, 1)), transposed=True,
                        **kw)
    got = ops.conv_nd(torch.from_numpy(x), torch.from_numpy(w), transposed=True, **kw)
    assert got.shape == want.shape == (2, 11, 11, 6)
    _close(got, want)


# -- pooling -----------------------------------------------------------------

POOL_CASES = {
    "max_112_to_56_ceil": dict(x=(1, 112, 112, 4), k=3, s=2, p=0, mode="max"),
    "max_odd_27": dict(x=(2, 27, 27, 3), k=3, s=2, p=0, mode="max"),
    "max_s1_p1": dict(x=(2, 9, 9, 3), k=3, s=1, p=1, mode="max"),
    "max_3d": dict(x=(2, 4, 7, 7, 3), k=(2, 3, 3), s=(2, 2, 2), p=0, mode="max"),
    "ave_s1_p1_odd": dict(x=(2, 9, 7, 3), k=3, s=1, p=1, mode="ave"),
    "ave_s2_p1_odd": dict(x=(2, 11, 9, 3), k=3, s=2, p=1, mode="ave"),
    "ave_clip_last_window": dict(x=(2, 5, 5, 3), k=2, s=2, p=1, mode="ave"),
    "ave_3d_global": dict(x=(2, 4, 7, 7, 3), k=None, s=1, p=0, mode="ave", glob=True),
    "max_int8": dict(x=(2, 9, 9, 3), k=3, s=2, p=1, mode="max", dtype="int8"),
    # ECO's and CaffeNet's pool geometries (H and W as in the graphs; batch
    # and channels cut); 112 -> 56 is max_112_to_56_ceil
    "eco_max_56_to_28": dict(x=(2, 56, 56, 8), k=3, s=2, p=0, mode="max"),
    "eco_ave_28_s1_p1": dict(x=(2, 28, 28, 8), k=3, s=1, p=1, mode="ave"),
    "eco_max_14_to_7": dict(x=(2, 14, 14, 8), k=3, s=2, p=0, mode="max"),
    "eco_max_7_s1_p1": dict(x=(2, 7, 7, 8), k=3, s=1, p=1, mode="max"),
    "eco_ave_7_k7": dict(x=(2, 7, 7, 8), k=7, s=1, p=0, mode="ave"),
    "caffenet_max_55_to_27": dict(x=(2, 55, 55, 4), k=3, s=2, p=0, mode="max"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_nd_matches_jax(case):
    c = POOL_CASES[case]
    rng = _rng(3)
    if c.get("dtype") == "int8":
        x = rng.integers(-128, 128, c["x"], dtype=np.int8)
    else:
        x = rng.standard_normal(c["x"]).astype(np.float32)
    kw = dict(kernel=c["k"], stride=c["s"], pad=c["p"], mode=c["mode"],
              global_pooling=c.get("glob", False))
    want = np.asarray(jops.pool_nd(jnp.asarray(x), **kw))
    got = ops.pool_nd(torch.from_numpy(x), **kw)
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    assert got.dtype == torch.from_numpy(x).dtype
    if c["mode"] == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want)


def _row_major_ave(x, k, s, p):
    """Caffe AVE pool of (N, H, W, C) written out: each window's cells, the
    padding's as +0.0, added one f32 add at a time in row-major order from
    +0.0, then divided by Caffe's divisor (the window clipped to H + p
    before the image)."""
    n, h, w, c = x.shape
    ho, wo = (caffe_pool_out_dim(d, k, s, p)[0] for d in (h, w))
    out = np.empty((n, ho, wo, c), np.float32)
    for i in range(ho):
        for j in range(wo):
            r0, q0 = i * s - p, j * s - p
            acc = np.zeros((n, c), np.float32)
            for r in range(r0, r0 + k):
                for q in range(q0, q0 + k):
                    if 0 <= r < h and 0 <= q < w:
                        acc = np.add(acc, x[:, r, q], dtype=np.float32)
                    else:
                        acc = np.add(acc, np.float32(0.0), dtype=np.float32)
            div = (np.float32(min(r0 + k, h + p) - r0)
                   * np.float32(min(q0 + k, w + p) - q0))
            out[:, i, j] = acc / div
    return out


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,k,s,p", [
    ((2, 28, 28, 8), 3, 1, 1), ((2, 7, 7, 8), 7, 1, 0), ((2, 11, 9, 3), 3, 2, 1),
    ((2, 5, 5, 3), 2, 2, 1), ((2, 9, 9, 3), 3, 2, 2)])
def test_ave_route_is_the_row_major_f32_sum_bit_for_bit(dtype, shape, k, s, p, grad):
    """K4's sum order: the plain AVE route gives the written-out row-major
    sum's bits, so the kernel can be held to it with torch.equal; under a
    gradient (training, where K4 does not run) the route sums alike.  The
    values span six orders of magnitude, so another order of adds would
    round otherwise.  A pad over half the window, which ATen's pool does not
    take, sums on the zero-padded tensor instead."""
    rng = _rng(5)
    scale = rng.choice(np.float32([1e-3, 1.0, 1e3]), shape)
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    want = torch.from_numpy(_row_major_ave(x.float().numpy(), k, s, p)).to(dtype)
    with torch.enable_grad():
        got = ops.pool_nd(x.requires_grad_(grad), kernel=k, stride=s, pad=p, mode="ave")
    assert got.requires_grad == grad
    got = got.detach()
    bits = {torch.float32: torch.int32}.get(dtype, torch.int16)
    assert got.dtype == dtype and torch.equal(got.view(bits), want.view(bits))


def _fake_card_tensor(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="cuda")


POOL_ROUTES = {
    # case: (shape, dtype, mode, how, where it goes: "k4" the 2D path, "k4_3d"
    # the 3D path, "route" the padded route)
    "card_max": ((2, 9, 9, 16), torch.bfloat16, "max", None, "k4"),
    "card_ave_f32": ((2, 9, 9, 16), torch.float32, "ave", None, "k4"),
    "card_f16_odd_channels": ((2, 9, 9, 5), torch.float16, "max", None, "k4"),
    "under_a_gradient": ((2, 9, 9, 16), torch.bfloat16, "max", "grad", "route"),
    "int8": ((2, 9, 9, 16), torch.int8, "max", None, "route"),
    "3d": ((2, 4, 9, 9, 16), torch.bfloat16, "max", None, "k4_3d"),
    "3d_ave_f32": ((2, 4, 9, 9, 16), torch.float32, "ave", None, "k4_3d"),
    "3d_one_frame_window": ((2, 4, 9, 9, 16), torch.bfloat16, "max", "frames", "k4"),
    "3d_under_a_gradient": ((2, 4, 9, 9, 16), torch.bfloat16, "max", "grad", "route"),
    "3d_int8": ((2, 4, 9, 9, 16), torch.int8, "max", None, "route"),
    "3d_while_compiling": ((2, 4, 9, 9, 16), torch.bfloat16, "max", "compiling", "route"),
    "3d_cpu": ((2, 4, 9, 9, 16), torch.bfloat16, "max", "cpu", "route"),
    "1d": ((2, 9, 16), torch.bfloat16, "max", None, "route"),
    "while_compiling": ((2, 9, 9, 16), torch.bfloat16, "max", "compiling", "route"),
    "not_contiguous": ((2, 9, 9, 16), torch.bfloat16, "max", "transposed", "route"),
    "cpu": ((2, 9, 9, 16), torch.bfloat16, "max", "cpu", "route"),
}


@pytest.mark.parametrize("case", sorted(POOL_ROUTES))
def test_pool_nd_routes_float_2d_card_pools_to_k4(case, monkeypatch):
    """On fake card tensors: a float 2D or 3D pool of a contiguous tensor on
    the card with no gradient asked goes to K4, a 3D window of one frame
    (stride 1, no pad along T) to its 2D path over the (N * T, H, W, C)
    view; a gradient, an integer or 1D pool, a running trace, a strided view
    and the CPU keep the route, and the float ones on the card count in
    COUNTS["pool.route"].  COUNTS["pool.bytes"] counts each pool once, on
    the shape it was given."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from eco_tpu_torch.ops import pool, poolk

    shape, dtype, mode, how, to = POOL_ROUTES[case]
    nsp = len(shape) - 2
    kernel, stride, pad = (3,) * nsp, (2,) * nsp, (1,) * nsp
    if how == "frames":
        kernel, stride, pad = (1, 3, 3), (1, 2, 2), (0, 1, 1)
    calls = []

    def recorder(route):
        def call(x, kernel, stride, pad, mode):
            calls.append((route, tuple(x.shape), tuple(kernel), tuple(stride), tuple(pad), mode))
            return x.new_empty(x.shape)
        return call

    monkeypatch.setattr(poolk, "_pool2d", recorder("k4"))
    monkeypatch.setattr(poolk, "_pool3d", recorder("k4_3d"))
    monkeypatch.setattr(pool, "padded_pool", recorder("route"))
    if how == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    before, bytes_before = COUNTS["pool.route"], COUNTS["pool.bytes"]
    with torch.enable_grad(), FakeTensorMode():
        x = (torch.empty(shape, dtype=dtype) if how == "cpu"
             else _fake_card_tensor(shape, dtype))
        if how == "grad":
            x.requires_grad_()
        if how == "transposed":
            x = x.transpose(1, 2)
        assert poolk.takes(x, mode) == (to != "route")
        pool.pool_nd(x, kernel=kernel, stride=stride, pad=pad, mode=mode)
    if how == "frames":  # each frame a 2D pool
        want = ("k4", (shape[0] * shape[1], *shape[2:]), kernel[1:], stride[1:], pad[1:], mode)
    else:
        want = (to, tuple(x.shape), kernel, stride, pad, mode)
    assert calls == [want]
    on_card_route = to == "route" and how != "cpu" and dtype.is_floating_point
    assert COUNTS["pool.route"] == before + on_card_route
    if how != "compiling":
        out = math.prod(caffe_pool_out_dim(d, k, s, p)[0]
                        for d, k, s, p in zip(shape[1:-1], kernel, stride, pad))
        least = (math.prod(shape) + shape[0] * out * shape[-1]) * dtype.itemsize
        assert COUNTS["pool.bytes"] == bytes_before + least


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name", sorted(K4_POOLS))
def test_k4_plan_fills_the_card_within_its_limits(name, itemsize):
    """K4's tile at every ECO and CaffeNet pool at 32 videos x 16 frames: the
    tile path, within the kernel's thread and shared-memory limits, with the
    output covered and two blocks or more for each of the card's 132 SMs."""
    from eco_tpu_torch.ops import poolk

    (h, w, c), k, s, p, _, _, _ = K4_POOLS[name]
    n = K4_FRAMES
    plan = poolk.plan((n, h, w, c), (k, k), (s, s), (p, p), itemsize, aligned=True)
    ho, wo = (caffe_pool_out_dim(d, k, s, p)[0] for d in (h, w))
    groups = c * itemsize // 16
    assert (plan.ho, plan.wo) == (ho, wo)
    assert plan.tiled and plan.per == {(3, 2): 2, (3, 1): 4}.get((k, s), 1)
    assert plan.threads == plan.cv * plan.tx * plan.toh <= poolk.THREADS
    assert plan.smem == (((plan.toh - 1) * s + k) * ((plan.tx * plan.per - 1) * s + k)
                         * plan.cv * 16) <= poolk.SMEM_BYTES
    assert plan.tiles == (-(-ho // plan.toh), -(-wo // (plan.tx * plan.per)),
                          -(-groups // plan.cv))
    assert n * math.prod(plan.tiles) >= poolk.MIN_BLOCKS


@pytest.mark.parametrize("shape,itemsize,aligned", [
    ((2, 8, 12, 5), 2, True), ((2, 8, 12, 6), 4, True), ((2, 16, 16, 8), 2, False)])
def test_k4_plan_takes_the_scalar_path_without_whole_aligned_vectors(shape, itemsize, aligned):
    from eco_tpu_torch.ops import poolk

    assert not poolk.plan(shape, (3, 3), (2, 2), (0, 0), itemsize, aligned).tiled


def test_k4_wrapper_rejects_what_the_kernel_does_not_take():
    from eco_tpu_torch.ops import poolk

    with pytest.raises(ValueError, match="on the card"):
        poolk.caffe_pool(torch.zeros(2, 8, 8, 8), (3, 3), (2, 2), (0, 0), "max")


I3D_3D_POOLS = sorted(n for n, v in I3D_POOLS.items() if v[1][0] > 1)


def test_i3d_pools_are_the_models(monkeypatch):
    """``I3D_POOLS`` (the card tests' and chip_smoke.py's table) holds every
    pool of I3D-RGB at 64 x 224 x 224: shape, window, stride, pad, mode and
    count, as the program runs them (shapes propagated on the meta device)."""
    from eco_tpu_torch.models import get_model
    from eco_tpu_torch.runtime import Program, executor
    from eco_tpu_torch.utils.shapes import normalize_spatial_param

    graph = get_model("i3d_rgb_kinetics", batch=1, num_frames=64, crop_size=224)
    seen = []
    pool_nd = executor.ops.pool_nd

    def recorder(x, *, kernel=None, stride=1, pad=0, mode="max", global_pooling=False):
        seen.append((tuple(x.shape[1:]), *(normalize_spatial_param(a, 3, default=d)
                                           for a, d in ((kernel, None), (stride, 1), (pad, 0))),
                     mode))
        return pool_nd(x, kernel=kernel, stride=stride, pad=pad, mode=mode)

    monkeypatch.setattr(executor.ops, "pool_nd", recorder)
    Program(graph, device="meta").init(torch.Generator().manual_seed(0),
                                       {"data": graph.inputs["data"]})
    want = sorted(v[:5] for v in I3D_POOLS.values() for _ in range(v[5]))
    assert sorted(seen) == want and len(seen) == 14


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name", I3D_3D_POOLS)
def test_k4_plan3d_fills_the_card_within_its_limits(name, itemsize):
    """K4's 3D tile at every I3D pool with a window of more than one frame,
    at the benchmark's 8 clips: the tile path (each is one of its windows, in
    the mode it is instantiated for), within the kernel's thread and
    shared-memory limits, with the output covered, and two blocks or more
    for each of the card's 132 SMs."""
    from eco_tpu_torch.ops import poolk

    (t, h, w, c), k, s, p, mode, _ = I3D_POOLS[name]
    plan = poolk.plan3d((BATCH, t, h, w, c), k, s, p, mode, itemsize, aligned=True)
    to, ho, wo = (caffe_pool_out_dim(d, kk, ss, pp)[0] for d, kk, ss, pp in zip((t, h, w), k, s, p))
    groups = c * itemsize // 16
    assert (plan.to, plan.ho, plan.wo) == (to, ho, wo)
    assert plan.tiled and plan.per == poolk._TILE3[(*k, *s, mode)]
    assert plan.threads == plan.cv * plan.tx * plan.toh <= poolk.THREADS
    assert plan.threads >= 16
    band = ((plan.toh - 1) * s[1] + k[1]) * ((plan.tx * plan.per - 1) * s[2] + k[2]) * plan.cv * 16
    assert plan.smem == poolk.RING * band <= poolk.SMEM3_BYTES
    assert plan.tiles == (-(-to // plan.tt), -(-ho // plan.toh), -(-wo // (plan.tx * plan.per)),
                          -(-groups // plan.cv))
    assert BATCH * math.prod(plan.tiles) >= poolk.MIN_BLOCKS


@pytest.mark.parametrize("shape,itemsize,aligned,kernel,stride,pad,mode", [
    ((2, 4, 8, 12, 5), 2, True, (3, 3, 3), (1, 1, 1), (1, 1, 1), "max"),
    ((2, 4, 8, 12, 6), 4, True, (3, 3, 3), (1, 1, 1), (1, 1, 1), "max"),
    ((2, 4, 16, 16, 8), 2, False, (3, 3, 3), (1, 1, 1), (1, 1, 1), "max"),
    ((2, 4, 16, 16, 8), 2, True, (3, 3, 3), (1, 1, 1), (3, 1, 1), "max"),
    ((2, 4, 16, 16, 8), 2, True, (1, 3, 3), (2, 2, 2), (0, 1, 1), "max"),
    ((2, 4, 16, 16, 8), 2, True, (3, 3, 3), (1, 1, 1), (1, 1, 1), "ave"),
    ((2, 4, 7, 7, 8), 2, True, (2, 7, 7), (1, 1, 1), (0, 0, 0), "max"),
    ((2, 5, 9, 11, 16), 2, True, (2, 3, 3), (1, 2, 2), (1, 1, 1), "max")])
def test_k4_plan3d_takes_the_scalar_path_without_whole_aligned_vectors(
        shape, itemsize, aligned, kernel, stride, pad, mode):
    """As in 2D; where a window along T lies wholly in the padding (a T pad
    as wide as the T window, which Caffe refuses); and at every window and
    mode the tile path is not instantiated for: I3D's windows in the other
    mode, a window of one frame at stride 2, any other window."""
    from eco_tpu_torch.ops import poolk

    assert not poolk.plan3d(shape, kernel, stride, pad, mode, itemsize, aligned).tiled


@pytest.mark.parametrize("args", [
    (torch.zeros(2, 4, 8, 8, 8), "max"),
    (torch.zeros(2, 8, 8, 8, device="meta"), "max"),
    (torch.zeros(2, 4, 8, 8, 8, dtype=torch.int8, device="meta"), "max")])
def test_k4_3d_wrapper_rejects_what_the_kernel_does_not_take(args):
    from eco_tpu_torch.ops import poolk

    x, mode = args
    with pytest.raises(ValueError, match="caffe_pool takes"):
        poolk.caffe_pool(x, (3, 3, 3), (1, 1, 1), (1, 1, 1), mode)


@pytest.mark.parametrize("shape", [(2, 7, 7, 8), (2, 4, 7, 7, 8)])
def test_global_avg_pool_matches_jax(shape):
    x = _rng(4).standard_normal(shape).astype(np.float32)
    want = jops.global_avg_pool(jnp.asarray(x))
    _close(ops.global_avg_pool(torch.from_numpy(x)), want)


# -- norm ----------------------------------------------------------------------


def _bn_inputs(c=6):
    rng = _rng(5)
    return (
        rng.standard_normal((2, 5, 5, c)).astype(np.float32),
        (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.3 * rng.standard_normal(c)).astype(np.float32),
        (0.5 + rng.random(c)).astype(np.float32),
    )


@pytest.mark.parametrize("fn", ["bn_inference", "scale_shift", "fold_scale_shift"])
def test_norm_matches_jax(fn):
    x, g, b, m, v = _bn_inputs()
    t = [torch.from_numpy(a) for a in (x, g, b, m, v)]
    j = [jnp.asarray(a) for a in (x, g, b, m, v)]
    if fn == "bn_inference":
        _close(ops.bn_inference(*t), jops.bn_inference(*j))
    elif fn == "scale_shift":
        _close(ops.scale_shift(t[0], t[1], t[2]), jops.scale_shift(j[0], j[1], j[2]))
    else:
        for got, want in zip(ops.fold_scale_shift(*t[1:]), jops.fold_scale_shift(*j[1:])):
            _close(got, want, rtol=1e-6, atol=1e-6)


# -- elementwise, fc, softmax --------------------------------------------------


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_relu_matches_jax(slope):
    x = _rng(6).standard_normal((2, 5, 5, 4)).astype(np.float32)
    want = np.asarray(jops.relu(jnp.asarray(x), slope))
    np.testing.assert_array_equal(ops.relu(torch.from_numpy(x), slope).numpy(), want)


def test_dropout_is_identity_at_test():
    x = torch.from_numpy(_rng(7).standard_normal((3, 4)).astype(np.float32))
    assert ops.dropout(x, 0.5) is x
    assert ops.dropout(x, 0.0, train=True) is x
    # train mode needs its randomness, as the reference needs an rng key
    with pytest.raises(ValueError, match="generator"):
        ops.dropout(x, 0.5, train=True)


@pytest.mark.parametrize("op,coeffs", [
    ("sum", None), ("sum", (0.5, -2.0, 1.0)), ("prod", None), ("max", None),
])
def test_eltwise_matches_jax(op, coeffs):
    xs = [_rng(8 + i).standard_normal((2, 3, 3, 4)).astype(np.float32) for i in range(3)]
    want = jops.eltwise([jnp.asarray(x) for x in xs], op, coeffs)
    _close(ops.eltwise([torch.from_numpy(x) for x in xs], op, coeffs), want)


def test_concat_channels_matches_jax():
    xs = [_rng(11 + i).standard_normal((2, 3, 3, c)).astype(np.float32) for i, c in
          enumerate((2, 5, 3))]
    want = np.asarray(jops.concat_channels([jnp.asarray(x) for x in xs]))
    np.testing.assert_array_equal(
        ops.concat_channels([torch.from_numpy(x) for x in xs]).numpy(), want)


@pytest.mark.parametrize("bias", [True, False])
def test_inner_product_matches_jax(bias):
    rng = _rng(12)
    x = rng.standard_normal((3, 20)).astype(np.float32)
    w = rng.standard_normal((20, 7)).astype(np.float32)  # reference (D_in, D_out)
    b = rng.standard_normal(7).astype(np.float32) if bias else None
    want = jops.inner_product(jnp.asarray(x), jnp.asarray(w),
                              None if b is None else jnp.asarray(b))
    got = ops.inner_product(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                            None if b is None else torch.from_numpy(b))
    _close(got, want)


def test_softmax_matches_jax():
    x = (5 * _rng(13).standard_normal((4, 10))).astype(np.float32)
    _close(ops.softmax(torch.from_numpy(x)), jops.softmax(jnp.asarray(x)), rtol=1e-6, atol=1e-7)


# -- layout ---------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["fold", "unfold", "consensus", "to_logical", "to_physical"])
def test_layout_matches_jax(fn):
    rng = _rng(14)
    if fn == "fold":
        x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
        got, want = ops.fold_segments(torch.from_numpy(x)), jops.fold_segments(jnp.asarray(x))
    elif fn == "unfold":
        x = rng.standard_normal((6, 4, 5, 6)).astype(np.float32)
        got = ops.unfold_segments(torch.from_numpy(x), 3)
        want = jops.unfold_segments(jnp.asarray(x), 3)
    elif fn == "consensus":
        x = rng.standard_normal((6, 8)).astype(np.float32)
        got = ops.segment_consensus(torch.from_numpy(x), 3)
        want = jops.segment_consensus(jnp.asarray(x), 3)
    elif fn == "to_logical":
        x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
        got, want = ops.to_logical(torch.from_numpy(x)), jops.to_logical(jnp.asarray(x))
    else:
        x = rng.standard_normal((2, 6, 4, 5)).astype(np.float32)
        got, want = ops.to_physical(torch.from_numpy(x)), jops.to_physical(jnp.asarray(x))
        assert got.is_contiguous()
    _close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("in_shape,dims,axis,num_axes", [
    ((2, 3, 4, 5), (0, -1), 0, -1),
    ((2, 3, 4, 5), (0, 0, 20), 0, -1),
    ((2, 3, 4, 5), (-1, 2, 2), 2, 1),
    ((8, 12), (2, 4, 12), 0, 1),
])
def test_caffe_reshape_dims_matches_jax(in_shape, dims, axis, num_axes):
    assert ops.caffe_reshape_dims(in_shape, dims, axis, num_axes) == \
        jops.caffe_reshape_dims(in_shape, dims, axis, num_axes)


def test_unfold_segments_is_a_channels_last_3d_view():
    """r2Dto3D is free: the unfold is a view of the trunk's output, and the
    NCDHW view cuDNN is handed is already channels_last_3d (no copy)."""
    x = torch.randn(2 * 4, 7, 7, 6)
    y = ops.unfold_segments(x, 4)
    assert y.data_ptr() == x.data_ptr() and y._base is x
    assert tuple(y.shape) == (2, 4, 7, 7, 6)
    ncdhw = y.permute(0, 4, 1, 2, 3)
    assert ncdhw.is_contiguous(memory_format=torch.channels_last_3d)
