"""eco_tpu_torch.tools.int8_probe against eco_tpu/tools/int8_probe.py on the
CPU, at n = 64 and a (4, 8, 8, 16) conv.

The probe's operands are the reference's (the same numpy draws, in the
port's layouts).  Its int8 matmul step is the reference's ``int8_step``
bit for bit: XLA's int32 -> int8 convert wraps, as torch's cast does.  Its
conv step is K3 with an int8-out epilogue at ``out_scale`` 1024 in place of
the reference's ``>> 10``: the int32 accumulators are equal, and K3 then
rounds and saturates (``clip(round(acc / 1024), -127, 127)``) where the
reference floors and wraps, so the step is held to that rule applied to the
reference's accumulator.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from eco_tpu_torch.ops import qconv
from eco_tpu_torch.tools import int8_probe

N, CONV = 64, dict(n=4, hw=8, c=16)


def _reference_int8_matmul_step(a, w):
    """eco_tpu/tools/int8_probe.py:mxu_ratio's ``int8_step``."""
    y = lax.dot_general(a, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    return (y >> 8).astype(jnp.int8)


def _reference_conv_acc(a, w):
    """The int32 conv of eco_tpu/tools/int8_probe.py:conv_ratio's
    ``int8_step``, before its ``>> 10``."""
    dn = lax.conv_dimension_numbers(a.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(a, w, (1, 1), [(1, 1), (1, 1)], dimension_numbers=dn,
                                    preferred_element_type=jnp.int32)


def test_int8_cast_wraps_in_both_packages():
    x = np.array([300, -300, 127, 128, -129, 1000], np.int32)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x).astype(jnp.int8)),
                                  torch.from_numpy(x).to(torch.int8).numpy())


def test_matmul_operands_are_the_reference_draws():
    rng = np.random.default_rng(0)
    want = [rng.standard_normal((N, N)), rng.standard_normal((N, N)),
            rng.integers(-127, 128, (N, N)), rng.integers(-127, 128, (N, N))]
    got = int8_probe.matmul_operands(N, "cpu")
    for g, w, dtype in zip(got, want, (torch.bfloat16, torch.bfloat16, torch.int8, torch.int8)):
        assert g.dtype == dtype
        assert torch.equal(g, torch.from_numpy(w).to(dtype))


def test_int8_matmul_step_equals_the_reference_step():
    """Three chained steps: the shift, the wrapping cast and the product's
    int32 sums bit for bit."""
    _, _, xi, wi = int8_probe.matmul_operands(N, "cpu")
    a, ja, jw = xi, jnp.asarray(xi.numpy()), jnp.asarray(wi.numpy())
    for _ in range(3):
        a, ja = int8_probe.int8_matmul_step(a, wi), _reference_int8_matmul_step(ja, jw)
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert (a.numpy() != 0).any()


def test_int8_conv_step_is_k3_on_the_reference_accumulator():
    rng = np.random.default_rng(1)
    n, hw, c = CONV["n"], CONV["hw"], CONV["c"]
    rng.standard_normal((n, hw, hw, c)), rng.standard_normal((3, 3, c, c))
    xi = rng.integers(-127, 128, (n, hw, hw, c)).astype(np.int8)
    wi = rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
    _, _, x, w = int8_probe.conv_operands(**CONV, device="cpu")
    assert torch.equal(x, torch.from_numpy(xi))
    assert torch.equal(w, torch.from_numpy(wi).permute(3, 2, 0, 1))
    acc = np.asarray(_reference_conv_acc(jnp.asarray(xi), jnp.asarray(wi)))
    np.testing.assert_array_equal(
        qconv.conv_acc_reference(x, w, stride=1, pad=1, dilation=1, groups=1).numpy(), acc)
    got = int8_probe.int8_conv_step(x, w, torch.ones(c))
    want = np.clip(np.round(acc.astype(np.float32) / int8_probe.CONV_OUT_SCALE), -127, 127)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int8))
    # the reference's own step floors and wraps: not the same bytes
    assert not np.array_equal(got.numpy(), (acc >> 10).astype(np.int8))


def test_bf16_steps_keep_their_types_and_layouts():
    xb, wb, _, _ = int8_probe.matmul_operands(N, "cpu")
    assert int8_probe.bf16_matmul_step(xb, wb).dtype == torch.bfloat16
    xb, wb, _, _ = int8_probe.conv_operands(**CONV, device="cpu")
    y = int8_probe.bf16_conv_step(xb, wb)
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("part", ["matmul", "conv", "serving"])
def test_result_keys(part):
    """The reference's keys (``int8_mxu_ratio`` is ``int8_matmul_ratio`` here),
    each rate with its share of the dense peak."""
    if part == "matmul":
        r = int8_probe.matmul_ratio(N, "cpu")
        keys = {f"matmul_{t}_{k}" for t in ("bf16", "int8")
                for k in ("ms", "tops", "peak_share")} | {"int8_matmul_ratio", "int_mm_ms",
                                                           "int_mm_tops", "int_mm_peak_share"}
    elif part == "conv":
        r = int8_probe.conv_ratio(**CONV, device="cpu")
        keys = {f"conv_{t}_{k}" for t in ("bf16", "int8")
                for k in ("ms", "tops", "peak_share")} | {"int8_conv_ratio", "conv_k3_launches"}
        assert r["conv_k3_launches"] == 0  # CPU tensors take the plain version
    else:
        r = int8_probe.serving_ratio(2, "cpu", segments=2, crop=64, iters=1)
        keys = {"eco_lite_bf16_videos_per_sec", "int8_videos_per_sec", "int8_quantized_layers",
                "int8_chained_layers", "int8_batch", "int8_speedup_vs_bf16", "e2e_requests",
                "e2e_k1_launches", "e2e_k3_launches", "eco_lite_bf16_ms", "int8_ms"}
        assert r["int8_quantized_layers"] == 29 and r["int8_chained_layers"] == 26
    assert set(r) == keys
    json.dumps(r)
    assert all(np.isfinite(v) for v in r.values() if isinstance(v, float))
