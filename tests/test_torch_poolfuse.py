"""The plain version of K2, eco_tpu_torch's fused 3x3/s2 max pool, against
the reference's Pallas kernel ``fused_maxpool_3x3s2`` in interpret mode, and
``pool_nd``'s 3x3/s2 max pool on the CPU, which never takes K2.

Tolerances: the plain and ReLU variants select one of the input values, so
they must be equal; the affine variant computes ``x * scale + shift`` in f32,
which XLA may contract into a fused multiply-add and PyTorch does not, so it
is held to rtol/atol 1e-6 (the reference's own test of that variant uses
the same bound).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eco_tpu.ops.pallas.poolfuse import fused_maxpool_3x3s2 as jax_fused
from eco_tpu.ops.pool import pool_nd as jax_pool_nd
from eco_tpu_torch.ops import poolfuse
from eco_tpu_torch.ops.pool import pool_nd
from eco_tpu_torch.utils.tracing import COUNTS


@pytest.fixture(autouse=True)
def _grad_enabled():
    """tests/test_golden_torch.py turns autograd off for its whole process
    when it is imported, and pytest-xdist workers import every test file;
    these tests need it on."""
    with torch.enable_grad():
        yield


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # negatives everywhere, so the non-ReLU fill (not 0) is what makes it pass;
    # continuous values, so no pre-ReLU value is exactly 0
    y = (rng.standard_normal(shape) - 2.0).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.3 + 1.0).astype(np.float32)
    shift = (rng.standard_normal(shape[-1]) * 0.2 + 1.5).astype(np.float32)
    return y.astype(dtype), scale, shift


@pytest.mark.parametrize("shape", [(2, 12, 16, 8), (3, 8, 4, 5), (1, 28, 28, 24)])
@pytest.mark.parametrize("variant", ["plain", "relu", "affine"])
def test_plain_version_matches_the_pallas_kernel(shape, variant):
    y, scale, shift = _inputs(shape, seed=sum(shape))
    kw = dict(relu=variant == "relu", affine=variant == "affine")
    args = (scale, shift) if variant == "affine" else ()
    want = np.asarray(jax_fused(jnp.asarray(y), *map(jnp.asarray, args), interpret=True, **kw))
    got = poolfuse.fused_maxpool_3x3s2_reference(
        torch.from_numpy(y), *map(torch.from_numpy, args), **kw)
    assert tuple(got.shape) == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    if variant == "affine":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(poolfuse.fused_maxpool_3x3s2(
        torch.from_numpy(y), *map(torch.from_numpy, args), **kw), got)


@pytest.mark.parametrize("variant", ["plain", "relu"])
def test_plain_version_matches_the_pallas_kernel_in_bf16(variant):
    y, _, _ = _inputs((2, 8, 12, 16), seed=5)
    want = jax_fused(jnp.asarray(y, jnp.bfloat16), relu=variant == "relu", interpret=True)
    got = poolfuse.fused_maxpool_3x3s2_reference(
        torch.from_numpy(y).to(torch.bfloat16), relu=variant == "relu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_supports_predicate():
    """The cases of the reference's own test (tests/test_pallas_poolfuse.py)."""
    assert poolfuse.supports((1, 112, 112, 64), (3, 3), (2, 2), (0, 0), "max")
    assert not poolfuse.supports((1, 112, 112, 64), (3, 3), (2, 2), (0, 0), "ave")
    assert not poolfuse.supports((1, 112, 112, 64), (3, 3), (1, 1), (0, 0), "max")
    assert not poolfuse.supports((1, 111, 112, 64), (3, 3), (2, 2), (0, 0), "max")
    assert not poolfuse.supports((1, 4, 7, 7, 64), (3, 3), (2, 2), (0, 0), "max")
    assert not poolfuse.supports((1, 8, 2, 4), (3, 3), (2, 2), (0, 0), "max")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    y = torch.randn(2, 8, 8, 4)
    with pytest.raises(ValueError, match="floats"):
        poolfuse.fused_maxpool_3x3s2(y.to(torch.int8))
    with pytest.raises(ValueError, match="even"):
        poolfuse.fused_maxpool_3x3s2(y[:, :7])
    with pytest.raises(ValueError, match="scale and shift"):
        poolfuse.fused_maxpool_3x3s2(y, affine=True)
    # no backward: the reference's Pallas kernel cannot be differentiated
    with pytest.raises(NotImplementedError, match="backward"):
        poolfuse.fused_maxpool_3x3s2(y.requires_grad_())
    with torch.no_grad():
        poolfuse.fused_maxpool_3x3s2(y)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_pool_nd_with_the_variable_set_on_the_cpu_matches_the_reference(dtype):
    """pool_nd's 3x3/s2 max pool equals the reference's on the CPU, never
    launches K2 (no route of pool_nd takes it), and still differentiates."""
    y, _, _ = _inputs((2, 12, 12, 8), seed=7)
    y = (y * 20).astype(dtype)
    want = np.asarray(jax_pool_nd(jnp.asarray(y), kernel=3, stride=2, mode="max"))
    x = torch.from_numpy(y)
    if dtype == np.float32:
        x.requires_grad_()
    before = COUNTS["k2.launches"]
    got = pool_nd(x, kernel=3, stride=2, mode="max")
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert COUNTS["k2.launches"] == before
    if dtype == np.float32:
        got.sum().backward()
        assert x.grad is not None
