"""The uint8 crop/normalize kernel's plain version against the JAX kernel.

Every output value is an integer in [-123, 151] (exact in bf16), and the
int8 path divides and rounds half to even on both sides, so the plain
PyTorch version must equal the Pallas kernel (run in interpret mode, as its
own tests run it on the CPU) and the portable XLA twin bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eco_tpu.convert.export_hlo import _crop_normalize_xla
from eco_tpu.ops.pallas.preprocess import preprocess_on_device as jax_preprocess
from eco_tpu_torch.ops import _build, preprocess
from eco_tpu_torch.utils.tracing import COUNTS

N, S, H, W, CROP = 4, 2, 20, 24, 16
MEAN = (104.0, 117.0, 123.0)
# offsets at 0 and at H-crop / W-crop, each with mirror off and on
H_OFF = np.array([0, 0, H - CROP, H - CROP], np.int32)
W_OFF = np.array([0, 0, W - CROP, W - CROP], np.int32)
MIRROR = np.array([False, True, False, True])

CASES = {
    "f32": (jnp.float32, torch.float32, None),
    "bf16": (jnp.bfloat16, torch.bfloat16, None),
    "int8_scale_0.37": (jnp.int8, torch.int8, 0.37),
    "int8_scale_2_half_ties": (jnp.int8, torch.int8, 2.0),
}


def _frames(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (N, S, H, W, 3), dtype=np.uint8)


# crop 7: 21 values a row, a multiple of 16 bytes in none of the types (the
# kernel's unaligned span heads and tails)
@pytest.mark.parametrize("crop", [CROP, 7])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla_twin"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_bit_exact_with_jax(case, oracle, crop):
    jdt, tdt, act_scale = CASES[case]
    frames = _frames()
    h_off = np.array([0, 0, H - crop, H - crop], np.int32)
    w_off = np.array([0, 0, W - crop, W - crop], np.int32)
    j_args = (jnp.asarray(frames), jnp.asarray(h_off), jnp.asarray(w_off), jnp.asarray(MIRROR))
    if oracle == "pallas_interpret":
        want = jax_preprocess(*j_args, crop=crop, mean=MEAN, out_dtype=jdt,
                              interpret=True, act_scale=act_scale)
    else:
        want = _crop_normalize_xla(*j_args, crop=crop, mean=MEAN, out_dtype=jdt,
                                   act_scale=act_scale)
    got = preprocess.preprocess_on_device(
        torch.from_numpy(frames), torch.from_numpy(h_off), torch.from_numpy(w_off),
        torch.from_numpy(MIRROR), crop=crop, mean=MEAN, out_dtype=tdt,
        act_scale=act_scale)
    assert got.dtype == tdt and tuple(got.shape) == (N, S, crop, crop, 3)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_cpu_tensor_uses_plain_version_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"CPU call tried to build {name}")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = COUNTS["k1.launches"]
    args = (torch.from_numpy(_frames(1)), torch.from_numpy(H_OFF),
            torch.from_numpy(W_OFF), torch.from_numpy(MIRROR))
    got = preprocess.preprocess_on_device(*args, crop=CROP, mean=MEAN)
    want = preprocess.crop_normalize_reference(*args, crop=CROP, mean=MEAN,
                                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16  # the reference's default clip type
    assert torch.equal(got, want)
    assert COUNTS["k1.launches"] == before


@pytest.mark.parametrize("kind", ["numpy", "list", "cpu_int64", "cpu_int32", "bool"])
def test_pack_aug_packs_host_values_into_one_int32_tensor(kind):
    """Host offsets and mirrors of any integer or bool type become one int32
    (3, N) tensor: rows h_off, w_off, mirror (as 0/1); offsets past int32
    are clamped to its range, which the kernel then clamps into the frame."""
    h, w, m = [0, 5, 2**40, -3], [7, 0, 1, 2], [0, 1, 1, 0]
    conv = {"numpy": lambda v: np.array(v),
            "list": list,
            "cpu_int64": lambda v: torch.tensor(v, dtype=torch.int64),
            "cpu_int32": lambda v: torch.tensor(np.clip(v, -2**31, 2**31 - 1), dtype=torch.int32),
            "bool": lambda v: torch.tensor(v, dtype=torch.int64)}[kind]
    mirror = (torch.tensor(m, dtype=torch.bool) if kind == "bool"
              else np.array(m, bool) if kind == "numpy" else conv(m))
    packed = preprocess._pack_aug(conv(h), conv(w), mirror, 4, torch.device("cpu"))
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (3, 4)
    assert packed.tolist() == [[0, 5, 2**31 - 1, -3], w, m]
    with pytest.raises(ValueError, match="w_off must have shape"):
        preprocess._pack_aug(conv(h), conv(w)[:3], mirror, 4, "cpu")
    with pytest.raises(ValueError, match="mirror must have shape"):
        preprocess._pack_aug(conv(h), conv(w), [0, 1], 4, "cpu")


def test_cpu_frames_with_numpy_offsets_take_the_plain_version():
    """numpy offsets and mirrors on CPU frames: the plain version's result,
    no launch."""
    frames = torch.from_numpy(_frames(3))
    before = COUNTS["k1.launches"]
    for dtype, act_scale in ((torch.bfloat16, None), (torch.float32, None), (torch.int8, 0.37)):
        kw = dict(crop=CROP, mean=MEAN, out_dtype=dtype, act_scale=act_scale)
        got = preprocess.preprocess_on_device(frames, H_OFF, W_OFF, MIRROR, **kw)
        want = preprocess.crop_normalize_reference(
            frames, torch.from_numpy(H_OFF), torch.from_numpy(W_OFF),
            torch.from_numpy(MIRROR), **kw)
        assert got.dtype == dtype and torch.equal(got, want)
    assert COUNTS["k1.launches"] == before


def test_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("preprocess")


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs its source, waits until every build has started,
# then fails on a source that says FAIL or writes what it saw to -o
while [ "$1" != "-o" ]; do shift; done
out="$2"; src="$3"
echo "$src" >> "$LOG"
i=0
while [ "$(wc -l < "$LOG")" -lt "$EXPECT" ] && [ $i -lt 50 ]; do sleep 0.1; i=$((i+1)); done
if grep -q FAIL "$src"; then echo "error in $src"; exit 3; fi
if [ "$(wc -l < "$LOG")" -ge "$EXPECT" ]; then echo together > "$out"; else echo alone > "$out"; fi
"""


@pytest.mark.parametrize("fail", [False, True])
def test_build_all_runs_one_nvcc_per_source_together(monkeypatch, tmp_path, fail):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("a")
    (csrc / "b.cu").write_text("FAIL" if fail else "b")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("LOG", str(tmp_path / "log"))
    monkeypatch.setenv("EXPECT", "2")
    if fail:
        with pytest.raises(RuntimeError, match="building b.cu"):
            _build.build_all(["a", "b"])
        assert not any(p.name.startswith("libb") for p in build.iterdir())
    else:
        outs = _build.build_all(["a", "b"])
        assert [p.name.split("-")[0] for p in outs] == ["liba", "libb"]
        assert all(p.read_text().strip() == "together" for p in outs)
        assert _build.build_all(["a", "b"]) == outs  # built: nothing to do
    assert sorted(p.name for p in build.iterdir() if not p.name.startswith("lib")) == []


def _plain(frames, h_off, w_off):
    return preprocess.crop_normalize_reference(
        torch.from_numpy(frames), torch.from_numpy(h_off), torch.from_numpy(w_off),
        torch.from_numpy(MIRROR), crop=CROP, mean=MEAN, out_dtype=torch.float32)


def test_offsets_are_clamped_into_the_frame():
    """Offsets past the far edge read the last in-frame window, as
    lax.dynamic_slice clamps in the XLA twin; negative offsets read the
    window at 0 (dynamic_slice would wrap them first, which no caller means).
    The kernel clamps the same way, so it never reads outside the frame."""
    frames = _frames(2)
    h_off = np.array([H, 100, 0, H - CROP], np.int32)
    w_off = np.array([3, W, 1000, W - CROP], np.int32)
    want = _crop_normalize_xla(
        jnp.asarray(frames), jnp.asarray(h_off), jnp.asarray(w_off), jnp.asarray(MIRROR),
        crop=CROP, mean=MEAN, out_dtype=jnp.float32)
    np.testing.assert_array_equal(_plain(frames, h_off, w_off).numpy(), np.asarray(want))
    neg = np.array([-5, -1, 0, -100], np.int32)
    zero = np.zeros(N, np.int32)
    assert torch.equal(_plain(frames, neg, neg), _plain(frames, zero, zero))
