"""int8 quantized serving ops: per-channel weights, calibrated activations.

Twin of ``eco_tpu/ops/quant.py``, ported (it imports JAX).  The scheme is
the reference's symmetric post-training quantization:

- weights: per-output-channel int8, ``s_w[c] = max|w[c]| / 127``.  Weights
  are in PyTorch's layout, so the output channel is axis **0** (the
  reference's is -1); a zero channel gets scale 1;
- activations: per-tensor int8 at a calibrated static scale
  (``eco_tpu_torch.convert.quantize.calibrate``);
- compute: int8 x int8 -> int32 in kernel K3 (``ops/qconv.py``), rescaled
  by ``act_scale * w_scale[c]`` with the bias added in f32, then cast to the
  float compute type or requantized to int8 (an int8 chain).  K3 fuses this
  epilogue; ``qconv.epilogue`` is the reference's ``_epilogue``.

Every division is by a 0-d f32 tensor on the operand's device, never by a
Python scalar (CUDA divides by a CPU scalar through its reciprocal), and
rounding is half to even (``torch.round``), as ``jnp.round``.  The 0-d
tensor is made by ``torch.full``, a fill on the device: ``torch.tensor`` on
a CUDA device copies from pageable host memory, which waits for the stream.
"""

from __future__ import annotations

import torch

from eco_tpu_torch.ops import qconv
from eco_tpu_torch.ops.conv import split_pad


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def quantize_weight(w: torch.Tensor, *, axis: int = 0):
    """Per-output-channel symmetric int8: returns (w_q, scale).

    ``scale`` has the length of ``w``'s ``axis``; ``w_q`` keeps ``w``'s
    shape.
    """
    axis = axis % w.ndim
    wf = w.float()
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = wf.abs().amax(dim=red)
    scale = torch.where(amax > 0, amax / _scalar(127.0, amax), torch.ones_like(amax))
    shape = [1] * w.ndim
    shape[axis] = -1
    w_q = torch.clamp(torch.round(wf / scale.reshape(shape)), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-tensor symmetric int8 with a static (calibrated) scale."""
    return torch.clamp(torch.round(x.float() / _scalar(scale, x)), -127, 127).to(torch.int8)


def _quantized_input(x, act_scale, out_dtype):
    """int8 ``x`` passes as it is (an upstream layer emitted it at
    ``act_scale``) and defaults the output to f32; a float ``x`` is
    quantized here and keeps its type at the output."""
    if x.dtype == torch.int8:
        return x, out_dtype or torch.float32
    return quantize_act(x, act_scale), out_dtype or x.dtype


def _scale_vec(act_scale: float, w_scale: torch.Tensor) -> torch.Tensor:
    # f32(act_scale) * w_scale in f32, as the reference's weak-typed product
    # (a multiply by a Python scalar is exact; only the division is not)
    return w_scale.float() * float(act_scale)


def conv_nd_int8(x, w_q, w_scale, b=None, *, act_scale: float, stride=1, pad=0,
                 dilation=1, groups: int = 1, out_scale: float | None = None,
                 out_dtype=None):
    """Quantized ND conv: int8 in K3, float or int8 at the edges.

    ``x``: float (N, *spatial, C_in), quantized here at ``act_scale``, or
    int8 already at ``act_scale``.  ``w_q``: int8 (C_out, C_in/g, *k),
    best in ``qconv.kernel_layout``; ``w_scale``: f32 (C_out,).
    ``out_scale`` set -> int8 output at that scale.  ``pad`` as
    ``ops.conv.conv_nd`` takes it: an asymmetric one pads the int8 input.
    """
    x_q, out_dtype = _quantized_input(x, act_scale, out_dtype)
    x_q, pad = split_pad(x_q, pad)
    # K3 reads channels-last rows; the executor's blobs already are
    return qconv.qconv_nd(
        x_q.contiguous(), w_q, _scale_vec(act_scale, w_scale),
        b.float() if b is not None else None,
        stride=stride, pad=pad, dilation=dilation, groups=groups,
        out_scale=out_scale, out_dtype=out_dtype,
    )


def inner_product_int8(x, w_q, w_scale, b=None, *, act_scale: float,
                       out_scale: float | None = None, out_dtype=None):
    """Quantized (N, D_in) x (D_out, D_in)^T, edge types as ``conv_nd_int8``.

    It runs through K3 as a 1x1 convolution over (N, 1, 1, D_in), so one
    kernel holds every int8 product of the path."""
    x_q, out_dtype = _quantized_input(x, act_scale, out_dtype)
    n, d_in = x_q.shape
    d_out = w_q.shape[0]
    y = qconv.qconv_nd(
        x_q.reshape(n, 1, 1, d_in).contiguous(), w_q.reshape(d_out, d_in, 1, 1),
        _scale_vec(act_scale, w_scale), b.float() if b is not None else None,
        out_scale=out_scale, out_dtype=out_dtype,
    )
    return y.reshape(n, d_out)
