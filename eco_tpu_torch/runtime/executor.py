"""GraphSpec -> ``Program`` on PyTorch, for inference and training.

Twin of ``eco_tpu/runtime/executor.py:Program``.  The graph IR is this
package's copy of the reference's (``eco_tpu_torch.spec.graph``); each layer
type maps to an implementation over this package's ops.

State contract, as in the reference:
    params: {layer_name: {param_name: tensor}}
    state:  {layer_name: {stat_name:  tensor}}   -- BN running stats
    apply(params, state, inputs, generator) -> (blobs, new_state)

The program is functional: ``apply`` writes nothing into ``params`` or
``state`` and returns the updated BN statistics as a new tree, so
``torch.autograd.grad`` of a loss top with respect to the param tensors is
the train step's gradient.

Blobs keep the reference's physical layout, channels-last ``(N, *spatial,
C)`` and contiguous for rank >= 3, ``(N, D)`` for matrices; a layer whose
options name a logical Caffe axis (Permute, Reduction, Bias, BatchReduction,
a generic Concat or Slice) goes through ``ops.to_logical`` and back.  Params
are in PyTorch's layout: conv ``w`` is ``(C_out, C_in/g, *k)``, deconv ``w``
``(C_in, C_out/g, *k)``, fc ``w`` ``(D_out, D_in)``
(``eco_tpu_torch.convert.bridge`` converts).  The int8
layers of a quantized graph (``convert/quantize.py``) keep int8 weights in
the same shapes, conv weights in ``ops.qconv.kernel_layout`` memory order.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from eco_tpu_torch.spec.graph import TEST, TRAIN, GraphSpec, LayerSpec
from eco_tpu_torch.utils.shapes import normalize_spatial_param
from eco_tpu_torch import ops
from eco_tpu_torch.ops import collectives
from eco_tpu_torch.ops.qconv import kernel_layout
from eco_tpu_torch.runtime import memory
from eco_tpu_torch.runtime.init import fill

# Layer types whose tops are host-provided (the data boundary).
DATA_LAYER_TYPES = {
    "videodata", "input", "imagedata", "data", "memorydata", "hdf5data",
    "windowdata", "segdata",
}


@dataclass
class Context:
    """What one ``apply`` hands every layer: the phase, the step's random
    seed, the compute type (None keeps the input's), the BN statistics that
    train mode updates, the program's device (where a layer with no
    bottoms, DummyData, makes its tops; ``meta`` while ``init`` propagates
    shapes), and, under a mesh, the process group SyncBN averages its
    moments over (``bn_axis_name``, the reference's field) and the one the
    Gather and Scatter layers cross (``data_group``)."""

    train: bool = False
    seed: Optional[int] = None
    compute_dtype: Optional[torch.dtype] = None
    new_state: dict = field(default_factory=dict)
    device: Any = "cuda"
    bn_axis_name: Any = None
    data_group: Any = None

    def layer_generator(self, layer_name: str, device) -> Optional[torch.Generator]:
        """A generator on ``device`` for this layer and step: the step's seed
        mixed with ``zlib.crc32`` of the name, as the reference folds the
        name's crc32 into the step's key (``Context.layer_rng``)."""
        if self.seed is None:
            return None
        seed = self.seed ^ zlib.crc32(layer_name.encode())
        return torch.Generator(device=device).manual_seed(seed)


class Collectives:
    """How one ``apply`` and one train step run across the ranks of a mesh
    (``eco_tpu_torch.parallel``); this base is one rank alone.

    ``bn_axis_name`` and ``data_group`` go into the ``Context``, and
    ``seed_offset`` is XORed into the step's seed.  ``start``
    sees the inputs of every ``apply``; ``input_shape`` says what an
    input's declared shape is on one rank;
    ``run_layer`` runs one layer (tensor and segment sharding change it).
    The train step calls ``reduce_grads`` on the accumulated gradients
    before the clip, ``sq_norm`` for the clip's global norm, and
    ``reduce_metric`` on the loss it reports; the eval step calls
    ``reduce_metric`` on its metric tops."""

    bn_axis_name: Any = None
    data_group: Any = None
    # mixed into the step's seed: ranks with other data draw other dropout
    # masks, replicas of the same data the same ones
    seed_offset: int = 0

    def start(self, inputs: Mapping[str, Any]) -> None:
        """Called with the inputs at the start of every ``apply``."""

    def input_shape(self, name: str, declared: tuple) -> tuple:
        return declared

    def run_layer(self, layer, impl, params, state, inputs, ctx) -> list:
        return impl.apply(layer, params, state, inputs, ctx)

    def reduce_grads(self, keys, grads) -> list:
        return grads

    def sq_norm(self, keys, grads):
        return sum(g.float().square().sum() for g in grads)

    def reduce_metric(self, value):
        return value


class LayerImpl:
    """One graph-layer type: param/state declaration + apply.

    ``param_specs`` maps name -> (shape, filler), f32, or (shape, filler,
    dtype); ``state_specs`` maps name -> (shape, fill value), f32, where the
    value is a number or an array of that shape.
    """

    def param_specs(self, spec: LayerSpec, in_shapes) -> dict:
        return {}

    def state_specs(self, spec: LayerSpec, in_shapes) -> dict:
        return {}

    def apply(self, spec, params, state, inputs, ctx: Context) -> list:
        raise NotImplementedError


def _transposed(spec) -> bool:
    """Deconvolution goes by the layer's type (deconv_layer.cpp), as in the
    reference; the ``transposed`` option overrides it for hand-built specs."""
    return spec.type == "deconvolution" or bool(spec.opt("transposed", False))


class _Conv(LayerImpl):
    """Convolution and Deconvolution (base_conv_layer.cpp)."""

    def param_specs(self, spec, in_shapes):
        in_shape = in_shapes[0]
        k = spec.opt("kernel_size")
        if k is None:
            k = (spec.opt("kernel_h"), spec.opt("kernel_w"))
        kernel = normalize_spatial_param(k, len(in_shape) - 2)
        cout = int(spec.opt("num_output"))
        groups = int(spec.opt("group", 1))
        if _transposed(spec):
            wshape = (in_shape[-1], cout // groups) + tuple(kernel)
        else:
            wshape = (cout, in_shape[-1] // groups) + tuple(kernel)
        out = {"w": (wshape, spec.opt("weight_filler", {"type": "xavier"}))}
        if spec.opt("bias_term", True):
            out["b"] = ((cout,), spec.opt("bias_filler", {"type": "constant"}))
        return out

    def apply(self, spec, params, state, inputs, ctx):
        return [ops.conv_nd(
            inputs[0], params["w"], params.get("b"),
            stride=spec.opt("stride", 1), pad=spec.opt("pad", 0),
            dilation=spec.opt("dilation", 1), groups=int(spec.opt("group", 1)),
            transposed=_transposed(spec),
        )]


class _InnerProduct(LayerImpl):
    def param_specs(self, spec, in_shapes):
        din = math.prod(in_shapes[0][1:])
        dout = int(spec.opt("num_output"))
        out = {"w": ((dout, din), spec.opt("weight_filler", {"type": "xavier"}))}
        if spec.opt("bias_term", True):
            out["b"] = ((dout,), spec.opt("bias_filler", {"type": "constant"}))
        return out

    def apply(self, spec, params, state, inputs, ctx):
        return [ops.inner_product(_flatten(inputs[0]), params["w"], params.get("b"))]


def _flatten(x):
    # Caffe flattens trailing axes in *logical* order.
    return ops.to_logical(x).reshape(x.shape[0], -1) if x.ndim > 2 else x


def _q_param_specs(base: dict) -> dict:
    """A float layer's params with an int8 ``w`` and its per-output-channel
    f32 ``w_scale``."""
    wshape = base["w"][0]
    out = {
        "w": (wshape, {"type": "constant"}, torch.int8),
        "w_scale": ((wshape[0],), {"type": "constant", "value": 1.0}),
    }
    if "b" in base:
        out["b"] = base["b"]
    return out


def _serving_only(spec, ctx):
    if ctx.train:
        # round() has zero gradient almost everywhere: training would
        # silently learn nothing through this layer
        raise ValueError(
            f"int8 layer {spec.name!r} is serving-only; train the float model "
            "and re-quantize (convert.quantize)")


def _out_scale(spec):
    s = spec.opt("out_scale")
    return float(s) if s is not None else None


class _QConv(LayerImpl):
    """int8 Convolution of a quantized graph: float or int8 in, int8 x int8
    -> int32 in K3, float or int8 out.  ``options['act_scale']`` is the
    calibrated input scale, ``options['out_scale']`` (an int8 chain) the
    scale it emits int8 at."""

    def param_specs(self, spec, in_shapes):
        return _q_param_specs(_Conv().param_specs(spec, in_shapes))

    def apply(self, spec, params, state, inputs, ctx):
        _serving_only(spec, ctx)
        return [ops.conv_nd_int8(
            inputs[0], params["w"], params["w_scale"], params.get("b"),
            act_scale=float(spec.opt("act_scale")),
            stride=spec.opt("stride", 1), pad=spec.opt("pad", 0),
            dilation=spec.opt("dilation", 1), groups=int(spec.opt("group", 1)),
            out_scale=_out_scale(spec), out_dtype=ctx.compute_dtype,
        )]


class _QInnerProduct(LayerImpl):
    """int8 InnerProduct (see _QConv)."""

    def param_specs(self, spec, in_shapes):
        return _q_param_specs(_InnerProduct().param_specs(spec, in_shapes))

    def apply(self, spec, params, state, inputs, ctx):
        _serving_only(spec, ctx)
        return [ops.inner_product_int8(
            _flatten(inputs[0]), params["w"], params["w_scale"], params.get("b"),
            act_scale=float(spec.opt("act_scale")),
            out_scale=_out_scale(spec), out_dtype=ctx.compute_dtype,
        )]


def _dequant(x, scale, dtype):
    """int8 ``x`` at ``scale`` -> float: the in-op dequant of an int8-
    accepting layer (``convert.quantize.chain_int8``), in f32, then cast to
    ``dtype`` (None keeps f32)."""
    return (x.float() * float(scale)).to(dtype or torch.float32)


def _dequant_in_scale(spec, x, ctx):
    """The single-input form (pools, global pool, Scale)."""
    if x.dtype == torch.int8 and spec.opt("in_scale") is not None:
        return _dequant(x, spec.opt("in_scale"), ctx.compute_dtype)
    return x


def _dequant_in_scales(spec, inputs, ctx):
    """The multi-input form (eltwise, concat): each int8 input at its own
    producer's scale; a float input passes."""
    scales = spec.opt("in_scales")
    if scales is None:
        return inputs
    return [
        _dequant(x, s, ctx.compute_dtype) if x.dtype == torch.int8 and s is not None else x
        for x, s in zip(inputs, scales)
    ]


class _BN(LayerImpl):
    """BN with Caffe-engine/cuDNN/frozen semantics: batch moments and a
    running update at TRAIN unless ``frozen``, running statistics otherwise."""

    def param_specs(self, spec, in_shapes):
        c = in_shapes[0][-1]
        return {
            "gamma": ((c,), spec.opt("slope_filler", {"type": "constant", "value": 1.0})),
            "beta": ((c,), spec.opt("bias_filler", {"type": "constant", "value": 0.0})),
        }

    def state_specs(self, spec, in_shapes):
        c = in_shapes[0][-1]
        return {"mean": ((c,), 0.0), "var": ((c,), 1.0)}

    def apply(self, spec, params, state, inputs, ctx):
        eps = float(spec.opt("eps", 1e-5))
        if ctx.train and not bool(spec.opt("frozen", False)):
            y, mean, var = ops.bn_train(
                inputs[0], params["gamma"], params["beta"], state["mean"],
                state["var"], eps=eps, momentum=float(spec.opt("momentum", 0.9)),
                axis_name=ctx.bn_axis_name,
            )
            ctx.new_state[spec.name] = {"mean": mean, "var": var}
            return [y]
        return [ops.bn_inference(
            inputs[0], params["gamma"], params["beta"], state["mean"],
            state["var"], eps=eps,
        )]


class _Scale(LayerImpl):
    """Per-channel scale (+ optional shift): what fold_bn leaves for a BN it
    cannot fold."""

    def param_specs(self, spec, in_shapes):
        c = in_shapes[0][-1]
        out = {"scale": ((c,), spec.opt("filler", {"type": "constant", "value": 1.0}))}
        if spec.opt("bias_term", True):
            out["shift"] = ((c,), {"type": "constant", "value": 0.0})
        return out

    def apply(self, spec, params, state, inputs, ctx):
        x = _dequant_in_scale(spec, inputs[0], ctx)
        return [ops.scale_shift(x, params["scale"], params.get("shift", 0.0))]


class _ReLU(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.relu(inputs[0], float(spec.opt("negative_slope", 0.0)))]


class _Pooling(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        k = spec.opt("kernel_size")
        if k is None and spec.opt("kernel_h") is not None:
            k = (int(spec.opt("kernel_h")), int(spec.opt("kernel_w")))
        s = spec.opt("stride", 1)
        if spec.opt("stride_h") is not None:
            s = (int(spec.opt("stride_h")), int(spec.opt("stride_w")))
        p = spec.opt("pad", 0)
        if spec.opt("pad_h") is not None:
            p = (int(spec.opt("pad_h")), int(spec.opt("pad_w")))
        x = _dequant_in_scale(spec, inputs[0], ctx)
        mode = str(spec.opt("pool", "max")).lower()
        if mode == "stochastic":
            # pooling_layer.cu StoPoolForwardTrain/Test; the reference GPU
            # kernels ignore pad, so reject it rather than silently shift
            if any(normalize_spatial_param(p, x.ndim - 2, default=0)):
                raise ValueError("STOCHASTIC pooling does not support pad")
            return [ops.stochastic_pool(
                x, k, s, train=ctx.train,
                generator=ctx.layer_generator(spec.name, x.device) if ctx.train else None,
            )]
        return [ops.pool_nd(
            x, kernel=k, stride=s, pad=p, mode=mode,
            global_pooling=bool(spec.opt("global_pooling", False)),
        )]


class _Dropout(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        x = inputs[0]
        return [ops.dropout(
            x, float(spec.opt("dropout_ratio", 0.5)), train=ctx.train,
            generator=ctx.layer_generator(spec.name, x.device),
        )]


class _Eltwise(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        op = str(spec.opt("operation", "sum"))
        draws = ctx.train and op.lower() == "stochastic_sum"
        return [ops.eltwise(
            _dequant_in_scales(spec, inputs, ctx), op, spec.opt("coeffs"), train=ctx.train,
            generator=ctx.layer_generator(spec.name, inputs[0].device) if draws else None,
        )]


class _Concat(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        # mixed-scale int8 inputs are dequantized here; int8 inputs all at one
        # scale (no in_scales set) concatenate as int8
        inputs = _dequant_in_scales(spec, inputs, ctx)
        # concat_dim is the V0/V1 legacy spelling of axis
        axis = int(spec.opt("axis", spec.opt("concat_dim", 1)))
        if inputs[0].ndim <= 2:
            return [torch.cat(inputs, dim=axis if axis != 1 else -1)]
        if axis == 1:
            return [ops.concat_channels(inputs)]
        # Generic axis: bridge through logical layout.
        logical = [ops.to_logical(x) for x in inputs]
        return [ops.to_physical(torch.cat(logical, dim=axis))]


class _Slice(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        x = ops.to_logical(inputs[0])
        axis = int(spec.opt("axis", 1))
        points = spec.opt("slice_point")
        n_out = len(spec.tops)
        if points is None:
            step = x.shape[axis] // n_out
            points = [step * i for i in range(1, n_out)]
        elif isinstance(points, (int, float)):
            points = [int(points)]  # single slice_point parses as a scalar
        pieces = torch.tensor_split(x, [int(p) for p in points], dim=axis)
        return [ops.to_physical(p) for p in pieces]


class _Reshape(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        x = ops.to_logical(inputs[0])
        dims = ops.caffe_reshape_dims(
            x.shape, spec.opt("dims"),
            axis=int(spec.opt("axis", 0)), num_axes=int(spec.opt("num_axes", -1)),
        )
        return [ops.to_physical(x.reshape(dims))]


class _Flatten(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        x = ops.to_logical(inputs[0])
        return [x.reshape(x.shape[0], -1)]


class _FoldSegments(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.fold_segments(inputs[0])]


class _UnfoldSegments(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.unfold_segments(inputs[0], int(spec.opt("num_segments")))]


class _SegmentConsensus(LayerImpl):
    """Average segment consensus (ECO-Full's 2D branch): a global average
    pool when the input still has spatial axes, then the mean over the
    segments, (N*S, D) -> (N, D)."""

    def apply(self, spec, params, state, inputs, ctx):
        x = inputs[0]
        if x.ndim > 2:
            x = ops.global_avg_pool(x)
        return [ops.segment_consensus(x, int(spec.opt("num_segments")))]


class _GlobalAvgPool(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.global_avg_pool(_dequant_in_scale(spec, inputs[0], ctx))]


class _Softmax(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.softmax(inputs[0])]


class _SoftmaxWithLoss(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.softmax_cross_entropy(
            inputs[0], inputs[1].long(), ignore_label=spec.opt("ignore_label"),
            normalization=spec.opt("normalization", "valid"),
        )]


class _Accuracy(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.topk_accuracy(
            inputs[0], inputs[1].long(), int(spec.opt("top_k", 1)),
            ignore_label=spec.opt("ignore_label"),
        )]


class _Split(LayerImpl):
    """Fan-out: one bottom copied to N tops, free in a functional executor."""

    def apply(self, spec, params, state, inputs, ctx):
        return [inputs[0]] * len(spec.tops)


class _Identity(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [inputs[0]]


class _Gather(LayerImpl):
    """Model-parallel section entry (gather_layer.cpp): under a mesh the
    batch is all-gathered over ``data`` so the section runs on the whole
    batch on every rank; its gradient is reduce-scattered, since each rank
    goes on with its own loss.  The identity outside a mesh."""

    def apply(self, spec, params, state, inputs, ctx):
        if ctx.data_group is None:
            return [inputs[0]]
        return [collectives.gather_batch(inputs[0], ctx.data_group)]


class _Scatter(LayerImpl):
    """Model-parallel section exit (scatter_layer.cpp): under a mesh each
    rank takes its slice of the batch back.  The identity outside a mesh."""

    def apply(self, spec, params, state, inputs, ctx):
        if ctx.data_group is None:
            return [inputs[0]]
        return [collectives.split_to_group(inputs[0], 0, ctx.data_group)]


# --------------------------------------------------------------------------
# The rest of Caffe's layer catalogue (eco_tpu/runtime/executor.py:385-1137)
# --------------------------------------------------------------------------


class _Permute(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        x = ops.to_logical(inputs[0])
        return [ops.to_physical(x.permute(*(int(i) for i in spec.opt("order"))))]


class _Power(LayerImpl):
    """y = (shift + scale * x)^power (power_layer.cpp)."""

    def apply(self, spec, params, state, inputs, ctx):
        a = float(spec.opt("power", 1.0))
        y = float(spec.opt("scale", 1.0)) * inputs[0] + float(spec.opt("shift", 0.0))
        return [y.pow(a) if a != 1.0 else y]


class _Sink(LayerImpl):
    """Silence, and HDF5Output in a graph (hdf5_output_layer.cpp): consume
    the bottoms, make no tops.  The file write is the host's
    (``data.hdf5.save_hdf5`` on captured blobs), as in the reference."""

    def apply(self, spec, params, state, inputs, ctx):
        return []


class _Pointwise(LayerImpl):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, spec, params, state, inputs, ctx):
        return [self.fn(inputs[0])]


class _Exp(LayerImpl):
    """y = base^(shift + scale * x), e when base is -1 (exp_layer.cpp), in f32."""

    def apply(self, spec, params, state, inputs, ctx):
        base = float(spec.opt("base", -1.0))
        y = float(spec.opt("scale", 1.0)) * inputs[0].float() + float(spec.opt("shift", 0.0))
        out = torch.exp(y) if base == -1.0 else torch.pow(base, y)
        return [out.to(inputs[0].dtype)]


class _Log(LayerImpl):
    """y = log_base(shift + scale * x), e when base is -1 (log_layer.cpp), in f32."""

    def apply(self, spec, params, state, inputs, ctx):
        base = float(spec.opt("base", -1.0))
        y = torch.log(float(spec.opt("shift", 0.0))
                      + float(spec.opt("scale", 1.0)) * inputs[0].float())
        if base > 0:
            y = y / math.log(base)
        return [y.to(inputs[0].dtype)]


class _Threshold(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.threshold(inputs[0], float(spec.opt("threshold", 0.0)))]


class _ArgMax(LayerImpl):
    """The index of the largest value on the last (channel) axis, as f32."""

    def apply(self, spec, params, state, inputs, ctx):
        return [inputs[0].argmax(dim=-1).float()]


class _LRN(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.lrn(
            inputs[0], local_size=int(spec.opt("local_size", 5)),
            alpha=float(spec.opt("alpha", 1.0)), beta=float(spec.opt("beta", 0.75)),
            k=float(spec.opt("k", 1.0)),
        )]


class _MVN(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.mvn(
            inputs[0], across_channels=bool(spec.opt("across_channels", False)),
            normalize_variance=bool(spec.opt("normalize_variance", True)),
            eps=float(spec.opt("eps", 1e-9)),
        )]


class _PReLU(LayerImpl):
    """Parametric ReLU (prelu_layer.cpp): a learned negative slope per
    channel, or one for all with ``channel_shared``; filler default 0.25.
    The input's gradient at exactly 0 is the slope, as in Caffe's backward
    (the reference's max/min form gives the mean of 1 and the slope)."""

    def param_specs(self, spec, in_shapes):
        c = 1 if spec.opt("channel_shared", False) else in_shapes[0][-1]
        return {"slope": ((c,), spec.opt("filler", {"type": "constant", "value": 0.25}))}

    def apply(self, spec, params, state, inputs, ctx):
        x = inputs[0]
        return [torch.where(x > 0, x, params["slope"].to(x.dtype) * x)]


class _BatchNormCaffe(LayerImpl):
    """Caffe's BatchNorm layer (batch_norm_layer.cpp): the statistics are
    state, scale and shift are a separate Scale layer's.  It is the BN
    layer's math with gamma 1 and beta 0: batch moments and a running update
    at ``moving_average_fraction`` in train mode unless
    ``use_global_stats``, the running statistics otherwise."""

    def state_specs(self, spec, in_shapes):
        c = in_shapes[0][-1]
        return {"mean": ((c,), 0.0), "var": ((c,), 1.0)}

    def apply(self, spec, params, state, inputs, ctx):
        x = inputs[0]
        ones = torch.ones(x.shape[-1], device=x.device)
        zeros = torch.zeros(x.shape[-1], device=x.device)
        eps = float(spec.opt("eps", 1e-5))
        if ctx.train and not bool(spec.opt("use_global_stats")):
            y, mean, var = ops.bn_train(
                x, ones, zeros, state["mean"], state["var"], eps=eps,
                momentum=float(spec.opt("moving_average_fraction", 0.999)),
                axis_name=ctx.bn_axis_name,
            )
            ctx.new_state[spec.name] = {"mean": mean, "var": var}
            return [y]
        return [ops.bn_inference(x, ones, zeros, state["mean"], state["var"], eps=eps)]


class _Bias(LayerImpl):
    """Bias (bias_layer.cpp): add a bias broadcast from logical ``axis`` over
    ``num_axes`` axes; the bias is the second bottom when there is one, else
    a learned param (filler default 0)."""

    @staticmethod
    def _bias_shape(spec, in_shape):
        logical = ((in_shape[0], in_shape[-1]) + tuple(in_shape[1:-1])
                   if len(in_shape) >= 3 else tuple(in_shape))
        axis = int(spec.opt("axis", 1)) % len(logical)
        num_axes = int(spec.opt("num_axes", 1))
        return logical[axis:] if num_axes == -1 else logical[axis:axis + num_axes]

    def param_specs(self, spec, in_shapes):
        if len(in_shapes) > 1:
            return {}
        return {"bias": (self._bias_shape(spec, in_shapes[0]),
                         spec.opt("filler", {"type": "constant", "value": 0.0}))}

    def apply(self, spec, params, state, inputs, ctx):
        x = ops.to_logical(inputs[0])
        axis = int(spec.opt("axis", 1)) % x.ndim
        b = ops.to_logical(inputs[1]) if len(inputs) > 1 else params["bias"]
        b = b.reshape((1,) * axis + tuple(b.shape) + (1,) * (x.ndim - axis - b.ndim))
        return [ops.to_physical(x + b.to(x.dtype))]


class _Loss(LayerImpl):
    """A loss with no options beyond its bottoms: ``fn(*bottoms)``."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, spec, params, state, inputs, ctx):
        return [self.fn(*inputs)]


class _HingeLoss(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.hinge_loss(inputs[0], inputs[1], norm=str(spec.opt("norm", "L1")))]


class _InfogainLoss(LayerImpl):
    """Infogain loss (infogain_loss_layer.cpp); H is the third bottom, or
    ``infogain_param { source }`` (a serialized BlobProto) read into the
    layer's state at ``init``."""

    def state_specs(self, spec, in_shapes):
        if len(in_shapes) >= 3:
            return {}
        src = spec.opt("source")
        if src is None:
            raise ValueError(f"InfogainLoss {spec.name!r} needs a third bottom or "
                             "infogain_param.source")
        from eco_tpu_torch.convert.caffemodel import load_blobproto

        c = in_shapes[0][-1]
        return {"H": ((c, c), np.asarray(load_blobproto(src), np.float32).reshape(c, c))}

    def apply(self, spec, params, state, inputs, ctx):
        h = inputs[2] if len(inputs) >= 3 else state["H"]
        return [ops.infogain_loss(inputs[0], inputs[1], h)]


class _ContrastiveLoss(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        return [ops.contrastive_loss(
            *inputs[:3], margin=float(spec.opt("margin", 1.0)),
            legacy=bool(spec.opt("legacy_version", False)),
        )]


class _Reduction(LayerImpl):
    """Reduction (reduction_layer.cpp): SUM / ASUM / SUMSQ / MEAN of every
    logical axis from ``axis`` on, times ``coeff``, in f32."""

    _OPS = {"sum": lambda x, d: x.sum(dim=d), "asum": lambda x, d: x.abs().sum(dim=d),
            "sumsq": lambda x, d: x.square().sum(dim=d), "mean": lambda x, d: x.mean(dim=d)}
    _CODES = {"1": "sum", "2": "asum", "3": "sumsq", "4": "mean"}  # the enum's numbers

    def apply(self, spec, params, state, inputs, ctx):
        x = ops.to_logical(inputs[0]).float()
        axis = int(spec.opt("axis", 0)) % x.ndim
        op = str(spec.opt("operation", "sum")).lower()
        op = self._CODES.get(op, op)
        if op not in self._OPS:
            raise ValueError(f"unknown reduction operation {op!r}")
        y = float(spec.opt("coeff", 1.0)) * self._OPS[op](x, tuple(range(axis, x.ndim)))
        return [ops.to_physical(y.to(inputs[0].dtype))]


class _Normalize(LayerImpl):
    """Per-sample L2 normalization over every non-batch axis
    (normalize_layer.cpp:21-33), in f32."""

    def apply(self, spec, params, state, inputs, ctx):
        x = inputs[0].float()
        norm = x.square().sum(dim=tuple(range(1, x.ndim)), keepdim=True).sqrt()
        return [(x / norm).to(inputs[0].dtype)]


class _BatchReduction(LayerImpl):
    """The TSN fork's BatchReduction (batch_reduction_layer.cpp): reduce
    logical ``axis`` blockwise, in f32.

    - ``level`` [l1, l2, ...] splits the axis into blocks of l_i^2, each
      summed (or averaged), and a len(levels) axis takes its place; [1] (the
      default) reduces the whole axis with no new one (:54-63);
    - TOPK (one level): the mean of the k largest along the axis (:153-168);
    - ``pos`` (one level): the sum over the diagonal of (axis, axis+1)
      (:125-129).
    ASUM and SUMSQ raise, as the reference declares them NOT_IMPLEMENTED.
    """

    def apply(self, spec, params, state, inputs, ctx):
        rp = spec.opt("reduction_param", {}) or {}
        op = str(rp.get("operation", "sum")).lower()
        levels = spec.opt("level", [1])
        if isinstance(levels, (int, float)):
            levels = [int(levels)]
        levels = [int(l) for l in levels] or [1]
        x = ops.to_logical(inputs[0])
        axis = int(rp.get("axis", 0)) % x.ndim
        xf = x.float()
        mean = op in ("mean", "4")
        if op in ("asum", "2", "sumsq", "3"):
            raise NotImplementedError(
                f"batch_reduction operation {op!r} is NOT_IMPLEMENTED in the reference too "
                "(batch_reduction_layer.cpp)")
        if bool(spec.opt("pos", False)):
            if len(levels) != 1:
                raise ValueError("pos-sensitive reduction needs one level")
            if axis + 1 >= x.ndim:
                raise ValueError(f"pos mode reduces axes ({axis}, {axis + 1}) but the input "
                                 f"has only {x.ndim} logical dims")
            tick = x.shape[axis]
            if x.shape[axis + 1] != tick:
                raise ValueError(f"pos mode needs square (axis, axis+1) dims, got "
                                 f"{x.shape[axis]}x{x.shape[axis + 1]}")
            y = torch.diagonal(xf, dim1=axis, dim2=axis + 1).sum(dim=-1)
            if mean:
                y = y / tick
            if levels != [1]:
                y = y.unsqueeze(axis)
            return [ops.to_physical(y.to(x.dtype))]
        if op in ("topk", "5"):
            if len(levels) != 1:
                raise ValueError("top-k reduction works with one level")
            k = int(rp.get("k", 1))
            y = xf.movedim(axis, -1).topk(k, dim=-1).values.mean(dim=-1)
            return [ops.to_physical(y.to(x.dtype))]
        if levels == [1]:
            y = xf.sum(dim=axis)
            return [ops.to_physical((y / x.shape[axis] if mean else y).to(x.dtype))]
        ticks = [l * l for l in levels]
        if sum(ticks) != x.shape[axis]:
            raise ValueError(f"levels {levels} (ticks {ticks}) do not cover axis size "
                             f"{x.shape[axis]}")
        pieces = [blk.sum(dim=axis) / (tick if mean else 1)
                  for blk, tick in zip(torch.split(xf, ticks, dim=axis), ticks)]
        return [ops.to_physical(torch.stack(pieces, dim=axis).to(x.dtype))]


class _SPP(LayerImpl):
    """Spatial pyramid pooling (spp_layer.cpp): level l pools a 2^l x 2^l
    grid with kernel ceil(dim / bins), pad (kernel * bins - dim + 1) / 2 and
    stride = kernel; each level flattens to (N, C * bins^2) in logical order
    and the levels are concatenated.  Pyramid height 1 is one global pool,
    not flattened (:132-139)."""

    def apply(self, spec, params, state, inputs, ctx):
        x = inputs[0]
        height = int(spec.opt("pyramid_height", 1))
        mode = str(spec.opt("pool", "max")).lower()
        if x.ndim != 4:
            raise ValueError("SPP expects a (N, H, W, C) input")
        n, h, w, _ = x.shape
        if height == 1:
            return [ops.pool_nd(x, global_pooling=True, mode=mode)]
        flats = []
        for level in range(height):
            bins = 2 ** level
            kh, kw = -(-h // bins), -(-w // bins)
            ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
            if ph >= kh or pw >= kw:
                # Caffe's PoolingLayer CHECKs pad < kernel; past it the grid
                # and so the concat's length would change
                raise ValueError(f"SPP level {level}: {bins}x{bins} bins exceed the {h}x{w} "
                                 "feature map (pad >= kernel, the reference aborts here too)")
            y = ops.pool_nd(x, kernel=(kh, kw), stride=(kh, kw), pad=(ph, pw), mode=mode)
            flats.append(ops.to_logical(y).reshape(n, -1))
        return [torch.cat(flats, dim=1)]


class _ROIPooling(LayerImpl):
    """Fast R-CNN ROI max pooling (``ops.roi_max_pool``): (R, pooled_h,
    pooled_w, C), physical channels-last."""

    def apply(self, spec, params, state, inputs, ctx):
        ph, pw = int(spec.opt("pooled_h", 0)), int(spec.opt("pooled_w", 0))
        if ph <= 0 or pw <= 0:
            # roi_pooling_layer.cpp:23-26 CHECK_GT(pooled_h/w, 0)
            raise ValueError(f"ROIPooling {spec.name!r} needs pooled_h/pooled_w > 0 "
                             f"(got {ph}x{pw})")
        return [ops.roi_max_pool(inputs[0], inputs[1], pooled_h=ph, pooled_w=pw,
                                 spatial_scale=float(spec.opt("spatial_scale", 1.0)))]


class _Filter(LayerImpl):
    """Filter (filter_layer.cpp): the batch items whose selector (the last
    bottom) is non-zero, in order, one top per data bottom.  Its output's
    size depends on the data; the reference compiles under static shapes
    and so takes the layer only with ``capacity``, as a fixed-size
    compaction: the selected rows first, in order, then zero rows up to
    ``capacity`` (selected rows past it dropped), and, with one top more
    than data bottoms, the (capacity,) bool mask of valid rows.  This port
    keeps that contract: without ``capacity`` it raises."""

    def apply(self, spec, params, state, inputs, ctx):
        cap = spec.opt("capacity")
        if cap is None:
            raise NotImplementedError(
                "Filter has a data-dependent output shape (rows whose selector is "
                "non-zero), which cannot compile under XLA's static shapes in the "
                "reference; set options['capacity'] for the fixed-size gather variant, "
                "or use masking (PARITY.md)")
        cap = int(cap)
        *data, sel = inputs
        keep = sel.reshape(sel.shape[0]) != 0
        n = keep.shape[0]
        pos = torch.cumsum(keep.long(), 0) - 1
        # idx[j]: the input row that lands at output j, n (a zero row) if none;
        # rows kept past the capacity land in slot cap, which is cut off
        idx = torch.full((cap + 1,), n, dtype=torch.long, device=keep.device)
        slot = torch.where(keep & (pos < cap), pos, torch.full_like(pos, cap))
        idx = idx.scatter(0, slot, torch.arange(n, device=keep.device))[:cap]
        outs = [torch.cat([d, d.new_zeros((1,) + tuple(d.shape[1:]))])[idx] for d in data]
        if len(spec.tops) == len(data) + 1:
            outs.append(idx < n)
        return outs


class _Im2col(LayerImpl):
    def apply(self, spec, params, state, inputs, ctx):
        k = spec.opt("kernel_size")
        if k is None and spec.opt("kernel_h") is not None:
            k = (int(spec.opt("kernel_h")), int(spec.opt("kernel_w")))
        return [ops.im2col(inputs[0], k, stride=spec.opt("stride", 1), pad=spec.opt("pad", 0),
                           dilation=spec.opt("dilation", 1))]


class _DummyData(LayerImpl):
    """DummyData (dummy_data_layer.cpp): a layer with tops and no bottoms,
    one top per declared shape (logical NCHW, made physical), filled by its
    ``data_filler`` (one for all tops, or one each) on the program's device.
    Gaussian and uniform draws come from a generator of the layer and top
    (the step's seed, or 0, mixed with the crc32 of the name), so they do
    not reproduce ``jax.random``'s bits."""

    @staticmethod
    def _shapes(spec):
        shapes = spec.opt("shape", [])
        if isinstance(shapes, dict):
            shapes = [shapes]
        dims = [tuple(int(d) for d in (s.get("dim") if isinstance(s, dict) else s))
                for s in shapes]
        if not dims and spec.opt("num") is not None:
            # legacy num/channels/height/width quadruples
            def each(v, n):
                return v if isinstance(v, list) else [v] * n

            nums = each(spec.opt("num"), 1)
            dims = [tuple(int(v) for v in q) for q in zip(
                nums, each(spec.opt("channels", 1), len(nums)),
                each(spec.opt("height", 1), len(nums)), each(spec.opt("width", 1), len(nums)))]
        if not dims:
            raise ValueError(f"DummyData {spec.name!r} declares no shape")
        return [(d[0],) + d[2:] + (d[1],) if len(d) >= 3 else d for d in dims]

    def apply(self, spec, params, state, inputs, ctx):
        fillers = spec.opt("data_filler", [{"type": "constant", "value": 0.0}])
        if isinstance(fillers, dict):
            fillers = [fillers]
        shapes = self._shapes(spec)
        if len(fillers) == 1:
            fillers = fillers * len(shapes)
        elif len(fillers) != len(shapes):
            # dummy_data_layer.cpp CHECKs 1-or-N fillers
            raise ValueError(f"DummyData {spec.name!r}: {len(fillers)} data_fillers for "
                             f"{len(shapes)} shapes (need 1 or exactly one per shape)")
        device = torch.device(ctx.device)
        outs = []
        for i, (shape, f) in enumerate(zip(shapes, fillers)):
            if device.type == "meta":
                outs.append(torch.empty(shape, device=device))
                continue
            if str(f.get("type", "constant")).lower() not in ("constant", "gaussian", "uniform"):
                raise ValueError(f"DummyData filler {f.get('type')!r} unsupported")
            seed = (ctx.seed or 0) ^ zlib.crc32(f"{spec.name}/{i}".encode())
            gen = torch.Generator(device=device).manual_seed(seed)
            outs.append(fill(gen, shape, torch.float32, f))
        return outs


IMPLS: dict[str, LayerImpl] = {
    "convolution": _Conv(),
    "innerproduct": _InnerProduct(),
    "qconvolution": _QConv(),
    "qinnerproduct": _QInnerProduct(),
    "bn": _BN(),
    "scale": _Scale(),
    "relu": _ReLU(),
    "pooling": _Pooling(),
    "dropout": _Dropout(),
    "eltwise": _Eltwise(),
    "concat": _Concat(),
    "slice": _Slice(),
    "reshape": _Reshape(),
    "flatten": _Flatten(),
    "fold_segments": _FoldSegments(),
    "unfold_segments": _UnfoldSegments(),
    "segment_consensus": _SegmentConsensus(),
    "global_avg_pool": _GlobalAvgPool(),
    "softmax": _Softmax(),
    "softmaxwithloss": _SoftmaxWithLoss(),
    "accuracy": _Accuracy(),
    "split": _Split(),
    "identity": _Identity(),
    # the rest of Caffe's catalogue, in the reference's groups
    "deconvolution": _Conv(),
    "permute": _Permute(),
    "power": _Power(),
    "silence": _Sink(),
    "bias": _Bias(),
    "gather": _Gather(),
    "scatter": _Scatter(),
    "sigmoid": _Pointwise(torch.sigmoid),
    "tanh": _Pointwise(torch.tanh),
    "absval": _Pointwise(torch.abs),
    "exp": _Exp(),
    "log": _Log(),
    "bnll": _Pointwise(ops.bnll),
    "threshold": _Threshold(),
    "argmax": _ArgMax(),
    "lrn": _LRN(),
    "mvn": _MVN(),
    "prelu": _PReLU(),
    "batchnorm": _BatchNormCaffe(),
    "euclideanloss": _Loss(ops.euclidean_loss),
    "hingeloss": _HingeLoss(),
    "sigmoidcrossentropyloss": _Loss(ops.sigmoid_cross_entropy),
    "infogainloss": _InfogainLoss(),
    "contrastiveloss": _ContrastiveLoss(),
    "multinomiallogisticloss": _Loss(ops.multinomial_logistic_loss),
    "smoothl1loss": _Loss(ops.smooth_l1_loss),
    "spp": _SPP(),
    "roipooling": _ROIPooling(),
    "filter": _Filter(),
    "im2col": _Im2col(),
    "reduction": _Reduction(),
    "normalize": _Normalize(),
    "batchreduction": _BatchReduction(),
    "dummydata": _DummyData(),
    "hdf5output": _Sink(),
}


def get_impl(layer_type: str) -> LayerImpl:
    key = layer_type.lower().replace("_", "")
    for cand in (layer_type.lower(), key):
        if cand in IMPLS:
            return IMPLS[cand]
    raise KeyError(f"no PyTorch implementation for layer type {layer_type!r}")


class Program(nn.Module):
    """A phase-filtered, executable view of a GraphSpec on one device.

    ``train`` picks the TRAIN or TEST layers (TEST by default) and the
    behaviour of BN and dropout.  ``init`` builds (params, state) by
    propagating shapes on the ``meta`` device (no real compute) and filling
    each param from a ``torch.Generator``; ``apply`` runs the graph eagerly.
    ``device`` is the card unless the caller asks for another; without a
    card, ``init`` and ``apply`` raise.
    """

    def __init__(self, graph: GraphSpec, *, train: bool = False, compute_dtype=None,
                 device="cuda"):
        super().__init__()
        self.graph = graph.filtered(TRAIN if train else TEST)
        self.train = train
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        data_layers = [
            l for l in self.graph.layers if l.type.lower() in DATA_LAYER_TYPES
        ]
        self.exec_layers = [
            l for l in self.graph.layers if l.type.lower() not in DATA_LAYER_TYPES
        ]
        self._impls = [get_impl(l.type) for l in self.exec_layers]
        # Cross-layer param sharing (LayerParameter.param name -> shared blob,
        # net.cpp param ownership): {layer: {param_index: shared_name}}.  The
        # first layer in execution order naming a blob owns it; later layers
        # alias the owner's tensor and have no entry of their own in params.
        self._shared_specs = {
            l.name: {i: ps.name for i, ps in enumerate(l.params) if ps.name}
            for l in self.exec_layers
            if any(ps.name for ps in l.params)
        }
        self.input_names = list(self.graph.inputs) + [
            t for l in data_layers for t in l.tops
        ]
        # in-place layers (top == bottom) do not consume their blob
        consumed = {
            b for l in self.exec_layers for b in l.bottoms if b not in l.tops
        }
        produced = [t for l in self.exec_layers for t in l.tops]
        self.output_names = [t for t in dict.fromkeys(produced) if t not in consumed]
        self.loss_names = [
            l.tops[0] for l in self.exec_layers if "loss" in l.type.lower() and l.tops
        ]

    def cast_input(self, v: torch.Tensor) -> torch.Tensor:
        """Float feature tensors (ndim >= 3) go to compute_dtype; labels and
        scalars keep their dtype (the reference's one input-cast policy)."""
        if self.compute_dtype is not None and v.is_floating_point() and v.ndim >= 3:
            v = v.to(self.compute_dtype)
        return v

    def init(self, generator: torch.Generator, sample_shapes: Mapping[str, Any]):
        """Build (params, state) on ``self.device`` from input shapes (or
        sample tensors, of which only the shapes are read)."""
        missing = [n for n in self.input_names if n not in sample_shapes]
        if missing:
            raise ValueError(f"sample_shapes missing {missing}")
        blobs = {
            k: self.cast_input(torch.empty(tuple(getattr(s, "shape", s)), device="meta"))
            for k, s in sample_shapes.items()
        }
        params: dict = {}
        state: dict = {}
        ctx = Context(train=False, compute_dtype=self.compute_dtype, device="meta")
        shared_owner: dict[str, torch.Tensor] = {}
        for layer, impl in zip(self.exec_layers, self._impls):
            ins = [blobs[b] for b in layer.bottoms]
            in_shapes = [tuple(x.shape) for x in ins]
            snames = self._shared_specs.get(layer.name, {})
            lp, aliased = {}, {}
            for i, (name, (shape, filler, *dtype)) in enumerate(
                    impl.param_specs(layer, in_shapes).items()):
                sname = snames.get(i)
                if sname in shared_owner:
                    owner = shared_owner[sname]
                    if tuple(owner.shape) != tuple(shape):
                        raise ValueError(
                            f"layer {layer.name!r} shares param {sname!r} with shape "
                            f"{tuple(shape)}, owner has {tuple(owner.shape)}")
                    aliased[name] = owner
                    continue
                dtype = dtype[0] if dtype else torch.float32
                lp[name] = fill(generator, shape, dtype, filler,
                                transposed=name == "w" and _transposed(layer)).to(self.device)
                if dtype == torch.int8 and len(shape) > 2:
                    lp[name] = kernel_layout(lp[name])  # K3's int8 conv weights
                if sname is not None:
                    shared_owner[sname] = lp[name]
            ls = {
                name: torch.as_tensor(value, dtype=torch.float32).to(self.device).expand(
                    shape).clone()
                for name, (shape, value) in impl.state_specs(layer, in_shapes).items()
            }
            if lp:
                params[layer.name] = lp
            if ls:
                state[layer.name] = ls
            outs = impl.apply(
                layer,
                {k: v.to("meta") for k, v in {**lp, **aliased}.items()},
                {k: v.to("meta") for k, v in ls.items()},
                ins, ctx,
            )
            for t, o in zip(layer.tops, outs):
                blobs[t] = o
        return params, state

    def apply(self, params: Mapping, state: Mapping, inputs: Mapping[str, Any],
              *, generator: Optional[torch.Generator] = None,
              capture: Optional[Sequence[str]] = None, remat: Optional[str] = None,
              dist: Optional[Collectives] = None):
        """Run the graph.  Returns (outputs, new_state): ``outputs`` maps
        every dangling top and every ``capture``d blob to its value;
        ``new_state`` is ``state`` with the BN statistics that a train-mode
        run updated replaced.

        ``generator`` draws the step's random seed (train-mode dropout and
        stochastic layers); each layer then gets its own generator on the
        tensor's device.  A CPU generator costs no device synchronisation.
        ``remat`` runs the layers under a rematerialization policy of
        ``runtime/memory.py`` (the values are the same; the backward pass
        recomputes what the policy does not keep).  ``dist`` runs it as one
        rank of a mesh (``eco_tpu_torch.parallel``): SyncBN, the Gather and
        Scatter layers' collectives, and tensor or segment sharding.
        """
        seed = None
        if generator is not None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device).item())
            if dist is not None:
                seed ^= dist.seed_offset
        ctx = Context(train=self.train, seed=seed, compute_dtype=self.compute_dtype,
                      device=self.device,
                      bn_axis_name=None if dist is None else dist.bn_axis_name,
                      data_group=None if dist is None else dist.data_group)
        blobs: dict[str, torch.Tensor] = {}
        if dist is not None:
            dist.start(inputs)
        for k, v in inputs.items():
            v = torch.as_tensor(v).to(self.device, non_blocking=True)
            declared = self.graph.inputs.get(k)
            if declared is not None and dist is not None:
                declared = dist.input_shape(k, declared)
            if declared is not None and tuple(v.shape[1:]) != tuple(declared[1:]):
                # batch (axis 0) is free; a wrong segment count would otherwise
                # be silently reinterpreted by the segment reshapes
                raise ValueError(
                    f"input {k!r}: shape {tuple(v.shape)} does not match declared "
                    f"{declared} (non-batch dims must agree)"
                )
            blobs[k] = self.cast_input(v)
        wanted = list(self.output_names) + [
            c for c in (capture or ()) if c not in self.output_names
        ]
        shared: dict[str, torch.Tensor] = {}  # shared name -> the owner's tensor

        def run(steps, blobs, first=True):
            # a recompute (first=False) writes its BN statistics elsewhere
            c = ctx if first else dataclasses.replace(ctx, new_state={})
            for layer, impl in steps:
                ins = [blobs[b] for b in layer.bottoms]
                lp = self._layer_params(layer, impl, params, ins, shared)
                st = state.get(layer.name, {})
                outs = (impl.apply(layer, lp, st, ins, c) if dist is None
                        else dist.run_layer(layer, impl, lp, st, ins, c))
                blobs.update(zip(layer.tops, outs))

        steps = list(zip(self.exec_layers, self._impls))
        if remat is None:
            run(steps, blobs)
        else:
            memory.run_with_remat(steps, blobs, wanted, remat, run)
        return {k: blobs[k] for k in wanted}, {**state, **ctx.new_state}

    def _layer_params(self, layer, impl, params, ins, shared):
        """The layer's params, with each shared one it does not own aliased
        to its owner's tensor, so autograd sums the gradients onto the one
        owned leaf."""
        lp = params.get(layer.name, {})
        snames = self._shared_specs.get(layer.name)
        if not snames:
            return lp
        lp = dict(lp)
        for i, pname in enumerate(impl.param_specs(layer, [tuple(x.shape) for x in ins])):
            sname = snames.get(i)
            if sname is None:
                continue
            if pname in lp:
                shared.setdefault(sname, lp[pname])
            elif sname in shared:
                lp[pname] = shared[sname]
            else:
                raise ValueError(f"layer {layer.name!r} shares param {sname!r} but no owner "
                                 "layer provided it")
        return lp

    def forward(self, params, state, inputs, *, generator=None, capture=None, dist=None):
        return self.apply(params, state, inputs, generator=generator, capture=capture,
                          dist=dist)

    def total_loss(self, outputs: Mapping[str, Any]):
        """Sum of loss tops weighted by loss_weight (solver.cpp output calc)."""
        total = 0.0
        for l in self.exec_layers:
            if l.tops and l.tops[0] in self.loss_names:
                total = total + float(l.opt("loss_weight", 1.0)) * outputs[l.tops[0]]
        return total
