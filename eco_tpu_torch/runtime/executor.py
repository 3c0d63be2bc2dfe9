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
C)`` and contiguous for rank >= 3, ``(N, D)`` for matrices.  Params are in
PyTorch's layout: conv ``w`` is ``(C_out, C_in/g, *k)``, fc ``w`` is
``(D_out, D_in)`` (``eco_tpu_torch.convert.bridge`` converts).  The int8
layers of a quantized graph (``convert/quantize.py``) keep int8 weights in
the same shapes, conv weights in ``ops.qconv.kernel_layout`` memory order.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from eco_tpu_torch.spec.graph import TEST, TRAIN, GraphSpec, LayerSpec
from eco_tpu_torch.utils.shapes import normalize_spatial_param
from eco_tpu_torch import ops
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
    seed, the compute type (None keeps the input's), and the BN statistics
    that train mode updates."""

    train: bool = False
    seed: Optional[int] = None
    compute_dtype: Optional[torch.dtype] = None
    new_state: dict = field(default_factory=dict)

    def layer_generator(self, layer_name: str, device) -> Optional[torch.Generator]:
        """A generator on ``device`` for this layer and step: the step's seed
        mixed with ``zlib.crc32`` of the name, as the reference folds the
        name's crc32 into the step's key (``Context.layer_rng``)."""
        if self.seed is None:
            return None
        seed = self.seed ^ zlib.crc32(layer_name.encode())
        return torch.Generator(device=device).manual_seed(seed)


class LayerImpl:
    """One graph-layer type: param/state declaration + apply.

    ``param_specs`` maps name -> (shape, filler), f32, or (shape, filler,
    dtype); ``state_specs`` maps name -> (shape, fill value), f32.
    """

    def param_specs(self, spec: LayerSpec, in_shapes) -> dict:
        return {}

    def state_specs(self, spec: LayerSpec, in_shapes) -> dict:
        return {}

    def apply(self, spec, params, state, inputs, ctx: Context) -> list:
        raise NotImplementedError


class _Conv(LayerImpl):
    def param_specs(self, spec, in_shapes):
        in_shape = in_shapes[0]
        k = spec.opt("kernel_size")
        if k is None:
            k = (spec.opt("kernel_h"), spec.opt("kernel_w"))
        kernel = normalize_spatial_param(k, len(in_shape) - 2)
        cout = int(spec.opt("num_output"))
        groups = int(spec.opt("group", 1))
        out = {
            "w": ((cout, in_shape[-1] // groups) + tuple(kernel),
                  spec.opt("weight_filler", {"type": "xavier"})),
        }
        if spec.opt("bias_term", True):
            out["b"] = ((cout,), spec.opt("bias_filler", {"type": "constant"}))
        return out

    def apply(self, spec, params, state, inputs, ctx):
        return [ops.conv_nd(
            inputs[0], params["w"], params.get("b"),
            stride=spec.opt("stride", 1), pad=spec.opt("pad", 0),
            dilation=spec.opt("dilation", 1), groups=int(spec.opt("group", 1)),
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
        ctx = Context(train=False, compute_dtype=self.compute_dtype)
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
                lp[name] = fill(generator, shape, dtype, filler).to(self.device)
                if dtype == torch.int8 and len(shape) > 2:
                    lp[name] = kernel_layout(lp[name])  # K3's int8 conv weights
                if sname is not None:
                    shared_owner[sname] = lp[name]
            ls = {
                name: torch.full(shape, value, dtype=torch.float32, device=self.device)
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
              capture: Optional[Sequence[str]] = None, remat: Optional[str] = None):
        """Run the graph.  Returns (outputs, new_state): ``outputs`` maps
        every dangling top and every ``capture``d blob to its value;
        ``new_state`` is ``state`` with the BN statistics that a train-mode
        run updated replaced.

        ``generator`` draws the step's random seed (train-mode dropout and
        stochastic layers); each layer then gets its own generator on the
        tensor's device.  A CPU generator costs no device synchronisation.
        ``remat`` runs the layers under a rematerialization policy of
        ``runtime/memory.py`` (the values are the same; the backward pass
        recomputes what the policy does not keep).
        """
        seed = None
        if generator is not None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device).item())
        ctx = Context(train=self.train, seed=seed, compute_dtype=self.compute_dtype)
        blobs: dict[str, torch.Tensor] = {}
        for k, v in inputs.items():
            v = torch.as_tensor(v).to(self.device, non_blocking=True)
            declared = self.graph.inputs.get(k)
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
                outs = impl.apply(layer, lp, state.get(layer.name, {}), ins, c)
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

    def forward(self, params, state, inputs, *, generator=None, capture=None):
        return self.apply(params, state, inputs, generator=generator, capture=capture)

    def total_loss(self, outputs: Mapping[str, Any]):
        """Sum of loss tops weighted by loss_weight (solver.cpp output calc)."""
        total = 0.0
        for l in self.exec_layers:
            if l.tops and l.tops[0] in self.loss_names:
                total = total + float(l.opt("loss_weight", 1.0)) * outputs[l.tops[0]]
        return total
