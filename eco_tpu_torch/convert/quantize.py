"""Post-training int8 quantization for serving.

Twin of ``eco_tpu/convert/quantize.py``, ported (it imports JAX).  The
pipeline is the reference's: fold BN into the preceding convs
(``convert.load.fold_bn``), calibrate per-tensor activation ranges on
representative batches, rewrite every forward Convolution/InnerProduct to
its int8 twin (``qconvolution``/``qinnerproduct``, executor ``_QConv``/
``_QInnerProduct``) with per-output-channel int8 weights, then keep tensors
int8 between quantized layers where the dataflow allows (``chain_int8``)
and let the serving plane feed conv1 int8 (``int8_input_rewrite``).

The graph logic (``chain_int8``, ``int8_input_rewrite``) is the reference's
line for line, including two of its open findings, which the port matches
rather than fixes: ``int8_input_rewrite`` does not pass through ReLU though
its docstring says so, and a quantized consumer whose top reuses the
tracked input name does not end the tracked range.

Rewrites are conservative: transposed convolutions and layers whose
calibrated input range is degenerate (max 0) stay float; everything else
runs unchanged in the same ``Program``.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from eco_tpu_torch.spec.graph import GraphSpec
from eco_tpu_torch.convert.load import fold_bn
from eco_tpu_torch.ops.qconv import kernel_layout
from eco_tpu_torch.ops.quant import quantize_weight
from eco_tpu_torch.runtime.executor import Program

_QUANT_TYPES = {"convolution": "qconvolution", "innerproduct": "qinnerproduct"}


def _quantizable(layer) -> bool:
    if layer.type.lower() not in _QUANT_TYPES:
        return False
    if layer.type.lower() == "convolution" and layer.opt("transposed", False):
        return False
    return True


def calibrate_blobs(program, params, state,
                    batches: Sequence[Mapping[str, Any]],
                    blobs: Sequence[str]) -> dict[str, float]:
    """Per-tensor |max| of arbitrary blobs over calibration batches.

    One capture pass per batch (``Program.apply(capture=...)``) under
    ``torch.no_grad``, maxes taken in f32 on the device and read back once
    per batch; returns {blob: max} as host floats.  For a blob rewritten in
    place (an in-place ReLU top) the captured value is the final one --
    what downstream consumers see."""
    blobs = sorted(set(blobs))
    agg = {b: 0.0 for b in blobs}
    with torch.no_grad():
        for batch in batches:
            outs, _ = program.apply(params, state, batch, capture=blobs)
            maxes = torch.stack([outs[b].float().abs().max() for b in blobs]).tolist()
            for b, m in zip(blobs, maxes):
                agg[b] = max(agg[b], m)
    return agg


def calibrate(program, params, state, batches: Sequence[Mapping[str, Any]],
              ) -> dict[str, float]:
    """Per-tensor |max| of every quantizable layer's input blob, as
    {layer_name: act_max}, ready to bake into the quantized GraphSpec."""
    targets = {l.name: l.bottoms[0] for l in program.exec_layers if _quantizable(l)}
    agg = calibrate_blobs(program, params, state, batches, targets.values())
    return {lname: agg[b] for lname, b in targets.items()}


def quantize_graph(graph: GraphSpec, params: Mapping,
                   act_maxes: Mapping[str, float]):
    """Rewrite quantizable layers to q-types; returns (qgraph, qparams,
    quantized layer names).

    ``act_maxes`` maps layer name -> calibrated |max| of its input; layers
    absent from it (or with a degenerate range) keep their float form.
    Conv weights come out in ``kernel_layout``, reordered once here.
    """
    qlayers = []
    qparams = {k: dict(v) for k, v in params.items()}
    quantized: list[str] = []
    for l in graph.layers:
        amax = act_maxes.get(l.name, 0.0)
        if not (_quantizable(l) and amax > 0.0 and l.name in params):
            qlayers.append(l)
            continue
        w_q, w_scale = quantize_weight(params[l.name]["w"], axis=0)
        if w_q.ndim >= 3:
            w_q = kernel_layout(w_q)
        qparams[l.name] = {**qparams[l.name], "w": w_q, "w_scale": w_scale}
        opts = dict(l.options)
        opts["act_scale"] = float(amax) / 127.0
        qlayers.append(l.replace(type=_QUANT_TYPES[l.type.lower()], options=opts))
        quantized.append(l.name)
    qgraph = GraphSpec(
        name=graph.name + "_int8",
        inputs=dict(graph.inputs),
        layers=qlayers,
        options=dict(graph.options),
    )
    return qgraph, qparams, quantized


_TRANSPARENT = {"relu", "reshape", "permute", "flatten", "dropout",
                "fold_segments", "unfold_segments"}
_Q_TYPES = ("qconvolution", "qinnerproduct")


def chain_int8(graph: GraphSpec, top_maxes: Mapping[str, float] | None = None,
               ) -> tuple[GraphSpec, list[str]]:
    """Fuse adjacent quantized layers into int8-resident chains.

    After ``quantize_graph`` every q-layer quantizes its float input and
    dequantizes its int32 accumulator back to float.  This pass keeps
    tensors int8 between quantized layers whenever the dataflow allows:

    - a q-layer whose output (transitively through ReLU / MAX pool /
      reshape / permute / dropout / concat) is consumed only by other
      quantized layers emits int8 directly, requantized in its epilogue
      (``options['out_scale']``);
    - consuming q-layers skip their quantize pass (their ``act_scale`` is
      overridden to the producer's emit scale);
    - AVE pools, global pools, Scale and Eltwise SUM inside a chain accept
      int8 and dequantize in-op (``in_scale``/``in_scales``);
    - anything else (loss/softmax/graph outputs/float layers) ends the
      chain: the producer keeps its float epilogue.

    A producer's emitted scale is its own calibrated output range when
    ``top_maxes`` (blob -> calibrated |max| of the q-layer tops) has it,
    else the largest calibrated act_scale reachable from the value.  Every
    consumer of an int8 value is rewritten to the exact emitted scale.
    Returns (new_graph, chained_layer_names).
    """
    layers = list(graph.layers)
    # SSA over the blob names (in-place layers rewrite the same name)
    ver: dict[str, int] = {}
    layer_in: list[list] = []
    layer_out: list[list] = []
    consumers: dict[tuple, list[int]] = {}
    for name in graph.inputs:
        ver[name] = 0
    for idx, l in enumerate(layers):
        ins = [(b, ver.get(b, 0)) for b in l.bottoms]
        for v in ins:
            consumers.setdefault(v, []).append(idx)
        outs = []
        for t in l.tops:
            ver[t] = ver.get(t, 0) + 1
            outs.append((t, ver[t]))
            consumers.setdefault((t, ver[t]), [])
        layer_in.append(ins)
        layer_out.append(outs)

    def _lt(l):
        return l.type.lower()

    def _transparent(l) -> bool:
        t = _lt(l)
        if t == "relu":
            return not float(l.opt("negative_slope", 0.0) or 0.0)
        if t == "pooling":
            return str(l.opt("pool", "max")).lower() == "max"
        return t in _TRANSPARENT

    def _accepting(l) -> bool:
        # float ops that can take int8 in and dequantize internally
        t = _lt(l)
        if t == "pooling":
            return str(l.opt("pool", "max")).lower() in ("ave", "avg", "mean")
        if t == "eltwise":
            return str(l.opt("operation", "sum")).lower() == "sum"
        return t in ("global_avg_pool", "scale")

    # backward pass: can value v be int8, and at what preferred scale?
    # feasible[v]: every consumer accepts int8.  prefer[v]: max calibrated
    # act_scale reachable (None if only scale-free consumers: no chain).
    feasible: dict[tuple, bool] = {}
    prefer: dict[tuple, float | None] = {}

    def _value_info(v):
        cons = consumers.get(v, [])
        if not cons:
            return False, None  # graph output / unused: stay float
        scales = []
        for ci in cons:
            l = layers[ci]
            t = _lt(l)
            if t in _Q_TYPES and layer_in[ci][0] == v:
                scales.append(float(l.opt("act_scale")))
            elif t == "concat" or _transparent(l):
                vo = layer_out[ci][0]
                if not feasible.get(vo, False):
                    return False, None
                if prefer.get(vo) is not None:
                    scales.append(prefer[vo])
            elif _accepting(l):
                # takes int8 at any scale.  Eltwise SUM also lends its
                # downstream preference as a hint; pools do not (averaging
                # shrinks the post-pool range, so its scale would clip)
                if t == "eltwise" and prefer.get(layer_out[ci][0]) is not None:
                    scales.append(prefer[layer_out[ci][0]])
            else:
                return False, None
        return True, (max(scales) if scales else None)

    for idx in range(len(layers) - 1, -1, -1):
        for v in layer_out[idx]:
            feasible[v], prefer[v] = _value_info(v)

    # forward pass: actual emit scales + option rewrites
    emit: dict[tuple, float] = {}  # value -> int8 scale on the wire
    new_opts: dict[int, dict] = {}
    chained: list[str] = []
    for idx, l in enumerate(layers):
        t = _lt(l)
        opts = new_opts.setdefault(idx, dict(l.options))
        if t in _Q_TYPES:
            vin = layer_in[idx][0]
            if vin in emit:
                opts["act_scale"] = emit[vin]  # exact dequant of wire int8
                opts["int8_in"] = True
            vout = layer_out[idx][0]
            if feasible.get(vout):
                s = None
                if top_maxes and top_maxes.get(l.tops[0], 0.0) > 0.0:
                    s = float(top_maxes[l.tops[0]]) / 127.0
                elif prefer.get(vout) is not None:
                    s = prefer[vout]
                if s is not None:
                    opts["out_scale"] = s
                    emit[vout] = s
                    chained.append(l.name)
        elif _transparent(l):
            vin = layer_in[idx][0]
            if vin in emit:
                emit[layer_out[idx][0]] = emit[vin]
        elif t == "concat":
            ss = [emit.get(v) for v in layer_in[idx]]
            if all(s is not None for s in ss) and len(set(ss)) == 1:
                emit[layer_out[idx][0]] = ss[0]  # int8 passes through
            elif any(s is not None for s in ss):
                opts["in_scales"] = ss  # mixed: dequant int8 inputs in-op
        elif _accepting(l):
            ss = [emit.get(v) for v in layer_in[idx]]
            if any(s is not None for s in ss):
                if t in ("pooling", "global_avg_pool", "scale"):
                    opts["in_scale"] = ss[0]
                else:
                    opts["in_scales"] = ss
        # all other layer types: the analysis guarantees no int8 reaches them

    qlayers = [
        l.replace(options=new_opts[i]) if new_opts[i] != dict(l.options) else l
        for i, l in enumerate(layers)
    ]
    return GraphSpec(
        name=graph.name,
        inputs=dict(graph.inputs),
        layers=qlayers,
        options=dict(graph.options),
    ), chained


def int8_input_rewrite(graph: GraphSpec, input_name: str = "data",
                       ) -> tuple[GraphSpec, float | None]:
    """Let the feed quantize: if every consumer of graph input
    ``input_name`` -- transitively through layout-only layers (reshape,
    permute, flatten, dropout, segment folds) -- is a quantized conv/fc,
    rewrite those consumers to dequantize at one shared scale and return
    ``(graph', scale)``.  The serving plane (K1's int8 output) then ships
    int8 straight into conv1.  Any float consumer makes this unsound:
    ``(graph, None)``.

    The shared scale is the max of the consumers' calibrated act_scales,
    which covers every consumer's observed range; each consumer's
    ``act_scale`` is rewritten to it, so the dequantization is exact.
    """
    # layout-only ops: value-preserving on int8.  ReLU is not among them,
    # as in the reference (whose docstring lists it).  The port's
    # space-to-depth (zero pads, then a rearrangement) is one too.
    _LAYOUT = {"reshape", "permute", "flatten", "dropout",
               "fold_segments", "unfold_segments", "space_to_depth"}
    tracked = {input_name}
    consumers: list[int] = []
    for idx, l in enumerate(graph.layers):
        t = l.type.lower()
        hit = [b for b in l.bottoms if b in tracked]
        if not hit:
            # an unrelated producer overwriting a tracked name ends that
            # name's tracked range -- except a bottom-less layer, which is
            # the feed (a Data/VideoData top produces the input blob)
            if l.bottoms:
                tracked.difference_update(l.tops)
            continue
        # as in the reference, a consumer whose top reuses a tracked name
        # leaves that name tracked
        if t in _Q_TYPES and l.bottoms[0] in tracked and len(hit) == 1:
            consumers.append(idx)
        elif t in _LAYOUT and len(l.bottoms) == 1:
            tracked.update(l.tops)
        else:
            return graph, None
    if not consumers:
        return graph, None
    scale = max(float(graph.layers[i].opt("act_scale")) for i in consumers)
    new_layers = list(graph.layers)
    for i in consumers:
        l = new_layers[i]
        new_layers[i] = l.replace(options={**dict(l.options), "act_scale": scale})
    return GraphSpec(
        name=graph.name,
        inputs=dict(graph.inputs),
        layers=new_layers,
        options=dict(graph.options),
    ), scale


def quantize_for_serving(program, params, state,
                         calib_batches: Sequence[Mapping[str, Any]],
                         *, fold: bool = True, chain: bool = True,
                         compute_dtype=None):
    """One-call post-training quantization: fold BN -> calibrate -> rewrite
    -> int8 chains (``chain=False`` keeps the per-layer float edges).

    Returns (qprogram, qparams, qstate, report), the programs on
    ``program``'s device.  ``report['quantized']`` lists the rewritten
    layers; ``report['chained']`` the subset emitting int8 directly;
    ``report['act_scales']`` the baked scales.
    """
    graph, p, s = program.graph, params, state
    compute_dtype = compute_dtype or program.compute_dtype
    if fold:
        graph, p, s = fold_bn(graph, p, s)
        program = Program(graph, compute_dtype=compute_dtype, device=program.device)
    # one capture pass measures both the q-layer input ranges (act_scale)
    # and their output ranges (chain_int8's emit scales)
    targets = {l.name: l.bottoms[0] for l in program.exec_layers if _quantizable(l)}
    tops = {l.tops[0] for l in program.exec_layers if _quantizable(l)}
    agg = calibrate_blobs(program, p, s, calib_batches, set(targets.values()) | tops)
    act_maxes = {lname: agg[b] for lname, b in targets.items()}
    qgraph, qp, quantized = quantize_graph(graph, p, act_maxes)
    chained: list[str] = []
    if chain:
        qgraph, chained = chain_int8(qgraph, top_maxes={b: agg[b] for b in tops})
    qprog = Program(qgraph, compute_dtype=compute_dtype, device=program.device)
    report = {
        "quantized": quantized,
        "chained": chained,
        "act_scales": {
            l.name: l.opt("act_scale") for l in qgraph.layers
            if l.type in ("qconvolution", "qinnerproduct")
        },
    }
    return qprog, qp, s, report
