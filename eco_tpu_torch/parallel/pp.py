"""Pipeline parallelism: stage-split serving over a device chain.

Twin of ``eco_tpu/parallel/pp.py``.  The reference has no pipeline
parallelism; its model-parallel construct is the batch-axis Gather/Scatter
section (gather_layer.cpp).  The serving analogue is a stage pipeline: cut
the layer graph at low-traffic boundaries, put each stage's params on one
device, and stream microbatches through the chain.  PyTorch's asynchronous
launches do the scheduling: the loop enqueues stage s of microbatch j while
stage s-1 of microbatch j+1 may still run on another device.  Stages may
share a device (one card): then the chain is one stream in order.

This is an inference construct; training an ECO-sized CNN wants DP x TP
(``parallel/{shard,tp}.py``), as the reference argues.

Cut points are the reference's:

- per-layer cost = a FLOP proxy from the blob shapes of one pass on the
  ``meta`` device (output elements x fan-in for layers with a weight of two
  or more dims, output elements otherwise);
- a cut goes where the cumulative cost crosses each stage's equal share,
  nudged to (a) the lowest-byte live set crossing the boundary and (b)
  never separating a cross-layer shared-param group (ECO-Full's 3c tower):
  the owner and every aliaser stay in one stage.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import torch

from eco_tpu_torch.runtime.executor import Program, _transposed
from eco_tpu_torch.spec.graph import GraphSpec


def _meta(tree):
    return {ln: {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in lp.items()}
            for ln, lp in tree.items()}


def _blob_shapes(program, sample_inputs: Mapping[str, Any], params):
    """Shape and dtype of every blob from one pass on the ``meta`` device
    (nothing is computed), and the params' shapes."""
    shapes = {k: torch.empty(tuple(getattr(v, "shape", v)),
                             dtype=getattr(v, "dtype", torch.float32), device="meta")
              for k, v in sample_inputs.items()}
    meta = Program(program.graph, train=program.train, compute_dtype=program.compute_dtype,
                   device="meta")
    meta_params, state = meta.init(torch.Generator(), {k: v.shape for k, v in shapes.items()})
    if params is not None:
        meta_params = _meta(params)
    tops = [t for l in program.exec_layers for t in l.tops]
    with torch.no_grad():
        outs, _ = meta.apply(meta_params, state, shapes, capture=tops)
    return {**shapes, **outs}, meta_params


def _layer_costs(program, shapes: Mapping[str, Any], params) -> list[float]:
    """FLOP proxy per exec layer from blob shapes + param shapes."""
    costs = []
    for layer in program.exec_layers:
        out_elems = sum(math.prod(shapes[t].shape) for t in layer.tops if t in shapes)
        w = params.get(layer.name, {}).get("w")
        if w is not None and w.ndim >= 2:
            # the reference's fan-in: (k..., C_in/g) of a conv, D_in of an fc,
            # (k..., C_in) of a deconv, whose port layout is (C_in, C_out/g, k...)
            shape = tuple(w.shape)
            fan = (shape[0] * math.prod(shape[2:]) if _transposed(layer)
                   else math.prod(shape[1:]))
            costs.append(out_elems * fan)
        else:
            costs.append(float(max(out_elems, 1)))
    return costs


def _live_sets(program) -> list[set[str]]:
    """live[i] = blobs produced by layers [0..i] (or graph inputs) that some
    layer >i still reads.  In-place layers re-produce their top, so the LAST
    producer index decides which side of a cut a blob lives on."""
    layers = program.exec_layers
    last_read = {}
    for i, l in enumerate(layers):
        for b in l.bottoms:
            last_read[b] = i
    live = []
    avail = set(program.input_names)
    for i, l in enumerate(layers):
        avail |= set(l.tops)
        live.append({b for b in avail if last_read.get(b, -1) > i})
    return live


def _shared_groups(program) -> list[tuple[int, int]]:
    """(first, last) exec-layer index of each cross-layer shared-param
    group; cuts inside such a span are illegal."""
    spans: dict[str, list[int]] = {}
    for i, l in enumerate(program.exec_layers):
        for ps in l.params:
            if ps.name:
                spans.setdefault(ps.name, []).append(i)
    return [(min(v), max(v)) for v in spans.values() if len(v) > 1]


@dataclass
class Stage:
    """One pipeline stage: a contiguous layer slice as its own Program."""

    program: Any           # a Program over the slice
    in_names: list[str]    # blobs this stage consumes from upstream
    out_names: list[str]   # blobs the next stage (or the caller) needs
    layer_names: list[str]


def split_stages(program, sample_inputs: Mapping[str, Any], n_stages: int,
                 params: Optional[Mapping] = None, *, device=None) -> list[Stage]:
    """Cut ``program`` into ``n_stages`` FLOP-balanced contiguous stages.

    ``sample_inputs`` (tensors, or shapes) drive one pass on the ``meta``
    device for the cost model.  ``params`` refines matmul costs when given.
    Feeding stage s's ``out_names`` dict into stage s+1 reproduces
    ``program.apply``.  Stage programs live on ``device`` (default: the
    program's).
    """
    layers = program.exec_layers
    if n_stages < 1 or n_stages > len(layers):
        raise ValueError(f"n_stages={n_stages} for {len(layers)} layers")
    shapes, params = _blob_shapes(program, sample_inputs, params)
    costs = _layer_costs(program, shapes, params)
    live = _live_sets(program)
    groups = _shared_groups(program)
    total = sum(costs)

    def legal(i: int) -> bool:  # cut AFTER layer i
        return not any(a <= i < b for a, b in groups)

    def live_bytes(i: int) -> int:
        return sum(math.prod(shapes[b].shape) * shapes[b].element_size()
                   for b in live[i] if b in shapes)

    cuts: list[int] = []
    acc = 0.0
    target = total / n_stages
    for i in range(len(layers) - 1):
        acc += costs[i]
        if acc >= target * (len(cuts) + 1) and len(cuts) < n_stages - 1:
            # nudge +-2 layers toward the cheapest legal live set
            cands = [
                j for j in range(max(i - 2, (cuts[-1] if cuts else -1) + 1),
                                 min(i + 3, len(layers) - 1))
                if legal(j)
            ]
            if not cands:
                cands = [j for j in range((cuts[-1] if cuts else -1) + 1, len(layers) - 1)
                         if legal(j)]
                cands = [j for j in cands if j >= i] or cands
            if not cands:
                # a shared-param span covers everything remaining: stop
                # cutting (fewer stages than asked is legal)
                break
            cuts.append(min(cands, key=live_bytes))
    bounds = [0] + [c + 1 for c in cuts] + [len(layers)]

    stages: list[Stage] = []
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        sl = layers[lo:hi]
        # stage inputs = the FULL live set crossing the boundary, so a skip
        # connection from stage s-1 to stage s+1 rides through stage s
        in_names = list(program.input_names) if lo == 0 else sorted(live[lo - 1])
        out_names = (sorted(live[hi - 1]) if hi < len(layers)
                     else list(program.output_names))
        g = GraphSpec(name=f"{program.graph.name}_stage{s}", inputs={}, layers=list(sl),
                      options=dict(program.graph.options))
        sp = Program(g, train=program.train, compute_dtype=program.compute_dtype,
                     device=device if device is not None else program.device)
        stages.append(Stage(sp, in_names, out_names, [l.name for l in sl]))
    return stages


def make_pp_infer_fn(program, params, state, devices: Sequence, *,
                     sample_inputs: Mapping[str, Any], output: Optional[str] = None,
                     microbatches: int = 4):
    """Pipelined inference over ``devices`` (one stage a device; a device may
    appear more than once).  Stage s's params are copied to devices[s].

    Returns ``infer(inputs) -> output``: the leading batch axis is split into
    ``microbatches`` slices streamed down the chain; activations hop devices
    with non-blocking copies.  The output equals ``program.apply`` on the
    same microbatches.
    """
    devices = [torch.device(d) for d in devices]
    stages = split_stages(program, sample_inputs, len(devices), params=params)
    n = len(stages)  # may be < len(devices) if shared-param spans limit cuts
    out_name = output or program.output_names[-1]
    placed = []
    for s, st in enumerate(stages):
        st.program.device = devices[s]
        placed.append((
            {k: {n_: v.to(devices[s]) for n_, v in params[k].items()}
             for k in st.layer_names if k in params},
            {k: {n_: v.to(devices[s]) for n_, v in state[k].items()}
             for k in st.layer_names if k in state},
        ))

    def infer(inputs: Mapping[str, Any]):
        batch = next(iter(inputs.values())).shape[0]
        m = min(microbatches, batch)
        size = batch // m
        splits = [{k: v[i * size:(i + 1) * size] for k, v in inputs.items()} for i in range(m)]
        if batch % m:
            splits.append({k: v[m * size:] for k, v in inputs.items()})
        outs = []
        with torch.no_grad():
            for blobs in splits:
                x = blobs
                for s, st in enumerate(stages):
                    want = st.out_names if s < n - 1 else [out_name]
                    x = {k: torch.as_tensor(v).to(devices[s], non_blocking=True)
                         for k, v in x.items()}
                    y, _ = st.program.apply(*placed[s], x, capture=want)
                    x = {k: y[k] for k in want}
                outs.append(x[out_name])
        return torch.cat(outs, dim=0)

    return infer
