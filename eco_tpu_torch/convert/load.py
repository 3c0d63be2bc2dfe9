"""Weight import from caffemodels, and BN folding for inference (twin of
``eco_tpu/convert/load.py``).

Ported rather than borrowed: the reference's versions compute with
``jax.numpy``, which the port may not import.  The decisions are the
reference's; only the weight layout differs.  This package keeps Caffe's
own axis order, conv ``(C_out, C_in/g, *k)`` and fc ``(D_out, D_in)``, so
a caffemodel blob loads with a reshape at most, where the reference
transposes it.

- :func:`import_caffe_weights`: name-based transfer of a caffemodel's blobs
  into copies of a Program's (params, state) (CopyTrainedLayersFrom,
  net.cpp:852-876); BN takes 4 blobs (1,C,1,1): slope, bias, running mean,
  running var (``inv_std`` checkpoints are converted: var = istd^-2 - eps,
  bn_convert_style.py:13-33).
- :func:`fold_bn`: absorbs inference-mode BN into the preceding
  Convolution / InnerProduct (gen_bn_inference.py:23-80), or makes it a
  per-channel Scale layer where it cannot fold; each BN with its own
  ``eps``, as the executor runs it.
- :func:`fold_input_transform`: absorbs an ``input_transform`` layer (a
  channel reorder and a scale of the clips, as I3D's BGR -> RGB and
  1/127.5) into the convolutions that read it.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from eco_tpu_torch.convert.caffemodel import load_caffemodel
from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec
from eco_tpu_torch.ops.norm import DEFAULT_EPS


def convert_conv_weight(w: np.ndarray, *, transposed: bool = False) -> np.ndarray:
    """A Caffe Convolution blob (out, in/g, *k), or a Deconvolution blob
    (in, out/g, *k), in this package's layout: the same axis order, as
    PyTorch's conv and transposed-conv weights keep it, made a contiguous
    f32 array.  ``transposed`` only documents which of the two it is."""
    del transposed
    return np.ascontiguousarray(w, np.float32)


def import_caffe_weights(
    graph: GraphSpec,
    params: Mapping,
    state: Mapping,
    caffe_paths: str | Sequence[str],
    *,
    bn_style: str = "var",
    eps: float = DEFAULT_EPS,
    strict: bool = False,
):
    """Load one or more .caffemodel files (comma-separated like the
    reference's --weights) into copies of (params, state); each blob takes
    the dtype and device of the tensor it replaces.

    Returns (params, state, report), where report lists loaded and skipped
    layer names.
    """
    if isinstance(caffe_paths, str):
        caffe_paths = [p for p in caffe_paths.split(",") if p]
    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    loaded, skipped = [], []
    for path in caffe_paths:
        for lname, entry in load_caffemodel(path).items():
            blobs = entry["blobs"]
            if lname not in new_params and lname not in new_state:
                skipped.append(lname)
                continue
            try:
                spec_type = graph.layer(lname).type
            except KeyError:
                spec_type = entry["type"].lower()
            if spec_type in ("convolution", "deconvolution"):
                w = convert_conv_weight(blobs[0], transposed=spec_type == "deconvolution")
                _assign(new_params, lname, "w", w, strict)
                if len(blobs) > 1:
                    _assign(new_params, lname, "b", blobs[1].reshape(-1), strict)
            elif spec_type == "innerproduct":
                _assign(new_params, lname, "w", blobs[0], strict)
                if len(blobs) > 1:
                    _assign(new_params, lname, "b", blobs[1].reshape(-1), strict)
            elif spec_type == "bn":
                gamma, beta, mean, var = (b.reshape(-1) for b in blobs[:4])
                if bn_style == "inv_std":
                    var = np.power(var, -2.0) - eps
                _assign(new_params, lname, "gamma", gamma, strict)
                _assign(new_params, lname, "beta", beta, strict)
                _assign(new_state, lname, "mean", mean, strict)
                _assign(new_state, lname, "var", var, strict)
            elif spec_type == "scale":
                _assign(new_params, lname, "scale", blobs[0].reshape(-1), strict)
                if len(blobs) > 1:
                    _assign(new_params, lname, "shift", blobs[1].reshape(-1), strict)
            elif spec_type == "batchnorm":
                # new-style BatchNorm: mean, var, scale_factor (the stats are
                # divided by scale_factor on use, batch_norm_layer.cpp)
                factor = float(blobs[2].reshape(-1)[0]) if len(blobs) > 2 else 1.0
                factor = 1.0 / factor if factor != 0 else 0.0
                _assign(new_state, lname, "mean", blobs[0].reshape(-1) * factor, strict)
                _assign(new_state, lname, "var", blobs[1].reshape(-1) * factor, strict)
            else:
                skipped.append(lname)
                continue
            loaded.append(lname)
    if strict and skipped:
        raise ValueError(f"unmatched caffemodel layers: {skipped}")
    return new_params, new_state, {"loaded": loaded, "skipped": skipped}


def _assign(tree, lname, pname, value, strict):
    if lname not in tree or pname not in tree[lname]:
        if strict:
            raise ValueError(f"model has no {lname}/{pname}")
        return
    cur = tree[lname][pname]
    if tuple(cur.shape) != tuple(value.shape):
        raise ValueError(
            f"{lname}/{pname}: caffemodel shape {value.shape} != model {tuple(cur.shape)}"
        )
    tree[lname][pname] = torch.from_numpy(np.array(value, order="C")).to(cur.device, cur.dtype)


def fold_bn(graph: GraphSpec, params: Mapping, state: Mapping,
            *, eps: float = DEFAULT_EPS):
    """Absorb inference-mode BN layers; returns (new_graph, new_params, new_state).

    A BN folds into the layer producing its bottom iff that layer is a
    Convolution / InnerProduct and the BN is the *sole* consumer of its blob;
    otherwise it becomes a Scale layer with precomputed scale / shift (ECO's
    3D residual adds consume pre-BN conv tops, so those BNs become Scale).
    Each BN folds with its own ``eps`` option, ``eps`` where it has none.
    """
    producer: dict[str, LayerSpec] = {}
    new_layers: list[LayerSpec] = []
    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    rename: dict[str, str] = {}

    consumers: dict[str, int] = {}
    for l in graph.layers:
        for bname in l.bottoms:
            if bname not in l.tops:  # in-place layers don't count
                consumers[bname] = consumers.get(bname, 0) + 1

    def resolve(names):
        return tuple(rename.get(n, n) for n in names)

    for l in graph.layers:
        l = l.replace(bottoms=resolve(l.bottoms), tops=resolve(l.tops))
        if l.type == "bn":
            src = producer.get(l.bottoms[0])
            g = new_params[l.name]["gamma"].float()
            b = new_params[l.name]["beta"].float()
            m = new_state[l.name]["mean"].float()
            v = new_state[l.name]["var"].float()
            scale = g / torch.sqrt(v + float(l.opt("eps", eps)))
            shift = b - m * scale
            foldable = (
                src is not None
                and src.type in ("convolution", "innerproduct")
                and l.bottoms[0] not in graph.inputs
                and consumers.get(l.bottoms[0], 0) == 1
            )
            if foldable:
                sp = new_params[src.name]
                w = sp["w"].float()
                sp["w"] = w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
                bias = sp["b"].float() if "b" in sp else torch.zeros_like(scale)
                sp["b"] = bias * scale + shift
                # BN's top now refers to the conv's output
                rename[l.tops[0]] = l.bottoms[0]
                del new_params[l.name]
                new_state.pop(l.name, None)
                continue
            new_layers.append(
                LayerSpec(l.name, "scale", l.bottoms, l.tops, {}, l.phase)
            )
            new_params[l.name] = {"scale": scale, "shift": shift}
            new_state.pop(l.name, None)
            continue
        new_layers.append(l)
        for t in l.tops:
            producer[t] = l
    folded = GraphSpec(graph.name + "_folded", dict(graph.inputs), new_layers,
                       dict(graph.options))
    return folded, new_params, new_state


def fold_input_transform(graph: GraphSpec, params: Mapping, state: Mapping):
    """Absorb each ``input_transform`` layer whose every consumer is a
    convolution (not transposed, one group) into their weights; returns
    (new_graph, new_params, state).

    The layer computes ``y[..., i] = scale * x[..., channel_order[i]]``, so
    a convolution of ``y`` is the convolution of ``x`` whose weights take
    input channel ``channel_order[i]`` from ``scale * w[:, i]``.  Exact with
    any zero padding of the convolution: the layer maps zero to zero, so a
    padded cell is the same in both domains.  A transform with any other
    consumer stays a layer.
    """
    new_params = {k: dict(v) for k, v in params.items()}
    consumers: dict[str, list[LayerSpec]] = {}
    for l in graph.layers:
        for b in l.bottoms:
            consumers.setdefault(b, []).append(l)
    rename: dict[tuple[str, str], str] = {}  # (consumer, bottom) -> new bottom
    drop: set[str] = set()
    for l in graph.layers:
        if l.type != "input_transform":
            continue
        readers = consumers.get(l.tops[0], [])
        if not readers or any(
                c.type != "convolution" or c.opt("transposed", False)
                or int(c.opt("group", 1)) != 1 or c.bottoms != l.tops for c in readers):
            continue
        order = torch.as_tensor([int(i) for i in l.opt("channel_order")])
        scale = float(l.opt("scale", 1.0))
        for c in readers:
            w = new_params[c.name]["w"].float()
            folded = torch.empty_like(w)
            folded[:, order] = w * scale
            new_params[c.name]["w"] = folded
            rename[(c.name, l.tops[0])] = l.bottoms[0]
        drop.add(l.name)
    layers = [l.replace(bottoms=tuple(rename.get((l.name, b), b) for b in l.bottoms))
              for l in graph.layers if l.name not in drop]
    return (GraphSpec(graph.name, dict(graph.inputs), layers, dict(graph.options)),
            new_params, state)
