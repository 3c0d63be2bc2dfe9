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
- :func:`fold_space_to_depth`: runs a 3D stride-2 convolution over a few
  input channels (I3D's stem) as space-to-depth and a stride-1
  convolution.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from eco_tpu_torch.convert.caffemodel import load_caffemodel
from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec
from eco_tpu_torch.ops.norm import DEFAULT_EPS
from eco_tpu_torch.runtime.executor import input_scales
from eco_tpu_torch.utils.shapes import caffe_conv_out_dim, conv_pads, normalize_spatial_param


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

    The layer computes ``y[..., i] = scale[i] * x[..., channel_order[i]]``
    (one scale for all channels, or one a channel), so a convolution of
    ``y`` is the convolution of ``x`` whose weights take input channel
    ``channel_order[i]`` from ``scale[i] * w[:, i]``.  Exact with any zero
    padding of the convolution: the layer maps zero to zero, so a padded
    cell is the same in both domains.  A transform with any other consumer
    stays a layer.
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
        scale = torch.tensor(input_scales(l, len(order)))
        for c in readers:
            w = new_params[c.name]["w"].float()
            folded = torch.empty_like(w)
            folded[:, order] = w * scale.to(w.device).view((1, -1) + (1,) * (w.ndim - 2))
            new_params[c.name]["w"] = folded
            rename[(c.name, l.tops[0])] = l.bottoms[0]
        drop.add(l.name)
    layers = [l.replace(bottoms=tuple(rename.get((l.name, b), b) for b in l.bottoms))
              for l in graph.layers if l.name not in drop]
    return (GraphSpec(graph.name, dict(graph.inputs), layers, dict(graph.options)),
            new_params, state)


# The convolution after space-to-depth reads this many channels a cell: the
# cell's 8 x C_in (C_in <= 4), then zero channels with zero weights.  On an
# H100 (bf16, cuDNN's benchmark mode, CUDA graphs) I3D's 4x4x4/s1 stem over
# 8 clips took 2.22-2.37 ms at 32 channels and 4.34-4.35 ms at 24; the
# 7x7x7/s2 conv over 3 channels 11.99-12.27 ms.
S2D_CHANNELS = 32


def _s2d_stem(l: LayerSpec, params: Mapping) -> bool:
    """A convolution that :func:`fold_space_to_depth` rewrites, read from
    its shape alone: 3D, not transposed, one group, no dilation, at most 4
    input channels, stride 2 on every axis, every kernel side odd and at
    least 5."""
    if (l.type != "convolution" or l.opt("transposed", False)
            or int(l.opt("group", 1)) != 1):
        return False
    w = params.get(l.name, {}).get("w")
    if w is None or w.ndim != 5 or w.shape[1] > 4:
        return False
    return (normalize_spatial_param(l.opt("stride", 1), 3, default=1) == (2, 2, 2)
            and normalize_spatial_param(l.opt("dilation", 1), 3, default=1) == (1, 1, 1)
            and all(k % 2 == 1 and k >= 5 for k in w.shape[2:]))


def space_to_depth_weight(w: torch.Tensor, channels: int) -> torch.Tensor:
    """A stride-2 kernel ``w`` (C_out, C_in, *k) of odd sides as the
    stride-1 kernel over 2x2x2 cells: zero-padded to 2 * ceil(k/2) at the
    high end of each axis, each (dt, dh, dw) offset made a block of C_in
    input channels (``ops/s2d.py``'s order), then zero channels up to
    ``channels``: (C_out, ``channels``, *ceil(k/2))."""
    co, ci, *k = w.shape
    half = [(kk + 1) // 2 for kk in k]
    flat = []  # F.pad lists axes from the last
    for kk, hh in reversed(list(zip(k, half))):
        flat += [0, 2 * hh - kk]
    w = F.pad(w, flat).reshape(co, ci, half[0], 2, half[1], 2, half[2], 2)
    w = w.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(co, 8 * ci, *half)
    return F.pad(w, [0] * 6 + [0, channels - 8 * ci]).contiguous()


def fold_space_to_depth(graph: GraphSpec, params: Mapping, state: Mapping):
    """Run each 3D stride-2 convolution over a few input channels (odd
    kernel sides of at least 5: I3D's 3-channel 7x7x7/s2 stem) as a
    ``space_to_depth`` layer and a stride-1 convolution; returns
    (new_graph, new_params, state).

    The layer zero-pads the input by the convolution's (lo, hi) pads, and
    by one more zero at the end of an axis whose padded extent is odd
    (``ops/s2d.py`` completes the last cell), and lays each 2x2x2 cell along
    the channels: 8 x C_in of them and zeros up to ``S2D_CHANNELS``.  The
    convolution then has kernel ceil(k/2), stride 1, no pad, and the kernel
    of :func:`space_to_depth_weight`; its bias is unchanged.  Output
    ``(t, h, w)`` of the stride-2 convolution reads padded input ``2t + a``
    along an axis, ``a < k``: cell ``t + a // 2``, offset ``a % 2``, which
    is where the new kernel keeps tap ``a``, so both sum the same products
    of the same values (in another order), and the taps past ``k`` are
    zeros.  The output extents are held equal here for a padded extent of
    either parity, and the fold raises where they are not.  A graph with no
    such convolution (ECO's, whose 7x7/s2 stem is 2D) comes back as it is.
    """
    stems = [l for l in graph.layers if _s2d_stem(l, params)]
    if not stems:
        return graph, params, state
    new_params = {k: dict(v) for k, v in params.items()}
    layers = []
    for l in graph.layers:
        if l not in stems:
            layers.append(l)
            continue
        w = params[l.name]["w"]
        half = [(k + 1) // 2 for k in w.shape[2:]]
        for k, h in zip(w.shape[2:], half):
            for padded in range(k, k + 4):  # padded extents of either parity
                if caffe_conv_out_dim(padded, k, 2, 0) != caffe_conv_out_dim(
                        -(-padded // 2), h, 1, 0):
                    raise ValueError(f"fold_space_to_depth: {l.name!r} would change its "
                                     f"output extent at a padded extent of {padded}")
        cells = f"{l.name}/space_to_depth"
        layers.append(LayerSpec(cells, "space_to_depth", l.bottoms, (cells,), {
            "block": [2, 2, 2], "pad": [list(p) for p in conv_pads(l.opt("pad", 0), 3)],
            "channels": S2D_CHANNELS}, l.phase))
        opts = {k: v for k, v in l.options.items()
                if k not in ("kernel_size", "kernel_h", "kernel_w", "pad")}
        layers.append(l.replace(bottoms=(cells,), options={
            **opts, "kernel_size": half, "stride": 1, "pad": 0}))
        new_params[l.name]["w"] = space_to_depth_weight(w, S2D_CHANNELS)
    return (GraphSpec(graph.name, dict(graph.inputs), layers, dict(graph.options)),
            new_params, state)
