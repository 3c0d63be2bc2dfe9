"""BN folding for inference (twin of ``eco_tpu/convert/load.py:fold_bn``).

Ported rather than borrowed: the reference's version computes with
``jax.numpy``, which the port may not import.  The decisions are the
reference's; only the weight layout differs (output channels on dim 0).
"""

from __future__ import annotations

from typing import Mapping

import torch

from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec
from eco_tpu_torch.ops.norm import DEFAULT_EPS


def fold_bn(graph: GraphSpec, params: Mapping, state: Mapping,
            *, eps: float = DEFAULT_EPS):
    """Absorb inference-mode BN layers; returns (new_graph, new_params, new_state).

    A BN folds into the layer producing its bottom iff that layer is a
    Convolution / InnerProduct and the BN is the *sole* consumer of its blob;
    otherwise it becomes a Scale layer with precomputed scale / shift (ECO's
    3D residual adds consume pre-BN conv tops, so those BNs become Scale).
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
            scale = g / torch.sqrt(v + eps)
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
