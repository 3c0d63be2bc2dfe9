"""Inference graph rewrite: merge sibling 1x1 convs
(twin of ``eco_tpu/spec/transforms.py:merge_sibling_1x1_convs``).

Inception blocks launch up to three 1x1 convs (+BN+ReLU) from one bottom.
Merging them into one conv with concatenated output channels reads the input
once and gives the GEMM a wider N; the per-branch tops become channel slices.
Legal only at inference (per-branch BNs concatenate exactly); the pattern
requires conv -> BN (sole consumer) -> in-place ReLU, and the merged BN
takes its members' options, so only BNs of one ``eps`` merge.  2D 1x1 and
3D 1x1x1 siblings (I3D's three a module) merge alike.

Ported rather than borrowed: the reference's version concatenates with
``jax.numpy``.  Weights are ``(C_out, C_in, 1, 1)`` here, so they
concatenate on dim 0.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec


def _hashable(v):
    return tuple(_hashable(x) for x in v) if isinstance(v, list) else v


def _conv_key(l: LayerSpec):
    return (
        l.bottoms,
        tuple(np.atleast_1d(l.opt("kernel_size", 1)).tolist()),
        tuple(np.atleast_1d(l.opt("stride", 1)).tolist()),
        _hashable(np.atleast_1d(l.opt("pad", 0)).tolist()),
        int(l.opt("group", 1)),
        bool(l.opt("bias_term", True)),
    )


def merge_sibling_1x1_convs(graph: GraphSpec, params: Mapping, state: Mapping):
    """Returns (new_graph, new_params, new_state); inference-only rewrite."""
    layers = graph.layers
    index = {l.name: i for i, l in enumerate(layers)}
    consumers: dict[str, list[LayerSpec]] = {}
    for l in layers:
        for b in l.bottoms:
            if b not in l.tops:
                consumers.setdefault(b, []).append(l)

    def chain_of(conv: LayerSpec):
        """conv -> bn (sole consumer) -> in-place relu; returns (bn, relu).

        The in-place ReLU (top == bottom == bn top) is absent from the
        consumers map, so it is located by a direct scan.
        """
        cons = consumers.get(conv.tops[0], [])
        if len(cons) != 1 or cons[0].type != "bn":
            return None
        bn = cons[0]
        relus = [
            l for l in layers
            if l.type == "relu" and l.bottoms == bn.tops and l.tops == bn.tops
        ]
        return bn, (relus[0] if relus else None)

    # every member must carry the SAME epilogue (conv -> BN -> in-place ReLU)
    # or the merged in-place ReLU would rectify a branch that should stay linear
    groups: dict = {}
    for l in layers:
        if l.type != "convolution":
            continue
        if not np.all(np.atleast_1d(l.opt("kernel_size", 1)) == 1):
            continue
        chain = chain_of(l)
        if chain is None or chain[1] is None:
            continue
        groups.setdefault((_conv_key(l), chain[0].opt("eps")), []).append(l)

    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    remove: set[str] = set()
    insert: dict[str, list[LayerSpec]] = {}  # anchor conv name -> new layers

    for (key, _), convs in groups.items():
        if len(convs) < 2:
            continue
        convs = sorted(convs, key=lambda l: index[l.name])
        chains = [chain_of(c) for c in convs]
        bns = [c[0] for c in chains]
        widths = [int(params[c.name]["w"].shape[0]) for c in convs]
        mname = convs[0].name + "__merged"
        mp = {"w": torch.cat([params[c.name]["w"] for c in convs], 0)}
        if key[5]:
            mp["b"] = torch.cat([params[c.name]["b"] for c in convs])
        new_params[mname] = mp
        new_params[mname + "_bn"] = {
            "gamma": torch.cat([params[b.name]["gamma"] for b in bns]),
            "beta": torch.cat([params[b.name]["beta"] for b in bns]),
        }
        new_state[mname + "_bn"] = {
            "mean": torch.cat([state[b.name]["mean"] for b in bns]),
            "var": torch.cat([state[b.name]["var"] for b in bns]),
        }
        opts = dict(convs[0].options)
        opts["num_output"] = int(sum(widths))
        insert[convs[0].name] = [
            LayerSpec(mname, "convolution", convs[0].bottoms, (mname,), opts),
            LayerSpec(mname + "_bn", "bn", (mname,), (mname + "_bn",),
                      dict(bns[0].options)),
            LayerSpec(mname + "_relu", "relu", (mname + "_bn",),
                      (mname + "_bn",)),
            LayerSpec(
                mname + "_split", "slice", (mname + "_bn",),
                tuple(b.tops[0] for b in bns),
                {"axis": 1,
                 "slice_point": list(np.cumsum(widths)[:-1].tolist())},
            ),
        ]
        for c, (bn, relu) in zip(convs, chains):
            remove.add(c.name)
            remove.add(bn.name)
            if relu is not None:
                remove.add(relu.name)
            new_params.pop(c.name, None)
            new_params.pop(bn.name, None)
            new_state.pop(bn.name, None)

    out_layers: list[LayerSpec] = []
    for l in layers:
        if l.name in insert:
            out_layers.extend(insert[l.name])
        if l.name in remove:
            continue
        out_layers.append(l)
    g2 = GraphSpec(graph.name + "_opt", dict(graph.inputs), out_layers,
                   dict(graph.options))
    return g2, new_params, new_state
