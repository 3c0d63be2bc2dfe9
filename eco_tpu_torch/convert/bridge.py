"""Carry ``eco_tpu`` params and state into this package's tensors.

The reference keeps convolution weights spatial-first, ``(*k, C_in/g,
C_out)``, and fc weights ``(D_in, D_out)``; this package keeps PyTorch's
``(C_out, C_in/g, *k)`` and ``(D_out, D_in)``.  BN, Scale and bias vectors
carry over unchanged.  Inputs are nested dicts of arrays (numpy, or anything
``numpy.asarray`` takes); no JAX import is needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from eco_tpu.spec.graph import GraphSpec


def _to_torch_layout(layer_type: str, pname: str, a: np.ndarray) -> np.ndarray:
    if pname == "w" and layer_type == "convolution":
        nsp = a.ndim - 2
        return np.transpose(a, (nsp + 1, nsp) + tuple(range(nsp)))
    if pname == "w" and layer_type == "innerproduct":
        return a.T
    if pname == "w":
        raise NotImplementedError(f"no weight layout for layer type {layer_type!r}")
    return a


def params_from_jax(graph: GraphSpec, params: Mapping, state: Mapping, *,
                    device="cpu"):
    """(params, state) of ``eco_tpu`` -> the same trees of torch tensors."""
    types = {l.name: l.type.lower() for l in graph.layers}

    def convert(tree, layouts: bool):
        out = {}
        for lname, entries in tree.items():
            out[lname] = {}
            for pname, value in entries.items():
                a = np.asarray(value)
                if layouts:
                    a = _to_torch_layout(types.get(lname, ""), pname, a)
                # a copy: arrays from JAX are read-only
                out[lname][pname] = torch.from_numpy(np.array(a, order="C")).to(device)
        return out

    return convert(params, True), convert(state, False)
