"""Carry params and state between ``eco_tpu``'s layout and this package's.

The reference keeps convolution weights spatial-first, ``(*k, C_in/g,
C_out)``, deconvolution weights ``(*k, C_in, C_out/g)`` and fc weights
``(D_in, D_out)``; this package keeps PyTorch's ``(C_out, C_in/g, *k)``,
``(C_in, C_out/g, *k)`` and ``(D_out, D_in)``.  Every other param (BN,
Scale, PReLU slopes, Bias vectors) and every state entry (BN and BatchNorm
statistics) carries over unchanged.  ``params_from_jax`` takes nested dicts of arrays
(numpy, or anything ``numpy.asarray`` takes); ``params_to_jax`` gives nested
dicts of numpy arrays.  No JAX import is needed.

A layer's type decides its weight layout.  Without a graph (``graph=None``,
as for a checkpoint file) the rank decides: a ``w`` of rank 2 is an fc
weight and one of rank >= 3 a convolution weight.  A deconvolution weight
cannot be told from a convolution weight by its shape, so without the graph
it is carried as a convolution weight: a checkpoint file's round trip
returns it as it was, but the file holds it axes-swapped against the
reference's deconvolution layout.  The int8 layers of a quantized graph
(``qconvolution``, ``qinnerproduct``) take the layouts of their float
twins; an int8 convolution weight comes in ``ops.qconv.kernel_layout``
memory order, (C_out, *k, C_in/g), so that K3 reads it with no copy, and
its ``w_scale`` carries over unchanged.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from eco_tpu_torch.spec.graph import GraphSpec
from eco_tpu_torch.ops.qconv import kernel_layout


_WEIGHT_KINDS = {"convolution": "convolution", "qconvolution": "convolution",
                 "deconvolution": "deconvolution",
                 "innerproduct": "innerproduct", "qinnerproduct": "innerproduct"}


def _weight_kind(layer_type: Optional[str], a: np.ndarray) -> str:
    if layer_type is None:
        return "convolution" if a.ndim >= 3 else "innerproduct"
    if layer_type in _WEIGHT_KINDS:
        return _WEIGHT_KINDS[layer_type]
    raise NotImplementedError(f"no weight layout for layer type {layer_type!r}")


def _to_torch_tensor(layer_type: Optional[str], pname: str, a: np.ndarray) -> torch.Tensor:
    # a copy: arrays from JAX are read-only
    t = torch.from_numpy(np.array(_to_torch_layout(layer_type, pname, a), order="C"))
    if pname == "w" and t.dtype == torch.int8 and _weight_kind(layer_type, a) == "convolution":
        t = kernel_layout(t)  # once here, so that K3 reads it with no copy
    return t


def _to_torch_layout(layer_type: Optional[str], pname: str, a: np.ndarray) -> np.ndarray:
    if pname != "w":
        return a
    kind = _weight_kind(layer_type, a)
    nsp = a.ndim - 2
    if kind == "convolution":
        return np.transpose(a, (nsp + 1, nsp) + tuple(range(nsp)))
    if kind == "deconvolution":
        return np.transpose(a, (nsp, nsp + 1) + tuple(range(nsp)))
    return a.T


def _to_jax_layout(layer_type: Optional[str], pname: str, a: np.ndarray) -> np.ndarray:
    if pname != "w":
        return a
    kind = _weight_kind(layer_type, a)
    if kind == "convolution":
        return np.transpose(a, tuple(range(2, a.ndim)) + (1, 0))
    if kind == "deconvolution":
        return np.transpose(a, tuple(range(2, a.ndim)) + (0, 1))
    return a.T


def _layer_types(graph: Optional[GraphSpec]):
    if graph is None:
        return lambda lname: None
    types = {l.name: l.type.lower() for l in graph.layers}
    return lambda lname: types.get(lname, "")


def params_from_jax(graph: Optional[GraphSpec], params: Mapping, state: Mapping, *,
                    device="cuda"):
    """(params, state) of ``eco_tpu`` -> the same trees of torch tensors."""
    layer_type = _layer_types(graph)

    def convert(tree, layouts: bool):
        out = {}
        for lname, entries in tree.items():
            out[lname] = {}
            for pname, value in entries.items():
                a = np.asarray(value)
                t = (_to_torch_tensor(layer_type(lname), pname, a) if layouts
                     else torch.from_numpy(np.array(a, order="C")))
                out[lname][pname] = t.to(device)
        return out

    return convert(params, True), convert(state, False)


def params_to_jax(graph: Optional[GraphSpec], params: Mapping, state: Mapping):
    """The inverse of ``params_from_jax``: trees of torch tensors (on any
    device) -> ``eco_tpu``'s trees of numpy arrays in its layout."""
    layer_type = _layer_types(graph)

    def convert(tree, layouts: bool):
        out = {}
        for lname, entries in tree.items():
            out[lname] = {}
            for pname, value in entries.items():
                a = value.detach().cpu().numpy()
                if layouts:
                    a = _to_jax_layout(layer_type(lname), pname, a)
                out[lname][pname] = np.ascontiguousarray(a)
        return out

    return convert(params, True), convert(state, False)
