# A copy of eco_tpu/convert/write.py (no framework code; it takes the reference's weight layout: pass the port's trees through convert.bridge.params_to_jax); tests/test_torch_cli.py holds it to the original.
"""Caffemodel EXPORT -- the inverse of convert/load.py.

The reference serializes learned nets back to protobuf
(``Net::ToProto`` + ``Solver::Snapshot``, solver.cpp:522-546); this module
writes a V2 ``NetParameter`` wire (net name field 1, repeated
``LayerParameter`` field 100 with name/type/blobs, blob shape field 7 +
packed float data field 5 -- caffe.proto:282-371) readable by stock Caffe
and by our own :func:`eco_tpu.convert.load_caffemodel`.

Layout conversions are the exact inverse of import_caffe_weights:
    conv  (*k, in/g, out) -> (out, in/g, *k)
    deconv(*k, in, out)   -> (in, out, *k)
    ip    (in, out)       -> (out, in)
    bn    gamma/beta/mean/var (C,) -> 4 blobs shaped (1, C, 1, 1)
"""

from __future__ import annotations

import struct
from typing import Mapping

import numpy as np


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _blob(arr: np.ndarray) -> bytes:
    """BlobProto: shape (field 7: BlobShape with repeated dim) + packed
    float data (field 5)."""
    arr = np.ascontiguousarray(arr, np.float32)
    shape_msg = b"".join(_tag(1, 0) + _varint(int(d)) for d in arr.shape)
    return _ld(7, shape_msg) + _ld(5, arr.ravel().tobytes())


CAFFE_TYPE = {
    "convolution": "Convolution",
    "deconvolution": "Deconvolution",
    "innerproduct": "InnerProduct",
    "bn": "BN",
    "scale": "Scale",
    "batchnorm": "BatchNorm",
}


def _layer_blobs(ltype: str, lp: Mapping, ls: Mapping):
    """Ordered caffe blobs for one layer, or None if not exportable."""
    t = ltype.lower()
    if t in ("convolution", "deconvolution"):
        if "w" not in lp:
            return None  # unresolved shared weight: skipped (caller warns)
        w = np.asarray(lp["w"], np.float32)
        nsp = w.ndim - 2
        if t == "deconvolution":  # (*k, in, out/g) -> (in, out/g, *k)
            perm = (nsp, nsp + 1) + tuple(range(nsp))
        else:  # (*k, in/g, out) -> (out, in/g, *k)
            perm = (nsp + 1, nsp) + tuple(range(nsp))
        blobs = [np.transpose(w, perm)]
        if "b" in lp:
            blobs.append(np.asarray(lp["b"], np.float32))
        return blobs
    if t == "innerproduct":
        if "w" not in lp:
            return None  # unresolved shared weight: skipped (caller warns)
        blobs = [np.asarray(lp["w"], np.float32).T]
        if "b" in lp:
            blobs.append(np.asarray(lp["b"], np.float32))
        return blobs
    if t == "bn":
        c = np.asarray(lp["gamma"]).shape[0]
        sh = (1, c, 1, 1)
        return [
            np.asarray(x, np.float32).reshape(sh)
            for x in (lp["gamma"], lp["beta"], ls["mean"], ls["var"])
        ]
    if t == "scale":
        blobs = [np.asarray(lp["scale"], np.float32)]
        if "shift" in lp:
            blobs.append(np.asarray(lp["shift"], np.float32))
        return blobs
    if t == "batchnorm":
        return [
            np.asarray(ls["mean"], np.float32),
            np.asarray(ls["var"], np.float32),
            np.asarray([1.0], np.float32),  # scale_factor already folded in
        ]
    return None


def export_caffe_weights(graph, params: Mapping, state: Mapping, path: str,
                         *, net_name: str | None = None) -> list[str]:
    """Write the graph's learned blobs as ``path`` (.caffemodel wire).

    Returns the exported layer names.  Layers without caffe-expressible
    params (our fused segment ops, dropout, ...) are skipped -- they carry no
    blobs in Caffe either.
    """
    qnames = [
        l.name for l in graph.layers
        if l.type.lower() in ("qconvolution", "qinnerproduct")
    ]
    if qnames:
        # silently skipping them would write a caffemodel with no conv/fc
        # weights at all
        raise ValueError(
            f"graph contains int8-quantized layers ({', '.join(qnames[:3])}"
            f"{', ...' if len(qnames) > 3 else ''}); Caffe has no int8 wire "
            "format -- export the float model and quantize after import"
        )
    out = _ld(1, (net_name or graph.name or "net").encode())
    exported = []
    # Cross-layer param sharing (ParamSpec.name): aliased layers own no
    # entry in the params tree, so resolve each share name to its owner's
    # array and export the blobs on EVERY sharing layer -- Caffe stores
    # blobs per layer even when `param { name }` ties them together.
    _PORDER = {
        "convolution": ("w", "b"), "deconvolution": ("w", "b"),
        "innerproduct": ("w", "b"), "bn": ("gamma", "beta"),
        "scale": ("scale", "shift"),
    }
    # Owner pre-pass so an aliasing layer that PRECEDES its owner in
    # graph.layers still resolves (ownership in Caffe is first-declaration,
    # net.cpp AppendParam, but graph order and ownership are independent
    # for us: the owner is whichever layer holds the array in the tree).
    shared_owner: dict = {}
    for layer in graph.layers:
        lp_own = params.get(layer.name, {})
        pnames = _PORDER.get(layer.type.lower(), ())
        for i, ps in enumerate(layer.params):
            sname = getattr(ps, "name", None)
            if sname and i < len(pnames) and pnames[i] in lp_own:
                shared_owner.setdefault(sname, lp_own[pnames[i]])
    unresolved: list[str] = []
    for layer in graph.layers:
        lp = dict(params.get(layer.name, {}))
        pnames = _PORDER.get(layer.type.lower(), ())
        for i, ps in enumerate(layer.params):
            sname = getattr(ps, "name", None)
            if not sname or i >= len(pnames):
                continue
            pn = pnames[i]
            if pn not in lp:
                if sname in shared_owner:
                    lp[pn] = shared_owner[sname]
                else:
                    unresolved.append(f"{layer.name}/{pn} (share name {sname!r})")
        ls = state.get(layer.name, {})
        if not lp and not ls:
            continue
        blobs = _layer_blobs(layer.type, lp, ls)
        if blobs is None:
            continue
        msg = _ld(1, layer.name.encode())
        msg += _ld(2, CAFFE_TYPE.get(layer.type.lower(), layer.type).encode())
        for b in blobs:
            msg += _ld(7, _blob(b))
        out += _ld(100, msg)
        exported.append(layer.name)
    if unresolved:
        import warnings

        warnings.warn(
            "export_caffe_weights: shared params never resolved to an owner "
            "array and were exported incomplete: " + ", ".join(unresolved),
            stacklevel=2,
        )
    with open(path, "wb") as f:
        f.write(out)
    return exported
