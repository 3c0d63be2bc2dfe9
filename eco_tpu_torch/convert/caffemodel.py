# A copy of eco_tpu/convert/caffemodel.py (no framework code); tests/test_torch_data.py holds it to the original.
"""Pure-python protobuf *wire format* reader for .caffemodel files.

No caffe proto stubs are required: we decode the binary wire format directly
with the field numbers of NetParameter/LayerParameter/BlobProto from the
reference schema (src/caffe/proto/caffe.proto):

NetParameter:   name=1, input=3, input_dim=4, layers(V1)=2, layer(V2)=100
LayerParameter: name=1, type=2(string), bottom=3, top=4, blobs=7
V1LayerParameter: bottom=2, top=3, name=4, type=5(enum), blobs=6
BlobProto:      num=1, channels=2, height=3, width=4, data=5(float),
                diff=6, shape=7(BlobShape.dim=1), double_data=8

Handles packed and unpacked repeated floats; returns numpy arrays.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            if pos + 8 > n:
                raise ValueError("truncated protobuf message (64-bit field)")
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated protobuf message (length field)")
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            if pos + 4 > n:
                raise ValueError("truncated protobuf message (32-bit field)")
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape = []
    legacy = [0, 0, 0, 0]
    data_chunks: list[np.ndarray] = []
    for field, wt, val in _fields(buf):
        if field == 7 and wt == 2:  # BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == 0:
                        shape.append(int(v2))
                    elif w2 == 2:  # packed int64
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            shape.append(int(d))
        elif field in (1, 2, 3, 4) and wt == 0:
            legacy[field - 1] = int(val)
        elif field == 5:  # float data
            if wt == 2:  # packed
                data_chunks.append(np.frombuffer(bytes(val), dtype="<f4"))
            elif wt == 5:
                data_chunks.append(np.frombuffer(val, dtype="<f4"))
        elif field == 8:  # double data
            if wt == 2:
                data_chunks.append(
                    np.frombuffer(bytes(val), dtype="<f8").astype(np.float32)
                )
            elif wt == 1:
                data_chunks.append(
                    np.frombuffer(val, dtype="<f8").astype(np.float32)
                )
    data = (
        np.concatenate(data_chunks) if data_chunks else np.zeros((0,), np.float32)
    )
    if not shape:
        if any(legacy):
            shape = legacy
        else:
            shape = [data.size]
    count = int(np.prod(shape)) if shape else 0
    if data.size != count:
        raise ValueError(f"blob data size {data.size} != shape {shape}")
    return data.reshape(shape)


_V1_TYPE_NAMES = {
    4: "Convolution", 5: "Data", 6: "Dropout", 14: "InnerProduct",
    17: "Pooling", 18: "ReLU", 20: "Softmax", 21: "SoftmaxWithLoss",
    1: "Accuracy", 3: "Concat", 15: "LRN", 8: "Flatten",
}


def _parse_layer(buf: memoryview, v1: bool) -> dict:
    name, ltype = "", ""
    blobs = []
    name_f, type_f, blobs_f = (4, 5, 6) if v1 else (1, 2, 7)
    for field, wt, val in _fields(buf):
        if field == name_f and wt == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == type_f:
            if v1 and wt == 0:
                ltype = _V1_TYPE_NAMES.get(int(val), str(val))
            elif not v1 and wt == 2:
                ltype = bytes(val).decode("utf-8", "replace")
        elif field == blobs_f and wt == 2:
            blobs.append(_parse_blob(val))
    return {"name": name, "type": ltype, "blobs": blobs}


def load_blobproto(path: str) -> "np.ndarray":
    """Read a standalone serialized BlobProto file (infogain H matrix,
    compute_image_mean output -- io.cpp ReadProtoFromBinaryFile users)."""
    with open(path, "rb") as f:
        return _parse_blob(memoryview(f.read()))


def load_caffemodel(path: str) -> dict[str, dict]:
    """Returns {layer_name: {"type": str, "blobs": [np.ndarray, ...]}} for all
    layers that carry weights."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    layers: dict[str, dict] = {}
    for field, wt, val in _fields(buf):
        if wt != 2:
            continue
        if field == 100:  # LayerParameter (V2)
            layer = _parse_layer(val, v1=False)
        elif field == 2:  # V1LayerParameter
            layer = _parse_layer(val, v1=True)
        else:
            continue
        if layer["blobs"]:
            layers[layer["name"]] = {
                "type": layer["type"], "blobs": layer["blobs"]
            }
    return layers
