"""Caffe prototxt (protobuf text format) importer -- config-system parity.

Parses NetParameter text files (including this fork's bracket-list extension
``kernel_size: [3, 3, 3]``) into plain dicts, then lowers them onto the
GraphSpec IR with TPU-friendly peephole rewrites:

- Reshape(-1,C,H,W) on a data-layer top      -> fold_segments
- Reshape(-1,S,C,H,W) + Permute([0,2,1,3,4]) -> unfold_segments(S)
  (the r2Dto3D dance, ECO_Lite.prototxt:1310-1326)
- Reshape(-1,1,S,D) + Pool(kh=S,kw=1) + Reshape(-1,D) -> segment_consensus(S)
  (ECO_full.prototxt:4802-4810)

Everything else lowers 1:1; unknown layer types raise at Program build time,
not at parse time.
"""

from __future__ import annotations

import re
from typing import Any

from eco_tpu_torch.spec.graph import GraphSpec, LayerSpec, ParamSpec

_TOKEN = re.compile(
    r"""
    \s*(?:
      (?P<comment>\#[^\n]*)
    | (?P<brace>[{}\[\],])
    | (?P<colon>:)
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<value>[^\s{}\[\]:,"#]+)
    )""",
    re.X,
)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            break
        pos = m.end()
        if m.lastgroup == "comment" or m.group().strip() == "":
            continue
        yield m.lastgroup, m.group().strip()
    yield "eof", ""


_UNESCAPES = {"\\": "\\", '"': '"', "n": "\n", "r": "\r", "t": "\t", "'": "'"}


def _unescape(s: str) -> str:
    if "\\" not in s:
        return s
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append(_UNESCAPES.get(s[i + 1], "\\" + s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _convert(tok: str) -> Any:
    if tok.startswith('"'):
        return _unescape(tok[1:-1])
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum token (MAX, TRAIN, RGB, ...)


class _Parser:
    def __init__(self, text: str):
        self._toks = list(_tokenize(text))
        self._i = 0

    def _peek(self):
        return self._toks[self._i]

    def _next(self):
        t = self._toks[self._i]
        self._i += 1
        return t

    def parse_message(self, top_level: bool = False) -> dict:
        """Parse { field: value ... }; repeated fields accumulate in lists."""
        msg: dict[str, Any] = {}
        while True:
            kind, tok = self._peek()
            if kind == "eof" or (kind == "brace" and tok == "}"):
                if not top_level:
                    self._next()  # consume '}'
                return msg
            if kind != "value":
                raise ValueError(f"unexpected token {tok!r}")
            key = self._next()[1]
            kind, tok = self._peek()
            if kind == "brace" and tok == "{":
                self._next()
                value = self.parse_message()
            elif kind == "colon":
                self._next()
                kind, tok = self._peek()
                if kind == "brace" and tok == "[":
                    self._next()
                    value = []
                    while True:
                        kind, tok = self._peek()
                        if kind == "brace" and tok == "]":
                            self._next()
                            break
                        if kind == "brace" and tok == ",":
                            self._next()
                            continue
                        value.append(_convert(self._next()[1]))
                elif kind == "brace" and tok == "{":
                    self._next()
                    value = self.parse_message()
                else:
                    value = _convert(self._next()[1])
            else:
                raise ValueError(f"expected ':' or '{{' after {key!r}")
            if key in msg:
                if not isinstance(msg[key], list) or isinstance(value, list):
                    prev = msg[key]
                    msg[key] = prev if isinstance(prev, list) else [prev]
                    if isinstance(value, list):
                        msg[key].extend(value)
                    else:
                        msg[key].append(value)
                else:
                    msg[key].append(value)
            else:
                msg[key] = value


def parse_prototxt(text: str) -> dict:
    """Text -> nested dict; repeated fields become lists."""
    return _Parser(text).parse_message(top_level=True)


# ---------------------------------------------------------------------------
# Lowering NetParameter dict -> GraphSpec
# ---------------------------------------------------------------------------

def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _phase_of(layer: dict):
    """Collapse include/exclude phase rules to a phase tag.

    Full NetStateRule (net.cpp:318-407) also carries stage/level; those are
    preserved verbatim in options['state_rules'] by _lower_layer and checked
    by GraphSpec.filtered when a NetState is supplied.
    """
    for rule, invert in (("include", False), ("exclude", True)):
        phases = {
            str(r["phase"]).lower()
            for r in _as_list(layer.get(rule))
            if isinstance(r, dict) and r.get("phase") is not None
        }
        if len(phases) >= 2:
            return None  # rules cover both phases -> no single-phase tag
        if phases:
            ph = next(iter(phases))
            return ("test" if ph == "train" else "train") if invert else ph
    return None


# V1 LayerType enum -> V2 string type (upgrade_proto.cpp UpgradeV1LayerType).
_V1_TYPES = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BN": "BN", "BNLL": "BNLL", "CONCAT": "Concat",
    "CONTRASTIVE_LOSS": "ContrastiveLoss", "CONVOLUTION": "Convolution",
    "DATA": "Data", "DECONVOLUTION": "Deconvolution", "DROPOUT": "Dropout",
    "DUMMY_DATA": "DummyData", "ELTWISE": "Eltwise",
    "EUCLIDEAN_LOSS": "EuclideanLoss", "EXP": "Exp", "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col", "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss", "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN", "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "RESHAPE": "Reshape", "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SLICE": "Slice", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "SPLIT": "Split", "TANH": "TanH",
    "THRESHOLD": "Threshold", "VIDEO_DATA": "VideoData",
    "WINDOW_DATA": "WindowData",
}


# V0 "type" strings -> V2 type names (UpgradeV0LayerType, upgrade_proto.cpp)
_V0_TYPES = {
    "accuracy": "Accuracy", "bnll": "BNLL", "concat": "Concat",
    "conv": "Convolution", "data": "Data", "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss", "flatten": "Flatten",
    "hdf5_data": "HDF5Data", "hdf5_output": "HDF5Output",
    "im2col": "Im2col", "images": "ImageData",
    "infogain_loss": "InfogainLoss", "innerproduct": "InnerProduct",
    "lrn": "LRN", "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling", "relu": "ReLU", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softmax_loss": "SoftmaxWithLoss",
    "split": "Split", "tanh": "TanH", "window_data": "WindowData",
}

# V0 flat field -> (param message, V2 field name), conditioned on layer type
# (UpgradeV0LayerParameter, upgrade_proto.cpp:118-470)
_V0_FIELD_DEST = {
    "num_output": {"conv": "convolution_param",
                   "innerproduct": "inner_product_param"},
    "biasterm": {"conv": "convolution_param",
                 "innerproduct": "inner_product_param"},
    "weight_filler": {"conv": "convolution_param",
                      "innerproduct": "inner_product_param"},
    "bias_filler": {"conv": "convolution_param",
                    "innerproduct": "inner_product_param"},
    "pad": {"conv": "convolution_param", "pool": "pooling_param"},
    "kernelsize": {"conv": "convolution_param", "pool": "pooling_param"},
    "stride": {"conv": "convolution_param", "pool": "pooling_param"},
    "group": {"conv": "convolution_param"},
    "pool": {"pool": "pooling_param"},
    "dropout_ratio": {"dropout": "dropout_param"},
    "local_size": {"lrn": "lrn_param"},
    "alpha": {"lrn": "lrn_param"},
    "beta": {"lrn": "lrn_param"},
    "k": {"lrn": "lrn_param"},
    "source": {"data": "data_param", "hdf5_data": "hdf5_data_param",
               "images": "image_data_param",
               "window_data": "window_data_param",
               "infogain_loss": "infogain_loss_param"},
    "batchsize": {"data": "data_param", "hdf5_data": "hdf5_data_param",
                  "images": "image_data_param",
                  "window_data": "window_data_param"},
    "rand_skip": {"data": "data_param", "images": "image_data_param"},
    "shuffle_images": {"images": "image_data_param"},
    "new_height": {"images": "image_data_param"},
    "new_width": {"images": "image_data_param"},
    "concat_dim": {"concat": "concat_param"},
}
_V0_RENAME = {"biasterm": "bias_term", "kernelsize": "kernel_size",
              "batchsize": "batch_size", "shuffle_images": "shuffle",
              "meanfile": "mean_file", "cropsize": "crop_size"}
# these always land in transform_param regardless of layer type
_V0_TRANSFORM_FIELDS = ("scale", "meanfile", "cropsize", "mirror")


def upgrade_v0_net(net: dict) -> dict:
    """V0 text format -> V1-shaped dict (UpgradeV0Net, upgrade_proto.cpp):
    ``layers { layer { name type <flat fields> } bottom top }`` becomes
    ``layers { name type: "Str" <typed param messages> bottom top }`` which
    :func:`upgrade_v1_net` then finishes (blobs_lr/weight_decay folding).

    Includes the padding-layer absorption pass (UpgradeV0PaddingLayers):
    standalone ``padding`` layers are deleted and their ``pad`` moves onto
    the consuming conv/pool layer, rewiring its bottom.
    """
    conns = _as_list(net.get("layers"))
    if not any(isinstance(c.get("layer"), dict) for c in conns):
        return net

    # pass 1: padding absorption (UpgradeV0PaddingLayers)
    last_top: dict[str, dict] = {inp: None for inp in _as_list(net.get("input"))}
    kept: list[dict] = []
    for conn in conns:
        conn = {**conn, "layer": dict(conn.get("layer", {})),
                "bottom": list(_as_list(conn.get("bottom")))}
        lp = conn["layer"]
        if lp.get("type") != "padding":
            kept.append(conn)
            for j, b in enumerate(conn["bottom"]):
                if b not in last_top:
                    raise ValueError(f"unknown blob input {b!r}")
                src = last_top[b]
                if src is not None and src["layer"].get("type") == "padding":
                    if lp.get("type") not in ("conv", "pool"):
                        raise ValueError(
                            "padding layer feeds non-conv/pool layer "
                            f"{lp.get('type')!r}"
                        )
                    lp["pad"] = src["layer"]["pad"]
                    conn["bottom"][j] = _as_list(src["bottom"])[0]
        for t in _as_list(conn.get("top")):
            last_top[t] = conn

    # pass 2: scatter flat V0 fields into typed param messages
    upgraded = []
    for conn in kept:
        lp = conn["layer"]
        t = str(lp.get("type", ""))
        nl: dict[str, Any] = {
            "bottom": conn["bottom"], "top": list(_as_list(conn.get("top"))),
        }
        if "name" in lp:
            nl["name"] = lp["name"]
        nl["type"] = _V0_TYPES.get(t, t)
        for key in ("blobs_lr", "weight_decay"):
            if key in lp:
                nl[key] = lp[key]
        for key, value in lp.items():
            if key in ("name", "type", "blobs", "blobs_lr", "weight_decay"):
                continue
            if key in _V0_TRANSFORM_FIELDS:
                nl.setdefault("transform_param", {})[
                    _V0_RENAME.get(key, key)] = value
                continue
            dest = _V0_FIELD_DEST.get(key, {}).get(t)
            if dest is None:
                import warnings

                warnings.warn(
                    f"V0 upgrade: unknown parameter {key!r} for layer type "
                    f"{t!r}; dropped", stacklevel=2,
                )
                continue
            field = _V0_RENAME.get(key, key)
            if field == "concat_dim":
                field = "axis"
            nl.setdefault(dest, {})[field] = value
        upgraded.append(nl)
    out = {k: v for k, v in net.items() if k != "layers"}
    out["layers"] = upgraded
    return out


def upgrade_v1_net(net: dict) -> dict:
    """V1 text format -> V2: ``layers { type: ENUM ... }`` becomes
    ``layer { type: "Str" ... }`` with ``blobs_lr``/``weight_decay``/string
    ``param`` share-names folded into V2 ``param { lr_mult decay_mult name }``
    (upgrade_proto.cpp UpgradeV1Net/UpgradeV1LayerParameter, :15-470).

    V0 nets (a nested ``layer { ... }`` message inside ``layers``) are first
    migrated by :func:`upgrade_v0_net`.
    """
    if "layers" not in net:
        return net
    net = upgrade_v0_net(net)
    out = {k: v for k, v in net.items() if k != "layers"}
    upgraded = list(_as_list(out.get("layer")))
    for l in _as_list(net["layers"]):
        nl = dict(l)
        t = str(nl.get("type", ""))
        nl["type"] = _V1_TYPES.get(t.upper(), t)
        lrs = _as_list(nl.pop("blobs_lr", None))
        wds = _as_list(nl.pop("weight_decay", None))
        names = [p for p in _as_list(nl.get("param")) if isinstance(p, str)]
        if lrs or wds or names:
            params = []
            for i in range(max(len(lrs), len(wds), len(names))):
                p = {}
                if i < len(names):
                    p["name"] = names[i]
                if i < len(lrs):
                    p["lr_mult"] = lrs[i]
                if i < len(wds):
                    p["decay_mult"] = wds[i]
                params.append(p)
            nl["param"] = params
        upgraded.append(nl)
    out["layer"] = upgraded
    return out


def _param_specs(layer: dict):
    specs = []
    for p in _as_list(layer.get("param")):
        if isinstance(p, dict):
            specs.append(
                ParamSpec(
                    lr_mult=float(p.get("lr_mult", 1.0)),
                    decay_mult=float(p.get("decay_mult", 1.0)),
                    name=p.get("name"),
                )
            )
    return tuple(specs)


_OPTS_MAP = {
    "Convolution": ("convolution_param", "convolution"),
    "Deconvolution": ("convolution_param", "deconvolution"),
    "InnerProduct": ("inner_product_param", "innerproduct"),
    "BN": ("bn_param", "bn"),
    "ReLU": ("relu_param", "relu"),
    "Pooling": ("pooling_param", "pooling"),
    "Dropout": ("dropout_param", "dropout"),
    "Eltwise": ("eltwise_param", "eltwise"),
    "Concat": ("concat_param", "concat"),
    "Reshape": ("reshape_param", "reshape"),
    "Permute": ("permute_param", "permute"),
    "Flatten": ("flatten_param", "flatten"),
    "Softmax": ("softmax_param", "softmax"),
    "SoftmaxWithLoss": ("loss_param", "softmaxwithloss"),
    "Accuracy": ("accuracy_param", "accuracy"),
    "Scale": ("scale_param", "scale"),
    "Power": ("power_param", "power"),
    "Slice": ("slice_param", "slice"),
    "Silence": (None, "silence"),
    "VideoData": ("video_data_param", "videodata"),
    "ImageData": ("image_data_param", "imagedata"),
    "Data": ("data_param", "data"),
    "Gather": (None, "gather"),
    "Scatter": (None, "scatter"),
    "LRN": ("lrn_param", "lrn"),
    "Sigmoid": (None, "sigmoid"),
    "TanH": (None, "tanh"),
    "AbsVal": (None, "absval"),
    "Exp": ("exp_param", "exp"),
    "ArgMax": ("argmax_param", "argmax"),
    "EuclideanLoss": (None, "euclideanloss"),
    "BatchNorm": ("batch_norm_param", "batchnorm"),
    "Split": (None, "split"),
    "Threshold": ("threshold_param", "threshold"),
    "BNLL": (None, "bnll"),
    "MVN": ("mvn_param", "mvn"),
    "HingeLoss": ("hinge_loss_param", "hingeloss"),
    "SigmoidCrossEntropyLoss": ("loss_param", "sigmoidcrossentropyloss"),
    "InfogainLoss": ("infogain_loss_param", "infogainloss"),
    "ContrastiveLoss": ("contrastive_loss_param", "contrastiveloss"),
    "Im2col": ("convolution_param", "im2col"),
    "MemoryData": ("memory_data_param", "memorydata"),
    "HDF5Data": ("hdf5_data_param", "hdf5data"),
    "HDF5Output": ("hdf5_output_param", "hdf5output"),
    "DummyData": ("dummy_data_param", "dummydata"),
    "MultinomialLogisticLoss": ("loss_param", "multinomiallogisticloss"),
    "WindowData": ("window_data_param", "windowdata"),
    "SegData": ("seg_data_param", "segdata"),
    # V2-only tail: every remaining layer in src/caffe/layers/
    "Log": ("log_param", "log"),
    "PReLU": ("prelu_param", "prelu"),
    "Bias": ("bias_param", "bias"),
    "Reduction": ("reduction_param", "reduction"),
    "BatchReduction": ("batch_reduction_param", "batchreduction"),
    "Normalize": (None, "normalize"),
    "SPP": ("spp_param", "spp"),
    "ROIPooling": ("roi_pooling_param", "roipooling"),
    "SmoothL1Loss": ("loss_param", "smoothl1loss"),
    "Filter": (None, "filter"),
}


def _lower_layer(layer: dict) -> LayerSpec:
    ltype = layer["type"]
    if ltype not in _OPTS_MAP:
        raise ValueError(f"unsupported layer type {ltype!r}")
    pkey, our_type = _OPTS_MAP[ltype]
    opts: dict[str, Any] = {}
    if pkey and pkey in layer:
        opts.update(layer[pkey])
    # normalize enum-ish values
    if "pool" in opts:
        opts["pool"] = str(opts["pool"]).lower()
    if "operation" in opts:
        opts["operation"] = str(opts["operation"]).lower()
    if ltype == "Reshape" and "shape" in opts:
        opts["dims"] = tuple(_as_list(opts.pop("shape").get("dim")))
    if ltype == "Permute" and "order" in opts:
        opts["order"] = tuple(_as_list(opts["order"]))
    if "loss_weight" in layer:
        # top-level loss_weight applies to any loss-type layer
        # (SoftmaxWithLoss, EuclideanLoss, ...); Program.total_loss reads it
        opts["loss_weight"] = layer["loss_weight"]
    if ltype == "Accuracy" and "accuracy_param" in layer:
        opts.update(layer["accuracy_param"])
    if ltype in ("VideoData", "Data", "ImageData", "WindowData"):
        opts["transform"] = dict(layer.get("transform_param", {}))
    # preserve full NetStateRules (stage / not_stage / min/max_level) for
    # GraphSpec.filtered; plain phase-only rules don't need this
    rules = {}
    for key in ("include", "exclude"):
        rl = [r for r in _as_list(layer.get(key)) if isinstance(r, dict)]
        # multi-rule phase sets (e.g. exclude both phases) are lossy as a
        # single phase tag -- keep the full rules for GraphSpec.filtered
        if any(set(r) - {"phase"} for r in rl) or len(rl) > 1:
            rules[key] = rl
    if rules:
        opts["state_rules"] = rules
    return LayerSpec(
        name=layer.get("name", layer["type"]),
        type=our_type,
        bottoms=tuple(_as_list(layer.get("bottom"))),
        tops=tuple(_as_list(layer.get("top"))),
        options=opts,
        phase=_phase_of(layer),
        params=_param_specs(layer),
    )


def _peephole(layers: list[LayerSpec], data_tops: set[str]) -> list[LayerSpec]:
    out: list[LayerSpec] = []
    i = 0
    while i < len(layers):
        l = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        nxt2 = layers[i + 2] if i + 2 < len(layers) else None
        if l.type == "reshape":
            dims = tuple(l.opt("dims", ()))
            # r2Dto3D + Permute -> unfold_segments
            if (
                len(dims) == 5
                and dims[0] == -1
                and nxt is not None
                and nxt.type == "permute"
                and tuple(nxt.opt("order", ())) == (0, 2, 1, 3, 4)
                and nxt.bottoms == l.tops
            ):
                out.append(
                    LayerSpec(l.name, "unfold_segments", l.bottoms, nxt.tops,
                              {"num_segments": int(dims[1])}, l.phase)
                )
                i += 2
                continue
            # segment consensus triple (must be AVE and actually connected)
            if (
                len(dims) == 4
                and dims[0] == -1
                and dims[1] == 1
                and nxt is not None
                and nxt.type == "pooling"
                and str(nxt.opt("pool", "max")).lower() in ("ave", "avg")
                and nxt.bottoms == l.tops
                and nxt.opt("kernel_h") == dims[2]
                and nxt.opt("kernel_w") == 1
                and nxt2 is not None
                and nxt2.type == "reshape"
                and nxt2.bottoms == nxt.tops
            ):
                out.append(
                    LayerSpec(nxt.name, "segment_consensus", l.bottoms, nxt2.tops,
                              {"num_segments": int(dims[2])}, l.phase)
                )
                i += 3
                continue
            # data-layer segment fold
            if len(dims) == 4 and dims[0] == -1 and l.bottoms and l.bottoms[0] in data_tops:
                out.append(
                    LayerSpec(l.name, "fold_segments", l.bottoms, l.tops, {}, l.phase)
                )
                i += 1
                continue
            # length_first dense-clip view: logical (N, C*L, H, W) ->
            # (N, C, L, H, W) is already our physical (N, L, H, W, C)
            # (112_c3d_resnet_18_train_val.prototxt:63-68)
            if (
                len(dims) == 5
                and dims[0] == -1
                and l.bottoms
                and l.bottoms[0] in data_tops
            ):
                out.append(
                    LayerSpec(l.name, "identity", l.bottoms, l.tops, {}, l.phase)
                )
                i += 1
                continue
        out.append(l)
        i += 1
    return out


def graph_from_prototxt(text: str, *, name: str = None) -> GraphSpec:
    net = upgrade_v1_net(parse_prototxt(text))
    graph = GraphSpec(name or net.get("name", "net"))
    # deploy-style inputs
    inputs = _as_list(net.get("input"))
    if inputs:
        dims = [int(d) for d in _as_list(net.get("input_dim"))]
        shapes = _as_list(net.get("input_shape"))
        for k, inp in enumerate(inputs):
            if dims:
                per = len(dims) // len(inputs)
                shape = tuple(dims[k * per:(k + 1) * per])
            else:
                shape = tuple(int(d) for d in _as_list(shapes[k].get("dim")))
            if len(shape) >= 3:
                # declared shapes are logical NCHW; graph inputs are physical
                # channels-last
                shape = (shape[0],) + shape[2:] + (shape[1],)
            graph.inputs[inp] = shape
    if "mem_param" in net:
        graph.options["mem_param"] = dict(net["mem_param"])
    raw = [_lower_layer(l) for l in _as_list(net.get("layer"))]
    data_tops = {
        t for l in raw if l.type in ("videodata", "imagedata", "data") for t in l.tops
    }
    graph.layers = _peephole(raw, data_tops)
    return graph


# ---------------------------------------------------------------------------
# NetParameter dict -> protobuf text (the inverse of parse_prototxt)
# ---------------------------------------------------------------------------

# caffe.proto fields whose string-ish values are *enum tokens* (emitted bare),
# not protobuf strings (emitted quoted).  Everything else that parses as str
# is a real string field (name/type/bottom/top/source/lr_policy/...).
_ENUM_FIELDS = {
    "pool", "phase", "modality", "operation", "norm", "norm_region", "engine",
    "backend", "share_mode", "variance_norm", "solver_mode", "solver_type",
    "snapshot_format", "db", "round_mode",
}


# protobuf text strings cannot contain raw control chars -- escape them
# (a name/source with a newline would otherwise emit an unparseable file)
_STRING_ESCAPES = {
    ord("\\"): "\\\\", ord('"'): '\\"',
    ord("\n"): "\\n", ord("\r"): "\\r", ord("\t"): "\\t",
}


def _format_value(key: str, v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        if key in _ENUM_FIELDS:
            return v
        return '"' + v.translate(_STRING_ESCAPES) + '"'
    if isinstance(v, float):
        return repr(v)
    return str(v)


def format_prototxt(net: dict, _indent: int = 0) -> str:
    """Nested NetParameter dict -> protobuf text format.

    Inverse of :func:`parse_prototxt` up to formatting: repeated fields
    (lists) are emitted as repeated scalar/message entries (never the fork's
    ``[a, b, c]`` bracket extension, so output stays stock-Caffe readable).
    Used by ``eco upgrade`` (tools/upgrade_net_proto_text.cpp parity).
    """
    pad = "  " * _indent
    lines = []
    for key, value in net.items():
        items = value if isinstance(value, list) else [value]
        for item in items:
            if isinstance(item, dict):
                body = format_prototxt(item, _indent + 1)
                lines.append(f"{pad}{key} {{\n{body}{pad}}}")
            else:
                lines.append(f"{pad}{key}: {_format_value(key, item)}")
    return "".join(l + "\n" for l in lines)
