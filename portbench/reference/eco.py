"""Plain PyTorch ECO-Lite and ECO-Full, in float32, for the benchmark's check.

Written from the published model definitions (mzolfaghari/ECO-efficient-
video-understanding, ``models_ECO_Lite/kinetics/ECO_Lite.prototxt`` and
``models_ECO_Full/kinetics/ECO_Full.prototxt``), as they run at test time
(dropout the identity, BN on its running statistics).  It imports nothing of the program under
test: no kernel, no graph, no weight it prepared.  Tensors are NCHW and
NCDHW; batch normalisation is unfolded; every conv and fc runs in float32
(the caller turns TF32 off).

A net is a list of layers (``layers``), which the forward pass runs and the
counts (``portbench/counts``) walk for shapes.  Weights are
``{layer: {"w", "b"}}`` for convs and fcs and ``{layer: {"gamma", "beta"}}``
for BN, with BN running statistics ``{layer: {"mean", "var"}}``.
``param_specs``, ``clips`` and ``forward`` are the reference interface
(``portbench/reference/__init__.py``) of both ECO configurations.

The weights' draws, chosen so that activations stay near unit scale
through every layer in inference as in training:
- conv and fc weights Laplace with scale b = sqrt(1 / fan_in) (variance
  2 / fan_in, which ReLU halves back), divided by 75 for the conv that
  reads the clips (uint8 pixels minus the mean have an RMS of some 10 to
  75): trained conv weights peak at zero with heavy tails, and a uniform
  draw, which has no tails, would make every per-channel int8 scale look
  better than it does on a trained net;
- biases U(-0.1, 0.1); BN scale U(0.8, 1.2), shift U(-0.2, 0.2);
- BN running mean U(-0.2, 0.2), running variance U(0.8, 1.25), so that
  folding them into the convs is not the identity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from portbench.reference import ParamSpec

# Inception blocks (ECO_Lite.prototxt:182-1330, ECO_Full.prototxt:1426-4800):
# (1x1, 3x3 reduce, 3x3, double reduce, double 1, double 2, pool proj, pool).
# A block without a 1x1 is a stride-2 reduction with a max pool branch.
INCEPTION = {
    "3a": (64, 64, 64, 64, 96, 96, 32, "ave"),
    "3b": (64, 64, 96, 64, 96, 96, 64, "ave"),
    "3c": (None, 128, 160, 64, 96, 96, None, "max"),
    "4a": (224, 64, 96, 96, 128, 128, 128, "ave"),
    "4b": (192, 96, 128, 96, 128, 128, 128, "ave"),
    "4c": (160, 128, 160, 128, 160, 160, 128, "ave"),
    "4d": (96, 128, 192, 160, 192, 192, 128, "ave"),
    "4e": (None, 128, 192, 192, 256, 256, None, "max"),
    "5a": (352, 192, 320, 160, 224, 224, 128, "ave"),
    "5b": (352, 192, 320, 192, 224, 224, 128, "max"),
}

BN_EPS = 1e-5
PIXEL_RMS = 75.0
UNIFORM = {"b": (-0.1, 0.1), "gamma": (0.8, 1.2), "beta": (-0.2, 0.2),
           "mean": (-0.2, 0.2), "var": (0.8, 1.25)}


@dataclass
class Layer:
    name: str
    op: str
    bottoms: tuple
    top: str
    attrs: dict = field(default_factory=dict)


class _NetSpec:
    def __init__(self):
        self.layers: list[Layer] = []

    def add(self, name, op, bottoms, top=None, **attrs):
        if isinstance(bottoms, str):
            bottoms = (bottoms,)
        self.layers.append(Layer(name, op, tuple(bottoms), top or name, attrs))
        return top or name

    def conv_bn_relu(self, name, x, cout, k, s=1, p=0):
        x = self.add(name, "conv", x, cout=cout, k=k, s=s, p=p, dim=2)
        x = self.add(name + "_bn", "bn", x)
        return self.add(name + "_relu", "relu", x)

    def inception(self, block, x):
        n1, nr3, n3, ndr, nd1, nd2, npp, pool = INCEPTION[block]
        pre = f"inception_{block}"
        stride = 2 if n1 is None else 1
        outs = []
        if n1 is not None:
            outs.append(self.conv_bn_relu(f"{pre}_1x1", x, n1, 1))
        r = self.conv_bn_relu(f"{pre}_3x3_reduce", x, nr3, 1)
        outs.append(self.conv_bn_relu(f"{pre}_3x3", r, n3, 3, stride, 1))
        r = self.conv_bn_relu(f"{pre}_double_3x3_reduce", x, ndr, 1)
        d = self.conv_bn_relu(f"{pre}_double_3x3_1", r, nd1, 3, 1, 1)
        outs.append(self.conv_bn_relu(f"{pre}_double_3x3_2", d, nd2, 3, stride, 1))
        if n1 is None:
            outs.append(self.add(f"{pre}_pool", "maxpool", x, k=3, s=2, p=0))
        else:
            p = self.add(f"{pre}_pool", "maxpool" if pool == "max" else "avepool", x,
                         k=3, s=1, p=1)
            outs.append(self.conv_bn_relu(f"{pre}_pool_proj", p, npp, 1))
        return self.add(f"{pre}_output", "concat", outs)

    def conv3(self, name, x, cout, s, top=None):
        return self.add(name, "conv", x, top, cout=cout, k=3, s=s, p=1, dim=3)

    def bn_relu(self, name, x):
        return self.add(name + "_relu", "relu", self.add(name + "_bn", "bn", x))


def layers(variant: str, num_classes: int, fc_name: str, dropout: float,
           segments: int) -> list[Layer]:
    """The executed layers of ECO-Lite (``variant="lite"``) or ECO-Full."""
    b = _NetSpec()
    x = b.conv_bn_relu("conv1_7x7_s2", "data", 64, 7, 2, 3)
    x = b.add("pool1_3x3_s2", "maxpool", x, k=3, s=2, p=0)
    x = b.conv_bn_relu("conv2_3x3_reduce", x, 64, 1)
    x = b.conv_bn_relu("conv2_3x3", x, 192, 3, 1, 1)
    x = b.add("pool2_3x3_s2", "maxpool", x, k=3, s=2, p=0)
    x = b.inception("3a", x)
    out_3b = b.inception("3b", x)
    r = b.conv_bn_relu("inception_3c_double_3x3_reduce", out_3b, 64, 1)
    trunk = b.conv_bn_relu("inception_3c_double_3x3_1", r, 96, 3, 1, 1)

    # 3D head (ECO_Lite.prototxt:1310-1830): the segments become depth
    x = b.add("r2Dto3D", "to3d", trunk, segments=segments)
    res3a = b.conv3("res3a_2n", x, 128, 1, top="res3a")
    x = b.bn_relu("res3a", res3a)
    y = b.bn_relu("res3b_1", b.conv3("res3b_1", x, 128, 1))
    y = b.conv3("res3b_2", y, 128, 1)
    x = b.bn_relu("res3b", b.add("res3b", "add", (y, res3a)))
    for stage, cout in (("res4", 256), ("res5", 512)):
        y = b.bn_relu(f"{stage}a_1", b.conv3(f"{stage}a_1", x, cout, 2))
        y = b.conv3(f"{stage}a_2", y, cout, 1)
        down = b.conv3(f"{stage}a_down", x, cout, 2)
        xa = b.add(f"{stage}a", "add", (y, down))
        x = b.bn_relu(f"{stage}a", xa)
        y = b.bn_relu(f"{stage}b_1", b.conv3(f"{stage}b_1", x, cout, 1))
        y = b.conv3(f"{stage}b_2", y, cout, 1)
        x = b.bn_relu(f"{stage}b", b.add(f"{stage}b", "add", (y, xa)))
    x = b.add("global_pool", "gap3d", x)
    feat = b.add("dropout", "dropout", x, ratio=dropout)

    if variant == "full":
        # ECO_Full.prototxt:1299-4881: the 2D path goes on from 3b's output
        # and shares the trunk's double-3x3 tower of 3c
        r = b.conv_bn_relu("inception_3c_3x3_reduce", out_3b, 128, 1)
        br3 = b.conv_bn_relu("inception_3c_3x3", r, 160, 3, 2, 1)
        brd = b.conv_bn_relu("inception_3c_double_3x3_2", trunk, 96, 3, 2, 1)
        brp = b.add("inception_3c_pool", "maxpool", out_3b, k=3, s=2, p=0)
        x2 = b.add("inception_3c_output", "concat", (br3, brd, brp))
        for block in ("4a", "4b", "4c", "4d", "4e", "5a", "5b"):
            x2 = b.inception(block, x2)
        x2 = b.add("global_pool2D", "avepool", x2, k=7, s=1, p=0)
        x2 = b.add("dropout2D", "dropout", x2, ratio=dropout)
        x2 = b.add("segment_consensus_st2", "consensus", x2, segments=segments)
        feat = b.add("gn02_concat", "concat", (x2, feat))
    elif variant != "lite":
        raise ValueError(f"unknown ECO variant {variant!r}")
    b.add(fc_name, "fc", feat, cout=num_classes)
    return b.layers


def _pool_out(size, k, s, p):
    """Caffe's pooled size: ceil, then drop a window that starts past the
    padded input (pooling_layer.cpp)."""
    out = int(math.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    return out


def shapes(net: list[Layer], videos: int, segments: int, crop: int) -> dict:
    """Every blob's shape, batch axis first, for ``videos`` clips."""
    shp = {"data": (videos * segments, 3, crop, crop)}
    for l in net:
        ins = [shp[b] for b in l.bottoms]
        x = ins[0]
        a = l.attrs
        if l.op == "conv":
            sp = tuple((d + 2 * a["p"] - a["k"]) // a["s"] + 1 for d in x[2:])
            out = (x[0], a["cout"]) + sp
        elif l.op in ("maxpool", "avepool"):
            out = x[:2] + tuple(_pool_out(d, a["k"], a["s"], a["p"]) for d in x[2:])
        elif l.op == "concat":
            out = (x[0], sum(i[1] for i in ins)) + tuple(x[2:])
        elif l.op == "to3d":
            out = (x[0] // a["segments"], x[1], a["segments"]) + tuple(x[2:])
        elif l.op == "gap3d":
            out = x[:2]
        elif l.op == "consensus":
            out = (x[0] // a["segments"], x[1])
        elif l.op == "fc":
            out = (x[0], a["cout"])
        else:  # bn, relu, add, dropout keep the shape
            out = x
        shp[l.top] = out
    return shp


def _uniform(layer, name, shape):
    return ParamSpec(layer, name, shape, *UNIFORM[name])


def param_specs(net: list[Layer], cfg: dict) -> tuple[list, list]:
    """(params, BN statistics) as ParamSpecs, in layer order, each with its
    draw (the module's note)."""
    shp = shapes(net, 1, cfg["num_segments"], cfg["crop_size"])
    params, stats = [], []
    for l in net:
        x = shp[l.bottoms[0]]
        if l.op in ("conv", "fc"):
            cin = x[1] if l.op == "conv" else math.prod(x[1:])
            k = (l.attrs["k"],) * l.attrs["dim"] if l.op == "conv" else ()
            fan = cin * math.prod(k)
            scale = math.sqrt(1.0 / fan) / (PIXEL_RMS if l.bottoms[0] == "data" else 1.0)
            params.append(ParamSpec(l.name, "w", (l.attrs["cout"], cin) + k, laplace=scale))
            params.append(_uniform(l.name, "b", (l.attrs["cout"],)))
        elif l.op == "bn":
            c = x[1]
            params += [_uniform(l.name, n, (c,)) for n in ("gamma", "beta")]
            stats += [_uniform(l.name, n, (c,)) for n in ("mean", "var")]
    return params, stats


def clips_from_frames(frames_u8, h_off, w_off, mirror, *, crop: int, mean) -> torch.Tensor:
    """uint8 (N, S, H, W, 3) frames, per-video crop offsets and mirror flags
    -> float32 (N, S, crop, crop, 3) clips: the crop (offsets clamped into
    the frame), the horizontal mirror, minus the per-channel mean."""
    n, s, h, w, _ = frames_u8.shape
    out = torch.empty((n, s, crop, crop, 3), dtype=torch.float32, device=frames_u8.device)
    m = torch.tensor(mean, dtype=torch.float32, device=frames_u8.device)
    for i in range(n):
        y0 = min(max(int(h_off[i]), 0), h - crop)
        x0 = min(max(int(w_off[i]), 0), w - crop)
        v = frames_u8[i, :, y0:y0 + crop, x0:x0 + crop, :].float() - m
        out[i] = v.flip(2) if bool(mirror[i]) else v
    return out


def clips(cfg: dict, frames_u8, h_off, w_off, mirror) -> torch.Tensor:
    """The configuration's clips: its crop, minus its BGR mean."""
    return clips_from_frames(frames_u8, h_off, w_off, mirror, crop=cfg["crop_size"],
                             mean=cfg["mean_bgr"])


def _bn(x, p, st):
    view = (1, -1) + (1,) * (x.ndim - 2)
    inv = p["gamma"] / torch.sqrt(st["var"] + BN_EPS)
    return (x - st["mean"].view(view)) * inv.view(view) + p["beta"].view(view)


def forward(net, params, state, clips):
    """float32 clips (N, S, H, W, 3) -> logits (N, classes)."""
    n, s = clips.shape[:2]
    blobs = {"data": clips.reshape((n * s,) + tuple(clips.shape[2:])).permute(0, 3, 1, 2)}
    for l in net:
        ins = [blobs[b] for b in l.bottoms]
        x = ins[0]
        a = l.attrs
        if l.op == "conv":
            conv = F.conv2d if a["dim"] == 2 else F.conv3d
            y = conv(x, params[l.name]["w"], params[l.name]["b"], stride=a["s"], padding=a["p"])
        elif l.op == "bn":
            y = _bn(x, params[l.name], state[l.name])
        elif l.op == "relu":
            y = F.relu(x)
        elif l.op in ("maxpool", "avepool"):
            want = tuple(_pool_out(d, a["k"], a["s"], a["p"]) for d in x.shape[2:])
            if l.op == "maxpool":
                y = F.max_pool2d(x, a["k"], a["s"], a["p"], ceil_mode=True)
            else:  # padded cells count in the divisor, as in pooling_layer.cpp
                y = F.avg_pool2d(x, a["k"], a["s"], a["p"], ceil_mode=True,
                                 count_include_pad=True)
            if tuple(y.shape[2:]) != want:
                raise ValueError(f"{l.name}: pooled {tuple(y.shape[2:])}, Caffe gives {want}")
        elif l.op == "concat":
            y = torch.cat(ins, dim=1)
        elif l.op == "add":
            y = ins[0] + ins[1]
        elif l.op == "to3d":
            y = x.reshape((-1, a["segments"]) + tuple(x.shape[1:])).transpose(1, 2)
        elif l.op == "gap3d":
            y = x.mean(dim=(2, 3, 4))
        elif l.op == "consensus":
            y = x.reshape(-1, a["segments"], x.shape[1]).mean(dim=1)
        elif l.op == "dropout":  # the identity at test time
            y = x
        elif l.op == "fc":
            y = F.linear(x.flatten(1), params[l.name]["w"], params[l.name]["b"])
        else:
            raise ValueError(f"unknown op {l.op!r}")
        blobs[l.top] = y
    return y
