"""Plain PyTorch I3D, RGB stream (Inflated Inception-V1, Kinetics-400), in
float32: the yardstick that I3D's graph in the port is held to.

Written from the published model (Carreira & Zisserman, CVPR 2017,
arXiv:1705.07750; ``InceptionI3d`` of deepmind/kinetics-i3d, ``i3d.py``)
as it runs at test time (dropout the identity, batch norm on its moving
statistics), independently of the port: it imports nothing of it, and
follows TF's own rules where the port follows Caffe's.  Tensors are NCDHW;
every conv pads TF's "SAME" by an explicit ``F.pad`` with zeros and every
max pool by one with -inf, then runs unpadded; batch norm is unfolded; the
caller turns TF32 off.

The clips are the published input: uint8 BGR frames through their crop,
mirror, BGR -> RGB and x / 127.5 - 1.

A net is a list of ``Layer`` s, which ``forward`` runs and ``shapes`` walks
(FLOP counts read it).  Weights are ``{layer: {"w", "b"}}`` for convs and
``{layer: {"gamma", "beta"}}`` for batch norm, with its moving statistics
``{layer: {"mean", "var"}}``, named as the port's graph names them.

The weights' draws (``param_specs``), so that activations stay near unit
scale through every layer: conv weights Laplace of scale sqrt(1 / fan_in)
(variance 2 / fan_in, which ReLU halves back; the stem's inputs are already
in [-1, 1], so it is not divided), the logits' bias U(-0.1, 0.1); batch
norm's offset U(-0.2, 0.2) and its scale exactly 1 (sonnet's BatchNorm has
no scale); moving mean U(-0.2, 0.2), moving variance U(0.8, 1.25).
"""

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    """One parameter or statistic of ``shape``: Laplace of scale
    ``laplace`` where that is above 0, else uniform on [``low``, ``high``)."""

    layer: str
    name: str
    shape: tuple
    low: float = 0.0
    high: float = 0.0
    laplace: float = 0.0


BN_EPS = 1e-3
UNIFORM = {"b": (-0.1, 0.1), "gamma": (1.0, 1.0), "beta": (-0.2, 0.2),
           "mean": (-0.2, 0.2), "var": (0.8, 1.25)}

# i3d.py's Mixed modules: (Branch_0; Branch_1 reduce, 3x3; Branch_2 reduce,
# 3x3; Branch_3 after the 3x3x3 max pool)
MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", None),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", None),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)


@dataclass
class Layer:
    name: str
    op: str
    bottoms: tuple
    top: str
    attrs: dict = field(default_factory=dict)


def net(cfg: dict) -> list[Layer]:
    """The executed layers, up to the averaged logits."""
    out: list[Layer] = []

    def add(name, op, bottoms, **attrs):
        out.append(Layer(name, op, (bottoms,) if isinstance(bottoms, str) else tuple(bottoms),
                         name, attrs))
        return name

    def unit(name, x, cout, k, s=1):
        x = add(name, "conv", x, cout=cout, k=(k,) * 3, s=(s,) * 3, bias=False)
        return add(name + "/relu", "relu", add(name + "/batch_norm", "bn", x))

    def max_pool(name, x, k, s):
        return add(name, "maxpool", x, k=k, s=s)

    x = unit("Conv3d_1a_7x7", "data", 64, 7, 2)
    x = max_pool("MaxPool3d_2a_3x3", x, (1, 3, 3), (1, 2, 2))
    x = unit("Conv3d_2b_1x1", x, 64, 1)
    x = unit("Conv3d_2c_3x3", x, 192, 3)
    x = max_pool("MaxPool3d_3a_3x3", x, (1, 3, 3), (1, 2, 2))
    for name, widths in MIXED:
        if widths is None:
            k = 3 if name.endswith("3x3") else 2
            x = max_pool(name, x, (k,) * 3, (2,) * 3)
            continue
        n0, n1a, n1b, n2a, n2b, n3 = widths
        b0 = unit(f"{name}/Branch_0/Conv3d_0a_1x1", x, n0, 1)
        b1 = unit(f"{name}/Branch_1/Conv3d_0b_3x3",
                  unit(f"{name}/Branch_1/Conv3d_0a_1x1", x, n1a, 1), n1b, 3)
        second = "Conv3d_0a_3x3" if name == "Mixed_5b" else "Conv3d_0b_3x3"
        b2 = unit(f"{name}/Branch_2/{second}",
                  unit(f"{name}/Branch_2/Conv3d_0a_1x1", x, n2a, 1), n2b, 3)
        b3 = unit(f"{name}/Branch_3/Conv3d_0b_1x1",
                  max_pool(f"{name}/Branch_3/MaxPool3d_0a_3x3", x, (3,) * 3, (1,) * 3), n3, 1)
        x = add(name, "concat", (b0, b1, b2, b3))
    x = add("Logits/AvgPool3d_0a_7x7", "avgpool", x, k=(2, 7, 7))
    x = add("Conv3d_0c_1x1", "conv", x, cout=cfg["num_classes"], k=(1, 1, 1), s=(1, 1, 1),
            bias=True)
    add("averaged_logits", "mean_t", x)
    return out


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF's "SAME" padding of one axis: (before, after)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def shapes(net: list[Layer], videos: int, frames: int, crop: int) -> dict:
    """Every blob's (N, C, T, H, W), or (N, classes) for the logits."""
    shp = {"data": (videos, 3, frames, crop, crop)}
    for l in net:
        x = shp[l.bottoms[0]]
        a = l.attrs
        if l.op in ("conv", "maxpool"):
            s = a["s"]
            out = x[:2] + tuple(math.ceil(d / st) for d, st in zip(x[2:], s))
            if l.op == "conv":
                out = (x[0], a["cout"]) + out[2:]
        elif l.op == "avgpool":
            out = x[:2] + tuple(d - k + 1 for d, k in zip(x[2:], a["k"]))
        elif l.op == "concat":
            out = (x[0], sum(shp[b][1] for b in l.bottoms)) + x[2:]
        elif l.op == "mean_t":
            out = x[:2]
        else:  # bn, relu keep the shape
            out = x
        shp[l.top] = out
    return shp


def param_specs(net: list[Layer], cfg: dict) -> tuple[list, list]:
    """(params, batch norm statistics) as ParamSpecs, in layer order."""
    shp = shapes(net, 1, cfg["num_segments"], cfg["crop_size"])
    params, stats = [], []
    for l in net:
        c = shp[l.bottoms[0]][1]
        if l.op == "conv":
            k = l.attrs["k"]
            params.append(ParamSpec(l.name, "w", (l.attrs["cout"], c) + k,
                                    laplace=math.sqrt(1.0 / (c * math.prod(k)))))
            if l.attrs["bias"]:
                params.append(ParamSpec(l.name, "b", (l.attrs["cout"],), *UNIFORM["b"]))
        elif l.op == "bn":
            params += [ParamSpec(l.name, n, (c,), *UNIFORM[n]) for n in ("gamma", "beta")]
            stats += [ParamSpec(l.name, n, (c,), *UNIFORM[n]) for n in ("mean", "var")]
    return params, stats


def clips(cfg: dict, frames_u8, h_off, w_off, mirror) -> torch.Tensor:
    """uint8 (N, T, H, W, 3) BGR frames -> float32 (N, 3, T, crop, crop) RGB
    in [-1, 1]: the crop (offsets clamped into the frame), the horizontal
    mirror, BGR -> RGB, x / 127.5 - 1."""
    n, _, h, w, _ = frames_u8.shape
    crop = cfg["crop_size"]
    out = []
    for i in range(n):
        y0 = min(max(int(h_off[i]), 0), h - crop)
        x0 = min(max(int(w_off[i]), 0), w - crop)
        v = frames_u8[i, :, y0:y0 + crop, x0:x0 + crop, :].float()
        if bool(mirror[i]):
            v = v.flip(2)
        rgb = v.flip(-1) / 127.5 - 1.0
        out.append(rgb.permute(3, 0, 1, 2))
    return torch.stack(out)


def _pad_same(x, k, s, value):
    pads = []
    for size, kk, ss in reversed(list(zip(x.shape[2:], k, s))):
        pads += list(same_pads(size, kk, ss))
    return F.pad(x, pads, value=value)


def forward(net, params, state, clips):
    """float32 clips (N, 3, T, H, W) -> averaged logits (N, classes)."""
    blobs = {"data": clips}
    for l in net:
        x = blobs[l.bottoms[0]]
        a = l.attrs
        if l.op == "conv":
            p = params[l.name]
            y = F.conv3d(_pad_same(x, a["k"], a["s"], 0.0), p["w"], p.get("b"), stride=a["s"])
        elif l.op == "bn":
            view = (1, -1, 1, 1, 1)
            p, st = params[l.name], state[l.name]
            y = ((x - st["mean"].view(view)) / torch.sqrt(st["var"].view(view) + BN_EPS)
                 * p["gamma"].view(view) + p["beta"].view(view))
        elif l.op == "relu":
            y = F.relu(x)
        elif l.op == "maxpool":
            y = F.max_pool3d(_pad_same(x, a["k"], a["s"], float("-inf")), a["k"], a["s"])
        elif l.op == "avgpool":  # VALID
            y = F.avg_pool3d(x, a["k"], stride=1)
        elif l.op == "concat":
            y = torch.cat([blobs[b] for b in l.bottoms], dim=1)
        elif l.op == "mean_t":  # the logits are (N, classes, T, 1, 1)
            y = x.flatten(2).mean(dim=2)
        else:
            raise ValueError(f"unknown op {l.op!r}")
        blobs[l.top] = y
    return y
