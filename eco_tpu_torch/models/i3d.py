"""I3D, RGB stream: the Inflated Inception-V1 of Carreira & Zisserman, "Quo
Vadis, Action Recognition? A New Model and the Kinetics Dataset" (CVPR
2017, arXiv:1705.07750), as ``InceptionI3d`` of deepmind/kinetics-i3d
(``i3d.py``) defines it up to its averaged logits.

Input is a dense clip (N, T, H, W, 3) channels-last: the serving plane's
BGR frames minus 127.5 (K1 with ``mean`` 127.5).  The published model takes
RGB in [-1, 1], so the first layer, ``input_transform``, reverses the
channels and scales by 1/127.5; ``optimize_for_inference`` folds it into
the stem's weights (``convert.load.fold_input_transform``).

Each unit is a bias-free conv, sonnet's ``BatchNorm`` (offset only, so
``gamma`` stays 1 and does not train; ``eps`` 1e-3) and a ReLU; the logits
conv has a bias and neither.  Convs pad as TF's "SAME": the 7x7x7/s2 stem
pads (2, 3) on each axis at even sizes, every other conv is stride 1 with
an odd kernel, so symmetric.  Every pool's "SAME" is Caffe's ceil mode with
the pad TF puts before the input, checked here at the graph's sizes.

Layer names are ``i3d.py``'s variable scopes under ``RGB/inception_i3d/``,
so converting the public checkpoint is a rename: ``<scope>/conv_3d/{w,b}``
is layer ``<scope>``,
``<scope>/batch_norm/{beta,moving_mean,moving_variance}`` is layer
``<scope>/batch_norm`` (``beta``, ``mean``, ``var``), and the logits conv
``Logits/Conv3d_0c_1x1`` is ``Conv3d_0c_1x1``.  TF's conv weights are
(D, H, W, C_in, C_out); this package's are (C_out, C_in, D, H, W).
"""

from __future__ import annotations

import math

from eco_tpu_torch.spec.graph import GraphSpec, ParamSpec
from eco_tpu_torch.spec.netspec import NetBuilder
from eco_tpu_torch.utils.shapes import caffe_pool_out_dim

BN_EPS = 1e-3  # sonnet's BatchNorm default
PIXEL_SCALE = 1.0 / 127.5

# Mixed modules: (Branch_0 1x1; Branch_1 1x1, 3x3; Branch_2 1x1, 3x3;
# Branch_3 1x1 after a 3x3x3/s1 max pool)
MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF's "SAME" padding of one axis, (before, after): ceil(size / s)
    outputs, the odd cell after."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def build_i3d(
    num_classes: int = 400,
    *,
    num_frames: int = 64,
    crop_size: int = 224,
    batch: int = 1,
) -> GraphSpec:
    b = NetBuilder("i3d_rgb")
    x = b.input("data", (batch, num_frames, crop_size, crop_size, 3))
    sizes = [num_frames, crop_size, crop_size]

    def unit(name, x, cout, k, s=1):
        kernel, stride = (k,) * 3, (s,) * 3
        pads = [same_pads(n, k, s) for n in sizes]
        sizes[:] = [math.ceil(n / s) for n in sizes]
        pad = [lo for lo, _ in pads] if all(lo == hi for lo, hi in pads) else pads
        x = b.conv(name, x, cout, k=kernel, s=stride, p=pad, bias=False)
        bn = b.layer(f"{name}/batch_norm", "bn", x, eps=BN_EPS,
                     params=(ParamSpec(0.0, 0.0), ParamSpec(1.0, 0.0)))
        return b.layer(f"{name}/relu", "relu", bn, tops=bn)

    def max_pool(name, x, k, s):
        pads = []
        for i, (size, kk, ss) in enumerate(zip(sizes, k, s)):
            lo, _ = same_pads(size, kk, ss)
            out, _ = caffe_pool_out_dim(size, kk, ss, lo)
            if out != math.ceil(size / ss):
                raise ValueError(f"{name}: Caffe's ceil mode gives {out} where TF's SAME "
                                 f"gives {math.ceil(size / ss)} on an axis of {size}")
            pads.append(lo)
            sizes[i] = out
        return b.max_pool(name, x, k=k, s=s, p=pads)

    x = b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0],
                scale=PIXEL_SCALE)
    x = unit("Conv3d_1a_7x7", x, 64, 7, 2)
    x = max_pool("MaxPool3d_2a_3x3", x, (1, 3, 3), (1, 2, 2))
    x = unit("Conv3d_2b_1x1", x, 64, 1)
    x = unit("Conv3d_2c_3x3", x, 192, 3)
    x = max_pool("MaxPool3d_3a_3x3", x, (1, 3, 3), (1, 2, 2))
    for name in ("Mixed_3b", "Mixed_3c", "MaxPool3d_4a_3x3", "Mixed_4b", "Mixed_4c",
                 "Mixed_4d", "Mixed_4e", "Mixed_4f", "MaxPool3d_5a_2x2", "Mixed_5b",
                 "Mixed_5c"):
        if name.startswith("MaxPool"):
            k = 3 if name.endswith("3x3") else 2
            x = max_pool(name, x, (k,) * 3, (2,) * 3)
            continue
        n0, n1a, n1b, n2a, n2b, n3 = MIXED[name]
        b0 = unit(f"{name}/Branch_0/Conv3d_0a_1x1", x, n0, 1)
        b1 = unit(f"{name}/Branch_1/Conv3d_0a_1x1", x, n1a, 1)
        b1 = unit(f"{name}/Branch_1/Conv3d_0b_3x3", b1, n1b, 3)
        b2 = unit(f"{name}/Branch_2/Conv3d_0a_1x1", x, n2a, 1)
        # i3d.py names Mixed_5b's second Branch_2 conv Conv3d_0a_3x3
        b2 = unit(f"{name}/Branch_2/Conv3d_0{'a' if name == 'Mixed_5b' else 'b'}_3x3",
                  b2, n2b, 3)
        b3 = max_pool(f"{name}/Branch_3/MaxPool3d_0a_3x3", x, (3,) * 3, (1,) * 3)
        b3 = unit(f"{name}/Branch_3/Conv3d_0b_1x1", b3, n3, 1)
        x = b.concat(f"{name}/concat", [b0, b1, b2, b3])

    # Logits: a (2, 7, 7) average pool, VALID, dropout (the identity at
    # test time), the 1x1x1 logits conv, then the mean over time
    x = b.avg_pool("Logits/AvgPool3d_0a_7x7", x, k=(2, 7, 7), s=1)
    x = b.dropout("Logits/Dropout_0b", x, 0.5)
    x = b.conv("Conv3d_0c_1x1", x, num_classes, k=(1, 1, 1), lr=(1.0, 2.0), decay=(1.0, 0.0))
    x = b.layer("averaged_logits", "global_avg_pool", x)
    b.layer("probs", "softmax", x)
    return b.build()
