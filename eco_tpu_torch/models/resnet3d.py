"""3D-ResNet-18 temporal-fusion head (res3a..res5b).

Structure transcribed from ECO_Lite.prototxt:1329-1830: each unit is
Conv3x3x3 (+BN+ReLU) pairs with identity Eltwise adds; stage transitions
(res4a, res5a) use stride-2 3x3x3 convs with a stride-2 3x3x3 downsample
projection ("res*_down").  Note the reference's idiosyncrasies, preserved
here: res3a has a single conv (no residual add), and the post-sum BN+ReLU
("pre-activation on the trunk") ordering.

All BNs are trainable (frozen: false, ECO_Lite.prototxt:1357) and use
standard momentum/eps.
"""

from __future__ import annotations

from eco_tpu_torch.spec.netspec import NetBuilder


def add_3d_head(b: NetBuilder, bottom: str) -> str:
    """bottom: (N, S, 28, 28, 96) NDHWC. Returns ``res5b_bn`` (N, S/4, 7, 7, 512)."""
    k3 = (3, 3, 3)
    s1, s2 = (1, 1, 1), (2, 2, 2)
    p1 = (1, 1, 1)

    def conv3(name, x, cout, s, top=None):
        from eco_tpu_torch.spec.graph import ParamSpec

        return b.layer(
            name, "convolution", x, tops=top,
            num_output=cout, kernel_size=k3, stride=s, pad=p1,
            weight_filler={"type": "xavier"},
            bias_filler={"type": "constant", "value": 0.0},
            # reference 3D convs: weight lr1/decay1, bias lr2/decay0
            # (ECO_Lite.prototxt:1349)
            params=(ParamSpec(1.0, 1.0), ParamSpec(2.0, 0.0)),
        )

    def bn_relu(name, x):
        y = b.bn(name + "_bn", x)
        return b.relu(name + "_relu", y)

    # res3a: single conv named res3a_2n producing top "res3a" (prototxt:1332-1350)
    x = conv3("res3a_2n", bottom, 128, s1, top="res3a")
    res3a = x
    x = bn_relu("res3a", x)
    # res3b: two convs + identity add with res3a
    y = conv3("res3b_1", x, 128, s1)
    y = bn_relu("res3b_1", y)
    y = conv3("res3b_2", y, 128, s1)
    x = b.eltwise_sum("res3b", [y, res3a])
    x = bn_relu("res3b", x)

    for stage, cout in (("res4", 256), ("res5", 512)):
        # {stage}a: stride-2 conv pair + stride-2 projection
        y = conv3(f"{stage}a_1", x, cout, s2)
        y = bn_relu(f"{stage}a_1", y)
        y = conv3(f"{stage}a_2", y, cout, s1)
        down = conv3(f"{stage}a_down", x, cout, s2)
        xa = b.eltwise_sum(f"{stage}a", [y, down])
        x = bn_relu(f"{stage}a", xa)
        # {stage}b: conv pair + identity add with {stage}a sum
        y = conv3(f"{stage}b_1", x, cout, s1)
        y = bn_relu(f"{stage}b_1", y)
        y = conv3(f"{stage}b_2", y, cout, s1)
        x = b.eltwise_sum(f"{stage}b", [y, xa])
        x = bn_relu(f"{stage}b", x)
    return x  # res5b_bn
