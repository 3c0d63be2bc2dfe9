"""C3D-ResNet-18: the dense-clip 3D network used to initialize ECO's head.

Structure transcribed from
models_ECO_Lite/kinetics/112_c3d_resnet18_kinetics_rgb_pretrained/
112_c3d_resnet_18_train_val.prototxt: a (3,7,7)/s2 stem on dense 16-frame
112x112 clips, four residual stages of 3x3x3 convs (64/128/256/512, stage
transitions stride-2 with stride-2 downsample projections), (1,7,7) global
average pool, dropout, FC.  Residual adds consume pre-BN tops exactly like
the ECO head (res2a sums conv1 with res2a_2, prototxt res2a bottoms).

Input is a dense clip (N, 16, 112, 112, 3) channels-last -- in reference
terms ``num_segments:1 new_length:16 length_first:true``.
"""

from __future__ import annotations

from eco_tpu_torch.spec.graph import GraphSpec, ParamSpec
from eco_tpu_torch.spec.netspec import NetBuilder


def build_c3d_resnet18(
    num_classes: int = 400,
    *,
    clip_len: int = 16,
    crop_size: int = 112,
    dropout_ratio: float = 0.3,
    with_loss: bool = False,
    batch: int = 1,
    fc_name: str = "fc8",
) -> GraphSpec:
    b = NetBuilder("c3d_resnet18")
    data = b.input("data", (batch, clip_len, crop_size, crop_size, 3))
    if with_loss:
        b.input("label", (batch,))

    def conv3(name, x, cout, *, k=(3, 3, 3), s=(1, 1, 1), p=(1, 1, 1), top=None):
        return b.layer(
            name, "convolution", x, tops=top,
            num_output=cout, kernel_size=k, stride=s, pad=p,
            weight_filler={"type": "xavier"},
            bias_filler={"type": "constant", "value": 0.0},
            params=(ParamSpec(1.0, 1.0), ParamSpec(2.0, 0.0)),
        )

    def bn_relu(name, x):
        y = b.bn(name + "_bn", x)
        return b.relu(name + "_relu", y)

    # stem on the dense clip (data_reshape is identity in our layout)
    x = conv3("conv1", data, 64, k=(3, 7, 7), s=(2, 2, 2), p=(1, 3, 3))
    stem = x  # pre-BN top feeds the first residual add
    b.bn("conv1_bn", x)
    x = b.relu("relu1", "conv1_bn")

    def unit(stage, cin_top, x, cout, *, downsample):
        """One residual stage half: {stage}_1 -> {stage}_2 (+down) + add."""
        s = (2, 2, 2) if downsample else (1, 1, 1)
        y = conv3(f"{stage}_1", x, cout, s=s)
        y = bn_relu(f"{stage}_1", y)
        y = conv3(f"{stage}_2", y, cout)
        if downsample:
            skip = conv3(f"{stage}_down", x, cout, s=(2, 2, 2))
        else:
            skip = cin_top
        added = b.eltwise_sum(stage, [y, skip] if stage != "res2a" else [skip, y])
        out = bn_relu(stage, added)
        return added, out

    a_top, x = unit("res2a", stem, x, 64, downsample=False)
    a_top, x = unit("res2b", a_top, x, 64, downsample=False)
    for stage, cout in (("res3", 128), ("res4", 256), ("res5", 512)):
        a_top, x = unit(f"{stage}a", None, x, cout, downsample=True)
        a_top, x = unit(f"{stage}b", a_top, x, cout, downsample=False)

    x = b.layer("global_pool", "global_avg_pool", x)  # (N, 512)
    x = b.dropout("dropout", x, dropout_ratio)
    logits = b.fc(fc_name, x, num_classes)
    if with_loss:
        b.layer("loss", "softmaxwithloss", (logits, "label"))
        b.layer("top1", "accuracy", (logits, "label"), phase="test", top_k=1)
        b.layer("top5", "accuracy", (logits, "label"), phase="test", top_k=5)
    else:
        b.layer("probs", "softmax", logits)
    return b.build()
