"""ECO-Lite / ECO-Full model assemblies (TPU-native).

ECO-Lite (ECO_Lite.prototxt): shared 2D BN-Inception trunk over all segments
(segments ride the batch axis) -> segment unfold into NDHWC -> 3D-ResNet-18
temporal fusion -> global 3D mean -> dropout -> FC.

ECO-Full (ECO_full.prototxt): same, plus the full 2D Inception branch
(3c..5b) with average segment consensus; the 1024-d 2D feature and the 512-d
3D feature are concatenated before the classifier (prototxt:4776-4881).

Where the reference performs the r2Dto3D NCHW Reshape+Permute dance
(ECO_Lite.prototxt:1310-1326), the TPU graph uses a single free reshape
(eco_tpu.ops.layout.unfold_segments).  Inputs are (N, S, H, W, 3)
channels-last; labels are (N,) int.
"""

from __future__ import annotations

from eco_tpu_torch.models.bn_inception import add_full_2d_branch, add_trunk
from eco_tpu_torch.models.resnet3d import add_3d_head
from eco_tpu_torch.spec.graph import GraphSpec
from eco_tpu_torch.spec.netspec import NetBuilder


def _add_head_and_loss(b, feat, *, num_classes, fc_name, with_loss):
    logits = b.fc(fc_name, feat, num_classes)
    if with_loss:
        b.layer("loss", "softmaxwithloss", (logits, "label"))
        b.layer("top1", "accuracy", (logits, "label"), phase="test", top_k=1)
        b.layer("top5", "accuracy", (logits, "label"), phase="test", top_k=5)
    else:
        b.layer("probs", "softmax", logits)
    return logits


def build_eco_lite(
    num_classes: int = 400,
    num_segments: int = 16,
    *,
    crop_size: int = 224,
    fc_name: str = "fc8",
    dropout_ratio: float = 0.3,
    with_loss: bool = False,
    batch: int = 1,
    in_channels: int = 3,
) -> GraphSpec:
    """``in_channels``: 3 for RGB, 2*new_length for stacked optical flow
    (the TSN-style flow modality the reference's data layer supports)."""
    b = NetBuilder("eco_lite")
    data = b.input(
        "data", (batch, num_segments, crop_size, crop_size, in_channels)
    )
    if with_loss:
        b.input("label", (batch,))
    x = b.layer("reshape_data", "fold_segments", data)  # (N*S, H, W, 3)
    x = add_trunk(b, x)  # (N*S, 28, 28, 96)
    x = b.layer("r2Dto3D", "unfold_segments", x, tops="res2b_bn",
                num_segments=num_segments)
    x = add_3d_head(b, x)  # (N, S/4, 7, 7, 512)
    x = b.layer("global_pool", "global_avg_pool", x)  # (N, 512)
    x = b.dropout("dropout", x, dropout_ratio)
    _add_head_and_loss(b, x, num_classes=num_classes, fc_name=fc_name,
                       with_loss=with_loss)
    return b.build()


def build_eco_full(
    num_classes: int = 400,
    num_segments: int = 16,
    *,
    crop_size: int = 224,
    fc_name: str = "fc8N",
    dropout_ratio: float = 0.5,
    with_loss: bool = False,
    batch: int = 1,
    in_channels: int = 3,
) -> GraphSpec:
    b = NetBuilder("eco_full")
    data = b.input(
        "data", (batch, num_segments, crop_size, crop_size, in_channels)
    )
    if with_loss:
        b.input("label", (batch,))
    x = b.layer("reshape_data", "fold_segments", data)
    trunk_out = add_trunk(b, x)  # inception_3c_double_3x3_1_bn

    # 3D branch
    x3 = b.layer("r2Dto3D", "unfold_segments", trunk_out, tops="res2b_bn",
                 num_segments=num_segments)
    x3 = add_3d_head(b, x3)
    x3 = b.layer("global_pool", "global_avg_pool", x3)  # (N, 512)
    x3 = b.dropout("dropout", x3, dropout_ratio)

    # 2D branch: continues from inception_3b_output, re-using the shared
    # 3c double-3x3-1 tower (ECO_full.prototxt:1299-1425).
    x2 = add_full_2d_branch(b, "inception_3b_output")  # (N*S, 1, 1, 1024)
    x2 = b.dropout("dropout2D", x2, dropout_ratio)
    x2 = b.layer("segment_consensus_st2", "segment_consensus", x2,
                 tops="pool_fusion_st2D", num_segments=num_segments)  # (N,1024)

    feat = b.concat("gn02_concat", [x2, x3])  # [1024 | 512], 2D first
    _add_head_and_loss(b, feat, num_classes=num_classes, fc_name=fc_name,
                       with_loss=with_loss)
    return b.build()
