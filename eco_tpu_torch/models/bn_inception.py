"""BN-Inception builders: the ECO 2D trunk and the ECO-Full 2D branch.

Architecture facts (channel widths, strides, pool types) transcribed from the
reference model definitions:
- trunk conv1..inception_3c_double_3x3_1: ECO_Lite.prototxt:182-1330
- full branch inception_3c..5b + 7x7 pool: ECO_full.prototxt:1426-4800

Layer names follow the reference exactly so that name-based weight transfer
(Net::CopyTrainedLayersFrom, net.cpp:852-876) works against converted
caffemodels.
"""

from __future__ import annotations

from eco_tpu_torch.spec.netspec import NetBuilder

# Inception block config: (1x1, 3x3_reduce, 3x3, dbl_reduce, dbl_1, dbl_2,
#                          pool_proj, pool_type).  Reduction blocks (stride 2)
# have no 1x1/pool_proj branch and use MAX pool.
INCEPTION_CFG = {
    "3a": (64, 64, 64, 64, 96, 96, 32, "ave"),
    "3b": (64, 64, 96, 64, 96, 96, 64, "ave"),
    "3c": (None, 128, 160, 64, 96, 96, None, "max"),  # stride-2 reduction
    "4a": (224, 64, 96, 96, 128, 128, 128, "ave"),
    "4b": (192, 96, 128, 96, 128, 128, 128, "ave"),
    "4c": (160, 128, 160, 128, 160, 160, 128, "ave"),
    "4d": (96, 128, 192, 160, 192, 192, 128, "ave"),
    "4e": (None, 128, 192, 192, 256, 256, None, "max"),  # stride-2 reduction
    "5a": (352, 192, 320, 160, 224, 224, 128, "ave"),
    "5b": (352, 192, 320, 192, 224, 224, 128, "max"),  # max pool, stride 1
}


def add_stem(b: NetBuilder, data: str) -> str:
    """conv1 7x7/2 -> pool 3x3/2 -> conv2 reduce/3x3 -> pool 3x3/2 (224->28)."""
    x = b.conv_bn_relu("conv1_7x7_s2", data, 64, k=7, s=2, p=3)
    x = b.max_pool("pool1_3x3_s2", x, k=3, s=2)
    x = b.conv_bn_relu("conv2_3x3_reduce", x, 64, k=1)
    x = b.conv_bn_relu("conv2_3x3", x, 192, k=3, p=1)
    return b.max_pool("pool2_3x3_s2", x, k=3, s=2)


def add_inception(b: NetBuilder, block: str, bottom: str) -> str:
    """One Inception block with the reference naming scheme."""
    n1, nr3, n3, ndr, nd1, nd2, npp, pool = INCEPTION_CFG[block]
    pre = f"inception_{block}"
    reduction = n1 is None
    stride = 2 if reduction else 1
    branches = []
    if not reduction:
        branches.append(b.conv_bn_relu(f"{pre}_1x1", bottom, n1, k=1))
    r = b.conv_bn_relu(f"{pre}_3x3_reduce", bottom, nr3, k=1)
    branches.append(b.conv_bn_relu(f"{pre}_3x3", r, n3, k=3, s=stride, p=1))
    r = b.conv_bn_relu(f"{pre}_double_3x3_reduce", bottom, ndr, k=1)
    d = b.conv_bn_relu(f"{pre}_double_3x3_1", r, nd1, k=3, p=1)
    branches.append(b.conv_bn_relu(f"{pre}_double_3x3_2", d, nd2, k=3, s=stride, p=1))
    if reduction:
        branches.append(b.max_pool(f"{pre}_pool", bottom, k=3, s=2))
    else:
        if pool == "max":
            p = b.max_pool(f"{pre}_pool", bottom, k=3, s=1, p=1)
        else:
            p = b.avg_pool(f"{pre}_pool", bottom, k=3, s=1, p=1)
        branches.append(b.conv_bn_relu(f"{pre}_pool_proj", p, npp, k=1))
    return b.concat(f"{pre}_output", branches)


def add_trunk(b: NetBuilder, data: str) -> str:
    """The shared ECO trunk: stem + 3a + 3b + the first double-3x3 conv of 3c.

    Output: ``inception_3c_double_3x3_1_bn`` -- (N*S, 28, 28, 96) here
    (channels-last), the tensor the reference reshapes into the 3D head
    (ECO_Lite.prototxt:1310-1326).
    """
    x = add_stem(b, data)
    x = add_inception(b, "3a", x)
    x = add_inception(b, "3b", x)
    r = b.conv_bn_relu("inception_3c_double_3x3_reduce", x, 64, k=1)
    return b.conv_bn_relu("inception_3c_double_3x3_1", r, 96, k=3, p=1)


def add_full_2d_branch(b: NetBuilder, inception_3b_output: str) -> str:
    """ECO-Full's continued 2D path: full 3c (stride-2) + 4a..5b + 7x7 pool.

    Input is the 3b concat output; the double_3x3_reduce/_1 convs of 3c are
    SHARED with the trunk in the reference graph (ECO_full.prototxt:1299-1425:
    inception_3c_double_3x3_2 consumes inception_3c_double_3x3_1_bn), so this
    builder re-uses those tops rather than re-declaring the layers.

    Returns ``global_pool2D`` -- (N*S, 1, 1, 1024) physical.
    """
    pre = "inception_3c"
    r = b.conv_bn_relu(f"{pre}_3x3_reduce", inception_3b_output, 128, k=1)
    br_3x3 = b.conv_bn_relu(f"{pre}_3x3", r, 160, k=3, s=2, p=1)
    # shared with trunk: inception_3c_double_3x3_1_bn already exists
    br_dbl = b.conv_bn_relu(
        f"{pre}_double_3x3_2", "inception_3c_double_3x3_1_bn", 96, k=3, s=2, p=1
    )
    br_pool = b.max_pool(f"{pre}_pool", inception_3b_output, k=3, s=2)
    x = b.concat(f"{pre}_output", [br_3x3, br_dbl, br_pool])
    for block in ("4a", "4b", "4c", "4d", "4e", "5a", "5b"):
        x = add_inception(b, block, x)
    return b.avg_pool("global_pool2D", x, k=7, s=1)
