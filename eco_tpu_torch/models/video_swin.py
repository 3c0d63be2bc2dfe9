"""Video Swin Transformer (Liu et al., "Video Swin Transformer", 2022,
arXiv:2106.13230), as ``SwinTransformer3D`` and ``I3DHead`` of
SwinTransformer/Video-Swin-Transformer (``mmaction/models/backbones/
swin_transformer.py``) define it; the defaults are Swin-B on Kinetics-400
(``configs/recognition/swin/swin_base_patch244_window877_kinetics400_1k.py``),
the network of ``torchvision.models.video.swin3d_b``.

Input is a clip (N, T, H, W, 3) channels-last: the serving plane's BGR
frames minus ImageNet's mean (K1 with ``mean`` (103.53, 116.28, 123.675)).
The published model takes RGB over ImageNet's std, so the first layer,
``input_transform``, reverses the channels and scales each by 1 / std;
``optimize_for_inference`` folds it into the patch embedding's weights
(``convert.load.fold_input_transform``): that conv has stride = kernel and
pads with zeros, which the transform maps to zeros.

The graph, at test time (dropout and drop-path the identity):

- patch embedding: a 3D conv, kernel = stride = ``patch_size``, padded at
  the end of each axis to whole patches, then a layer norm;
- four stages of ``depths`` blocks at ``embed_dim`` x 1, 2, 4, 8 channels,
  ``num_heads`` heads each; every block is ``x + proj(attn(qkv(LN1(x))))``
  then ``x + fc2(GELU(fc1(LN2(x))))``; its attention is windowed
  (``ops/attention.py``), every odd block's shifted by half a window; an
  axis whose grid is not larger than the window takes the grid as its
  window and no shift; where the grid is not a whole number of windows the
  normalised tokens are padded with zeros before qkv (``window_pad``) and
  the attention's output cropped back;
- patch merging after each stage but the last: each 2x2 spatial cell laid
  along the channels (``patch_merging``), a layer norm, then a linear 4C ->
  2C without bias;
- a final layer norm, the mean over (T, H, W), dropout, ``fc_cls``, softmax.

The linears are token-wise InnerProducts (``per_token``) on cuBLAS; the
published qkv linear runs before the shift and partition and its
projection after the reverse, which is the same product (each acts on a
token alone).  Layer norms take eps 1e-5.

Layer names follow the published ``state_dict`` without ``backbone.``:
``patch_embed.proj``, ``layers.{i}.blocks.{j}.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``layers.{i}.downsample.{norm, reduction}``,
``norm`` and ``cls_head.fc_cls``; ``<name>.weight`` and ``.bias`` are the
params ``w`` and ``b`` of a linear or conv and ``gamma`` and ``beta`` of a
layer norm, and ``layers.{i}.blocks.{j}.attn.relative_position_bias_table``
is the param of that name of the window attention layer
``layers.{i}.blocks.{j}.attn``.
"""

from __future__ import annotations

import math

from eco_tpu_torch.ops.attention import window_geometry, window_pads
from eco_tpu_torch.spec.graph import GraphSpec
from eco_tpu_torch.spec.netspec import NetBuilder

STD_RGB = (58.395, 57.12, 57.375)  # the published Normalize's, RGB
LN_EPS = 1e-5


def build_video_swin(
    num_classes: int = 400,
    *,
    num_frames: int = 32,
    crop_size: int = 224,
    batch: int = 1,
    embed_dim: int = 128,
    depths=(2, 2, 18, 2),
    num_heads=(4, 8, 16, 32),
    window_size=(8, 7, 7),
    patch_size=(2, 4, 4),
    mlp_ratio: float = 4.0,
) -> GraphSpec:
    b = NetBuilder("video_swin")
    x = b.input("data", (batch, num_frames, crop_size, crop_size, 3))
    x = b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0],
                scale=[1.0 / s for s in STD_RGB])

    def linear(name, x, cout, bias=True):
        return b.layer(name, "innerproduct", x, num_output=cout, bias_term=bias,
                       per_token=True, weight_filler={"type": "xavier"},
                       bias_filler={"type": "constant", "value": 0.0})

    def norm(name, x):
        return b.layer(name, "layer_norm", x, eps=LN_EPS)

    sizes = [num_frames, crop_size, crop_size]
    pad = [(0, (p - s % p) % p) for s, p in zip(sizes, patch_size)]
    x = b.conv("patch_embed.proj", x, embed_dim, k=list(patch_size), s=list(patch_size),
               p=pad if any(hi for _, hi in pad) else 0)
    sizes = [math.ceil(s / p) for s, p in zip(sizes, patch_size)]
    x = norm("patch_embed.norm", x)
    dim = embed_dim
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}"
            half = tuple(w // 2 for w in window_size) if j % 2 else (0, 0, 0)
            window, shift = window_geometry(sizes, window_size, half)
            pads = window_pads(sizes, window)
            y = norm(f"{pre}.norm1", x)
            if any(pads):
                y = b.layer(f"{pre}.attn.pad", "window_pad", y, pads=list(pads))
            y = linear(f"{pre}.attn.qkv", y, 3 * dim)
            y = b.layer(f"{pre}.attn", "window_attention", y, heads=heads, window=list(window),
                        shift=list(shift), table_window=list(window_size), size=list(sizes))
            y = linear(f"{pre}.attn.proj", y, dim)
            x = b.eltwise_sum(f"{pre}.residual1", [x, y])
            y = norm(f"{pre}.norm2", x)
            y = linear(f"{pre}.mlp.fc1", y, int(dim * mlp_ratio))
            y = b.layer(f"{pre}.mlp.act", "gelu", y)
            y = linear(f"{pre}.mlp.fc2", y, dim)
            x = b.eltwise_sum(f"{pre}.residual2", [x, y])
        if i < len(depths) - 1:
            x = b.layer(f"layers.{i}.downsample", "patch_merging", x)
            sizes = [sizes[0], math.ceil(sizes[1] / 2), math.ceil(sizes[2] / 2)]
            x = norm(f"layers.{i}.downsample.norm", x)
            dim *= 2
            x = linear(f"layers.{i}.downsample.reduction", x, dim, bias=False)
    x = norm("norm", x)
    x = b.layer("cls_head.avg_pool", "global_avg_pool", x)
    x = b.dropout("cls_head.dropout", x, 0.5)
    x = b.fc("cls_head.fc_cls", x, num_classes)
    b.layer("probs", "softmax", x)
    return b.build()
