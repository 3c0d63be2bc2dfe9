"""MViTv2 (Li et al., "MViTv2: Improved Multiscale Vision Transformers for
Classification and Detection", CVPR 2022, arXiv:2112.01526), as ``MViT`` of
facebookresearch/SlowFast (``slowfast/models/video_model_builder.py``,
``slowfast/models/attention.py``) defines it; the defaults are MViTv2-B on
Kinetics-400 at 32 frames (``configs/Kinetics/MVITv2_B_32x3.yaml``).

Input is a clip (N, T, H, W, 3) channels-last: the serving plane's BGR
frames minus the mean (K1 with ``mean`` 114.75 a channel, the published
0.45 x 255).  The published model takes RGB over the std 57.375 (0.225 x
255), so the first layer, ``input_transform``, reverses the channels and
scales them by 1 / 57.375; ``optimize_for_inference`` folds it into the
patch embedding's weights (``convert.load.fold_input_transform``): the
transform maps zero to zero, so the conv's zero padding is the same in
both domains.

The graph, at test time (dropout and drop-path the identity):

- patch embedding: a 3D conv, kernel ``patch_kernel``, stride
  ``patch_stride``, padding ``patch_padding``, with bias; the grid's
  tokens as rows in (t, h, w) order with a learned class token in front
  (``cls_token``); no absolute position embedding;
- ``depth`` blocks; the blocks of ``dim_mul_blocks`` double the width and
  the heads (the head width stays ``embed_dim / num_heads``) and pool q
  with stride (1, 2, 2); the kv stride starts at ``kv_stride`` and is
  divided by each q stride on the way, at least 1.  A block is
  ``s + proj(attn(qkv(LN1(x))))``, then ``x + fc2(GELU(fc1(LN2(x))))``:
  ``attn`` is the pooling attention (``pooled_attention``: q, k and v each
  pooled by a depthwise ``pool_kernel`` conv and normed, the decomposed
  relative positions, the residual pooling add); the skip ``s`` is ``x``,
  or ``proj(LN1(x))`` where the width changes, max-pooled over the grid
  (kernel 1 + stride, ``token_pool``) where q is strided;
- a final layer norm, the class token's row (``cls_select``),
  ``head.projection``, softmax.

The linears are token-wise InnerProducts (``per_token``) over the rows.
Layer norms take eps 1e-6.

Layer names follow the published ``state_dict``: ``patch_embed.proj``,
``cls_token``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm`` and ``head.projection``; ``<name>.weight``
and ``.bias`` are the params ``w`` and ``b`` of a linear or conv and
``gamma`` and ``beta`` of a layer norm; the class token is the param
``token`` of the layer ``cls_token``; ``blocks.{i}.attn.{pool_q, norm_q,
pool_k, norm_k, pool_v, norm_v}`` and ``blocks.{i}.attn.rel_pos_{h, w, t}``
are the params ``pool_q.w``, ``norm_q.gamma``, ``norm_q.beta``, ...,
``rel_pos_h``, ``rel_pos_w``, ``rel_pos_t`` of the pooling attention layer
``blocks.{i}.attn``.
"""

from __future__ import annotations

import math

from eco_tpu_torch.ops.pooled_attention import pooled_size
from eco_tpu_torch.spec.graph import GraphSpec
from eco_tpu_torch.spec.netspec import NetBuilder

STD = 57.375  # the published DATA.STD (0.225) in grey levels, every channel
LN_EPS = 1e-6


def build_mvit_v2(
    num_classes: int = 400,
    *,
    num_frames: int = 32,
    crop_size: int = 224,
    batch: int = 1,
    embed_dim: int = 96,
    depth: int = 24,
    num_heads: int = 1,
    dim_mul_blocks=(2, 5, 21),
    patch_kernel=(3, 7, 7),
    patch_stride=(2, 4, 4),
    patch_padding=(1, 3, 3),
    pool_kernel=(3, 3, 3),
    kv_stride=(1, 8, 8),
    mlp_ratio: float = 4.0,
) -> GraphSpec:
    b = NetBuilder("mvit_v2")
    x = b.input("data", (batch, num_frames, crop_size, crop_size, 3))
    x = b.layer("input_transform", "input_transform", x, channel_order=[2, 1, 0],
                scale=1.0 / STD)

    def linear(name, x, cout):
        return b.layer(name, "innerproduct", x, num_output=cout, per_token=True,
                       weight_filler={"type": "xavier"},
                       bias_filler={"type": "constant", "value": 0.0})

    def norm(name, x):
        return b.layer(name, "layer_norm", x, eps=LN_EPS)

    x = b.conv("patch_embed.proj", x, embed_dim, k=list(patch_kernel), s=list(patch_stride),
               p=list(patch_padding))
    size = pooled_size((num_frames, crop_size, crop_size), patch_kernel, patch_stride,
                       patch_padding)
    x = b.layer("cls_token", "cls_token", x)
    dim, heads, kv = embed_dim, num_heads, list(kv_stride)
    for i in range(depth):
        pre = f"blocks.{i}"
        stride_q = [1, 2, 2] if i in dim_mul_blocks else [1, 1, 1]
        kv = [max(s // q, 1) for s, q in zip(kv, stride_q)]
        dim_out = dim
        if i in dim_mul_blocks:
            heads, dim_out = 2 * heads, 2 * dim
        xn = norm(f"{pre}.norm1", x)
        y = linear(f"{pre}.attn.qkv", xn, 3 * dim_out)
        y = b.layer(f"{pre}.attn", "pooled_attention", y, heads=heads, size=list(size),
                    stride_q=stride_q, stride_kv=list(kv), kernel=list(pool_kernel), eps=LN_EPS)
        y = linear(f"{pre}.attn.proj", y, dim_out)
        skip = linear(f"{pre}.proj", xn, dim_out) if dim_out != dim else x
        if math.prod(stride_q) > 1:
            kernel = [s + 1 if s > 1 else s for s in stride_q]
            skip = b.layer(f"{pre}.pool_skip", "token_pool", skip, size=list(size),
                           kernel_size=kernel, stride=stride_q, pad=[k // 2 for k in kernel])
        x = b.eltwise_sum(f"{pre}.residual1", [skip, y])
        y = norm(f"{pre}.norm2", x)
        y = linear(f"{pre}.mlp.fc1", y, int(dim_out * mlp_ratio))
        y = b.layer(f"{pre}.mlp.act", "gelu", y)
        y = linear(f"{pre}.mlp.fc2", y, dim_out)
        x = b.eltwise_sum(f"{pre}.residual2", [x, y])
        size = pooled_size(size, pool_kernel, stride_q, [k // 2 for k in pool_kernel])
        dim = dim_out
    x = norm("norm", x)
    x = b.layer("cls_select", "cls_select", x)
    x = b.fc("head.projection", x, num_classes)
    b.layer("probs", "softmax", x)
    return b.build()
