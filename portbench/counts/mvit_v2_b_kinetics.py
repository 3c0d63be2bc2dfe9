"""Counts of MViTv2-B, Kinetics-400: every multiply-add of the patch
embedding, the linears (qkv, proj, the width-changing blocks' proj, fc1,
fc2, head.projection), the depthwise pooling convs of q, k and v, the three
relative-position products and the pooled q k^T and weights times v, from
the reference's blocks and the pooled grids; 224.47 G a 32 x 224 x 224 clip.

``pattn_flops`` and ``pattn_bytes`` are the pooled attention core's
operations and least bytes over a whole forward pass, as the program counts
them in ``COUNTS["pattn.flops"]`` and ``COUNTS["pattn.bytes"]``: twice the
multiply-adds of q k^T, the weights times v and the position products; q,
k and v read once, the output written once and the three position tables
read once, at ``value_bytes`` a value (no materialised bias)."""

from __future__ import annotations

import math

from portbench.counts.shapes import k1_bytes  # noqa: F401
from portbench.reference.mvit_v2_b_kinetics import blocks, net  # noqa: F401


def _pooled(size, kernel, stride, pad):
    return tuple((s + 2 * p - k) // st + 1 for s, k, st, p in zip(size, kernel, stride, pad))


def _layers(net, cfg):
    """(block, tokens in, q grid, k grid, table rows) of each block of one
    clip, tokens with the class token."""
    size = _pooled((cfg["num_segments"], cfg["crop_size"], cfg["crop_size"]), net.patch_kernel,
                   net.patch_stride, net.patch_padding)
    pad = [k // 2 for k in net.pool_kernel]
    out = []
    for blk in blocks(net, cfg["num_segments"], cfg["crop_size"]):
        q = _pooled(size, net.pool_kernel, blk.stride_q, pad)
        k = _pooled(size, net.pool_kernel, blk.stride_kv, pad)
        rows = sum(2 * max(a, b) - 1 for a, b in zip(q, k))
        out.append((blk, 1 + math.prod(size), q, k, rows))
        size = q
    return out, size


def forward_flops(net, cfg: dict) -> float:
    layers, _ = _layers(net, cfg)
    grid = layers[0][1] - 1
    macs = grid * net.embed_dim * 3 * math.prod(net.patch_kernel)
    taps = math.prod(net.pool_kernel)
    for blk, tokens, q, k, _ in layers:
        lq = 1 + math.prod(q)
        macs += tokens * blk.dim * 3 * blk.dim_out                      # qkv
        if blk.dim != blk.dim_out:
            macs += tokens * blk.dim * blk.dim_out                      # the skip's proj
        macs += blk.dim_out * taps * (math.prod(q) + 2 * math.prod(k))  # q, k, v pooling
        macs += lq * blk.dim_out * blk.dim_out                          # attn.proj
        macs += 2 * lq * blk.dim_out * int(blk.dim_out * net.mlp_ratio)  # fc1, fc2
    macs += layers[-1][0].dim_out * net.num_classes
    return 2.0 * macs + pattn_flops(net, cfg, 1)


def pattn_flops(net, cfg: dict, clips: int) -> float:
    layers, _ = _layers(net, cfg)
    total = 0
    for blk, _, q, k, _ in layers:
        lq, lk = 1 + math.prod(q), 1 + math.prod(k)
        total += blk.dim_out * (2 * lq * lk + math.prod(q) * sum(k))
    return 2.0 * clips * total


def pattn_bytes(net, cfg: dict, clips: int, value_bytes: int = 2) -> float:
    layers, _ = _layers(net, cfg)
    total = 0
    for blk, _, q, k, rows in layers:
        lq, lk = 1 + math.prod(q), 1 + math.prod(k)
        total += clips * blk.dim_out * (2 * lq + 2 * lk) + rows * blk.dim_out // blk.heads
    return float(total * value_bytes)
