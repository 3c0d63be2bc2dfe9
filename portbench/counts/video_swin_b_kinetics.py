"""Counts of Video Swin-B, Kinetics-400: every multiply-add of the patch
embedding, the linears (qkv, proj, fc1, fc2, the merges' reductions,
fc_cls) and the windowed q k^T and weights times v, from the reference's
token grids; 281.33 G a 32 x 224 x 224 clip.

``attention_flops`` and ``attention_bytes`` are the attention core's
operations and least bytes over a whole forward pass, as the program counts
them in ``COUNTS["attn.flops"]`` and ``COUNTS["attn.bytes"]`` (q, k and v
read once, the output written once, at ``value_bytes`` a value, and each
block's gathered bias and mask read once, per call, at ``value_bytes``)."""

from __future__ import annotations

import math

from portbench.counts.shapes import k1_bytes  # noqa: F401
from portbench.reference.video_swin_b_kinetics import get_window_size, grids, net  # noqa: F401


def _blocks(net, cfg):
    """(tokens, windows, window tokens, C, heads, shifted) of each block of
    one clip, tokens and windows over the padded grid."""
    out = []
    c = net.embed_dim
    for i, (grid, depth, heads) in enumerate(zip(grids(net, cfg["num_segments"],
                                                       cfg["crop_size"]),
                                                 net.depths, net.num_heads)):
        half = tuple(w // 2 for w in net.window_size)
        for j in range(depth):
            window, shift = get_window_size(grid, net.window_size,
                                            half if j % 2 else (0, 0, 0))
            padded = [math.ceil(g / w) * w for g, w in zip(grid, window)]
            out.append((math.prod(grid), math.prod(padded) // math.prod(window),
                        math.prod(window), c, heads, any(shift), math.prod(padded)))
        c *= 2
    return out


def forward_flops(net, cfg: dict) -> float:
    gs = grids(net, cfg["num_segments"], cfg["crop_size"])
    macs = math.prod(gs[0]) * net.embed_dim * 3 * math.prod(net.patch_size)
    hidden = net.mlp_ratio
    for tokens, windows, length, c, heads, _, padded in _blocks(net, cfg):
        macs += padded * 3 * c * c + tokens * c * c + 2 * tokens * int(hidden * c) * c
        macs += 2 * windows * length * length * c
    c = net.embed_dim
    for grid in gs[1:]:
        macs += math.prod(grid) * 4 * c * 2 * c
        c *= 2
    macs += c * net.num_classes
    return 2.0 * macs


def attention_flops(net, cfg: dict, clips: int) -> float:
    return float(sum(4 * clips * windows * length * length * c
                     for _, windows, length, c, _, _, _ in _blocks(net, cfg)))


def attention_bytes(net, cfg: dict, clips: int, value_bytes: int = 2) -> float:
    total = 0
    for _, windows, length, c, heads, shifted, _ in _blocks(net, cfg):
        total += 4 * clips * windows * length * c * value_bytes
        total += (windows if shifted else 1) * heads * length * length * value_bytes
    return float(total)
