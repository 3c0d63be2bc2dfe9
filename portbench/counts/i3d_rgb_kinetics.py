"""Counts of I3D-RGB, Kinetics-400: every conv's multiply-adds from the
reference's shapes (TF "SAME": ceil(size / stride) outputs an axis), the
logits conv included; 111.15 G a 64 x 224 x 224 clip."""

from __future__ import annotations

import math

from portbench.counts.shapes import k1_bytes  # noqa: F401
from portbench.reference.i3d_rgb_kinetics import net, shapes  # noqa: F401


def forward_flops(net, cfg: dict) -> float:
    shp = shapes(net, 1, cfg["num_segments"], cfg["crop_size"])
    return 2.0 * sum(math.prod(shp[l.top]) * shp[l.bottoms[0]][1] * math.prod(l.attrs["k"])
                     for l in net if l.op == "conv")
