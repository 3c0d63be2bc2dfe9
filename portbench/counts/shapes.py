"""Operations and bytes from shapes alone, never from what the program runs.

``forward_flops``: twice the multiply-adds of every conv and fc of one
video's forward pass, the layers walked as ``reference/eco.py`` defines
them (ECO's nets; another configuration's counts module brings its own).  A
training step's operations are three times those (forward, the gradient
of the data, the gradient of the weights).

``k1_bytes``: the preprocessing kernel's least traffic for one call: the
crop windows of the uint8 frames read once, the clips written once.
"""

from __future__ import annotations

import math

from portbench.reference.eco import shapes


def forward_flops(net, cfg: dict) -> float:
    shp = shapes(net, 1, cfg["num_segments"], cfg["crop_size"])
    total = 0
    for l in net:
        if l.op == "conv":
            cin = shp[l.bottoms[0]][1]
            total += math.prod(shp[l.top]) * cin * l.attrs["k"] ** l.attrs["dim"]
        elif l.op == "fc":
            total += math.prod(shp[l.bottoms[0]]) * l.attrs["cout"]
    return 2.0 * total


def k1_bytes(videos: int, cfg: dict, out_bytes: int) -> float:
    pixels = videos * cfg["num_segments"] * cfg["crop_size"] ** 2 * 3
    return float(pixels * (1 + out_bytes))
