"""Parameter fillers with Caffe semantics (twin of ``eco_tpu/runtime/init.py``).

- ``constant``: fill with ``value``.
- ``uniform``: U(min, max).
- ``gaussian``: N(mean, std).
- ``xavier``: U(-sqrt(3/n), +sqrt(3/n)), n = fan_in by default
  (``variance_norm`` AVERAGE / FAN_OUT supported).
- ``msra``: N(0, sqrt(2/n)).

Draws come from an explicit ``torch.Generator``.  The two frameworks give
different numbers from one seed; parity tests carry weights across with
``eco_tpu_torch.convert.bridge.params_from_jax`` instead.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch


def _fans(shape, transposed: bool = False):
    """fan_in / fan_out of a param in this package's layout: conv
    (C_out, C_in/g, *k), fc (D_out, D_in), and with ``transposed`` a deconv
    weight (C_in, C_out/g, *k).  Equal to the reference's ``_fans`` of the
    same param in its layout ((*k, C_in/g, C_out), (D_in, D_out),
    (*k, C_in, C_out/g)), which reads the last two axes as (in, out)."""
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[2:])
    if transposed:
        return shape[0] * receptive, shape[1] * receptive
    return shape[1] * receptive, shape[0] * receptive


def fill(generator: torch.Generator, shape, dtype, filler: Mapping | None, *,
         transposed: bool = False) -> torch.Tensor:
    """A new tensor on ``generator.device`` filled as ``filler`` says;
    ``transposed`` marks a deconv weight for the fans of xavier and msra."""
    filler = dict(filler or {"type": "constant", "value": 0.0})
    ftype = filler.get("type", "constant")
    t = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    if ftype == "constant":
        return t.fill_(float(filler.get("value", 0.0)))
    if ftype == "uniform":
        lo = float(filler.get("min", 0.0))
        hi = float(filler.get("max", 1.0))
        return t.uniform_(lo, hi, generator=generator)
    if ftype == "gaussian":
        mean = float(filler.get("mean", 0.0))
        std = float(filler.get("std", 1.0))
        return t.normal_(mean, std, generator=generator)
    fan_in, fan_out = _fans(tuple(shape), transposed)
    norm = filler.get("variance_norm", "FAN_IN")
    if norm == "AVERAGE":
        n = (fan_in + fan_out) / 2.0
    elif norm == "FAN_OUT":
        n = fan_out
    else:
        n = fan_in
    if ftype == "xavier":
        scale = (3.0 / n) ** 0.5
        return t.uniform_(-scale, scale, generator=generator)
    if ftype == "msra":
        return t.normal_(0.0, (2.0 / n) ** 0.5, generator=generator)
    raise ValueError(f"unknown filler type {ftype!r}")
