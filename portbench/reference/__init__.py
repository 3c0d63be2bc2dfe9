"""Plain PyTorch references of the benchmark's configurations.

``reference/<config>.py`` is all the harness knows of a configuration's
model.  It imports nothing of the program and provides:

- ``net(cfg)``: the model, in whatever form its own functions take;
- ``param_specs(net, cfg)``: (parameters, BN or other running statistics),
  each a list of ``ParamSpec`` in the order the weights are drawn;
- ``clips(cfg, frames_u8, h_off, w_off, mirror)``: uint8 (N, frames, H, W, 3)
  BGR frames, per-video crop offsets and mirror flags -> float32 clips, in
  the configuration's own crop, mirror, normalisation, channel order and
  layout, as its ``forward`` takes them;
- ``forward(net, params, state, clips)``: float32 logits (N, classes), from
  weights ``{layer: {name: tensor}}`` as ``weights.make`` draws them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ParamSpec:
    """One parameter or statistic, ``{layer: {name: tensor}}`` of ``shape``,
    with its draw: Laplace of scale ``laplace`` where that is above 0, else
    uniform on [``low``, ``high``)."""

    layer: str
    name: str
    shape: tuple
    low: float = 0.0
    high: float = 0.0
    laplace: float = 0.0
