"""Weights and BN statistics from the seed, made on the device in bulk.

One uniform draw fills one flat float32 buffer; each parameter is a view of
it, scaled into its range or mapped to its distribution.  Both the program and the reference get these
same tensors (the program's own derived forms, folded or cast, are its
business).

Ranges, chosen so that activations stay near unit scale through every
layer in inference as in training:
- conv and fc weights Laplace with scale b = sqrt(1 / fan_in) (variance
  2 / fan_in, which ReLU halves back), divided by 75 for the conv that
  reads the clips (uint8 pixels minus the mean have an RMS of some 10 to
  75): trained conv weights peak at zero with heavy tails, and a uniform
  draw, which has no tails, would make every per-channel int8 scale look
  better than it does on a trained net;
- biases U(-0.1, 0.1); BN scale U(0.8, 1.2), shift U(-0.2, 0.2);
- BN running mean U(-0.2, 0.2), running variance U(0.8, 1.25), so that
  folding them into the convs is not the identity.

``for_cell`` then scales the classifier's weights so that the reference's
logits of two videos drawn from the seed have a standard deviation of
``LOGIT_STD`` over the classes (the videos drawn as the cell's traffic
draws them): as a trained classifier's, they spread over
a few units, alike from seed to seed (unscaled, their spread varies tenfold
between seeds, and with it every comparison of probabilities).
"""

from __future__ import annotations

import math

import torch

from portbench import load
from portbench.reference import eco

PIXEL_RMS = 75.0
LOGIT_STD = 2.0
CALIBRATION_VIDEOS = 2
_RANGES = {"b": (-0.1, 0.1), "gamma": (0.8, 1.2), "beta": (-0.2, 0.2),
           "mean": (-0.2, 0.2), "var": (0.8, 1.25)}


def _range(spec):
    """(low, high) of a uniform draw, or (0, 0) and a Laplace scale."""
    if spec.name == "w":
        return 0.0, 0.0, math.sqrt(1.0 / spec.fan_in) / (PIXEL_RMS if spec.takes_data else 1.0)
    return _RANGES[spec.name] + (0.0,)


def make(param_specs, stat_specs, seed: int, device) -> tuple[dict, dict]:
    """(params, state) as ``{layer: {name: tensor}}`` on ``device``."""
    specs = list(param_specs) + list(stat_specs)
    counts = [math.prod(s.shape) for s in specs]
    device = torch.device(device)
    rep = torch.tensor(counts, device=device)
    lo, hi, b = (torch.repeat_interleave(torch.tensor(v, device=device), rep,
                                         output_size=sum(counts))
                 for v in zip(*(_range(s) for s in specs)))
    g = torch.Generator(device=device).manual_seed(load.derive(seed, 0))
    u = torch.rand(sum(counts), generator=g, device=device)
    v = (u - 0.5).clamp_(-0.5 + 1e-7, 0.5 - 1e-7)
    laplace = v.sign().mul_(v.abs().mul_(-2.0).log1p_()).mul_(b).neg_()
    flat = torch.where(b > 0, laplace, u.mul_(hi - lo).add_(lo))
    del lo, hi, b, u, v, laplace
    trees = ({}, {})
    for i, (s, view) in enumerate(zip(specs, torch.split(flat, counts))):
        tree = trees[0] if i < len(param_specs) else trees[1]
        tree.setdefault(s.layer, {})[s.name] = view.view(s.shape)
    return trees


def for_cell(cell, seed: int, device) -> tuple[dict, dict]:
    """The cell's weights from the seed, the classifier scaled to
    ``LOGIT_STD``."""
    cfg = cell.config
    net = cell.reference.net(cfg)
    params, state = make(*eco.param_specs(net, cfg["num_segments"], cfg["crop_size"]),
                         seed, device)
    frames = load.frame_pool(1, (CALIBRATION_VIDEOS, cfg["num_segments"], cfg["frame_height"],
                                 cfg["frame_width"], 3), load.derive(seed, 6), device,
                             cell.traffic["frames"])[0]
    n, _, h, w, _ = frames.shape
    crop = cfg["crop_size"]
    clips = eco.clips_from_frames(frames.to(device), [(h - crop) // 2] * n,
                                  [(w - crop) // 2] * n, [0] * n, crop=crop,
                                  mean=cfg["mean_bgr"])
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            logits = eco.forward(net, params, state, clips)
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    params[cfg["fc_name"]]["w"].mul_(LOGIT_STD / float(logits.std(dim=-1).mean()))
    return params, state


def clone(tree: dict) -> dict:
    return {ln: {k: v.clone() for k, v in d.items()} for ln, d in tree.items()}
