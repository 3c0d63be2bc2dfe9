"""Weights and statistics from the seed, made on the device in bulk.

One uniform draw fills one flat float32 buffer; each parameter is a view of
it, scaled into its range or mapped to its distribution, as its
``ParamSpec`` from the configuration's reference says (``reference/eco.py``
gives ECO's draws and why).  Both the program and the reference get these
same tensors (the program's own derived forms, folded or cast, are its
business).

``for_cell`` then scales the classifier's weights (the layer the
configuration names ``fc_name``) so that the reference's logits of two
videos drawn from the seed have a standard deviation of ``LOGIT_STD`` over
the classes (the videos drawn as the cell's traffic draws them): as a
trained classifier's, they spread over a few units, alike from seed to
seed (unscaled, their spread varies tenfold between seeds, and with it
every comparison of probabilities).
"""

from __future__ import annotations

import math

import torch

from portbench import load

LOGIT_STD = 2.0
CALIBRATION_VIDEOS = 2


def make(param_specs, stat_specs, seed: int, device) -> tuple[dict, dict]:
    """(params, state) as ``{layer: {name: tensor}}`` on ``device``, drawn
    as each ``ParamSpec`` says."""
    specs = list(param_specs) + list(stat_specs)
    counts = [math.prod(s.shape) for s in specs]
    device = torch.device(device)
    rep = torch.tensor(counts, device=device)
    lo, hi, b = (torch.repeat_interleave(torch.tensor(v, device=device), rep,
                                         output_size=sum(counts))
                 for v in zip(*((s.low, s.high, s.laplace) for s in specs)))
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
    cfg, ref = cell.config, cell.reference
    net = ref.net(cfg)
    params, state = make(*ref.param_specs(net, cfg), seed, device)
    frames = load.frame_pool(1, (CALIBRATION_VIDEOS, cfg["num_segments"], cfg["frame_height"],
                                 cfg["frame_width"], 3), load.derive(seed, 6), device,
                             cell.traffic["frames"])[0]
    n, _, h, w, _ = frames.shape
    crop = cfg["crop_size"]
    clips = ref.clips(cfg, frames.to(device), [(h - crop) // 2] * n, [(w - crop) // 2] * n,
                      [0] * n)
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            logits = ref.forward(net, params, state, clips)
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    params[cfg["fc_name"]]["w"].mul_(LOGIT_STD / float(logits.std(dim=-1).mean()))
    return params, state


def clone(tree: dict) -> dict:
    return {ln: {k: v.clone() for k, v in d.items()} for ln, d in tree.items()}
