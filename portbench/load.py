"""The benchmark's load generator: every traffic file is read here.

A traffic file (``portbench/traffic/<name>.json``) names its ``kind``:

- ``closed``: one client sends a request of ``videos`` videos, waits for its
  probabilities on the host, and sends the next.

and how its frames look (``frames``).  Frames are uint8 (videos, segments,
height, width, 3) BGR, as a decoder hands them over, drawn on the device
from the seed and kept in pinned host memory: ``pool`` blocks of them,
which requests take in turn.  Offsets and mirrors are drawn per request
from the seed.

``frames`` ``smooth``: each frame is a smooth random field, as a photograph
is smooth between its edges: at each of ``scales`` (``[rows, columns,
amplitude]``) a coarse grid of normal draws is upsampled bicubically to the
frame and added.  A video's segments share one field and each adds its own
(``drift`` of the shared one's size), the three channels share a luminance
field and each adds its own (``chroma``), and each video gets its own
brightness and contrast drawn from the given ranges, plus per-pixel normal
noise (``noise``, in grey levels); the result is clamped to 0..255, so some
areas saturate.  Uniform noise, by contrast, makes every video alike to a
net, and every number type rounds it alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

# more requests than a closed loop's window can send
CLOSED_REQUESTS = 20000


def derive(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + purpose * 7919) % (2**63 - 1)


def _uniform(n, lo_hi, g, device):
    lo, hi = lo_hi
    return torch.rand(n, generator=g, device=device) * (hi - lo) + lo


def smooth_frames(shape, spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """uint8 frames of ``shape`` (videos, segments, height, width, 3) on
    ``device``, drawn from ``g`` as ``spec`` (a traffic file's ``frames``)
    says."""
    n, s, h, w, c = shape
    field = torch.zeros((n, s, c, h, w), device=device)
    for rows, cols, amp in spec["scales"]:
        coarse = torch.randn((n, 1 + s, 1 + c, rows, cols), generator=g, device=device)
        per_seg = coarse[:, :1] + spec["drift"] * coarse[:, 1:]          # (n, s, 1+c, ...)
        chans = per_seg[:, :, :1] + spec["chroma"] * per_seg[:, :, 1:]   # (n, s, c, ...)
        up = F.interpolate(chans.reshape(n * s, c, rows, cols), size=(h, w), mode="bicubic",
                           align_corners=False)
        field += amp * up.reshape(n, s, c, h, w)
        del coarse, per_seg, chans, up
    flat = field.view(n, -1)
    flat -= flat.mean(dim=1, keepdim=True)
    flat /= flat.std(dim=1, keepdim=True)
    bright = _uniform(n, spec["brightness"], g, device).view(n, 1)
    contrast = _uniform(n, spec["contrast"], g, device).view(n, 1)
    flat.mul_(contrast).add_(bright)
    flat.add_(torch.randn(flat.shape, generator=g, device=device), alpha=spec["noise"])
    out = flat.round_().clamp_(0, 255).to(torch.uint8).view(n, s, c, h, w)
    return out.permute(0, 1, 3, 4, 2).contiguous()


def frame_pool(count: int, shape, seed: int, device, spec: dict) -> list[torch.Tensor]:
    """``count`` uint8 frame blocks of ``shape``, drawn on ``device`` as
    ``spec`` says and kept in (pinned, for a card) host memory."""
    if spec["kind"] != "smooth":
        raise ValueError(f"unknown frames {spec['kind']!r}")
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(derive(seed, 1))
    out = []
    for _ in range(count):
        block = smooth_frames(tuple(shape), spec, g, device)
        host = torch.empty(tuple(shape), dtype=torch.uint8, pin_memory=device.type == "cuda")
        host.copy_(block)
        out.append(host)
        del block
    return out


@dataclass
class Request:
    index: int
    videos: int
    pool: int             # frame block it takes its first ``videos`` videos from
    h_off: np.ndarray
    w_off: np.ndarray
    mirror: np.ndarray


def requests(traffic: dict, seed: int, *, frame_hw, crop) -> list[Request]:
    """The requests of a closed mix: more than its window can send."""
    if traffic["kind"] != "closed":
        raise ValueError(f"traffic kind {traffic['kind']!r} has no requests")
    rng = np.random.default_rng(derive(seed, 2))
    pool, n = int(traffic["pool"]), int(traffic["videos"])
    h, w = frame_hw
    out = []
    for i in range(CLOSED_REQUESTS):
        out.append(Request(i, n, i % pool, rng.integers(0, h - crop + 1, n),
                           rng.integers(0, w - crop + 1, n), rng.integers(0, 2, n)))
    return out
