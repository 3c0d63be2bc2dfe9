"""Plain PyTorch Video Swin Transformer (Swin-B, Kinetics-400) in float32:
the reference the port's Video Swin (``eco_tpu_torch/models/video_swin.py``)
is held to.

Written from the paper (Liu et al., "Video Swin Transformer", 2022,
arXiv:2106.13230) and the published code (SwinTransformer/Video-Swin-
Transformer, ``mmaction/models/backbones/swin_transformer.py``:
``SwinTransformer3D``, ``BasicLayer``, ``SwinTransformerBlock3D``,
``WindowAttention3D``, ``PatchMerging``, ``PatchEmbed3D``, and
``mmaction/models/heads/i3d_head.py``), as it runs at test time: dropout
and drop-path the identity.  It imports nothing of the port.  Its functions
are the published ones (``window_partition``, ``window_reverse``,
``get_window_size``, ``compute_mask``) on (B, D, H, W, C) tokens; the
relative-position bias is gathered from its table and the shift mask made
in full, every attention takes its softmax explicitly, and the caller turns
TF32 off.

Where it departs from the published code:

- the qkv linear, the bias table and the mask are the published ones, but
  the weights are random draws from ``param_specs`` (below), not a
  checkpoint;
- ``compute_mask`` is made per call, not cached;
- the head scores one clip: the published test protocol averages the
  softmax of 4 clips x 3 crops (``average_clips='prob'``), which a caller
  does over the rows.

The clips are the published input: uint8 BGR frames through their crop,
horizontal mirror, BGR -> RGB and ImageNet's Normalize ((x - mean) / std,
RGB mean (123.675, 116.28, 103.53), std (58.395, 57.12, 57.375), from the
configuration's ``mean_bgr`` and ``std_rgb``), as (N, 3, T, H, W).

A net is a ``Net`` of the published widths (``cfg`` may give others:
``embed_dim``, ``depths``, ``num_heads``, ``window_size``, ``patch_size``,
``mlp_ratio``).  Weights are ``{layer: {name: tensor}}``, named as the
port's graph names them: the published ``state_dict`` names without
``backbone.``, ``w`` / ``b`` for ``weight`` / ``bias`` of a conv or linear,
``gamma`` / ``beta`` of a layer norm, the bias table
``layers.{i}.blocks.{j}.attn`` / ``relative_position_bias_table`` and the
qkv linear ``layers.{i}.blocks.{j}.attn.qkv``.  There are no running
statistics.

The weights' draws (``param_specs``): conv and linear weights Laplace of
scale sqrt(1 / fan_in) (variance 2 / fan_in), the qkv linear's of scale
``QKV_GAIN`` times that, so that q k^T / sqrt(d) spreads by some 1-3 over
a query's keys at every stage (nearly uniform weights or nearly one-hot
ones would leave the attention untested); biases U(-0.1, 0.1); layer norm
scale U(0.8, 1.2), shift U(-0.2, 0.2); the bias tables U(-1, 1), so that the
relative positions move the weights too (the published initialisation,
a normal of std 0.02, would not).
"""

import math
from dataclasses import dataclass
from functools import reduce
from operator import mul

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamSpec:
    """One parameter, with its draw: Laplace of scale ``laplace`` where
    that is above 0, else uniform on [``low``, ``high``)."""

    layer: str
    name: str
    shape: tuple
    low: float = 0.0
    high: float = 0.0
    laplace: float = 0.0


LN_EPS = 1e-5
MASK_VALUE = -100.0
QKV_GAIN = 1.5
UNIFORM = {"b": (-0.1, 0.1), "gamma": (0.8, 1.2), "beta": (-0.2, 0.2),
           "relative_position_bias_table": (-1.0, 1.0)}


@dataclass(frozen=True)
class Net:
    num_classes: int
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window_size: tuple
    patch_size: tuple
    mlp_ratio: float


def net(cfg: dict) -> Net:
    """Swin-B's widths, or those ``cfg`` gives."""
    return Net(num_classes=cfg.get("num_classes", 400), embed_dim=cfg.get("embed_dim", 128),
               depths=tuple(cfg.get("depths", (2, 2, 18, 2))),
               num_heads=tuple(cfg.get("num_heads", (4, 8, 16, 32))),
               window_size=tuple(cfg.get("window_size", (8, 7, 7))),
               patch_size=tuple(cfg.get("patch_size", (2, 4, 4))),
               mlp_ratio=float(cfg.get("mlp_ratio", 4.0)))


def grids(net: Net, frames: int, crop: int) -> list:
    """The (D, H, W) token grid of each stage."""
    d, h, w = (math.ceil(s / p) for s, p in zip((frames, crop, crop), net.patch_size))
    out = []
    for _ in net.depths:
        out.append((d, h, w))
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return out


def param_specs(net: Net, cfg: dict) -> tuple[list, list]:
    """(params, no statistics) as ParamSpecs, in the published order."""
    out = []

    def linear(name, cin, cout, bias=True, gain=1.0):
        out.append(ParamSpec(name, "w", (cout, cin), laplace=gain * math.sqrt(1.0 / cin)))
        if bias:
            out.append(ParamSpec(name, "b", (cout,), *UNIFORM["b"]))

    def norm(name, c):
        out.extend(ParamSpec(name, n, (c,), *UNIFORM[n]) for n in ("gamma", "beta"))

    c = net.embed_dim
    pt, ph, pw = net.patch_size
    fan = 3 * pt * ph * pw
    out.append(ParamSpec("patch_embed.proj", "w", (c, 3, pt, ph, pw),
                         laplace=math.sqrt(1.0 / fan)))
    out.append(ParamSpec("patch_embed.proj", "b", (c,), *UNIFORM["b"]))
    norm("patch_embed.norm", c)
    wt, wh, ww = net.window_size
    rows = (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1)
    for i, (depth, heads) in enumerate(zip(net.depths, net.num_heads)):
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}"
            norm(f"{pre}.norm1", c)
            out.append(ParamSpec(f"{pre}.attn", "relative_position_bias_table", (rows, heads),
                                 *UNIFORM["relative_position_bias_table"]))
            linear(f"{pre}.attn.qkv", c, 3 * c, gain=QKV_GAIN)
            linear(f"{pre}.attn.proj", c, c)
            norm(f"{pre}.norm2", c)
            hidden = int(c * net.mlp_ratio)
            linear(f"{pre}.mlp.fc1", c, hidden)
            linear(f"{pre}.mlp.fc2", hidden, c)
        if i < len(net.depths) - 1:
            norm(f"layers.{i}.downsample.norm", 4 * c)
            linear(f"layers.{i}.downsample.reduction", 4 * c, 2 * c, bias=False)
            c *= 2
    norm("norm", c)
    linear("cls_head.fc_cls", c, net.num_classes)
    return out, []


def clips(cfg: dict, frames_u8, h_off, w_off, mirror) -> torch.Tensor:
    """uint8 (N, T, H, W, 3) BGR frames -> float32 (N, 3, T, crop, crop):
    the crop (offsets clamped into the frame), the horizontal mirror,
    BGR -> RGB, then (x - mean) / std a channel."""
    n, _, h, w, _ = frames_u8.shape
    crop = cfg["crop_size"]
    mean = torch.tensor(cfg["mean_bgr"][::-1], device=frames_u8.device)
    std = torch.tensor(cfg["std_rgb"], device=frames_u8.device)
    out = []
    for i in range(n):
        y0 = min(max(int(h_off[i]), 0), h - crop)
        x0 = min(max(int(w_off[i]), 0), w - crop)
        v = frames_u8[i, :, y0:y0 + crop, x0:x0 + crop, :].float()
        if bool(mirror[i]):
            v = v.flip(2)
        rgb = (v.flip(-1) - mean) / std
        out.append(rgb.permute(3, 0, 1, 2))
    return torch.stack(out)


# -- the published functions ---------------------------------------------------


def window_partition(x, window_size):
    b, d, h, w, c = x.shape
    x = x.view(b, d // window_size[0], window_size[0], h // window_size[1], window_size[1],
               w // window_size[2], window_size[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, reduce(mul, window_size), c)


def window_reverse(windows, window_size, b, d, h, w):
    x = windows.view(b, d // window_size[0], h // window_size[1], w // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def get_window_size(x_size, window_size, shift_size):
    use_window_size, use_shift_size = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            use_shift_size[i] = 0
    return tuple(use_window_size), tuple(use_shift_size)


def compute_mask(d, h, w, window_size, shift_size, device):
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for ds in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
               slice(-shift_size[0], None)):
        for hs in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                   slice(-shift_size[1], None)):
            for ws in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                       slice(-shift_size[2], None)):
                img_mask[:, ds, hs, ws, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, MASK_VALUE).masked_fill(attn_mask == 0, 0.0)


def relative_position_index(window_size):
    coords = torch.stack(torch.meshgrid(torch.arange(window_size[0]),
                                        torch.arange(window_size[1]),
                                        torch.arange(window_size[2]), indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 2] += window_size[2] - 1
    relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative_coords[:, :, 1] *= (2 * window_size[2] - 1)
    return relative_coords.sum(-1)


# -- the network ------------------------------------------------------------------


def _linear(p, x):
    return F.linear(x, p["w"], p.get("b"))


def _norm(p, x):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], LN_EPS)


def window_attention(params, pre, x, heads, full_window, mask, probe):
    """``WindowAttention3D.forward`` over (B_, N, C) windows."""
    b_, n, c = x.shape
    qkv = _linear(params[f"{pre}.qkv"], x).reshape(b_, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    index = relative_position_index(full_window).to(x.device)
    table = params[pre]["relative_position_bias_table"]
    bias = table[index[:n, :n].reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    if probe is not None:
        # the spread of a query's logits over the keys its mask keeps
        keep = (attn > MASK_VALUE / 2).double()
        m = (attn * keep).sum(-1) / keep.sum(-1)
        var = (((attn - m.unsqueeze(-1)) ** 2) * keep).sum(-1) / keep.sum(-1)
        probe.append((pre, float(var.sqrt().mean())))
    e = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True)
    x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
    return _linear(params[f"{pre}.proj"], x)


def block(params, pre, x, heads, full_window, shift_size, mask_matrix, probe):
    """``SwinTransformerBlock3D.forward`` over (B, D, H, W, C)."""
    b, d, h, w, c = x.shape
    window_size, shift_size = get_window_size((d, h, w), full_window, shift_size)
    shortcut = x
    x = _norm(params[f"{pre}.norm1"], x)
    pad_d1 = (window_size[0] - d % window_size[0]) % window_size[0]
    pad_b = (window_size[1] - h % window_size[1]) % window_size[1]
    pad_r = (window_size[2] - w % window_size[2]) % window_size[2]
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
    _, dp, hp, wp, _ = x.shape
    if any(i > 0 for i in shift_size):
        shifted_x = torch.roll(x, shifts=tuple(-s for s in shift_size), dims=(1, 2, 3))
        attn_mask = mask_matrix
    else:
        shifted_x = x
        attn_mask = None
    x_windows = window_partition(shifted_x, window_size)
    attn_windows = window_attention(params, f"{pre}.attn", x_windows, heads, full_window,
                                    attn_mask, probe)
    attn_windows = attn_windows.view(-1, *(window_size + (c,)))
    shifted_x = window_reverse(attn_windows, window_size, b, dp, hp, wp)
    if any(i > 0 for i in shift_size):
        x = torch.roll(shifted_x, shifts=tuple(shift_size), dims=(1, 2, 3))
    else:
        x = shifted_x
    x = x[:, :d, :h, :w, :]
    x = shortcut + x
    y = _linear(params[f"{pre}.mlp.fc1"], _norm(params[f"{pre}.norm2"], x))
    return x + _linear(params[f"{pre}.mlp.fc2"], F.gelu(y))


def patch_merging(params, pre, x):
    h, w = x.shape[2], x.shape[3]
    if h % 2 == 1 or w % 2 == 1:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x0 = x[:, :, 0::2, 0::2, :]
    x1 = x[:, :, 1::2, 0::2, :]
    x2 = x[:, :, 0::2, 1::2, :]
    x3 = x[:, :, 1::2, 1::2, :]
    x = torch.cat([x0, x1, x2, x3], -1)
    return _linear(params[f"{pre}.reduction"], _norm(params[f"{pre}.norm"], x))


def forward(net: Net, params, state, clips, probe=None):
    """float32 clips (N, 3, T, H, W) -> logits (N, classes).  ``probe``, a
    list, gets each block's mean spread of a query's attention logits."""
    del state
    x = clips
    _, _, d, h, w = x.shape
    pt, ph, pw = net.patch_size
    if w % pw:
        x = F.pad(x, (0, pw - w % pw))
    if h % ph:
        x = F.pad(x, (0, 0, 0, ph - h % ph))
    if d % pt:
        x = F.pad(x, (0, 0, 0, 0, 0, pt - d % pt))
    p = params["patch_embed.proj"]
    x = F.conv3d(x, p["w"], p["b"], stride=net.patch_size)
    x = _norm(params["patch_embed.norm"], x.permute(0, 2, 3, 4, 1))   # B D H W C
    for i, (depth, heads) in enumerate(zip(net.depths, net.num_heads)):
        b, d, h, w, _ = x.shape
        layer_shift = tuple(s // 2 for s in net.window_size)
        window_size, shift_size = get_window_size((d, h, w), net.window_size, layer_shift)
        dp, hp, wp = (math.ceil(s / ws) * ws for s, ws in zip((d, h, w), window_size))
        attn_mask = compute_mask(dp, hp, wp, window_size, shift_size, x.device)
        for j in range(depth):
            shift = (0, 0, 0) if j % 2 == 0 else layer_shift
            x = block(params, f"layers.{i}.blocks.{j}", x, heads, net.window_size, shift,
                      attn_mask, probe)
        if i < len(net.depths) - 1:
            x = patch_merging(params, f"layers.{i}.downsample", x)
    x = _norm(params["norm"], x)
    x = x.mean(dim=(1, 2, 3))
    return _linear(params["cls_head.fc_cls"], x)
