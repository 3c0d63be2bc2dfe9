"""Plain PyTorch MViTv2-B (Kinetics-400, 32 x 3) in float32: the reference
the port's MViT (``eco_tpu_torch/models/mvit.py``) is held to.

Written from the paper (Li et al., "MViTv2: Improved Multiscale Vision
Transformers for Classification and Detection", CVPR 2022,
arXiv:2112.01526) and the published code (facebookresearch/SlowFast,
``configs/Kinetics/MVITv2_B_32x3.yaml``; ``slowfast/models/
video_model_builder.py``: ``MViT``; ``slowfast/models/attention.py``:
``MultiScaleBlock``, ``MultiScaleAttention``, ``attention_pool``,
``cal_rel_pos_spatial``, ``cal_rel_pos_temporal``), as it runs at test
time: dropout and drop-path the identity.  It imports nothing of the port.
Its tensors are the published layout: tokens (B, L, C) with the class token
first, heads (B, heads, L, d), pooling on (B x heads, d, T, H, W) by
``permute`` and ``reshape``; every attention takes its softmax explicitly
over the full logits, and the caller turns TF32 off.

The published configuration (``MVIT`` of the yaml): depth 24, embed dim 96,
one head, ``DIM_MUL`` and ``HEAD_MUL`` [[2, 2.0], [5, 2.0], [21, 2.0]],
``DIM_MUL_IN_ATT`` (the attention changes the width), patch kernel (3, 7,
7), stride (2, 4, 4), padding (1, 3, 3), ``POOL_KVQ_KERNEL`` (3, 3, 3), q
stride (1, 2, 2) at blocks 2, 5 and 21 (every other block lists (1, 1, 1),
so every block pools q), ``POOL_KV_STRIDE_ADAPTIVE`` (1, 8, 8),
``MODE: conv`` (a depthwise conv a head width, shared by the heads),
``REL_POS_SPATIAL``, ``REL_POS_TEMPORAL``, ``RESIDUAL_POOLING``,
``CLS_EMBED_ON``, no absolute position embedding, ``MLP_RATIO`` 4,
``QKV_BIAS``; layer norms of eps 1e-6.

Where it departs from the published code:

- the weights are random draws from ``param_specs`` (below), not a
  checkpoint;
- ``get_rel_pos`` interpolates a table whose length is not 2 max(q, k) - 1;
  no geometry here needs that (each table is made for its block's sizes),
  so this raises instead;
- the widths are doubled at the blocks of ``dim_mul_blocks`` directly (the
  published ``round_width`` gives the same widths at every size here);
- the head scores one clip: the published test protocol averages the softmax
  of its 5 views (``NUM_ENSEMBLE_VIEWS`` 5, ``NUM_SPATIAL_CROPS`` 1), which
  a caller does over the rows.

The clips are the published input: uint8 BGR frames through their crop,
horizontal mirror, BGR -> RGB and ``(x / 255 - 0.45) / 0.225`` a channel
(``DATA.MEAN``, ``DATA.STD``), which is ``(x - mean) / std`` with the
configuration's ``mean_bgr`` (114.75 each) and ``std_rgb`` (57.375 each),
as (N, 3, T, H, W).

A net is a ``Net`` of the published widths (``cfg`` may give others:
``embed_dim``, ``depth``, ``num_heads``, ``dim_mul_blocks``,
``patch_kernel``, ``patch_stride``, ``patch_padding``, ``pool_kernel``,
``kv_stride``, ``mlp_ratio``).  Weights are ``{layer: {name: tensor}}``,
named as the port's graph names them: the published ``state_dict`` names,
``w`` / ``b`` for ``weight`` / ``bias`` of a conv or linear, ``gamma`` /
``beta`` of a layer norm; the class token ``cls_token`` / ``token``; each
block's pooling convs, their norms and the position tables are params of the
layer ``blocks.{i}.attn``: ``pool_q.w``, ``norm_q.gamma``, ``norm_q.beta``
(and ``_k``, ``_v``), ``rel_pos_h``, ``rel_pos_w``, ``rel_pos_t``.  There
are no running statistics.

The weights' draws (``param_specs``): conv and linear weights Laplace of
scale sqrt(1 / fan_in) (variance 2 / fan_in), the pooling convs' fan-in
their 27 taps; biases U(-0.1, 0.1); layer norm scale U(0.8, 1.2), shift
U(-0.2, 0.2), but ``norm_q`` and ``norm_k``'s scales U(``QK_GAMMA``), so
that the logits (q k^T / sqrt(d), after the norms) spread by roughly 1-3
over a query's keys at every stage: nearly uniform weights or nearly
one-hot ones would leave the attention untested; the class token U(-1, 1);
the position tables U(-r, r), r = ``REL_POS`` / sqrt(d), so that each
position term (q . R, |q| ~ sqrt(d)) moves a logit by some 0.4: the
published initialisation, a truncated normal of std 0.02, would leave the
positions without effect.
"""

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F


LN_EPS = 1e-6
QK_GAMMA = (1.0, 1.5)
REL_POS = 0.7
UNIFORM = {"b": (-0.1, 0.1), "gamma": (0.8, 1.2), "beta": (-0.2, 0.2), "token": (-1.0, 1.0)}


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


@dataclass(frozen=True)
class Net:
    num_classes: int
    embed_dim: int
    depth: int
    num_heads: int
    dim_mul_blocks: tuple
    patch_kernel: tuple
    patch_stride: tuple
    patch_padding: tuple
    pool_kernel: tuple
    kv_stride: tuple
    mlp_ratio: float


@dataclass(frozen=True)
class Block:
    """One block's widths and strides, and the input sizes its position
    tables are made for (the published ``input_size``)."""

    dim: int
    dim_out: int
    heads: int
    stride_q: tuple
    stride_kv: tuple
    input_size: tuple


def net(cfg: dict) -> Net:
    """MViTv2-B's widths, or those ``cfg`` gives."""
    return Net(num_classes=cfg.get("num_classes", 400), embed_dim=cfg.get("embed_dim", 96),
               depth=cfg.get("depth", 24), num_heads=cfg.get("num_heads", 1),
               dim_mul_blocks=tuple(cfg.get("dim_mul_blocks", (2, 5, 21))),
               patch_kernel=tuple(cfg.get("patch_kernel", (3, 7, 7))),
               patch_stride=tuple(cfg.get("patch_stride", (2, 4, 4))),
               patch_padding=tuple(cfg.get("patch_padding", (1, 3, 3))),
               pool_kernel=tuple(cfg.get("pool_kernel", (3, 3, 3))),
               kv_stride=tuple(cfg.get("kv_stride", (1, 8, 8))),
               mlp_ratio=float(cfg.get("mlp_ratio", 4.0)))


def blocks(net: Net, frames: int, crop: int) -> list:
    """Each block's ``Block``, as ``MViT.__init__`` derives them: the width
    and the heads doubled at the blocks of ``dim_mul_blocks``, whose q
    stride is (1, 2, 2), and the kv stride (``POOL_KV_STRIDE_ADAPTIVE``)
    divided by each q stride on the way, at least 1."""
    size = [frames // net.patch_stride[0], crop // net.patch_stride[1],
            crop // net.patch_stride[2]]
    dim, heads, kv = net.embed_dim, net.num_heads, list(net.kv_stride)
    out = []
    for i in range(net.depth):
        stride_q = (1, 2, 2) if i in net.dim_mul_blocks else (1, 1, 1)
        kv = [max(s // q, 1) for s, q in zip(kv, stride_q)]
        dim_out = dim
        if i in net.dim_mul_blocks:
            heads, dim_out = 2 * heads, 2 * dim
        out.append(Block(dim, dim_out, heads, stride_q, tuple(kv), tuple(size)))
        size = [s // q for s, q in zip(size, stride_q)]
        dim = dim_out
    return out


def param_specs(net: Net, cfg: dict) -> tuple[list, list]:
    """(params, no statistics) as ParamSpecs, in the graph's order."""
    out = []

    def linear(name, cin, cout):
        out.append(ParamSpec(name, "w", (cout, cin), laplace=math.sqrt(1.0 / cin)))
        out.append(ParamSpec(name, "b", (cout,), *UNIFORM["b"]))

    def norm(name, c):
        out.extend(ParamSpec(name, n, (c,), *UNIFORM[n]) for n in ("gamma", "beta"))

    c = net.embed_dim
    fan = 3 * math.prod(net.patch_kernel)
    out.append(ParamSpec("patch_embed.proj", "w", (c, 3, *net.patch_kernel),
                         laplace=math.sqrt(1.0 / fan)))
    out.append(ParamSpec("patch_embed.proj", "b", (c,), *UNIFORM["b"]))
    out.append(ParamSpec("cls_token", "token", (c,), *UNIFORM["token"]))
    taps = math.prod(net.pool_kernel)
    for i, blk in enumerate(blocks(net, cfg["num_segments"], cfg["crop_size"])):
        pre = f"blocks.{i}"
        d = blk.dim_out // blk.heads
        norm(f"{pre}.norm1", blk.dim)
        linear(f"{pre}.attn.qkv", blk.dim, 3 * blk.dim_out)
        for s in "qkv":
            out.append(ParamSpec(f"{pre}.attn", f"pool_{s}.w", (d, 1, *net.pool_kernel),
                                 laplace=math.sqrt(1.0 / taps)))
            gamma = QK_GAMMA if s in "qk" else UNIFORM["gamma"]
            out.append(ParamSpec(f"{pre}.attn", f"norm_{s}.gamma", (d,), *gamma))
            out.append(ParamSpec(f"{pre}.attn", f"norm_{s}.beta", (d,), *UNIFORM["beta"]))
        size_t, size_h, _ = blk.input_size
        q_size = size_h // blk.stride_q[1]
        kv_size = size_h // blk.stride_kv[1]
        r = REL_POS / math.sqrt(d)
        for axis in "hw":
            out.append(ParamSpec(f"{pre}.attn", f"rel_pos_{axis}",
                                 (2 * max(q_size, kv_size) - 1, d), -r, r))
        out.append(ParamSpec(f"{pre}.attn", "rel_pos_t", (2 * size_t - 1, d), -r, r))
        linear(f"{pre}.attn.proj", blk.dim_out, blk.dim_out)
        if blk.dim != blk.dim_out:
            linear(f"{pre}.proj", blk.dim, blk.dim_out)
        norm(f"{pre}.norm2", blk.dim_out)
        hidden = int(blk.dim_out * net.mlp_ratio)
        linear(f"{pre}.mlp.fc1", blk.dim_out, hidden)
        linear(f"{pre}.mlp.fc2", hidden, blk.dim_out)
        c = blk.dim_out
    norm("norm", c)
    linear("head.projection", c, net.num_classes)
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


def attention_pool(tensor, pool, thw_shape, has_cls_embed=True, norm=None):
    if pool is None:
        return tensor, thw_shape
    tensor_dim = tensor.ndim
    if tensor_dim == 3:
        tensor = tensor.unsqueeze(1)
    if has_cls_embed:
        cls_tok, tensor = tensor[:, :, :1, :], tensor[:, :, 1:, :]
    b, n, _, c = tensor.shape
    t, h, w = thw_shape
    tensor = tensor.reshape(b * n, t, h, w, c).permute(0, 4, 1, 2, 3).contiguous()
    tensor = pool(tensor)
    thw_shape = [tensor.shape[2], tensor.shape[3], tensor.shape[4]]
    l_pooled = tensor.shape[2] * tensor.shape[3] * tensor.shape[4]
    tensor = tensor.reshape(b, n, c, l_pooled).transpose(2, 3)
    if has_cls_embed:
        tensor = torch.cat((cls_tok, tensor), dim=2)
    if norm is not None:
        tensor = norm(tensor)
    if tensor_dim == 3:
        tensor = tensor.squeeze(1)
    return tensor, thw_shape


def get_rel_pos(rel_pos, d):
    if rel_pos.shape[0] != d:
        raise ValueError(f"a table of {rel_pos.shape[0]} rows for {d} distances: the published "
                         "code interpolates it, which no geometry here needs")
    return rel_pos


def rel_pos_distance(q_size, k_size):
    """The published distance index of ``cal_rel_pos_spatial`` /
    ``cal_rel_pos_temporal`` along one axis, (q_size, k_size) int64."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = torch.arange(q_size)[:, None] * q_ratio - torch.arange(k_size)[None, :] * k_ratio
    dist += (k_size - 1) * k_ratio
    return dist.long()


def cal_rel_pos_spatial(attn, q, k, has_cls_embed, q_shape, k_shape, rel_pos_h, rel_pos_w):
    sp_idx = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dh = int(2 * max(q_h, k_h) - 1)
    dw = int(2 * max(q_w, k_w) - 1)
    dist_h = rel_pos_distance(q_h, k_h).to(q.device)
    dist_w = rel_pos_distance(q_w, k_w).to(q.device)
    rel_pos_h = get_rel_pos(rel_pos_h, dh)
    rel_pos_w = get_rel_pos(rel_pos_w, dw)
    rh = rel_pos_h[dist_h]
    rw = rel_pos_w[dist_w]
    b, n_head, _, dim = q.shape
    r_q = q[:, :, sp_idx:].reshape(b, n_head, q_t, q_h, q_w, dim)
    rel_h_q = torch.einsum("bythwc,hkc->bythwk", r_q, rh)
    rel_w_q = torch.einsum("bythwc,wkc->bythwk", r_q, rw)
    attn[:, :, sp_idx:, sp_idx:] = (
        attn[:, :, sp_idx:, sp_idx:].view(b, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel_h_q[:, :, :, :, :, None, :, None]
        + rel_w_q[:, :, :, :, :, None, None, :]
    ).view(b, -1, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn


def cal_rel_pos_temporal(attn, q, has_cls_embed, q_shape, k_shape, rel_pos_t):
    sp_idx = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    dt = int(2 * max(q_t, k_t) - 1)
    rel_pos_t = get_rel_pos(rel_pos_t, dt)
    dist_t = rel_pos_distance(q_t, k_t).to(q.device)
    rt = rel_pos_t[dist_t]
    b, n_head, _, dim = q.shape
    r_q = q[:, :, sp_idx:].reshape(b, n_head, q_t, q_h, q_w, dim)
    r_q = r_q.permute(2, 0, 1, 3, 4, 5).reshape(q_t, b * n_head * q_h * q_w, dim)
    rel = torch.matmul(r_q, rt.transpose(1, 2)).transpose(0, 1)
    rel = rel.view(b, n_head, q_h, q_w, q_t, k_t).permute(0, 1, 4, 2, 3, 5)
    attn[:, :, sp_idx:, sp_idx:] = (
        attn[:, :, sp_idx:, sp_idx:].view(b, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel[:, :, :, :, :, :, None, None]
    ).view(b, -1, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn


# -- the network ------------------------------------------------------------------


def _linear(p, x):
    return F.linear(x, p["w"], p.get("b"))


def _norm(p, x, prefix=""):
    return F.layer_norm(x, (x.shape[-1],), p[prefix + "gamma"], p[prefix + "beta"], LN_EPS)


def _spread(logits):
    """Mean over queries of the std of a query's logits over its keys."""
    return float(logits.double().std(dim=-1).mean())


def attention(net, params, pre, x, thw, blk, probe):
    """``MultiScaleAttention.forward`` over (B, N, C) tokens."""
    b, n, _ = x.shape
    heads = blk.heads
    d = blk.dim_out // heads
    p = params[pre]
    kernel = net.pool_kernel
    padding = [k // 2 for k in kernel]
    qkv = _linear(params[f"{pre}.qkv"], x).reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]

    def pool(s, stride):
        conv = partial(F.conv3d, weight=p[f"pool_{s}.w"], stride=stride, padding=padding,
                       groups=d)
        return dict(pool=conv, norm=partial(_norm, p, prefix=f"norm_{s}."))

    q, q_shape = attention_pool(q, thw_shape=thw, **pool("q", blk.stride_q))
    k, k_shape = attention_pool(k, thw_shape=thw, **pool("k", blk.stride_kv))
    v, _ = attention_pool(v, thw_shape=thw, **pool("v", blk.stride_kv))
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    plain = attn[:, :, 1:, 1:].clone() if probe is not None else None
    attn = cal_rel_pos_spatial(attn, q, k, True, q_shape, k_shape, p["rel_pos_h"], p["rel_pos_w"])
    attn = cal_rel_pos_temporal(attn, q, True, q_shape, k_shape, p["rel_pos_t"])
    if probe is not None:
        # the logits' spread over a query's keys, and that of the position
        # terms alone, over the grid's queries and keys
        probe.append((pre, _spread(attn[:, :, 1:, 1:]), _spread(attn[:, :, 1:, 1:] - plain)))
    e = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True)
    x = attn @ v
    x[:, :, 1:, :] += q[:, :, 1:, :]
    x = x.transpose(1, 2).reshape(b, -1, blk.dim_out)
    return _linear(params[f"{pre}.proj"], x), q_shape


def block(net, params, pre, x, thw, blk, probe):
    """``MultiScaleBlock.forward`` (``DIM_MUL_IN_ATT``) over (B, N, C)."""
    x_norm = _norm(params[f"{pre}.norm1"], x)
    x_block, thw_new = attention(net, params, f"{pre}.attn", x_norm, thw, blk, probe)
    if blk.dim != blk.dim_out:
        x = _linear(params[f"{pre}.proj"], x_norm)
    if math.prod(blk.stride_q) > 1:
        kernel_skip = [s + 1 if s > 1 else s for s in blk.stride_q]
        padding_skip = [k // 2 for k in kernel_skip]
        skip = partial(F.max_pool3d, kernel_size=kernel_skip, stride=blk.stride_q,
                       padding=padding_skip)
        x, _ = attention_pool(x, skip, thw)
    x = x + x_block
    x_mlp = _linear(params[f"{pre}.mlp.fc2"],
                    F.gelu(_linear(params[f"{pre}.mlp.fc1"], _norm(params[f"{pre}.norm2"], x))))
    return x + x_mlp, thw_new


def forward(net: Net, params, state, clips, probe=None):
    """float32 clips (N, 3, T, H, W) -> logits (N, classes).  ``probe``, a
    list, gets each block's (name, logit spread, position terms' spread)."""
    del state
    p = params["patch_embed.proj"]
    x = F.conv3d(clips, p["w"], p["b"], stride=net.patch_stride, padding=net.patch_padding)
    b, c, t, h, w = x.shape
    x = x.flatten(2).transpose(1, 2)
    cls = params["cls_token"]["token"].view(1, 1, c).expand(b, -1, -1)
    x = torch.cat((cls, x), dim=1)
    thw = [t, h, w]
    for i, blk in enumerate(blocks(net, clips.shape[2], clips.shape[3])):
        x, thw = block(net, params, f"blocks.{i}", x, thw, blk, probe)
    x = _norm(params["norm"], x)
    return _linear(params["head.projection"], x[:, 0])
