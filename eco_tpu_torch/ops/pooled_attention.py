"""Pooling attention with decomposed relative positions: the attention of
MViTv2 (Li et al., "MViTv2: Improved Multiscale Vision Transformers for
Classification and Detection", CVPR 2022, arXiv:2112.01526), as
``MultiScaleAttention.forward`` of facebookresearch/SlowFast
(``slowfast/models/attention.py``) runs it at test time, and the max pool of
its blocks' skip path.

Tokens are rows, (N, 1 + T x H x W, C): a class token, then a (T, H, W)
grid flattened in (t, h, w) order; each layer that needs the grid is told
its size.  The attention layer takes the block's qkv rows (N, L, 3C),
channels (q, k, v) x heads x d as the published qkv linear lays them out
(the linear and the output projection are token-wise InnerProducts).

- :func:`pool_qkv`: for each of q, k and v, the class token set aside, the
  grid pooled by a depthwise 3D convolution over each head's d channels
  (one kernel serves every head), the class token put back in front, then
  a layer norm over d of every token and head.  It takes one of two routes,
  by its input alone.  K7, the hand-written kernel ``csrc/qkv_pool.cu``
  (built with ``nvcc`` at first use), takes bf16 or f16 rows on the card
  with a (3, 3, 3) kernel, strides (1, s, s) for s in 1, 2, 4 and 8, d a
  multiple of 8 up to 96 and no gradient asked (:func:`_takes`): one
  launch a block reads the qkv rows by index, sums each window's 27 taps
  in f32, norms each token and head and writes q, k and v, the class
  token's row first.  Everything else (the CPU, f32, other kernels and
  strides, gradients) takes :func:`pool_qkv_route`: a layout copy of the
  grid, PyTorch's depthwise 3D conv, the concats and ``layer_norm``.
  :func:`pool_qkv_plain` is K7's arithmetic in plain PyTorch (f32 sums,
  an f32 norm, one rounding), the kernel's plain version;
- :func:`rel_pos_index`: the published distance of query i from key j along
  one axis, for unequal sizes (``cal_rel_pos_spatial``'s arithmetic);
- :func:`pooled_attention`: q, k and v pooled with their own strides, then
  softmax(q k^T / sqrt(d) + bias) v with the bias
  ``q . Rt[qt, kt] + q . Rh[qh, kh] + q . Rw[qw, kw]`` on the grid's rows
  and columns (none on the class token's), from the pooled, normed,
  unscaled q and each table gathered by :func:`rel_pos_index`; then the
  residual pooling add of q to the grid's rows, and the heads merged;
- :func:`pool_skip`: the block's skip path where q is strided: a max pool
  of the grid's rows (``ops/pool.py:pool_nd``, K4 on the card), the class
  token passed through.

This module is beside ``ops/attention.py``, not a section of it: the two
share no geometry (windows and a gathered table there; a whole clip, keys
coarser than queries and a bias computed from the queries here) and no
code.

The core is ``F.scaled_dot_product_attention`` with no mask.  The bias is a
sum of three terms, each a function of the query and of one coordinate of
the key, so it is the product of position columns: each query gets
``q . R`` for every key coordinate along each axis
(:func:`position_columns`), each key a one at its own three coordinates
(:func:`key_columns`), and q and k, widened by these columns, give the
logits with the bias in the library's own product.  The bias
(N, heads, Lq, Lk), 8.27 GB of bf16 a request of 10 MViTv2-B clips, is
never written: the columns are 0.35 GB.  Serving only: the residual pooling
is added in place, so a gradient through the layer raises.

Spans and counters (``utils/tracing.py``): ``eco.qkv_pool`` around the
pooling of q, k and v (K7's launch, or the route's layout copy, three
convs, concats with the class token and three norms);
``COUNTS["k7.launches"]`` counts K7's launches, and
``COUNTS["qkv_pool.bytes"]`` the pooling's least bytes on either route
(each row some window reads, the class token's row and each output row,
once, at the rows' bytes a value); ``eco.pattn`` around the core (the
three position products and the columns, the attention, the residual add
and the merge); ``COUNTS["pattn.flops"]`` adds twice the multiply-adds of
q k^T, of the weights times v and of the three position products,
``COUNTS["pattn.bytes"]`` the core's least bytes (q, k and v read once,
the output written once, the three tables read once, at the tokens' bytes
a value), and ``COUNTS["pattn.bias_bytes"]`` the bytes of the position
terms the route writes for the library's kernel (the columns of q and k);
a kernel that computes the terms from q and the tables writes none.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch
import torch.nn.functional as F

from eco_tpu_torch.ops import _build
from eco_tpu_torch.ops.norm import layer_norm
from eco_tpu_torch.ops.pool import pool_nd
from eco_tpu_torch.utils.tracing import COUNTS, span

COLUMN_ALIGN = 8  # q and k's head width with the position columns is a multiple of it
K7_STRIDES = (1, 2, 4, 8)  # the strides along H and W that K7 is built for
MAX_HEAD_DIM = 96  # K7's widest head (csrc/qkv_pool.cu's kMaxD)
_ELEM_KINDS = {torch.bfloat16: 1, torch.float16: 2}  # K7's row types


def pooled_size(size, kernel, stride, pad) -> tuple:
    """The grid a convolution or max pool of ``kernel``, ``stride`` and a
    symmetric ``pad`` leaves of ``size``, floor mode (PyTorch's, as the
    published ``Conv3d`` and ``MaxPool3d`` give)."""
    return tuple((s + 2 * p - k) // st + 1 for s, k, st, p in zip(size, kernel, stride, pad))


def rel_pos_index(q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size) int64: the row of a (2 max(q, k) - 1)-row table that
    query i and key j read along one axis, the published arithmetic:
    ``i * max(k / q, 1) - j * max(q / k, 1) + (k - 1) * max(q / k, 1)``,
    in float32 and truncated, as ``cal_rel_pos_spatial`` computes it."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = torch.arange(q_size)[:, None] * q_ratio - torch.arange(k_size)[None, :] * k_ratio
    return (dist + (k_size - 1) * k_ratio).long()


@functools.lru_cache(maxsize=256)
def _index(q_size: int, k_size: int, device) -> torch.Tensor:
    """:func:`rel_pos_index` on ``device``, made once: a copy from host
    memory at every call would wait for the stream."""
    return rel_pos_index(q_size, k_size).to(device)


def pool_qkv(qkv: torch.Tensor, params: dict, *, heads: int, size, stride_q, stride_kv, kernel,
             eps: float):
    """q, k and v pooled and normed, the published ``attention_pool`` of each.

    ``qkv``: (N, 1 + T x H x W, 3C) rows, channels (q, k, v) x heads x d;
    ``params``: the layer's (see :func:`pooled_attention`).  Returns q, k
    and v as (N, 1 + T' x H' x W', heads, d) and the grids of q and of k
    and v.  K7 (``csrc/qkv_pool.cu``) where :func:`_takes` holds, else
    :func:`pool_qkv_route`; ``COUNTS["qkv_pool.bytes"]`` counts the same
    least bytes on either."""
    _count_pool(qkv.shape[0], qkv.shape[-1] // 3, tuple(size), tuple(stride_q),
                tuple(stride_kv), tuple(kernel), qkv.element_size())
    if _takes(qkv, params, heads, size, stride_q, stride_kv, kernel):
        return _pool_k7(qkv, params, heads, tuple(size), tuple(stride_q), tuple(stride_kv), eps)
    return pool_qkv_route(qkv, params, heads=heads, size=size, stride_q=stride_q,
                          stride_kv=stride_kv, kernel=kernel, eps=eps)


def pool_qkv_route(qkv: torch.Tensor, params: dict, *, heads: int, size, stride_q, stride_kv,
                   kernel, eps: float):
    """:func:`pool_qkv` through the library: the grid's rows are laid out
    once as (3, N, C, T, H, W), so that each of q, k and v is a contiguous
    NCDHW clip, which PyTorch's depthwise 3D kernel takes as it is (cuDNN's
    channels-last depthwise 3D conv converts the layout and ran 2.2-2.5x
    slower at stride 1 on an H100); each is convolved with its kernel
    repeated over the heads (groups = C) in the input type, its grid's rows
    put back behind the class token's, and each token and head normed over
    d with gamma and beta in the input type."""
    n, _, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    pad = tuple(k // 2 for k in kernel)
    grid = qkv[:, 1:].unflatten(2, (3, c)).permute(2, 0, 3, 1).contiguous().view(3, n, c, *size)
    out, sizes = [], []
    for i, (s, stride) in enumerate(zip("qkv", (stride_q, stride_kv, stride_kv))):
        w = params[f"pool_{s}.w"].to(qkv.dtype).repeat(heads, 1, 1, 1, 1)
        pooled = F.conv3d(grid[i], w, None, tuple(stride), pad, 1, c)
        rows = torch.cat([qkv[:, :1, i * c:(i + 1) * c], pooled.flatten(2).transpose(1, 2)], dim=1)
        out.append(layer_norm(rows.view(n, -1, heads, d), params[f"norm_{s}.gamma"],
                              params[f"norm_{s}.beta"], eps=eps))
        sizes.append(tuple(pooled.shape[2:]))
    return (*out, sizes[0], sizes[1])


def pool_qkv_plain(qkv: torch.Tensor, params: dict, *, heads: int, size, stride_q, stride_kv,
                   kernel, eps: float):
    """K7's arithmetic in plain PyTorch, the kernel's plain version: each
    tap of each of q, k and v reads its rows of the zero-padded grid by
    index (a strided slice), the products are summed in f32 with the f32
    kernel, and the class token's row and the pooled rows are normed over
    d in f32 with f32 gamma and beta, then rounded once to ``qkv``'s type.
    The same results as :func:`pool_qkv`."""
    n, _, c3 = qkv.shape
    d = c3 // 3 // heads
    pad = tuple(k // 2 for k in kernel)
    x = qkv.float().view(n, -1, 3, heads, d)
    out, sizes = [], []
    for i, (s, stride) in enumerate(zip("qkv", (stride_q, stride_kv, stride_kv))):
        o = pooled_size(size, kernel, stride, pad)
        grid = F.pad(x[:, 1:, i].reshape(n, *size, heads, d),
                     (0, 0, 0, 0, pad[2], pad[2], pad[1], pad[1], pad[0], pad[0]))
        w = params[f"pool_{s}.w"].float().reshape(d, -1)
        acc = torch.zeros((n, *o, heads, d), device=qkv.device)
        for tap, (a, b, e) in enumerate(itertools.product(*map(range, kernel))):
            acc += w[:, tap] * grid[:, a:a + stride[0] * (o[0] - 1) + 1:stride[0],
                                    b:b + stride[1] * (o[1] - 1) + 1:stride[1],
                                    e:e + stride[2] * (o[2] - 1) + 1:stride[2]]
        rows = torch.cat([x[:, :1, i], acc.view(n, -1, heads, d)], dim=1)
        out.append(F.layer_norm(rows, (d,), params[f"norm_{s}.gamma"].float(),
                                params[f"norm_{s}.beta"].float(), eps).to(qkv.dtype))
        sizes.append(o)
    return (*out, sizes[0], sizes[1])


@functools.lru_cache(maxsize=256)
def _tapped(size: int, kernel: int, stride: int, pad: int) -> int:
    """Rows of an axis of ``size`` that some window of the pool reads."""
    (out,) = pooled_size((size,), (kernel,), (stride,), (pad,))
    return len({i * stride - pad + k for i in range(out) for k in range(kernel)}
               & set(range(size)))


def _count_pool(n: int, c: int, size, stride_q, stride_kv, kernel, itemsize: int) -> None:
    """``COUNTS["qkv_pool.bytes"]``: for each of q, k and v, each of the
    ``c`` channels of every row some window reads, the class token's row
    and every output row (its class token's too), once, ``itemsize`` bytes
    a value."""
    pad = tuple(k // 2 for k in kernel)
    rows = 0
    for stride in (stride_q, stride_kv, stride_kv):
        read = math.prod(_tapped(*a) for a in zip(size, kernel, stride, pad))
        rows += read + 1 + math.prod(pooled_size(size, kernel, stride, pad)) + 1
    COUNTS["qkv_pool.bytes"] += n * rows * c * itemsize


@functools.cache
def _kernel():
    fn = _build.load("qkv_pool").eco_qkv_pool
    fn.argtypes = (
        [ctypes.c_void_p] * 13          # qkv; w, gamma, beta of q, k, v; the three outputs
        + [ctypes.c_int] * 8            # n, t, h, w, heads, d, stride_q, stride_kv
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # eps, element kind, stream
    )
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build and load K7 now rather than at its first launch."""
    _kernel()


def k7_fits(dtype, shape, heads: int, size, stride_q, stride_kv, kernel) -> bool:
    """True iff K7 is built for the geometry: bf16 or f16 rows (N, 1 + T x
    H x W, 3 x heads x d), d a multiple of 8 up to ``MAX_HEAD_DIM``, a
    (3, 3, 3) kernel, strides (1, s, s) with s in ``K7_STRIDES``, fewer
    than 2**31 rows, and fewer than 2**31 values in a clip's rows."""
    n, rows, c3 = shape
    d = c3 // 3 // heads
    return (dtype in _ELEM_KINDS and c3 == 3 * heads * d and d % 8 == 0
            and 8 <= d <= MAX_HEAD_DIM and rows == 1 + math.prod(size)
            and tuple(kernel) == (3, 3, 3) and n * rows < 2**31 and rows * c3 < 2**31
            and all(s[0] == 1 and s[1] == s[2] and s[1] in K7_STRIDES
                    for s in (tuple(stride_q), tuple(stride_kv))))


def _takes(qkv: torch.Tensor, params: dict, heads: int, size, stride_q, stride_kv,
           kernel) -> bool:
    """True iff :func:`pool_qkv` launches K7: rows on the card, contiguous,
    that :func:`k7_fits`, the layer's kernels, gammas and betas on the same
    card with the shapes the rows give, no gradient asked and no trace
    running."""
    if qkv.device.type != "cuda" or qkv.ndim != 3 or not qkv.is_contiguous():
        return False
    if not k7_fits(qkv.dtype, tuple(qkv.shape), heads, size, stride_q, stride_kv, kernel):
        return False
    d = qkv.shape[-1] // 3 // heads
    mine = [params[f"{k}_{s}.{p}"] for s in "qkv" for k, p in (("pool", "w"), ("norm", "gamma"),
                                                                 ("norm", "beta"))]
    return (all(t.device == qkv.device and t.is_floating_point() for t in mine)
            and all(tuple(mine[3 * i].shape) == (d, 1, 3, 3, 3)
                    and tuple(mine[3 * i + 1].shape) == tuple(mine[3 * i + 2].shape) == (d,)
                    for i in range(3))
            and not (torch.is_grad_enabled()
                     and (qkv.requires_grad or any(t.requires_grad for t in mine)))
            and not torch.compiler.is_compiling())


def _pool_k7(qkv, params, heads, size, stride_q, stride_kv, eps):
    """K7's launch: q, k and v pooled and normed into new rows."""
    n, _, c3 = qkv.shape
    d = c3 // 3 // heads
    pad = (1, 1, 1)
    q_size = pooled_size(size, (3, 3, 3), stride_q, pad)
    k_size = pooled_size(size, (3, 3, 3), stride_kv, pad)
    q = torch.empty((n, 1 + math.prod(q_size), heads, d), dtype=qkv.dtype, device=qkv.device)
    k = torch.empty((n, 1 + math.prod(k_size), heads, d), dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(k)
    # f32 and contiguous already in serving: no copy
    w, g, b = ([params[f"{key}_{s}.{p}"].float().contiguous() for s in "qkv"]
               for key, p in (("pool", "w"), ("norm", "gamma"), ("norm", "beta")))
    err = _kernel()(
        qkv.data_ptr(), *(t.data_ptr() for t in (*w, *g, *b)), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), n, *size, heads, d, stride_q[1], stride_kv[1], eps,
        _ELEM_KINDS[qkv.dtype], torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"q/k/v pooling kernel launch failed: CUDA error {err}")
    COUNTS["k7.launches"] += 1
    return q, k, v, q_size, k_size


def position_width(k_size, d: int) -> int:
    """The position columns appended to q and k: one a key position along
    each axis (kt + kh + kw), padded so that d + width is a whole number of
    ``COLUMN_ALIGN``."""
    return -(-(d + sum(k_size)) // COLUMN_ALIGN) * COLUMN_ALIGN - d


def position_columns(q: torch.Tensor, tables, q_size, k_size) -> torch.Tensor:
    """The position columns of the queries, (N, Lq, heads, width):
    ``q . Rt[qt, kt]`` for each kt, then ``q . Rh[qh, kh]`` for each kh, then
    ``q . Rw[qw, kw]`` for each kw, each times sqrt(d); zero in the class
    token's row and in the padding.

    ``q``: the pooled, normed, unscaled queries (N, Lq, heads, d);
    ``tables``: (rel_pos_t, rel_pos_h, rel_pos_w), each (2 max(q, k) - 1, d)
    along its axis, gathered by :func:`rel_pos_index`.  With the key columns
    of :func:`key_columns`, the product of the columns is the published
    bias times sqrt(d)."""
    n, lq, heads, d = q.shape
    qg = q[:, 1:].unflatten(1, tuple(q_size))                        # n, qt, qh, qw, heads, d
    rel = []
    for axis, (table, qs, ks) in enumerate(zip(tables, q_size, k_size)):
        if table.shape[0] != 2 * max(qs, ks) - 1:
            raise ValueError(f"a position table of {table.shape[0]} rows for sizes {qs} and "
                             f"{ks}: the published code interpolates it, which this does not")
        r = (table[_index(qs, ks, q.device)].float() * math.sqrt(d)).to(q.dtype)  # qs, ks, d
        rel.append(torch.einsum(f"nthwyc,{'thw'[axis]}kc->nthwyk", qg, r))
    cols = torch.cat(rel, dim=-1).view(n, lq - 1, heads, sum(k_size))
    return F.pad(cols, (0, position_width(k_size, d) - sum(k_size), 0, 0, 1, 0))


@functools.lru_cache(maxsize=64)
def key_columns(k_size, width: int, dtype, device) -> torch.Tensor:
    """The position columns of the keys, (1 + kt x kh x kw, width): key
    (t, h, w) has a one in column t, in column kt + h and in column kt + kh
    + w; the class token's row and the padding are zero.  Made once a
    geometry."""
    kt, kh, kw = k_size
    j = torch.arange(kt * kh * kw)
    cols = torch.zeros((1 + len(j), width))
    cols[1 + j, j // (kh * kw)] = 1.0
    cols[1 + j, kt + (j // kw) % kh] = 1.0
    cols[1 + j, kt + kh + j % kw] = 1.0
    return cols.to(device=device, dtype=dtype)


def _count_core(n, heads, lq, lk, d, width, q_size, k_size, table_rows, itemsize):
    """``pattn.flops``, ``pattn.bytes`` and ``pattn.bias_bytes`` of one
    core: ``lq`` / ``lk`` rows of q / k and v with the class token,
    ``width`` position columns, ``table_rows`` the three tables' rows
    together."""
    grid_q = math.prod(q_size)
    products = 2 * lq * lk + grid_q * sum(k_size)
    COUNTS["pattn.flops"] += 2 * n * heads * products * d
    COUNTS["pattn.bytes"] += (n * heads * (2 * lq + 2 * lk) * d + table_rows * d) * itemsize
    COUNTS["pattn.bias_bytes"] += n * heads * (lq + lk) * width * itemsize


def pooled_attention(qkv: torch.Tensor, params: dict, *, heads: int, size, stride_q,
                     stride_kv, kernel, eps: float):
    """Multi-head pooling attention of one block's qkv rows.

    ``qkv``: (N, 1 + T x H x W, 3C), the grid ``size`` (T, H, W);
    ``params``: the layer's ``pool_{q,k,v}.w`` (d, 1, *kernel),
    ``norm_{q,k,v}.gamma`` / ``.beta`` (d,) and ``rel_pos_t`` / ``_h`` /
    ``_w``; q pooled with ``stride_q``, k and v with ``stride_kv``, each
    padded by kernel // 2.  Returns the output rows before the projection,
    (N, 1 + T' x H' x W', C), and q's grid (T', H', W')."""
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or any(t.requires_grad for t in params.values())):
        raise NotImplementedError("pooled_attention is serving-only: it adds the residual "
                                  "pooling in place, which a gradient cannot pass")
    n, _, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    with span("eco.qkv_pool"):
        q, k, v, q_size, k_size = pool_qkv(qkv, params, heads=heads, size=size,
                                           stride_q=stride_q, stride_kv=stride_kv,
                                           kernel=kernel, eps=eps)
    lq, lk = q.shape[1], k.shape[1]
    width = position_width(k_size, d)
    tables = tuple(params[f"rel_pos_{a}"] for a in "thw")
    _count_core(n, heads, lq, lk, d, width, q_size, k_size, sum(t.shape[0] for t in tables),
                q.element_size())
    with span("eco.pattn"):
        qa = torch.cat([q, position_columns(q, tables, q_size, k_size)], dim=-1)
        cols = key_columns(tuple(k_size), width, k.dtype, k.device)
        ka = torch.cat([k, cols.view(1, lk, 1, width).expand(n, lk, heads, width)], dim=-1)
        out = F.scaled_dot_product_attention(qa.transpose(1, 2), ka.transpose(1, 2),
                                             v.transpose(1, 2), scale=d ** -0.5)
        out = out.transpose(1, 2).contiguous()                         # n, lq, heads, d
        out[:, 1:] += q[:, 1:]
        return out.view(n, lq, c), q_size


def pool_skip(x: torch.Tensor, *, size, kernel, stride, pad) -> torch.Tensor:
    """The skip path's max pool of (N, 1 + T x H x W, C) rows over the grid
    ``size``, floor mode with a symmetric ``pad`` (the published
    ``MaxPool3d``), the class token passed through: (N, 1 + T' x H' x W',
    C).  ``pool_nd`` pools in Caffe's ceil mode, whose windows start where
    the floor mode's do and may add one past them on an axis: the first
    ``pooled_size`` windows are the published pool's."""
    n, _, c = x.shape
    out_size = pooled_size(size, kernel, stride, pad)
    # contiguous, as K4 takes it: the rows past the class token are a view
    grid = x[:, 1:].contiguous().view(n, *size, c)
    pooled = pool_nd(grid, kernel=kernel, stride=stride, pad=pad, mode="max")
    out = torch.empty((n, 1 + math.prod(out_size), c), dtype=x.dtype, device=x.device)
    out[:, :1] = x[:, :1]
    out[:, 1:].view(n, *out_size, c).copy_(
        pooled[:, :out_size[0], :out_size[1], :out_size[2]])
    return out


def prepend_token(x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) grid -> (N, 1 + T x H x W, C) rows, ``token`` (C,)
    in front."""
    n, c = x.shape[0], x.shape[-1]
    return torch.cat([token.to(x.dtype).view(1, 1, c).expand(n, 1, c), x.reshape(n, -1, c)],
                     dim=1)
