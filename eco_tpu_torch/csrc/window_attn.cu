// K6: the shifted-window multi-head attention of a Video Swin block, read
// from the block's qkv tokens and written back to its output tokens, in one
// kernel.
//
// Replaces no TPU kernel.  It replaces ops/attention.py's route on the card
// (ops/attention.py:window_attention_reference): the shift and partition
// copies (an unshifted block's permuting copy, a shifted block's gather of
// whole heads), the bias and mask gathered from the table into a (1, heads
// [x windows], L, L) tensor, the library's fused attention over it, and the
// reverse copies.
//
// Input : qkv (N, T, H, W, 3C) contiguous, bf16 or f16, channels (q, k, v)
//         x heads x 32 as the published qkv linear lays them out; the grid
//         a whole number of windows (wt, wh, ww) on each axis.  table
//         ((2Tt-1)(2Th-1)(2Tw-1), heads) contiguous f32: the
//         relative-position bias of the table window (Tt, Th, Tw).
// Output: (N, Ot, Oh, Ow, C) contiguous, in the input type, the grid cut
//         to (Ot, Oh, Ow) at the end of each axis.
//
// For clip n, window and head, with L = wt wh ww tokens in (t, h, w) order,
// window position p at rolled-grid coordinate x (the window's origin plus p
// unravelled in the window's shape) reads, and writes its output row to,
// the token (x + shift) mod the grid: the roll by -shift, the partition and
// their reverses are index arithmetic.  Its output row is
//   softmax_j(q_p . k_j / sqrt(32) + table[rel(p, j), head] + mask(p, j)) v_j
// where rel(p, j) = pos(p) - pos(j) + (rows - 1) / 2, pos the flat index
// unravelled in the table window's shape, (a, b, c) -> (a (2Th-1) + b)
// (2Tw-1) + c: ops/attention.py:relative_position_index's rule, which a
// clipped window reads at its first L rows and columns; and mask(p, j) is
// -100 where the two tokens' regions differ, a region being, on each axis,
// 0, 1 or 2 as x < G - w, x < G - s, or neither (ops/attention.py:
// window_indices holds this arithmetic in plain PyTorch; shift_mask labels
// regions the same way).  The products accumulate in f32, the scale, bias
// and mask are added in f32, the softmax is online in f32 (base 2, the
// table scaled by log2 e as it is staged); the weights go to the input
// type for the product with v, which accumulates in f32; the row is
// divided by its sum and written once.
//
// What bounds it on Hopper: at Swin-B's shapes (d = 32, L = 392) the least
// bytes (q, k, v read once, the output written once: 4.8 GB a request of 12
// clips, 1.43 ms at 3.35 TB/s) and the tensor work (0.94 TFLOP, 0.95 ms at
// 989 TFLOP/s) are close, and the work per logit outside the tensor cores
// (7.3e9 logits a request) is as heavy: a bias lookup, the scale, mask and
// max, an exponential (1.8 ms at the SFU's 16 a cycle an SM) and the sums.
// The design:
//   * a block per (clip, window, head), 5 warps, 3 blocks an SM; it first
//     computes each window position's token, output token, table offset and
//     region once into shared memory, stages the head's column of the table
//     (scaled by log2 e, in f32), and gathers the window's K and V rows (64
//     bytes each) by index with cp.async, zero rows padding L to whole
//     16-key steps, swizzled by 16-byte chunk so that ldmatrix reads them
//     without bank conflicts: the bias is one shared-memory load a logit,
//     at (query offset - key offset), and no (heads x windows, L, L) tensor
//     exists;
//   * a warp takes 16 query rows at a time (392 rows: 25 tiles, 5 a warp),
//     its q read from the tokens straight into the mma A fragments, the next
//     tile's while this one runs; mma.sync m16n8k16 for q k^T and for p v,
//     the weights passed from the accumulators to the A operand in
//     registers, over keys in steps of 64 and a tail of 16-key steps;
//   * the running max is raised, and the sums rescaled, only when a row's
//     max grows by more than 2^8 (any row of the warp): the weights stay
//     below 256, and the rescaling is rare after the first step; the maxima
//     and sums of a step are trees, not chains;
//   * a window whose tokens are all of one region (every window of an
//     unshifted block, the interior ones of a shifted block) skips the mask;
//   * each lane stores its rows' output pairs to their tokens; rows of
//     tokens cut off by the crop are not stored.
// Measured (chip_smoke.py, an H100 SXM at 700 W): 6.4 ms over a request's
// 24 blocks, 25% of the bound; the route it replaces 24.4 ms.  What holds
// it there: blocks on an SM start and end together, so each wave gathers
// its windows (~1.7 ms of the 6.4 in all) while no logit is computed, then
// computes while the memory idles; a persistent kernel that gathers the
// next window while it computes this one is the next step.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 32;              // head width: 64 bytes a row, 4 chunks of 16
constexpr int kWarps = 5;           // 25 tiles of 16 query rows at L = 392: 5 a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocks = 3;          // blocks an SM: 3 x 68 KB of shared memory
constexpr int kStep = 8;            // 8-key tiles a step: 64 keys
constexpr int kMaxLength = 1024;    // ops/attention.py:MAX_LENGTH
constexpr int kMaxTableRows = 8192; // ops/attention.py:MAX_TABLE_ROWS
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskLog2 = -100.0f * kLog2e;  // the published mask, in base 2
constexpr float kLazy = 8.0f;       // log2 of the largest weight before a rescale

struct Geom {
  int t, h, w;        // the qkv grid
  int c;              // q's channels: heads x 32; a token has 3c
  int heads;
  int wt, wh, ww;     // window
  int st, sh, sw;     // shift
  int tt, th, tw;     // table window
  int ot, oh, ow;     // output grid (the crop)
  int length;         // L = wt wh ww
  int padded;         // L rounded up to 16
  int windows;        // windows a clip
  int table_rows;
  float scale;        // log2(e) / sqrt(32)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ``chunk`` (0-3) of 64-byte row ``row``: the
// chunk index XOR-ed with (row / 2) % 4, so that the 8 rows an ldmatrix
// matrix reads (or a warp's 4-byte stores touch) fall in 8 distinct bank
// groups
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// the rolled-grid origin of window ``win``, windows in (t, h, w) order
__device__ __forceinline__ void window_origin(const Geom& g, int win, int& t0, int& h0,
                                              int& w0) {
  const int nw = g.w / g.ww, nh = g.h / g.wh;
  w0 = (win % nw) * g.ww;
  win /= nw;
  h0 = (win % nh) * g.wh;
  t0 = (win / nh) * g.wt;
}

__device__ __forceinline__ int axis_region(int x, int grid, int window, int shift) {
  return x < grid - window ? 0 : (x < grid - shift ? 1 : 2);
}

struct Token {
  int t, h, w;  // in the qkv grid
  int region;   // 0-26
};

// the token that window position ``p`` reads and writes, and its region
__device__ __forceinline__ Token token(const Geom& g, int t0, int h0, int w0, int p) {
  const int pw = p % g.ww;
  const int r = p / g.ww;
  const int xt = t0 + r / g.wh, xh = h0 + r % g.wh, xw = w0 + pw;
  Token k;
  k.region = (axis_region(xt, g.t, g.wt, g.st) * 3 + axis_region(xh, g.h, g.wh, g.sh)) * 3 +
             axis_region(xw, g.w, g.ww, g.sw);
  k.t = xt + g.st >= g.t ? xt + g.st - g.t : xt + g.st;
  k.h = xh + g.sh >= g.h ? xh + g.sh - g.h : xh + g.sh;
  k.w = xw + g.sw >= g.w ? xw + g.sw - g.w : xw + g.sw;
  return k;
}

// pos(p): p unravelled in the table window's shape, as a table row offset
__device__ __forceinline__ int table_pos(const Geom& g, int p) {
  const int c = p % g.tw;
  const int r = p / g.tw;
  return ((r / g.th) * (2 * g.th - 1) + r % g.th) * (2 * g.tw - 1) + c;
}


// what a block keeps in shared memory
struct Shared {
  uint32_t k, v;       // K and V rows, swizzled (shared-space addresses)
  const int* src;      // per window position: its token in the qkv grid
  const int* dst;      // its token in the output grid, or -1 where cropped
  const int4* keys;    // per pair of positions: {table offset x 4, region} of each
  const char* table;   // the head's column, f32, scaled by log2 e
};

// one step of NT 8-key tiles from key k0 for the warp's 16 rows: logits,
// online softmax, and the weights times v into ``o``
template <typename T, int NT, bool kMasked, bool kTail>
__device__ __forceinline__ void step(const Geom& g, const Shared& sh, int k0, int lane,
                                     const uint32_t (&qa)[2][4], const int (&qoff)[2],
                                     const int (&qreg)[2], float (&o)[4][4], float (&m)[2],
                                     float (&l)[2]) {
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t kb[4];
    ldsm_x4(kb, sh.k + swz(k0 + 8 * j + (lane & 7), lane >> 3));
    Mma<T>::first(s[j], qa[0], kb[0], kb[1]);
    Mma<T>::run(s[j], qa[1], kb[2], kb[3]);
  }
  // logits in base 2: scale, bias, mask; each row's max by a tree
  float tmax[2][NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int key = k0 + 8 * j + 2 * (lane & 3);
    const int4 kk = sh.keys[key >> 1];  // {offset, region} of key and key + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, e = i & 1;
      float x = s[j][i] * g.scale +
                *reinterpret_cast<const float*>(sh.table + (qoff[r] - (e ? kk.z : kk.x)));
      if (kMasked && (e ? kk.w : kk.y) != qreg[r]) x += kMaskLog2;
      if (kTail && key + e >= g.length) x = -INFINITY;
      s[j][i] = x;
    }
    tmax[0][j] = fmaxf(s[j][0], s[j][1]);
    tmax[1][j] = fmaxf(s[j][2], s[j][3]);
  }
  bool grow = false;
  float cmax[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int w = 1; w < NT; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < NT; j += 2 * w) tmax[r][j] = fmaxf(tmax[r][j], tmax[r][j + w]);
    }
    cmax[r] = fmaxf(tmax[r][0], __shfl_xor_sync(0xffffffffu, tmax[r][0], 1));
    cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
    grow |= cmax[r] > m[r] + kLazy;
  }
  if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], cmax[r]);
      const float f = ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= f;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        o[dt][2 * r] *= f;
        o[dt][2 * r + 1] *= f;
      }
    }
  }
  // the weights, and each row's sum by a tree
  float tsum[2][NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = ex2(s[j][i] - m[i >> 1]);
    tsum[0][j] = s[j][0] + s[j][1];
    tsum[1][j] = s[j][2] + s[j][3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int w = 1; w < NT; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < NT; j += 2 * w) tsum[r][j] += tsum[r][j + w];
    }
    l[r] += tsum[r][0];
  }
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t v0[4], v1[4];
    const int vrow = k0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4_t(v0, sh.v + swz(vrow, lane >> 4));
    ldsm_x4_t(v1, sh.v + swz(vrow, 2 + (lane >> 4)));
    const uint32_t a[4] = {
        Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
        Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
        Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
    };
    Mma<T>::run(o[0], a, v0[0], v0[1]);
    Mma<T>::run(o[1], a, v0[2], v0[3]);
    Mma<T>::run(o[2], a, v1[0], v1[1]);
    Mma<T>::run(o[3], a, v1[2], v1[3]);
  }
}

// q of the 16 rows from ``row0`` as the A operand, straight from the qkv
// tokens: a lane's rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + 8 k
template <typename T>
__device__ __forceinline__ void load_q(const Geom& g, const Shared& sh, const T* __restrict__ src,
                                       int row0, int lane, uint32_t (&qa)[2][4]) {
  const long long c3 = 3LL * g.c;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + 8 * r + (lane >> 2);
    const bool valid = p < g.length;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(
        src + (valid ? sh.src[p] : 0) * c3 + 2 * (lane & 3));
#pragma unroll
    for (int k = 0; k < 4; ++k) qa[k >> 1][2 * (k & 1) + r] = valid ? __ldg(row + 4 * k) : 0u;
  }
}

// the warp's 16 query rows from ``row0`` against every key; each lane
// stores its two rows' output pairs
template <typename T, bool kMasked>
__device__ __forceinline__ void rows(const Geom& g, const Shared& sh, T* __restrict__ out,
                                     int row0, int lane, const uint32_t (&qa)[2][4]) {
  const int centre4 = 4 * ((g.table_rows - 1) / 2);
  int qoff[2], qreg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + 8 * r + (lane >> 2);
    const int2 info = reinterpret_cast<const int2*>(sh.keys)[p < g.length ? p : 0];
    qoff[r] = p < g.length ? info.x + centre4 : centre4;
    qreg[r] = p < g.length ? info.y : -1;
  }
  float o[4][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  }
  const int whole = g.length / (8 * kStep);
  for (int c = 0; c < whole; ++c) {
    step<T, kStep, kMasked, false>(g, sh, 8 * kStep * c, lane, qa, qoff, qreg, o, m, l);
  }
  for (int k0 = 8 * kStep * whole; k0 < g.padded; k0 += 16) {
    step<T, 2, kMasked, true>(g, sh, k0, lane, qa, qoff, qreg, o, m, l);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int p = row0 + 8 * r + (lane >> 2);
    const int tok = p < g.length ? sh.dst[p] : -1;
    if (tok < 0) continue;
    const float inv = 1.f / l[r];
    T* row = out + static_cast<long long>(tok) * g.c + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      *reinterpret_cast<uint32_t*>(row + 8 * dt) =
          Mma<T>::pack(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
    window_attn_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                       T* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) char smem[];
  char* ks = smem;
  char* vs = ks + g.padded * 64;
  int2* keys = reinterpret_cast<int2*>(vs + g.padded * 64);
  int* src_tok = reinterpret_cast<int*>(keys + g.padded);
  int* dst_tok = src_tok + g.padded;
  float* tab = reinterpret_cast<float*>(dst_tok + g.padded);

  int b = blockIdx.x;
  const int head = b % g.heads;
  b /= g.heads;
  const int win = b % g.windows;
  const int n = b / g.windows;
  int t0, h0, w0;
  window_origin(g, win, t0, h0, w0);

  // each window position's tokens, table offset and region, once
  const int region0 = token(g, t0, h0, w0, 0).region;
  int mixed = 0;
  for (int p = threadIdx.x; p < g.padded; p += kThreads) {
    int src = 0, dst = -1, off = 0, region = region0;
    if (p < g.length) {
      const Token k = token(g, t0, h0, w0, p);
      src = ((n * g.t + k.t) * g.h + k.h) * g.w + k.w;
      if (k.t < g.ot && k.h < g.oh && k.w < g.ow) {
        dst = ((n * g.ot + k.t) * g.oh + k.h) * g.ow + k.w;
      }
      off = 4 * table_pos(g, p);
      region = k.region;
    }
    src_tok[p] = src;
    dst_tok[p] = dst;
    keys[p] = make_int2(off, region);
    mixed |= region != region0;
  }
  // the head's column of the table, in base 2
  for (int r0 = 0; r0 < g.table_rows; r0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * kThreads + threadIdx.x;
      v[i] = r < g.table_rows ? __ldg(table + static_cast<long long>(r) * g.heads + head) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * kThreads + threadIdx.x;
      if (r < g.table_rows) tab[r] = v[i] * kLog2e;
    }
  }
  mixed = __syncthreads_or(mixed);

  // K and V of the window, gathered by index: 4 lanes a key, 16 bytes each
  const T* src = qkv + head * kD;
  const long long c3 = 3LL * g.c;
  for (int i = threadIdx.x; i < 4 * g.padded; i += kThreads) {
    const int j = i >> 2, chunk = i & 3;
    const bool valid = j < g.length;
    const T* row = src + (valid ? src_tok[j] : 0) * c3 + chunk * 8;
    cp_async16(smem_u32(ks + swz(j, chunk)), row + g.c, valid);
    cp_async16(smem_u32(vs + swz(j, chunk)), row + 2 * g.c, valid);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Shared sh{smem_u32(ks), smem_u32(vs), src_tok, dst_tok,
                  reinterpret_cast<const int4*>(keys), reinterpret_cast<const char*>(tab)};
  uint32_t qa[2][4];
  load_q(g, sh, src, 16 * warp, lane, qa);
  cp_async_wait_all();
  __syncthreads();

  T* dst = out + head * kD;
  for (int row0 = 16 * warp; row0 < g.length; row0 += 16 * kWarps) {
    uint32_t next[2][4];  // the warp's next rows' q, loaded while these run
    if (row0 + 16 * kWarps < g.length) load_q(g, sh, src, row0 + 16 * kWarps, lane, next);
    if (mixed) {
      rows<T, true>(g, sh, dst, row0, lane, qa);
    } else {
      rows<T, false>(g, sh, dst, row0, lane, qa);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[k][i] = next[k][i];
    }
  }
}

size_t smem_bytes(const Geom& g) {
  return static_cast<size_t>(g.padded) * (2 * 64 + 16) + static_cast<size_t>(g.table_rows) * 4;
}

template <typename T>
int launch(const void* qkv, const float* table, void* out, const Geom& g, long long blocks,
           cudaStream_t stream) {
  auto kernel = window_attn_kernel<T>;
  const size_t smem = smem_bytes(g);
  static size_t allowed = 0;  // dynamic shared memory the kernel was allowed so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), table, static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// Plain C entry point, bound with ctypes.  qkv (n, t, h, w, 3 heads 32) and
// out (n, ot, oh, ow, heads 32) of ``elem_kind`` (1 bf16, 2 f16), the table
// ((2tt-1)(2th-1)(2tw-1), heads) in f32; window (wt, wh, ww), shift (st,
// sh, sw), table window (tt, th, tw).  Returns cudaGetLastError() after the
// launch (0 on success); a geometry it does not take (a grid not a whole
// number of windows, a shift not under the window, an output larger than
// the grid, a window longer than kMaxLength or than its table window, a
// table over kMaxTableRows, a grid of 2^31 tokens or more, an unaligned
// pointer) returns cudaErrorInvalidValue and launches nothing.
extern "C" int eco_window_attention(const void* qkv, const float* table, void* out, int n,
                                    int t, int h, int w, int heads, int wt, int wh, int ww,
                                    int st, int sh, int sw, int tt, int th, int tw, int ot,
                                    int oh, int ow, int elem_kind, void* stream) {
  const bool bad =
      n < 0 || t < 1 || h < 1 || w < 1 || heads < 1 || wt < 1 || wh < 1 || ww < 1 ||
      t % wt || h % wh || w % ww || st < 0 || sh < 0 || sw < 0 || st >= wt || sh >= wh ||
      sw >= ww || ot < 1 || oh < 1 || ow < 1 || ot > t || oh > h || ow > w || tt < 1 ||
      th < 1 || tw < 1 || wt * wh * ww > tt * th * tw || wt * wh * ww > kMaxLength ||
      (2 * tt - 1) * (2 * th - 1) * (2 * tw - 1) > kMaxTableRows ||
      static_cast<long long>(n) * t * h * w >= INT32_MAX ||
      (elem_kind != 1 && elem_kind != 2) || reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(table) % 4;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const long long windows = static_cast<long long>(t / wt) * (h / wh) * (w / ww);
  const long long blocks = n * windows * heads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const int length = wt * wh * ww;
  Geom g{t, h, w, heads * kD, heads, wt, wh, ww, st, sh, sw, tt, th, tw, ot, oh, ow,
         length, (length + 15) / 16 * 16, static_cast<int>(windows),
         (2 * tt - 1) * (2 * th - 1) * (2 * tw - 1),
         static_cast<float>(1.4426950408889634 / 5.656854249492381)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_kind == 1 ? launch<__nv_bfloat16>(qkv, table, out, g, blocks, s)
                        : launch<__half>(qkv, table, out, g, blocks, s);
}
