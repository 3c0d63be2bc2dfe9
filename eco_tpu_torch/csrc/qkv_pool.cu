// K7: the q, k and v pooling of an MViTv2 block, read from the block's qkv
// rows and written as the normed rows the attention core takes, in one
// kernel.
//
// Replaces no TPU kernel.  It was added because the route it replaces on
// the card (ops/pooled_attention.py:pool_qkv_route) made four passes over
// the qkv rows for work that needs one: a (3, N, C, T, H, W) layout copy of
// the grid, PyTorch's depthwise 3D conv for each of q, k and v, a concat of
// each with its class token's row, and a layer norm of each (about 22
// launches and 35 ms a request of 10 MViTv2-B clips on an H100).
//
// Input : qkv (N, 1 + T x H x W, 3C) contiguous, bf16 or f16, channels
//         (q, k, v) x heads x d as the published qkv linear lays them out,
//         a class token's row first, then the (T, H, W) grid in (t, h, w)
//         order.  For each of q, k and v: the depthwise kernel (d, 1, 3, 3,
//         3), gamma and beta (d,), f32, contiguous; one kernel serves every
//         head.
// Output: q (N, 1 + T x Hq x Wq, heads, d), k and v (N, 1 + T x Hk x Wk,
//         heads, d), contiguous, in the input type: row 0 the class token's
//         row normed, then the pooled grid normed.
//
// For each of q, k and v with its stride (1, s, s), s in {1, 2, 4, 8}, pad
// 1 on every axis: out[t, i, j] = sum over the 27 taps (a, b, e) of
// w[a, b, e] * x[t - 1 + a, i s - 1 + b, j s - 1 + e], zero outside the
// grid (PyTorch's floor mode: Hq = (H - 1) / s + 1); then each row and head
// normed over d: (y - mean) / sqrt(var + eps) * gamma + beta.  The sums,
// the mean and the (biased) variance are f32, gamma and beta f32, and the
// row is rounded once to the output type (the route rounds the conv's
// output and gamma and beta to it; ops/pooled_attention.py:pool_qkv_plain
// holds this arithmetic in plain PyTorch).
//
// What bounds it on Hopper: bytes.  Each qkv row some window taps read once
// (the class token's too) and each output row written once is 3.60 GB a
// request of 10 MViTv2-B clips, 1.07 ms at 3.35 TB/s; the 27 products of
// each output value are 31 GFLOP, 0.47 ms at the CUDA cores' 67 TFLOP/s in
// f32, and the instructions around them (loads, conversions, the norm)
// take about as long again.  The design:
//   * a block per (q, k or v; clip; head; tile of output positions along H
//     and W; stretch of T) of d / 8 summing warps (12 at d = 96) and 8 norm
//     warps, one block an SM (96 registers a thread); one launch covers q,
//     k and v, each part with its own stride;
//   * summing warp w sums the head's channels 8w .. 8w + 7, lane l output
//     positions l and l + 32 of the tile, so that every lane works, a
//     warp's weights are one broadcast read of shared memory for both
//     positions, and a lane's input is one 16-byte read a tap a position;
//   * each input frame's rows of the tile, halo included, are staged once
//     in shared memory by cp.async (16 bytes a copy, zero-filled outside
//     the grid: the padding is by index), the next frame's (at stride 1 the
//     next two's) while this one is summed; at a stride of 3 or more only
//     the rows a window taps are staged (20 of 56 along H and W at s = 8);
//     a staged row is padded by 16 bytes so that a warp's reads at stride 1
//     and 3 fall in distinct banks;
//   * T's stride is 1 and its window 3, so an input frame adds to three
//     output frames at once: three rows of f32 partial sums a position in
//     registers, each input value converted once and used for its three
//     taps along T; after frame t the output frame t - 1 is whole, and the
//     sums move down a row;
//   * the whole frame's sums go to shared memory, position-major, in f32,
//     two buffers handed between the summing and the norm warps by named
//     barriers ("full", "empty"), so that the norms of one frame run while
//     the next is summed; a norm warp's 16-lane group takes two positions
//     at once (lane k their channels 8k ..), norms them with shuffles
//     (Chan's formula for the mean and variance, level by level) and stores
//     each head's d values as one contiguous row of 16-byte stores (each
//     summing lane storing its own 16 bytes of 32 positions' rows, 192
//     bytes apart, ran the kernel at half the speed: each store then writes
//     half of a 32-byte sector);
//   * the tile: 8 x 8 or 4 x 16 positions at s <= 2, 2 x 16 (one a lane)
//     at s = 1, 4 x 8 at s >= 4, whichever covers least of the output grid
//     (the host picks it; a staged frame is at most 297 rows); the host
//     splits T into 1, 2 or 4 stretches (each re-reading a frame at either
//     end), whichever wastes least of the blocks the card holds at once;
//   * the weights (27 x d, tap-major), gamma and beta sit in shared memory;
//     the class token's row is normed by the first norm warp of the first
//     block of each part, clip and head.
// Measured (chip_smoke.py's check_qkv_pool_kernel, an H100 SXM at 700 W):
// 4.02 ms over a request's 24 blocks, 27% of the bound; the route it
// replaces 34.9 ms.  What holds it there: the summing warps' weights, read
// as broadcasts (~2.5 cycles of shared memory each, 54 a frame for two
// positions), and the norm warps' dependent chains each take about a step;
// with 96 registers a thread the compiler still spills a little, and one
// block an SM hides little of either.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 96;                 // ops/pooled_attention.py:MAX_HEAD_DIM
constexpr int kNormWarps = 8;            // warps that norm and store, beside d / 8 that sum
constexpr int kMaxThreads = 32 * (kMaxD / 8 + kNormWarps);
constexpr int kTaps = 27;
constexpr int kRowPad = 8;                // elements after each staged row
constexpr int kPositions = 64;            // output positions a tile holds at most
constexpr int kOutLen = kMaxD + 4;        // floats a position's row of the output tile

struct Part {
  void* out;           // (N, 1 + T x ho x wo, heads, d)
  const float* w;      // (d, 27)
  const float* gamma;  // (d,)
  const float* beta;   // (d,)
  int stride;          // along H and W
  int shape;           // the tile's shape: an index of kShapes
  int ho, wo;          // the output grid's H and W (T is kept)
  int tiles_w;         // tiles along W
  int tiles;           // tiles a (clip, head)
  int first;           // the part's first block
};

struct Geom {
  const void* qkv;
  int t, h, w, heads, d;
  int tc, chunks;      // output frames a block, stretches of T
  float eps;
  Part part[3];
};

// the tiles of output positions (rows x columns of the output grid) a
// block may take: 64 positions (two a summing lane) at s <= 2, 32 (one) at
// s = 1 where that covers less of the grid, and at s >= 4, where each
// position stages nine rows of its own
struct Shape {
  int rows, cols;
};
constexpr Shape kShapes[] = {{8, 8}, {4, 16}, {2, 16}, {4, 8}};

// a tile of R x C positions at stride S, the staged rows it needs, and the
// staged frames
template <int S, int R, int C> struct Tile {
  static constexpr int kRows = R, kCols = C, kTile = R * C, kPer = kTile / 32;
  static constexpr int kStep = S < 3 ? S : 3;   // staged rows an output position adds
  static constexpr int kFh = (kRows - 1) * kStep + 3;
  static constexpr int kFw = (kCols - 1) * kStep + 3;
  static constexpr int kRing = S == 1 ? 3 : 2;  // staged frames
};

bool shape_ok(int s, int shape) { return s <= 2 ? shape <= 1 || (s == 1 && shape == 2) : shape == 3; }
int ring(int s) { return s == 1 ? 3 : 2; }
int staged_rows(int s, int shape) {
  const int step = s < 3 ? s : 3;
  return ((kShapes[shape].rows - 1) * step + 3) * ((kShapes[shape].cols - 1) * step + 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// named barriers (0 is __syncthreads): the summing warps' own, and for each
// of the two output-sum buffers "full" (summing warps arrive, norm warps
// wait) and "empty" (the other way round)
constexpr int kBarSum = 1, kBarFull = 2, kBarEmpty = 4;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const uint4& v, float (&x)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Vec<__half> {
  static __device__ __forceinline__ void load(const uint4& v, float (&x)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// The mean and the sum of squared deviations of two rows (x, y) of 16 lanes
// x 8 values, the lanes not ``active`` holding none: each lane's own
// (count, means, sums), then merged across the lanes level by level
// (xor 8, 4, 2, 1) by Chan's formula; the two rows' shuffles of a level are
// independent of each other.
struct Moments {
  float cnt, mx, vx, my, vy;
};

__device__ __forceinline__ Moments local_moments(const float (&x)[8], const float (&y)[8],
                                                 bool active) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sx += x[j];
    sy += y[j];
  }
  Moments m{active ? 8.f : 0.f, active ? sx * 0.125f : 0.f, 0.f, active ? sy * 0.125f : 0.f,
            0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m.vx += (x[j] - m.mx) * (x[j] - m.mx);
    m.vy += (y[j] - m.my) * (y[j] - m.my);
  }
  if (!active) m.vx = m.vy = 0.f;
  return m;
}

__device__ __forceinline__ void merge_moments(Moments& m, int o) {
  const float cb = __shfl_xor_sync(0xffffffffu, m.cnt, o);
  const float mxb = __shfl_xor_sync(0xffffffffu, m.mx, o);
  const float vxb = __shfl_xor_sync(0xffffffffu, m.vx, o);
  const float myb = __shfl_xor_sync(0xffffffffu, m.my, o);
  const float vyb = __shfl_xor_sync(0xffffffffu, m.vy, o);
  const float total = m.cnt + cb;
  const float share = __fdividef(cb, fmaxf(total, 1.f));  // the other's share
  const float dx = mxb - m.mx, dy = myb - m.my;
  m.mx += dx * share;
  m.my += dy * share;
  m.vx += vxb + dx * dx * m.cnt * share;
  m.vy += vyb + dy * dy * m.cnt * share;
  m.cnt = total;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// 8 values normed with their mean and rstd, gamma and beta applied, packed
template <typename T>
__device__ __forceinline__ uint4 affine8(const float (&x)[8], float mean, float rstd,
                                         const float* g, const float* b) {
  float gg[8], bb[8], y[8];
  load8(g, gg);
  load8(b, bb);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = (x[j] - mean) * rstd * gg[j] + bb[j];
  return make_uint4(Vec<T>::pack(y[0], y[1]), Vec<T>::pack(y[2], y[3]),
                    Vec<T>::pack(y[4], y[5]), Vec<T>::pack(y[6], y[7]));
}

// the input row (along H or W) of staged row ``j`` of a tile whose first
// output row is ``o0``
template <int S>
__device__ __forceinline__ int staged_to_input(int o0, int j) {
  return S <= 3 ? o0 * S - 1 + j : (o0 + j / 3) * S - 1 + j % 3;
}

template <typename T, int S, int R, int C>
__device__ __forceinline__ void pool_part(const Geom& g, const Part& pt, int part, int block,
                                          char* smem) {
  using Tl = Tile<S, R, C>;
  constexpr int kFw = Tl::kFw, kSlots = Tl::kFh * Tl::kFw, kTile = Tl::kTile, kPer = Tl::kPer;
  constexpr int kRing = Tl::kRing;
  const int d = g.d, nch = d / 8, c = g.heads * d, row_len = d + kRowPad;
  int rest = block;
  const int tile = rest % pt.tiles;
  rest /= pt.tiles;
  const int chunk = rest % g.chunks;
  rest /= g.chunks;
  const int head = rest % g.heads;
  const int n = rest / g.heads;
  const int h0 = (tile / pt.tiles_w) * Tl::kRows;  // the tile's first output row and column
  const int w0 = (tile % pt.tiles_w) * Tl::kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;  // < nch: sums the 8 channels 8 warp ..; else norms
  const int nthreads = nch * 32;      // the summing warps' threads
  const int all = nthreads + 32 * kNormWarps;

  float* w_s = reinterpret_cast<float*>(smem);  // (27, d), tap-major
  float* g_s = w_s + kTaps * d;
  float* b_s = g_s + d;
  float* o_s = b_s + d;  // 2 x (kPositions, kOutLen): the last two whole frames' sums
  T* x_s = reinterpret_cast<T*>(o_s + 2 * kPositions * kOutLen);  // kRing frames of kSlots rows

  for (int i = threadIdx.x; i < kTaps * d; i += all) {  // read in order, stored by tap
    const int k = i / kTaps, tap = i - k * kTaps;
    w_s[tap * d + k] = pt.w[i];
  }
  for (int i = threadIdx.x; i < d; i += all) {
    g_s[i] = pt.gamma[i];
    b_s[i] = pt.beta[i];
  }

  // this clip's grid rows of the part's head, and of its output
  const int in_row = 3 * c, hw = g.h * g.w, out_hw = pt.ho * pt.wo;
  const T* in = static_cast<const T*>(g.qkv) +
                static_cast<long long>(n) * (1 + static_cast<long long>(g.t) * hw) * in_row +
                part * c + head * d;
  T* out = static_cast<T*>(pt.out) +
           static_cast<long long>(n) * (1 + static_cast<long long>(g.t) * out_hw) * c + head * d;
  const int t0 = chunk * g.tc;
  const int steps = g.tc + 2;  // input frames t0 - 1 .. t0 + tc

  // a block has 32 threads a 16-byte chunk of a row: thread i copies chunk
  // i % nch of rows i / nch, i / nch + 32, ...
  const int stage_k = threadIdx.x % nch, stage_slot = threadIdx.x / nch;
  auto stage = [&](int step) {
    const int t = t0 - 1 + step;
    if (step >= steps || t < 0 || t >= g.t) return;
    T* dst = x_s + (step % kRing) * kSlots * row_len + stage_k * 8;
    const T* src = in + (1 + static_cast<long long>(t) * hw) * in_row + stage_k * 8;
    for (int slot = stage_slot; slot < kSlots; slot += 32) {
      const int hh = staged_to_input<S>(h0, slot / kFw);
      const int ww = staged_to_input<S>(w0, slot % kFw);
      const bool ok = hh >= 0 && hh < g.h && ww >= 0 && ww < g.w;
      cp_async16(smem_u32(dst + slot * row_len), ok ? src + (hh * g.w + ww) * in_row : in, ok);
    }
  };

  if (warp < nch) {
#pragma unroll
    for (int step = 0; step < kRing - 1; ++step) {
      stage(step);
      cp_async_commit();
    }
  }
  __syncthreads();  // the weights, gamma and beta

  if (tile == 0 && chunk == 0 && warp == nch) {  // the class token's row: lane k, channels 8k..
    const bool active = lane < nch;
    float x[8];
    uint4 v = make_uint4(0, 0, 0, 0);
    if (active) v = *reinterpret_cast<const uint4*>(in + lane * 8);
    Vec<T>::load(v, x);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += x[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / d;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) q += active ? (x[j] - mean) * (x[j] - mean) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const int k = active ? lane : 0;
    const uint4 y = affine8<T>(x, mean, rsqrtf(q / d + g.eps), g_s + k * 8, b_s + k * 8);
    if (active) *reinterpret_cast<uint4*>(out + lane * 8) = y;
  }

  // output frame f, whole, normed from its sums in shared memory: a
  // position by 16 lanes (lane k its channels 8k ..), two positions (p and
  // p + groups) a pass of a group, stored as whole rows
  const int groups = 2 * kNormWarps;
  const auto norm_store = [&](const float* sums, int f) {
    const int k = lane & 15;
    const bool active = k < nch;
    const int kc = active ? k : 0;
    for (int p = (threadIdx.x - nthreads) >> 4; p < kTile; p += 2 * groups) {
      float x[8], y[8];
      load8(sums + p * kOutLen + kc * 8, x);
      load8(sums + (p + groups < kTile ? p + groups : p) * kOutLen + kc * 8, y);
      Moments m = local_moments(x, y, active);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) merge_moments(m, o);
      const uint4 ox = affine8<T>(x, m.mx, rsqrtf(m.vx / d + g.eps), g_s + kc * 8, b_s + kc * 8);
      const uint4 oy = affine8<T>(y, m.my, rsqrtf(m.vy / d + g.eps), g_s + kc * 8, b_s + kc * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = p + i * groups;
        const int oh = h0 + q / Tl::kCols, ow = w0 + q % Tl::kCols;
        if (active && q < kTile && oh < pt.ho && ow < pt.wo)
          *reinterpret_cast<uint4*>(out + (1 + f * out_hw + oh * pt.wo + ow) * c + k * 8) =
              i == 0 ? ox : oy;
      }
    }
  };
  const auto mine = [&](int f) { return f >= t0 && f < t0 + g.tc && f < g.t; };

  if (warp >= nch) {
    // the norm warps: step j's whole output frame, t0 - 2 + j, from the
    // summing warps through o_s[j & 1], normed and stored; the buffer handed
    // back unless the summing warps are done with it
    for (int step = 0; step < steps; ++step) {
      bar_sync(kBarFull + (step & 1), all);
      if (mine(t0 - 2 + step)) norm_store(o_s + (step & 1) * kPositions * kOutLen, t0 - 2 + step);
      if (step + 2 < steps) bar_arrive(kBarEmpty + (step & 1), all);
    }
    return;
  }

  // the summing warps: partial sums of output frames t - 1, t and t + 1
  // while input frame t is read, for positions lane and lane + 32
  float a0[kPer][8], a1[kPer][8], a2[kPer][8];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) a0[p][j] = a1[p][j] = a2[p][j] = 0.f;

  const float* wbase = w_s + warp * 8;
  const T* xlane[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int q = lane + 32 * p;
    xlane[p] = x_s + warp * 8 +
               ((q / Tl::kCols) * Tl::kStep * kFw + (q % Tl::kCols) * Tl::kStep) * row_len;
  }
  for (int step = 0; step < steps; ++step) {
    const int t = t0 - 1 + step;
    cp_async_wait<kRing - 2>();
    // frame t is staged, and every summing thread is done with frame t - 1's
    // buffer
    bar_sync(kBarSum, nthreads);
    stage(step + kRing - 1);  // into frame t - 1's buffer
    cp_async_commit();
    if (t >= 0 && t < g.t) {
      const int frame = (step % kRing) * kSlots * row_len;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          float x[kPer][8], w[8];
#pragma unroll
          for (int p = 0; p < kPer; ++p)
            Vec<T>::load(*reinterpret_cast<const uint4*>(xlane[p] + frame + (b * kFw + e) * row_len),
                         x[p]);
          // this tap's weights at a = 2, 1, 0 (one broadcast read each, for
          // every position of the lane) into output frames t - 1, t and t + 1
          load8(wbase + (2 * 9 + b * 3 + e) * d, w);
#pragma unroll
          for (int p = 0; p < kPer; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j) a0[p][j] = fmaf(w[j], x[p][j], a0[p][j]);
          load8(wbase + (1 * 9 + b * 3 + e) * d, w);
#pragma unroll
          for (int p = 0; p < kPer; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j) a1[p][j] = fmaf(w[j], x[p][j], a1[p][j]);
          load8(wbase + (0 * 9 + b * 3 + e) * d, w);
#pragma unroll
          for (int p = 0; p < kPer; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j) a2[p][j] = fmaf(w[j], x[p][j], a2[p][j]);
        }
      }
    }
    // output frame t - 1 is whole: its sums to o_s[step & 1] once the norm
    // warps are done with what it held two steps ago
    if (step >= 2) bar_sync(kBarEmpty + (step & 1), all);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      float* o = o_s + (step & 1) * kPositions * kOutLen + (lane + 32 * p) * kOutLen + warp * 8;
      *reinterpret_cast<float4*>(o) = make_float4(a0[p][0], a0[p][1], a0[p][2], a0[p][3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(a0[p][4], a0[p][5], a0[p][6], a0[p][7]);
    }
    __threadfence_block();
    bar_arrive(kBarFull + (step & 1), all);
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a0[p][j] = a1[p][j];
        a1[p][j] = a2[p][j];
        a2[p][j] = 0.f;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) qkv_pool_kernel(const Geom g) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int b = blockIdx.x;
  const int part = b >= g.part[2].first ? 2 : b >= g.part[1].first ? 1 : 0;
  const Part pt = part == 0 ? g.part[0] : part == 1 ? g.part[1] : g.part[2];
  const int lb = b - pt.first;
  switch (pt.stride * 4 + pt.shape) {
    case 4: pool_part<T, 1, 8, 8>(g, pt, part, lb, smem); break;
    case 5: pool_part<T, 1, 4, 16>(g, pt, part, lb, smem); break;
    case 6: pool_part<T, 1, 2, 16>(g, pt, part, lb, smem); break;
    case 8: pool_part<T, 2, 8, 8>(g, pt, part, lb, smem); break;
    case 9: pool_part<T, 2, 4, 16>(g, pt, part, lb, smem); break;
    case 19: pool_part<T, 4, 4, 8>(g, pt, part, lb, smem); break;
    default: pool_part<T, 8, 4, 8>(g, pt, part, lb, smem); break;
  }
}


size_t smem_bytes(int d, int stride, int shape) {
  return (static_cast<size_t>(kTaps + 2) * d + 2 * kPositions * kOutLen) * sizeof(float) +
         static_cast<size_t>(ring(stride)) * staged_rows(stride, shape) * (d + kRowPad) * 2;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

bool stride_ok(int s) { return s == 1 || s == 2 || s == 4 || s == 8; }

// the area a tiling covers
long long covered(int ho, int wo, int rows, int cols) {
  return static_cast<long long>((ho + rows - 1) / rows * rows) * ((wo + cols - 1) / cols * cols);
}

template <typename T>
int launch(Geom& g, int n, cudaStream_t stream) {
  static cudaError_t configured = cudaFuncSetAttribute(  // s = 2 in 4 x 16 stages the most
      qkv_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxD, 2, 1)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  long long tiles = 0;
  size_t smem = 0;
  for (Part& p : g.part) {
    // the shape that covers least of the output grid, the larger tile on a tie
    const int s = p.stride;
    p.shape = -1;
    for (int k = 0; k < 4; ++k) {
      if (!shape_ok(s, k)) continue;
      if (p.shape < 0 || covered(p.ho, p.wo, kShapes[k].rows, kShapes[k].cols) <
                             covered(p.ho, p.wo, kShapes[p.shape].rows, kShapes[p.shape].cols))
        p.shape = k;
    }
    const Shape sh = kShapes[p.shape];
    p.tiles_w = (p.wo + sh.cols - 1) / sh.cols;
    p.tiles = (p.ho + sh.rows - 1) / sh.rows * p.tiles_w;
    tiles += static_cast<long long>(n) * g.heads * p.tiles;
    const size_t need = smem_bytes(g.d, s, p.shape);
    smem = need > smem ? need : smem;
  }
  if (tiles == 0) return 0;
  const int threads = (g.d / 8 + kNormWarps) * 32;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qkv_pool_kernel<T>, threads,
                                                    smem) != cudaSuccess || per_sm < 1)
    per_sm = 1;
  // T in 1, 2 or 4 stretches, whichever wastes least: each stretch sums one
  // frame more at either end, and the last wave of blocks may be short
  const double slots = static_cast<double>(per_sm) * sm_count();
  double best = -1.0;
  for (int chunks = 1; chunks <= 4; chunks *= 2) {
    const int tc = (g.t + chunks - 1) / chunks;
    if (chunks > 1 && tc < 4) break;
    const double waves = tiles * ((g.t + tc - 1) / tc) / slots;
    const double use = waves / std::ceil(waves) * tc / (tc + 2);
    if (use > best + 1e-9) {
      best = use;
      g.tc = tc;
    }
  }
  g.chunks = (g.t + g.tc - 1) / g.tc;
  long long blocks = 0;
  for (Part& p : g.part) {
    p.first = static_cast<int>(blocks);
    blocks += static_cast<long long>(n) * g.heads * p.tiles * g.chunks;
  }
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  qkv_pool_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k and v of one block; returns a CUDA error code, cudaErrorInvalidValue
// (launching nothing) for what the kernel does not take.
extern "C" int eco_qkv_pool(const void* qkv, const float* wq, const float* wk, const float* wv,
                            const float* gq, const float* gk, const float* gv, const float* bq,
                            const float* bk, const float* bv, void* out_q, void* out_k,
                            void* out_v, int n, int t, int h, int w, int heads, int d,
                            int stride_q, int stride_kv, float eps, int elem_kind,
                            void* stream) {
  const auto misaligned = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  const long long rows = 1 + static_cast<long long>(t) * h * w;  // a clip's
  const bool bad =
      n < 0 || t < 1 || h < 1 || w < 1 || heads < 1 || d < 8 || d > kMaxD || d % 8 ||
      !stride_ok(stride_q) || !stride_ok(stride_kv) || !(eps > 0.f) ||
      (elem_kind != 1 && elem_kind != 2) || n * rows >= INT32_MAX ||
      rows * 3 * heads * d >= INT32_MAX || misaligned(qkv, 16) || misaligned(out_q, 16) ||
      misaligned(out_k, 16) || misaligned(out_v, 16) || misaligned(wq, 4) ||
      misaligned(wk, 4) || misaligned(wv, 4) || misaligned(gq, 4) || misaligned(gk, 4) ||
      misaligned(gv, 4) || misaligned(bq, 4) || misaligned(bk, 4) || misaligned(bv, 4);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Geom g{qkv, t, h, w, heads, d, t, 1, eps, {}};
  const void* outs[3] = {out_q, out_k, out_v};
  const float* ws[3] = {wq, wk, wv};
  const float* gs[3] = {gq, gk, gv};
  const float* bs[3] = {bq, bk, bv};
  for (int i = 0; i < 3; ++i) {
    const int s = i == 0 ? stride_q : stride_kv;
    Part& p = g.part[i];
    p.out = const_cast<void*>(outs[i]);
    p.w = ws[i];
    p.gamma = gs[i];
    p.beta = bs[i];
    p.stride = s;
    p.ho = (h - 1) / s + 1;
    p.wo = (w - 1) / s + 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_kind == 1 ? launch<__nv_bfloat16>(g, n, s) : launch<__half>(g, n, s);
}
