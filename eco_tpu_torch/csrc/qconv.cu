// int8 x int8 -> int32 convolution with the dequant / requant epilogue fused.
//
// Replaces the XLA int8 convolution behind eco_tpu/ops/quant.py:69
// (conv_nd_int8: lax.conv_general_dilated with an int32 accumulator, then
// _epilogue).  It is not a Pallas kernel, but PyTorch has no int8
// convolution on CUDA, so the port writes it by hand.
//
// Input : x int8 (N, D, H, W, C_in) contiguous (1D and 2D convolutions come
//         in with D = 1, H = 1); weights int8 (C_out, kd, kh, kw, C_in/g)
//         contiguous; scale_vec f32 (C_out,) = act_scale * w_scale; bias f32
//         (C_out,) or null.
// Output: (N, Do, Ho, Wo, C_out) contiguous, one of
//           f32 / bf16 : y = f32(acc) * scale_vec[c] (+ bias[c])
//           int8       : clip(rint(y / out_scale), -127, 127)
//
// An implicit GEMM: rows M = N*Do*Ho*Wo (output pixels), columns C_out/g of
// one group, reduction K over (tap, channel).  A block owns a 128 x BN
// output tile (BN 32, 64 or 128) of one group and one K split; two warpgroups
// each multiply 64 of its rows on the int8 tensor cores with
// wgmma.mma_async m64nBNk32 s8.s8 -> s32, both operands read from shared
// memory, K-major, in the no-swizzle core-matrix layout (8 rows x 16 bytes
// per 128-byte core matrix, K-adjacent core matrices 128 bytes apart, 8-row
// groups BK*8 bytes apart).  A 16-byte chunk number i of a stage then sits
// at byte 16*i, so the copies that fill it are contiguous too.
//
// What bounds it on Hopper.  ECO's int8 layers reduce over K = 147-4608 at
// C_out 32-736: most are compute-bound at the int8 rate (1,979 TOP/s) if the
// tensor cores are kept fed, and conv1 (7x7/s2, C_in 3) and the 1x1 layers
// are bound by their bytes, mostly the output they write.  The design:
//  - loads run ahead of the math (VEC mode, C_in/g a multiple of 16): a
//    ring of shared-memory stages (4 of 64 bytes of K, or 8 of 32) is
//    filled with cp.async.cg 16-byte copies whose src-size 0 zero-fills
//    padding taps, rows past M, columns past C_out/g and the channel tail;
//    copies run two (or six) stages ahead, and one stage's wgmma stays in
//    flight while the next stage is waited for;
//  - about four blocks an SM (two fit at once), each walking its share of
//    the M tiles; the ring runs across tile boundaries, so the next tile's
//    first copies are in flight during a tile's last products and epilogue;
//  - no division in the K loop: each thread decomposes its rows once per
//    tile, and the loop walks (tap, channel chunk) with running counters;
//  - wgmma on 128 x BN tiles, BN 128, 64 or 32 after C_out/g;
//  - split-K where the tiles alone would not fill 132 SMs: each split writes
//    its exact int32 partial sums to a workspace and a second kernel adds
//    them (int32 adds are exact in any order) and applies the epilogue;
//  - the epilogue goes through shared memory: accumulators -> scaled values
//    in the output type -> 16-byte coalesced stores of whole tile rows;
//    scale_vec and bias are read once per column into shared memory;
//  - conv1 (SPAN mode, C_in*kw <= 32, one group, no dilation along W): a K
//    chunk is one (kz, ky) tap row, whose kw*C_in input bytes are contiguous
//    in NHWC; a thread loads them as aligned 32-bit words, realigns them with
//    funnel shifts, masks the image edges, and pads the row to 32 bytes with
//    zeros; the block's weights, padded the same way, are loaded into shared
//    memory once and the block walks many M tiles; two register-staged
//    stages keep the next row's loads in flight during the math;
//  - every other geometry (C_in/g not a multiple of 16, unaligned pointers,
//    groups or dilation that SPAN does not take) goes through GATHER mode:
//    bytes gathered one by one over the flat K, slower, same math.
// The tile, K-split and mode are chosen by the planner in ops/qconv.py.
// What holds it back now (measured on an H100, PERF.md): at 128-row tiles a
// stage brings 64 multiply-adds per byte from L2, below the ~180 the int8
// rate needs, and the implicit GEMM reads each input pixel again for every
// tap; the compute-bound layers reach 10-15% of the int8 peak.  Larger
// tiles, TMA multicast of the weights across a cluster, or reuse of an
// input halo across taps are the next levers.
//
// Bit-exactness with the plain version (ops/qconv.py): the accumulator is
// exact (|acc| <= 127*127*K < 2**31 for K <= 133,000; ECO's worst is
// 127^2*3*3*3*512 ~= 2.2e8), in any order of the sums; the epilogue uses
// __int2float_rn, __fmul_rn and __fadd_rn (no FMA contraction, as PyTorch's
// separate multiply and add), __fdiv_rn by out_scale (the plain version
// divides by a 0-d tensor), rintf (round half to even, as torch.round) and
// __float2bfloat16_rn.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;           // output pixels per tile
constexpr int kThreads = 256;      // two warpgroups, 64 rows each
constexpr int kSpanBK = 32;        // SPAN / GATHER bytes of K per chunk
constexpr int kMaxSpanB = 65536;   // SPAN: bytes of padded weights per block
constexpr int kMaxSmem = 200 * 1024;

enum Mode : int { kVec = 0, kSpan = 1, kGather = 2 };
enum OutKind : int { kF32 = 0, kBF16 = 1, kInt8 = 2, kPartial = 3 };

struct Geometry {
  int n, d, h, w, c_in, c_out, groups, cg, cog;
  int kd, kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int od, oh, ow;
  int k_total;          // kd * kh * kw * cg: one weight row
  long long m_total;    // n * od * oh * ow
  int chunks;           // K chunks of the whole reduction
  int chunks_per_split;
  int splits;
  int cpt;              // VEC: channel chunks per tap
  int out_kind;
  int has_bias;
  int vec_out;          // 16-byte output stores are aligned
  float out_scale;
};

// wgmma shared-memory descriptor, no swizzle: start address, K-direction
// core-matrix stride (LBO) and 8-row-group stride (SBO), all >> 4.
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// VEC ring depth: 8 stages of 32 bytes of K or 4 of 64 (64 KB with 128 x 128
// tiles; with a bf16 staging tile two blocks fit an SM; deeper rings for the
// narrower tiles measured slower on an H100)
__host__ __device__ constexpr int vec_stages(int bk) { return bk == 32 ? 8 : 4; }

// D (64 x 32, s32) += A (64 x 32, s8, K-major in shared) * B (32 x 32,
// s8, K-major in shared)^T.  One warpgroup; d is its 16 accumulators.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, s32) += A (64 x 32, s8, K-major in shared) * B (64 x 32,
// s8, K-major in shared)^T.  One warpgroup; d is its 32 accumulators.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, s32) += A (64 x 32, s8, K-major in shared) * B (128 x 32,
// s8, K-major in shared)^T.  One warpgroup; d is its 64 accumulators.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<32>(int (&d)[16], uint64_t da, uint64_t db) {
  wgmma_n32(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<64>(int (&d)[32], uint64_t da, uint64_t db) {
  wgmma_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_n128(d, da, db);
}

// Issues the products of one stage of BK bytes of K, without waiting: A is
// 128 rows, B is BN rows, each in the core-matrix layout; warpgroup wg
// multiplies rows 64*wg .. 64*wg + 63.
template <int BN, int BK>
__device__ __forceinline__ void mma_issue(int (&acc)[BN / 2], const int8_t* a, const int8_t* b,
                                          int wg) {
  constexpr uint32_t kLbo = 128, kSbo = BK * 8;
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    const uint64_t da = make_desc(a + wg * 8 * kSbo + ks * 256, kLbo, kSbo);
    const uint64_t db = make_desc(b + ks * 256, kLbo, kSbo);
    wgmma_tile<BN>(acc, da, db);
  }
}

// One stage, issued and waited for.
template <int BN, int BK>
__device__ __forceinline__ void mma_stage(int (&acc)[BN / 2], const int8_t* a, const int8_t* b,
                                          int wg) {
  wgmma_fence();
  mma_issue<BN, BK>(acc, a, b, wg);
  wgmma_commit();
  wgmma_wait<0>();
}

// Byte offset, in the core-matrix layout of a stage BK bytes deep, of the
// 16-byte chunk (row, kc).
template <int BK>
__device__ __forceinline__ int core_offset(int row, int kc) {
  return (row >> 3) * (BK * 8) + kc * 128 + (row & 7) * 16;
}

// Where one tile row (an output pixel) reads: its image and the input
// coordinates of tap (0, 0, 0).  valid is false past M.
struct RowOrigin {
  const int8_t* img;
  int iz0, iy0, ix0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const Geometry& g, const int8_t* x,
                                                long long m) {
  RowOrigin r{x, 0, 0, 0, false};
  if (m >= g.m_total) return r;
  long long q = m;
  const int ox = static_cast<int>(q % g.ow); q /= g.ow;
  const int oy = static_cast<int>(q % g.oh); q /= g.oh;
  const int oz = static_cast<int>(q % g.od); q /= g.od;
  r.img = x + q * g.d * g.h * static_cast<long long>(g.w) * g.c_in;
  r.iz0 = oz * g.sd - g.pd;
  r.iy0 = oy * g.sh - g.ph;
  r.ix0 = ox * g.sw - g.pw;
  r.valid = true;
  return r;
}

// Offset, from the row's image, of input element k (flat over tap,
// channel) of a row, or -1 where the tap falls in the padding or k is past
// the reduction.  GATHER only.
__device__ __forceinline__ long long gather_offset(const Geometry& g, const RowOrigin& r,
                                                   int grp, int k) {
  if (!r.valid || k >= g.k_total) return -1;
  const int tap = k / g.cg;
  const int c = k - tap * g.cg;
  const int tx = tap % g.kw;
  const int t2 = tap / g.kw;
  const int ty = t2 % g.kh;
  const int tz = t2 / g.kh;
  const int iz = r.iz0 + tz * g.dd;
  const int iy = r.iy0 + ty * g.dh;
  const int ix = r.ix0 + tx * g.dw;
  if (iz < 0 || iz >= g.d || iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return -1;
  return ((static_cast<long long>(iz) * g.h + iy) * g.w + ix) * g.c_in +
         static_cast<long long>(grp) * g.cg + c;
}

// SPAN: 16 bytes (half `half` of the 32-byte padded tap row) of one row at
// tap row (tz, ty): the kw*C_in contiguous input bytes of the row, loaded as
// aligned words, realigned, with the bytes of taps outside the image (and
// the padding past kw*C_in) zero.
__device__ __forceinline__ uint4 span_load(const Geometry& g, const int8_t* x,
                                           long long x_bytes, const RowOrigin& r, int tz,
                                           int ty, int half) {
  uint4 out = make_uint4(0, 0, 0, 0);
  if (!r.valid) return out;
  const int iz = r.iz0 + tz * g.dd;
  const int iy = r.iy0 + ty * g.dh;
  if (iz < 0 || iz >= g.d || iy < 0 || iy >= g.h) return out;
  // valid byte range [lo, hi) of the padded row: taps with 0 <= ix < W
  const int kx_lo = max(0, -r.ix0);
  const int kx_hi = min(g.kw, g.w - r.ix0);
  if (kx_hi <= kx_lo) return out;
  const int lo = kx_lo * g.c_in - 16 * half;
  const int hi = kx_hi * g.c_in - 16 * half;
  if (hi <= 0 || lo >= 16) return out;
  // byte offset, from x, of byte 16*half of the span (may be < 0 or past the
  // end: those bytes are masked, and no word outside x is read)
  const long long off =
      (r.img - x) + ((static_cast<long long>(iz) * g.h + iy) * g.w + r.ix0) * g.c_in + 16 * half;
  const int shift = static_cast<int>(off & 3);
  const long long base = off - shift;
  uint32_t words[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const long long wo = base + 4 * j;
    uint32_t v = 0;
    if (wo >= 0 && wo + 4 <= x_bytes) {
      v = __ldg(reinterpret_cast<const uint32_t*>(x + wo));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (wo + b >= 0 && wo + b < x_bytes) {
          v |= static_cast<uint32_t>(static_cast<uint8_t>(x[wo + b])) << (8 * b);
        }
      }
    }
    words[j] = v;
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = __funnelshift_r(words[i], words[i + 1], 8 * shift);
    uint32_t keep = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * i + b;
      if (k >= lo && k < hi) keep |= 0xFFu << (8 * b);
    }
    o[i] = v & keep;
  }
  out = make_uint4(o[0], o[1], o[2], o[3]);
  return out;
}

__device__ __forceinline__ float epilogue_value(int acc, float scale, float bias, bool has_bias) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (has_bias) y = __fadd_rn(y, bias);
  return y;
}

__device__ __forceinline__ int8_t requant(float y, float out_scale) {
  float q = rintf(__fdiv_rn(y, out_scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// bytes of one output element (an int32 partial sum for kPartial)
__host__ __device__ __forceinline__ int out_size(int kind) {
  return kind == kBF16 ? 2 : (kind == kInt8 ? 1 : 4);
}

// Accumulators of warpgroup wg -> the staging tile in shared memory (row
// stride `stride` bytes), in the output type, or as int32 for a split.
template <int BN>
__device__ __forceinline__ void stage_out(const Geometry& g, const int (&acc)[BN / 2],
                                          uint8_t* stg, int stride, const float* s_scale,
                                          const float* s_bias, int wg) {
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  const bool has_bias = g.has_bias != 0;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int col = (i / 4) * 8 + col0;
    const int row = row0 + ((i >> 1) & 1) * 8;
    uint8_t* p = stg + row * stride;
    if (g.out_kind == kPartial) {
      *reinterpret_cast<int2*>(p + col * 4) = make_int2(acc[i], acc[i + 1]);
      continue;
    }
    const float y0 = epilogue_value(acc[i], s_scale[col], s_bias[col], has_bias);
    const float y1 = epilogue_value(acc[i + 1], s_scale[col + 1], s_bias[col + 1], has_bias);
    if (g.out_kind == kF32) {
      *reinterpret_cast<float2*>(p + col * 4) = make_float2(y0, y1);
    } else if (g.out_kind == kBF16) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(y0);
      v.y = __float2bfloat16_rn(y1);
      *reinterpret_cast<__nv_bfloat162*>(p + col * 2) = v;
    } else {
      const uint32_t q0 = static_cast<uint8_t>(requant(y0, g.out_scale));
      const uint32_t q1 = static_cast<uint8_t>(requant(y1, g.out_scale));
      *reinterpret_cast<uint16_t*>(p + col) = static_cast<uint16_t>(q0 | (q1 << 8));
    }
  }
}

// The staging tile -> device memory: 16-byte stores of whole rows where
// aligned and inside the tile's valid columns, bytes otherwise.
template <int BN>
__device__ __forceinline__ void store_out(const Geometry& g, const uint8_t* stg, int stride,
                                          uint8_t* out, long long m0, int col_base, int n0) {
  const int es = out_size(g.out_kind);
  const int cpr = BN * es / 16;  // 16-byte chunks per tile row
  const int rows = static_cast<int>(g.m_total - m0 < kBM ? g.m_total - m0 : kBM);
  const int valid_bytes = min(BN, g.cog - n0) * es;
  const long long row_bytes = static_cast<long long>(g.c_out) * es;
  for (int id = threadIdx.x; id < kBM * cpr; id += kThreads) {
    const int r = id / cpr;
    const int cb = (id - r * cpr) * 16;
    if (r >= rows || cb >= valid_bytes) continue;
    const uint8_t* src = stg + r * stride + cb;
    uint8_t* dst = out + (m0 + r) * row_bytes + static_cast<long long>(col_base) * es + cb;
    if (g.vec_out && cb + 16 <= valid_bytes) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int b = 0; b < 16 && cb + b < valid_bytes; ++b) dst[b] = src[b];
    }
  }
}

template <int kMode, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale_vec, const float* __restrict__ bias,
             uint8_t* __restrict__ out, Geometry g, long long x_bytes) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float s_scale[BN];
  __shared__ float s_bias[BN];

  constexpr int kStageA = kBM * BK;
  constexpr int kStageB = BN * BK;
  constexpr int kNumStages = kMode == kVec ? vec_stages(BK) : 2;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int grp = blockIdx.z % g.groups;
  const int split = blockIdx.z / g.groups;
  const int n0 = blockIdx.y * BN;
  const int col_base = grp * g.cog + n0;  // first output channel of the tile
  const int c_begin = split * g.chunks_per_split;
  const int nchunks = min(g.chunks, c_begin + g.chunks_per_split) - c_begin;
  const int es = out_size(g.out_kind);
  const int stride = BN * es + 16;
  uint8_t* out_tile =
      g.out_kind == kPartial
          ? out + static_cast<long long>(split) * g.m_total * g.c_out * 4
          : out;
  const long long m_tiles = (g.m_total + kBM - 1) / kBM;

  int8_t* stage_a = reinterpret_cast<int8_t*>(smem);
  int8_t* stage_b = stage_a + kNumStages * kStageA;
  // VEC: the staging tile of the epilogue, past the ring (whose next copies
  // are in flight during an epilogue); SPAN: the block's padded weights,
  // one BN x 32 stage per tap row, kept for all of its tiles, past the
  // staging tile, which reuses the ring
  uint8_t* vec_staging = smem + kNumStages * (kStageA + kStageB);
  int8_t* span_b = reinterpret_cast<int8_t*>(smem) +
                   max(kNumStages * kStageA, kBM * (BN * 4 + 16));

  for (int i = tid; i < BN; i += kThreads) {
    const bool ok = n0 + i < g.cog;
    s_scale[i] = ok ? scale_vec[col_base + i] : 0.0f;
    s_bias[i] = ok && bias != nullptr ? bias[col_base + i] : 0.0f;
  }
  if constexpr (kMode == kSpan) {
    const int row_bytes = g.kw * g.c_in;
    const int total = g.chunks * BN * kSpanBK;
    for (int i = tid; i < total; i += kThreads) {
      const int chunk = i / (BN * kSpanBK);
      const int rem = i - chunk * (BN * kSpanBK);
      const int row = rem / kSpanBK;
      const int k = rem - row * kSpanBK;
      int8_t v = 0;
      if (n0 + row < g.cog && k < row_bytes) {
        v = w[static_cast<long long>(col_base + row) * g.k_total + chunk * row_bytes + k];
      }
      span_b[chunk * kStageB + core_offset<kSpanBK>(row, k >> 4) + (k & 15)] = v;
    }
  }
  __syncthreads();

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  if constexpr (kMode == kVec) {
    // The block walks its M tiles (blockIdx.x, + gridDim.x, ...) and each
    // tile's K chunks as one sequence of steps, and the ring runs across
    // tile boundaries: the next tile's first copies are in flight while
    // this tile's last chunk multiplies and its epilogue stores.
    // This thread's 16-byte chunks of a stage: A idx = tid + 256*i, B idx
    // likewise.
    constexpr int kcs = BK / 16;
    constexpr int kAPer = kBM * kcs / kThreads;        // 1 or 2
    constexpr int kBTot = BN * kcs;                    // B chunks a stage
    constexpr int kBPer = (kBTot + kThreads - 1) / kThreads;
    const int a_kc = (tid >> 3) % kcs;
    int a_row[kAPer];
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int idx = tid + kThreads * i;
      a_row[i] = (idx / (8 * kcs)) * 8 + (idx & 7);
    }
    int b_row[kBPer], b_kc[kBPer];
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + kThreads * i;
      b_row[i] = (idx / (8 * kcs)) * 8 + (idx & 7);
      b_kc[i] = (idx >> 3) % kcs;
    }
    // the copies' position: tile, its rows' origins, and the K chunk as
    // tap (tz, ty, tx), its flat index and the channel chunk cc
    long long ld_tile = blockIdx.x;
    int ld_chunk = 0;
    RowOrigin rows[kAPer];
    int cc, tap, tx, ty, tz;
    auto start_tile = [&]() {
#pragma unroll
      for (int i = 0; i < kAPer; ++i) rows[i] = row_origin(g, x, ld_tile * kBM + a_row[i]);
      cc = c_begin % g.cpt;
      tap = c_begin / g.cpt;
      tx = tap % g.kw;
      ty = (tap / g.kw) % g.kh;
      tz = tap / (g.kw * g.kh);
    };
    start_tile();

    auto load = [&](int stage) {
      int8_t* sa = stage_a + stage * kStageA;
      int8_t* sb = stage_b + stage * kStageB;
      const int c0 = cc * BK;
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int idx = tid + kThreads * i;
        const RowOrigin& r = rows[i];
        const int c = c0 + a_kc * 16;
        const int iz = r.iz0 + tz * g.dd, iy = r.iy0 + ty * g.dh, ix = r.ix0 + tx * g.dw;
        const bool ok = r.valid && c < g.cg && iz >= 0 && iz < g.d && iy >= 0 && iy < g.h &&
                        ix >= 0 && ix < g.w;
        const int8_t* src =
            ok ? r.img + ((static_cast<long long>(iz) * g.h + iy) * g.w + ix) * g.c_in +
                     grp * g.cg + c
               : x;
        cp_async16(sa + idx * 16, src, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int idx = tid + kThreads * i;
        if (kBTot % kThreads == 0 || idx < kBTot) {
          const int c = c0 + b_kc[i] * 16;
          const bool ok = n0 + b_row[i] < g.cog && c < g.cg;
          const int8_t* src =
              ok ? w + static_cast<long long>(col_base + b_row[i]) * g.k_total +
                       static_cast<long long>(tap) * g.cg + c
                 : w;
          cp_async16(sb + idx * 16, src, ok ? 16 : 0);
        }
      }
      if (++ld_chunk == nchunks) {
        ld_chunk = 0;
        ld_tile += gridDim.x;
        if (ld_tile < m_tiles) start_tile();
      } else if (++cc == g.cpt) {
        cc = 0;
        ++tap;
        if (++tx == g.kw) {
          tx = 0;
          if (++ty == g.kh) {
            ty = 0;
            ++tz;
          }
        }
      }
    };

    // Copies run kNumStages - 2 steps ahead, and one stage's products stay
    // in flight while the next stage is waited for and the next copies are
    // issued: the stage a copy overwrites was last read two steps ago.
    const int steps = static_cast<int>((m_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) *
                      nchunks;
#pragma unroll
    for (int s = 0; s < kNumStages - 2; ++s) {
      if (s < steps) load(s);
      cp_async_commit();
    }
    long long tile = blockIdx.x;
    int chunk = 0, stage = 0, ld_stage = kNumStages - 2;
    for (int st = 0; st < steps; ++st) {
      cp_async_wait<kNumStages - 3>();
      fence_async_smem();
      __syncthreads();
      if (st + kNumStages - 2 < steps) load(ld_stage);
      cp_async_commit();
      if (++ld_stage == kNumStages) ld_stage = 0;
      wgmma_fence();
      mma_issue<BN, BK>(acc, stage_a + stage * kStageA, stage_b + stage * kStageB, wg);
      wgmma_commit();
      wgmma_wait<1>();
      if (++stage == kNumStages) stage = 0;
      if (++chunk == nchunks) {
        // epilogue: registers -> staging -> device memory; the barrier at
        // the top of the next step keeps the staging tile until it is read
        wgmma_wait<0>();
        stage_out<BN>(g, acc, vec_staging, stride, s_scale, s_bias, wg);
        __syncthreads();
        store_out<BN>(g, vec_staging, stride, out_tile, tile * kBM, col_base, n0);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        chunk = 0;
        tile += gridDim.x;
      }
    }
    cp_async_wait<0>();
    return;
  } else {
    // SPAN and GATHER: registers carry chunk it + 1 while chunk it multiplies
    for (long long tile = blockIdx.x; tile < m_tiles; tile += gridDim.x) {
      const long long m0 = tile * kBM;
      const int a_row = tid & 127;
      const int a_half = tid >> 7;
      const RowOrigin r = row_origin(g, x, m0 + a_row);
      // GATHER's B: BN x 32 bytes a chunk, 8 bytes a thread
      const int b_row = tid >> 2;
      const int b_part = tid & 3;
      int tz = c_begin / g.kh, ty = c_begin % g.kh;  // SPAN: tap row
      int chunk = c_begin;
      uint4 va;
      uint2 vb = make_uint2(0, 0);

      auto fetch = [&]() {
        if constexpr (kMode == kSpan) {
          va = span_load(g, x, x_bytes, r, tz, ty, a_half);
          if (++ty == g.kh) {
            ty = 0;
            ++tz;
          }
        } else {
          uint32_t o[4] = {0, 0, 0, 0};
          const int k0 = chunk * kSpanBK + 16 * a_half;
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const long long off = gather_offset(g, r, grp, k0 + b);
            if (off >= 0) {
              o[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(r.img[off])) << (8 * (b & 3));
            }
          }
          va = make_uint4(o[0], o[1], o[2], o[3]);
          uint32_t p[2] = {0, 0};
          const int kb = chunk * kSpanBK + 8 * b_part;
          const bool col_ok = n0 + b_row < g.cog;
          const int8_t* wr = w + static_cast<long long>(col_base + b_row) * g.k_total;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            if (col_ok && kb + b < g.k_total) {
              p[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(wr[kb + b])) << (8 * (b & 3));
            }
          }
          vb = make_uint2(p[0], p[1]);
        }
        ++chunk;
      };
      auto put = [&](int stage) {
        int8_t* sa = stage_a + stage * kStageA;
        *reinterpret_cast<uint4*>(sa + core_offset<kSpanBK>(a_row, a_half)) = va;
        if (kMode == kGather && b_row < BN) {
          int8_t* sb = stage_b + stage * kStageB;
          *reinterpret_cast<uint2*>(sb + core_offset<kSpanBK>(b_row, b_part >> 1) +
                                    8 * (b_part & 1)) = vb;
        }
      };

      if (nchunks > 0) {
        fetch();
        put(0);
      }
      for (int it = 0; it < nchunks; ++it) {
        fence_async_smem();
        __syncthreads();
        if (it + 1 < nchunks) fetch();
        const int s = it & 1;
        const int8_t* sb = kMode == kSpan ? span_b + (c_begin + it) * kStageB
                                          : stage_b + s * kStageB;
        mma_stage<BN, kSpanBK>(acc, stage_a + s * kStageA, sb, wg);
        if (it + 1 < nchunks) put(s ^ 1);
      }

      // epilogue: registers -> staging (the ring, free now) -> device memory
      __syncthreads();
      stage_out<BN>(g, acc, smem, stride, s_scale, s_bias, wg);
      __syncthreads();
      store_out<BN>(g, smem, stride, out_tile, m0, col_base, n0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    }
  }
}

// Split-K: the splits' int32 partial sums (splits, M, C_out) -> their exact
// sum -> the epilogue, one thread per output element.
template <typename OutT>
__device__ __forceinline__ void finish_store(OutT* p, float v, float);
template <>
__device__ __forceinline__ void finish_store<float>(float* p, float v, float) {
  *p = v;
}
template <>
__device__ __forceinline__ void finish_store<__nv_bfloat16>(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ void finish_store<int8_t>(int8_t* p, float v, float out_scale) {
  *p = requant(v, out_scale);
}

template <typename OutT>
__global__ void __launch_bounds__(256)
qconv_splitk_finish(const int* __restrict__ ws, const float* __restrict__ scale_vec,
                    const float* __restrict__ bias, OutT* __restrict__ out, long long total,
                    int c_out, int splits, float out_scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % c_out);
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += ws[s * total + i];
  const float y = epilogue_value(acc, scale_vec[c], bias != nullptr ? bias[c] : 0.0f,
                                 bias != nullptr);
  finish_store<OutT>(out + i, y, out_scale);
}

int smem_bytes(int mode, int bn, int bk, int chunks, int out_kind) {
  const int es = out_size(out_kind);
  const int staging = kBM * (bn * es + 16);
  if (mode == kVec) return vec_stages(bk) * (kBM + bn) * bk + staging;
  const int ring = std::max(2 * kBM * kSpanBK, kBM * (bn * 4 + 16));
  if (mode == kSpan) return ring + chunks * bn * kSpanBK;
  return std::max(2 * (kBM + bn) * kSpanBK, staging);
}

template <int kMode, int BN, int BK>
cudaError_t launch_tile(const int8_t* x, const int8_t* w, const float* sv, const float* bi,
                        void* out, const Geometry& g, long long x_bytes, int grid_x,
                        cudaStream_t s) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_kernel<kMode, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned int>(grid_x),
                  static_cast<unsigned int>((g.cog + BN - 1) / BN),
                  static_cast<unsigned int>(g.groups * g.splits));
  const int smem = smem_bytes(kMode, BN, BK, g.chunks, g.out_kind);
  qconv_kernel<kMode, BN, BK><<<grid, kThreads, smem, s>>>(
      x, w, sv, bi, static_cast<uint8_t*>(out), g, x_bytes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launches (0 on success); a plan or geometry the kernel does not take
// returns cudaErrorInvalidValue.  mode, bn, bk, splits, chunks_per_split and
// grid_x come from the planner (ops/qconv.py:plan), which this checks; with
// splits > 1, workspace is an int32 (splits, M, C_out) buffer.
extern "C" int eco_qconv(
    const void* x, const void* w, const void* scale_vec, const void* bias, void* out,
    void* workspace, int n, int d, int h, int wd, int c_in, int c_out, int groups, int kd,
    int kh, int kw, int sd, int sh, int sw, int pd, int ph, int pw, int dd, int dh, int dw,
    int od, int oh, int ow, int out_kind, float out_scale, int mode, int bn, int bk, int splits,
    int chunks_per_split, int grid_x, void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (groups <= 0 || c_in % groups != 0 || c_out % groups != 0) return bad;
  if (out_kind < kF32 || out_kind > kInt8) return bad;
  Geometry g{};
  g.n = n; g.d = d; g.h = h; g.w = wd; g.c_in = c_in; g.c_out = c_out; g.groups = groups;
  g.cg = c_in / groups; g.cog = c_out / groups;
  g.kd = kd; g.kh = kh; g.kw = kw; g.sd = sd; g.sh = sh; g.sw = sw;
  g.pd = pd; g.ph = ph; g.pw = pw; g.dd = dd; g.dh = dh; g.dw = dw;
  g.od = od; g.oh = oh; g.ow = ow;
  g.k_total = kd * kh * kw * g.cg;
  g.m_total = static_cast<long long>(n) * od * oh * ow;
  g.out_scale = out_scale;
  g.has_bias = bias != nullptr;
  if (g.m_total == 0) return 0;
  const auto xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w);
  int chunks;
  if (mode == kVec) {
    if (g.cg % 16 != 0 || xa % 16 != 0 || wa % 16 != 0 || (bk != 32 && bk != 64) ||
        (bn != 32 && bn != 64 && bn != 128)) {
      return bad;
    }
    g.cpt = (g.cg + bk - 1) / bk;
    chunks = kd * kh * kw * g.cpt;
  } else if (mode == kSpan) {
    if (groups != 1 || dw != 1 || kw * c_in > kSpanBK || xa % 4 != 0 || bn != 64 ||
        bk != kSpanBK || kd * kh * bn * kSpanBK > kMaxSpanB) {
      return bad;
    }
    chunks = kd * kh;
  } else if (mode == kGather) {
    if (bn != 64 || bk != kSpanBK) return bad;
    chunks = (g.k_total + kSpanBK - 1) / kSpanBK;
  } else {
    return bad;
  }
  g.chunks = chunks;
  g.splits = splits;
  g.chunks_per_split = chunks_per_split;
  if (splits < 1 || chunks_per_split < 1 || static_cast<long long>(splits) * chunks_per_split < chunks ||
      static_cast<long long>(splits - 1) * chunks_per_split >= chunks) {
    return bad;
  }
  if (splits > 1 && (mode != kVec || workspace == nullptr)) return bad;
  const long long m_tiles = (g.m_total + kBM - 1) / kBM;
  if (grid_x < 1 || grid_x > m_tiles || (mode == kGather && grid_x != m_tiles) || (g.cog + bn - 1) / bn > 65535 ||
      static_cast<long long>(groups) * splits > 65535) {
    return bad;
  }
  g.out_kind = splits > 1 ? static_cast<int>(kPartial) : out_kind;
  const int es = out_size(g.out_kind);
  g.vec_out = (splits > 1 ? reinterpret_cast<uintptr_t>(workspace) : reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
              (static_cast<long long>(c_out) * es) % 16 == 0 &&
              (static_cast<long long>(g.cog) * es) % 16 == 0;
  const long long x_bytes = static_cast<long long>(n) * d * h * wd * c_in;
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* sv = static_cast<const float*>(scale_vec);
  const auto* bi = static_cast<const float*>(bias);
  void* dst = splits > 1 ? workspace : out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kVec) {
    if (bn == 32 && bk == 32) e = launch_tile<kVec, 32, 32>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
    else if (bn == 32) e = launch_tile<kVec, 32, 64>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
    else if (bn == 64 && bk == 32) e = launch_tile<kVec, 64, 32>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
    else if (bn == 64) e = launch_tile<kVec, 64, 64>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
    else if (bk == 32) e = launch_tile<kVec, 128, 32>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
    else e = launch_tile<kVec, 128, 64>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
  } else if (mode == kSpan) {
    e = launch_tile<kSpan, 64, kSpanBK>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
  } else {
    e = launch_tile<kGather, 64, kSpanBK>(xi, wi, sv, bi, dst, g, x_bytes, grid_x, s);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long total = g.m_total * c_out;
  const unsigned int blocks = static_cast<unsigned int>((total + 255) / 256);
  const auto* ws = static_cast<const int*>(workspace);
  if (out_kind == kF32) {
    qconv_splitk_finish<float><<<blocks, 256, 0, s>>>(ws, sv, bi, static_cast<float*>(out),
                                                      total, c_out, splits, out_scale);
  } else if (out_kind == kBF16) {
    qconv_splitk_finish<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        ws, sv, bi, static_cast<__nv_bfloat16*>(out), total, c_out, splits, out_scale);
  } else {
    qconv_splitk_finish<int8_t><<<blocks, 256, 0, s>>>(ws, sv, bi, static_cast<int8_t*>(out),
                                                       total, c_out, splits, out_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
