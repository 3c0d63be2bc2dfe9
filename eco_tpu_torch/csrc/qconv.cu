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
// Design: an implicit GEMM.  Rows M = N*Do*Ho*Wo (output pixels), columns
// C_out/g per group, reduction K = kd*kh*kw*C_in/g ordered (tap, channel),
// so that K runs along contiguous input channels of one input pixel and
// along contiguous bytes of one weight row.  A block owns a 128 x 64 output
// tile of one group (grid z = groups); per 32-deep K chunk it gathers the
// 128 input rows (zeros where the tap falls in the padding) and 64 weight
// rows into shared memory, and four warps, each on a 64 x 32 sub-tile,
// multiply them on the int8 tensor cores with mma.sync m16n8k32 (s8 x s8 ->
// s32).  The epilogue reads the accumulators straight from registers, so the
// int32 values never reach device memory.
//
// Two load paths.  Where C_in/g is a multiple of 16 (every ECO layer but
// conv1) and both pointers are 16-byte aligned, a thread moves 16 bytes of
// one input pixel (or one weight row) at a time: 16 consecutive K indices
// then never straddle two taps.  Otherwise (conv1: C_in = 3, K = 147) a
// thread gathers its bytes one by one, and the K tail of the last chunk is
// zero-filled on both sides.
//
// What bounds it on Hopper: at ECO's shapes the reduction is 147-4608 deep
// and C_out 64-512, so the tensor cores are far from busy with this simple
// loop (one shared buffer, no asynchronous copies, no wgmma).  It is built
// to be right first; cp.async or TMA pipelining and wgmma are later work.
//
// Bit-exactness with the plain version (ops/qconv.py): the accumulator is
// exact (|acc| <= 127*127*K < 2**31 for K <= 133,000; ECO's worst is
// 127^2*3*3*3*512 ~= 2.2e8); the epilogue uses __int2float_rn, __fmul_rn and
// __fadd_rn (no FMA contraction, as PyTorch's separate multiply and add),
// __fdiv_rn by out_scale (the plain version divides by a 0-d tensor), rintf
// (round half to even, as torch.round) and __float2bfloat16_rn.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;            // output pixels per block
constexpr int kBN = 64;             // output channels per block
constexpr int kBK = 32;             // reduction depth per chunk (one mma k)
constexpr int kLds = kBK + 16;      // shared row stride, bytes: 12 words, so
                                    // the fragment loads hit 32 distinct banks
constexpr int kThreads = 128;       // four warps, 2 x 2 over the tile

enum OutKind : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

struct Geometry {
  int n, d, h, w, c_in, c_out, groups, cg, cog;
  int kd, kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int od, oh, ow;
  int k_total;         // kd * kh * kw * cg
  long long m_total;   // n * od * oh * ow
};

__device__ __forceinline__ void store(float* p, float v, float) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store(int8_t* p, float v, float out_scale) {
  float q = rintf(__fdiv_rn(v, out_scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  *p = static_cast<int8_t>(q);
}

// D = A (16x32, row) * B (32x8, col) + D, int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int* d, int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Offset of input element (k) of an output row, or -1 where the tap falls in
// the padding or k is past the reduction.
__device__ __forceinline__ long long input_offset(const Geometry& g, int k,
                                                  int iz0, int iy0, int ix0) {
  if (k >= g.k_total) return -1;
  const int tap = k / g.cg;
  const int c = k - tap * g.cg;
  const int tx = tap % g.kw;
  const int t2 = tap / g.kw;
  const int ty = t2 % g.kh;
  const int tz = t2 / g.kh;
  const int iz = iz0 + tz * g.dd;
  const int iy = iy0 + ty * g.dh;
  const int ix = ix0 + tx * g.dw;
  if (iz < 0 || iz >= g.d || iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return -1;
  return ((static_cast<long long>(iz) * g.h + iy) * g.w + ix) * g.c_in + c;
}

template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale_vec, const float* __restrict__ bias,
             OutT* __restrict__ out, Geometry g, float out_scale) {
  __shared__ __align__(16) int8_t a_tile[kBM * kLds];
  __shared__ __align__(16) int8_t b_tile[kBN * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;   // mma "groupID"
  const int tig = lane & 3;    // mma "threadID_in_group"
  const int grp = blockIdx.z;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: thread tid gathers tile row tid (one output pixel).
  const long long m = m0 + tid;
  const bool row_ok = m < g.m_total;
  int iz0 = 0, iy0 = 0, ix0 = 0;
  const int8_t* xb = x;
  if (row_ok) {
    long long r = m;
    const int ox = static_cast<int>(r % g.ow); r /= g.ow;
    const int oy = static_cast<int>(r % g.oh); r /= g.oh;
    const int oz = static_cast<int>(r % g.od); r /= g.od;
    iz0 = oz * g.sd - g.pd;
    iy0 = oy * g.sh - g.ph;
    ix0 = ox * g.sw - g.pw;
    xb = x + r * g.d * g.h * g.w * static_cast<long long>(g.c_in) +
         static_cast<long long>(grp) * g.cg;
  }
  // B loader: thread tid fills half (tid & 1) of weight row tid >> 1.
  const int b_row = tid >> 1;
  const int b_half = tid & 1;
  const bool col_ok = n0 + b_row < g.cog;
  const int8_t* wb =
      w + static_cast<long long>(grp * g.cog + n0 + b_row) * g.k_total;

  const int warp_m = warp >> 1;  // rows warp_m*64 .. +64
  const int warp_n = warp & 1;   // cols warp_n*32 .. +32
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < g.k_total; k0 += kBK) {
    if (kVec) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int4 v = make_int4(0, 0, 0, 0);
        if (row_ok) {
          const long long off = input_offset(g, k0 + 16 * half, iz0, iy0, ix0);
          if (off >= 0) v = *reinterpret_cast<const int4*>(xb + off);
        }
        *reinterpret_cast<int4*>(a_tile + tid * kLds + 16 * half) = v;
      }
      int4 v = make_int4(0, 0, 0, 0);
      const int k = k0 + 16 * b_half;
      if (col_ok && k < g.k_total) v = *reinterpret_cast<const int4*>(wb + k);
      *reinterpret_cast<int4*>(b_tile + b_row * kLds + 16 * b_half) = v;
    } else {
      for (int i = 0; i < kBK; ++i) {
        int8_t v = 0;
        if (row_ok) {
          const long long off = input_offset(g, k0 + i, iz0, iy0, ix0);
          if (off >= 0) v = xb[off];
        }
        a_tile[tid * kLds + i] = v;
      }
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + 16 * b_half + i;
        b_tile[b_row * kLds + 16 * b_half + i] =
            (col_ok && k < g.k_total) ? wb[k] : static_cast<int8_t>(0);
      }
    }
    __syncthreads();

    int b_frag[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* bp = b_tile + (warp_n * 32 + ni * 8 + gid) * kLds + tig * 4;
      b_frag[ni][0] = *reinterpret_cast<const int*>(bp);
      b_frag[ni][1] = *reinterpret_cast<const int*>(bp + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* ap = a_tile + (warp_m * 64 + mi * 16 + gid) * kLds + tig * 4;
      const int a0 = *reinterpret_cast<const int*>(ap);
      const int a1 = *reinterpret_cast<const int*>(ap + 8 * kLds);
      const int a2 = *reinterpret_cast<const int*>(ap + 16);
      const int a3 = *reinterpret_cast<const int*>(ap + 8 * kLds + 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc[mi][ni], a0, a1, a2, a3, b_frag[ni][0], b_frag[ni][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + warp_m * 64 + mi * 16 + gid + (e >> 1) * 8;
        const int col = n0 + warp_n * 32 + ni * 8 + tig * 2 + (e & 1);
        if (row < g.m_total && col < g.cog) {
          const int co = grp * g.cog + col;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][e]), scale_vec[co]);
          if (bias != nullptr) y = __fadd_rn(y, bias[co]);
          store(out + row * g.c_out + co, y, out_scale);
        }
      }
    }
  }
}

template <typename OutT>
void launch(const int8_t* x, const int8_t* w, const float* scale_vec,
            const float* bias, void* out, const Geometry& g, float out_scale,
            bool vec, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>((g.m_total + kBM - 1) / kBM),
                  static_cast<unsigned int>((g.cog + kBN - 1) / kBN),
                  static_cast<unsigned int>(g.groups));
  if (vec) {
    qconv_kernel<OutT, true><<<grid, kThreads, 0, s>>>(
        x, w, scale_vec, bias, static_cast<OutT*>(out), g, out_scale);
  } else {
    qconv_kernel<OutT, false><<<grid, kThreads, 0, s>>>(
        x, w, scale_vec, bias, static_cast<OutT*>(out), g, out_scale);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success); an unknown out_kind or a geometry the kernel
// does not take returns cudaErrorInvalidValue.  The 16-byte load path is
// taken where C_in/g % 16 == 0 and both x and w are 16-byte aligned.
extern "C" int eco_qconv(
    const void* x, const void* w, const void* scale_vec, const void* bias,
    void* out, int n, int d, int h, int wd, int c_in, int c_out, int groups,
    int kd, int kh, int kw, int sd, int sh, int sw, int pd, int ph, int pw,
    int dd, int dh, int dw, int od, int oh, int ow, int out_kind,
    float out_scale, void* stream) {
  if (groups <= 0 || c_in % groups != 0 || c_out % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{n,  d,  h,  wd, c_in, c_out, groups, c_in / groups, c_out / groups,
             kd, kh, kw, sd, sh,   sw,    pd,     ph,            pw,
             dd, dh, dw, od, oh,   ow,    0,      0};
  g.k_total = kd * kh * kw * g.cg;
  g.m_total = static_cast<long long>(n) * od * oh * ow;
  if (g.m_total == 0) return 0;
  if ((g.m_total + kBM - 1) / kBM > 0x7fffffffLL || (g.cog + kBN - 1) / kBN > 65535 ||
      groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = g.cg % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* wi = static_cast<const int8_t*>(w);
  const auto* sv = static_cast<const float*>(scale_vec);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kF32:
      launch<float>(xi, wi, sv, bi, out, g, out_scale, vec, s);
      break;
    case kBF16:
      launch<__nv_bfloat16>(xi, wi, sv, bi, out, g, out_scale, vec, s);
      break;
    case kInt8:
      launch<int8_t>(xi, wi, sv, bi, out, g, out_scale, vec, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
