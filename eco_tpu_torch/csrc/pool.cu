// K4: Caffe ceil-mode 2D MAX and AVE pooling on channels-last float tensors,
// in one pass.
//
// Replaces no TPU kernel.  It replaces ``ops/pool.py:pool_nd``'s padded route
// on the card for inference: a MAX pool there copies the whole activation
// into a -inf-padded tensor before ATen's pool; an AVE pool casts to f32,
// zero-pads in f32, sums an unfold view, divides by the divisor grid and
// casts back, six passes over the activation.
//
// Input : x (N, H, W, C) contiguous, f32 / bf16 / f16.
// Output: (N, Ho, Wo, C) contiguous, in the input type, Ho and Wo by Caffe's
//         ceil rule (utils/shapes.py:caffe_pool_out_dim), computed by the
//         caller.  The window of output (i, j) covers rows i*sh - ph ..
//         i*sh - ph + kh - 1 and the same for columns; cells outside the
//         image are the padding.
//   MAX: the largest value of the window's image cells; a NaN among them
//        gives NaN, as ATen's max pool does.
//   AVE: the window's cells added in f32 in row-major order, one add at a
//        time from +0.0, the padding's cells as +0.0, then divided (IEEE,
//        __fdiv_rn) by Caffe's divisor: the window clipped to H + ph
//        (W + pw) before it is clipped to the image
//        (utils/shapes.py:caffe_avg_pool_divisors).  That is how ATen's
//        average pool sums a window, which the plain route runs with a
//        divisor of 1 on the zero-padded f32 tensor, so the two give the
//        same bits.
//
// What bounds it on Hopper: memory traffic.  At most 49 adds or compares
// per output element against 2-8 bytes moved, so the pool's bytes, its
// input read once and its output written once, set the least time.  The
// design:
//   * a block owns a tile of output rows x output columns x a chunk of
//     16-byte channel vectors (8 bf16/f16 or 4 f32 channels each) and
//     stages the input band under it, (rows - 1) * sh + kh rows by
//     (columns - 1) * sw + kw columns, in shared memory with cp.async
//     (16 bytes a thread, neighbouring threads on neighbouring vectors, so
//     the loads coalesce).  Each input byte comes from device memory about
//     once; only a tile's halo rows and columns are read again, by the
//     neighbouring block, mostly from L2.  Cells outside the image are
//     written as the fill (-inf for MAX, +0.0 for AVE) while staging: the
//     padding and the last window's clip are index arithmetic, and no padded
//     copy is made in device memory;
//   * a thread owns one channel vector of PW neighbouring output pixels of
//     one row, and walks each window row once: a loaded column serves every
//     one of its PW windows that covers it, from registers (PW 2 at 3x3/s2,
//     4 at 3x3/s1);
//   * the shapes ECO runs are template-specialised, so their loops unroll:
//     3x3/s2, 3x3/s1 (any pad) and 7x7/s1; a generic instantiation takes
//     any other window with PW 1;
//   * a scalar path (one thread per output element, loads straight from
//     device memory) takes a C whose row is not a whole number of 16-byte
//     vectors, an unaligned pointer, or a window whose tile does not fit in
//     shared memory.
// The tile comes from the caller (ops/poolk.py:plan), which keeps it within
// 48 KB of shared memory and 256 threads, and splits rows and then channels
// until the grid has two blocks for each of the card's SMs.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kMaxThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;

struct Geom {
  int n, h, w, c;      // input (N, H, W, C)
  int ho, wo;          // output rows and columns
  int kh, kw, sh, sw, ph, pw;
};

struct Tile {
  int tx, toh, cv;                     // threads along a row, output rows, vectors
  int row_tiles, col_tiles, chunks;    // tiles along Ho, Wo and the channel vectors
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// the padding's value in the input type: -inf for MAX, +0.0 for AVE
template <typename T, bool AVE> __device__ __forceinline__ T fill_value() {
  return from_f32<T>(AVE ? 0.0f : __int_as_float(0xff800000));
}

// max that returns NaN when either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the accumulator's start: -inf for MAX, +0.0 for AVE
template <bool AVE> __device__ __forceinline__ float acc_start() {
  return AVE ? 0.0f : __int_as_float(0xff800000);
}

// one window cell into the accumulator: MAX compares, AVE adds, the cells
// taken in row-major order
template <bool AVE>
__device__ __forceinline__ void take(float& acc, float v) {
  if constexpr (AVE) {
    acc = __fadd_rn(acc, v);
  } else {
    acc = nan_max(acc, v);
  }
}

// Caffe's AVE divisor along one axis: the window clipped to size + pad
__device__ __forceinline__ int window_extent(int o, int s, int p, int k, int size) {
  const int start = o * s - p;
  return min(start + k, size + p) - start;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The tile path.  KH == 0 is the generic instantiation: the window from
// ``g`` at run time, PW 1.
template <typename T, int KH, int KW, int SH, int SW, int PW, bool AVE>
__global__ void __launch_bounds__(kMaxThreads)
pool_tile_kernel(const T* __restrict__ x, T* __restrict__ out, Geom g, Tile t) {
  constexpr int EL = 16 / sizeof(T);
  extern __shared__ uint4 band[];
  const int kh = KH ? KH : g.kh, kw = KW ? KW : g.kw;
  const int sh = SH ? SH : g.sh, sw = SW ? SW : g.sw;
  const int cv = t.cv;

  // consecutive blocks: neighbouring column tiles, then row tiles, of one
  // chunk of one image, so a halo is read again while it is still in L2
  int b = blockIdx.x;
  const int ct = b % t.col_tiles;
  b /= t.col_tiles;
  const int rt = b % t.row_tiles;
  b /= t.row_tiles;
  const int chunk = b % t.chunks;
  const long long n = b / t.chunks;
  const int oh0 = rt * t.toh, ow0 = ct * t.tx * PW;
  const int ih0 = oh0 * sh - g.ph, iw0 = ow0 * sw - g.pw;
  const int band_h = (t.toh - 1) * sh + kh, band_w = (t.tx * PW - 1) * sw + kw;
  const int groups = g.c / EL, v0 = chunk * cv;

  const T fill = fill_value<T, AVE>();
  uint4 fill_vec;
  T* f = reinterpret_cast<T*>(&fill_vec);
#pragma unroll
  for (int e = 0; e < EL; ++e) f[e] = fill;
  const long long image = n * g.h;
  const int cells = band_h * band_w * cv;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = i % cv, pix = i / cv;
    const int r = ih0 + pix / band_w, q = iw0 + pix % band_w;
    if (r >= 0 && r < g.h && q >= 0 && q < g.w && v0 + v < groups) {
      cp_async16(band + i, x + ((image + r) * g.w + q) * g.c + (v0 + v) * EL);
    } else {
      band[i] = fill_vec;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int v = threadIdx.x % cv, rest = threadIdx.x / cv;
  const int tx = rest % t.tx, ty = rest / t.tx;
  const int oh = oh0 + ty, ow = ow0 + tx * PW;
  if (ty >= t.toh || oh >= g.ho || ow >= g.wo || v0 + v >= groups) return;

  float acc[PW][EL];
#pragma unroll
  for (int p = 0; p < PW; ++p) {
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[p][e] = acc_start<AVE>();
  }
  const uint4* corner = band + (ty * sh * band_w + tx * PW * sw) * cv + v;
  if constexpr (KH > 0) {
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      const uint4* row = corner + i * band_w * cv;
#pragma unroll
      for (int q = 0; q < (PW - 1) * SW + KW; ++q) {
        const uint4 raw = row[q * cv];
        const T* cell = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const int j = q - p * SW;
          if (j >= 0 && j < KW) {
#pragma unroll
            for (int e = 0; e < EL; ++e) take<AVE>(acc[p][e], to_f32(cell[e]));
          }
        }
      }
    }
  } else {
    for (int i = 0; i < kh; ++i) {
      const uint4* row = corner + i * band_w * cv;
      for (int j = 0; j < kw; ++j) {
        const uint4 raw = row[j * cv];
        const T* cell = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < EL; ++e) take<AVE>(acc[0][e], to_f32(cell[e]));
      }
    }
  }

  const float div_h = AVE ? static_cast<float>(window_extent(oh, sh, g.ph, kh, g.h)) : 1.0f;
  T* dst = out + ((n * g.ho + oh) * g.wo + ow) * static_cast<long long>(g.c) + (v0 + v) * EL;
#pragma unroll
  for (int p = 0; p < PW; ++p) {
    if (ow + p >= g.wo) break;
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
    // the route's divisor grid is the f32 product of the two axes' divisors,
    // small integers, so exact
    const float div = AVE ? div_h * static_cast<float>(window_extent(ow + p, sw, g.pw, kw, g.w))
                          : 1.0f;
#pragma unroll
    for (int e = 0; e < EL; ++e) o[e] = from_f32<T>(AVE ? __fdiv_rn(acc[p][e], div) : acc[p][e]);
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(p) * g.c) = packed;
  }
}

// The scalar path: one thread per output element, loads from device memory.
template <typename T, bool AVE>
__global__ void pool_scalar_kernel(const T* __restrict__ x, T* __restrict__ out, Geom g,
                                   long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = static_cast<int>(t % g.c);
  long long pix = t / g.c;
  const int ow = static_cast<int>(pix % g.wo);
  pix /= g.wo;
  const int oh = static_cast<int>(pix % g.ho);
  const long long n = pix / g.ho;
  const int r0 = oh * g.sh - g.ph, q0 = ow * g.sw - g.pw;
  float acc = acc_start<AVE>();
  for (int i = 0; i < g.kh; ++i) {
    const int r = r0 + i;
    for (int j = 0; j < g.kw; ++j) {
      const int q = q0 + j;
      const bool inside = r >= 0 && r < g.h && q >= 0 && q < g.w;
      if (!AVE && !inside) continue;
      const float v = inside ? to_f32(x[((n * g.h + r) * g.w + q) * g.c + ch]) : 0.0f;
      take<AVE>(acc, v);
    }
  }
  if constexpr (AVE) {
    const float div = static_cast<float>(window_extent(oh, g.sh, g.ph, g.kh, g.h)) *
                      static_cast<float>(window_extent(ow, g.sw, g.pw, g.kw, g.w));
    acc = __fdiv_rn(acc, div);
  }
  out[t] = from_f32<T>(acc);
}

template <typename T, int KH, int KW, int SH, int SW, int PW, bool AVE>
int launch_tile(const void* x, void* out, const Geom& g, const Tile& t, int threads, int smem,
                cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(g.n) * t.chunks * t.row_tiles * t.col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pool_tile_kernel<T, KH, KW, SH, SW, PW, AVE>
      <<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), g, t);
  return static_cast<int>(cudaGetLastError());
}

// The tile comes from ops/poolk.py:plan, which decides it; here it is only
// checked against the kernel's limits: a whole number of vectors a pixel,
// aligned pointers, the threads it needs, and a band that fits the shared
// memory asked for.
template <typename T, bool AVE>
int dispatch(const void* x, void* out, const Geom& g, bool tiled, int per, const Tile& t,
             int threads, int smem, cudaStream_t stream) {
  if (!tiled) {
    const long long total = static_cast<long long>(g.n) * g.ho * g.wo * g.c;
    const int block = 256;
    const long long blocks = (total + block - 1) / block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    pool_scalar_kernel<T, AVE><<<static_cast<unsigned int>(blocks), block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), g, total);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int EL = 16 / sizeof(T);
  const long long band = static_cast<long long>((t.toh - 1) * g.sh + g.kh) *
                         ((t.tx * per - 1) * g.sw + g.kw) * t.cv * 16;
  if (g.c % EL != 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 ||
      t.tx < 1 || t.toh < 1 || t.cv < 1 || threads != t.cv * t.tx * t.toh ||
      threads > kMaxThreads || band > smem || smem > kMaxSmemBytes ||
      static_cast<long long>(t.row_tiles) * t.toh < g.ho ||
      static_cast<long long>(t.col_tiles) * t.tx * per < g.wo ||
      static_cast<long long>(t.chunks) * t.cv * EL < g.c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool k3 = g.kh == 3 && g.kw == 3;
  if (k3 && g.sh == 2 && g.sw == 2 && per == 2) {
    return launch_tile<T, 3, 3, 2, 2, 2, AVE>(x, out, g, t, threads, smem, stream);
  }
  if (k3 && g.sh == 1 && g.sw == 1 && per == 4) {
    return launch_tile<T, 3, 3, 1, 1, 4, AVE>(x, out, g, t, threads, smem, stream);
  }
  if (g.kh == 7 && g.kw == 7 && g.sh == 1 && g.sw == 1 && per == 1) {
    return launch_tile<T, 7, 7, 1, 1, 1, AVE>(x, out, g, t, threads, smem, stream);
  }
  if (per != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile<T, 0, 0, 0, 0, 1, AVE>(x, out, g, t, threads, smem, stream);
}

template <typename T>
int dispatch_mode(const void* x, void* out, const Geom& g, int ave, bool tiled, int per,
                  const Tile& t, int threads, int smem, cudaStream_t stream) {
  return ave ? dispatch<T, true>(x, out, g, tiled, per, t, threads, smem, stream)
             : dispatch<T, false>(x, out, g, tiled, per, t, threads, smem, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  ``tiled`` selects the tile path
// with ``per`` output columns a thread (2 at 3x3/s2, 4 at 3x3/s1, else 1),
// ``tx`` threads along a tile's row, ``toh`` output rows and ``cv`` 16-byte
// channel vectors a tile, ``row_tiles``, ``col_tiles`` and ``chunks`` tiles
// along Ho, Wo and the channel vectors, ``threads`` a block and ``smem``
// bytes of shared memory a block, all from ops/poolk.py:plan.  Returns
// cudaGetLastError() after the launch (0 on success); a bad dtype, shape or
// tile returns cudaErrorInvalidValue and launches nothing.
extern "C" int eco_caffe_pool2d(const void* x, void* out, int n, int h, int w, int c, int ho,
                                int wo, int kh, int kw, int sh, int sw, int ph, int pw,
                                int dtype, int ave, int tiled, int per, int tx, int toh, int cv,
                                int row_tiles, int col_tiles, int chunks, int threads, int smem,
                                void* stream) {
  if (n < 0 || h < 1 || w < 1 || c < 1 || ho < 1 || wo < 1 || kh < 1 || kw < 1 || sh < 1 ||
      sw < 1 || ph < 0 || pw < 0 || per < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Geom g{n, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw};
  const Tile t{tx, toh, cv, row_tiles, col_tiles, chunks};
  const bool tile = tiled != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_mode<float>(x, out, g, ave, tile, per, t, threads, smem, s);
    case kBF16:
      return dispatch_mode<__nv_bfloat16>(x, out, g, ave, tile, per, t, threads, smem, s);
    case kF16:
      return dispatch_mode<__half>(x, out, g, ave, tile, per, t, threads, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
