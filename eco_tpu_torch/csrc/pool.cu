// K4: Caffe ceil-mode 2D and 3D MAX and AVE pooling on channels-last float
// tensors, in one pass.
//
// Replaces no TPU kernel.  It replaces ``ops/pool.py:pool_nd``'s padded route
// on the card for inference: a MAX pool there copies the whole activation
// into a -inf-padded tensor before ATen's pool (in 3D ATen's pool also
// writes int64 indices, and the result is copied back to channels-last); an
// AVE pool casts to f32, zero-pads in f32, pools with a divisor of 1,
// divides by the divisor grid and casts back.
//
// The 2D path is below; the 3D path (N, T, H, W, C), after it, has kernels
// of its own and shares only the device helpers (fill_value, nan_max, take,
// window_extent, cp_async16).
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
//
// The 3D path: the same function over (t, h, w), the divisor the product of
// the three axes' (the route pools with ATen's avg_pool3d, divisor 1, which
// adds a window's cells in (t, h, w) order).  At most 98 compares or adds per
// output element against 2-8 bytes moved: memory traffic again.  A block
// walks a tile's output frames along T and stages each input frame's band
// once, by cp.async into a ring of frame slots in dynamic shared memory (up
// to 227 KB), while it pools the one before; a thread keeps every open
// window along T in registers, so a 3x3x3/s1 pool reads each input frame
// once a block, not three times.  MAX reduces each frame's 2D windows once,
// in the input type (bf16x2 / f16x2 max, NaN kept), and folds that into
// every window along T that covers the frame; AVE adds each frame's cells
// into each window that covers it, in f32.  The tile path is instantiated
// only for the windows and modes I3D runs: MAX at 3x3x3/s1 (PW 4), 3x3x3/s2
// and 2x2x2/s2 (PW 2), AVE at 2x7x7/s1 (its logits pool); every other 3D
// pool takes the scalar path.  The tile comes from ops/poolk.py:plan3d.

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

// ---- 3D: (N, T, H, W, C) ---------------------------------------------------

constexpr int kMaxSmem3Bytes = 227 * 1024;  // a block's dynamic shared memory on Hopper
// Frames a block stages at once: one pooled, two in flight.  Of 2, 3 and 4,
// 3 was the fastest over I3D's twelve 3D pools in a sweep of tiles on an
// H100 (PERF.md, section 6); ops/poolk.py:RING sizes the ring to match.
constexpr int kRing = 3;

struct Geom3 {
  int n, t, h, w, c;   // input (N, T, H, W, C)
  int to, ho, wo;      // output frames, rows and columns
  int kt, kh, kw, st, sh, sw, pt, ph, pw;
};

struct Tile3 {
  int tx, toh, cv;                              // threads along a row, output rows, vectors
  int tt;                                       // output frames a block
  int t_tiles, row_tiles, col_tiles, chunks;    // tiles along To, Ho, Wo, channel vectors
};

// the larger of two 16-byte vectors of T, lane by lane, NaN where either
// lane is: MAX needs no f32, since the max of values of T is one of them
template <typename T> __device__ __forceinline__ uint4 vec_max(uint4 a, uint4 b);
template <> __device__ __forceinline__ uint4 vec_max<float>(uint4 a, uint4 b) {
  return make_uint4(__float_as_uint(nan_max(__uint_as_float(a.x), __uint_as_float(b.x))),
                    __float_as_uint(nan_max(__uint_as_float(a.y), __uint_as_float(b.y))),
                    __float_as_uint(nan_max(__uint_as_float(a.z), __uint_as_float(b.z))),
                    __float_as_uint(nan_max(__uint_as_float(a.w), __uint_as_float(b.w))));
}
template <typename V> __device__ __forceinline__ uint4 vec_max2(uint4 a, uint4 b) {
  uint4 r;
  const V* pa = reinterpret_cast<const V*>(&a);
  const V* pb = reinterpret_cast<const V*>(&b);
  V* pr = reinterpret_cast<V*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) pr[i] = __hmax2_nan(pa[i], pb[i]);
  return r;
}
template <> __device__ __forceinline__ uint4 vec_max<__nv_bfloat16>(uint4 a, uint4 b) {
  return vec_max2<__nv_bfloat162>(a, b);
}
template <> __device__ __forceinline__ uint4 vec_max<__half>(uint4 a, uint4 b) {
  return vec_max2<__half2>(a, b);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 3D tile path, instantiated for each window and mode that a model runs.
// A block owns toh output rows x tx * PW output columns x cv channel
// vectors of tt output frames.  It walks the input frames under them in
// order, each staged once into a ring of kRing slots (the band of one frame
// a slot) by cp.async, kRing - 1 frames ahead of the one it pools.  A
// thread keeps the running result of every output frame whose window is
// open, at most SLOTS = ceil(KT / ST) of them, in registers: slot 0 the
// oldest.  Each staged frame is pooled once over its 2D windows (MAX: one
// partial max folded into every open slot; AVE: its cells added into each
// open slot in (h, w) order, so a window's cells are added in (t, h, w)
// order); a slot is written out when its window's last frame has been
// pooled.  Frames in the T padding are never staged: -inf changes no max,
// and +0.0 changes no sum that starts from +0.0.
template <typename T, int KT, int KH, int KW, int ST, int SH, int SW, int PW, int SLOTS,
          bool AVE>
__global__ void __launch_bounds__(kMaxThreads)
pool3d_tile_kernel(const T* __restrict__ x, T* __restrict__ out, Geom3 g, Tile3 t) {
  constexpr int EL = 16 / sizeof(T);
  extern __shared__ uint4 ring[];
  const int cv = t.cv;

  // consecutive blocks: neighbouring column tiles, then row tiles, then
  // frame tiles, of one chunk of one clip
  int b = blockIdx.x;
  const int ct = b % t.col_tiles;
  b /= t.col_tiles;
  const int rt = b % t.row_tiles;
  b /= t.row_tiles;
  const int tk = b % t.t_tiles;
  b /= t.t_tiles;
  const int chunk = b % t.chunks;
  const long long n = b / t.chunks;
  const int oh0 = rt * t.toh, ow0 = ct * t.tx * PW;
  const int ih0 = oh0 * SH - g.ph, iw0 = ow0 * SW - g.pw;
  const int band_h = (t.toh - 1) * SH + KH, band_w = (t.tx * PW - 1) * SW + KW;
  const int plane = band_h * band_w * cv;
  const int groups = g.c / EL, v0 = chunk * cv;
  // the block's output frames [o_lo, o_hi) and the input frames [f_lo, f_hi) under them
  const int o_lo = tk * t.tt, o_hi = min(o_lo + t.tt, g.to);
  const int f_lo = max(o_lo * ST - g.pt, 0);
  const int f_hi = min((o_hi - 1) * ST - g.pt + KT, g.t);
  const int frames = f_hi - f_lo;

  const T fill = fill_value<T, AVE>();
  uint4 fill_vec;
  T* fv = reinterpret_cast<T*>(&fill_vec);
#pragma unroll
  for (int e = 0; e < EL; ++e) fv[e] = fill;

  // A thread stages channel vector v of every step-th pixel of the band
  // (consecutive threads on consecutive vectors, then pixels, so the loads
  // coalesce), the same cells of every frame: its first pixel's row and
  // column are divided out once and then stepped.  The padding's cells are
  // the same in every frame, so they are written at a slot's first use only.
  const int v = threadIdx.x % cv, lane_pix = threadIdx.x / cv, step = blockDim.x / cv;
  const int step_r = step / band_w, step_q = step % band_w;
  const int r_first = lane_pix / band_w, q_first = lane_pix % band_w;
  const bool vec_in = v0 + v < groups;
  const T* clip = x + n * g.t * g.h * static_cast<long long>(g.w) * g.c + (v0 + v) * EL;
  auto stage = [&](int k) {
    uint4* buf = ring + (k % kRing) * plane + v;
    const bool first_use = k < kRing;
    const T* frame = clip + static_cast<long long>(f_lo + k) * g.h * g.w * g.c;
    int r = ih0 + r_first, q = iw0 + q_first;
    for (int pix = lane_pix; pix < band_h * band_w; pix += step) {
      if (vec_in && r >= 0 && r < g.h && q >= 0 && q < g.w) {
        cp_async16(buf + pix * cv, frame + (static_cast<long long>(r) * g.w + q) * g.c);
      } else if (first_use) {
        buf[pix * cv] = fill_vec;
      }
      r += step_r;
      q += step_q;
      if (q >= iw0 + band_w) {
        q -= band_w;
        ++r;
      }
    }
  };
  for (int k = 0; k < kRing - 1; ++k) {
    if (k < frames) stage(k);
    cp_async_commit();
  }

  const int tx = lane_pix % t.tx, ty = lane_pix / t.tx;
  const int oh = oh0 + ty, ow = ow0 + tx * PW;
  const bool active = ty < t.toh && oh < g.ho && ow < g.wo && vec_in;

  uint4 mx[SLOTS][PW];         // MAX: each open window's max so far, in T
  float sum[SLOTS][PW][EL];    // AVE: each open window's f32 sum so far
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      if constexpr (AVE) {
#pragma unroll
        for (int e = 0; e < EL; ++e) sum[s][p][e] = 0.0f;
      } else {
        mx[s][p] = fill_vec;
      }
    }
  }
  const float div_hw = AVE ? static_cast<float>(window_extent(oh, SH, g.ph, KH, g.h)) : 1.0f;
  T* dst = out + (n * g.to * g.ho + oh) * static_cast<long long>(g.wo) * g.c +
           static_cast<long long>(ow) * g.c + (v0 + v) * EL;
  const long long frame_stride = static_cast<long long>(g.ho) * g.wo * g.c;

  int o_first = o_lo;  // the output frame in slot 0
  for (int k = 0; k < frames; ++k) {
    const int f = f_lo + k;
    // frame k has landed, and every thread is done with frame k - 1, whose
    // slot the frame kRing - 1 ahead takes
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (k + kRing - 1 < frames) stage(k + kRing - 1);
    cp_async_commit();

    if (active) {
      const uint4* corner =
          ring + (k % kRing) * plane + (ty * SH * band_w + tx * PW * SW) * cv + v;
      if constexpr (AVE) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int o = o_first + s;
          if (o >= o_hi || o * ST - g.pt > f) continue;
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
                  for (int e = 0; e < EL; ++e) take<true>(sum[s][p][e], to_f32(cell[e]));
                }
              }
            }
          }
        }
      } else {
        uint4 part[PW];
#pragma unroll
        for (int p = 0; p < PW; ++p) part[p] = fill_vec;
#pragma unroll
        for (int i = 0; i < KH; ++i) {
          const uint4* row = corner + i * band_w * cv;
#pragma unroll
          for (int q = 0; q < (PW - 1) * SW + KW; ++q) {
            const uint4 raw = row[q * cv];
#pragma unroll
            for (int p = 0; p < PW; ++p) {
              const int j = q - p * SW;
              if (j >= 0 && j < KW) part[p] = vec_max<T>(part[p], raw);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int o = o_first + s;
          if (o >= o_hi || o * ST - g.pt > f) continue;
#pragma unroll
          for (int p = 0; p < PW; ++p) mx[s][p] = vec_max<T>(mx[s][p], part[p]);
        }
      }
    }

    // write out and drop the windows that end at this frame (at the last
    // frame of the clip, every one left: their ends lie in the padding)
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (o_first >= o_hi || (o_first * ST - g.pt + KT - 1 > f && f != g.t - 1)) break;
      if (active) {
        T* o_dst = dst + o_first * frame_stride;
        const float div_thw =
            AVE ? div_hw * static_cast<float>(window_extent(o_first, ST, g.pt, KT, g.t)) : 1.0f;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          if (ow + p >= g.wo) break;
          uint4 packed;
          if constexpr (AVE) {
            T* o = reinterpret_cast<T*>(&packed);
            // the route's divisor grid is the f32 product of the three axes'
            // divisors, small integers, so exact in any order
            const float div =
                div_thw * static_cast<float>(window_extent(ow + p, SW, g.pw, KW, g.w));
#pragma unroll
            for (int e = 0; e < EL; ++e) o[e] = from_f32<T>(__fdiv_rn(sum[0][p][e], div));
          } else {
            packed = mx[0][p];
          }
          *reinterpret_cast<uint4*>(o_dst + static_cast<long long>(p) * g.c) = packed;
        }
      }
      // the slots move down one; the last starts afresh
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) {
        const int next = r + 1 < SLOTS ? r + 1 : r;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          if constexpr (AVE) {
#pragma unroll
            for (int e = 0; e < EL; ++e) sum[r][p][e] = next > r ? sum[next][p][e] : 0.0f;
          } else {
            mx[r][p] = next > r ? mx[next][p] : fill_vec;
          }
        }
      }
      ++o_first;
    }
  }
}

// The 3D scalar path: one thread per output element, loads from device
// memory.  It takes every window and mode the tile path is not
// instantiated for.
template <typename T, bool AVE>
__global__ void pool3d_scalar_kernel(const T* __restrict__ x, T* __restrict__ out, Geom3 g,
                                     long long total) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= total) return;
  const int ch = static_cast<int>(id % g.c);
  long long pix = id / g.c;
  const int ow = static_cast<int>(pix % g.wo);
  pix /= g.wo;
  const int oh = static_cast<int>(pix % g.ho);
  pix /= g.ho;
  const int ot = static_cast<int>(pix % g.to);
  const long long n = pix / g.to;
  const int f0 = ot * g.st - g.pt, r0 = oh * g.sh - g.ph, q0 = ow * g.sw - g.pw;
  float acc = acc_start<AVE>();
  for (int a = 0; a < g.kt; ++a) {
    const int f = f0 + a;
    for (int i = 0; i < g.kh; ++i) {
      const int r = r0 + i;
      for (int j = 0; j < g.kw; ++j) {
        const int q = q0 + j;
        const bool inside = f >= 0 && f < g.t && r >= 0 && r < g.h && q >= 0 && q < g.w;
        if (!AVE && !inside) continue;
        const float v =
            inside ? to_f32(x[(((n * g.t + f) * g.h + r) * g.w + q) * g.c + ch]) : 0.0f;
        take<AVE>(acc, v);
      }
    }
  }
  if constexpr (AVE) {
    const float div = static_cast<float>(window_extent(ot, g.st, g.pt, g.kt, g.t)) *
                      static_cast<float>(window_extent(oh, g.sh, g.ph, g.kh, g.h)) *
                      static_cast<float>(window_extent(ow, g.sw, g.pw, g.kw, g.w));
    acc = __fdiv_rn(acc, div);
  }
  out[id] = from_f32<T>(acc);
}

constexpr int kMaxDevices = 64;

template <typename T, int KT, int KH, int KW, int ST, int SH, int SW, int PW, int SLOTS,
          bool AVE>
int launch_tile3(const void* x, void* out, const Geom3& g, const Tile3& t, int threads,
                 int smem, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(g.n) * t.chunks * t.t_tiles * t.row_tiles *
                           t.col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pool3d_tile_kernel<T, KT, KH, KW, ST, SH, SW, PW, SLOTS, AVE>;
  // the most dynamic shared memory a block may ask, set once a device
  static bool opened[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opened[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem3Bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opened[device] = true;
  }
  kernel<<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), g, t);
  return static_cast<int>(cudaGetLastError());
}

// The tile comes from ops/poolk.py:plan3d, which sends the tile path only
// the windows and modes instantiated below; here it is only checked against
// the kernel's limits, as in 2D, and against the slots a thread keeps.
template <typename T, bool AVE>
int dispatch3(const void* x, void* out, const Geom3& g, bool tiled, int per, const Tile3& t,
              int threads, int smem, cudaStream_t stream) {
  if (!tiled) {
    const long long total = static_cast<long long>(g.n) * g.to * g.ho * g.wo * g.c;
    const int block = 256;
    const long long blocks = (total + block - 1) / block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    pool3d_scalar_kernel<T, AVE><<<static_cast<unsigned int>(blocks), block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), g, total);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int EL = 16 / sizeof(T);
  const long long band = static_cast<long long>((t.toh - 1) * g.sh + g.kh) *
                         ((t.tx * per - 1) * g.sw + g.kw) * t.cv * 16;
  if (g.c % EL != 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 ||
      t.tx < 1 || t.toh < 1 || t.cv < 1 || t.tt < 1 ||
      g.pt >= g.kt || (g.to - 1) * g.st - g.pt >= g.t || threads != t.cv * t.tx * t.toh ||
      threads > kMaxThreads ||
      band * kRing > smem || smem > kMaxSmem3Bytes ||
      static_cast<long long>(t.t_tiles) * t.tt < g.to ||
      static_cast<long long>(t.row_tiles) * t.toh < g.ho ||
      static_cast<long long>(t.col_tiles) * t.tx * per < g.wo ||
      static_cast<long long>(t.chunks) * t.cv * EL < g.c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool s1 = g.st == 1 && g.sh == 1 && g.sw == 1;
  const bool s2 = g.st == 2 && g.sh == 2 && g.sw == 2;
  const bool k333 = g.kt == 3 && g.kh == 3 && g.kw == 3;
  if constexpr (AVE) {
    // I3D's logits pool
    if (g.kt == 2 && g.kh == 7 && g.kw == 7 && s1 && per == 1) {
      return launch_tile3<T, 2, 7, 7, 1, 1, 1, 1, 2, true>(x, out, g, t, threads, smem, stream);
    }
  } else {
    // I3D's branch pools, MaxPool3d_4a and MaxPool3d_5a
    if (k333 && s1 && per == 4) {
      return launch_tile3<T, 3, 3, 3, 1, 1, 1, 4, 3, false>(x, out, g, t, threads, smem, stream);
    }
    if (k333 && s2 && per == 2) {
      return launch_tile3<T, 3, 3, 3, 2, 2, 2, 2, 2, false>(x, out, g, t, threads, smem, stream);
    }
    if (g.kt == 2 && g.kh == 2 && g.kw == 2 && s2 && per == 2) {
      return launch_tile3<T, 2, 2, 2, 2, 2, 2, 2, 1, false>(x, out, g, t, threads, smem, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch3_mode(const void* x, void* out, const Geom3& g, int ave, bool tiled, int per,
                   const Tile3& t, int threads, int smem, cudaStream_t stream) {
  return ave ? dispatch3<T, true>(x, out, g, tiled, per, t, threads, smem, stream)
             : dispatch3<T, false>(x, out, g, tiled, per, t, threads, smem, stream);
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

// Plain C entry point of the 3D path, bound with ctypes: (N, T, H, W, C) to
// (N, To, Ho, Wo, C), the window, stride and pad (t, h, w).  ``tiled``
// selects the tile path, which takes MAX at 3x3x3/s1 with ``per`` 4 and at
// 3x3x3/s2 and 2x2x2/s2 with ``per`` 2, and AVE at 2x7x7/s1 with ``per`` 1;
// ``tx``, ``toh``, ``cv`` as in 2D, ``tt`` output frames a block,
// ``t_tiles``, ``row_tiles``, ``col_tiles`` and ``chunks`` tiles along To,
// Ho, Wo and the channel vectors, ``threads`` a block and ``smem`` bytes of
// dynamic shared memory a block (up to 227 KB), all from ops/poolk.py:plan3d.
// Returns as eco_caffe_pool2d.
extern "C" int eco_caffe_pool3d(const void* x, void* out, int n, int t, int h, int w, int c,
                                int to, int ho, int wo, int kt, int kh, int kw, int st, int sh,
                                int sw, int pt, int ph, int pw, int dtype, int ave, int tiled,
                                int per, int tx, int toh, int cv, int tt, int t_tiles,
                                int row_tiles, int col_tiles, int chunks, int threads, int smem,
                                void* stream) {
  if (n < 0 || t < 1 || h < 1 || w < 1 || c < 1 || to < 1 || ho < 1 || wo < 1 || kt < 1 ||
      kh < 1 || kw < 1 || st < 1 || sh < 1 || sw < 1 || pt < 0 || ph < 0 || pw < 0 ||
      per < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Geom3 g{n, t, h, w, c, to, ho, wo, kt, kh, kw, st, sh, sw, pt, ph, pw};
  const Tile3 tile{tx, toh, cv, tt, t_tiles, row_tiles, col_tiles, chunks};
  const bool tl = tiled != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch3_mode<float>(x, out, g, ave, tl, per, tile, threads, smem, s);
    case kBF16:
      return dispatch3_mode<__nv_bfloat16>(x, out, g, ave, tl, per, tile, threads, smem, s);
    case kF16:
      return dispatch3_mode<__half>(x, out, g, ave, tl, per, tile, threads, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
