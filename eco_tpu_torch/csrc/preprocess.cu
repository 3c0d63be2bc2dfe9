// Fused crop + mirror + mean subtraction + cast of raw uint8 video frames.
//
// Replaces the Pallas TPU kernel eco_tpu/ops/pallas/preprocess.py:40
// (crop_normalize) together with the mirror that its wrapper
// preprocess_on_device applies after the kernel.
//
// Input : frames uint8 (N, S, H, W, 3) BGR, contiguous, at any address;
//         aug (3, N) int32 or int64 on the device: rows h_off, w_off, mirror.
// Output: (N, S, crop, crop, 3) contiguous, 16-byte aligned, one of
//           f32 / bf16 : x - mean[c]
//           int8       : clip(rint((x - mean[c]) / act_scale), -127, 127)
//
// What bounds it on Hopper: memory traffic.  There is one subtraction (and,
// for int8, one division) per byte; a 128-frame batch at crop 224 reads
// 19.3 MB of the frames and writes 38.5 MB of bf16: 0.0173 ms at 3.35 TB/s
// (f32 0.0288 ms, int8 0.0115 ms), far below the card's compute line.  On an
// H100 (700 W) the previous kernel (a block per output row, a thread per pixel,
// byte loads and 2-byte stores) took 0.037 / 0.041 / 0.050 ms of device time
// in bf16 / f32 / int8, and, run alone, the instructions per value and not
// the bytes set its pace: its bf16 and f32 times differ by 10% for twice the
// bytes, and int8 divides once per value.  The design:
//   * A block works on a row group: R consecutive output rows of one frame,
//     the frame's rows split as evenly as a 44 KB stage allows (R = 56 at
//     crop 224: 37.6 KB of source, one contiguous output span).  The
//     per-video setup (offsets, clamp, mirror) is done once per group, in
//     32-bit arithmetic.  Groups of 8 rows were markedly slower than groups
//     of 56 in every type: the per-group cost (two barriers, the geometry,
//     a last partial pass of the threads) is paid 7x less often.
//   * Loads: each row's 3*crop source bytes are copied with 16-byte
//     cp.async.cg into shared memory as their 16-byte-aligned superset (the
//     idea of the TPU kernel's aligned window, which there was forced by
//     Mosaic's tiling; here it buys 16-byte transactions).  The chunk that
//     holds the frames' first or last byte, which can reach outside the
//     tensor (a view at an odd address, the last row of the last frame), is
//     copied byte by byte with only the bytes inside it read.
//   * Blocks are persistent: a grid of at most (SMs x resident blocks, 2 at
//     crop 224) walks the groups, every block given the same number, with a
//     ring of two stages: the next group's loads fly while one is converted.
//   * Compute, where crop is a multiple of 16 / sizeof(out) (crop 224 in
//     every type): a thread makes a unit of 16 / sizeof(out) pixels, three
//     16-byte vectors of output, from the unit's contiguous source bytes
//     (reverse pixel order when mirrored), read as realigned words; every
//     byte position and channel is then known at compile time.  A byte
//     becomes an exact float with one byte permute (0x4B0000xx is 2^23+xx),
//     so a value costs a permute and two adds; int8 values come from a
//     3 x 256 table per block, made with the IEEE division (at most 2-way
//     bank conflicts: a channel's 256 bytes hold 2 words per bank).
//   * Stores: a warp's 32 units are one contiguous 1,536-byte span; they go
//     through the warp's slot of shared memory, so each 16-byte store of
//     the warp writes 512 contiguous bytes (three direct stores at a 48-byte
//     stride made f32 slower than the previous kernel).
//   * Other crops (odd ones, e.g. 7, or CaffeNet's 227: 681 values a row,
//     rows split 57/57/57/56) take a general path: 16 bytes of output per
//     thread, value by value from shared memory (int8 from the table), and a
//     group span's head and tail that are not 16-byte aligned stored value
//     by value.
//   * Offsets are clamped into the frame (as lax.dynamic_slice clamps), so
//     no window reads outside its frame whatever the offsets hold.
// With the loads, or the converts and stores, left out, each alone takes
// about its bytes' time at the card's practical rate (a plain fill of the
// output), and the kernel about their sum: what is left is mostly bytes.
// chip_smoke.py prints the kernel's time in each type beside its bound: on
// an H100 (700 W), 0.0219 / 0.0360 / 0.0197 ms in bf16 / f32 / int8, 79% /
// 80% / 58% of the bound.  ptxas: 40 / 40 / 32 registers, no spills.
//
// Every value is an integer in [-123, 151], exact in bf16; the int8 path
// divides by act_scale (not by its reciprocal) and rounds half to even with
// rintf, as jnp.round and torch.round do.  So the kernel equals its plain
// PyTorch version bit for bit.  Built without --use_fast_math: the division
// must stay IEEE round-to-nearest.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxRowsPerGroup = 64;
constexpr int kStageBytes = 45056;  // a group's source rows, at most
constexpr int kWarpStageBytes = kThreads / 32 * 32 * 48;

enum OutKind : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

// Each output type's bits for a value x - mean[c].
template <typename OutT> struct Out;
template <> struct Out<float> {
  using Bits = uint32_t;
  __device__ static Bits bits(float v, float) { return __float_as_uint(v); }
};
template <> struct Out<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ static Bits bits(float v, float) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Out<int8_t> {
  using Bits = uint8_t;
  __device__ static Bits bits(float v, float act_scale) {
    float q = rintf(v / act_scale);
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    return static_cast<uint8_t>(static_cast<int8_t>(q));
  }
};

struct Params {
  const uint8_t* frames;
  unsigned long long frames_bytes;
  const void* aug;  // (3, videos) int32, or int64 when aug64
  int aug64;
  void* out;
  int videos, segments, height, width, crop;
  int rows_per_group, row_bytes;  // row_bytes: one row's slot in a stage
  int groups;
  float mean0, mean1, mean2, act_scale;
};

// One row group: frame t, output rows y0 .. y0+rows-1, the clamped offsets,
// the mirror, and the byte offset of its first source row's window.
struct Group {
  long long src;
  int t, y0, rows;
  bool flip;
};

// 32-bit index arithmetic (the entry point checks that the groups fit).
__device__ __forceinline__ Group group_at(const Params& p, int g) {
  const int per_frame = (p.crop + p.rows_per_group - 1) / p.rows_per_group;
  Group o;
  o.t = g / per_frame;
  o.y0 = (g - o.t * per_frame) * p.rows_per_group;
  o.rows = min(p.rows_per_group, p.crop - o.y0);
  const int n = o.t / p.segments;
  long long h, w, m;
  if (p.aug64) {
    const auto* a = static_cast<const long long*>(p.aug);
    h = a[n], w = a[p.videos + n], m = a[2 * p.videos + n];
  } else {
    const auto* a = static_cast<const int32_t*>(p.aug);
    h = a[n], w = a[p.videos + n], m = a[2 * p.videos + n];
  }
  const int h0 = static_cast<int>(min(max(h, 0LL), static_cast<long long>(p.height - p.crop)));
  const int w0 = static_cast<int>(min(max(w, 0LL), static_cast<long long>(p.width - p.crop)));
  o.flip = m != 0;
  o.src = ((static_cast<long long>(o.t) * p.height + h0 + o.y0) * p.width + w0) * 3;
  return o;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of group g's source rows into buf: row r's aligned
// superset at buf + r * row_bytes, its first byte at offset (address & 15).
__device__ __forceinline__ void load_group(const Params& p, const Group& g, uint8_t* buf) {
  const int span = 3 * p.crop;
  const long long w3 = 3LL * p.width;
  const int chunks = p.row_bytes / 16;
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.frames);
  const uintptr_t end = base + p.frames_bytes;
  for (int i = threadIdx.x; i < g.rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const uintptr_t row = base + g.src + r * w3;
    const uintptr_t chunk = (row & ~static_cast<uintptr_t>(15)) + 16u * c;
    if (chunk >= row + span) continue;  // past this row's window
    uint8_t* dst = buf + r * p.row_bytes + 16 * c;
    if (chunk >= base && chunk + 16 <= end) {
      cp_async16(dst, reinterpret_cast<const void*>(chunk));
    } else {  // holds the frames' first or last byte: read only what is inside
      for (int k = 0; k < 16; ++k) {
        const uintptr_t a = chunk + k;
        dst[k] = a >= base && a < end ? *reinterpret_cast<const uint8_t*>(a) : 0;
      }
    }
  }
}

// 3*kVec source bytes from shared memory at any byte address s, realigned
// into words: t[i] holds bytes 4i .. 4i+3.  Reads up to 4 bytes past the span
// (row slots are padded for it).
template <int kWords>
__device__ __forceinline__ void load_span(const uint8_t* s, uint32_t (&t)[kWords]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const unsigned shift = static_cast<unsigned>(a & 3) * 8;
  uint32_t lo = w[0];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t hi = w[i + 1];
    t[i] = __funnelshift_r(lo, hi, shift);
    lo = hi;
  }
}

// Byte b of word as an exact float: 0x4B0000xx is 2^23 + xx.
__device__ __forceinline__ float byte_value(uint32_t word, int b) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | b)) - 8388608.0f;
}

// Group g when crop is a multiple of kVec (crop 224 in every type): each
// thread makes a unit of kVec pixels, 3*kVec output values (48 bytes), from
// 3*kVec contiguous source bytes (in reverse pixel order when mirrored), so
// every byte position and channel is known at compile time.  int8 values
// come from lut[c * 256 + x], made with the IEEE division.  A warp's 32 units
// are one contiguous 1,536-byte span of the output (rows follow each other
// in a group): they pass through the warp's slot of shared memory, so each
// of its three 16-byte stores writes 512 contiguous bytes.
template <typename OutT, bool kFlip>
__device__ __forceinline__ void store_group_units(const Params& p, const Group& g,
                                                  const uint8_t* buf, const uint8_t* lut,
                                                  uint4* stage) {
  using Bits = typename Out<OutT>::Bits;
  constexpr int kVec = 16 / sizeof(Bits);
  constexpr int kUnit = 3 * kVec;            // values (and source bytes) of a unit
  constexpr int kPerWord = 4 / sizeof(Bits);
  const int span = 3 * p.crop;
  const int units = span / kUnit;            // a row's units
  const int total = g.rows * units;
  const int lane = threadIdx.x % 32;
  uint4* out = reinterpret_cast<uint4*>(static_cast<Bits*>(p.out) +
                                        (static_cast<long long>(g.t) * p.crop + g.y0) * span);
  const unsigned off0 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p.frames) + g.src) & 15u;
  const unsigned w3lo = static_cast<unsigned>(3LL * p.width) & 15u;
  const float mean[3] = {p.mean0, p.mean1, p.mean2};
  for (int first = threadIdx.x - lane; first < total; first += blockDim.x) {
    const int i = first + lane;
    if (i < total) {
      const int r = i / units, j0 = (i - r * units) * kUnit;
      const uint8_t* row = buf + r * p.row_bytes + ((off0 + r * w3lo) & 15u);
      uint32_t src[kUnit / 4];
      load_span(row + (kFlip ? span - j0 - kUnit : j0), src);
      uint32_t o[kUnit / kPerWord];
#pragma unroll
      for (int k = 0; k < kUnit / kPerWord; ++k) o[k] = 0u;
#pragma unroll
      for (int k = 0; k < kUnit; ++k) {
        const int c = k % 3;
        const int b = kFlip ? 3 * (kVec - 1 - k / 3) + c : k;  // source byte of value k
        uint32_t bits;
        if constexpr (sizeof(Bits) == 1) {
          bits = lut[c * 256 + __byte_perm(src[b / 4], 0u, 0x4440u | (b % 4))];
        } else {
          bits = Out<OutT>::bits(byte_value(src[b / 4], b % 4) - mean[c], p.act_scale);
        }
        o[k / kPerWord] |= bits << (8 * sizeof(Bits) * (k % kPerWord));
      }
#pragma unroll
      for (int v = 0; v < 3; ++v)
        stage[3 * lane + v] = make_uint4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const int q = 32 * v + lane;  // the warp's 16-byte chunk q is unit q/3's
      if (first + q / 3 < total) out[3 * first + q] = stage[q];
    }
    __syncwarp();
  }
}

// Convert group g from buf and store its output span, value by value from
// shared memory: any crop (the general path).  int8 values come from the
// block's table, as in the unit path.
template <typename OutT>
__device__ __forceinline__ void store_group_general(const Params& p, const Group& g,
                                            const uint8_t* buf, const uint8_t* lut) {
  using Bits = typename Out<OutT>::Bits;
  constexpr int kVec = 16 / sizeof(Bits);
  constexpr int kPerWord = 4 / sizeof(Bits);
  const int span = 3 * p.crop;
  const long long e0 = (static_cast<long long>(g.t) * p.crop + g.y0) * span;  // first output element
  const int count = g.rows * span;
  Bits* out = static_cast<Bits*>(p.out) + e0;
  const unsigned off0 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p.frames) + g.src) & 15u;
  const unsigned w3lo = static_cast<unsigned>(3LL * p.width) & 15u;
  const bool flip = g.flip;

  // element j (channel c) of row r of the group
  auto value = [&](int r, int j, int c) -> Bits {
    const unsigned off = (off0 + r * w3lo) & 15u;
    const int col = flip ? span - 3 - j + 2 * c : j;
    const uint8_t x = buf[r * p.row_bytes + off + col];
    if constexpr (sizeof(Bits) == 1) {
      return lut[c * 256 + x];
    } else {
      const float mean = c == 0 ? p.mean0 : (c == 1 ? p.mean1 : p.mean2);
      return Out<OutT>::bits(static_cast<float>(x) - mean, p.act_scale);
    }
  };

  // the span's unaligned head and tail, value by value (out is 16-aligned)
  const int head = min(count, static_cast<int>((kVec - e0 % kVec) % kVec));
  const int vecs = (count - head) / kVec;
  const int tail = head + vecs * kVec;
  for (int i = threadIdx.x; i < head + (count - tail); i += blockDim.x) {
    const int q = i < head ? i : tail + (i - head);
    const int r = q / span, j = q - r * span;
    out[q] = value(r, j, j % 3);
  }
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const int q = head + v * kVec;
    int r = q / span, j = q - r * span, c = j % 3;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      w[k / kPerWord] |= static_cast<uint32_t>(value(r, j, c))
                         << (8 * sizeof(Bits) * (k % kPerWord));
      if (++c == 3) c = 0;
      if (++j == span) j = 0, c = 0, ++r;
    }
    *reinterpret_cast<uint4*>(out + q) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) crop_normalize_kernel(const Params p) {
  using Bits = typename Out<OutT>::Bits;
  constexpr int kVec = 16 / sizeof(Bits);
  extern __shared__ __align__(16) uint8_t smem[];
  const int stage_bytes = p.rows_per_group * p.row_bytes;
  // each warp's 32 x 48-byte slot for the unit path's stores, then (int8
  // only) the table of its 3 x 256 values
  uint4* warp_stage = reinterpret_cast<uint4*>(smem + kStages * stage_bytes) +
                      (threadIdx.x / 32) * 96;
  uint8_t* lut = smem + kStages * stage_bytes + kWarpStageBytes;
  if constexpr (sizeof(Bits) == 1) {
    for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) {
      const int c = i / 256;
      lut[i] = Out<OutT>::bits(static_cast<float>(i % 256) -
                                   (c == 0 ? p.mean0 : (c == 1 ? p.mean1 : p.mean2)),
                               p.act_scale);
    }
  }
  const bool units = p.crop % kVec == 0;
  const int step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int g = blockIdx.x + s * step;
    if (g < p.groups) load_group(p, group_at(p, g), smem + s * stage_bytes);
    cp_async_commit();
  }
  int stage = 0;
  for (int g = blockIdx.x; g < p.groups; g += step) {
    // refill the stage that the previous group was read from
    const int ahead = g + (kStages - 1) * step;
    if (ahead < p.groups)
      load_group(p, group_at(p, ahead), smem + ((stage + kStages - 1) % kStages) * stage_bytes);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Group grp = group_at(p, g);
    const uint8_t* buf = smem + stage * stage_bytes;
    if (!units)
      store_group_general<OutT>(p, grp, buf, lut);
    else if (grp.flip)
      store_group_units<OutT, true>(p, grp, buf, lut, warp_stage);
    else
      store_group_units<OutT, false>(p, grp, buf, lut, warp_stage);
    __syncthreads();
    stage = (stage + 1) % kStages;
  }
}

template <typename OutT>
int launch(Params p, cudaStream_t stream) {
  const int stage_bytes = p.rows_per_group * p.row_bytes;
  const int smem = kStages * stage_bytes + kWarpStageBytes + (sizeof(OutT) == 1 ? 3 * 256 : 0);
  auto* kernel = crop_normalize_kernel<OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block takes the same number of groups, so no SM waits on a last one
  const long long slots = static_cast<long long>(sms) * resident;
  const long long per_block = (p.groups + slots - 1) / slots;
  const long long blocks = (p.groups + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success); an unknown out_kind, an output that is not
// 16-byte aligned or a row too wide for shared memory returns
// cudaErrorInvalidValue.
extern "C" int eco_crop_normalize(
    const void* frames, const void* aug, int aug64, void* out, int videos,
    int segments, int height, int width, int crop, float mean0, float mean1,
    float mean2, int out_kind, float act_scale, void* stream) {
  Params p;
  p.frames = static_cast<const uint8_t*>(frames);
  p.frames_bytes = static_cast<unsigned long long>(videos) * segments * height * width * 3;
  p.aug = aug;
  p.aug64 = aug64;
  p.out = out;
  p.videos = videos, p.segments = segments, p.height = height, p.width = width;
  p.crop = crop;
  // a row's slot: its window's aligned superset (up to 15 bytes before the
  // window) and 4 bytes more for the word reads of the last unit
  p.row_bytes = (3 * crop + 15 + 4 + 15) / 16 * 16;
  // as many rows as fit in a stage, then as even a split of the frame's
  // rows as that count allows
  const int max_rows = std::min(std::max(kStageBytes / p.row_bytes, 1), kMaxRowsPerGroup);
  const int per_frame = (crop + max_rows - 1) / max_rows;
  p.rows_per_group = (crop + per_frame - 1) / per_frame;
  const long long groups = static_cast<long long>(videos) * segments * per_frame;
  p.groups = static_cast<int>(groups);
  p.mean0 = mean0, p.mean1 = mean1, p.mean2 = mean2, p.act_scale = act_scale;
  if (groups == 0) return 0;
  if (groups > (1LL << 30) || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(kStages) * p.rows_per_group * p.row_bytes + kWarpStageBytes +
              3 * 256 > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kF32: return launch<float>(p, s);
    case kBF16: return launch<__nv_bfloat16>(p, s);
    case kInt8: return launch<int8_t>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
