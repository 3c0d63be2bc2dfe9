// K5: space-to-depth of a channels-last 3D float tensor by 2x2x2 cells, with
// a zero pad made by index, in one pass.
//
// Replaces no TPU kernel.  It was added for the stem of I3D
// (convert/load.py:fold_space_to_depth): a stride-2 convolution over few
// input channels (3 RGB channels, 7x7x7/s2) is a stride-1 convolution of
// ceil(k/2) per axis over the clip rearranged into 2x2x2 cells, 8 x C
// channels a cell; cuDNN runs the second at its implicit-GEMM rate, and the
// first at a few percent of it (a reduction over 3 channels fills no MMA
// tile).  This kernel makes that rearranged clip.
//
// Input : x (N, T, H, W, C) contiguous, f32 / bf16 / f16, C of 1 to 4.
// Output: (N, To, Ho, Wo, Cout) contiguous, in the input type, where
//         To = ceil((T + lo_t + hi_t) / 2) and so on (the last cell of an
//         odd padded extent completed with zeros); channel
//         ((dt * 2 + dh) * 2 + dw) * C + c of
//         cell (t, h, w) is channel c of the input at (2t + dt - lo_t,
//         2h + dh - lo_h, 2w + dw - lo_w), or zero where that lies in the
//         padding; channels 8C .. Cout - 1 are zeros.  A copy of bits, so
//         it is ops/s2d.py:space_to_depth_reference's result in every type.
//
// What bounds it on Hopper: memory traffic, with no arithmetic at all: the
// clip read once and the cells written once (I3D's request of 8 clips in
// bf16: 154 MB read, 178 MB written, 0.099 ms at 3.35 TB/s).  The design:
//   * a thread owns one output cell (8C elements: 48 bytes at I3D's bf16
//     RGB), assembles it in registers and puts it in shared memory as whole
//     16-byte vectors; threads run along the output's cells in memory
//     order, so a warp's loads read the same two input rows of each
//     (dt, dh) for its neighbouring cells, and the block's cells are one
//     contiguous stretch of the output, which its threads then store a
//     16-byte vector each, neighbouring threads on neighbouring vectors;
//   * the pads are index arithmetic: a source outside the clip gives zero
//     bits, and no padded copy is made in device memory;
//   * C and the element width are template parameters, so a cell's loads
//     and its packing into 32-bit words unroll into registers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCellBytes = 128;  // Cout * element bytes: 8 vectors a cell

struct Geom {
  int n, t, h, w, c;   // input (N, T, H, W, C)
  int to, ho, wo;      // output cells along each axis
  int lo_t, lo_h, lo_w;
  int vectors;         // 16-byte vectors a cell: Cout * element bytes / 16
  int cells;           // N * To * Ho * Wo
};

template <int E> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };

// cell ``cell``'s g.vectors 16-byte vectors, to ``dst``: its first 8C
// elements (C channels a pixel, E bytes an element) from the input, zeros
// after them
template <int C, int E, typename U>
__device__ __forceinline__ void assemble(const U* __restrict__ x, const Geom& g, int cell,
                                         uint4* dst) {
  constexpr int kElems = 8 * C;
  constexpr int kWords = kElems * E / 4;       // 32-bit words from the input
  constexpr int kVectors = kElems * E / 16;    // whole 16-byte vectors of them
  static_assert(kElems * E % 16 == 0, "a cell is whole 16-byte vectors");
  int r = cell;
  const int wo = r % g.wo;
  r /= g.wo;
  const int ho = r % g.ho;
  r /= g.ho;
  const int to = r % g.to;
  const int n = r / g.to;

  unsigned int words[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) words[i] = 0u;
#pragma unroll
  for (int dt = 0; dt < 2; ++dt) {
    const int t = 2 * to + dt - g.lo_t;
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {
      const int h = 2 * ho + dh - g.lo_h;
      const bool row = t >= 0 && t < g.t && h >= 0 && h < g.h;
      const long long base = (static_cast<long long>(n) * g.t + t) * g.h + h;
#pragma unroll
      for (int dw = 0; dw < 2; ++dw) {
        const int w = 2 * wo + dw - g.lo_w;
        if (!row || w < 0 || w >= g.w) continue;
        const U* src = x + (base * g.w + w) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = ((dt * 2 + dh) * 2 + dw) * C + c;  // element of the cell
          const unsigned int v = __ldg(src + c);
          if constexpr (E == 4) {
            words[j] = v;
          } else {
            words[j / 2] |= v << (16 * (j % 2));
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVectors; ++i) {
    dst[i] = make_uint4(words[4 * i], words[4 * i + 1], words[4 * i + 2], words[4 * i + 3]);
  }
  for (int i = kVectors; i < g.vectors; ++i) dst[i] = make_uint4(0u, 0u, 0u, 0u);
}

// a block's kThreads cells, a thread each, staged in shared memory and then
// stored as one contiguous stretch, a 16-byte vector a thread at a time
template <int C, int E>
__global__ void __launch_bounds__(kThreads) s2d_kernel(const void* __restrict__ x,
                                                       uint4* __restrict__ out, Geom g) {
  __shared__ uint4 stage[kThreads * kMaxCellBytes / 16];
  const int first = blockIdx.x * kThreads;
  const int cell = first + threadIdx.x;
  if (cell < g.cells) {
    assemble<C, E>(static_cast<const typename Word<E>::type*>(x), g, cell,
                   stage + threadIdx.x * g.vectors);
  }
  __syncthreads();
  const int count = min(kThreads, g.cells - first) * g.vectors;
  uint4* dst = out + static_cast<long long>(first) * g.vectors;
  for (int k = threadIdx.x; k < count; k += kThreads) dst[k] = stage[k];
}

template <int E>
int launch(const void* x, void* out, const Geom& g, cudaStream_t stream) {
  const int blocks = (g.cells + kThreads - 1) / kThreads;
  uint4* o = static_cast<uint4*>(out);
  switch (g.c) {
    case 1: s2d_kernel<1, E><<<blocks, kThreads, 0, stream>>>(x, o, g); break;
    case 2: s2d_kernel<2, E><<<blocks, kThreads, 0, stream>>>(x, o, g); break;
    case 3: s2d_kernel<3, E><<<blocks, kThreads, 0, stream>>>(x, o, g); break;
    case 4: s2d_kernel<4, E><<<blocks, kThreads, 0, stream>>>(x, o, g); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes: (N, T, H, W, C) of ``elem_bytes``-
// byte elements (2: bf16 or f16, 4: f32) to (N, To, Ho, Wo, Cout), the cells
// 2x2x2 and the low pads (lo_t, lo_h, lo_w); the high pads, with the zeros
// that complete the last cell, are what is left of 2 * To - T - lo_t and so
// on.  Returns cudaGetLastError() after the
// launch (0 on success); a shape, pad or width it does not take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int eco_space_to_depth(const void* x, void* out, int n, int t, int h, int w, int c,
                                  int to, int ho, int wo, int cout, int lo_t, int lo_h,
                                  int lo_w, int elem_bytes, void* stream) {
  if (n < 0 || t < 1 || h < 1 || w < 1 || c < 1 || c > 4 || to < 1 || ho < 1 || wo < 1 ||
      lo_t < 0 || lo_h < 0 || lo_w < 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      cout < 8 * c || cout * elem_bytes % 16 != 0 || cout * elem_bytes > kMaxCellBytes ||
      2 * to < t + lo_t || 2 * ho < h + lo_h || 2 * wo < w + lo_w ||
      (reinterpret_cast<uintptr_t>(x) % elem_bytes) || (reinterpret_cast<uintptr_t>(out) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cells = static_cast<long long>(n) * to * ho * wo;
  if (cells > INT32_MAX - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (cells == 0) return 0;
  const Geom g{n, t, h, w, c, to, ho, wo, lo_t, lo_h, lo_w, cout * elem_bytes / 16,
               static_cast<int>(cells)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2 ? launch<2>(x, out, g, s) : launch<4>(x, out, g, s);
}
