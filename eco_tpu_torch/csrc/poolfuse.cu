// Caffe ceil-mode 3x3 / stride-2 max pool (pad 0) on channels-last tensors,
// with an optional per-channel affine and ReLU applied first.
//
// Replaces the Pallas TPU kernel eco_tpu/ops/pallas/poolfuse.py:73
// (fused_maxpool_3x3s2, body _kernel at :38).
//
// Input : x (N, H, W, C) contiguous, f32 / bf16 / f16, H and W even, W >= 4;
//         optional f32 scale (C,) and shift (C,).
// Output: (N, H/2, W/2, C) contiguous, in the input type:
//           out[n, i, j, c] = max over rows 2i..2i+2 and columns 2j..2j+2
//         of z, where z = relu(x * scale[c] + shift[c]) (affine, in f32),
//         relu(x) (relu), or x.  Row H and column W lie outside the input
//         (the clipped last window of Caffe's ceil mode) and count as the
//         fill value: 0 after the affine or the ReLU, -3e38 (rounded to the
//         input type) otherwise, as in the TPU kernel.
//
// What bounds it on Hopper: memory traffic.  Nine compares per output
// element; at pool1 of ECO-Lite (128, 112, 112, 64) bf16 the kernel reads
// 205.5 MB and writes 51.4 MB, far below the card's compute line.  The
// design only tries to read each input byte from device memory once and to
// keep accesses coalesced:
//   * one thread per output pixel and 16-byte channel vector (8 bf16/f16 or
//     4 f32), consecutive threads along C, then along the output column, so
//     each of a thread's nine 16-byte loads and its one store are coalesced
//     across the warp.  Rows and columns shared by neighbouring windows are
//     re-read from L1/L2, not from device memory;
//   * the clipped last row and column are skipped by bounds and replaced by
//     one max with the fill, so no padded copy is written;
//   * a scalar path (one thread per output element) takes a C whose row is
//     not a whole number of 16-byte vectors, or an unaligned pointer.
// The TPU kernel's (N, H, W/2, 2C) view, which turns column parity into a
// lane subrange because Mosaic has no strided slice, has no counterpart.
//
// Bit-exact with the plain PyTorch version: the affine is __fmul_rn then
// __fadd_rn (nvcc would otherwise contract it into an FMA, which PyTorch's
// separate multiply and add do not do); every other value is a value of the
// input type, so the max is exact, and a NaN anywhere in a window gives NaN,
// as ATen's max_pool2d and jnp.maximum do.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

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

// max that returns NaN when either side is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Epilogue {
  const float* scale;  // (C,) or null
  const float* shift;  // (C,) or null
  bool affine;
  bool relu;
};

__device__ __forceinline__ float transform(float v, const Epilogue& ep, float sc, float sh) {
  if (ep.affine) v = __fadd_rn(__fmul_rn(v, sc), sh);
  if (ep.affine || ep.relu) v = nan_max(v, 0.0f);
  return v;
}

// EL channels per thread: EL * sizeof(T) == 16 on the vector path, 1 on the
// scalar path.
template <typename T, int EL>
__global__ void maxpool_3x3s2_kernel(const T* __restrict__ x, T* __restrict__ out,
                                     Epilogue ep, int H, int W, int C, long long total) {
  constexpr bool kVec = EL * sizeof(T) == 16;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int groups = C / EL;
  const int Ho = H / 2, Wo = W / 2;
  const int cg = static_cast<int>(t % groups);
  long long pix = t / groups;
  const int j = static_cast<int>(pix % Wo);
  pix /= Wo;
  const int i = static_cast<int>(pix % Ho);
  const long long n = pix / Ho;
  const int c0 = cg * EL;

  float sc[EL], sh[EL], acc[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) {
    sc[e] = ep.affine ? ep.scale[c0 + e] : 1.0f;
    sh[e] = ep.affine ? ep.shift[c0 + e] : 0.0f;
    acc[e] = __int_as_float(0xff800000);  // -inf
  }
  const int r0 = 2 * i, q0 = 2 * j;
  const int r_end = min(r0 + 3, H), q_end = min(q0 + 3, W);
  for (int r = r0; r < r_end; ++r) {
    const T* row = x + (n * H + r) * W * static_cast<long long>(C) + c0;
    for (int q = q0; q < q_end; ++q) {
      const T* src = row + static_cast<long long>(q) * C;
      if constexpr (kVec) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          acc[e] = nan_max(acc[e], transform(to_f32(v[e]), ep, sc[e], sh[e]));
        }
      } else {
        acc[0] = nan_max(acc[0], transform(to_f32(src[0]), ep, sc[0], sh[0]));
      }
    }
  }
  if (r_end - r0 < 3 || q_end - q0 < 3) {
    // the fill of the non-ReLU variant is -3e38 rounded to the input type
    const float fill = (ep.affine || ep.relu) ? 0.0f : to_f32(from_f32<T>(-3.0e38f));
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[e] = nan_max(acc[e], fill);
  }
  if constexpr (kVec) {
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int e = 0; e < EL; ++e) o[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<uint4*>(out + t * EL) = packed;
  } else {
    out[t] = from_f32<T>(acc[0]);
  }
}

template <typename T>
int launch(const void* x, void* out, Epilogue ep, int n, int h, int w, int c,
           bool vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int el = vec ? kVec : 1;
  const long long total = static_cast<long long>(n) * (h / 2) * (w / 2) * (c / el);
  if (total == 0) return 0;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned int>((total + threads - 1) / threads));
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (vec) {
    maxpool_3x3s2_kernel<T, kVec><<<grid, threads, 0, stream>>>(xi, o, ep, h, w, c, total);
  } else {
    maxpool_3x3s2_kernel<T, 1><<<grid, threads, 0, stream>>>(xi, o, ep, h, w, c, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  ``vec`` selects the 16-byte
// vector path; the caller sets it only when C * sizeof(T) is a multiple of
// 16 and both pointers are 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 on success); a bad dtype or shape returns
// cudaErrorInvalidValue.
extern "C" int eco_fused_maxpool_3x3s2(const void* x, const void* scale, const void* shift,
                                       void* out, int n, int h, int w, int c, int dtype,
                                       int affine, int relu, int vec, void* stream) {
  if (h % 2 != 0 || w % 2 != 0 || w < 4 || h < 2 || c < 1 || (affine && (!scale || !shift))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(shift),
                    affine != 0, relu != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (vec && c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch<float>(x, out, ep, n, h, w, c, vec != 0, s);
    case kBF16:
      if (vec && c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch<__nv_bfloat16>(x, out, ep, n, h, w, c, vec != 0, s);
    case kF16:
      if (vec && c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch<__half>(x, out, ep, n, h, w, c, vec != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
