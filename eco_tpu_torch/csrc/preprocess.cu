// Fused crop + mirror + mean subtraction + cast of raw uint8 video frames.
//
// Replaces the Pallas TPU kernel eco_tpu/ops/pallas/preprocess.py:40
// (crop_normalize) together with the mirror that its wrapper
// preprocess_on_device applies after the kernel.
//
// Input : frames uint8 (N, S, H, W, 3) BGR, contiguous; per-video int32
//         h_off (N,), w_off (N,) and uint8 mirror (N,) on the device.
// Output: (N, S, crop, crop, 3) contiguous, one of
//           f32 / bf16 : x - mean[c]
//           int8       : clip(rint((x - mean[c]) / act_scale), -127, 127)
//
// What bounds it on Hopper: memory traffic.  There is one subtraction (and,
// for int8, one division) per byte; a 128-frame batch at crop 224 reads
// 128*224*224*3 = 19.3 MB of the frames and writes 38.5 MB of bf16, far
// below the card's compute line.  The design therefore only tries to touch
// each byte once and to keep accesses coalesced:
//   * one block per output row (frame t, row y); thread x owns output pixel
//     x and its three channels, so a warp reads 96 consecutive source bytes
//     and writes 96 consecutive outputs.  On an H100 (700 W) this ran in
//     0.0386 ms at (8, 16, 256, 340, 3) to bf16, against 0.0576 ms for one
//     thread per output byte (consecutive threads on consecutive bytes, a
//     divide by 3 and a select per byte) timed in the same process;
//   * the mirror is folded into the source column (x_src = crop-1-x, channel
//     order kept), so no second pass flips the output;
//   * only the crop window is read: the TPU kernel's aligned superset window
//     and its VMEM rotates were Mosaic alignment workarounds and have no
//     counterpart here;
//   * offsets are clamped into the frame (as lax.dynamic_slice clamps), so
//     the kernel never reads outside the frame whatever the offsets hold.
//
// Every value is an integer in [-123, 151], exact in bf16; the int8 path
// divides by act_scale (not by its reciprocal) and rounds half to even with
// rintf, as jnp.round and torch.round do.  So the kernel equals its plain
// PyTorch version bit for bit.  Built without --use_fast_math: the division
// must stay IEEE round-to-nearest.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum OutKind : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

__device__ __forceinline__ void store(float* p, float v, float) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store(int8_t* p, float v, float act_scale) {
  float q = rintf(v / act_scale);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  *p = static_cast<int8_t>(q);
}

template <typename OutT>
__global__ void crop_normalize_kernel(
    const uint8_t* __restrict__ frames, const int32_t* __restrict__ h_off,
    const int32_t* __restrict__ w_off, const uint8_t* __restrict__ mirror,
    OutT* __restrict__ out, int segments, int height, int width, int crop,
    float mean0, float mean1, float mean2, float act_scale) {
  const long long row = blockIdx.x;  // over N*S*crop output rows
  const int y = static_cast<int>(row % crop);
  const long long t = row / crop;    // frame index in [0, N*S)
  const int n = static_cast<int>(t / segments);

  const int h0 = min(max(h_off[n], 0), height - crop);
  const int w0 = min(max(w_off[n], 0), width - crop);
  const bool flip = mirror[n] != 0;

  const uint8_t* src = frames + ((t * height) + h0 + y) * (3LL * width) + 3LL * w0;
  OutT* dst = out + row * (3LL * crop);
  for (int x = threadIdx.x; x < crop; x += blockDim.x) {
    const uint8_t* px = src + 3 * (flip ? crop - 1 - x : x);
    OutT* o = dst + 3 * x;
    store(o + 0, static_cast<float>(px[0]) - mean0, act_scale);
    store(o + 1, static_cast<float>(px[1]) - mean1, act_scale);
    store(o + 2, static_cast<float>(px[2]) - mean2, act_scale);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success); an unknown out_kind returns cudaErrorInvalidValue.
extern "C" int eco_crop_normalize(
    const void* frames, const void* h_off, const void* w_off,
    const void* mirror, void* out, int videos, int segments, int height,
    int width, int crop, float mean0, float mean1, float mean2, int out_kind,
    float act_scale, void* stream) {
  const long long rows = static_cast<long long>(videos) * segments * crop;
  if (rows == 0) return 0;
  // one thread per output pixel of the row, in whole warps, at most 256
  const int threads = ((crop + 31) / 32) * 32 < 256 ? ((crop + 31) / 32) * 32 : 256;
  const dim3 grid(static_cast<unsigned int>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* ho = static_cast<const int32_t*>(h_off);
  const auto* wo = static_cast<const int32_t*>(w_off);
  const auto* m = static_cast<const uint8_t*>(mirror);
  switch (out_kind) {
    case kF32:
      crop_normalize_kernel<float><<<grid, threads, 0, s>>>(
          f, ho, wo, m, static_cast<float*>(out), segments, height, width,
          crop, mean0, mean1, mean2, act_scale);
      break;
    case kBF16:
      crop_normalize_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
          f, ho, wo, m, static_cast<__nv_bfloat16*>(out), segments, height,
          width, crop, mean0, mean1, mean2, act_scale);
      break;
    case kInt8:
      crop_normalize_kernel<int8_t><<<grid, threads, 0, s>>>(
          f, ho, wo, m, static_cast<int8_t*>(out), segments, height, width,
          crop, mean0, mean1, mean2, act_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
