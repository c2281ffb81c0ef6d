// RMS normalization over the last axis, for Hopper (sm_90a).
//
//   y[i, :] = x[i, :] * rsqrt(mean(x[i, :]^2) + eps) * scale     x (rows, D)
//
// statistics in f32, y in x's dtype (f32 or bf16; scale has x's dtype).
//
// Replaces the Pallas kernel of src/repro/kernels/rmsnorm.py (rmsnorm,
// _rmsnorm_kernel). The decoder LM runs it 2L + 1 times per forward and per
// decode step: norm_mix and norm_ffn in every block, and final_norm.
//
// Bound: device-memory bytes. Per element it does ~4 flops against 4 bytes
// moved in bf16 (read x, write y) or 8 in f32, far below the card's
// flop-per-byte ridge, so the least time is x read once and y written once
// over the memory rate.
//
// Design: one block of 256 threads per row. Each thread reads a fixed
// strided subset of the row from device memory once, keeps it as f32 in
// shared memory, and sums its squares in a fixed order; a fixed-order block
// reduction (warp shuffles, then shared memory) gives the row's sum of
// squares, so the same row gives the same bits on every run (no atomics).
// The scale pass then reads the row back from shared memory, not from
// device memory. D is at most 56K f32 values (the shared memory a block
// may use); rows above 12,288 values need the opt-in dynamic size, which
// the launcher requests. Loads are scalar and coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int D, float eps) {
  extern __shared__ float row[];
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * D;

  float acc = 0.0f;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    const float v = to_f32(x[base + j]);
    row[j] = v;
    acc += v * v;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) inv_rms = 1.0f / sqrtf(v / static_cast<float>(D) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int j = threadIdx.x; j < D; j += kThreads)
    y[base + j] = from_f32<T>(row[j] * r * to_f32(scale[j]));
}

template <typename T>
int launch(const void* x, const void* scale, void* y, long long rows, int D,
           float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(y), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, scale and y share it). x and y are
// (rows, D) contiguous, scale (D,). Returns the CUDA error code of the
// launch (0 = cudaSuccess).
extern "C" int repro_rmsnorm(int dtype, const void* x, const void* scale,
                             void* y, long long rows, int D, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, y, rows, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, y, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
