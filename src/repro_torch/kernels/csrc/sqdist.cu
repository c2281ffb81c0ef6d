// Row-wise squared distance to a reference row, for Hopper (sm_90a).
//
//   out[i] = sum_j (x[i, j] - r[j])^2      x (m, P), r (P,), out (m,) f32
//
// Replaces the Pallas kernels of src/repro/kernels/sqdist.py:
// sqdist_rows (_sqdist_rows_kernel) and, with m = 1, sqdist
// (_sqdist_kernel). These distances are every learner's local condition
// ||f_i - r||^2 on the flat fleet plane; the protocol compares them with
// the threshold Delta, and that comparison sets the communication
// counters.
//
// Bound: device-memory bytes. The work is 3 flops per element against
// 4 bytes (f32) or 2 bytes (bf16) read, far below the card's
// flop-per-byte ridge, so the least time is the bytes of x and r over
// the memory rate.
//
// Design: a deterministic two-pass reduction, no atomics, so the same
// inputs give the same bits on every run (the threshold compare must be
// reproducible).
//   pass 1, grid (m, S): block (i, s) reduces columns [s*seg, (s+1)*seg)
//     of row i in f32 -- each thread a fixed strided subset in a fixed
//     order, then warp shuffles, then shared memory -- and writes
//     partial[i, s]. The S column splits let m*S fill the SMs several
//     times over even when the fleet has few rows.
//   pass 2, grid (m,): block i sums its row's S partials in a fixed order.
// Loads are plain coalesced scalar loads: a row of the mnist_cnn plane
// has P = 1,199,882 = 2 (mod 4) elements, so every odd row starts 8
// bytes off a 16-byte boundary and a float4 load there would fault.
// Rows must be contiguous; the Python wrapper checks that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of one float per thread; the result is valid in thread 0. The
// order of additions is fixed by the block shape alone.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sqdist_partial_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          float* __restrict__ partial, int64_t P,
                          int64_t seg) {
  const int64_t row = blockIdx.x;
  const int64_t split = blockIdx.y;
  const int64_t begin = split * seg;
  const int64_t end = begin + seg < P ? begin + seg : P;
  const T* __restrict__ xr = x + row * P;

  float acc[kUnroll] = {0.0f, 0.0f, 0.0f, 0.0f};
  int64_t j = begin + threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < end; j += kUnroll * kThreads) {
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      d[u] = to_f32(xr[j + u * kThreads]) - to_f32(r[j + u * kThreads]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] += d[u] * d[u];
  }
  for (; j < end; j += kThreads) {
    const float d = to_f32(xr[j]) - to_f32(r[j]);
    acc[0] += d * d;
  }
  const float v = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (threadIdx.x == 0) partial[row * gridDim.y + split] = v;
}

__global__ void __launch_bounds__(kThreads)
    sqdist_finish_kernel(const float* __restrict__ partial,
                         float* __restrict__ out, int S) {
  const int64_t row = blockIdx.x;
  float acc = 0.0f;
  for (int s = threadIdx.x; s < S; s += kThreads) acc += partial[row * S + s];
  const float v = block_sum(acc);
  if (threadIdx.x == 0) out[row] = v;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and r share it). partial is an
// (m, S) f32 scratch buffer, out the (m,) f32 result; seg * S >= P.
// Returns the CUDA error code of the launches (0 = cudaSuccess).
extern "C" int repro_sqdist_rows(int dtype, const void* x, const void* r,
                                 float* partial, float* out, long long m,
                                 long long P, long long seg, int S,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(m), static_cast<unsigned>(S));
  if (dtype == 0) {
    sqdist_partial_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(r), partial,
        P, seg);
  } else if (dtype == 1) {
    sqdist_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(r), partial, P, seg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sqdist_finish_kernel<<<static_cast<unsigned>(m), kThreads, 0, s>>>(
      partial, out, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
