// Row-wise squared distance to a reference row, for Hopper (sm_90a).
//
//   out[i] = sum_j (x[i, j] - r[i / k, j])^2
//            x (m, P), r (g, P) with k = m / g rows per group, out (m,) f32
//
// g = 1 (k = m) is every row against one reference; g > 1 is a fleet of
// g clusters, each row against its own cluster's reference, in the same
// single launch (the reference runs jax.vmap over the Pallas kernel).
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
// Design: a deterministic reduction in ONE launch, no atomics in any sum,
// so the same inputs give the same bits on every run (the threshold
// compare must be reproducible). Grid (k, S, g): block (i, s, c) reduces
// columns [s*seg, (s+1)*seg) of row c*k + i in f32 -- each thread a fixed strided
// subset in a fixed order, then warp shuffles, then shared memory -- and
// writes partial[i, s]. The S column splits let m*S fill the SMs several
// times over even when the fleet has few rows. Then the block makes its
// partial visible (__threadfence) and takes a ticket from row i's counter
// (atomicAdd); the block that takes the last ticket sums the row's S
// partials, each thread a fixed strided subset in order, then the same
// block sum, and resets the counter to 0 for the next call. The ticket
// decides only WHICH block sums, never the order of the sum, so every
// value has the bits of the earlier two-launch form (partials, then a
// second kernel summing them in this order). The counters live in a
// small per-(device, stream) buffer that the wrapper zeroes once.
// Loads are plain coalesced scalar loads: a row of the mnist_cnn plane
// has P = 1,199,882 = 2 (mod 4) elements, so every odd row starts 8
// bytes off a 16-byte boundary and a float4 load there would fault.
// The group is the grid's z index (grid (k, S, g)), so a block finds its
// row and its reference row without a division. g = 1 launches the
// ungrouped instantiation (kGrouped = false): the earlier kernel's code,
// blocks and bits; the grouped one differs only in those two offsets.
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

template <typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
    sqdist_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  float* __restrict__ partial, float* __restrict__ out,
                  unsigned int* __restrict__ tickets, int64_t P,
                  int64_t seg) {
  const int64_t row =
      kGrouped ? static_cast<int64_t>(blockIdx.z) * gridDim.x + blockIdx.x
               : static_cast<int64_t>(blockIdx.x);
  const int64_t split = blockIdx.y;
  const int S = static_cast<int>(gridDim.y);
  const int64_t begin = split * seg;
  const int64_t end = begin + seg < P ? begin + seg : P;
  const T* __restrict__ xr = x + row * P;
  if (kGrouped) r += static_cast<int64_t>(blockIdx.z) * P;  // its reference

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

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[row * S + split] = v;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(tickets + row, 1u) == static_cast<unsigned>(S - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the row's partials, in a fixed order whichever block came last
  const volatile float* pr = partial + row * S;
  float sum = 0.0f;
  for (int s = threadIdx.x; s < S; s += kThreads) sum += pr[s];
  const float total = block_sum(sum);
  if (threadIdx.x == 0) {
    out[row] = total;
    tickets[row] = 0u;  // ready for the next call
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and r share it). r holds m / k
// reference rows, row i of x is held against r row i / k (k = m: one
// reference). partial is an (m, S) f32 scratch buffer, out the m f32
// results, tickets m counters that read 0 (the kernel leaves them at 0);
// seg * S >= P. One launch. Returns its CUDA error code (0 = cudaSuccess).
extern "C" int repro_sqdist_rows(int dtype, const void* x, const void* r,
                                 float* partial, float* out,
                                 unsigned int* tickets, long long m,
                                 long long P, long long seg, int S,
                                 long long k, void* stream) {
  if (k < 1 || m % k != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>(S),
                  static_cast<unsigned>(m / k));
  const bool grouped = k != m;
  if (dtype == 0) {
    auto* kernel =
        grouped ? sqdist_kernel<float, true> : sqdist_kernel<float, false>;
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(r), partial,
        out, tickets, P, seg);
  } else if (dtype == 1) {
    auto* kernel = grouped ? sqdist_kernel<__nv_bfloat16, true>
                           : sqdist_kernel<__nv_bfloat16, false>;
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(r), partial, out, tickets, P, seg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
