// RMS normalization over the last axis, for Hopper (sm_90a).
//
//   y[i, :] = x[i, :] * rsqrt(mean(x[i, :]^2) + eps) * scale[i / R]
//
// x (rows, D); scale (g, D), g groups of R = rows / g consecutive rows (g =
// 1 for a model's norm; g = m when m learners' norms run as one launch
// under the learners' vmap). Statistics in f32, y in x's dtype (f32 or
// bf16; scale has x's dtype).
//
// Replaces the Pallas kernel of src/repro/kernels/rmsnorm.py (rmsnorm,
// _rmsnorm_kernel). The decoder LM runs it 2L + 1 times per forward and per
// decode step: norm_mix and norm_ffn in every block, and final_norm.
//
// Bound: device-memory bytes. Per element it does ~4 flops against 4 bytes
// moved in bf16 (read x, write y) or 8 in f32, far below the card's
// flop-per-byte ridge, so the least time is x read once and y written once
// over the memory rate. What stands between a row and that rate is how
// many rows an SM keeps in flight and how long each one's chain (load,
// reduce, scale, store) takes.
//
// Design. Every load and store of the row's body is a 16-byte vector (8
// bf16 or 4 f32 values), and the row stays in registers between the sum of
// squares and the scaling, so x is read from device memory once. A thread
// keeps at most 2 vectors (4 past 2,048 vectors a row), so a thread needs
// few registers and an SM holds up to 64 warps. On an H100 (PERF.md §6)
// that beat, at every zoo width from 1,600 up, one warp a row with the
// whole row in its lanes (7-32 vectors a lane, so few warps an SM). Two
// forms, picked by the wrapper from D and the dtype (rmsnorm.py::plan):
//   * block: one block a row, 2 vectors a thread (rows of up to 2,048
//     vectors: 16,384 bf16 or 8,192 f32 values, 1,024 threads; a row of up
//     to 64 vectors takes one warp), then 4 (up to 4,096 vectors). Shared
//     memory holds only the warp sums; two barriers.
//   * stream: longer rows (up to MAX_D), 1,024 threads: the same
//     reduction, and the scaling pass reads the row again (from L2).
// The edges are paths of the kernel: a row that does not start on 16 bytes
// (D * itemsize not a multiple of 16, or x a view at an odd offset) has a
// scalar head up to its first 16-byte boundary and a scalar tail after its
// last whole vector; scale and y take vectors where they share the row's
// alignment, scalars where they do not. Every thread sums its values in a
// fixed order, and the xor butterfly leaves the same bits in every lane (a
// + b = b + a), so the same row gives the same bits on every run (no
// atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

template <typename T>
struct Vec {  // values of a 16-byte vector
  static constexpr int N = 16 / sizeof(T);
};

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

// a 16-byte vector's values as f32, and back (round to nearest, as
// from_f32)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// kForm: 0 = block (one row a block, the row in registers), 1 = stream
// (one row a block, read twice). NV: vectors a thread keeps. With at most 2
// vectors a thread the kernel is held to 32 registers, so two 1,024-thread
// blocks (64 warps) fit an SM: at 40 registers one did, and (4, 2048,
// 16,384) bf16 took 0.228 ms, not 0.181 (chip_smoke.py).
// kGrouped: scale has a row per group of group_rows rows (a separate
// instantiation, so the one-scale forms keep their registers: the group's
// offset cost the bf16 two-vector form a 12-byte spill at 32 registers).
template <typename T, int NV, int kForm, bool kGrouped>
__global__ void __launch_bounds__(kMaxThreads, NV <= 2 ? 2 : 1)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scales,
                   T* __restrict__ y, int D, unsigned group_rows,
                   float eps) {
  constexpr int V = Vec<T>::N;
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float row_sum;
  const int n = static_cast<int>(blockDim.x);
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  // this row's group (rows < 2^31, so 32-bit division)
  const T* scale =
      kGrouped ? scales + static_cast<long long>(blockIdx.x / group_rows) * D
               : scales;
  // the row: a scalar head of h values up to its first 16-byte boundary,
  // nb whole vectors, a scalar tail of nt values
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(xr) & 15u) / sizeof(T));
  const int h = min(D, mis ? V - mis : 0);
  const int nb = (D - h) / V;
  const int tail = h + nb * V, nt = D - tail;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + h);

  uint4 buf[kForm == 1 ? 1 : NV];
  float ss = 0.0f;
  if (kForm == 1) {
    for (int j = t; j < nb; j += n) {
      float f[V];
      unpack<T>(__ldg(xv + j), f);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += f[e] * f[e];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * n;
      if (j < nb) buf[i] = __ldg(xv + j);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * n;
      if (j < nb) {
        float f[V];
        unpack<T>(buf[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) ss += f[e] * f[e];
      }
    }
  }
  const float hx = t < h ? to_f32(xr[t]) : 0.0f;
  const float tx = t < nt ? to_f32(xr[tail + t]) : 0.0f;
  ss += hx * hx;
  ss += tx * tx;
  ss = warp_sum(ss);
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < n / 32 ? warp_sums[lane] : 0.0f;
    v = warp_sum(v);
    if (lane == 0) row_sum = v;
  }
  __syncthreads();
  ss = row_sum;
  const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);

  // scale and y in vectors where they share the row's alignment
  const bool s_vec = aligned16(scale + h), y_vec = aligned16(yr + h);
  const uint4* sv = reinterpret_cast<const uint4*>(scale + h);
  auto out = [&](int j, const uint4& u) {
    float f[V], s[V];
    unpack<T>(u, f);
    if (s_vec) {
      unpack<T>(__ldg(sv + j), s);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] = to_f32(scale[h + j * V + e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = f[e] * r * s[e];
    if (y_vec) {
      reinterpret_cast<uint4*>(yr + h)[j] = pack<T>(f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) yr[h + j * V + e] = from_f32<T>(f[e]);
    }
  };
  if (kForm == 1) {
    for (int j = t; j < nb; j += n) out(j, __ldg(xv + j));
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * n;
      if (j < nb) out(j, buf[i]);
    }
  }
  if (t < h) yr[t] = from_f32<T>(hx * r * to_f32(scale[t]));
  if (t < nt) yr[tail + t] = from_f32<T>(tx * r * to_f32(scale[tail + t]));
}

template <typename T, int NV, int kForm>
int launch(const void* x, const void* scale, void* y, long long rows, int D,
           long long group_rows, float eps, int threads, cudaStream_t s) {
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  if (group_rows == rows)
    rmsnorm_kernel<T, NV, kForm, false><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(y), D, 0u, eps);
  else
    rmsnorm_kernel<T, NV, kForm, true><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(y), D, static_cast<unsigned>(group_rows), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int form, int nv, int threads, const void* x, const void* scale,
             void* y, long long rows, int D, long long group_rows, float eps,
             cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  const long long nb = D / V;  // whole vectors a row holds at most
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0 && nb <= 1LL * threads * nv) {
    if (nv == 2) return launch<T, 2, 0>(x, scale, y, rows, D, group_rows, eps,
                                       threads, s);
    if (nv == 4) return launch<T, 4, 0>(x, scale, y, rows, D, group_rows, eps,
                                       threads, s);
  }
  if (form == 1)
    return launch<T, 1, 1>(x, scale, y, rows, D, group_rows, eps, threads,
                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, scale and y share it). x and y are
// (rows, D) contiguous, scale (rows / group_rows, D), row i normed with
// scale row i / group_rows (group_rows = rows: one scale); any alignment
// of x and scale that their dtype allows. form, nv, threads: the plan (rmsnorm.py::plan), with
// n = D / (16 / itemsize) the whole vectors of a row: form 0 = one block
// of `threads` a row, the row in registers (nv 2 or 4, n <= nv threads);
// form 1 = one block of `threads` a row, read twice. Returns the CUDA
// error code of the launch (0 = cudaSuccess).
extern "C" int repro_rmsnorm(int dtype, int form, int nv, int threads,
                             const void* x, const void* scale, void* y,
                             long long rows, int D, long long group_rows,
                             float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || rows < 1 || group_rows < 1 || rows % group_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(form, nv, threads, x, scale, y, rows, D,
                           group_rows, eps, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(form, nv, threads, x, scale, y, rows, D,
                                   group_rows, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
