// The gradient of the RMS norm over the last axis, for Hopper (sm_90a), in
// f32 or bf16 (the math f32 in both):
//
//   y[i]  = x[i] * r[i] * scale[i / R],  r[i] = 1 / sqrt(mean(x[i]^2) + eps)
//   dx[i] = r[i] * dy[i] * s - x[i] * r[i]^3 / D * sum(dy[i] * s * x[i])
//   dscale[g] = sum over the rows i of group g of dy[i] * x[i] * r[i]
//
// x, dy, dx (rows, D); scale, dscale (g, D), g groups of R = rows / g
// consecutive rows (g = 1 for a model's norm, g = m for m learners' norms
// under the learners' vmap, as the forward's grouped scale). All five in
// one dtype, f32 or bf16: bf16 values are read into f32, every sum and
// product is f32, and dx and dscale are rounded to bf16 once, as the
// reference's norm (src/repro/models/layers.py, rms_norm) computes in f32
// and casts its result; the dscale partials stay f32.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel
// (its training path differentiates a jnp norm). On the card the port's
// forward is rmsnorm.cu, so its gradient is a kernel too.
//
// Bound: device-memory bytes (x and dy read, dx written, the scale read and
// dscale written, each at its dtype's width; ~9 flops an element).
//
// Design: two launches, no atomics, fixed orders, so a given card gives the
// same bits on every run.
//   1. rows: one block of `threads` per chunk of up to `chunk_rows`
//      consecutive rows of one group (the wrapper picks both,
//      rmsnorm.py::bwd_plan, from the shapes alone). A row is two passes
//      over its columns, thread t taking columns t, t + threads, ...: the
//      first sums dy s x and x^2 (each thread in column order, then an xor
//      butterfly in each warp, then every thread adds the warp sums in warp
//      order), the second writes dx and adds dy x r to the chunk's dscale
//      partial, a D-float row in shared memory whose column c only thread
//      c % threads touches. The block writes its partial row.
//   2. scale: dscale[g, c] sums column c of the group's partial rows in
//      chunk order, one thread a column.
// Loads are scalar and coalesced, so any row offset and any D work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kScaleThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                            const T* __restrict__ scales,
                            const T* __restrict__ dy,
                            T* __restrict__ dx,
                            float* __restrict__ partial, int D,
                            int group_rows, int chunk_rows,
                            int chunks_per_group, float eps) {
  extern __shared__ float sp[];  // D floats: this chunk's dscale partial
  __shared__ float warp_a[kMaxThreads / 32], warp_b[kMaxThreads / 32];
  const int n = static_cast<int>(blockDim.x), t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = n >> 5;
  const int chunk = static_cast<int>(blockIdx.x);
  const int gi = chunk / chunks_per_group;
  const int ci = chunk - gi * chunks_per_group;
  const long long r0 =
      static_cast<long long>(gi) * group_rows +
      static_cast<long long>(ci) * chunk_rows;
  const int nr = min(chunk_rows, group_rows - ci * chunk_rows);
  const T* s = scales + static_cast<long long>(gi) * D;
  for (int j = t; j < D; j += n) sp[j] = 0.0f;

  for (int rr = 0; rr < nr; ++rr) {
    const long long row = r0 + rr;
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float a = 0.0f, b = 0.0f;
    for (int j = t; j < D; j += n) {
      const float xv = to_f32(xr[j]);
      a = fmaf(to_f32(gr[j]) * to_f32(s[j]), xv, a);
      b = fmaf(xv, xv, b);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      warp_a[warp] = a;
      warp_b[warp] = b;
    }
    __syncthreads();
    float sa = 0.0f, sb = 0.0f;
    for (int w = 0; w < nw; ++w) {
      sa += warp_a[w];
      sb += warp_b[w];
    }
    __syncthreads();  // the warp sums are read before the next row's
    const float r = 1.0f / sqrtf(sb / static_cast<float>(D) + eps);
    const float coef = sa * (r * r * r) / static_cast<float>(D);
    T* dr = dx + row * D;
    for (int j = t; j < D; j += n) {
      const float xv = to_f32(xr[j]), gv = to_f32(gr[j]);
      dr[j] = from_f32<T>(gv * to_f32(s[j]) * r - xv * coef);
      sp[j] = fmaf(gv, xv * r, sp[j]);
    }
  }
  float* pr = partial + static_cast<long long>(chunk) * D;
  for (int j = t; j < D; j += n) pr[j] = sp[j];
}

template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
    rmsnorm_bwd_scale_kernel(const float* __restrict__ partial,
                             T* __restrict__ dscale, int D,
                             int chunks_per_group) {
  const int col = blockIdx.x * kScaleThreads + threadIdx.x;
  const int gi = blockIdx.y;
  if (col >= D) return;
  const float* p =
      partial + static_cast<long long>(gi) * chunks_per_group * D + col;
  float acc = 0.0f;
  for (int k = 0; k < chunks_per_group; ++k)
    acc += p[static_cast<long long>(k) * D];
  dscale[static_cast<long long>(gi) * D + col] = from_f32<T>(acc);
}

template <typename T>
int launch(const T* x, const T* scale, const T* dy, T* dx, T* dscale,
           float* partial, int D, long long groups, long long group_rows,
           int chunk_rows, long long cpg, int threads, float eps,
           cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(float) * D);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_rows_kernel<T><<<static_cast<unsigned>(groups * cpg), threads,
                               smem, s>>>(
      x, scale, dy, dx, partial, D, static_cast<int>(group_rows), chunk_rows,
      static_cast<int>(cpg), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D + kScaleThreads - 1) / kScaleThreads,
                  static_cast<unsigned>(groups));
  rmsnorm_bwd_scale_kernel<T><<<grid, kScaleThreads, 0, s>>>(
      partial, dscale, D, static_cast<int>(cpg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16, for x, scale, dy, dx and dscale alike. x,
// dy and dx are (rows, D) contiguous; scale and dscale (rows / group_rows,
// D); partial f32 scratch of (rows / group_rows) * ceil(group_rows /
// chunk_rows) rows of D floats. threads: a multiple of 32 up to 512. D * 4
// bytes of shared memory a block. Two launches on `stream`; returns the
// CUDA error code of the first that fails (0 = cudaSuccess).
extern "C" int repro_rmsnorm_bwd(int dtype, const void* x, const void* scale,
                                 const void* dy, void* dx, void* dscale,
                                 void* partial, long long rows, int D,
                                 long long group_rows, int chunk_rows,
                                 int threads, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || rows < 1 || group_rows < 1 || rows % group_rows ||
      (dtype != 0 && dtype != 1) ||
      group_rows > 0x7fffffffLL || chunk_rows < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = rows / group_rows;
  const long long cpg = (group_rows + chunk_rows - 1) / chunk_rows;
  if (groups * cpg > 0x7fffffffLL || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dscale), static_cast<float*>(partial), D, groups,
        group_rows, chunk_rows, cpg, threads, eps, s);
  using bf16 = __nv_bfloat16;
  return launch<bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(dscale), static_cast<float*>(partial), D, groups,
      group_rows, chunk_rows, cpg, threads, eps, s);
}
