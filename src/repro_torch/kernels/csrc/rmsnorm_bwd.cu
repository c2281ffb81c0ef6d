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
//      over its columns: the first sums dy s x and x^2 (each thread in
//      column order, then an xor butterfly in each warp, then every thread
//      adds the warp sums in warp order), the second writes dx and adds
//      dy x r to the chunk's dscale partial, each column's in row order.
//      The block writes its partial row.
//        * f32: thread t takes columns t, t + threads, ..., scalar and
//          coalesced, any row offset and any D; the partial is a D-float
//          row in shared memory whose column c only thread c % threads
//          touches.
//        * bf16: the forward's split (rmsnorm.cu). Every load and store of
//          a row's body is a 16-byte vector of 8 values, after a scalar
//          head up to the row's first 16-byte boundary and before a scalar
//          tail; thread t takes the head's column t, vectors t, t +
//          threads, ... (NV of them at most) and the tail's column t. A
//          thread's vectors of x and dy come by cp.async into its own
//          slots of a ring of K rows in shared memory (K = 4, 2 at NV = 4),
//          so K - 1 rows are in flight while one is summed and written,
//          and x and dy are read from device memory once. dy, dx and the
//          scale take vectors where they share x's alignment, scalars where
//          they do not. Where D is a multiple of 8 every row has the same
//          head, so a thread's columns are the same in every row: their
//          scale values and dscale partials stay in its registers;
//          otherwise (a head that moves from row to row) the partials live
//          in shared memory, as f32's.
//   2. scale: dscale[g, c] sums column c of the group's partial rows in
//      chunk order, one thread a column, from pieces of the rows that a
//      block of 256 threads loads into shared memory together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kScaleThreads = 256;
constexpr int kScaleCols = 32;    // columns a block of the scale kernel
constexpr int kScalePiece = 256;  // partial rows it loads at once

__device__ __forceinline__ float to_f32(float v) { return v; }
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// a vector's 8 bf16 values as f32
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// 8 values rounded to bf16 (to nearest even) as one vector
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 bf16 values from p: one 16-byte load where `vec`, else 8 scalar ones
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint16_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __bfloat16_as_ushort(p[e]);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = h[2 * i] | (uint32_t(h[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A bf16 row as the vector kernel splits it: a scalar head of h values up
// to x's first 16-byte boundary, nb whole vectors, a scalar tail of nt
struct Split {
  int h, nb, tail, nt;
};
__device__ __forceinline__ Split split_row(const __nv_bfloat16* xr, int D) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(xr) & 15u) / 2);
  Split p;
  p.h = min(D, mis ? 8 - mis : 0);
  p.nb = (D - p.h) / 8;
  p.tail = p.h + p.nb * 8;
  p.nt = D - p.tail;
  return p;
}

// 16 bytes from global to shared memory without registers, and the
// groups that wait for them
__device__ __forceinline__ void cp_async16(const void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows in flight a block of the bf16 form: its ring's slots
template <int NV>
__host__ __device__ constexpr int ring_rows() {
  return NV == 2 ? 4 : 2;
}

// bf16 rows, NV vectors a thread at most. A thread's vectors of x and dy
// of the next rows come by cp.async into its own slots of a ring in
// shared memory (only it reads them back, so no barrier guards the ring);
// the head and tail values one row ahead in registers. kFixed: D % 8 ==
// 0, so every row splits alike: a thread's columns, its scale values and
// its dscale partials stay in its registers for the whole chunk.
template <int NV, bool kFixed>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ scales,
                                 const __nv_bfloat16* __restrict__ dy,
                                 __nv_bfloat16* __restrict__ dx,
                                 float* __restrict__ partial, int D,
                                 int group_rows, int chunk_rows,
                                 int chunks_per_group, float eps) {
  constexpr int K = ring_rows<NV>();
  // K slots of (x, dy) x NV x threads vectors; then, !kFixed, the chunk's
  // D-float dscale partial
  extern __shared__ uint4 ring[];
  // the warp sums, a buffer for even rows and one for odd ones: a row's
  // are read before any thread passes the next row's barrier, so one
  // barrier a row keeps them
  __shared__ float warp_a[2][kMaxThreads / 32], warp_b[2][kMaxThreads / 32];
  const int n = static_cast<int>(blockDim.x), t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = n >> 5;
  float* sp = reinterpret_cast<float*>(ring + K * 2 * NV * n);
  const int chunk = static_cast<int>(blockIdx.x);
  const int gi = chunk / chunks_per_group;
  const int ci = chunk - gi * chunks_per_group;
  const long long r0 =
      static_cast<long long>(gi) * group_rows +
      static_cast<long long>(ci) * chunk_rows;
  const int nr = min(chunk_rows, group_rows - ci * chunk_rows);
  const __nv_bfloat16* s = scales + static_cast<long long>(gi) * D;
  // dy and dx share x's row offsets; each takes vectors where it also
  // shares x's alignment
  const bool g_vec = ((reinterpret_cast<uintptr_t>(dy) -
                       reinterpret_cast<uintptr_t>(x)) & 15u) == 0;
  const bool d_vec = ((reinterpret_cast<uintptr_t>(dx) -
                       reinterpret_cast<uintptr_t>(x)) & 15u) == 0;
  if (!kFixed)
    for (int j = t; j < D; j += n) sp[j] = 0.0f;
  auto slot = [&](int rr, int which, int i) {
    return ring + (((rr % K) * 2 + which) * NV + i) * n + t;
  };
  // the copies of chunk row rr's vectors into its slot (a group a row,
  // empty past the chunk, so that every row waits for the same count)
  auto issue = [&](int rr) {
    if (rr < nr) {
      const __nv_bfloat16* xr = x + (r0 + rr) * D;
      const __nv_bfloat16* gr = dy + (r0 + rr) * D;
      const Split p = split_row(xr, D);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (t + i * n < p.nb) {
          const int c = p.h + 8 * (t + i * n);
          cp_async16(slot(rr, 0, i), xr + c);
          if (g_vec) cp_async16(slot(rr, 1, i), gr + c);
        }
      }
    }
    cp_async_commit();
  };
  // a row's head and tail values of x and dy for this thread
  auto ends = [&](int rr, float* e) {
    const __nv_bfloat16* xr = x + (r0 + rr) * D;
    const __nv_bfloat16* gr = dy + (r0 + rr) * D;
    const Split p = split_row(xr, D);
    const bool hd = t < p.h, tl = t < p.nt;
    e[0] = hd ? __bfloat162float(xr[t]) : 0.0f;
    e[1] = hd ? __bfloat162float(gr[t]) : 0.0f;
    e[2] = tl ? __bfloat162float(xr[p.tail + t]) : 0.0f;
    e[3] = tl ? __bfloat162float(gr[p.tail + t]) : 0.0f;
  };

  // kFixed: this thread's scale values and dscale partials, whole chunk
  const Split p0 = split_row(x + r0 * D, D);
  uint4 sv[kFixed ? NV : 1];
  float pv[kFixed ? NV : 1][8], ph = 0.0f, pt = 0.0f, hs = 0.0f, ts = 0.0f;
  if (kFixed) {
    const bool s_vec = aligned16(s + p0.h);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * n < p0.nb) sv[i] = load8(s + p0.h + 8 * (t + i * n), s_vec);
#pragma unroll
      for (int e = 0; e < 8; ++e) pv[i][e] = 0.0f;
    }
    if (t < p0.h) hs = __bfloat162float(s[t]);
    if (t < p0.nt) ts = __bfloat162float(s[p0.tail + t]);
  }

#pragma unroll
  for (int k = 0; k < K - 1; ++k) issue(k);
  float cur[4], nxt[4];
  if (nr > 0) ends(0, cur);
  for (int rr = 0; rr < nr; ++rr) {
    const long long row = r0 + rr;
    const __nv_bfloat16* gr = dy + row * D;
    issue(rr + K - 1);               // into the slot row rr - 1 left
    if (rr + 1 < nr) ends(rr + 1, nxt);
    const Split p = kFixed ? p0 : split_row(x + row * D, D);
    const bool s_vec = aligned16(s + p.h);
    if (!kFixed) {
      hs = t < p.h ? __bfloat162float(s[t]) : 0.0f;
      ts = t < p.nt ? __bfloat162float(s[p.tail + t]) : 0.0f;
    }
    cp_async_wait<K - 1>();          // this row's vectors have landed
    // vector i's values of x, dy and the scale
    auto values = [&](int i, float* xf, float* gf, float* sf) {
      const int c = p.h + 8 * (t + i * n);
      unpack8(*slot(rr, 0, i), xf);
      unpack8(g_vec ? *slot(rr, 1, i) : load8(gr + c, false), gf);
      if (kFixed) unpack8(sv[kFixed ? i : 0], sf);
      else unpack8(load8(s + c, s_vec), sf);
    };

    // the first pass, in column order: head, vectors, tail
    float a = 0.0f, b = 0.0f;
    a = fmaf(cur[1] * hs, cur[0], a);
    b = fmaf(cur[0], cur[0], b);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * n < p.nb) {
        float xf[8], gf[8], sf[8];
        values(i, xf, gf, sf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a = fmaf(gf[e] * sf[e], xf[e], a);
          b = fmaf(xf[e], xf[e], b);
        }
      }
    }
    a = fmaf(cur[3] * ts, cur[2], a);
    b = fmaf(cur[2], cur[2], b);
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      warp_a[rr & 1][warp] = a;
      warp_b[rr & 1][warp] = b;
    }
    __syncthreads();
    float sa = 0.0f, sb = 0.0f;
    for (int w = 0; w < nw; ++w) {
      sa += warp_a[rr & 1][w];
      sb += warp_b[rr & 1][w];
    }
    const float r = 1.0f / sqrtf(sb / static_cast<float>(D) + eps);
    const float coef = sa * (r * r * r) / static_cast<float>(D);

    // the second pass: dx, and dy x r into the partial of each column
    __nv_bfloat16* dr = dx + row * D;
    auto add = [&](float& reg, int col, float gv, float xv) {
      if (kFixed) reg = fmaf(gv, xv * r, reg);
      else sp[col] = fmaf(gv, xv * r, sp[col]);
    };
    if (t < p.h) {
      dr[t] = __float2bfloat16_rn(cur[1] * hs * r - cur[0] * coef);
      add(ph, t, cur[1], cur[0]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * n < p.nb) {
        const int c = p.h + 8 * (t + i * n);
        float xf[8], gf[8], sf[8], of[8];
        values(i, xf, gf, sf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          of[e] = gf[e] * sf[e] * r - xf[e] * coef;
          add(pv[kFixed ? i : 0][e], c + e, gf[e], xf[e]);
        }
        if (d_vec) {
          *reinterpret_cast<uint4*>(dr + c) = pack8(of);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) dr[c + e] = __float2bfloat16_rn(of[e]);
        }
      }
    }
    if (t < p.nt) {
      dr[p.tail + t] = __float2bfloat16_rn(cur[3] * ts * r - cur[2] * coef);
      add(pt, p.tail + t, cur[3], cur[2]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
  }
  cp_async_wait<0>();

  float* pr = partial + static_cast<long long>(chunk) * D;
  if (kFixed) {
    if (t < p0.h) pr[t] = ph;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = p0.h + 8 * (t + i * n);
      if (t + i * n < p0.nb)
#pragma unroll
        for (int e = 0; e < 8; ++e) pr[c + e] = pv[i][e];
    }
    if (t < p0.nt) pr[p0.tail + t] = pt;
  } else {
    __syncthreads();  // every thread's last row is in sp
    for (int j = t; j < D; j += n) pr[j] = sp[j];
  }
}

// dscale: a block sums kScaleCols columns of one group's partial rows, in
// chunk order. Its threads load pieces of up to kScalePiece rows of those
// columns together, coalesced, into shared memory; then thread c adds
// column c's rows of the piece to its sum in order.
template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
    rmsnorm_bwd_scale_kernel(const float* __restrict__ partial,
                             T* __restrict__ dscale, int D,
                             int chunks_per_group) {
  __shared__ float tile[kScalePiece][kScaleCols + 1];  // + 1: no conflicts
  const int c0 = blockIdx.x * kScaleCols, gi = blockIdx.y, t = threadIdx.x;
  const float* p =
      partial + static_cast<long long>(gi) * chunks_per_group * D + c0;
  float acc = 0.0f;
  for (int k0 = 0; k0 < chunks_per_group; k0 += kScalePiece) {
    const int nk = min(kScalePiece, chunks_per_group - k0);
#pragma unroll 8
    for (int e = t; e < nk * kScaleCols; e += kScaleThreads) {
      const int r = e / kScaleCols, c = e % kScaleCols;
      tile[r][c] = c0 + c < D ? p[static_cast<long long>(k0 + r) * D + c]
                              : 0.0f;
    }
    __syncthreads();
    if (t < kScaleCols)
      for (int r = 0; r < nk; ++r) acc += tile[r][t];
    __syncthreads();
  }
  if (t < kScaleCols && c0 + t < D)
    dscale[static_cast<long long>(gi) * D + c0 + t] = from_f32<T>(acc);
}

// the rows kernel of T at this plan; bf16 the vector form, NV from the
// whole vectors a row holds and the threads
template <typename T>
int launch_rows(const T* x, const T* scale, const T* dy, T* dx,
                float* partial, int D, long long blocks, long long group_rows,
                int chunk_rows, long long cpg, int threads, float eps,
                cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(float) * D);
  auto go = [&](auto kernel, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), threads, bytes, s>>>(
        x, scale, dy, dx, partial, D, static_cast<int>(group_rows),
        chunk_rows, static_cast<int>(cpg), eps);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (sizeof(T) == 4) {
    return go(rmsnorm_bwd_rows_kernel<T>, smem);
  } else {
    const int nv = (D / 8 + threads - 1) / threads;
    const bool fixed = D % 8 == 0;
#define REPRO_RMSNORM_BWD_NV(NV)                                        \
  if (nv <= NV) {                                                       \
    const int ring = ring_rows<NV>() * 2 * NV * threads * 16;           \
    return fixed ? go(rmsnorm_bwd_rows_bf16_kernel<NV, true>, ring)     \
                 : go(rmsnorm_bwd_rows_bf16_kernel<NV, false>,          \
                      ring + smem);                                     \
  }
    REPRO_RMSNORM_BWD_NV(2)
    REPRO_RMSNORM_BWD_NV(4)
#undef REPRO_RMSNORM_BWD_NV
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const T* x, const T* scale, const T* dy, T* dx, T* dscale,
           float* partial, int D, long long groups, long long group_rows,
           int chunk_rows, long long cpg, int threads, float eps,
           cudaStream_t s) {
  int code = launch_rows<T>(x, scale, dy, dx, partial, D, groups * cpg,
                            group_rows, chunk_rows, cpg, threads, eps, s);
  if (code != 0) return code;
  const dim3 grid((D + kScaleCols - 1) / kScaleCols,
                  static_cast<unsigned>(groups));
  rmsnorm_bwd_scale_kernel<T><<<grid, kScaleThreads, 0, s>>>(
      partial, dscale, D, static_cast<int>(cpg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16, for x, scale, dy, dx and dscale alike. x,
// dy and dx are (rows, D) contiguous; scale and dscale (rows / group_rows,
// D); partial f32 scratch of (rows / group_rows) * ceil(group_rows /
// chunk_rows) rows of D floats. threads: a multiple of 32 up to 512; in
// bf16 a thread takes up to 4 of a row's 16-byte vectors (D / 8 <= 4
// threads). Up to 192 KB of shared memory a block. Two launches on
// `stream`; returns the CUDA error code of the first that fails (0 =
// cudaSuccess).
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
