// The gradient of masked softmax attention with grouped KV heads, in f32 on
// Hopper's CUDA cores (sm_90a): dq, dk and dv from q, k, v, the forward's
// output o and per-row log-sum-exp, and the output's gradient do.
//
//   s[i, j] = scale q[i] . k[j],  p[i, j] = mask(i, j) ? exp(s - lse[i]) : 0
//   dv[j]   = sum_i p[i, j] do[i]
//   dp[i,j] = do[i] . v[j],  ds[i, j] = p[i, j] (dp[i, j] - delta[i]),
//   delta[i] = do[i] . o[i]
//   dq[i]   = scale sum_j ds[i, j] k[j],  dk[j] = scale sum_i ds[i, j] q[i]
//
// q, o, do, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); lse (B, H, Sq),
// written by the f32 forward (attention.cu) in natural-log units, -inf for
// a row that keeps no key (whose output and gradient are 0). D is 32, 64 or
// 128 for queries, keys and values alike. The masks are the forward's:
// query row i sits at position i + Sk - Sq; key j is kept when j < Sk,
// j <= qpos if causal, and j > qpos - window if window > 0. The dk and dv
// of kv head hk sum over its G = H / Hkv query heads.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel.
// Its training path differentiates jnp attention (src/repro/models/); on
// the card the port's forward is a hand-written kernel (attention.cu), so
// its gradient is one too.
//
// Bound: the arithmetic, 5 products of 2 D flops per kept query-key pair
// and query head (s = q k^T again, dp = do v^T, dv += p^T do, dk += ds^T q,
// dq += ds k), 2.5 times the forward's; on the CUDA cores, in plain f32
// FMAs (one TF32 product would miss the f32 tolerance, ROADMAP "One
// rounding misses the tolerance"), over the f32 rate.
//
// Design: three launches, no atomics, every sum in a fixed order, so a
// given card gives the same bits on every run (gradients feed the
// divergence trigger through the parameter plane).
//   1. delta: one warp a row, lanes over D, an xor butterfly.
//   2. dk, dv: one block of 256 threads per (batch, kv head, 64-key tile),
//      (batch, kv head) fastest, the first key tiles (the longest under a
//      causal mask) first. It keeps the tile's k and v in shared memory,
//      walks its group's query heads in order and, for each, the 64-row
//      query tiles that keep any of its keys, in order: s and dp as 4 x 4
//      blocks a thread, p and ds into shared memory, then dv and dk as 4
//      keys x D / 16 dims a thread in registers.
//   3. dq: one block of 256 threads per (batch, head, 64-row query tile),
//      the last query tile first; it keeps q and do, walks the key tiles
//      that any of its rows keeps in order, and sums dq as 4 rows x D / 16
//      dims a thread in registers.
// Tiles sit in shared memory with rows of D + 1 floats, so a thread's
// rows i + 16 r (or keys j + 16 c) fall in 16 different banks. Every load
// of a tile is a 16-byte vector from device memory, zero past Sq or Sk.
// This is the simple, right kernel: one block an SM (~150-166 KB of shared
// memory at D = 128), single-buffered tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // query rows and keys a tile
constexpr int kThreads = 256;
constexpr int kLP = kB + 1;      // floats a row of the p and ds tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int LD = D + 1;            // floats a row of a D tile
  static constexpr int E = D / 16;            // dims a thread sums
  static constexpr size_t kKV =               // dk / dv pass
      sizeof(float) * (4 * kB * LD + 2 * kB * kLP + 2 * kB);
  static constexpr size_t kQ =                // dq pass
      sizeof(float) * (4 * kB * LD + kB * kLP + 2 * kB);
};

// rows [r0, r0 + kB) x D of a (.., rows, heads, D) tensor (row stride
// `stride` floats, from `src`, the head's first row) into shared memory
// with rows of D + 1 floats; rows >= n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int n) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < kB * C4; e += kThreads) {
    const int r = e / C4, c = (e - r * C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) v = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
    float* d = dst + r * (D + 1) + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// the per-row terms of query rows [q0, q0 + kB): lse in log2 units (+inf
// where the row keeps nothing or lies past Sq, so its p is 0) and delta
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int Sq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const int i = q0 + r;
    float l = INFINITY, d = 0.0f;
    if (i < Sq) {
      const float v = lse[i];
      l = isinf(v) ? INFINITY : v * kLog2e;
      d = delta[i];
    }
    sL[r] = l;
    sD[r] = d;
  }
}

__device__ __forceinline__ bool keeps(int qpos, int kpos, int Sk, int causal,
                                      int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// p and ds of a 64 x 64 tile: thread (ti, tj) = (t / 16, t % 16) takes rows
// ti + 16 r and keys tj + 16 c; the dot products sum over d in order. p is
// written to sP when it is not null, ds to sS.
template <int D>
__device__ __forceinline__ void p_ds(const float* sQ, const float* sdO,
                                     const float* sK, const float* sV,
                                     const float* sL, const float* sD,
                                     float* sP, float* sS, int q0, int k0,
                                     int off, int Sk, int causal, int window,
                                     float sl2) {
  constexpr int LD = D + 1;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = sQ[(ti + 16 * r) * LD + d];
      g[r] = sdO[(ti + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      b[c] = sK[(tj + 16 * c) * LD + d];
      w[c] = sV[(tj + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(a[r], b[c], s[r][c]);
        dp[r][c] = fmaf(g[r], w[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ri = ti + 16 * r;
    const int qpos = q0 + ri + off;
    const float l = sL[ri], dl = sD[ri];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cj = tj + 16 * c;
      const float p = keeps(qpos, k0 + cj, Sk, causal, window)
                          ? exp2f(s[r][c] * sl2 - l)
                          : 0.0f;
      if (sP != nullptr) sP[ri * kLP + cj] = p;
      sS[ri * kLP + cj] = p * (dp[r][c] - dl);
    }
  }
}

// delta[b, h, i] = do[b, i, h] . o[b, i, h]: one warp a row
__global__ void __launch_bounds__(kThreads)
    attention_bwd_delta_kernel(const float* __restrict__ o,
                               const float* __restrict__ dO,
                               float* __restrict__ delta, long long rows,
                               int Sq, int H, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* a = o + row * D;
  const float* g = dO + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(a[d], g[d], acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    // row = (b Sq + i) H + h -> delta[(b H + h) Sq + i]
    const long long h = row % H, bi = row / H;
    const long long i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkv_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int BHkv, int H, int Hkv, int Sq, int Sk,
                             int causal, int window, float scale) {
  constexpr int LD = Tiles<D>::LD, E = Tiles<D>::E;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sdO = sQ + kB * LD;
  float* sP = sdO + kB * LD;
  float* sS = sP + kB * kLP;
  float* sL = sS + kB * kLP;
  float* sD = sL + kB;

  const int bhk = static_cast<int>(blockIdx.x % BHkv);
  const int k0 = static_cast<int>(blockIdx.x / BHkv) * kB;
  const int b = bhk / Hkv, hk = bhk - b * Hkv;
  const int G = H / Hkv;
  const int off = Sk - Sq;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t kv0 = (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  load_tile<D>(sK, k + kv0 + k0 * k_stride, k_stride, min(kB, Sk - k0));
  load_tile<D>(sV, v + kv0 + k0 * k_stride, k_stride, min(kB, Sk - k0));

  // the query rows that may keep a key of [k0, k0 + kB)
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - off);
  if (window > 0) i_hi = min(Sq, k0 + kB - 1 + window - off);
  const int t_lo = i_lo / kB;
  const int t_hi = i_hi > i_lo ? (i_hi + kB - 1) / kB : t_lo;

  // this thread's keys tj + 16 c and dims td + 16 e
  const int tj = threadIdx.x & 15, td = threadIdx.x >> 4;
  float acc_v[4][E], acc_k[4][E];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_v[c][e] = acc_k[c][e] = 0.0f;
  const float sl2 = scale * kLog2e;

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const int64_t q0_off = (static_cast<int64_t>(b) * Sq * H + h) * D;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qt = t_lo; qt < t_hi; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the tiles of the step before are read
      load_tile<D>(sQ, q + q0_off + q0 * q_stride, q_stride, min(kB, Sq - q0));
      load_tile<D>(sdO, dO + q0_off + q0 * q_stride, q_stride,
                   min(kB, Sq - q0));
      load_rows(sL, sD, lse_h, delta_h, q0, Sq);
      __syncthreads();
      p_ds<D>(sQ, sdO, sK, sV, sL, sD, sP, sS, q0, k0, off, Sk, causal,
              window, sl2);
      __syncthreads();
      for (int i = 0; i < kB; ++i) {
        float pc[4], sc[4], g[E], x[E];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pc[c] = sP[i * kLP + tj + 16 * c];
          sc[c] = sS[i * kLP + tj + 16 * c];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          g[e] = sdO[i * LD + td + 16 * e];
          x[e] = sQ[i * LD + td + 16 * e];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc_v[c][e] = fmaf(pc[c], g[e], acc_v[c][e]);
            acc_k[c][e] = fmaf(sc[c], x[e], acc_k[c][e]);
          }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = k0 + tj + 16 * c;
    if (j >= Sk) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t at = kv0 + j * k_stride + td + 16 * e;
      dv[at] = acc_v[c][e];
      dk[at] = acc_k[c][e] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int BH, int H, int Hkv,
                            int Sq, int Sk, int causal, int window,
                            float scale) {
  constexpr int LD = Tiles<D>::LD, E = Tiles<D>::E;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kB * LD;
  float* sK = sdO + kB * LD;
  float* sV = sK + kB * LD;
  float* sS = sV + kB * LD;
  float* sL = sS + kB * kLP;
  float* sD = sL + kB;

  const int n_qt = (Sq + kB - 1) / kB;
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kB;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int off = Sk - Sq;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t qh = (static_cast<int64_t>(b) * Sq * H + h) * D;
  const int64_t kv0 = (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  load_tile<D>(sQ, q + qh + q0 * q_stride, q_stride, min(kB, Sq - q0));
  load_tile<D>(sdO, dO + qh + q0 * q_stride, q_stride, min(kB, Sq - q0));
  load_rows(sL, sD, lse + static_cast<int64_t>(bh) * Sq,
            delta + static_cast<int64_t>(bh) * Sq, q0, Sq);

  // the key tiles any row of this tile may keep, as the forward's
  const int q_last = min(q0 + kB, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, off + q_last + 1);
  if (window > 0) k_lo = max(0, off + q0 - window + 1);
  const int t_lo = k_lo / kB;
  const int t_hi = k_hi > k_lo ? (k_hi + kB - 1) / kB : t_lo;

  // this thread's rows ti + 16 r and dims td + 16 e
  const int ti = threadIdx.x & 15, td = threadIdx.x >> 4;
  float acc[4][E];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  const float sl2 = scale * kLog2e;

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the tiles of the step before are read
    load_tile<D>(sK, k + kv0 + k0 * k_stride, k_stride, min(kB, Sk - k0));
    load_tile<D>(sV, v + kv0 + k0 * k_stride, k_stride, min(kB, Sk - k0));
    __syncthreads();
    p_ds<D>(sQ, sdO, sK, sV, sL, sD, nullptr, sS, q0, k0, off, Sk, causal,
            window, sl2);
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float sc[4], x[E];
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[r] = sS[(ti + 16 * r) * kLP + j];
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = sK[j * LD + td + 16 * e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(sc[r], x[e], acc[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ti + 16 * r;
    if (i >= Sq) continue;
#pragma unroll
    for (int e = 0; e < E; ++e)
      dq[qh + i * q_stride + td + 16 * e] = acc[r][e] * scale;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dO, float* dq, float* dk, float* dv,
           float* delta, int B, int H, int Hkv, int Sq, int Sk, int causal,
           int window, float scale, cudaStream_t s) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long d_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long kv_blocks =
      static_cast<long long>(B) * Hkv * ((Sk + kB - 1) / kB);
  const long long q_blocks =
      static_cast<long long>(B) * H * ((Sq + kB - 1) / kB);
  if (d_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tiles<D>::kKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Tiles<D>::kQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_delta_kernel<<<static_cast<unsigned>(d_blocks), kThreads, 0,
                               s>>>(o, dO, delta, rows, Sq, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<D>
      <<<static_cast<unsigned>(kv_blocks), kThreads, Tiles<D>::kKV, s>>>(
          q, k, v, dO, lse, delta, dk, dv, B * Hkv, H, Hkv, Sq, Sk, causal,
          window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<D>
      <<<static_cast<unsigned>(q_blocks), kThreads, Tiles<D>::kQ, s>>>(
          q, k, v, dO, lse, delta, dq, B * H, H, Hkv, Sq, Sk, causal, window,
          scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 throughout; d one of 32, 64 and 128 (queries, keys and values
// alike). q, o, dO and dq are (B, Sq, H, d); k, v, dk and dv (B, Sk, Hkv,
// d); lse and delta (B, H, Sq), delta scratch the launcher fills. All
// contiguous and 16-byte aligned, H % Hkv == 0. Three launches on
// `stream`; returns the CUDA error code of the first that fails (0 =
// cudaSuccess).
extern "C" int repro_attention_bwd(int d, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dO, void* dq,
                                   void* dk, void* dv, void* delta, int B,
                                   int H, int Hkv, int Sq, int Sk, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_ATTENTION_BWD_CASE(D)                                         \
  if (d == D)                                                               \
    return launch<D>(                                                       \
        static_cast<const float*>(q), static_cast<const float*>(k),         \
        static_cast<const float*>(v), static_cast<const float*>(o),         \
        static_cast<const float*>(lse), static_cast<const float*>(dO),      \
        static_cast<float*>(dq), static_cast<float*>(dk),                   \
        static_cast<float*>(dv), static_cast<float*>(delta), B, H, Hkv, Sq, \
        Sk, causal, window, scale, s);
  REPRO_ATTENTION_BWD_CASE(32)
  REPRO_ATTENTION_BWD_CASE(64)
  REPRO_ATTENTION_BWD_CASE(128)
#undef REPRO_ATTENTION_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
