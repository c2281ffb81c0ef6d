// Chunked SSD (state-space duality) scan, Mamba2's core, for Hopper (sm_90a).
//
//   h_t = exp(dt_t * a) h_{t-1} + dt_t * x_t b_t^T,   y_t = h_t c_t
//
// computed chunk by chunk as Dao & Gu's chunked algorithm does. For a chunk
// of Q steps with cum = cumsum(dt * a) inside the chunk:
//
//   y   = (C B^T o L)(dt * x) + exp(cum) * (C h^T)
//   h  <- exp(cum_last) h + (dt * exp(cum_last - cum) * x)^T B
//
// where L[i][j] = exp(cum_i - cum_j) for j <= i and 0 above the diagonal.
//
// x (BH, S, P), dt (BH, S), b and c (BH / R, S, N), f32 or bf16 alike; a
// (BH,) f32 with bh = batch * H + head (b-major). y (BH, S, P) comes out in
// x's dtype and the final state h (BH, P, N) in f32. Head bh reads row
// bh / R of b and c: with H heads in G groups per batch, R = H / G, so the
// groups are read in place and never repeated in memory (R = 1 is the
// reference's layout, b and c per head). S is a multiple of Q (callers pad
// with dt = 0, which leaves the state untouched); Q is 8, 16, 32 or 64,
// P <= 64 and N <= 128.
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py (ssd_scan,
// _ssd_kernel) behind the padding wrapper src/repro/kernels/ops.py
// (ssd_scan). Mamba2 serving runs it once per SSM layer in prefill.
//
// Bound: operations. Per chunk it does 2 Q^2 N (C B^T) + 2 Q^2 P (the
// diagonal product) + 2 Q N P (C h^T) + 2 Q P N (the state update) flops:
// 3.67 MFLOP at Q = P = 64, N = 128, against 16 + 2 * 32 KB of f32 input,
// ~100 flops per byte, far above the card's f32 CUDA-core ridge. This first
// kernel runs every product as f32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores.
//
// Design. One block of 256 threads owns one (batch, head) and loops over the
// chunks in order; that loop takes the place of the TPU's sequential chunk
// grid axis, whose (P, N) state lived in VMEM scratch. The state lives in
// registers: thread (r, c) = (tid / 16, tid % 16) owns h[r + 16u][c + 16v]
// for u < 4, v < 8, and mirrors it into shared memory for the next chunk's
// C h^T. Per chunk the block stages x * dt, B and C as f32 in shared memory
// (rows padded by one float against bank conflicts where 16 rows are read
// at once): 130 KB at Q = P = 64, N = 128, so it is dynamic shared memory,
// one block per SM. One warp scans dt * a in a fixed order (shuffles); the
// block then forms M = C B^T o L, selecting 0 above the diagonal BEFORE the
// exp (cum_i - cum_j > 0 there, so exp could overflow and inf * 0 would be
// NaN), then y, then the state update, each as 4 x 4 or 4 x 8 register
// tiles per thread with f32 FMAs in a fixed order. No atomics: a card gives
// the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kRP = kMaxP / 16;  // state rows per thread
constexpr int kRN = kMaxN / 16;  // state columns per thread

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

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(Q) * P            // x * dt
         + 2 * static_cast<size_t>(Q) * (N + 1)  // B, C
         + static_cast<size_t>(P) * (N + 1)      // state
         + static_cast<size_t>(Q) * (Q + 1)      // C B^T o L
         + 3 * static_cast<size_t>(Q);           // dt * a, cum, decay
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ c, T* __restrict__ y,
                    float* __restrict__ h_out, int S, int P, int N, int R) {
  constexpr int RQ = (Q + 15) / 16;  // chunk rows per thread
  constexpr int LDM = Q + 1;
  const int LDN = N + 1;  // row stride of B, C and the state
  extern __shared__ float smem[];
  float* sX = smem;               // Q x P: x * dt
  float* sB = sX + Q * P;         // Q x LDN
  float* sC = sB + Q * LDN;       // Q x LDN
  float* sH = sC + Q * LDN;       // P x LDN: the state at the chunk's start
  float* sM = sH + P * LDN;       // Q x LDM: C B^T o L
  float* sDa = sM + Q * LDM;      // Q: dt * a
  float* sCum = sDa + Q;          // Q: inclusive cumsum of dt * a
  float* sDecay = sCum + Q;       // Q: exp(cum_last - cum)
  __shared__ float sLast;         // exp(cum_last)

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int cc = tid & 15;
  const float av = a[bh];
  const T* xb = x + static_cast<int64_t>(bh) * S * P;
  const T* dtb = dt + static_cast<int64_t>(bh) * S;
  const T* bb = b + static_cast<int64_t>(bh / R) * S * N;
  const T* cb = c + static_cast<int64_t>(bh / R) * S * N;
  T* yb = y + static_cast<int64_t>(bh) * S * P;

  float h[kRP][kRN];
#pragma unroll
  for (int u = 0; u < kRP; ++u)
#pragma unroll
    for (int v = 0; v < kRN; ++v) h[u][v] = 0.0f;
  for (int e = tid; e < P * LDN; e += kThreads) sH[e] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the last chunk's tiles are no longer read
    const int64_t xo = static_cast<int64_t>(s0) * P;
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P;
      sX[e] = to_f32(xb[xo + e]) * to_f32(dtb[s0 + j]);
    }
    const int64_t bo = static_cast<int64_t>(s0) * N;
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      sB[j * LDN + n] = to_f32(bb[bo + e]);
      sC[j * LDN + n] = to_f32(cb[bo + e]);
    }
    if (tid < Q) sDa[tid] = to_f32(dtb[s0 + tid]) * av;
    __syncthreads();

    // warp 0: cum = cumsum(dt * a), an inclusive shuffle scan in a fixed
    // order, 32 steps at a time with the running total carried over
    if (tid < 32) {
      float carry = 0.0f;
      for (int q0 = 0; q0 < Q; q0 += 32) {
        const int q = q0 + tid;
        float v = q < Q ? sDa[q] : 0.0f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float w = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += w;
        }
        v += carry;
        if (q < Q) sCum[q] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      for (int q = tid; q < Q; q += 32) sDecay[q] = expf(carry - sCum[q]);
      if (tid == 0) sLast = expf(carry);
    }

    // C B^T: thread (r, cc) owns rows r + 16u and columns cc + 16v (rows
    // past Q read row Q - 1 and are dropped)
    float cbt[RQ][RQ];
#pragma unroll
    for (int u = 0; u < RQ; ++u)
#pragma unroll
      for (int v = 0; v < RQ; ++v) cbt[u][v] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[RQ], bv[RQ];
#pragma unroll
      for (int u = 0; u < RQ; ++u) {
        cv[u] = sC[min(r + 16 * u, Q - 1) * LDN + n];
        bv[u] = sB[min(cc + 16 * u, Q - 1) * LDN + n];
      }
#pragma unroll
      for (int u = 0; u < RQ; ++u)
#pragma unroll
        for (int v = 0; v < RQ; ++v) cbt[u][v] = fmaf(cv[u], bv[v], cbt[u][v]);
    }
    __syncthreads();  // cum is written

#pragma unroll
    for (int u = 0; u < RQ; ++u) {
      const int i = r + 16 * u;
#pragma unroll
      for (int v = 0; v < RQ; ++v) {
        const int j = cc + 16 * v;
        // select before the exp: above the diagonal cum_i - cum_j > 0
        if (i < Q && j < Q)
          sM[i * LDM + j] = j <= i ? cbt[u][v] * expf(sCum[i] - sCum[j])
                                   : 0.0f;
      }
    }
    __syncthreads();

    // y = M (x * dt) + exp(cum) * (C h^T): thread (r, cc) owns rows
    // r + 16u and columns p = cc + 16v
    {
      float yd[RQ][kRP], yo[RQ][kRP];
#pragma unroll
      for (int u = 0; u < RQ; ++u)
#pragma unroll
        for (int v = 0; v < kRP; ++v) yd[u][v] = yo[u][v] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        float mv[RQ], xv[kRP];
#pragma unroll
        for (int u = 0; u < RQ; ++u) mv[u] = sM[min(r + 16 * u, Q - 1) * LDM + j];
#pragma unroll
        for (int v = 0; v < kRP; ++v) xv[v] = sX[j * P + min(cc + 16 * v, P - 1)];
#pragma unroll
        for (int u = 0; u < RQ; ++u)
#pragma unroll
          for (int v = 0; v < kRP; ++v) yd[u][v] = fmaf(mv[u], xv[v], yd[u][v]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[RQ], hv[kRP];
#pragma unroll
        for (int u = 0; u < RQ; ++u) cv[u] = sC[min(r + 16 * u, Q - 1) * LDN + n];
#pragma unroll
        for (int v = 0; v < kRP; ++v) hv[v] = sH[min(cc + 16 * v, P - 1) * LDN + n];
#pragma unroll
        for (int u = 0; u < RQ; ++u)
#pragma unroll
          for (int v = 0; v < kRP; ++v) yo[u][v] = fmaf(cv[u], hv[v], yo[u][v]);
      }
#pragma unroll
      for (int u = 0; u < RQ; ++u) {
        const int i = r + 16 * u;
        if (i >= Q) continue;
        const float ec = expf(sCum[i]);
        const int64_t yo_row = static_cast<int64_t>(s0 + i) * P;
#pragma unroll
        for (int v = 0; v < kRP; ++v) {
          const int p = cc + 16 * v;
          if (p < P) yb[yo_row + p] = from_f32<T>(yd[u][v] + ec * yo[u][v]);
        }
      }
    }
    __syncthreads();  // C h^T has read the state

    // h <- exp(cum_last) h + (x * dt * decay)^T B: thread (r, cc) owns
    // h[r + 16u][cc + 16v]
    {
      float acc[kRP][kRN];
#pragma unroll
      for (int u = 0; u < kRP; ++u)
#pragma unroll
        for (int v = 0; v < kRN; ++v) acc[u][v] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        const float dj = sDecay[j];
        float xv[kRP], bv[kRN];
#pragma unroll
        for (int u = 0; u < kRP; ++u) xv[u] = sX[j * P + min(r + 16 * u, P - 1)] * dj;
#pragma unroll
        for (int v = 0; v < kRN; ++v) bv[v] = sB[j * LDN + min(cc + 16 * v, N - 1)];
#pragma unroll
        for (int u = 0; u < kRP; ++u)
#pragma unroll
          for (int v = 0; v < kRN; ++v) acc[u][v] = fmaf(xv[u], bv[v], acc[u][v]);
      }
      const float last = sLast;
#pragma unroll
      for (int u = 0; u < kRP; ++u) {
        const int p = r + 16 * u;
#pragma unroll
        for (int v = 0; v < kRN; ++v) {
          const int n = cc + 16 * v;
          h[u][v] = last * h[u][v] + acc[u][v];
          if (p < P && n < N) sH[p * LDN + n] = h[u][v];
        }
      }
    }
  }

  float* hb = h_out + static_cast<int64_t>(bh) * P * N;
#pragma unroll
  for (int u = 0; u < kRP; ++u) {
    const int p = r + 16 * u;
#pragma unroll
    for (int v = 0; v < kRN; ++v) {
      const int n = cc + 16 * v;
      if (p < P && n < N) hb[p * N + n] = h[u][v];
    }
  }
}

template <typename T, int Q>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, void* y, float* h, int BH, int S, int P, int N,
           int R, cudaStream_t s) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, Q><<<static_cast<unsigned>(BH), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      h, S, P, N, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_chunk(int chunk, const void* x, const void* dt, const float* a,
                   const void* b, const void* c, void* y, float* h, int BH,
                   int S, int P, int N, int R, cudaStream_t s) {
  switch (chunk) {
    case 8:
      return launch<T, 8>(x, dt, a, b, c, y, h, BH, S, P, N, R, s);
    case 16:
      return launch<T, 16>(x, dt, a, b, c, y, h, BH, S, P, N, R, s);
    case 32:
      return launch<T, 32>(x, dt, a, b, c, y, h, BH, S, P, N, R, s);
    case 64:
      return launch<T, 64>(x, dt, a, b, c, y, h, BH, S, P, N, R, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and y share it; a and h are
// float32). chunk one of 8, 16, 32, 64, dividing S; 1 <= P <= 64,
// 1 <= N <= 128. x and y are (BH, S, P), dt (BH, S), a (BH,), b and c
// (BH / R, S, N), h (BH, P, N), all contiguous. Returns the CUDA error code
// of the launch (0 = cudaSuccess).
extern "C" int repro_ssd_scan(int dtype, int chunk, const void* x,
                              const void* dt, const void* a, const void* b,
                              const void* c, void* y, void* h, int BH, int S,
                              int P, int N, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || R < 1 ||
      BH < 1 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  float* hf = static_cast<float*>(h);
  if (dtype == 0)
    return dispatch_chunk<float>(chunk, x, dt, af, b, c, y, hf, BH, S, P, N,
                                 R, s);
  if (dtype == 1)
    return dispatch_chunk<__nv_bfloat16>(chunk, x, dt, af, b, c, y, hf, BH,
                                         S, P, N, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
