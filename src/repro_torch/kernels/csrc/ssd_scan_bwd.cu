// The gradient of the chunked SSD scan (csrc/ssd_scan.cu), for Hopper
// (sm_90a), in f32 on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel (it
// trains by differentiating the jnp SSD, src/repro/models/mamba.py's
// _ssd_chunked). This is the gradient of the port's forward kernel, which
// replaces src/repro/kernels/ssd_scan.py (ssd_scan).
//
// The forward, per head, with da_t = dt_t a, cum the inclusive cumulative
// sum of da within a chunk of Q steps, u_t = dt_t x_t and H_c the state
// entering chunk c (which the forward writes to its scratch):
//
//   y_i     = sum_{j <= i} (c_i . b_j) e^(cum_i - cum_j) u_j + e^cum_i H_c c_i
//   H_{c+1} = e^cum_Q H_c + sum_j e^(cum_Q - cum_j) u_j b_j^T
//
// The backward is an SSD run in reverse time. With G_c the gradient of the
// state leaving chunk c (G_last = dh, zero when the caller reads no final
// state):
//
//   G_{c-1} = e^cum_Q G_c + sum_i e^cum_i dy_i c_i^T
//   du_j = sum_{i >= j} (c_i . b_j) e^(cum_i - cum_j) dy_i
//          + e^(cum_Q - cum_j) G_c b_j;              dx_j = dt_j du_j
//   dc_i = sum_{j <= i} e^(cum_i - cum_j) (dy_i . u_j) b_j + e^cum_i H_c^T dy_i
//   db_j = sum_{i >= j} e^(cum_i - cum_j) (dy_i . u_j) c_i
//          + e^(cum_Q - cum_j) G_c^T u_j
//
// and d cum gathers every exp: with T_ij = (c_i . b_j)(dy_i . u_j)
// e^(cum_i - cum_j) (j <= i) and W_j = e^(cum_Q - cum_j) u_j . G_c b_j,
//
//   d cum_i = e^cum_i c_i . (H_c^T dy_i) + sum_j T_ij - sum_k T_ki - W_i
//             + [i = Q - 1] (e^cum_Q <G_c, H_c> + sum_j W_j),
//
// the last term being <G_c, H_{c+1}>. d da_k is its sum over i >= k
// (cum_i = sum_{k <= i} da_k), taken in the form where nothing cancels:
//
//   d da_k = sum_{i >= k} e^cum_i c_i . (H_c^T dy_i)
//            + sum_{i >= k, j < k} T_ij + sum_{j < k} W_j + e^cum_Q <G_c, H_c>
//
// (summing d cum would add each T_ii and W_{Q-1}, which do not decay, and
// take them away again: under strong decay the rounding of those is
// larger than the rest). ddt_k = x_k . du_k + a d da_k and
// da = sum_t dt_t d da_t.
//
// Design: three or four launches on one stream, no atomics, every sum in a
// fixed order, so a card gives the same bits on every run (the gradients
// reach the protocol's distance trigger through the parameter plane).
//   1. ssd_scan_bwd_state_kernel, grid (BH, N / 64): the ordered reverse
//      walk, the mirror of the forward's pass 2. One block per head and 64
//      state columns holds its (P, 64) slice of G in registers and walks
//      the chunks from the last, writing G_c (the gradient of the state
//      leaving chunk c) to a (BH, S / Q, P, N) scratch before it adds the
//      chunk's e^cum dy c^T; the next chunk's loads are in flight during
//      the multiply (two buffers).
//   2. ssd_scan_bwd_chunk_kernel, grid (BH S / Q): every chunk of every
//      head in parallel, from x, dt, b, c, dy, the forward's H_c and pass
//      1's G_c, all staged in shared memory: the Q x Q products (C B^T,
//      dY U^T) with L applied, then the H_c products (dc, the entering
//      term of d da), then the G_c products (du, dx, db, W). It writes dx,
//      ddt and, per head, db and dc (the row's own where R = 1), and the
//      chunk's share of da.
//   3. ssd_scan_bwd_sum_heads_kernel (R > 1 only): db and dc of each b/c
//      row, the per-head partials of its R heads summed in head order.
//   4. ssd_scan_bwd_sum_chunks_kernel: da per head, its chunks' shares
//      summed in chunk order.
// L selects the exponent to -inf above the diagonal BEFORE the exp: there
// cum_i - cum_j > 0, so the exp could overflow and inf * 0 would be NaN.
// Each pass recomputes cum from the forward's f32 da_t = dt_t a, summed in
// float64: a decay of nearby steps, e^(cum_i - cum_j), taken as the
// difference of two long f32 sums would lose |cum| eps of its argument
// (1e-5 of the decay where a chunk's cum reaches -100).
//
// Precision: plain f32 fused multiply-adds. One TF32 product per product
// would miss the backward's f32 tolerance (tests/test_torch_ssd_bwd.py
// shows it); split TF32 on the tensor cores is the open speed step.
// Each product is a 16 x 16 grid of threads, each holding up to 4 x 8
// outputs (rows ty + 16 r, columns tx + 16 s) and walking K in order;
// the causal ones skip the 16 x 16 tiles that L makes zero.
// Shared tiles have odd row strides, so a column read across a warp hits
// distinct banks.
//
// Bound: the function reads x, dt, b, c and dy once and writes dx, ddt,
// db, dc and da once (263 MB at mamba2-2.7b's (80, 4096, 64, 128), 80
// heads a row, 0.079 ms at 3.35 TB/s); its flops (29.8 GFLOP there) take
// 0.18 ms in split TF32 at the tensor cores' rate and 0.44 ms on the CUDA
// cores, which this kernel uses. The design's own traffic is G_c, written
// and read once, the forward's H_c read once (2 x 168 MB and 168 MB), and
// the per-head db and dc partials where R > 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kLd64 = 65;       // row stride of a tile of up to 64 columns
constexpr int kSumThreads = 256;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// row stride of a tile of 16 ns columns: odd
__host__ __device__ constexpr int ld_cols(int ns) {
  return round_up(16 * ns, 32) + 1;
}

// One warp: dt of one chunk -> sDt[q] = dt_q and sCum[q] = the inclusive
// cumsum of da_q = dt_q * a (the forward's f32 products) in float64, a
// shuffle scan in a fixed order, 32 steps at a time with the running total
// carried over. Returns the chunk's total in every lane.
template <int Q>
__device__ __forceinline__ double chunk_cumsum(const float* __restrict__ dt,
                                               float av, float* sDt,
                                               double* sCum, int lane) {
  double carry = 0.0;
#pragma unroll
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int q = q0 + lane;
    const float d = q < Q ? dt[q] : 0.0f;
    double v = q < Q ? static_cast<double>(d * av) : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double w = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += w;
    }
    v += carry;
    if (q < Q) {
      sDt[q] = d;
      sCum[q] = v;
    }
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  return carry;
}
// e^(cum_i - cum_j), the difference taken in float64
__device__ __forceinline__ float decay(const double* sCum, int i, int j) {
  return expf(static_cast<float>(sCum[i] - sCum[j]));
}

// acc[r][s] += sum_{k < K} A(ty + 16 r, k) B(k, tx + 16 s), k in order, with
// A(m, k) = A[m am + k ak] and B(k, n) = B[k bk + n bn] in shared memory.
// kLower: a square output of which only the lower triangle is read; the
// tiles s > r lie wholly above the diagonal (column tx + 16 s > row
// ty + 16 r) and are left as they are
template <int MR, int MS, bool kLower = false>
__device__ __forceinline__ void mm(float (&acc)[MR][MS],
                                   const float* __restrict__ A, int am,
                                   int ak, const float* __restrict__ B,
                                   int bk, int bn, int K, int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[MR], bv[MS];
#pragma unroll
    for (int r = 0; r < MR; ++r) av[r] = A[(ty + 16 * r) * am + k * ak];
#pragma unroll
    for (int s = 0; s < MS; ++s) bv[s] = B[k * bk + (tx + 16 * s) * bn];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int s = 0; s < MS; ++s)
        if (!kLower || s <= r) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
  }
}

// mm over K = Q steps where A is a causal Q x Q matrix read as A(row, k):
// kUpper false, A zero where k > row (M2 in dc's product), so row tile r
// takes the 16-step segments kk <= r; kUpper true, A zero where k < row
// (M1^T, M2^T in du's and db's), so row tile r takes the segments
// kk >= r. The skipped terms are exact zeros; the rest keep k's order
template <int MR, int MS, bool kUpper>
__device__ __forceinline__ void mm_causal(float (&acc)[MR][MS],
                                          const float* __restrict__ A,
                                          int am, int ak,
                                          const float* __restrict__ B,
                                          int bk, int bn, int K, int ty,
                                          int tx) {
#pragma unroll
  for (int kk = 0; kk < MR; ++kk) {
    const int k1 = min(K, 16 * kk + 16);
#pragma unroll 2
    for (int k = 16 * kk; k < k1; ++k) {
      float av[MR], bv[MS];
#pragma unroll
      for (int r = 0; r < MR; ++r)
        av[r] = (kUpper ? r <= kk : r >= kk)
                    ? A[(ty + 16 * r) * am + k * ak]
                    : 0.0f;
#pragma unroll
      for (int s = 0; s < MS; ++s) bv[s] = B[k * bk + (tx + 16 * s) * bn];
#pragma unroll
      for (int r = 0; r < MR; ++r)
        if (kUpper ? r <= kk : r >= kk)
#pragma unroll
          for (int s = 0; s < MS; ++s)
            acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
  }
}

template <int MR, int MS>
__device__ __forceinline__ void zero(float (&acc)[MR][MS]) {
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int s = 0; s < MS; ++s) acc[r][s] = 0.0f;
}

// the sum over the 16 threads of a row of the grid (tx = 0..15, one half
// of a warp), in a fixed butterfly order; every lane gets it
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- 1. the reverse walk over the chunks ----------------------------------
// Two buffers of the chunk's tiles: while the block multiplies chunk k's,
// the loads of chunk k - 1's are in flight, so the ordered chain waits on
// the multiply alone.
template <int Q>
constexpr int walk_smem_bytes() {
  constexpr int QM = Q < 16 ? 16 : Q;
  return 2 * (QM * static_cast<int>(sizeof(double)) +
              2 * QM * kLd64 * static_cast<int>(sizeof(float)));
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_state_kernel(const float* __restrict__ dt,
                              const float* __restrict__ a,
                              const float* __restrict__ c,
                              const float* __restrict__ dy,
                              const float* __restrict__ dh,
                              float* __restrict__ gstates, int S, int P,
                              int N, int R) {
  constexpr int QM = Q < 16 ? 16 : Q;
  constexpr int kPer = QM * 64 / kThreads;  // tile values a thread stages
  constexpr int kTile = QM * kLd64;
  // buffer b: cum (float64) at sCum + b QM; e^cum_i dy_i (i, p) at
  // tiles + 2 b kTile; c_i (i, n0 + n) kTile further
  extern __shared__ double walk_smem[];
  double* sCum = walk_smem;
  float* tiles = reinterpret_cast<float*>(walk_smem + 2 * QM);
  __shared__ float sDt[QM];
  __shared__ float sLast[2];  // e^cum_Q
  const int bh = blockIdx.x, n0 = blockIdx.y * 64;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31;
  const int nc = S / Q;
  const float av = a[bh];
  const float* dtb = dt + static_cast<int64_t>(bh) * S;
  const float* dyb = dy + static_cast<int64_t>(bh) * S * P;
  const float* cb = c + static_cast<int64_t>(bh / R) * S * N;
  float* gb = gstates + static_cast<int64_t>(bh) * nc * P * N;

  // chunk k's c and dy into registers (thread tid stages elements tid +
  // 256 u of the QM x 64 tiles), and, in warp 0, its cum into buffer b
  float cv[kPer], dv[kPer];
  auto load = [&](int k, int b) {
    const int s0 = k * Q;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads, i = e >> 6, col = e & 63;
      cv[u] = i < Q && n0 + col < N
                  ? cb[static_cast<int64_t>(s0 + i) * N + n0 + col]
                  : 0.0f;
      dv[u] = i < Q && col < P ? dyb[static_cast<int64_t>(s0 + i) * P + col]
                               : 0.0f;
    }
    if (tid < 32) {
      const double total =
          chunk_cumsum<Q>(dtb + s0, av, sDt, sCum + b * QM, lane);
      if (lane == 0) sLast[b] = expf(static_cast<float>(total));
    }
  };
  // ... and from registers into buffer b, dy scaled by e^cum_i
  auto stage = [&](int b) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads, i = e >> 6, col = e & 63;
      float* dyt = tiles + 2 * b * kTile;
      dyt[kTile + i * kLd64 + col] = cv[u];
      dyt[i * kLd64 + col] =
          i < Q ? expf(static_cast<float>(sCum[b * QM + i])) * dv[u] : 0.0f;
    }
  };

  // G in registers: g[r][s] = G[ty + 16 r][n0 + tx + 16 s]
  float g[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * s;
      g[r][s] = dh != nullptr && p < P && n < N
                    ? dh[(static_cast<int64_t>(bh) * P + p) * N + n]
                    : 0.0f;
    }
  load(nc - 1, (nc - 1) & 1);
  __syncthreads();
  stage((nc - 1) & 1);
  __syncthreads();
  for (int k = nc - 1; k >= 0; --k) {
    const int b = k & 1;
    float* gk = gb + static_cast<int64_t>(k) * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = ty + 16 * r, n = n0 + tx + 16 * s;
        if (p < P && n < N) gk[p * N + n] = g[r][s];
      }
    if (k > 0) load(k - 1, b ^ 1);
    const float last = sLast[b];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) g[r][s] *= last;
    // G(p, n) += sum_i (e^cum_i dy_i)(p) c_i(n)
    const float* dyt = tiles + 2 * b * kTile;
    mm<4, 4>(g, dyt, 1, kLd64, dyt + kTile, kLd64, 1, Q, ty, tx);
    if (k > 0) {
      __syncthreads();  // chunk k - 1's cum is in; buffer b ^ 1 is free
      stage(b ^ 1);
      __syncthreads();
    }
  }
}

// ---- 2. every chunk in parallel -----------------------------------------
template <int Q, int NS>
constexpr int chunk_smem_floats() {
  constexpr int QM = Q < 16 ? 16 : Q;
  return 2 * QM + 5 * QM * kLd64 + 2 * QM * ld_cols(NS) +
         kMaxP * ld_cols(NS) + 5 * QM + kThreads / 32;
}

template <int Q, int NS>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_chunk_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a, const float* __restrict__ b,
        const float* __restrict__ c, const float* __restrict__ states,
        const float* __restrict__ gstates, const float* __restrict__ dy,
        float* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ dbo, float* __restrict__ dco,
        float* __restrict__ dapart, int S, int P, int N, int R) {
  constexpr int QM = Q < 16 ? 16 : Q;
  constexpr int MR = QM / 16;       // row tiles of a Q-row output
  constexpr int NP = 16 * NS;       // N padded to whole column tiles
  constexpr int LN = ld_cols(NS);
  extern __shared__ double smem_d[];
  double* sCum = smem_d;            // QM: cum, float64
  float* sU = reinterpret_cast<float*>(sCum + QM);  // QM x kLd64: x dt (j, p)
  float* sDy = sU + QM * kLd64;     // QM x kLd64: dy (i, p)
  float* sM1 = sDy + QM * kLd64;    // QM x kLd64: (C B^T o L) (i, j)
  float* sM2 = sM1 + QM * kLd64;    // QM x kLd64: (dY U^T o L) (i, j)
  float* sT = sM2 + QM * kLd64;     // QM x kLd64: T (i, j)
  float* sB = sT + QM * kLd64;      // QM x LN: b (j, n)
  float* sC = sB + QM * LN;         // QM x LN: c (i, n)
  float* sHG = sC + QM * LN;        // kMaxP x LN: H_c, then G_c (p, n)
  float* sDt = sHG + kMaxP * LN;    // QM
  float* sP1 = sDt + QM;            // QM: e^cum_i c_i . (H_c^T dy_i)
  float* sW = sP1 + QM;             // QM: W_j
  float* sXdu = sW + QM;            // QM: x_j . du_j
  float* sA = sXdu + QM;            // QM: sum_{i >= k, j < k} T_ij
  float* sRed = sA + QM;            // kThreads / 32 warps' <G, H>

  const int nc = S / Q;
  const int bh = blockIdx.x / nc, k = blockIdx.x - bh * nc;
  const int s0 = k * Q, row = bh / R;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const float av = a[bh];
  const int64_t xoff = (static_cast<int64_t>(bh) * S + s0) * P;
  const int64_t boff = (static_cast<int64_t>(row) * S + s0) * N;
  const float* dtb = dt + static_cast<int64_t>(bh) * S + s0;

  // ---- stage: the chunk's tiles, zero past Q, P and N; the loops have
  // fixed trip counts, unrolled so that eight loads a thread are in flight
  if (warp == 0) chunk_cumsum<Q>(dtb, av, sDt, sCum, lane);
#pragma unroll 8
  for (int e = tid; e < QM * 64; e += kThreads) {
    const int i = e >> 6, p = e & 63;
    const bool in = i < Q && p < P;
    sU[i * kLd64 + p] = in ? x[xoff + i * P + p] * dtb[i] : 0.0f;
    sDy[i * kLd64 + p] = in ? dy[xoff + i * P + p] : 0.0f;
  }
#pragma unroll 8
  for (int e = tid; e < QM * NP; e += kThreads) {
    const int i = e / NP, n = e - (e / NP) * NP;
    const bool in = i < Q && n < N;
    sB[i * LN + n] = in ? b[boff + i * N + n] : 0.0f;
    sC[i * LN + n] = in ? c[boff + i * N + n] : 0.0f;
  }
  const float* Hs = states + (static_cast<int64_t>(bh) * nc + k) * P * N;
#pragma unroll 8
  for (int e = tid; e < kMaxP * NP; e += kThreads) {
    const int p = e / NP, n = e - (e / NP) * NP;
    sHG[p * LN + n] = p < P && n < N ? Hs[p * N + n] : 0.0f;
  }
  __syncthreads();

  // ---- the Q x Q products: C B^T and dY U^T, then L, M1, M2 and T
  {
    float cbt[MR][MR], dut[MR][MR];
    zero(cbt);
    zero(dut);
    mm<MR, MR, true>(cbt, sC, LN, 1, sB, 1, LN, N, ty, tx);
    mm<MR, MR, true>(dut, sDy, kLd64, 1, sU, 1, kLd64, P, ty, tx);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int s = 0; s < MR; ++s) {
        const int i = ty + 16 * r, j = tx + 16 * s;
        // the exponent selected to -inf above the diagonal, then the exp
        const float l = expf(j <= i && i < Q
                                 ? static_cast<float>(sCum[i] - sCum[j])
                                 : -INFINITY);
        const float m1 = cbt[r][s] * l, m2 = dut[r][s] * l;
        sM1[i * kLd64 + j] = m1;
        sM2[i * kLd64 + j] = m2;
        sT[i * kLd64 + j] = m1 * dut[r][s];
      }
  }
  __syncthreads();

  // ---- H_c: dc_i = e^cum_i H_c^T dy_i + sum_j M2_ij b_j, and the entering
  // term of d da
  {
    float dc[MR][NS];
    zero(dc);
    mm<MR, NS>(dc, sDy, kLd64, 1, sHG, LN, 1, P, ty, tx);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int i = ty + 16 * r;
      float part = 0.0f;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        part = fmaf(sC[i * LN + tx + 16 * s], dc[r][s], part);
      part = row_sum(part);
      const float ec = i < Q ? expf(static_cast<float>(sCum[i])) : 0.0f;
      if (tx == 0 && i < Q) sP1[i] = ec * part;
#pragma unroll
      for (int s = 0; s < NS; ++s) dc[r][s] *= ec;
    }
    mm_causal<MR, NS, false>(dc, sM2, kLd64, 1, sB, LN, 1, Q, ty, tx);
    float* dcb = dco + (static_cast<int64_t>(bh) * S + s0) * N;
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int i = ty + 16 * r, n = tx + 16 * s;
        if (i < Q && n < N) dcb[i * N + n] = dc[r][s];
      }
  }
  // the Q x Q terms of d da_k, T over rows i >= k and columns j < k: first
  // each row's exclusive prefix sums in place, T_ik <- sum_{j < k} T_ij
  // (T is 0 above the diagonal), then each column's sum over i >= k below
  if (tid < Q) {
    float s = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float t = sT[tid * kLd64 + j];
      sT[tid * kLd64 + j] = s;
      s += t;
    }
  }
  __syncthreads();  // H_c is no longer read

  // ---- G_c in place of H_c, with <G_c, H_c> on the way
  {
    const float* Gs = gstates + (static_cast<int64_t>(bh) * nc + k) * P * N;
    float gh = 0.0f;
#pragma unroll 8
    for (int e = tid; e < kMaxP * NP; e += kThreads) {
      const int p = e / NP, n = e - (e / NP) * NP;
      const float gv = p < P && n < N ? Gs[p * N + n] : 0.0f;
      gh = fmaf(sHG[p * LN + n], gv, gh);
      sHG[p * LN + n] = gv;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
    if (lane == 0) sRed[warp] = gh;
  }
  __syncthreads();
  if (tid < Q) {
    float s = 0.0f;
    for (int i = Q - 1; i >= tid; --i) s += sT[i * kLd64 + tid];
    sA[tid] = s;
  }

  // ---- G_c: du_j = e^(cum_Q - cum_j) G_c b_j + sum_i M1_ij dy_i, W_j,
  // dx, x_j . du_j; db_j = e^(cum_Q - cum_j) G_c^T u_j + sum_i M2_ij c_i
  {
    float du[MR][4];
    zero(du);
    mm<MR, 4>(du, sB, LN, 1, sHG, 1, LN, N, ty, tx);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int j = ty + 16 * r;
      float part = 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        part = fmaf(sU[j * kLd64 + tx + 16 * s], du[r][s], part);
      part = row_sum(part);
      const float eq = j < Q ? decay(sCum, Q - 1, j) : 0.0f;
      if (tx == 0 && j < Q) sW[j] = eq * part;
#pragma unroll
      for (int s = 0; s < 4; ++s) du[r][s] *= eq;
    }
    mm_causal<MR, 4, true>(du, sM1, 1, kLd64, sDy, kLd64, 1, Q, ty, tx);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int j = ty + 16 * r;
      float part = 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int p = tx + 16 * s;
        if (j < Q && p < P) {
          part = fmaf(x[xoff + j * P + p], du[r][s], part);
          dx[xoff + j * P + p] = sDt[j] * du[r][s];
        }
      }
      part = row_sum(part);
      if (tx == 0 && j < Q) sXdu[j] = part;
    }
  }
  {
    float db[MR][NS];
    zero(db);
    mm<MR, NS>(db, sU, kLd64, 1, sHG, LN, 1, P, ty, tx);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int j = ty + 16 * r;
      const float eq = j < Q ? decay(sCum, Q - 1, j) : 0.0f;
#pragma unroll
      for (int s = 0; s < NS; ++s) db[r][s] *= eq;
    }
    mm_causal<MR, NS, true>(db, sM2, 1, kLd64, sC, LN, 1, Q, ty, tx);
    float* dbb = dbo + (static_cast<int64_t>(bh) * S + s0) * N;
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int j = ty + 16 * r, n = tx + 16 * s;
        if (j < Q && n < N) dbb[j * N + n] = db[r][s];
      }
  }
  __syncthreads();

  // ---- d da, ddt and the chunk's share of da
  if (tid == 0) {
    float gh = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) gh += sRed[w];
    gh *= expf(static_cast<float>(sCum[Q - 1]));
    // W's prefix sums, in place: sW[k] <- sum_{j < k} W_j
    float w = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float wj = sW[j];
      sW[j] = w;
      w += wj;
    }
    float p1 = 0.0f, dap = 0.0f;
    for (int i = Q - 1; i >= 0; --i) {
      p1 += sP1[i];
      const float dda = p1 + sA[i] + sW[i] + gh;
      ddt[static_cast<int64_t>(bh) * S + s0 + i] = sXdu[i] + av * dda;
      dap = fmaf(sDt[i], dda, dap);
    }
    dapart[static_cast<int64_t>(bh) * nc + k] = dap;
  }
}

// ---- 3. db and dc of a row: its R heads' partials in head order ---------
__global__ void __launch_bounds__(kSumThreads)
    ssd_scan_bwd_sum_heads_kernel(const float* __restrict__ dbp,
                                  const float* __restrict__ dcp,
                                  float* __restrict__ db,
                                  float* __restrict__ dc, int64_t row_size,
                                  int64_t total, int R) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kSumThreads +
                    threadIdx.x;
  if (e >= total) return;
  const int64_t row = e / row_size, off = e - row * row_size;
  const int64_t first = row * R * row_size + off;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < R; ++h) {
    sb += dbp[first + h * row_size];
    sc += dcp[first + h * row_size];
  }
  db[e] = sb;
  dc[e] = sc;
}

// ---- 4. da of a head: its chunks' shares in chunk order -----------------
__global__ void __launch_bounds__(kSumThreads)
    ssd_scan_bwd_sum_chunks_kernel(const float* __restrict__ dapart,
                                   float* __restrict__ da, int BH, int nc) {
  const int bh = blockIdx.x * kSumThreads + threadIdx.x;
  if (bh >= BH) return;
  float s = 0.0f;
  for (int k = 0; k < nc; ++k) s += dapart[static_cast<int64_t>(bh) * nc + k];
  da[bh] = s;
}

template <int Q, int NS>
int launch_chunks(const float* x, const float* dt, const float* a,
                  const float* b, const float* c, const float* states,
                  const float* gst, const float* dy, float* dx, float* ddt,
                  float* dbo, float* dco, float* dap, int BH, int S, int P,
                  int N, int R, cudaStream_t s) {
  const size_t smem = chunk_smem_floats<Q, NS>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_chunk_kernel<Q, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err) return static_cast<int>(err);
  ssd_scan_bwd_chunk_kernel<Q, NS>
      <<<static_cast<unsigned>(BH) * static_cast<unsigned>(S / Q), kThreads,
         smem, s>>>(x, dt, a, b, c, states, gst, dy, dx, ddt, dbo, dco, dap,
                    S, P, N, R);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch(const float* x, const float* dt, const float* a, const float* b,
           const float* c, const float* states, const float* dy,
           const float* dh, float* dx, float* ddt, float* da, float* db,
           float* dc, float* gst, float* dbp, float* dcp, float* dap, int BH,
           int S, int P, int N, int R, cudaStream_t s) {
  constexpr int walk_smem = walk_smem_bytes<Q>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_state_kernel<Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, walk_smem);
  if (err) return static_cast<int>(err);
  ssd_scan_bwd_state_kernel<Q>
      <<<dim3(static_cast<unsigned>(BH), static_cast<unsigned>((N + 63) / 64)),
         kThreads, walk_smem, s>>>(dt, a, c, dy, dh, gst, S, P, N, R);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  // per-head db and dc where R heads share a row, the row's own where not
  float* dbo = R > 1 ? dbp : db;
  float* dco = R > 1 ? dcp : dc;
  int code;
  if (N <= 16)
    code = launch_chunks<Q, 1>(x, dt, a, b, c, states, gst, dy, dx, ddt, dbo,
                               dco, dap, BH, S, P, N, R, s);
  else if (N <= 32)
    code = launch_chunks<Q, 2>(x, dt, a, b, c, states, gst, dy, dx, ddt, dbo,
                               dco, dap, BH, S, P, N, R, s);
  else if (N <= 64)
    code = launch_chunks<Q, 4>(x, dt, a, b, c, states, gst, dy, dx, ddt, dbo,
                               dco, dap, BH, S, P, N, R, s);
  else
    code = launch_chunks<Q, 8>(x, dt, a, b, c, states, gst, dy, dx, ddt, dbo,
                               dco, dap, BH, S, P, N, R, s);
  if (code) return code;
  if (R > 1) {
    const int64_t total = static_cast<int64_t>(BH / R) * S * N;
    ssd_scan_bwd_sum_heads_kernel<<<static_cast<unsigned>(
                                        (total + kSumThreads - 1) /
                                        kSumThreads),
                                    kSumThreads, 0, s>>>(
        dbp, dcp, db, dc, static_cast<int64_t>(S) * N, total, R);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
  }
  ssd_scan_bwd_sum_chunks_kernel<<<static_cast<unsigned>(
                                       (BH + kSumThreads - 1) / kSumThreads),
                                   kSumThreads, 0, s>>>(dap, da, BH, S / Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All float32 and contiguous. chunk one of 8, 16, 32, 64, dividing S;
// 1 <= P <= 64, 1 <= N <= 128. x, dy and dx (BH, S, P); dt and ddt (BH, S);
// a and da (BH,); b, c, db and dc (BH / R, S, N); dh (BH, P, N) or null
// (zero); states (BH, S / chunk, P, N), the states entering each chunk as
// repro_ssd_scan writes them. Scratch, none of it read before this call
// writes it: gstates, BH * (S / chunk) * P * N; dbp and dcp, BH * S * N
// each where R > 1 (unused, may be null, where R = 1); dapart,
// BH * (S / chunk). Three launches on the stream, four where R > 1;
// returns the CUDA error code of the first that fails (0 = cudaSuccess).
extern "C" int repro_ssd_scan_bwd(int chunk, const void* x, const void* dt,
                                  const void* a, const void* b,
                                  const void* c, const void* states,
                                  const void* dy, const void* dh, void* dx,
                                  void* ddt, void* da, void* db, void* dc,
                                  void* gstates, void* dbp, void* dcp,
                                  void* dapart, int BH, int S, int P, int N,
                                  int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || R < 1 ||
      BH < 1 || BH % R != 0 || S < chunk || S % chunk != 0 ||
      (R > 1 && (dbp == nullptr || dcp == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SSD_BWD_ARGS                                                   \
  static_cast<const float*>(x), static_cast<const float*>(dt),               \
      static_cast<const float*>(a), static_cast<const float*>(b),            \
      static_cast<const float*>(c), static_cast<const float*>(states),       \
      static_cast<const float*>(dy), static_cast<const float*>(dh),          \
      static_cast<float*>(dx), static_cast<float*>(ddt),                     \
      static_cast<float*>(da), static_cast<float*>(db),                      \
      static_cast<float*>(dc), static_cast<float*>(gstates),                 \
      static_cast<float*>(dbp), static_cast<float*>(dcp),                    \
      static_cast<float*>(dapart), BH, S, P, N, R, s
  switch (chunk) {
    case 8:
      return launch<8>(REPRO_SSD_BWD_ARGS);
    case 16:
      return launch<16>(REPRO_SSD_BWD_ARGS);
    case 32:
      return launch<32>(REPRO_SSD_BWD_ARGS);
    case 64:
      return launch<64>(REPRO_SSD_BWD_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSD_BWD_ARGS
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
