// The gradient of masked softmax attention with grouped KV heads, in bf16
// on Hopper's tensor cores (sm_90a): dq, dk and dv from bf16 q, k, v, the
// forward's bf16 output o and f32 per-row log-sum-exp, and the output's
// bf16 gradient do.
//
//   s[i, j] = scale q[i] . k[j],  p[i, j] = mask(i, j) ? exp(s - lse[i]) : 0
//   dv[j]   = sum_i p[i, j] do[i]
//   dp[i,j] = do[i] . v[j],  ds[i, j] = p[i, j] (dp[i, j] - delta[i]),
//   delta[i] = do[i] . o[i]
//   dq[i]   = scale sum_j ds[i, j] k[j],  dk[j] = scale sum_i ds[i, j] q[i]
//
// q, dq (B, Sq, H, DQK); k, dk (B, Sk, Hkv, DQK); o, do (B, Sq, H, DV); v,
// dv (B, Sk, Hkv, DV), all bf16; lse (B, H, Sq) f32, written by the bf16
// forward (attention_sm90.cu) in natural-log units, -inf for a row that
// keeps no key (whose output and gradient are 0). The width pairs (DQK, DV)
// are the bf16 forward's: equal widths of 32, 64 or 128, and MLA's (192,
// 128). The masks are the forward's: query row i sits at position i + Sk -
// Sq; key j is kept when j < Sk, j <= qpos if causal, and j > qpos - window
// if window > 0. The dk and dv of kv head hk sum over its G = H / Hkv query
// heads.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel.
// Its training path differentiates jnp attention (src/repro/models/), which
// in bf16 rounds the probabilities to bf16 before they meet v
// (models/attention.py, _sdpa). On the card the port's bf16 forward is a
// hand-written kernel (attention_sm90.cu), so its gradient is one too.
//
// Bound: the arithmetic, 5 products per kept query-key pair and query head,
// 2 (3 DQK + 2 DV) flops, at the bf16 tensor-core rate (989 TFLOP/s); bf16
// inputs are exact in bf16, so each product is one bf16 product with f32
// accumulation. This design, two passes and no atomics, computes s and dp
// in both passes: 2 (5 DQK + 4 DV) flops, 7/5 of that bound at equal
// widths.
//
// Design: the forward's parts (sm90_common.cuh: TMA on 4-D tensor maps
// over (D, heads, S, B) with 128-byte swizzle, 64-byte at D = 32; wgmma
// with shared-memory descriptors; a producer warp and two consumer
// warpgroups of 64 rows, setmaxnreg 24 / 240). P and dS are formed on the
// f32 accumulator fragments and rounded to bf16 once, as the register A
// operand of the next product (where the reference rounds its
// probabilities); every running sum is f32 in the tensor cores'
// accumulators. Three launches, no atomics, every sum in a fixed order, so
// a given card gives the same bits on every run (gradients feed the
// divergence trigger through the parameter plane).
//   1. delta: DV / 8 lanes a row, a 16-byte vector of o and of do a lane,
//      f32 sums, an xor butterfly over the row's lanes.
//   2. dk, dv: a block owns kBKV = 128 keys of one (batch, kv head), 64 a
//      consumer warpgroup (wgmma's M), and walks the group's G query heads
//      in head order and, for each, the query tiles of BQ rows that the
//      causal diagonal, the window and Sq leave alive. K and V arrive once;
//      the producer warp streams Q and dO by TMA on a ring of kKvStages,
//      with the tile's lse (in log2 units, +inf past Sq) and delta, which
//      its lanes copy into the stage and announce on the stage's barrier.
//      With the keys as rows each consumer issues S^T = K Q^T and dP^T =
//      V dO^T (SS, all four tiles K-major: D is contiguous, each its own
//      wgmma group), forms P^T on the fragments while dP^T runs (a tile
//      that crosses Sk, the diagonal or the window's edge is masked; one
//      that no row keeps is skipped), then dS^T, then dV += P^T dO and dK
//      += dS^T Q with the packed fragments as the A operand and dO and Q
//      as B through the transpose bit (MN-major, nothing transposed in
//      memory). dK and dV stay in registers over the whole group and are
//      written once, in bf16, dK scaled, by TMA store (which clips keys >=
//      Sk) from the warpgroup's own rows of the K and V tiles. So no f32
//      partial and no group-sum launch. The grid is (batch, kv head)
//      fastest, the first key tile first: under the causal mask the first
//      key tiles have the most query rows.
//   3. dq: the forward's skeleton with one more product. A block owns 128
//      query rows of one (batch, head), the last query tile first; the
//      producer streams K and V tiles of BK keys over the forward's key
//      range on a ring of kQStages. Each consumer issues S = Q K^T and dP
//      = dO V^T (SS, a wgmma group each), forms P while dP runs, then dS,
//      then dQ += dS K (RS, K MN-major through the transpose bit), and
//      writes dq once, in bf16, scaled, by TMA store from its own rows of
//      the Q tile (rows >= Sq clipped).
// Tiles. BQ, the dk/dv pass's query tile: 64 at equal widths; 32 at (192,
// 128), where the consumer holds dK (96 registers a thread) and dV (64)
// and a 64-query S^T and dP^T would overflow its 240 registers. BK, the
// dq pass's key tile: 128 at (128, 128), so S and dP are m64n128 wgmmas;
// 64 at the other widths. At DQK = 192 the dK and dQ products are an n128
// and an n64 wgmma over the B tile's first two boxes and its third.
// Overlap. The two consumer warpgroups keep the tensor cores busy for each
// other; within a warpgroup only P's exponentials overlap a product (dP or
// dP^T). Deeper overlap inside a warpgroup (the forward's pipeline with
// two dS buffers in the dq pass; dV issued before dS^T is formed in the
// dk/dv pass) made both passes slower on the H100 (PERF.md §6, PR 32).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHalf = 64;                   // rows a consumer warpgroup
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kKvStages = 3;                // the dk/dv pass's Q/dO ring
constexpr int kQStages = 2;                 // the dq pass's K/V ring
constexpr int kBKV = 128;                   // keys a dk/dv block
constexpr int kBQ = 128;                    // query rows a dq block
constexpr int kFlatThreads = 384;           // the delta kernel's blocks
constexpr float kLog2e = 1.4426950408889634f;

// the dk/dv pass's tiles at query/key width DQK and value width DV: K and
// V resident (kBKV rows), then the ring's stages, each a Q and a dO tile of
// BQ rows; then each stage's lse and delta rows (f32), then the barriers
template <int DQK, int DV>
struct KvTile {
  using QK = Box<DQK>;
  using VO = Box<DV>;
  static constexpr int BQ = DQK + DV <= 256 ? 64 : 32;
  static constexpr int K_BYTES = kBKV * DQK * 2;
  static constexpr int V_BYTES = kBKV * DV * 2;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int O_BYTES = BQ * DV * 2;
  static constexpr int STAGE = Q_BYTES + O_BYTES;
  static constexpr int ROWS = K_BYTES + V_BYTES + kKvStages * STAGE;
  static constexpr int BARS = ROWS + kKvStages * 2 * BQ * 4;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * kKvStages) + 1024;  // align
};

// the dq pass's tiles: Q and dO resident (kBQ rows), then the ring's
// stages, each a K and a V tile of BK rows; then the barriers. BK: 128
// keys at (128, 128), S and dP one m64n128 wgmma wide; 64 at (192, 128),
// where dQ takes 96 of a consumer's registers, and at the narrow widths,
// where a banded window masks more of a wider tile
template <int DQK, int DV>
struct QTile {
  using QK = Box<DQK>;
  using VO = Box<DV>;
  static constexpr int BK = DQK == 128 && DV == 128 ? 128 : 64;
  static constexpr int Q_BYTES = kBQ * DQK * 2;
  static constexpr int O_BYTES = kBQ * DV * 2;
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int BARS = Q_BYTES + O_BYTES + kQStages * STAGE;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * kQStages) + 1024;  // align
};

// a row's lse in log2 units: +inf where the row keeps nothing, so its p is 0
__device__ __forceinline__ float lse2_of(float v) {
  return isinf(v) ? INFINITY : v * kLog2e;
}

// (lo, hi) rounded to bf16, to nearest even, as one register
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ bool keeps(int qpos, int kpos, int Sk, int causal,
                                      int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// the K-major descriptor of k-step kk (16 columns, 32 bytes) of a tile of
// D-column rows stored as boxes of `rows` rows: the step's box, then its
// offset in the swizzled row
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int kk) {
  using X = Box<D>;
  const uint32_t box = (kk * 32) / X::ROW, in = (kk * 32) % X::ROW;
  return smem_desc(tile + box * rows * X::ROW + in, 16, 8 * X::ROW,
                   X::LAYOUT);
}

// the MN-major descriptor of k-step kk (16 rows) of such a tile, read as
// a B operand whose N is the tile's columns: the next box `rows` rows on
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  using X = Box<D>;
  return smem_desc(tile + kk * 16 * X::ROW, rows * X::ROW, 8 * X::ROW,
                   X::LAYOUT);
}

// d (64 x 128, f32) = (accumulate 0) or += A (64 x 16, smem) . B (128 x
// 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) = or += A (64 x 16, smem) . B (N x 16, smem, K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         bool first) {
  static_assert(N == 32 || N == 64 || N == 128, "a score tile's columns");
  if constexpr (N == 32) {
    if (first) wgmma_ss_n32_first(d, da, db);
    else wgmma_ss_n32(d, da, db);
  } else if constexpr (N == 64) {
    if (first) wgmma_ss_n64_first(d, da, db);
    else wgmma_ss_n64(d, da, db);
  } else {
    wgmma_ss_n128(d, da, db, !first);
  }
}

// d (64 x N) += A (64 x 16, registers) . B (16 x N, smem, MN-major) with N
// a tile's width D; at D = 192 an n128 over its first two boxes and an n64
// over its third, `box` bytes on
template <int D>
__device__ __forceinline__ void wgmma_rs_wide(float* d, const uint32_t* a,
                                              uint64_t db, uint32_t box) {
  if constexpr (D == 192) {
    wgmma_rs<128>(d, a, db);
    wgmma_rs<64>(d + 64, a, db + ((2 * box) >> 4));
  } else {
    wgmma_rs<D>(d, a, db);
  }
}

// a warpgroup's 64 rows of f32 accumulator columns (x factor) written as
// bf16 into its rows of a tile of D-column boxes of `rows` rows (at
// `base`, its first row), swizzled as the tensor map expects
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* base, const float* acc,
                                           float factor, int rows, int r0,
                                           int cq) {
  using X = Box<D>;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    const uint32_t box = col / X::COLS, cc = col % X::COLS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = box * rows * X::ROW +
                           swizzle<X::ROW>((r0 + 8 * r) * X::ROW + 2 * cc);
      *reinterpret_cast<__nv_bfloat162*>(base + off) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * factor, acc[4 * j + 2 * r + 1] * factor);
    }
  }
}

// delta[b, h, i] = do[b, i, h] . o[b, i, h] over the DV columns: DV / 8
// lanes a row, a 16-byte vector of each a lane, f32 sums in column order
// within a lane, then an xor butterfly over the row's lanes
template <int DV>
__global__ void __launch_bounds__(kFlatThreads)
    attention_bwd_bf16_delta_kernel(const uint4* __restrict__ o,
                                    const uint4* __restrict__ dO,
                                    float* __restrict__ delta,
                                    long long rows, int Sq, int H) {
  constexpr int L = DV / 8;  // lanes a row
  const long long row =
      (static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x) / L;
  const int part = threadIdx.x % L;
  float acc = 0.0f;
  if (row < rows) {
    const uint4 a = o[row * L + part], g = dO[row * L + part];
    const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
    const uint32_t wg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wa[e]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wg[e]));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && part == 0) {
    // row = (b Sq + i) H + h -> delta[(b H + h) Sq + i]
    const long long h = row % H, bi = row / H;
    const long long i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// dk, dv. A block owns keys [k0, k0 + kBKV) of one (batch, kv head) and
// writes their dk and dv in bf16.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_bf16_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const __grid_constant__ CUtensorMap tdk,
                                  const __grid_constant__ CUtensorMap tdv,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, int H,
                                  int Hkv, int Sq, int Sk, int causal,
                                  int window, float scale) {
  using T = KvTile<DQK, DV>;
  using QK = typename T::QK;
  using VO = typename T::VO;
  constexpr int BQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T::K_BYTES;
  // stage s: Q at sS + s STAGE, dO right after it
  const uint32_t sS = sV + T::V_BYTES;
  uint8_t* const base = smem_raw + (sK - smem_addr(smem_raw));
  // stage s: lse2 at sL + 2 s BQ, delta right after it
  float* const sL = reinterpret_cast<float*>(base + T::ROWS);
  const uint32_t kv_full = sK + T::BARS;
  const uint32_t full = kv_full + 8;            // + 8 s, likewise below
  const uint32_t empty = full + 8 * kKvStages;

  // (batch, kv head) fastest, the first key tile first
  const int n_kt = (Sk + kBKV - 1) / kBKV;
  const int BHk = gridDim.x / n_kt;
  const int bh = blockIdx.x % BHk;
  const int k0 = static_cast<int>(blockIdx.x / BHk) * kBKV;
  const int b = bh / Hkv, hk = bh - b * Hkv;
  const int G = H / Hkv;

  // the query tiles any key of this block may be kept by
  const int off = Sk - Sq;
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - off);
  if (window > 0) i_hi = min(Sq, k0 + kBKV - 1 + window - off);
  const int t_lo = i_lo / BQ;
  const int n_t = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - t_lo : 0;
  const int n_iter = G * n_t;  // head hh's tiles are iterations hh n_t ..

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid < kConsumers + 32) {
      const int lane = tid - kConsumers;
      if (lane == 0) {
        mbar_expect_tx(kv_full, T::K_BYTES + T::V_BYTES);
        for (int c = 0; c < QK::CHUNKS; ++c)
          tma_load(sK + c * kBKV * QK::ROW, &tk, kv_full, c * QK::COLS, hk,
                   k0, b);
        for (int c = 0; c < VO::CHUNKS; ++c)
          tma_load(sV + c * kBKV * VO::ROW, &tv, kv_full, c * VO::COLS, hk,
                   k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kKvStages, hh = it / n_t;
        const int h = hk * G + hh, q0 = (t_lo + it - hh * n_t) * BQ;
        if (it >= kKvStages)
          mbar_wait(empty + 8 * s, ((it / kKvStages) & 1) ^ 1);
        const float* lr = lse + (static_cast<int64_t>(b) * H + h) * Sq;
        const float* dr = delta + (static_cast<int64_t>(b) * H + h) * Sq;
        float* ls = sL + 2 * BQ * s;
        for (int e = lane; e < BQ; e += 32) {
          const int i = q0 + e;
          ls[e] = i < Sq ? lse2_of(lr[i]) : INFINITY;
          ls[BQ + e] = i < Sq ? dr[i] : 0.0f;
        }
        if (lane == 0) {  // its arrival carries the tiles' bytes
          const uint32_t sQ = sS + s * T::STAGE;
          mbar_expect_tx(full + 8 * s, T::STAGE);
          for (int c = 0; c < QK::CHUNKS; ++c)
            tma_load(sQ + c * BQ * QK::ROW, &tq, full + 8 * s, c * QK::COLS,
                     h, q0, b);
          for (int c = 0; c < VO::CHUNKS; ++c)
            tma_load(sQ + T::Q_BYTES + c * BQ * VO::ROW, &tdo, full + 8 * s,
                     c * VO::COLS, h, q0, b);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup g owns keys kg .. kg + 63; a thread holds keys
  // kg + r0 and kg + r0 + 8, query columns 8j + cq + {0, 1} of each S^T
  // fragment
  const int g = tid / 128, lt = tid % 128;
  const int lane = lt % 32;
  const int r0 = 16 * (lt / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kg = k0 + kHalf * g;
  const int kpos[2] = {kg + r0, kg + r0 + 8};
  const uint32_t sKg = sK + g * kHalf * QK::ROW;
  const uint32_t sVg = sV + g * kHalf * VO::ROW;
  const float sl2 = scale * kLog2e;  // scores in log2 units

  float dk[DQK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dk[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.0f;
  float st[BQ / 2], dpt[BQ / 2];
  uint32_t pa[BQ / 4], da[BQ / 4];  // P^T and dS^T as bf16 A fragments
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kKvStages, hh = it / n_t;
    const int q0 = (t_lo + it - hh * n_t) * BQ;
    const int pos_lo = q0 + off, pos_hi = pos_lo + BQ - 1;
    mbar_wait(full + 8 * s, (it / kKvStages) & 1);
    // no key of this warpgroup is kept by a row of this tile: skip it
    const bool skip = kg >= Sk || (causal && kg > pos_hi) ||
                      (window > 0 && kg + kHalf - 1 <= pos_lo - window);
    if (!skip) {
      const uint32_t sQ = sS + s * T::STAGE, sO = sQ + T::Q_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<BQ>(st, kmajor<DQK>(sKg, kBKV, kk), kmajor<DQK>(sQ, BQ, kk),
                     kk == 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<BQ>(dpt, kmajor<DV>(sVg, kBKV, kk), kmajor<DV>(sO, BQ, kk),
                     kk == 0);
      wgmma_commit();

      // P^T while dP^T runs: element (r, c) of n-tile j is key kpos[r],
      // query q0 + 8j + cq + c; pair (4j + 2r, +1) is A register 2j + r
      wgmma_wait<1>();
      fence_regs<BQ / 2>(st);
      const bool edge = kg + kHalf - 1 >= Sk ||
                        (causal && kg + kHalf - 1 > pos_lo) ||
                        (window > 0 && kg <= pos_hi - window);
      const float* ls = sL + 2 * BQ * s;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            float p = ex2(fmaf(st[e], sl2, -(c ? l.y : l.x)));
            if (edge && !keeps(pos_lo + 8 * j + cq + c, kpos[r], Sk, causal,
                               window))
              p = 0.0f;
            st[e] = p;
          }
          pa[2 * j + r] = pack(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
        }
      }
      fence_regs<BQ / 4>(pa);

      // dS^T once dP^T has landed
      wgmma_wait<0>();
      fence_regs<BQ / 2>(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(ls + BQ + 8 * j + cq);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r;
          da[2 * j + r] = pack(st[e] * (dpt[e] - dl.x),
                               st[e + 1] * (dpt[e + 1] - dl.y));
        }
      }
      fence_regs<BQ / 4>(da);

      // dV += P^T dO, dK += dS^T Q: the tile's queries are the k order
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs_wide<DV>(dv, pa + 4 * kk, mnmajor<DV>(sO, BQ, kk),
                          BQ * VO::ROW);
        wgmma_rs_wide<DQK>(dk, da + 4 * kk, mnmajor<DQK>(sQ, BQ, kk),
                           BQ * QK::ROW);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DV / 2>(dv);
      fence_regs<DQK / 2>(dk);
    }
    mbar_arrive(empty + 8 * s);
  }

  // dk (scaled) and dv in bf16 into this warpgroup's rows of the K and V
  // tiles, which only it reads, then to memory by TMA (keys >= Sk clipped)
  warpgroup_sync(g);
  stage_rows<DQK>(base + g * kHalf * QK::ROW, dk, scale, kBKV, r0, cq);
  stage_rows<DV>(base + T::K_BYTES + g * kHalf * VO::ROW, dv, 1.0f, kBKV, r0,
                 cq);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(g);
  if (lt == 0 && kg < Sk) {
    for (int c = 0; c < QK::CHUNKS; ++c)
      tma_store(&tdk, sKg + c * kBKV * QK::ROW, c * QK::COLS, hk, kg, b);
    for (int c = 0; c < VO::CHUNKS; ++c)
      tma_store(&tdv, sVg + c * kBKV * VO::ROW, c * VO::COLS, hk, kg, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// dq. A block owns query rows [q0, q0 + kBQ) of one (batch, head).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_bf16_dq_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const __grid_constant__ CUtensorMap tdq,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta, int H,
                                 int Hkv, int Sq, int Sk, int causal,
                                 int window, float scale) {
  using T = QTile<DQK, DV>;
  using QK = typename T::QK;
  using VO = typename T::VO;
  constexpr int kBK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + T::Q_BYTES;
  // stage s: K at sS + s STAGE, V right after it
  const uint32_t sS = sO + T::O_BYTES;
  uint8_t* const base = smem_raw + (sQ - smem_addr(smem_raw));
  const uint32_t q_full = sQ + T::BARS;
  const uint32_t full = q_full + 8;             // + 8 s, likewise below
  const uint32_t empty = full + 8 * kQStages;

  // the last query tile first, (batch, head) fastest
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kBQ;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);

  // the key tiles any row of this query tile may keep, as the forward's
  const int off = Sk - Sq;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, off + q_last + 1);
  if (window > 0) k_lo = max(0, off + q0 - window + 1);
  const int t_begin = k_lo / kBK;
  const int n_tiles =
      max(0, (k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0) - t_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, T::Q_BYTES + T::O_BYTES);
      for (int c = 0; c < QK::CHUNKS; ++c)
        tma_load(sQ + c * kBQ * QK::ROW, &tq, q_full, c * QK::COLS, h, q0, b);
      for (int c = 0; c < VO::CHUNKS; ++c)
        tma_load(sO + c * kBQ * VO::ROW, &tdo, q_full, c * VO::COLS, h, q0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kQStages, k0 = (t_begin + i) * kBK;
        const uint32_t sK = sS + s * T::STAGE;
        if (i >= kQStages) mbar_wait(empty + 8 * s, ((i / kQStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, T::STAGE);
        for (int c = 0; c < QK::CHUNKS; ++c)
          tma_load(sK + c * kBK * QK::ROW, &tk, full + 8 * s, c * QK::COLS,
                   hk, k0, b);
        for (int c = 0; c < VO::CHUNKS; ++c)
          tma_load(sK + T::K_BYTES + c * kBK * VO::ROW, &tv, full + 8 * s,
                   c * VO::COLS, hk, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup g owns rows q0 + 64g .. + 63; a thread holds rows
  // r0 and r0 + 8 of them, key columns 8j + cq + {0, 1} of each fragment
  const int g = tid / 128, lt = tid % 128;
  const int lane = lt % 32;
  const int r0 = 16 * (lt / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qg = q0 + kHalf * g;
  const int pos0 = off + qg;  // position of the warpgroup's first row
  const int qpos[2] = {pos0 + r0, pos0 + r0 + 8};
  const uint32_t sQg = sQ + g * kHalf * QK::ROW;
  const uint32_t sOg = sO + g * kHalf * VO::ROW;
  const float sl2 = scale * kLog2e;
  const float* lr = lse + static_cast<int64_t>(bh) * Sq;
  const float* dr = delta + static_cast<int64_t>(bh) * Sq;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qg + r0 + 8 * r;
    l2[r] = i < Sq ? lse2_of(lr[i]) : INFINITY;
    dl[r] = i < Sq ? dr[i] : 0.0f;
  }

  float dq[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dq[i] = 0.0f;
  float sc[kBK / 2], dp[kBK / 2];
  uint32_t da[kBK / 4];  // dS as bf16 A fragments
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kQStages, k0 = (t_begin + i) * kBK;
    mbar_wait(full + 8 * s, (i / kQStages) & 1);
    // no row of this warpgroup keeps a key of this tile: skip it
    const bool skip = qg >= Sq || (causal && k0 > pos0 + kHalf - 1) ||
                      (window > 0 && k0 + kBK - 1 <= pos0 - window);
    if (!skip) {
      const uint32_t sK = sS + s * T::STAGE, sV = sK + T::K_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<kBK>(sc, kmajor<DQK>(sQg, kBQ, kk), kmajor<DQK>(sK, kBK, kk),
                      kk == 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<kBK>(dp, kmajor<DV>(sOg, kBQ, kk), kmajor<DV>(sV, kBK, kk),
                      kk == 0);
      wgmma_commit();

      // P while dP runs: element (r, c) of n-tile j is row qpos[r], key
      // k0 + 8j + cq + c
      wgmma_wait<1>();
      fence_regs<kBK / 2>(sc);
      const bool edge = k0 + kBK > Sk ||
                        (causal && k0 + kBK - 1 > pos0) ||
                        (window > 0 && k0 <= pos0 + kHalf - 1 - window);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            float p = ex2(fmaf(sc[e], sl2, -l2[r]));
            if (edge && !keeps(qpos[r], k0 + 8 * j + cq + c, Sk, causal,
                               window))
              p = 0.0f;
            sc[e] = p;
          }
        }
      }
      // dS once dP has landed
      wgmma_wait<0>();
      fence_regs<kBK / 2>(dp);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r;
          da[2 * j + r] = pack(sc[e] * (dp[e] - dl[r]),
                               sc[e + 1] * (dp[e + 1] - dl[r]));
        }
      }
      fence_regs<kBK / 4>(da);

      // dQ += dS K: the tile's keys are the k order
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs_wide<DQK>(dq, da + 4 * kk, mnmajor<DQK>(sK, kBK, kk),
                           kBK * QK::ROW);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DQK / 2>(dq);
    }
    mbar_arrive(empty + 8 * s);
  }

  // dq (scaled) in bf16 into this warpgroup's rows of the Q tile, which
  // only it reads, then to memory by TMA (rows >= Sq clipped)
  warpgroup_sync(g);
  stage_rows<DQK>(base + g * kHalf * QK::ROW, dq, scale, kBQ, r0, cq);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(g);
  if (lt == 0 && qg < Sq) {
    for (int c = 0; c < QK::CHUNKS; ++c)
      tma_store(&tdq, sQg + c * kBQ * QK::ROW, c * QK::COLS, h, qg, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int DQK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dO, bf16* dq, bf16* dk, bf16* dv,
           float* delta, int B, int H, int Hkv, int Sq, int Sk, int causal,
           int window, float scale, cudaStream_t s) {
  using KT = KvTile<DQK, DV>;
  using QT = QTile<DQK, DV>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the dk/dv pass's maps: Q and dO by BQ rows, K and V by kBKV, dk and
  // dv stored by a warpgroup's kHalf; the dq pass's: Q and dO by kBQ, K
  // and V by BK, dq stored by kHalf
  CUtensorMap kq, kk, kv, kdo, kdk, kdv, qq, qk, qv, qdo, qdq;
  if (!make_map<DQK>(encode, &kq, q, H, Sq, B, KT::BQ) ||
      !make_map<DQK>(encode, &kk, k, Hkv, Sk, B, kBKV) ||
      !make_map<DV>(encode, &kv, v, Hkv, Sk, B, kBKV) ||
      !make_map<DV>(encode, &kdo, dO, H, Sq, B, KT::BQ) ||
      !make_map<DQK>(encode, &kdk, dk, Hkv, Sk, B, kHalf) ||
      !make_map<DV>(encode, &kdv, dv, Hkv, Sk, B, kHalf) ||
      !make_map<DQK>(encode, &qq, q, H, Sq, B, kBQ) ||
      !make_map<DQK>(encode, &qk, k, Hkv, Sk, B, QT::BK) ||
      !make_map<DV>(encode, &qv, v, Hkv, Sk, B, QT::BK) ||
      !make_map<DV>(encode, &qdo, dO, H, Sq, B, kBQ) ||
      !make_map<DQK>(encode, &qdq, dq, H, Sq, B, kHalf))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long d_blocks =
      (rows * (DV / 8) + kFlatThreads - 1) / kFlatThreads;
  const long long kv_blocks =
      static_cast<long long>(B) * Hkv * ((Sk + kBKV - 1) / kBKV);
  const long long q_blocks =
      static_cast<long long>(B) * H * ((Sq + kBQ - 1) / kBQ);
  if (d_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_bf16_dkv_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, KT::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_bf16_dq_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QT::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_delta_kernel<DV><<<static_cast<unsigned>(d_blocks),
                                        kFlatThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(o), reinterpret_cast<const uint4*>(dO),
      delta, rows, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_dkv_kernel<DQK, DV>
      <<<static_cast<unsigned>(kv_blocks), kThreads, KT::SMEM, s>>>(
          kq, kk, kv, kdo, kdk, kdv, lse, delta, H, Hkv, Sq, Sk, causal,
          window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_dq_kernel<DQK, DV>
      <<<static_cast<unsigned>(q_blocks), kThreads, QT::SMEM, s>>>(
          qq, qk, qv, qdo, qdq, lse, delta, H, Hkv, Sq, Sk, causal, window,
          scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, o, dO, dq, dk and dv; f32 lse and delta; (d, dv) the
// (query/key, value) widths, one of (32, 32), (64, 64), (128, 128) and
// (192, 128). q and dq are (B, Sq, H, d); k and dk (B, Sk, Hkv, d); o and
// dO (B, Sq, H, dv); v and dv (B, Sk, Hkv, dv); lse and delta (B, H, Sq),
// delta scratch the launcher fills. All contiguous and 16-byte aligned, H %
// Hkv == 0. Three launches on `stream`; returns the CUDA error code of the
// first that fails (0 = cudaSuccess).
extern "C" int repro_attention_bwd_bf16(int d, int dv, const void* q,
                                        const void* k, const void* v,
                                        const void* o, const void* lse,
                                        const void* dO, void* dq, void* dk,
                                        void* dV, void* delta, int B, int H,
                                        int Hkv, int Sq, int Sk, int causal,
                                        int window, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_ATTENTION_BWD_BF16_CASE(DQK, DV)                               \
  if (d == DQK && dv == DV)                                                  \
    return launch<DQK, DV>(                                                  \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),            \
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),            \
        static_cast<const float*>(lse), static_cast<const bf16*>(dO),        \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),                      \
        static_cast<bf16*>(dV), static_cast<float*>(delta), B, H, Hkv, Sq,   \
        Sk, causal, window, scale, s);
  REPRO_ATTENTION_BWD_BF16_CASE(32, 32)
  REPRO_ATTENTION_BWD_BF16_CASE(64, 64)
  REPRO_ATTENTION_BWD_BF16_CASE(128, 128)
  REPRO_ATTENTION_BWD_BF16_CASE(192, 128)
#undef REPRO_ATTENTION_BWD_BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
