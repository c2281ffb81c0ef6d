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
// accumulation (the f32 program, attention_bwd.cu, needs three TF32 ones).
// This design, two passes and no atomics, computes s and dp in both passes:
// 2 (5 DQK + 4 DV) flops, 7/5 of that bound at equal widths.
//
// Design: the f32 program's (attention_bwd.cu) passes, tiles and sums, with
// bf16 tiles in shared memory and every product one
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32. P and dS stay f32 on the
// accumulator fragments and are rounded to bf16 once, as the A operand of
// dV += P^T dO, dK += dS^T Q and dQ += dS K (where the reference rounds
// the probabilities); the running sums are f32. Four launches, no atomics,
// every sum in a fixed order, so a given card gives the same bits on every
// run (gradients feed the divergence trigger through the parameter plane).
//   1. delta: one warp a row, lanes over bf16 pairs of D, f32 sums, an xor
//      butterfly.
//   2. dk, dv: a block of P warp pairs owns 16 P keys of one (batch, query
//      head), a pair 16 (mma's M), and walks query tiles of 32 rows. With
//      the keys as rows it computes S^T = K Q^T and dP^T = V dO^T: K and V
//      rows are the A operand, the Q and dO tiles' rows the B operand, each
//      a 32-bit load of two neighbouring columns. P^T = exp2(S^T scale
//      log2(e) - lse log2(e)) with the masks and dS^T = P^T (dP^T - delta)
//      on the fragments; a pair of query n-tiles of the accumulator is one
//      k-step's A fragment as it stands (no shuffle). dO and Q are the B
//      operand of dV and dK with the queries as k: ldmatrix .trans reads
//      them from their row-major tiles, nothing is transposed in memory.
//      Q, dO, lse and delta arrive by a two-stage cp.async ring. The block
//      writes its query head's dk and dv as f32 partials to a (B, Sk, H,
//      DQK + DV) scratch.
//   3. dq: a block of P warp pairs owns 16 P query rows of one (batch,
//      head) and walks the 32-key tiles of the forward's key range on a
//      two-stage K / V ring, the last query tile first: S = Q K^T, dP = dO
//      V^T, dS = P (dP - delta), dQ += dS K (K by ldmatrix .trans); dq is
//      written in bf16 once.
//   4. sum: each kv head's G partials summed in head order in f32, dk
//      scaled, both written in bf16 once (G = 1 is the cast alone).
// The two warps of a pair split both widths, as in the f32 program: each
// computes the S product over its half of DQK and the dP product over its
// half of DV (a half is whole 16-column k-steps), the pair swaps the
// partials through shared memory, and each computes dK and dQ for its half
// of DQK's columns and dV for its half of DV's. Each tile's dV, dK and dQ
// products are summed from zero over the tile's two k-steps and then added
// to the running sums in f32. A pair skips a tile none of its pairs keeps
// and masks only a tile that crosses Sk, the causal diagonal or the
// window's edge. Every tile row is its width + 8 bf16 (16 bytes), so the
// 32-bit fragment loads (row g, column pair t) and ldmatrix's eight 16-byte
// rows each hit distinct banks.
// Budget (Plan): 6 pairs (12 warps, at most 168 registers a thread) at
// equal widths up to 128, 4 pairs (8 warps, 255) at (192, 128), whose dK
// accumulators take 48 registers a thread; one block an SM.
// Later speed work (ROADMAP Queue B): wgmma with TMA-fed tiles and a
// warp-specialized pipeline, as the forward has.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBT = 32;             // streamed rows a tile
constexpr int kStages = 2;          // the ring of streamed tiles
constexpr int kSwap = 2 * kBT * 16; // floats a warp's slot: its two partials
constexpr int kMaxPairs = 6;        // warp pairs a block at equal widths
constexpr int kNarrowPairs = 4;     // warp pairs a block at (192, 128)
constexpr size_t kMaxSmem = 232448; // bytes a block may opt in to
constexpr int kFlatThreads = 384;   // the delta and group-sum kernels' blocks
constexpr float kLog2e = 1.4426950408889634f;

// a block's shared memory with rows of ldq and ldv bf16 and `pairs` warp
// pairs: two resident bf16 tiles of 16 rows a pair; a ring of two streamed
// bf16 tiles; then f32: the ring's lse and delta rows, a slot a warp for
// its partial sums
constexpr size_t plan_bytes(int ldq, int ldv, int pairs) {
  return 2 * (16 * pairs * (ldq + ldv) + kStages * kBT * (ldq + ldv)) +
         4 * (kStages * 2 * kBT + 2 * pairs * kSwap);
}

template <int DQK, int DV>
struct Plan {
  static constexpr int LDQ = DQK + 8;  // bf16 a row of a q / k tile
  static constexpr int LDV = DV + 8;   // bf16 a row of a v / do tile
  static constexpr int kPairs = DQK + DV <= 256 ? kMaxPairs : kNarrowPairs;
  static constexpr int kThreads = 64 * kPairs;  // a pair's warps split widths
  static constexpr int kBR = 16 * kPairs;  // resident rows (keys or queries)
  // the f32 region: lse and delta of the ring, then the swap slots
  static constexpr int kHalfs = 16 * kPairs * (LDQ + LDV) +
                                kStages * kBT * (LDQ + LDV);
  static constexpr size_t kBytes = plan_bytes(LDQ, LDV, kPairs);
  static_assert(kBytes <= kMaxSmem, "a block's tiles exceed shared memory");
  static_assert(DQK % 32 == 0 && DV % 32 == 0,
                "each warp of a pair takes whole 16-column k-steps of both "
                "widths");
};

// 16 bytes from global to shared memory without registers; zeros when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<unsigned>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS x D bf16 of a (.., rows, heads, D) tensor (row stride `stride`
// values, from `src`, the head's first row) into shared memory with rows
// of D + 8 values, by THREADS threads; rows >= valid are zero-filled
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int valid,
                                          int tid) {
  constexpr int C8 = D / 8;
#pragma unroll 4
  for (int e = tid; e < ROWS * C8; e += THREADS) {
    const int r = e / C8, c = (e - r * C8) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 8) + c, ok ? src + r * stride + c : src, ok);
  }
}

// a row's lse in log2 units: +inf where the row keeps nothing, so its p is 0
__device__ __forceinline__ float lse2_of(float v) {
  return isinf(v) ? INFINITY : v * kLog2e;
}

// two neighbouring bf16 of shared memory as one register
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// (lo, hi) rounded to bf16, to nearest even, as one register
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// four 8 x 8 bf16 matrices, transposed: lanes 8i .. 8i + 7 give the rows of
// matrix i; register i holds (2t, g) and (2t + 1, g) of matrix i
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}
// d (16 x 8) += a (16 x 16, row) b (16 x 8, col): bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The m16n8k16 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4, each register two bf16, the lower
// column in the low half: A (16 x 16) holds (g, 2t | 2t + 1), (g + 8, 2t
// | 2t + 1), (g, 2t + 8 | 2t + 9), (g + 8, 2t + 8 | 2t + 9); B (16 x 8)
// holds (2t | 2t + 1, g), (2t + 8 | 2t + 9, g); the f32 accumulator holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), as m16n8k8's.

// the A fragment of a warp's 16 resident rows at k-step kk; `w` points at
// row g, column 2t
__device__ __forceinline__ void a_rows(const bf16* w, int ld, int kk,
                                       uint32_t (&a)[4]) {
  a[0] = ld32(w + 16 * kk);
  a[1] = ld32(w + 8 * ld + 16 * kk);
  a[2] = ld32(w + 16 * kk + 8);
  a[3] = ld32(w + 8 * ld + 16 * kk + 8);
}

// acc (16 x 8 NN) += c (16 x kBT, accumulator n-tiles, rounded to bf16) b
// (kBT x 8 NN of a row-major tile): n-tiles 2j and 2j + 1 of c are k-step
// j's A fragment; `b` is this lane's ldmatrix row, (lane & 7) + 8 ((lane
// >> 3) & 1) of the tile, column 8 (lane >> 4) of the warp's columns. Each
// n-tile's product over the tile's kBT / 16 k-steps is summed from zero by
// the tensor cores, then added to acc in f32 (the tensor cores' adds
// truncate, so a running sum over thousands of rows kept in their
// accumulator would drift; this way each truncates over one tile only).
template <int NN, int LD>
__device__ __forceinline__ void tile_product(float (&acc)[NN][4],
                                             const float (&c)[kBT / 8][4],
                                             const bf16* b) {
  static_assert(NN % 2 == 0, "ldmatrix .x4 reads two n-tiles");
  uint32_t a[kBT / 16][4];
#pragma unroll
  for (int j = 0; j < kBT / 16; ++j) {
    a[j][0] = pack(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
#pragma unroll
  for (int n = 0; n < NN; n += 2) {
    float x0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, x1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kBT / 16; ++j) {
      uint32_t r[4];
      ldsm_x4_trans(r, b + 16 * j * LD + 8 * n);
      mma(x0, a[j], r[0], r[1]);
      mma(x1, a[j], r[2], r[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += x0[e];
      acc[n + 1][e] += x1[e];
    }
  }
}

// The two warps of a pair share 16 rows and split D: each sums the S and
// dP products over its half of D, then the pair swaps partials through
// shared memory so that both hold the whole sums, half 0's plus half 1's
// (the same bits in both warps: f32 addition commutes).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}
__device__ __forceinline__ void pair_sum(float (&s)[kBT / 8][4],
                                         float (&d)[kBT / 8][4], float* mine,
                                         const float* other, int pair,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(4 * j + e) * 32 + lane] = s[j][e];
      mine[(kBT / 2 + 4 * j + e) * 32 + lane] = d[j][e];
    }
  pair_sync(pair);
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] += other[(4 * j + e) * 32 + lane];
      d[j][e] += other[(kBT / 2 + 4 * j + e) * 32 + lane];
    }
}

__device__ __forceinline__ bool keeps(int qpos, int kpos, int Sk, int causal,
                                      int window) {
  return kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// delta[b, h, i] = do[b, i, h] . o[b, i, h] over the D = DV columns: one
// warp a row, two columns a lane a step
__global__ void __launch_bounds__(kFlatThreads)
    attention_bwd_bf16_delta_kernel(const __nv_bfloat162* __restrict__ o,
                                    const __nv_bfloat162* __restrict__ dO,
                                    float* __restrict__ delta,
                                    long long rows, int Sq, int H, int D2) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kFlatThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat162* a = o + row * D2;
  const __nv_bfloat162* g = dO + row * D2;
  float acc = 0.0f;
  for (int d = lane; d < D2; d += 32) {
    const float2 x = __bfloat1622float2(a[d]), y = __bfloat1622float2(g[d]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    // row = (b Sq + i) H + h -> delta[(b H + h) Sq + i]
    const long long h = row % H, bi = row / H;
    const long long i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// dk, dv. A block owns keys [k0, k0 + kBR) of one (batch, query head) and
// writes its unscaled dk and its dv as f32 partials: pk (B, Sk, H, DQK),
// pv (B, Sk, H, DV).
template <int DQK, int DV>
__global__ void __launch_bounds__(Plan<DQK, DV>::kThreads, 1)
    attention_bwd_bf16_dkv_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ dO,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  float* __restrict__ pk,
                                  float* __restrict__ pv, int BH, int H,
                                  int Hkv, int Sq, int Sk, int causal,
                                  int window, float scale) {
  using P = Plan<DQK, DV>;
  constexpr int LDQ = P::LDQ, LDV = P::LDV, kBR = P::kBR;
  constexpr int kThreads = P::kThreads;
  constexpr int KQ = DQK / 32;  // a half's k-steps of S^T
  constexpr int KV = DV / 32;   // a half's k-steps of dP^T
  constexpr int KM = KQ > KV ? KQ : KV;
  constexpr int NQ = DQK / 16;  // a half's n-tiles of dK
  constexpr int NV = DV / 16;   // a half's n-tiles of dV
  constexpr int NJ = kBT / 8;   // query n-tiles of S^T
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kBR x LDQ
  bf16* sV = sK + kBR * LDQ;                     // kBR x LDV
  bf16* sQ = sV + kBR * LDV;                     // kStages x kBT x LDQ
  bf16* sdO = sQ + kStages * kBT * LDQ;          // kStages x kBT x LDV
  float* sL = reinterpret_cast<float*>(sK + P::kHalfs);  // kStages x kBT
  float* sDl = sL + kStages * kBT;               // kStages x kBT, delta
  float* sX = sDl + kStages * kBT;               // 2 kPairs x kSwap

  const int bh = static_cast<int>(blockIdx.x % BH);
  const int k0 = static_cast<int>(blockIdx.x / BH) * kBR;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * DQK;
  const int64_t o_stride = static_cast<int64_t>(H) * DV;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * DQK;
  const int64_t v_stride = static_cast<int64_t>(Hkv) * DV;
  const int64_t kvr = static_cast<int64_t>(b) * Sk * Hkv + hk;

  // the query rows that may keep a key of [k0, k0 + kBR)
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - off);
  if (window > 0) i_hi = min(Sq, k0 + kBR - 1 + window - off);
  const int t_lo = i_lo / kBT;
  const int n_t = i_hi > i_lo ? (i_hi + kBT - 1) / kBT - t_lo : 0;
  const int64_t qr = static_cast<int64_t>(b) * Sq * H + h;

  auto load_step = [&](int s, int stage) {
    const int q0 = (t_lo + s) * kBT;
    const int valid = min(kBT, Sq - q0);
    load_tile<kBT, DQK, kThreads>(sQ + stage * kBT * LDQ,
                                  q + qr * DQK + q0 * q_stride, q_stride,
                                  valid, tid);
    load_tile<kBT, DV, kThreads>(sdO + stage * kBT * LDV,
                                 dO + qr * DV + q0 * o_stride, o_stride,
                                 valid, tid);
    if (tid < kBT) {
      const int i = q0 + tid;
      const int64_t at = static_cast<int64_t>(bh) * Sq + i;
      sL[stage * kBT + tid] = i < Sq ? lse2_of(lse[at]) : INFINITY;
      sDl[stage * kBT + tid] = i < Sq ? delta[at] : 0.0f;
    }
  };
  const int kvalid = min(kBR, Sk - k0);
  load_tile<kBR, DQK, kThreads>(sK, k + kvr * DQK + k0 * k_stride, k_stride,
                                kvalid, tid);
  load_tile<kBR, DV, kThreads>(sV, v + kvr * DV + k0 * v_stride, v_stride,
                               kvalid, tid);
  if (n_t > 0) load_step(0, 0);
  cp_async_commit();

  // this warp's keys, kw + g and kw + g + 8, and columns [cq, cq + DQK / 2)
  // of the q / k tiles and [cv, cv + DV / 2) of the v / do tiles
  const int pair = warp >> 1;
  const int cq = (warp & 1) * (DQK / 2), cv = (warp & 1) * (DV / 2);
  const int kw = k0 + 16 * pair;
  const bf16* wk = sK + (16 * pair + g) * LDQ + cq + 2 * t;
  const bf16* wv = sV + (16 * pair + g) * LDV + cv + 2 * t;
  // this lane's ldmatrix row of a streamed tile
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  float* mine = sX + warp * kSwap;
  const float* other = sX + (warp ^ 1) * kSwap;
  const float sl2 = scale * kLog2e;   // scores in log2 units

  float acc_v[NV][4], acc_k[NQ][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = 0.0f;

  for (int s = 0; s < n_t; ++s) {
    cp_async_wait_all();
    // this step's copies have landed, and no warp still reads the stage
    // the next copies overwrite
    __syncthreads();
    if (s + 1 < n_t) load_step(s + 1, (s + 1) % kStages);
    cp_async_commit();

    const int stage = s % kStages;
    const int q0 = (t_lo + s) * kBT;
    const int pos_lo = q0 + off, pos_hi = pos_lo + kBT - 1;
    if (kw >= Sk || (causal && kw > pos_hi) ||
        (window > 0 && kw + 15 <= pos_lo - window))
      continue;  // no key of this pair is kept by a row of this tile
    const bf16* tQ = sQ + stage * kBT * LDQ;
    const bf16* tdO = sdO + stage * kBT * LDV;

    // S^T = K Q^T over this warp's half of DQK, dP^T = V dO^T over its
    // half of DV: keys as rows, the tile's queries as columns; then the
    // pair's sums
    float st[NJ][4], dt[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dt[j][e] = 0.0f;
    const bf16* bq = tQ + g * LDQ + cq + 2 * t;
    const bf16* bo = tdO + g * LDV + cv + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
      if (kk < KQ) {
        uint32_t a[4];
        a_rows(wk, LDQ, kk, a);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(st[j], a, ld32(bq + 8 * j * LDQ + 16 * kk),
              ld32(bq + 8 * j * LDQ + 16 * kk + 8));
      }
      if (kk < KV) {
        uint32_t a[4];
        a_rows(wv, LDV, kk, a);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(dt[j], a, ld32(bo + 8 * j * LDV + 16 * kk),
              ld32(bo + 8 * j * LDV + 16 * kk + 8));
      }
    }
    pair_sum(st, dt, mine, other, pair, lane);

    // P^T and dS^T on the fragments, in both warps of the pair: element e
    // of n-tile j is key kw + g + 8 (e / 2), query q0 + 8j + 2t + e % 2
    const bool edge = kw + 15 >= Sk || (causal && kw + 15 > pos_lo) ||
                      (window > 0 && kw <= pos_hi - window);
    const float* tl = sL + stage * kBT + 2 * t;
    const float* tdl = sDl + stage * kBT + 2 * t;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(tl + 8 * j);
      const float2 dl = *reinterpret_cast<const float2*>(tdl + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(st[j][e], sl2, -(e & 1 ? l.y : l.x)));
        if (edge && !keeps(pos_lo + 8 * j + 2 * t + (e & 1),
                           kw + g + 8 * (e >> 1), Sk, causal, window))
          p = 0.0f;
        st[j][e] = p;
        dt[j][e] = p * (dt[j][e] - (e & 1 ? dl.y : dl.x));
      }
    }

    // dV += P^T dO over DV's half, then dK += dS^T Q over DQK's: the
    // queries are the k order; P^T and dS^T rounded to bf16 there
    tile_product<NV, LDV>(acc_v, st, tdO + lrow * LDV + cv + lcol);
    tile_product<NQ, LDQ>(acc_k, dt, tQ + lrow * LDQ + cq + lcol);
  }
  cp_async_wait_all();

  const int64_t orow = static_cast<int64_t>(b) * Sk * H + h;
  const int64_t ok_stride = static_cast<int64_t>(H) * DQK;
  const int64_t ov_stride = static_cast<int64_t>(H) * DV;
  float* ok = pk + orow * DQK + cq + 2 * t;
  float* ov = pv + orow * DV + cv + 2 * t;
  const int j0 = kw + g, j1 = j0 + 8;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    if (j0 < Sk)
      *reinterpret_cast<float2*>(ov + j0 * ov_stride + 8 * n) =
          make_float2(acc_v[n][0], acc_v[n][1]);
    if (j1 < Sk)
      *reinterpret_cast<float2*>(ov + j1 * ov_stride + 8 * n) =
          make_float2(acc_v[n][2], acc_v[n][3]);
  }
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    if (j0 < Sk)
      *reinterpret_cast<float2*>(ok + j0 * ok_stride + 8 * n) =
          make_float2(acc_k[n][0], acc_k[n][1]);
    if (j1 < Sk)
      *reinterpret_cast<float2*>(ok + j1 * ok_stride + 8 * n) =
          make_float2(acc_k[n][2], acc_k[n][3]);
  }
}

// dq. A block owns query rows [q0, q0 + kBR) of one (batch, head).
template <int DQK, int DV>
__global__ void __launch_bounds__(Plan<DQK, DV>::kThreads, 1)
    attention_bwd_bf16_dq_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ dO,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 bf16* __restrict__ dq, int BH, int H,
                                 int Hkv, int Sq, int Sk, int causal,
                                 int window, float scale) {
  using P = Plan<DQK, DV>;
  constexpr int LDQ = P::LDQ, LDV = P::LDV, kBR = P::kBR;
  constexpr int kThreads = P::kThreads;
  constexpr int KQ = DQK / 32;  // a half's k-steps of S
  constexpr int KV = DV / 32;   // a half's k-steps of dP
  constexpr int KM = KQ > KV ? KQ : KV;
  constexpr int NQ = DQK / 16;  // a half's n-tiles of dQ
  constexpr int NJ = kBT / 8;   // key n-tiles of S
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBR x LDQ
  bf16* sdO = sQ + kBR * LDQ;                    // kBR x LDV
  bf16* sK = sdO + kBR * LDV;                    // kStages x kBT x LDQ
  bf16* sV = sK + kStages * kBT * LDQ;           // kStages x kBT x LDV
  // 2 kPairs x kSwap, past the (unused) lse and delta rows of the plan
  float* sX = reinterpret_cast<float*>(sQ + P::kHalfs) + kStages * 2 * kBT;

  const int n_qt = (Sq + kBR - 1) / kBR;
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kBR;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * DQK;
  const int64_t o_stride = static_cast<int64_t>(H) * DV;
  const int64_t k_stride = static_cast<int64_t>(Hkv) * DQK;
  const int64_t v_stride = static_cast<int64_t>(Hkv) * DV;
  const int64_t qr = static_cast<int64_t>(b) * Sq * H + h;
  const int64_t kvr = static_cast<int64_t>(b) * Sk * Hkv + hk;

  // the key tiles any row of this tile may keep, as the forward's
  const int q_last = min(q0 + kBR, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, off + q_last + 1);
  if (window > 0) k_lo = max(0, off + q0 - window + 1);
  const int t_lo = k_lo / kBT;
  const int n_t = k_hi > k_lo ? (k_hi + kBT - 1) / kBT - t_lo : 0;

  auto load_step = [&](int s, int stage) {
    const int k0 = (t_lo + s) * kBT;
    const int valid = min(kBT, Sk - k0);
    load_tile<kBT, DQK, kThreads>(sK + stage * kBT * LDQ,
                                  k + kvr * DQK + k0 * k_stride, k_stride,
                                  valid, tid);
    load_tile<kBT, DV, kThreads>(sV + stage * kBT * LDV,
                                 v + kvr * DV + k0 * v_stride, v_stride,
                                 valid, tid);
  };
  const int qvalid = min(kBR, Sq - q0);
  load_tile<kBR, DQK, kThreads>(sQ, q + qr * DQK + q0 * q_stride, q_stride,
                                qvalid, tid);
  load_tile<kBR, DV, kThreads>(sdO, dO + qr * DV + q0 * o_stride, o_stride,
                               qvalid, tid);
  if (n_t > 0) load_step(0, 0);
  cp_async_commit();

  // this warp's rows, r0 + g and r0 + g + 8, and columns [cq, cq + DQK / 2)
  // of the q / k tiles and [cv, cv + DV / 2) of the v / do tiles
  const int pair = warp >> 1;
  const int cq = (warp & 1) * (DQK / 2), cv = (warp & 1) * (DV / 2);
  const int r0 = q0 + 16 * pair;
  const int pos0 = off + r0;
  const int qp0 = pos0 + g, qp1 = qp0 + 8;
  const float* lr = lse + static_cast<int64_t>(bh) * Sq;
  const float* dr = delta + static_cast<int64_t>(bh) * Sq;
  const float l0 = r0 + g < Sq ? lse2_of(lr[r0 + g]) : INFINITY;
  const float l1 = r0 + g + 8 < Sq ? lse2_of(lr[r0 + g + 8]) : INFINITY;
  const float dl0 = r0 + g < Sq ? dr[r0 + g] : 0.0f;
  const float dl1 = r0 + g + 8 < Sq ? dr[r0 + g + 8] : 0.0f;
  const bf16* wq = sQ + (16 * pair + g) * LDQ + cq + 2 * t;
  const bf16* wo = sdO + (16 * pair + g) * LDV + cv + 2 * t;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  float* mine = sX + warp * kSwap;
  const float* other = sX + (warp ^ 1) * kSwap;
  const float sl2 = scale * kLog2e;

  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int s = 0; s < n_t; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n_t) load_step(s + 1, (s + 1) % kStages);
    cp_async_commit();

    const int k0 = (t_lo + s) * kBT;
    if (r0 >= Sq || (causal && k0 > pos0 + 15) ||
        (window > 0 && k0 + kBT - 1 <= pos0 - window))
      continue;  // no row of this pair keeps a key of this tile
    const bf16* tK = sK + (s % kStages) * kBT * LDQ;
    const bf16* tV = sV + (s % kStages) * kBT * LDV;

    // S = Q K^T over this warp's half of DQK, dP = dO V^T over its half of
    // DV, then the pair's sums
    float sc[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    const bf16* bk = tK + g * LDQ + cq + 2 * t;
    const bf16* bv = tV + g * LDV + cv + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
      if (kk < KQ) {
        uint32_t a[4];
        a_rows(wq, LDQ, kk, a);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(sc[j], a, ld32(bk + 8 * j * LDQ + 16 * kk),
              ld32(bk + 8 * j * LDQ + 16 * kk + 8));
      }
      if (kk < KV) {
        uint32_t a[4];
        a_rows(wo, LDV, kk, a);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma(dp[j], a, ld32(bv + 8 * j * LDV + 16 * kk),
              ld32(bv + 8 * j * LDV + 16 * kk + 8));
      }
    }
    pair_sum(sc, dp, mine, other, pair, lane);

    // P and dS: element e of n-tile j is row r0 + g + 8 (e / 2), key
    // k0 + 8j + 2t + e % 2
    const bool edge = k0 + kBT > Sk || (causal && k0 + kBT - 1 > pos0) ||
                      (window > 0 && k0 <= pos0 + 15 - window);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[j][e], sl2, -(e < 2 ? l0 : l1)));
        if (edge && !keeps(e < 2 ? qp0 : qp1, k0 + 8 * j + 2 * t + (e & 1),
                           Sk, causal, window))
          p = 0.0f;
        sc[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }

    // dQ += dS K over DQK's half: the keys are the k order; dS rounded to
    // bf16 there
    tile_product<NQ, LDQ>(acc, sc, tK + lrow * LDQ + cq + lcol);
  }
  cp_async_wait_all();

  const int i0 = r0 + g, i1 = i0 + 8;
  bf16* ob = dq + qr * DQK + cq + 2 * t;
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    if (i0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + i0 * q_stride + 8 * n) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (i1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + i1 * q_stride + 8 * n) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// row r's G partials of a (rows G, D4) float4 array, summed in head order:
// partial hh of row r, column c is at (r G + hh) D4 + c
__device__ __forceinline__ float4 group_sum(const float4* __restrict__ p,
                                            long long r, long long c, int G,
                                            int D4) {
  const long long at = r * G * D4 + c;
  float4 a = p[at];
  for (int hh = 1; hh < G; ++hh) {
    const float4 x = p[at + hh * D4];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  return a;
}

// four values rounded to bf16 once, stored as 8 bytes
__device__ __forceinline__ void store4(bf16* p, float4 a, float s) {
  const uint2 w = make_uint2(pack(a.x * s, a.y * s), pack(a.z * s, a.w * s));
  *reinterpret_cast<uint2*>(p) = w;
}

// dk (B, Sk, Hkv, DQK) and dv (B, Sk, Hkv, DV) in bf16 from the query
// heads' f32 partials (B, Sk, H, DQK) and (B, Sk, H, DV): each kv head's G
// partials summed in head order, dk times scale; 4 values a thread, dk's
// nk4 groups of four first, then dv's
__global__ void __launch_bounds__(kFlatThreads)
    attention_bwd_bf16_sum_kernel(const float4* __restrict__ pk,
                                  const float4* __restrict__ pv,
                                  bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, long long nk4,
                                  long long n4, int G, int DK4, int DV4,
                                  float scale) {
  const long long e = static_cast<long long>(blockIdx.x) * kFlatThreads +
                      threadIdx.x;
  if (e >= n4) return;
  // e = ((b Sk + j) Hkv + hk) D4 + c reads ((b Sk + j) H + hk G + hh) D4 + c
  if (e < nk4) {
    const long long r = e / DK4;
    store4(dk + 4 * e, group_sum(pk, r, e - r * DK4, G, DK4), scale);
  } else {
    const long long f = e - nk4, r = f / DV4;
    store4(dv + 4 * f, group_sum(pv, r, f - r * DV4, G, DV4), 1.0f);
  }
}

template <int DQK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dO, bf16* dq, bf16* dk, bf16* dv,
           float* delta, float* part, int B, int H, int Hkv, int Sq, int Sk,
           int causal, int window, float scale, cudaStream_t s) {
  using P = Plan<DQK, DV>;
  constexpr size_t smem = P::kBytes;
  const int G = H / Hkv;
  if (part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long d_blocks = (rows + kFlatThreads / 32 - 1) / (kFlatThreads / 32);
  const long long kv_blocks =
      static_cast<long long>(B) * H * ((Sk + P::kBR - 1) / P::kBR);
  const long long q_blocks =
      static_cast<long long>(B) * H * ((Sq + P::kBR - 1) / P::kBR);
  const long long kv_rows = static_cast<long long>(B) * Sk * Hkv;
  const long long nk4 = kv_rows * (DQK / 4), n4 = nk4 + kv_rows * (DV / 4);
  const long long s_blocks = (n4 + kFlatThreads - 1) / kFlatThreads;
  if (d_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL || s_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_bf16_dkv_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_bf16_dq_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_delta_kernel<<<static_cast<unsigned>(d_blocks),
                                    kFlatThreads, 0, s>>>(
      reinterpret_cast<const __nv_bfloat162*>(o),
      reinterpret_cast<const __nv_bfloat162*>(dO), delta, rows, Sq, H,
      DV / 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pk = part;
  float* pv = part + static_cast<size_t>(B) * Sk * H * DQK;
  attention_bwd_bf16_dkv_kernel<DQK, DV>
      <<<static_cast<unsigned>(kv_blocks), P::kThreads, smem, s>>>(
          q, k, v, dO, lse, delta, pk, pv, B * H, H, Hkv, Sq, Sk, causal,
          window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_dq_kernel<DQK, DV>
      <<<static_cast<unsigned>(q_blocks), P::kThreads, smem, s>>>(
          q, k, v, dO, lse, delta, dq, B * H, H, Hkv, Sq, Sk, causal, window,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_sum_kernel<<<static_cast<unsigned>(s_blocks),
                                  kFlatThreads, 0, s>>>(
      reinterpret_cast<const float4*>(pk), reinterpret_cast<const float4*>(pv),
      dk, dv, nk4, n4, G, DQK / 4, DV / 4, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, o, dO, dq, dk and dv; f32 lse and delta; (d, dv) the
// (query/key, value) widths, one of (32, 32), (64, 64), (128, 128) and
// (192, 128). q and dq are (B, Sq, H, d); k and dk (B, Sk, Hkv, d); o and
// dO (B, Sq, H, dv); v and dv (B, Sk, Hkv, dv); lse and delta (B, H, Sq),
// delta scratch the launcher fills; `part` is f32 scratch of B Sk H (d +
// dv) values for the query heads' dk partials, then their dv partials,
// which the fourth launch sums over each group. All contiguous and 16-byte
// aligned, H % Hkv == 0. Four launches on `stream`; returns the CUDA error
// code of the first that fails (0 = cudaSuccess).
extern "C" int repro_attention_bwd_bf16(int d, int dv, const void* q,
                                        const void* k, const void* v,
                                        const void* o, const void* lse,
                                        const void* dO, void* dq, void* dk,
                                        void* dV, void* delta, void* part,
                                        int B, int H, int Hkv, int Sq, int Sk,
                                        int causal, int window, float scale,
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
        static_cast<bf16*>(dV), static_cast<float*>(delta),                  \
        static_cast<float*>(part), B, H, Hkv, Sq, Sk, causal, window, scale, \
        s);
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
