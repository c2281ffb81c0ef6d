// The gradient of masked softmax attention with grouped KV heads, in f32 on
// Hopper's tensor cores in split TF32 (sm_90a): dq, dk and dv from q, k, v,
// the forward's output o and per-row log-sum-exp, and the output's
// gradient do.
//
//   s[i, j] = scale q[i] . k[j],  p[i, j] = mask(i, j) ? exp(s - lse[i]) : 0
//   dv[j]   = sum_i p[i, j] do[i]
//   dp[i,j] = do[i] . v[j],  ds[i, j] = p[i, j] (dp[i, j] - delta[i]),
//   delta[i] = do[i] . o[i]
//   dq[i]   = scale sum_j ds[i, j] k[j],  dk[j] = scale sum_i ds[i, j] q[i]
//
// q, dq (B, Sq, H, DQK); k, dk (B, Sk, Hkv, DQK); o, do (B, Sq, H, DV); v,
// dv (B, Sk, Hkv, DV); lse (B, H, Sq), written by the f32 forward
// (attention.cu) in natural-log units, -inf for a row that keeps no key
// (whose output and gradient are 0). The width pairs (DQK, DV) are the f32
// forward's: equal widths of 32, 64 or 128, and MLA's wider queries and
// keys, (192, 128) at deepseek-v2's width (128 + 64 rope by 128) and (48,
// 32) at its smoke config's. S, dK and dQ are products over or into DQK
// columns; dP and dV over or into DV; delta sums over DV. The masks are the
// forward's:
// query row i sits at position i + Sk - Sq; key j is kept when j < Sk,
// j <= qpos if causal, and j > qpos - window if window > 0. The dk and dv
// of kv head hk sum over its G = H / Hkv query heads.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel.
// Its training path differentiates jnp attention (src/repro/models/); on
// the card the port's forward is a hand-written kernel (attention.cu), so
// its gradient is one too.
//
// Bound: the arithmetic. The gradient needs 5 products per kept query-key
// pair and query head, 2 (3 DQK + 2 DV) flops (s = q k^T again and dk +=
// ds^T q, dq += ds k over DQK; dp = do v^T, dv += p^T do over DV), 2.5
// times the forward's at equal widths (analysis/roofline.py counts these). The tensor cores take f32 only as
// TF32, and one TF32 product misses the f32 tolerance (ROADMAP "One
// rounding misses the tolerance"; tests/test_torch_backward_tiles.py shows
// it), so every product is split TF32 as in attention.cu: v = hi + lo,
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, three TF32 products a product,
// over the TF32 rate (495 TFLOP/s). This design, two passes and no
// atomics, computes s and dp in both passes: 2 (5 DQK + 4 DV) flops, 7/5
// of that bound at equal widths.
//
// Design: every product is mma.sync.m16n8k8 TF32 on the fragment
// conventions of attention.cu; three or four launches; no atomics and every
// sum in a fixed order, so a given card gives the same bits on every run
// (gradients feed the divergence trigger through the parameter plane).
//   1. delta: one warp a row, lanes over D, an xor butterfly.
//   2. dk, dv: a block of P warp pairs owns 16 P keys of one (batch, kv
//      head), a pair 16 (mma's M), and walks query tiles of 32 rows. With
//      the keys as rows it computes S^T = K Q^T and dP^T = V dO^T: K and V
//      are the A operand, from the block's resident tiles; the Q and dO
//      tiles are the B operand, read by rows as the forward reads K. Then,
//      on the accumulator fragments, P^T = exp2(S^T scale log2(e) - lse
//      log2(e)) with the masks, and dS^T = P^T (dP^T - delta). dV += P^T
//      dO and dK += dS^T Q take the accumulators as the A operand with the
//      queries in the k order (0, 2, 4, 6 | 1, 3, 5, 7), as the forward's
//      P V does: no shuffle, nothing transposed in memory. Q, dO, lse and
//      delta arrive by a two-stage ring (cp.async for the tiles). A block
//      takes one query head; where G > 1 it writes that head's dk and dv
//      partials to a (B, Sk, H, D) scratch, and 4. a fourth launch sums
//      each kv head's G partials in head order and scales dk. Blocks run
//      (batch, head) fastest and the first key tiles (the longest under a
//      causal mask) first.
//   3. dq: a block of P warp pairs owns 16 P query rows of one (batch,
//      head), a pair 16, and walks the 32-key tiles of the forward's key range on
//      a two-stage K / V ring, the last query tile first: the forward's
//      loop with S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
// The two warps of a pair split both widths: each computes the S product
// over its half of DQK and the dP product over its half of DV (96 / 64 at
// (192, 128), 24 / 16 at (48, 32)), the pair swaps the partials through
// shared memory (a named barrier of 64 threads), and each computes dK and
// dQ for its half of DQK's columns and dV for its half of DV's. The dV,
// dK and dQ products of a tile are summed from zero, one independent sum
// an 8-column n-tile, and then added to the running sums in f32
// (tile_product: the tensor cores' accumulation truncates). A pair skips
// a tile none of its pairs keeps and masks only a tile that crosses Sk,
// the causal diagonal or the window's edge. Every tile row is its width +
// 4 floats, so every fragment load, by rows (A and the S products' B: row
// g, column t) or by columns (the dV, dK and dQ products' B: rows 2t and
// 2t + 1, column g), hits 32 banks with one 4-byte load a lane.
// Budget (Plan): one block an SM, of 6 pairs where their tiles fit in the
// 232,448 bytes a block may have (the 16 P resident rows of two tiles, a
// two-stage ring of two 32-row tiles, a 4 KB swap slot a warp), else of 4.
// At D = 128, 6 pairs (12 warps), 218,624 bytes and at most 168 registers
// a thread (a dk / dv warp's dK and dV for 16 keys x 64 columns are 64).
// At (192, 128) 6 pairs would take 259,584 bytes; 5 fit (230,400) but
// keep the cap of 168 registers and spill (dk / dv 120 bytes, dK 48 and
// dV 32 accumulators a warp; dq 24); 4 (8 warps, 64 rows, 201,216 bytes)
// take 253 and 186 registers and spill none. At deepseek-v2's (1, 4096,
// 128, 192/128) causal on an H100 (700 W), 4 take 51.85 ms, 5 57.48
// (benchmarks/torch_attention_bwd_pairs.py, PERF.md §6, PR 28).
// Tried on an H100 at llama3-8b's (1, 4096, 32/8, 128) (PERF.md, PR 25):
// 8 warps of 16 rows x the whole D (128 accumulator registers for dK and
// dV, 243-255 registers, 203 KB) were faster with the running sums
// kept in the tensor cores' accumulators, but their truncation left dk
// and dv an order of magnitude further off the plain version, and as fast
// as the pairs with the tile sums added in f32, but slower at the
// fleet's (16, 128, 12/4, 128). A block walking its kv head's G query
// heads (the CUDA-core kernel's way, no scratch) is slower at both shapes.
// Unrolling the pair's S^T loop by 2 or 4, splitting it into an S^T and a
// dP^T loop, tile sums over two k-steps, and a tile product that chains
// each column n-tile's four k-steps are no faster or slower. The dk / dv
// form keeps 16 bytes of spill stores at D = 128 (every form tried that
// has none is slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 32;             // streamed rows a tile
constexpr int kStages = 2;          // the ring of streamed tiles
constexpr int kSwap = 2 * kBT * 16; // floats a warp's slot: its two partials
constexpr int kMaxPairs = 6;        // warp pairs a block at most
// warp pairs a block where kMaxPairs' tiles do not fit; the define lets
// benchmarks/torch_attention_bwd_pairs.py build 5 beside it
#ifndef REPRO_BWD_NARROW_PAIRS
#define REPRO_BWD_NARROW_PAIRS 4
#endif
constexpr int kNarrowPairs = REPRO_BWD_NARROW_PAIRS;
constexpr size_t kMaxSmem = 232448; // bytes a block may opt in to
constexpr int kFlatThreads = 384;   // the delta and group-sum kernels' blocks
constexpr float kLog2e = 1.4426950408889634f;

// a block's shared memory with rows of ldq and ldv floats and `pairs` warp
// pairs: two resident tiles of 16 rows a pair; a ring of two streamed
// tiles (+ lse, delta rows); a slot a warp for its partial sums
constexpr size_t plan_bytes(int ldq, int ldv, int pairs) {
  return sizeof(float) *
         (16 * pairs * (ldq + ldv) + kStages * (kBT * (ldq + ldv) + 2 * kBT) +
          2 * pairs * kSwap);
}

template <int DQK, int DV>
struct Plan {
  static constexpr int LDQ = DQK + 4;  // floats a row of a q / k tile
  static constexpr int LDV = DV + 4;   // floats a row of a v / do tile
  // 6 pairs where their tiles fit, else 4: 5 buy no registers over 6
  // (10 warps put 3 on some of the SM's four 16K-register partitions, 168
  // registers a thread, as 12 do), where 4 get 255
  static constexpr int kPairs =
      plan_bytes(LDQ, LDV, kMaxPairs) <= kMaxSmem ? kMaxPairs : kNarrowPairs;
  static constexpr int kThreads = 64 * kPairs;  // a pair's warps split widths
  static constexpr int kBR = 16 * kPairs;  // resident rows (keys or queries)
  static constexpr size_t kBytes = plan_bytes(LDQ, LDV, kPairs);
  static_assert(kBytes <= kMaxSmem, "a block's tiles exceed shared memory");
  static_assert(DQK % 16 == 0 && DV % 16 == 0,
                "each warp of a pair takes whole k-steps of both widths");
};

// 16 bytes from global to shared memory without registers; zeros when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// ROWS x D floats of a (.., rows, heads, D) tensor (row stride `stride`
// floats, from `src`, the head's first row) into shared memory with rows
// of D + 4 floats, by THREADS threads; rows >= valid are zero-filled
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int valid,
                                          int tid) {
  constexpr int C4 = D / 4;
#pragma unroll 4
  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e - r * C4) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 4) + c, ok ? src + r * stride + c : src, ok);
  }
}

// a row's lse in log2 units: +inf where the row keeps nothing, so its p is 0
__device__ __forceinline__ float lse2_of(float v) {
  return isinf(v) ? INFINITY : v * kLog2e;
}

// v = hi + lo: hi is v rounded to TF32, to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding, by two integer operations); lo = v - hi is
// exact in f32 and goes to the tensor cores unrounded, which read its TF32
// part (what they drop is below 2^-21 |v|)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), one TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in split TF32, the small terms first; b = (b0, b1) unsplit
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}
// The m16n8k8 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8"), with
// g = lane / 4 and t = lane % 4: A (16 x 8) holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (8 x 8) holds (t, g), (t + 4, g); the
// accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// the A fragment of a warp's 16 resident rows at k-step kk, split; `w`
// points at row g, column t
__device__ __forceinline__ void a_rows(const float* w, int ld, int kk,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(w[8 * kk], h[0], l[0]);
  split(w[8 * ld + 8 * kk], h[1], l[1]);
  split(w[8 * kk + 4], h[2], l[2]);
  split(w[8 * ld + 8 * kk + 4], h[3], l[3]);
}
// an accumulator n-tile as the A fragment of a k-step, its columns in the
// k order (0, 2, 4, 6 | 1, 3, 5, 7), split
__device__ __forceinline__ void a_acc(const float (&c)[4], uint32_t (&h)[4],
                                      uint32_t (&l)[4]) {
  split(c[0], h[0], l[0]);
  split(c[2], h[1], l[1]);
  split(c[1], h[2], l[2]);
  split(c[3], h[3], l[3]);
}

// acc (16 x 8 NN) += c (16 x kBT, accumulator n-tiles) b (kBT x 8 NN rows
// of a tile, `b` at row 2t, column g): the kBT / 8 k-steps' split products
// summed from zero by the tensor cores, NN independent sums, then added to
// acc in f32. The tensor cores add into their accumulator truncating, not
// rounding, so a sum over S rows kept in one accumulator can drift by up to
// 3 (S / 8) 2^-23 of itself (2e-4 at S = 4,096); this way each truncates
// over one tile only.
template <int NN, int LD>
__device__ __forceinline__ void tile_product(float (&acc)[NN][4],
                                             const float (&c)[kBT / 8][4],
                                             const float* b) {
  float x[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) {
    uint32_t ch[4], cl[4];
    a_acc(c[j], ch, cl);
#pragma unroll
    for (int n = 0; n < NN; ++n)
      mma3(x[n], ch, cl, b[8 * j * LD + 8 * n], b[(8 * j + 1) * LD + 8 * n]);
  }
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += x[n][e];
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
// warp a row
__global__ void __launch_bounds__(kFlatThreads)
    attention_bwd_delta_kernel(const float* __restrict__ o,
                               const float* __restrict__ dO,
                               float* __restrict__ delta, long long rows,
                               int Sq, int H, int D) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kFlatThreads / 32) + (threadIdx.x >> 5);
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

// dk, dv. A block owns keys [k0, k0 + kBR) of one (batch, query head) and
// writes them to dk_out (B, Sk, H, DQK) and dv_out (B, Sk, H, DV), dk
// times dk_scale: dk and dv themselves where H = Hkv, else the head's
// partials.
template <int DQK, int DV>
__global__ void __launch_bounds__(Plan<DQK, DV>::kThreads, 1)
    attention_bwd_dkv_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk_out,
                             float* __restrict__ dv_out, int BH, int H,
                             int Hkv, int Sq, int Sk, int causal,
                             int window, float scale, float dk_scale) {
  using P = Plan<DQK, DV>;
  constexpr int LDQ = P::LDQ, LDV = P::LDV, kBR = P::kBR;
  constexpr int kThreads = P::kThreads;
  constexpr int KQ = DQK / 16;  // a half's k-steps of S^T, n-tiles of dK
  constexpr int KV = DV / 16;   // a half's k-steps of dP^T, n-tiles of dV
  constexpr int KM = KQ > KV ? KQ : KV;
  constexpr int NJ = kBT / 8;   // query n-tiles of S^T = k-steps of dV
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                          // kBR x LDQ
  float* sV = sK + kBR * LDQ;                // kBR x LDV
  float* sQ = sV + kBR * LDV;                // kStages x kBT x LDQ
  float* sdO = sQ + kStages * kBT * LDQ;     // kStages x kBT x LDV
  float* sL = sdO + kStages * kBT * LDV;     // kStages x kBT, lse2
  float* sDl = sL + kStages * kBT;           // kStages x kBT, delta
  float* sX = sDl + kStages * kBT;           // 2 kPairs x kSwap

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
  const float* wk = sK + (16 * pair + g) * LDQ + cq + t;
  const float* wv = sV + (16 * pair + g) * LDV + cv + t;
  float* mine = sX + warp * kSwap;
  const float* other = sX + (warp ^ 1) * kSwap;
  const float sl2 = scale * kLog2e;   // scores in log2 units

  float acc_v[KV][4], acc_k[KQ][4];
#pragma unroll
  for (int n = 0; n < KV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < KQ; ++n)
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
    const float* tQ = sQ + stage * kBT * LDQ;
    const float* tdO = sdO + stage * kBT * LDV;

    // S^T = K Q^T over this warp's half of DQK, dP^T = V dO^T over its
    // half of DV: keys as rows, the tile's queries as columns; then the
    // pair's sums
    float st[NJ][4], dt[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dt[j][e] = 0.0f;
    const float* bq = tQ + g * LDQ + cq + t;
    const float* bo = tdO + g * LDV + cv + t;
#pragma unroll
    for (int kk = 0; kk < KM; ++kk) {
      if (kk < KQ) {
        uint32_t kh[4], kl[4];
        a_rows(wk, LDQ, kk, kh, kl);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma3(st[j], kh, kl, bq[8 * j * LDQ + 8 * kk],
               bq[8 * j * LDQ + 8 * kk + 4]);
      }
      if (kk < KV) {
        uint32_t vh[4], vl[4];
        a_rows(wv, LDV, kk, vh, vl);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma3(dt[j], vh, vl, bo[8 * j * LDV + 8 * kk],
               bo[8 * j * LDV + 8 * kk + 4]);
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

    // dV += P^T dO over DV's half, then dK += dS^T Q over DQK's: query
    // n-tile j of S^T is k-step j; each tile's product is summed from zero
    // and added in f32
    tile_product<KV, LDV>(acc_v, st, tdO + 2 * t * LDV + cv + g);
    tile_product<KQ, LDQ>(acc_k, dt, tQ + 2 * t * LDQ + cq + g);
  }
  cp_async_wait_all();

  const int64_t orow = static_cast<int64_t>(b) * Sk * H + h;
  const int64_t ok_stride = static_cast<int64_t>(H) * DQK;
  const int64_t ov_stride = static_cast<int64_t>(H) * DV;
  float* ok = dk_out + orow * DQK + cq + 2 * t;
  float* ov = dv_out + orow * DV + cv + 2 * t;
  const int j0 = kw + g, j1 = j0 + 8;
#pragma unroll
  for (int n = 0; n < KV; ++n) {
    if (j0 < Sk)
      *reinterpret_cast<float2*>(ov + j0 * ov_stride + 8 * n) =
          make_float2(acc_v[n][0], acc_v[n][1]);
    if (j1 < Sk)
      *reinterpret_cast<float2*>(ov + j1 * ov_stride + 8 * n) =
          make_float2(acc_v[n][2], acc_v[n][3]);
  }
#pragma unroll
  for (int n = 0; n < KQ; ++n) {
    if (j0 < Sk)
      *reinterpret_cast<float2*>(ok + j0 * ok_stride + 8 * n) =
          make_float2(acc_k[n][0] * dk_scale, acc_k[n][1] * dk_scale);
    if (j1 < Sk)
      *reinterpret_cast<float2*>(ok + j1 * ok_stride + 8 * n) =
          make_float2(acc_k[n][2] * dk_scale, acc_k[n][3] * dk_scale);
  }
}

// dq. A block owns query rows [q0, q0 + kBR) of one (batch, head).
template <int DQK, int DV>
__global__ void __launch_bounds__(Plan<DQK, DV>::kThreads, 1)
    attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int BH, int H, int Hkv,
                            int Sq, int Sk, int causal, int window,
                            float scale) {
  using P = Plan<DQK, DV>;
  constexpr int LDQ = P::LDQ, LDV = P::LDV, kBR = P::kBR;
  constexpr int kThreads = P::kThreads;
  constexpr int KQ = DQK / 16;  // a half's k-steps of S, n-tiles of dQ
  constexpr int KV = DV / 16;   // a half's k-steps of dP
  constexpr int KM = KQ > KV ? KQ : KV;
  constexpr int NJ = kBT / 8;   // key n-tiles of S = k-steps of dQ
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                          // kBR x LDQ
  float* sdO = sQ + kBR * LDQ;               // kBR x LDV
  float* sK = sdO + kBR * LDV;               // kStages x kBT x LDQ
  float* sV = sK + kStages * kBT * LDQ;      // kStages x kBT x LDV
  float* sX = sV + kStages * kBT * LDV + kStages * 2 * kBT;  // 2 kPairs x kSwap

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
  const float* wq = sQ + (16 * pair + g) * LDQ + cq + t;
  const float* wo = sdO + (16 * pair + g) * LDV + cv + t;
  float* mine = sX + warp * kSwap;
  const float* other = sX + (warp ^ 1) * kSwap;
  const float sl2 = scale * kLog2e;

  float acc[KQ][4];
#pragma unroll
  for (int n = 0; n < KQ; ++n)
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
    const float* tK = sK + (s % kStages) * kBT * LDQ;
    const float* tV = sV + (s % kStages) * kBT * LDV;

    // S = Q K^T over this warp's half of DQK, dP = dO V^T over its half of
    // DV, then the pair's sums
    float sc[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    const float* bk = tK + g * LDQ + cq + t;
    const float* bv = tV + g * LDV + cv + t;
#pragma unroll 4   // whole, it spills 12 bytes at D = 128
    for (int kk = 0; kk < KM; ++kk) {
      if (kk < KQ) {
        uint32_t qh_[4], ql[4];
        a_rows(wq, LDQ, kk, qh_, ql);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma3(sc[j], qh_, ql, bk[8 * j * LDQ + 8 * kk],
               bk[8 * j * LDQ + 8 * kk + 4]);
      }
      if (kk < KV) {
        uint32_t oh[4], ol[4];
        a_rows(wo, LDV, kk, oh, ol);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma3(dp[j], oh, ol, bv[8 * j * LDV + 8 * kk],
               bv[8 * j * LDV + 8 * kk + 4]);
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

    // dQ += dS K over DQK's half: key n-tile j of dS is k-step j
    tile_product<KQ, LDQ>(acc, sc, tK + 2 * t * LDQ + cq + g);
  }
  cp_async_wait_all();

  const int i0 = r0 + g, i1 = i0 + 8;
  float* ob = dq + qr * DQK + cq + 2 * t;
#pragma unroll
  for (int n = 0; n < KQ; ++n) {
    if (i0 < Sq)
      *reinterpret_cast<float2*>(ob + i0 * q_stride + 8 * n) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (i1 < Sq)
      *reinterpret_cast<float2*>(ob + i1 * q_stride + 8 * n) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
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

// dk (B, Sk, Hkv, DQK) and dv (B, Sk, Hkv, DV) from the query heads'
// partials (B, Sk, H, DQK) and (B, Sk, H, DV): each kv head's G partials
// summed in head order, dk times scale; 16 bytes a thread, dk's nk4 float4s
// first, then dv's
__global__ void __launch_bounds__(kFlatThreads)
    attention_bwd_sum_kernel(const float4* __restrict__ pk,
                             const float4* __restrict__ pv,
                             float4* __restrict__ dk,
                             float4* __restrict__ dv, long long nk4,
                             long long n4, int G, int DK4, int DV4,
                             float scale) {
  const long long e = static_cast<long long>(blockIdx.x) * kFlatThreads +
                      threadIdx.x;
  if (e >= n4) return;
  // e = ((b Sk + j) Hkv + hk) D4 + c reads ((b Sk + j) H + hk G + hh) D4 + c
  if (e < nk4) {
    const long long r = e / DK4;
    const float4 a = group_sum(pk, r, e - r * DK4, G, DK4);
    dk[e] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
  } else {
    const long long f = e - nk4, r = f / DV4;
    dv[f] = group_sum(pv, r, f - r * DV4, G, DV4);
  }
}

template <int DQK, int DV>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dO, float* dq, float* dk, float* dv,
           float* delta, float* part, int B, int H, int Hkv, int Sq, int Sk,
           int causal, int window, float scale, cudaStream_t s) {
  using P = Plan<DQK, DV>;
  constexpr size_t smem = P::kBytes;
  const int G = H / Hkv;
  if (G > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
      attention_bwd_dkv_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_delta_kernel<<<static_cast<unsigned>(d_blocks), kFlatThreads,
                               0, s>>>(o, dO, delta, rows, Sq, H, DV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pk = G > 1 ? part : dk;
  float* pv = G > 1 ? part + static_cast<size_t>(B) * Sk * H * DQK : dv;
  attention_bwd_dkv_kernel<DQK, DV>
      <<<static_cast<unsigned>(kv_blocks), P::kThreads, smem, s>>>(
          q, k, v, dO, lse, delta, pk, pv, B * H, H, Hkv, Sq, Sk, causal,
          window, scale, G > 1 ? 1.0f : scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<DQK, DV>
      <<<static_cast<unsigned>(q_blocks), P::kThreads, smem, s>>>(
          q, k, v, dO, lse, delta, dq, B * H, H, Hkv, Sq, Sk, causal, window,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  attention_bwd_sum_kernel<<<static_cast<unsigned>(s_blocks), kFlatThreads, 0,
                             s>>>(
      reinterpret_cast<const float4*>(pk), reinterpret_cast<const float4*>(pv),
      reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), nk4, n4,
      G, DQK / 4, DV / 4, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 throughout; (d, dv) the (query/key, value) widths, one of (32,
// 32), (64, 64), (128, 128), (192, 128) and (48, 32). q and dq are (B, Sq,
// H, d); k and dk (B, Sk, Hkv, d); o and dO (B, Sq, H, dv); v and dv (B,
// Sk, Hkv, dv); lse and delta (B, H, Sq), delta scratch the launcher
// fills; where H > Hkv, `part` is scratch of B Sk H (d + dv) floats for
// the query heads' dk partials, then their dv partials, which a fourth
// launch sums over each group (null where H = Hkv). All contiguous and
// 16-byte aligned, H % Hkv == 0. Three or four launches on `stream`;
// returns the CUDA error code of the first that fails (0 = cudaSuccess).
extern "C" int repro_attention_bwd(int d, int dv, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dO, void* dq, void* dk,
                                   void* dV, void* delta, void* part, int B,
                                   int H, int Hkv, int Sq, int Sk, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_ATTENTION_BWD_CASE(DQK, DV)                                   \
  if (d == DQK && dv == DV)                                                 \
    return launch<DQK, DV>(                                                 \
        static_cast<const float*>(q), static_cast<const float*>(k),         \
        static_cast<const float*>(v), static_cast<const float*>(o),         \
        static_cast<const float*>(lse), static_cast<const float*>(dO),      \
        static_cast<float*>(dq), static_cast<float*>(dk),                   \
        static_cast<float*>(dV), static_cast<float*>(delta),                \
        static_cast<float*>(part), B, H, Hkv, Sq, Sk, causal, window,       \
        scale, s);
  REPRO_ATTENTION_BWD_CASE(32, 32)
  REPRO_ATTENTION_BWD_CASE(64, 64)
  REPRO_ATTENTION_BWD_CASE(128, 128)
  REPRO_ATTENTION_BWD_CASE(192, 128)
  REPRO_ATTENTION_BWD_CASE(48, 32)
#undef REPRO_ATTENTION_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
