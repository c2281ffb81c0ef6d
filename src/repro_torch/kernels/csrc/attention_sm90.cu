// Masked online-softmax attention with grouped KV heads, bf16, on Hopper's
// tensor cores (sm_90a): TMA-fed wgmma.
//
//   o[b, i, h, :] = softmax_j(mask(i, j) ? scale * q[b, i, h] . k[b, j, h/G]
//                                        : -inf) @ v[b, :, h/G, :]
//
// q (B, Sq, H, DK); k (B, Sk, Hkv, DK); v (B, Sk, Hkv, DV); o (B, Sq, H,
// DV); G = H / Hkv; bf16 in and out; (DK, DV) one of (32, 32), (64, 64),
// (128, 128) and (192, 128), the last multi-head latent attention's
// (DeepSeek-V2: the decoupled rotary part rides on the query/key width);
// scores, the running max and denominator and the accumulator in f32. Query row i sits at position i + Sk - Sq (the causal
// diagonal is right-aligned); key j is kept when j < Sk, j <= qpos if
// causal, and j > qpos - window if window > 0. The f32 case runs the
// split-TF32 program of attention.cu; the wrapper picks one by dtype.
//
// Replaces, for bf16, the same two Pallas kernels as attention.cu:
// src/repro/kernels/flash_attention.py (flash_attention, with the GQA front
// end src/repro/kernels/ops.py flash_attention_gqa) and
// src/repro/kernels/swa_attention.py (swa_attention: causal = 1 and the
// window; the key loop covers only the tiles that overlap
// (qpos - window, qpos]).
//
// Bound: at the serving shapes (head dim 128, thousands of keys per row)
// the bf16 tensor-core rate: 4 flops per kept query-key pair per head
// dimension against q, k, v, o moved once. The design runs 1.5x those
// products (see "P"), so it can reach at most 2/3 of that bound.
//
// Design. A block of 384 threads owns one (batch, head) and a tile of 128
// query rows: two consumer warpgroups of 64 rows each (wgmma's M) and a
// producer warpgroup, which gives its registers to the consumers
// (setmaxnreg 24 / 240). The grid is one-dimensional, (batch, head)
// fastest and the last query tile first, so the longest causal tiles start
// first and B * H has no limit of its own.
//   * Copies. One producer thread loads the Q tile once, then K and V tiles
//     of BK = 64 keys, each on a two-stage ring of its own, by TMA on 4-D
//     tensor maps over (D, heads, S, B) with 128-byte swizzle (64-byte at
//     D = 32; a D = 128 row is two 64-column boxes). The hardware zero-fills
//     rows past Sq or Sk, so a ragged tile never reads the next batch's
//     rows. mbarriers: q_full; per stage k_full and v_full (the transaction
//     bytes) and k_empty and v_empty (all 256 consumer threads arrive once
//     the wgmma that reads the tile has completed).
//   * S = Q K^T: m64n64k16 wgmma, bf16 -> f32, Q and K both K-major in
//     shared memory (D is contiguous). bf16 products are exact in f32; only
//     the summation order differs from the plain version.
//   * Softmax on the accumulator fragment: each row lives in a quad of
//     lanes, so the row max is two xor shuffles; scores are scaled into
//     log2 units inside the exponent's FMA (ex2.approx). The mask runs only
//     on tiles that cross Sk, the causal diagonal or the window's lower
//     edge of the warpgroup's rows; interior tiles skip it. A masked score
//     is -inf, so its p is 0 even while the running max is still -1e30. The
//     denominator is summed per thread from the f32 p and reduced across
//     the quad once, at the end.
//   * P. The S fragment, packed in pairs, is the register A operand of the
//     next wgmma. Rounding p to bf16 once misses the bf16 tolerance (one
//     bf16 step of the output) on ~10% of outputs at S = 2048, so p is
//     split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and O += P V
//     runs twice per tile, m64nDk16 with V MN-major through the transpose
//     bit (V is never transposed in memory).
//   * Pipeline. Per tile i the warpgroup issues S of tile i and, behind it,
//     P V of tile i - 1; it waits for S only, runs the softmax of tile i
//     while P V runs, then waits for P V and rescales O. The p of two tiles
//     live in two register buffers, and the loop takes two tiles a turn so
//     no register is copied while a wgmma reads it. BK = 64 keeps the
//     consumer under its 240 registers with no spills (at BK = 128 the
//     second buffer spills).
//   * Output. Each warpgroup writes its normalized rows as bf16 into its
//     half of the Q tile (swizzled as the map expects) and stores them by
//     TMA, which clips rows >= Sq.
//   * Log-sum-exp. A gradient's forward (kLse, a non-null lse) also writes
//     each row's log-sum-exp of its scaled kept scores to (B, H, Sq) f32,
//     natural log, -inf for a row that keeps no key: the convention of
//     attention.cu, which the backward kernels read. The running max m is
//     in log2 units of the scaled scores, so lse = (m + log2(l)) ln 2 from
//     the quad's reduced denominator l. The serving path passes no lse and
//     runs the kLse = false instance, unchanged.
// No atomics, fixed reduction orders: a given card gives the same bits on
// every run.

#include <cuda.h>  // CUtensorMap; libcuda gives the encoder at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBQ = 128;                    // query rows per block
constexpr int kHalf = 64;                   // rows per consumer warpgroup
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kStages = 2;                  // the K ring and the V ring
constexpr float kNegBig = -1e30f;           // the running max's start
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// tile geometry at query/key width DK and value width DV (bf16): Q and K
// rows are boxes of DK, V and O rows boxes of DV. Each consumer warpgroup
// stages its output in its own rows of the Q tile's boxes, so DV <= DK and
// both take boxes of the same row width.
template <int DK, int DV>
struct Tile {
  using QK = Box<DK>;
  using VO = Box<DV>;
  static_assert(DV <= DK && QK::ROW == VO::ROW,
                "the output is staged in the Q tile");
  static constexpr int BK = 64;                      // keys per tile
  static constexpr int Q_BYTES = kBQ * DK * 2;
  static constexpr int K_BYTES = BK * DK * 2;        // K, one stage
  static constexpr int V_BYTES = BK * DV * 2;        // V, one stage
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int BARS = Q_BYTES + kStages * STAGE;
  static constexpr int SMEM = BARS + 8 * (1 + 4 * kStages) + 1024;  // + align
};

// issue S = Q K^T for one warpgroup, both K-major: a k-step of 16 columns
// is 32 bytes into a swizzled row, the next box after ROW bytes
template <int DK, int DV>
__device__ __forceinline__ void issue_scores(float* sc, uint32_t sQg,
                                             uint32_t sK) {
  using T = Tile<DK, DV>;
  constexpr int BK = T::BK, ROW = T::QK::ROW;
  static_assert(BK == 64, "the score tile is one m64n64 wgmma wide");
  auto desc = [&](uint32_t tile, int rows, int kk) {
    const uint32_t box = (kk * 32) / ROW, in = (kk * 32) % ROW;
    return smem_desc(tile + box * rows * ROW + in, 16, 8 * ROW,
                     T::QK::LAYOUT);
  };
  wgmma_fence();
  // the first k-step writes sc (sc is no input, so its registers are free
  // between tiles), the others accumulate
  wgmma_ss_n64_first(sc, desc(sQg, kBQ, 0), desc(sK, BK, 0));
#pragma unroll
  for (int kk = 1; kk < DK / 16; ++kk)
    wgmma_ss_n64(sc, desc(sQg, kBQ, kk), desc(sK, BK, kk));
  wgmma_commit();
}

// issue O += P_hi V + P_lo V; V is MN-major: a k-step is 16 key rows, the
// next box of DV columns BK rows on
template <int DK, int DV>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* ph,
                                         const uint32_t* pl, uint32_t sV) {
  using T = Tile<DK, DV>;
  constexpr int BK = T::BK, ROW = T::VO::ROW;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        smem_desc(sV + kk * 16 * ROW, BK * ROW, 8 * ROW, T::VO::LAYOUT);
    wgmma_rs<DV>(o, ph + 4 * kk, dv);
    wgmma_rs<DV>(o, pl + 4 * kk, dv);
  }
  wgmma_commit();
}

// The online softmax of one score tile on the accumulator fragment: the
// thread's rows r0 + 8r, key columns k0 + 8j + cq + {0, 1}. Updates the
// running max m (log2 units) and the thread's share of the denominator,
// returns the rescale factors in alpha, and writes p split into bf16 hi
// and lo A fragments: pair (4j + 2r, +1) is register 2j + r, so k-step kk
// reads registers 4kk .. 4kk + 3.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float* sc, uint32_t* ph, uint32_t* pl, float* m, float* lsum,
    float* alpha, float sl2, bool edge, int k0, int cq, const int* qpos,
    int Sk, int causal, int window) {
  float mx[2] = {-__uint_as_float(0x7f800000u), -__uint_as_float(0x7f800000u)};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sc[4 * j + 2 * r + c];
        if (edge) {
          const int kpos = k0 + 8 * j + cq + c;
          const bool keep = kpos < Sk && (!causal || kpos <= qpos[r]) &&
                            (window <= 0 || kpos > qpos[r] - window);
          x = keep ? x : -__uint_as_float(0x7f800000u);  // -inf: p = 0
          sc[4 * j + 2 * r + c] = x;
        }
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // scale > 0, so the max of the scaled scores is the scaled max
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    nm[r] = -m_new;
  }
  float ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = ex2(fmaf(sc[4 * j + 2 * r], sl2, nm[r]));
      const float p1 = ex2(fmaf(sc[4 * j + 2 * r + 1], sl2, nm[r]));
      ps[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[2 * j + r] = bf16x2_bits(hi);
      pl[2 * j + r] =
          bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) lsum[r] = lsum[r] * alpha[r] + ps[r];
}

template <int DK, int DV, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          float* __restrict__ lse, int H, int Hkv, int Sq,
                          int Sk, int causal, int window, float scale) {
  using T = Tile<DK, DV>;
  using QK = typename T::QK;
  using VO = typename T::VO;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage s: K at sKV + s STAGE, V right after it
  const uint32_t sKV = sQ + T::Q_BYTES;
  const uint32_t q_full = sQ + T::BARS;
  const uint32_t k_full = q_full + 8;             // + 8 s, likewise below
  const uint32_t k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  // the last query tile first, (batch, head) fastest
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kBQ;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int hk = h / (H / Hkv);

  // the key tiles any row of this query tile may keep
  const int q_offset = Sk - Sq;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_offset + q_last + 1);
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int t_begin = k_lo / BK;
  const int n_tiles = max(0, (k_hi > 0 ? (k_hi + BK - 1) / BK : 0) - t_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < QK::CHUNKS; ++c)
        tma_load(sQ + c * kBQ * QK::ROW, &tq, q_full, c * QK::COLS, h, q0,
                 b);
      // K and V on rings of their own: K(i + 1) loads while V(i - 1) is
      // still being read
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = (t_begin + i) * BK;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const uint32_t sK = sKV + s * T::STAGE;
        if (i >= kStages) mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, T::K_BYTES);
        for (int c = 0; c < QK::CHUNKS; ++c)
          tma_load(sK + c * BK * QK::ROW, &tk, k_full + 8 * s, c * QK::COLS,
                   hk, k0, b);
        if (i >= kStages) mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, T::V_BYTES);
        for (int c = 0; c < VO::CHUNKS; ++c)
          tma_load(sK + T::K_BYTES + c * BK * VO::ROW, &tv, v_full + 8 * s,
                   c * VO::COLS, hk, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup g owns rows 64g .. 64g + 63 of the tile; a thread
  // holds rows r0 and r0 + 8, columns 8j + cq + {0, 1} of each fragment
  const int g = tid / 128, lt = tid % 128;
  const int lane = lt % 32;
  const int r0 = 16 * (lt / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int pos0 = q_offset + q0 + kHalf * g;  // position of row 0 of the half
  const int qpos[2] = {pos0 + r0, pos0 + r0 + 8};
  const uint32_t sQg = sQ + g * kHalf * QK::ROW;
  const float sl2 = scale * kLog2e;
  // a tile needs the mask where it crosses Sk, the causal diagonal or the
  // window's lower edge of this half's rows
  auto edge = [&](int k0) {
    return k0 + BK > Sk || (causal && k0 + BK - 1 > pos0) ||
           (window > 0 && k0 <= pos0 + kHalf - 1 - window);
  };

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegBig, kNegBig}, lsum[2] = {0.0f, 0.0f}, alpha[2];
  float sc[BK / 2];
  // p of two tiles, as bf16 hi and lo A fragments: tile i in buffer i % 2
  uint32_t p0h[BK / 4], p0l[BK / 4], p1h[BK / 4], p1l[BK / 4];

  // Software pipeline, per tile i >= 1: the scores of tile i are issued
  // on the tensor cores with P V of tile i - 1 behind them; the softmax of
  // tile i overlaps that P V, and O is rescaled once it has landed. K and
  // V of a stage are released as soon as their wgmma has read them.
  auto scores = [&](int i) {
    const int s = i % kStages, k0 = (t_begin + i) * BK;
    mbar_wait(k_full + 8 * s, (i / kStages) & 1);
    issue_scores<DK, DV>(sc, sQg, sKV + s * T::STAGE);
    return k0;
  };
  auto step = [&](int i, uint32_t* ph, uint32_t* pl, uint32_t* nh,
                  uint32_t* nl) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(v_full + 8 * sp, ((i - 1) / kStages) & 1);
    const int k0 = scores(i);
    issue_pv<DK, DV>(o, ph, pl, sKV + sp * T::STAGE + T::K_BYTES);
    wgmma_wait<1>();  // the scores have landed; P V may still run
    fence_regs<BK / 2>(sc);
    mbar_arrive(k_empty + 8 * s);
    softmax_tile<BK>(sc, nh, nl, m, lsum, alpha, sl2, edge(k0), k0, cq, qpos,
                     Sk, causal, window);
    fence_regs<BK / 4>(nh);
    fence_regs<BK / 4>(nl);
    wgmma_wait<0>();
    fence_regs<DV / 2>(o);
    mbar_arrive(v_empty + 8 * sp);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * j + 2 * r] *= alpha[r];
        o[4 * j + 2 * r + 1] *= alpha[r];
      }
    }
    fence_regs<DV / 2>(o);
  };
  auto last_pv = [&](uint32_t* ph, uint32_t* pl) {
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(v_full + 8 * sp, ((n_tiles - 1) / kStages) & 1);
    issue_pv<DK, DV>(o, ph, pl, sKV + sp * T::STAGE + T::K_BYTES);
    wgmma_wait<0>();
    fence_regs<DV / 2>(o);
  };

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    const int k0 = scores(0);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    mbar_arrive(k_empty);
    softmax_tile<BK>(sc, p0h, p0l, m, lsum, alpha, sl2, edge(k0), k0, cq,
                     qpos, Sk, causal, window);
    fence_regs<BK / 4>(p0h);
    fence_regs<BK / 4>(p0l);
    for (int i = 1; i < n_tiles; i += 2) {  // two tiles a turn: no copies
      step(i, p0h, p0l, p1h, p1l);
      if (i + 1 == n_tiles) break;
      step(i + 1, p1h, p1l, p0h, p0l);
    }
    if (n_tiles % 2) last_pv(p0h, p0l);
    else last_pv(p1h, p1l);
  }

  // normalize, write bf16 rows into this half of the Q tile as the output
  // map's swizzle expects (boxes of DV columns, laid out as the Q tile's
  // boxes of DK would be at DV's width), and store them by TMA (rows >= Sq
  // are clipped)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
  // the rows' log-sum-exp, natural log, for the backward; -inf for a row
  // that keeps no key (its denominator is 0)
  if (kLse && cq == 0) {
    float* lr = lse + static_cast<int64_t>(bh) * Sq + q0 + kHalf * g;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + kHalf * g + r0 + 8 * r < Sq)
        lr[r0 + 8 * r] = lsum[r] > 0.0f ? (m[r] + log2f(lsum[r])) * kLn2
                                        : -__uint_as_float(0x7f800000u);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) lsum[r] = fmaxf(lsum[r], 1e-30f);
  warpgroup_sync(g);  // every warp of the half is done reading its Q rows
  const uint32_t sOg = sQ + g * kHalf * VO::ROW;
  uint8_t* base = smem_raw + (sOg - smem_addr(smem_raw));
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = 8 * j + cq;
    const uint32_t box = col / VO::COLS, cc = col % VO::COLS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = box * kBQ * VO::ROW +
                           swizzle<VO::ROW>((r0 + 8 * r) * VO::ROW + 2 * cc);
      *reinterpret_cast<__nv_bfloat162*>(base + off) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / lsum[r], o[4 * j + 2 * r + 1] / lsum[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(g);
  if (lt == 0) {
    for (int c = 0; c < VO::CHUNKS; ++c)
      tma_store(&to, sOg + c * kBQ * VO::ROW, c * VO::COLS, h, q0 + kHalf * g,
                b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int DK, int DV, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t s) {
  using T = Tile<DK, DV>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mo;
  if (!make_map<DK>(encode, &mq, q, H, Sq, B, kBQ) ||
      !make_map<DK>(encode, &mk, k, Hkv, Sk, B, T::BK) ||
      !make_map<DV>(encode, &mv, v, Hkv, Sk, B, T::BK) ||
      !make_map<DV>(encode, &mo, o, H, Sq, B, kHalf))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel_sm90<DK, DV, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel_sm90<DK, DV, kLse>
      <<<static_cast<unsigned>(blocks), kThreads, T::SMEM, s>>>(
          mq, mk, mv, mo, static_cast<float*>(lse), H, Hkv, Sq, Sk, causal,
          window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and o; (dk, dv) one of (32, 32), (64, 64), (128, 128) and
// (192, 128). q is (B, Sq, H, dk), k (B, Sk, Hkv, dk), v (B, Sk, Hkv, dv)
// and o (B, Sq, H, dv), all contiguous and 16-byte aligned, with
// H % Hkv == 0. lse is null (serving), or (B, H, Sq) f32 that receives
// each row's log-sum-exp (a gradient's forward). Returns the CUDA error
// code of the launch (0 = cudaSuccess).
extern "C" int repro_attention_sm90(int dk, int dv, const void* q,
                                    const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int Hkv, int Sq,
                                    int Sk, int causal, int window,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTENTION_CASE(DK, DV)                                        \
  if (dk == DK && dv == DV)                                                 \
    return lse == nullptr                                                   \
               ? launch<DK, DV, false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,  \
                                       causal, window, scale, s)            \
               : launch<DK, DV, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,   \
                                      causal, window, scale, s);
  REPRO_ATTENTION_CASE(32, 32)
  REPRO_ATTENTION_CASE(64, 64)
  REPRO_ATTENTION_CASE(128, 128)
  REPRO_ATTENTION_CASE(192, 128)
#undef REPRO_ATTENTION_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
