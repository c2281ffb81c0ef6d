// Masked online-softmax attention with grouped KV heads in f32, on Hopper's
// tensor cores in split TF32 (sm_90a): the f32 program. bf16 runs the
// program of attention_sm90.cu; the wrapper (flash_attention.py) picks one
// by dtype.
//
//   o[b, i, h, :] = softmax_j(mask(i, j) ? scale * q[b, i, h] . k[b, j, h/G]
//                                        : -1e30) @ v[b, :, h/G, :]
//
// q (B, Sq, H, DK); k (B, Sk, Hkv, DK); v (B, Sk, Hkv, DV); o (B, Sq, H, DV);
// G = H / Hkv; f32 in and out. DK = DV but for multi-head latent attention
// (DeepSeek-V2), whose queries and keys carry the decoupled rotary part on
// top of the value width: (192, 128) at full width, (48, 32) at the smoke
// config's. Query row i sits at position i + Sk - Sq (the causal diagonal
// is right-aligned); key j is kept when j < Sk, j <= qpos if causal, and
// j > qpos - window if window > 0.
//
// Replaces, for f32, two Pallas kernels:
//   * src/repro/kernels/flash_attention.py (flash_attention, _flash_kernel)
//     and its GQA front end src/repro/kernels/ops.py (flash_attention_gqa);
//   * src/repro/kernels/swa_attention.py (swa_attention, _swa_kernel), the
//     banded causal case (Sq = Sk, S % window == 0): the same program with
//     causal = 1 and the window; its key loop is bounded to the window, so
//     it reads the k tiles that overlap (qpos - window, qpos] and no others,
//     which is what the TPU kernel's "k blocks i-1 and i" does when its
//     block is the whole window.
//
// Bound: the arithmetic, 2 (DK + DV) flops per kept query-key pair and
// head. The tensor cores take f32 only as TF32 (10 mantissa bits); one
// TF32 product keeps ~3 digits and misses the f32 tolerance (rtol 1e-4;
// tests/test_torch_attention_f32_tiles.py shows it), so every product is
// split TF32 (3xTF32): v = hi + lo, hi = v rounded to TF32 (cvt.rna's
// rounding, by two integer operations), lo = v - hi, exact in f32 and read
// by the tensor cores as TF32; a b = a_lo b_hi + a_hi b_lo + a_hi b_hi in
// f32, the small terms first, as ssd_scan.cu does. That is 3 TF32 products
// a product: the bound is 3 x the flops over the TF32 rate (495 TFLOP/s),
// beside the flops over the CUDA cores' f32 rate (67 TFLOP/s), the bound
// of plain f32 FMAs.
// The softmax, the running max, the rescale and the denominator stay f32.
//
// Design. A block of W warps owns one (batch, head) and a tile of 16 W
// query rows, 16 a warp (mma's M): W = 12 at (128, 128), 8 otherwise. It
// walks 32-key tiles of the block's key range. The grid is
// one-dimensional, (batch, head) fastest and the last query tile first,
// so the longest causal tiles start first and B * H has no limit of its
// own.
//   * Products: mma.sync.m16n8k8 TF32. wgmma takes TF32 operands K-major
//     only, from shared memory: Q K^T would fit as it is, but P V needs V
//     with the keys contiguous (its transpose bit exists only for 16-bit
//     types), and at (192, 128) the hi and lo images of Q and of a
//     double-buffered K and V come to ~370 KB for 8 warps. With mma.sync
//     each thread loads its own fragments from the f32 tiles and splits
//     them in registers; nothing is transposed in memory.
//   * S = Q K^T. The k-step's 8 head dims are taken in the order
//     (0, 2, 4, 6 | 1, 3, 5, 7): fragment element t reads dim 2t and
//     element t + 4 dim 2t + 1 of Q and of K alike, so each is one 8-byte
//     shared load. Q (rows padded to DK + 8 floats) stays in shared memory
//     for the whole loop; its fragment is split once a k-step and used for
//     the 4 key n-tiles.
//   * Softmax on the accumulator fragment, in log2 units (the scores times
//     scale * log2(e), then exp2): a row lives in a quad of lanes,
//     so the row max is two xor shuffles; the denominator is summed per
//     thread and reduced over the quad once, at the end. The mask runs
//     only on tiles that cross Sk, the causal diagonal or the window's
//     lower edge of the warp's 16 rows; a masked score is -1e30 and its p
//     is 0 even while the running max is still -1e30 (as
//     flash_attention.py:61 does), so a row whose first tiles are all
//     masked accumulates nothing from them. A warp skips a tile that none
//     of its rows keeps (all its p would be 0 and its rescale 1, so the
//     state would not change by a bit).
//   * O += P V. The S accumulator of n-tile j holds keys 8j + 2t and
//     8j + 2t + 1 of rows g and g + 8; taken as the A fragment of k-step j
//     with the keys in the order (0, 2, 4, 6 | 1, 3, 5, 7), it needs no
//     shuffle: the B fragment reads V rows 8j + 2t and 8j + 2t + 1 (rows
//     padded to DV + 4 floats, so the 32 lanes hit 32 banks).
//   * Copies. K and V tiles arrive by cp.async (16 bytes, zero-filled past
//     Sk) into a ring of three stages, the next two tiles' copies in flight
//     while the current tile is computed; one barrier a tile. Q arrives the
//     same way once, zero-filled past Sq.
//   * Occupancy. Each warp keeps its 16 rows of Q, 16 (DK + 8) floats, in
//     shared memory for the whole loop, beside the ring: 4 (16 W (DK + 8)
//     + 3 * 32 (DK + 8 + DV + 4)) bytes. (32, 32) 49,664, (48, 32) 64,000
//     and (64, 64) 90,624: two blocks of 8 warps an SM (at most 128
//     registers). (128, 128) 207,360: one block of 12 warps (158 registers
//     x 384 threads of the 65,536). (192, 128) 229,888 of the 232,448 a
//     block may use: one block of 8 warps (165 registers); 12 would need
//     a Q tile of 153,600 bytes.
//   * Tried on an H100 (PERF.md §6): 12 warps instead of 8 at
//     (128, 128) are faster. 16 at the small widths, two stages against
//     three, one or two accumulators a key n-tile, unrolling the Q K^T
//     loop, and K and V split once a tile into shared memory (two barriers
//     a tile) are no faster or slower.
// Key positions >= Sk are masked in the kernel, so a ragged non-causal Sk is
// right (the Pallas kernel pads keys with zeros and lets them into the
// softmax, ROADMAP C1). The KV head is read as h / G; nothing is repeated
// in memory. No atomics and fixed reduction orders: a given card gives the
// same bits on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;                 // keys per tile
constexpr int kStages = 3;              // the K / V ring
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DK, int DV>
struct Plan {
  static constexpr int kWarps = DK == 128 ? 12 : 8;  // 16 query rows each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;        // query rows per block
  static constexpr int LDK = DK + 8;    // floats a row of the Q and K tiles
  static constexpr int LDV = DV + 4;    // floats a row of the V tile
  static constexpr int kMinBlocks = DK >= 128 ? 1 : 2;
  static constexpr size_t kBytes =
      sizeof(float) *
      (static_cast<size_t>(kBQ) * LDK + kStages * kBK * (LDK + LDV));
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x COLS floats (source row stride sld floats) into shared memory with
// row stride LD; rows >= valid are zero-filled
template <int ROWS, int COLS, int LD, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t sld, int valid, int tid) {
  constexpr int C4 = COLS / 4;
#pragma unroll 4
  for (int e = tid; e < ROWS * C4; e += kThreads) {
    const int r = e / C4, c = (e - r * C4) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * sld + c : src, ok);
  }
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// kLse: write each row's log-sum-exp (a gradient's forward). A separate
// instantiation, so the serving forms are the code they were without it
// (a runtime branch cost MLA's (192, 128) form 1% on an H100).
template <int DK, int DV, bool kLse>
__global__ void __launch_bounds__(Plan<DK, DV>::kThreads,
                                  Plan<DK, DV>::kMinBlocks)
    attention_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int BH, int H, int Hkv, int Sq,
                     int Sk, int causal, int window, float scale) {
  static_assert(DK % 8 == 0 && DV % 8 == 0,
                "head dims must be multiples of 8");
  constexpr int LDK = Plan<DK, DV>::LDK, LDV = Plan<DK, DV>::LDV;
  constexpr int kThreads = Plan<DK, DV>::kThreads, kBQ = Plan<DK, DV>::kBQ;
  constexpr int KD = DK / 8;   // k-steps of S
  constexpr int NJ = kBK / 8;  // key n-tiles of S = k-steps of P V
  constexpr int NU = DV / 8;   // n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // kBQ x LDK
  float* sK = sQ + kBQ * LDK;             // kStages x kBK x LDK
  float* sV = sK + kStages * kBK * LDK;   // kStages x kBK x LDV

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int64_t q_stride = static_cast<int64_t>(H) * DK;  // per position
  const int64_t k_stride = static_cast<int64_t>(Hkv) * DK;
  const int64_t v_stride = static_cast<int64_t>(Hkv) * DV;
  const int64_t o_stride = static_cast<int64_t>(H) * DV;
  const float* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * DK;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * DK;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * DV;
  float* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * DV;

  // the key tiles any row of this query tile may keep: [t_lo, t_lo + n_t)
  const int q_offset = Sk - Sq;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_offset + q_last + 1);
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int t_lo = k_lo / kBK;
  const int n_t = k_hi > k_lo ? (k_hi + kBK - 1) / kBK - t_lo : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    const int valid = min(kBK, Sk - k0);
    load_tile<kBK, DK, LDK, kThreads>(sK + stage * kBK * LDK,
                                      kb + k0 * k_stride, k_stride, valid,
                                      tid);
    load_tile<kBK, DV, LDV, kThreads>(sV + stage * kBK * LDV,
                                      vb + k0 * v_stride, v_stride, valid,
                                      tid);
  };
  load_tile<kBQ, DK, LDK, kThreads>(sQ, qb + q0 * q_stride, q_stride,
                                    min(kBQ, Sq - q0), tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_t) load_kv(t_lo + s, s);
    cp_async_commit();
  }

  // this warp's rows: r0 + g and r0 + g + 8
  const int r0 = q0 + 16 * warp;
  const int pos0 = q_offset + r0;  // the position of row r0
  const int qp0 = pos0 + g, qp1 = qp0 + 8;
  const float* wq = sQ + (16 * warp + g) * LDK + 2 * t;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

  float acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < n_t; ++it) {
    cp_async_wait<kStages - 2>();
    // every thread's copies of this tile have landed, and no warp still
    // reads the stage the next copies overwrite
    __syncthreads();
    if (it + kStages - 1 < n_t)
      load_kv(t_lo + it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int k0 = (t_lo + it) * kBK;
    if (r0 >= Sq || (causal && k0 > pos0 + 15) ||
        (window > 0 && k0 + kBK - 1 <= pos0 - window))
      continue;  // no row of this warp keeps a key of this tile
    const float* tK = sK + (it % kStages) * kBK * LDK + g * LDK + 2 * t;
    const float* tV = sV + (it % kStages) * kBK * LDV + 2 * t * LDV + g;

    // S = Q K^T
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    // whole when DK is a multiple of 32; at (48, 32) that spills under
    // the two-blocks-an-SM register cap
#pragma unroll (DK % 32 == 0 ? DK / 8 : 3)
    for (int kk = 0; kk < KD; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(wq + 8 * kk);
      const float2 x1 =
          *reinterpret_cast<const float2*>(wq + 8 * LDK + 8 * kk);
      uint32_t ah[4], al[4];
      split(x0.x, ah[0], al[0]);
      split(x1.x, ah[1], al[1]);
      split(x0.y, ah[2], al[2]);
      split(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 y =
            *reinterpret_cast<const float2*>(tK + 8 * j * LDK + 8 * kk);
        mma3(s[j], ah, al, y.x, y.y);
      }
    }

    // the online softmax; bit 4j + e of `kept`: s[j][e] is kept
    uint32_t kept = 0xffffu;
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > pos0) ||
        (window > 0 && k0 <= pos0 + 15 - window)) {
      kept = 0u;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          const bool keep = kpos < Sk && (!causal || kpos <= qp) &&
                            (window <= 0 || kpos > qp - window);
          kept |= static_cast<uint32_t>(keep) << (4 * j + e);
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (kept >> (4 * j + e)) & 1u ? s[j][e] * sl2 : kNegInf;
        if (e < 2)
          mx0 = fmaxf(mx0, s[j][e]);
        else
          mx1 = fmaxf(mx1, s[j][e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (kept >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - (e < 2 ? mn0 : mn1))
                            : 0.0f;
        s[j][e] = p;
        if (e < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      acc[u][0] *= alpha0;
      acc[u][1] *= alpha0;
      acc[u][2] *= alpha1;
      acc[u][3] *= alpha1;
    }

    // O += P V: n-tile j of S is k-step j, keys in the order
    // (0, 2, 4, 6 | 1, 3, 5, 7)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const float* vj = tV + 8 * j * LDV;
#pragma unroll
      for (int u = 0; u < NU; ++u)
        mma3(acc[u], ph, pl, vj[8 * u], vj[LDV + 8 * u]);
    }
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int i0 = r0 + g, i1 = i0 + 8;
  // the rows' log-sum-exp of the scaled scores, natural log, for the
  // backward (attention_bwd.cu); -inf for a row that keeps no key
  if (kLse && t == 0) {
    float* lr = lse + static_cast<int64_t>(bh) * Sq;
    if (i0 < Sq) lr[i0] = l0 > 0.0f ? (m0 + log2f(l0)) * kLn2 : -INFINITY;
    if (i1 < Sq) lr[i1] = l1 > 0.0f ? (m1 + log2f(l1)) * kLn2 : -INFINITY;
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (i0 < Sq)
      *reinterpret_cast<float2*>(ob + i0 * o_stride + 8 * u + 2 * t) =
          make_float2(acc[u][0] / d0, acc[u][1] / d0);
    if (i1 < Sq)
      *reinterpret_cast<float2*>(ob + i1 * o_stride + 8 * u + 2 * t) =
          make_float2(acc[u][2] / d1, acc[u][3] / d1);
  }
}

template <int DK, int DV, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t s) {
  constexpr size_t smem = Plan<DK, DV>::kBytes;
  constexpr int kBQ = Plan<DK, DV>::kBQ, kThreads = Plan<DK, DV>::kThreads;
  const long long blocks = static_cast<long long>(B) * H *
                           ((Sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DK, DV, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<DK, DV, kLse>
      <<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(lse), B * H, H, Hkv, Sq, Sk, causal, window,
          scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 q, k, v and o; (dk, dv) one of (32, 32), (64, 64), (128, 128),
// (192, 128) and (48, 32). q is (B, Sq, H, dk), k (B, Sk, Hkv, dk), v
// (B, Sk, Hkv, dv) and o (B, Sq, H, dv), all contiguous and 16-byte
// aligned, with H % Hkv == 0. lse is null, or (B, H, Sq) f32 that
// receives each row's log-sum-exp (a gradient's forward, at every width
// pair: the backward's). Returns the CUDA error code of the launch (0 =
// cudaSuccess).
extern "C" int repro_attention(int dk, int dv, const void* q, const void* k,
                               const void* v, void* o, void* lse, int B,
                               int H, int Hkv, int Sq, int Sk, int causal,
                               int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTENTION_CASE(DK, DV)                                       \
  if (dk == DK && dv == DV)                                                \
    return lse == nullptr                                                  \
               ? launch<DK, DV, false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, \
                                       causal, window, scale, s)           \
               : launch<DK, DV, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,  \
                                      causal, window, scale, s);
  REPRO_ATTENTION_CASE(32, 32)
  REPRO_ATTENTION_CASE(64, 64)
  REPRO_ATTENTION_CASE(128, 128)
  REPRO_ATTENTION_CASE(192, 128)
  REPRO_ATTENTION_CASE(48, 32)
#undef REPRO_ATTENTION_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
