// Masked online-softmax attention with grouped KV heads, bf16, on Hopper's
// tensor cores (sm_90a): TMA-fed wgmma.
//
//   o[b, i, h, :] = softmax_j(mask(i, j) ? scale * q[b, i, h] . k[b, j, h/G]
//                                        : -inf) @ v[b, :, h/G, :]
//
// q, o (B, Sq, H, D); k, v (B, Sk, Hkv, D); G = H / Hkv; bf16 in and out,
// D one of 32, 64, 128; scores, the running max and denominator and the
// accumulator in f32. Query row i sits at position i + Sk - Sq (the causal
// diagonal is right-aligned); key j is kept when j < Sk, j <= qpos if
// causal, and j > qpos - window if window > 0. The f32 case runs the
// CUDA-core program of attention.cu; the wrapper picks one by dtype.
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
// No atomics, fixed reduction orders: a given card gives the same bits on
// every run.

#include <cuda.h>  // CUtensorMap; libcuda gives the encoder at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                    // query rows per block
constexpr int kHalf = 64;                   // rows per consumer warpgroup
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kStages = 2;                  // the K ring and the V ring
constexpr float kNegBig = -1e30f;           // the running max's start
constexpr float kLog2e = 1.4426950408889634f;

// tile geometry at head dim D (bf16)
template <int D>
struct Tile {
  static constexpr int BK = 64;                      // keys per tile
  static constexpr int ROW = D * 2 < 128 ? D * 2 : 128;  // bytes per box row
  static constexpr int COLS = ROW / 2;               // columns per box
  static constexpr int CHUNKS = D / COLS;            // boxes per row of D
  static constexpr uint32_t LAYOUT = ROW == 128 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // K or V, one stage
  static constexpr int BARS = Q_BYTES + kStages * 2 * KV_BYTES;
  static constexpr int SMEM = BARS + 8 * (1 + 4 * kStages) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the 128 threads of warpgroup g (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1 = 128B, 2 = 64B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers in program order: an accumulator is not read before the
// wait above it, and a wgmma's inputs are all written before it is issued
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16, smem) . B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, f32) += A (64 x 16, smem) . B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, registers) . B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "head dim");
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of a swizzled box row: 16-byte chunk ^= row bits (the
// pattern TMA writes and wgmma reads; the tile base is 1024-aligned)
template <int ROW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
}

// issue S = Q K^T for one warpgroup, both K-major: a k-step of 16 columns
// is 32 bytes into a swizzled row, the next box after ROW bytes
template <int D>
__device__ __forceinline__ void issue_scores(float* sc, uint32_t sQg,
                                             uint32_t sK) {
  using T = Tile<D>;
  constexpr int BK = T::BK, ROW = T::ROW;
  static_assert(BK == 64, "the score tile is one m64n64 wgmma wide");
  auto desc = [&](uint32_t tile, int rows, int kk) {
    const uint32_t box = (kk * 32) / ROW, in = (kk * 32) % ROW;
    return smem_desc(tile + box * rows * ROW + in, 16, 8 * ROW, T::LAYOUT);
  };
  wgmma_fence();
  // the first k-step writes sc (sc is no input, so its registers are free
  // between tiles), the others accumulate
  wgmma_ss_n64_first(sc, desc(sQg, kBQ, 0), desc(sK, BK, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(sc, desc(sQg, kBQ, kk), desc(sK, BK, kk));
  wgmma_commit();
}

// issue O += P_hi V + P_lo V; V is MN-major: a k-step is 16 key rows, the
// next box of D columns BK rows on
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* ph,
                                         const uint32_t* pl, uint32_t sV) {
  using T = Tile<D>;
  constexpr int BK = T::BK, ROW = T::ROW;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        smem_desc(sV + kk * 16 * ROW, BK * ROW, 8 * ROW, T::LAYOUT);
    wgmma_rs<D>(o, ph + 4 * kk, dv);
    wgmma_rs<D>(o, pl + 4 * kk, dv);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, int H,
                          int Hkv, int Sq, int Sk, int causal, int window,
                          float scale) {
  using T = Tile<D>;
  constexpr int BK = T::BK, ROW = T::ROW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage s: K at sKV + 2s KV_BYTES, V right after it
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
      for (int c = 0; c < T::CHUNKS; ++c)
        tma_load(sQ + c * kBQ * ROW, &tq, q_full, c * T::COLS, h, q0, b);
      // K and V on rings of their own: K(i + 1) loads while V(i - 1) is
      // still being read
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = (t_begin + i) * BK;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const uint32_t sK = sKV + 2 * s * T::KV_BYTES;
        if (i >= kStages) mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load(sK + c * BK * ROW, &tk, k_full + 8 * s, c * T::COLS, hk,
                   k0, b);
        if (i >= kStages) mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load(sK + T::KV_BYTES + c * BK * ROW, &tv, v_full + 8 * s,
                   c * T::COLS, hk, k0, b);
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
  const uint32_t sQg = sQ + g * kHalf * ROW;
  const float sl2 = scale * kLog2e;
  // a tile needs the mask where it crosses Sk, the causal diagonal or the
  // window's lower edge of this half's rows
  auto edge = [&](int k0) {
    return k0 + BK > Sk || (causal && k0 + BK - 1 > pos0) ||
           (window > 0 && k0 <= pos0 + kHalf - 1 - window);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
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
    issue_scores<D>(sc, sQg, sKV + 2 * s * T::KV_BYTES);
    return k0;
  };
  auto step = [&](int i, uint32_t* ph, uint32_t* pl, uint32_t* nh,
                  uint32_t* nl) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(v_full + 8 * sp, ((i - 1) / kStages) & 1);
    const int k0 = scores(i);
    issue_pv<D>(o, ph, pl, sKV + (2 * sp + 1) * T::KV_BYTES);
    wgmma_wait<1>();  // the scores have landed; P V may still run
    fence_regs<BK / 2>(sc);
    mbar_arrive(k_empty + 8 * s);
    softmax_tile<BK>(sc, nh, nl, m, lsum, alpha, sl2, edge(k0), k0, cq, qpos,
                     Sk, causal, window);
    fence_regs<BK / 4>(nh);
    fence_regs<BK / 4>(nl);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    mbar_arrive(v_empty + 8 * sp);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * j + 2 * r] *= alpha[r];
        o[4 * j + 2 * r + 1] *= alpha[r];
      }
    }
    fence_regs<D / 2>(o);
  };
  auto last_pv = [&](uint32_t* ph, uint32_t* pl) {
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(v_full + 8 * sp, ((n_tiles - 1) / kStages) & 1);
    issue_pv<D>(o, ph, pl, sKV + (2 * sp + 1) * T::KV_BYTES);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
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
  // map's swizzle expects, and store them by TMA (rows >= Sq are clipped)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    lsum[r] = fmaxf(lsum[r], 1e-30f);
  }
  warpgroup_sync(g);  // every warp of the half is done reading its Q rows
  uint8_t* base = smem_raw + (sQg - smem_addr(smem_raw));
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    const uint32_t box = col / T::COLS, cc = col % T::COLS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off =
          box * kBQ * ROW + swizzle<ROW>((r0 + 8 * r) * ROW + 2 * cc);
      *reinterpret_cast<__nv_bfloat162*>(base + off) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / lsum[r], o[4 * j + 2 * r + 1] / lsum[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(g);
  if (lt == 0) {
    for (int c = 0; c < T::CHUNKS; ++c)
      tma_store(&to, sQg + c * kBQ * ROW, c * T::COLS, h, q0 + kHalf * g, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, looked up at run time: nothing links libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over (D, heads, S, B) of a contiguous (B, S, heads, D) bf16
// tensor, box (cols, 1, rows, 1)
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int heads, int S, int B, int rows) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::COLS), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t s) {
  using T = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mo;
  if (!make_map<D>(encode, &mq, q, H, Sq, B, kBQ) ||
      !make_map<D>(encode, &mk, k, Hkv, Sk, B, T::BK) ||
      !make_map<D>(encode, &mv, v, Hkv, Sk, B, T::BK) ||
      !make_map<D>(encode, &mo, o, H, Sq, B, kHalf))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel_sm90<D><<<static_cast<unsigned>(blocks), kThreads,
                             T::SMEM, s>>>(mq, mk, mv, mo, H, Hkv, Sq, Sk,
                                           causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and o; head_dim one of 32, 64, 128. q and o are
// (B, Sq, H, head_dim), k and v (B, Sk, Hkv, head_dim), all contiguous and
// 16-byte aligned, with H % Hkv == 0. Returns the CUDA error code of the
// launch (0 = cudaSuccess).
extern "C" int repro_attention_sm90(int head_dim, const void* q,
                                    const void* k, const void* v, void* o,
                                    int B, int H, int Hkv, int Sq, int Sk,
                                    int causal, int window, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, scale,
                        s);
    case 128:
      return launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
