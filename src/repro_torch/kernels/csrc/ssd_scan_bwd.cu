// The gradient of the chunked SSD scan (csrc/ssd_scan.cu), for Hopper
// (sm_90a), in f32 on the tensor cores in split TF32.
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
// Design: four or five launches on one stream, no atomics, every sum in a
// fixed order that depends on Q, P, N and R alone, so a card gives the same
// bits on every run and a vmapped call (learners folded into BH) the
// per-learner calls' bits. The partition is ssd_scan.bwd_plan's.
//   1. ssd_scan_bwd_prep_kernel, grid (BH / R, S / Q): C B^T of one chunk
//      of one row of b and c, on its lower 16 x 8 tiles only, into a
//      (BH / R, S / Q, Q, Q) scratch: formed once per (row, chunk) and read
//      by the row's R heads (mamba2-2.7b: 80), where a chunk block per head
//      would form it R times. A pass of the backward's own, not the
//      forward's cbt scratch: keeping that beside the entering states
//      would change the forward's outputs and SSDScanFn's saved tensors
//      for 1 MB at mamba2-2.7b's shape. The same blocks write the decays
//      the walk needs, e^cum_i and e^cum_Q of each head's chunk (a warp a
//      head, cum in float64), so that no scan sits on the walk's chain.
//   2. ssd_scan_bwd_state_kernel, grid (BH, N / NB, P / 16W), W warps: the
//      ordered reverse walk, the mirror of the forward's pass 2. A warp
//      holds 16 rows of G by NB columns in mma.sync's accumulator and
//      walks the chunks from the last, writing G_c to a (BH, S / Q, P, N)
//      scratch before it adds the chunk's (e^cum dY)^T C: that product is
//      summed from zero on the tensor cores (in 8 / (NB / 8) partial sums
//      over consecutive k-steps where NB < 64, so that 8 accumulators are
//      in flight) and added to G in f32 after the decay multiply, so the
//      truncation of the tensor cores' sums never reaches G's long sum.
//      The column tile NB is N rounded up to 8, 16, 32 or 64 (16 at
//      hymba-1.5b's N = 16: no padded column is computed), and the rows of
//      G, which are independent, split across blocks: W (1, 2 or 4 warps,
//      the block's W row tiles sharing one staged tile of C) is the most
//      that still gives every SM a block (hymba's walk runs on 50 x 4 =
//      200 blocks of one warp, mamba2-2.7b's on 80 x 2 = 160 blocks of
//      four). The next chunks' C, dY and decays are in flight (cp.async, a
//      ring of 2 to 8 stages, as deep as two blocks an SM allow) during a
//      chunk's products. W does not change any row's arithmetic, so the
//      bits do not depend on it. Up to 255 registers a thread (197 at
//      NB = 64: still two blocks of four warps an SM), so that a k-step's
//      fragments of C are all loaded before its products.
//   3. ssd_scan_bwd_chunk_kernel, grid (BH S / Q), 8 warps: every chunk of
//      every head in parallel, from x, dt, dy, the C B^T scratch, b, c, the
//      forward's H_c and pass 2's G_c. dY U^T on its lower tiles, then L,
//      M1 = C B^T o L, M2 = dY U^T o L and T = M1 o dY U^T elementwise;
//      then the columns of b, c, H_c and G_c in slabs of NW = 16, 32 or 64
//      (two slabs at N = 128): dc = e^cum H_c^T dy + M2 B, G_c over H_c
//      with <G_c, H_c>, G_c B^T accumulated over the slabs, db =
//      e^(cum_Q - cum) U G_c + M2^T C; then du = e^(cum_Q - cum) G_c B^T +
//      M1^T dY, dx, W and x . du. It writes dx, ddt and, per head, db and
//      dc (the row's own where R = 1; read once more, by launch 4, so they
//      and G_c go past the L2 with evict-first hints), and the chunk's
//      share of da.
//   4. ssd_scan_bwd_sum_heads_kernel (R > 1 only): db and dc of each b/c
//      row, the per-head partials of its R heads summed in head order.
//   5. ssd_scan_bwd_sum_chunks_kernel: da per head, its chunks' shares
//      summed in chunk order.
// L selects the exponent to -inf above the diagonal BEFORE the exp: there
// cum_i - cum_j > 0, so the exp could overflow and inf * 0 would be NaN.
// Each pass recomputes cum from the forward's f32 da_t = dt_t a, summed in
// float64: a decay of nearby steps, e^(cum_i - cum_j), taken as the
// difference of two long f32 sums would lose |cum| eps of its argument
// (1e-5 of the decay where a chunk's cum reaches -100).
//
// Precision. Every product is mma.sync.m16n8k8 in split TF32, the
// convention of ssd_scan.cu and attention_bwd.cu: v = hi + lo, hi = v
// rounded to TF32 (cvt.rna's rounding, by two integer operations), lo =
// v - hi handed over unrounded (the tensor cores read its TF32 part), and
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first. One TF32
// product per product misses the backward's f32 tolerance
// (tests/test_torch_ssd_bwd.py, test_torch_ssd_bwd_tiles.py). Each
// product runs over at most 64 K values (a slab of N, P, or the chunk's
// Q), summed from zero on the tensor cores, and every sum of two products
// or over slabs or chunks is taken in f32 (attention_bwd.cu's lesson: the
// tensor cores truncate as they accumulate). The causal products (M2 B,
// M1^T dY, M2^T C) take only the k-steps of each 16-row tile that the mask
// keeps, and select within the two k-steps that cross the diagonal. The
// elementwise work stays f32 with cum in float64, in the order of the
// CUDA-core program it replaces: L, M1, M2, T, the exps, d da's row
// prefix and column suffix sums over T (one thread a row, then one a
// column, in index order), ddt and the chunk's share of da (one thread,
// in step order). The row sums (p1, W, x . du) and <G_c, H_c> are summed
// in a fixed order over a thread's columns, the 4 lanes of a quad, the
// warps (in warp order) and the slabs.
//
// Chunk pass layout. A warp's outputs are 16 x 8 tiles, two of the Q / 16
// row tiles (r and Q/16 - 1 - r, so that the causal products' work is the
// same for every warp) by one or two column tiles; M1 and M2 share one Q x
// Q tile (M2 on and below the diagonal, M1^T above, M1's diagonal beside).
// Shared memory at Q = 64, N = 128 (slabs of 64): dY, U, M, B, C and H_c
// / G_c tiles of 64 rows, 112,672 bytes, so two blocks (16 warps) share an
// SM, at 128 registers a thread (ptxas spills ~250 bytes). The row's C B^T
// is staged in T's place, which is C's before the slabs begin.
//
// Tried on an H100 (PERF.md, section 6), and not kept: the decays' float64
// scan on the walk's chain (a warp a block, every chunk); a walk block of
// four heads of one row sharing C, or of warps splitting a row tile's
// columns; db and dc summed over 2 to 8 heads of a row in a thread block
// cluster through distributed shared memory (dc staged in H_c's place, so
// H_c read again from the L2 for <G_c, H_c>): the chunk pass slowed by
// more than the head sum saved, at every cluster size; a shared C tile as
// an L2 hot spot (the heads' walks reading different chunks: no change);
// B rows conflict-free, two k-steps of a product in flight: no faster.
// What bounds the chunk pass: without its products (loads, stores,
// epilogues alone) it keeps a large share of its time, latency-bound at
// two blocks an SM; the products, three mma.sync and the split of every
// fragment element, are bound by issue as much as by the tensor pipe.
//
// Bound: the function reads x, dt, b, c and dy once and writes dx, ddt,
// db, dc and da once (263 MB at mamba2-2.7b's (80, 4096, 64, 128), 80
// heads a row, 0.079 ms at 3.35 TB/s); its flops (29.8 GFLOP there, three
// TF32 products each) take 0.18 ms at the tensor cores' TF32 rate. The
// design's own traffic: G_c written and read once, H_c read once (2 x 168
// MB and 168 MB), and the per-head db and dc partials where R > 1
// (2 x 168 MB written and read).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kWarps = 8;             // the chunk pass: 8 warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPrepThreads = 256;
constexpr int kSumThreads = 256;
constexpr int kMaxStages = 8;         // the walk's deepest ring of chunk tiles

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// ---- copies ----------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy a rows x cols tile (source row stride sld floats) into shared
// memory with row stride ld, zero-filling it out to rpad x cpad (cpad a
// multiple of 4): cp.async 16 bytes at a time where the rows allow it,
// else one float at a time. The caller commits and waits.
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src,
                                      int64_t sld, int rows, int cols,
                                      int rpad, int cpad, int tid,
                                      int nthreads) {
  const bool vec = cols % 4 == 0 && sld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int c4 = cpad / 4;
#pragma unroll 4
    for (int e = tid; e < rpad * c4; e += nthreads) {
      const int r = e / c4, cc = (e - r * c4) * 4;
      if (r < rows && cc < cols)
        cp_async16(dst + r * ld + cc, src + r * sld + cc);
      else
        *reinterpret_cast<float4*>(dst + r * ld + cc) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < rpad * cpad; e += nthreads) {
      const int r = e / cpad, cc = e - r * cpad;
      dst[r * ld + cc] = r < rows && cc < cols ? src[r * sld + cc] : 0.0f;
    }
  }
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

// ---- split TF32 on mma.sync -----------------------------------------------
// v = hi + lo: hi is v rounded to TF32, to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding, by two integer operations); lo = v - hi is
// exact in f32 and goes to the tensor cores unrounded, which read its TF32
// part (what they drop is below 2^-21 |v|)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
struct AFrag {  // an A fragment (16 x 8), split
  uint32_t h[4], l[4];
};
struct BFrag {  // a B fragment (8 x 8), split
  uint32_t h[2], l[2];
};
// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), one TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in split TF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     const BFrag& b) {
  mma(d, a.l, b.h[0], b.h[1]);
  mma(d, a.h, b.l[0], b.l[1]);
  mma(d, a.h, b.h[0], b.h[1]);
}
// The m16n8k8 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8"), with
// g = lane / 4 and t = lane % 4: A (16 x 8) holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (8 x 8) holds (t, g), (t + 4, g); the
// accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// `s` points at the fragment's (row 0, k 0) or (k 0, column 0).
//
// A(r, k) = s[r ld + k]: conflict-free where ld = 4 (mod 8)
__device__ __forceinline__ void a_rows(const float* s, int ld, int g, int t,
                                       AFrag& f) {
  split(s[g * ld + t], f.h[0], f.l[0]);
  split(s[(g + 8) * ld + t], f.h[1], f.l[1]);
  split(s[g * ld + t + 4], f.h[2], f.l[2]);
  split(s[(g + 8) * ld + t + 4], f.h[3], f.l[3]);
}
// A(r, k) = s[k ld + r]
__device__ __forceinline__ void a_cols(const float* s, int ld, int g, int t,
                                       AFrag& f) {
  split(s[t * ld + g], f.h[0], f.l[0]);
  split(s[t * ld + g + 8], f.h[1], f.l[1]);
  split(s[(t + 4) * ld + g], f.h[2], f.l[2]);
  split(s[(t + 4) * ld + g + 8], f.h[3], f.l[3]);
}
// B(k, n) = s[k ld + n]: conflict-free where ld = 8 or 24 (mod 32)
__device__ __forceinline__ void b_rows(const float* s, int ld, int g, int t,
                                       BFrag& f) {
  split(s[t * ld + g], f.h[0], f.l[0]);
  split(s[(t + 4) * ld + g], f.h[1], f.l[1]);
}
// B(k, n) = s[n ld + k]: conflict-free where ld = 4 (mod 8)
__device__ __forceinline__ void b_cols(const float* s, int ld, int g, int t,
                                       BFrag& f) {
  split(s[g * ld + t], f.h[0], f.l[0]);
  split(s[g * ld + t + 4], f.h[1], f.l[1]);
}

// ---- 1. C B^T once per (row of b and c, chunk), and the decays -----------
template <int Q>
size_t prep_smem_bytes(int N) {
  constexpr int QM = Q < 16 ? 16 : Q;
  return static_cast<size_t>(2 * QM) * (round_up(N, 8) + 4) * sizeof(float);
}
// floats of one (head, chunk) of the decay scratch: e^cum_i (Q), e^cum_Q,
// padding to 16 bytes
template <int Q>
__host__ __device__ constexpr int dec_floats() {
  return Q + 4;
}

template <int Q>
__global__ void __launch_bounds__(kPrepThreads)
    ssd_scan_bwd_prep_kernel(const float* __restrict__ b,
                             const float* __restrict__ c,
                             const float* __restrict__ dt,
                             const float* __restrict__ a,
                             float* __restrict__ cbt, float* __restrict__ dec,
                             int S, int N, int R) {
  constexpr int QM = Q < 16 ? 16 : Q;
  constexpr int NJ = Q / 8;  // column tiles of the Q x Q output
  const int NK = round_up(N, 8), ld = NK + 4;
  extern __shared__ float prep_smem[];
  float* sC = prep_smem;     // QM x ld: c (i, n)
  float* sB = sC + QM * ld;  // QM x ld: b (j, n)
  const int row = blockIdx.x, k = blockIdx.y, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t off = (static_cast<int64_t>(row) * S + k * Q) * N;
  stage(sC, ld, c + off, N, Q, N, QM, NK, tid, kPrepThreads);
  stage(sB, ld, b + off, N, Q, N, QM, NK, tid, kPrepThreads);
  cp_async_commit();
  // the decays of chunk k of the row's R heads, a warp a head: the walk
  // reads them with its tiles, off its ordered chain
  for (int h = warp; h < R; h += kPrepThreads / 32) {
    const int bh = row * R + h;
    const float* d = dt + static_cast<int64_t>(bh) * S + k * Q;
    const float av = a[bh];
    float* out = dec + (static_cast<int64_t>(bh) * nc + k) * dec_floats<Q>();
    double carry = 0.0;
#pragma unroll
    for (int q0 = 0; q0 < Q; q0 += 32) {
      const int q = q0 + lane;
      double v = q < Q ? static_cast<double>(d[q] * av) : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double w = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += w;
      }
      v += carry;
      if (q < Q) out[q] = expf(static_cast<float>(v));
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) out[Q] = expf(static_cast<float>(carry));
  }
  cp_async_wait_all();
  __syncthreads();
  float* o = cbt + (static_cast<int64_t>(row) * nc + k) * Q * Q;
  for (int tile = warp; tile < (QM / 16) * NJ; tile += kPrepThreads / 32) {
    const int m0 = (tile / NJ) * 16, n0 = (tile % NJ) * 8;
    if (n0 > m0 + 15) continue;  // wholly above the diagonal: never read
    // the sum over N in slabs of 64, each from zero, added in f32
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < NK; k0 += 64) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = k0; kk < min(NK, k0 + 64); kk += 8) {
        AFrag fa;
        BFrag fb;
        a_rows(sC + m0 * ld + kk, ld, g, t, fa);
        b_cols(sB + n0 * ld + kk, ld, g, t, fb);
        mma3(acc, fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] += acc[e];
    }
    const int i = m0 + g, j = n0 + 2 * t;
    if (i < Q) *reinterpret_cast<float2*>(o + i * Q + j) =
        make_float2(sum[0], sum[1]);
    if (i + 8 < Q) *reinterpret_cast<float2*>(o + (i + 8) * Q + j) =
        make_float2(sum[2], sum[3]);
  }
}

// ---- 2. the reverse walk over the chunks ----------------------------------
// A block of W warps over W tiles of 16 rows of one head's G and NB
// columns. One stage of the ring: C (Q x NB) of the chunk, shared by the
// block's warps; dY (Q x 16) of each warp's rows, side by side; the
// head's e^cum_i (Q), e^cum_Q and padding.
template <int NB>
__host__ __device__ constexpr int walk_ldc() {
  return NB + 8 < 24 ? 24 : NB + 8;
}
template <int Q, int NB>
__host__ __device__ constexpr int walk_stage_floats(int W) {
  return Q * walk_ldc<NB>() + Q * (16 * W + 8) + dec_floats<Q>();
}
// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Grid (BH, N / NB, the row tiles / W).
template <int Q, int NB>
__global__ void __launch_bounds__(128, 1)
    ssd_scan_bwd_state_kernel(const float* __restrict__ dec,
                              const float* __restrict__ c,
                              const float* __restrict__ dy,
                              const float* __restrict__ dh,
                              float* __restrict__ gstates, int S, int P,
                              int N, int R, int stages) {
  constexpr int NT = NB / 8;   // column tiles a warp
  constexpr int KS = Q / 8;    // k-steps a chunk
  // the chunk's product in KP partial sums over consecutive k-steps, so
  // that 8 accumulators (NT x KP) are in flight: a narrow tile's chain of
  // dependent mma is cut short
  constexpr int KP = KS < 8 / NT ? KS : (NT >= 8 ? 1 : 8 / NT);
  constexpr int LDC = walk_ldc<NB>();
  constexpr int DF = dec_floats<Q>();
  extern __shared__ float walk_smem[];
  const int W = blockDim.x / 32;
  const int LDY = 16 * W + 8;  // = 8 (mod 32) for W = 1, 2, 4
  const int SF = walk_stage_floats<Q, NB>(W);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, n0 = blockIdx.y * NB;
  const int p0 = 16 * (blockIdx.z * W + warp);  // the warp's rows
  const bool active = p0 < P;
  const int nc = S / Q;
  const float* dyb = dy + static_cast<int64_t>(bh) * S * P + p0;
  const float* cb = c + static_cast<int64_t>(bh / R) * S * N + n0;
  const float* db = dec + static_cast<int64_t>(bh) * nc * DF;
  float* gb = gstates + static_cast<int64_t>(bh) * nc * P * N;
  const int ncols = min(NB, N - n0), nrows = active ? min(16, P - p0) : 0;

  // chunk kc's tiles into stage st, and a commit group (an empty one past
  // the first chunk, so that every iteration commits one): C by the
  // block, each warp's dY by the warp, the decays by warp 0
  auto issue = [&](int kc, float* st) {
    if (kc >= 0) {
      stage(st, LDC, cb + static_cast<int64_t>(kc) * Q * N, N,
            Q, ncols, Q, NB, tid, blockDim.x);
      stage(st + Q * LDC + 16 * warp, LDY,
            dyb + static_cast<int64_t>(kc) * Q * P, P, Q, nrows, Q, 16, lane,
            32);
      if (warp == 0)
        stage(st + Q * LDC + Q * LDY, DF, db + static_cast<int64_t>(kc) * DF,
              DF, 1, DF, 1, DF, lane, 32);
    }
    cp_async_commit();
  };

  // G in the accumulator's layout: rows p0 + g (+8), columns n0 + 8j + 2t (+1)
  float G[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
      G[j][e] = dh != nullptr && p < P && n < N
                    ? dh[(static_cast<int64_t>(bh) * P + p) * N + n]
                    : 0.0f;
    }

  // the ring: chunks nc - 1, nc - 2, ... in stages 0, 1, ...
  for (int s = 0; s < stages - 1; ++s) issue(nc - 1 - s, walk_smem + s * SF);
  for (int kc = nc - 1, it = 0; kc >= 0; --kc, ++it) {
    float* st = walk_smem + (it % stages) * SF;
    cp_async_wait(stages - 2);
    __syncthreads();  // chunk kc is in; the stage read last is free
    issue(kc - (stages - 1), walk_smem + ((it + stages - 1) % stages) * SF);
    if (active) {
      // G_c, the gradient of the state leaving chunk kc
      float* gk = gb + static_cast<int64_t>(kc) * P * N;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h, n = n0 + 8 * j + 2 * t;
          if (p >= P) continue;
          if (n + 1 < N && N % 2 == 0) {
            *reinterpret_cast<float2*>(gk + p * N + n) =
                make_float2(G[j][2 * h], G[j][2 * h + 1]);
          } else {
            if (n < N) gk[p * N + n] = G[j][2 * h];
            if (n + 1 < N) gk[p * N + n + 1] = G[j][2 * h + 1];
          }
        }
      // (e^cum dY)^T C of the chunk, from zero: A(p, i) = e^cum_i dy_i(p)
      const float* sC = st;
      const float* sY = st + Q * LDC + 16 * warp;
      const float* sEc = st + Q * LDC + Q * LDY;
      float acc[KP][NT][4];
#pragma unroll
      for (int q = 0; q < KP; ++q)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          acc[q][j][0] = acc[q][j][1] = acc[q][j][2] = acc[q][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int i0 = 8 * kk + t;
        const float e0 = sEc[i0], e1 = sEc[i0 + 4];
        AFrag fa;
        split(e0 * sY[i0 * LDY + g], fa.h[0], fa.l[0]);
        split(e0 * sY[i0 * LDY + g + 8], fa.h[1], fa.l[1]);
        split(e1 * sY[(i0 + 4) * LDY + g], fa.h[2], fa.l[2]);
        split(e1 * sY[(i0 + 4) * LDY + g + 8], fa.h[3], fa.l[3]);
        // the k-step's fragments of C first, then its three products for
        // every column tile, the small terms first
        BFrag fb[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          b_rows(sC + 8 * kk * LDC + 8 * j, LDC, g, t, fb[j]);
        float (&ak)[NT][4] = acc[kk / (KS / KP)];
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(ak[j], fa.l, fb[j].h[0], fb[j].h[1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(ak[j], fa.h, fb[j].l[0], fb[j].l[1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(ak[j], fa.h, fb[j].h[0], fb[j].h[1]);
      }
      // G <- e^cum_Q G + the chunk's product (its partial sums in order),
      // in f32
      const float last = sEc[Q];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = acc[0][j][e];
#pragma unroll
          for (int q = 1; q < KP; ++q) sum += acc[q][j][e];
          G[j][e] = fmaf(G[j][e], last, sum);
        }
    }
  }
  cp_async_wait(0);
}

// ---- 3. every chunk in parallel --------------------------------------------
// A warp's share of a Q x (8 NT8) output of 16 x 8 tiles: WM row tiles
// (two, r and MT - 1 - r, where it has two or more tiles and there are two
// row tiles: the causal products' work is then alike for all warps) by WN
// column tiles; the first kBusy warps have one.
template <int MT, int NT8>
struct Items {
  static constexpr int kTiles = MT * NT8;
  static constexpr int kPer = kTiles >= kWarps ? kTiles / kWarps : 1;
  static constexpr int WM = kPer >= 2 && MT >= 2 ? 2 : 1;
  static constexpr int WN = kPer / WM;
  static constexpr int NG = NT8 / WN;  // column groups
  static constexpr int kBusy = (WM == 2 ? MT / 2 : MT) * NG;
  __device__ static void of(int w, int (&m)[WM], int& n0) {
    m[0] = w / NG;
    if (WM == 2) m[WM - 1] = MT - 1 - w / NG;
    n0 = (w % NG) * WN;
  }
};

// acc[a][b] = sum over k-steps kk in [kb[a], ke[a]) of A(row tile m[a]) B(
// column tile n0 + b), split TF32, from zero; la(m, kk, AFrag&) and
// lb(kk, n, BFrag&) load the fragments; column tiles >= nlive are skipped,
// and with `lower` the tiles wholly above the diagonal (8 n > 16 m + 15)
template <int WM, int WN, typename LA, typename LB>
__device__ __forceinline__ void product(float (&acc)[WM][WN][4],
                                        const int (&m)[WM], int n0,
                                        int nlive, const int (&kb)[WM],
                                        const int (&ke)[WM], LA la, LB lb,
                                        bool lower = false) {
  int lo = kb[0], hi = ke[0];
#pragma unroll
  for (int i = 1; i < WM; ++i) {
    lo = min(lo, kb[i]);
    hi = max(hi, ke[i]);
  }
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
#pragma unroll 1
  for (int kk = lo; kk < hi; ++kk) {
    AFrag fa[WM];
#pragma unroll
    for (int i = 0; i < WM; ++i)
      if (kk >= kb[i] && kk < ke[i]) la(m[i], kk, fa[i]);
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      if (n0 + j >= nlive) continue;
      BFrag fb;
      lb(kk, n0 + j, fb);
#pragma unroll
      for (int i = 0; i < WM; ++i)
        if (kk >= kb[i] && kk < ke[i] &&
            !(lower && n0 + j > 2 * m[i] + 1))
          mma3(acc[i][j], fa[i], fb);
    }
  }
}

// The shared tiles of a chunk block (floats after QM doubles of cum)
template <int Q, int NW>
struct ChunkPlan {
  static constexpr int QM = Q < 16 ? 16 : Q;
  static constexpr int MT = QM / 16;
  static constexpr int LDP = kMaxP + 4;  // dY, U: = 4 (mod 32)
  static constexpr int LDX = QM + 4;     // M, T
  static constexpr int LDB = NW + 4;     // B slab
  static constexpr int LDC = NW + 8;     // C slab, H_c / G_c slab
  static constexpr int kDy = 0;                       // QM x LDP: dy (i, p)
  static constexpr int kU = kDy + QM * LDP;           // QM x LDP: x dt (j, p)
  static constexpr int kM = kU + QM * LDP;            // QM x LDX: M2, M1^T
  static constexpr int kB = kM + QM * LDX;            // QM x LDB: b (j, n)
  static constexpr int kC = kB + QM * LDB;            // QM x LDC: c (i, n); T
  static constexpr int kHG = kC + cmax(QM * LDC, QM * LDX);  // 64 x LDC
  static constexpr int kD1 = kHG + kMaxP * LDC;       // QM: M1's diagonal
  static constexpr int kDt = kD1 + QM;                // QM: dt
  static constexpr int kP1 = kDt + QM;                // QM: c . (H^T dy)
  static constexpr int kW = kP1 + QM;                 // QM: W_j
  static constexpr int kXdu = kW + QM;                // QM: x_j . du_j
  static constexpr int kA = kXdu + QM;                // QM: T's terms of d da
  static constexpr int kPart = kA + QM;               // 2 x 8 x QM: row sums
  static constexpr int kRed = kPart + 2 * kWarps * QM;  // 8: <G, H> a warp
  static constexpr int kFloats = kRed + kWarps;
  static constexpr size_t kBytes =
      QM * sizeof(double) + kFloats * sizeof(float);
};

template <int Q, int NW>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_bwd_chunk_kernel(
        const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a, const float* __restrict__ cbt,
        const float* __restrict__ b, const float* __restrict__ c,
        const float* __restrict__ states, const float* __restrict__ gstates,
        const float* __restrict__ dy, float* __restrict__ dx,
        float* __restrict__ ddt, float* __restrict__ dbo,
        float* __restrict__ dco, float* __restrict__ dapart, int S, int P,
        int N, int R) {
  using Pl = ChunkPlan<Q, NW>;
  constexpr int QM = Pl::QM, MT = Pl::MT, Q8 = Q / 8;
  constexpr int LDP = Pl::LDP, LDX = Pl::LDX, LDB = Pl::LDB, LDC = Pl::LDC;
  using IQ = Items<MT, 2 * MT>;    // Q x Q (lower tiles)
  using IP = Items<MT, 8>;         // Q x P (P to 64)
  using IN = Items<MT, NW / 8>;    // Q x a slab of N
  extern __shared__ double smem_d[];
  double* sCum = smem_d;
  float* f = reinterpret_cast<float*>(smem_d + QM);
  float* sDy = f + Pl::kDy;
  float* sU = f + Pl::kU;
  float* sM = f + Pl::kM;
  float* sB = f + Pl::kB;
  float* sC = f + Pl::kC;
  float* sT = f + Pl::kC;
  float* sHG = f + Pl::kHG;
  float* sD1 = f + Pl::kD1;
  float* sDt = f + Pl::kDt;
  float* sP1 = f + Pl::kP1;
  float* sW = f + Pl::kW;
  float* sXdu = f + Pl::kXdu;
  float* sA = f + Pl::kA;
  float* sPart = f + Pl::kPart;
  float* sRed = f + Pl::kRed;

  const int nc = S / Q;
  const int bh = blockIdx.x / nc, k = blockIdx.x - bh * nc;
  const int s0 = k * Q, row = bh / R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float av = a[bh];
  const int64_t xoff = (static_cast<int64_t>(bh) * S + s0) * P;
  const int64_t boff = (static_cast<int64_t>(row) * S + s0) * N;
  const float* dtb = dt + static_cast<int64_t>(bh) * S + s0;
  const int64_t hoff = (static_cast<int64_t>(bh) * nc + k) * P * N;
  const int kP = (P + 7) / 8;  // k-steps (and column tiles) over P

  // ---- stage (cp.async, one wait): dy, x, the row's C B^T (in T's place),
  // b's and H_c's first slab; then x dt in place, cum
  stage(sDy, LDP, dy + xoff, P, Q, P, QM, kMaxP, tid, kThreads);
  stage(sU, LDP, x + xoff, P, Q, P, QM, kMaxP, tid, kThreads);
  stage(sT, LDX, cbt + (static_cast<int64_t>(row) * nc + k) * Q * Q, Q, Q,
        Q, QM, QM, tid, kThreads);
  stage(sB, LDB, b + boff, N, Q, min(N, NW), QM, NW, tid, kThreads);
  stage(sHG, LDC, states + hoff, N, P, min(N, NW), kMaxP, NW, tid,
        kThreads);
  cp_async_commit();
  if (warp == 0) chunk_cumsum<Q>(dtb, av, sDt, sCum, lane);
  cp_async_wait_all();
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < QM * kMaxP; e += kThreads) {
    const int i = e >> 6, p = e & (kMaxP - 1);
    sU[i * LDP + p] = i < Q ? sU[i * LDP + p] * sDt[i] : 0.0f;
  }
  __syncthreads();

  // ---- dY U^T on the lower tiles; L, M1, M2 and T
  {
    int m[IQ::WM], n0;
    IQ::of(warp, m, n0);
    if (warp < IQ::kBusy) {
      float acc[IQ::WM][IQ::WN][4];
      int kb[IQ::WM], ke[IQ::WM];
#pragma unroll
      for (int i = 0; i < IQ::WM; ++i) kb[i] = 0, ke[i] = kP;
      // column tile n of row tile r is kept where 8 n <= 16 r + 15
      product(acc, m, n0, 2 * MT, kb, ke,
              [&](int r, int kk, AFrag& fa) {
                a_rows(sDy + 16 * r * LDP + 8 * kk, LDP, g, t, fa);
              },
              [&](int kk, int n, BFrag& fb) {
                b_cols(sU + 8 * n * LDP + 8 * kk, LDP, g, t, fb);
              },
              true);
#pragma unroll
      for (int ia = 0; ia < IQ::WM; ++ia)
#pragma unroll
        for (int jb = 0; jb < IQ::WN; ++jb) {
          const int n = n0 + jb;
          if (n > 2 * m[ia] + 1) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * m[ia] + g + 8 * (e >> 1);
            const int j = 8 * n + 2 * t + (e & 1);
            const bool keep = j <= i && i < Q;
            // the exponent selected to -inf above the diagonal, then the exp
            const float l = expf(
                keep ? static_cast<float>(sCum[i] - sCum[j]) : -INFINITY);
            const float dut = acc[ia][jb][e];
            // C B^T (i, j), staged where T goes: read, then overwritten
            const float m1 = (keep ? sT[i * LDX + j] : 0.0f) * l;
            const float m2 = dut * l;
            if (j <= i) {
              sM[i * LDX + j] = m2;
              sT[i * LDX + j] = m1 * dut;
            }
            if (j < i) sM[j * LDX + i] = m1;
            if (j == i) sD1[i] = m1;
          }
        }
    }
  }
  __syncthreads();
  // the Q x Q terms of d da_k, T over rows i >= k and columns j < k: each
  // row's exclusive prefix sums in place, T_ik <- sum_{j < k} T_ij, then
  // each column's sum over i >= k, both in index order, eight loads at a
  // time (a row's prefix runs to its block of eight past the diagonal:
  // those places are never read)
  if (tid < Q) {
    float s = 0.0f;
    float* row_t = sT + tid * LDX;
    for (int j0 = 0; j0 <= tid; j0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = row_t[j0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        row_t[j0 + u] = s;
        s += v[u];
      }
    }
  }
  __syncthreads();
  if (tid < Q) {
    float s = 0.0f;
    for (int i0 = Q - 8; i0 + 7 >= tid; i0 -= 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = sT[(i0 + u) * LDX + tid];
#pragma unroll
      for (int u = 7; u >= 0; --u)
        if (i0 + u >= tid) s += v[u];
    }
    sA[tid] = s;
  }
  __syncthreads();  // T's place is free for C

  // ---- the slabs of N
  int mp[IP::WM], np0;
  IP::of(warp, mp, np0);
  int mn[IN::WM], nn0;
  IN::of(warp, mn, nn0);
  float gbt[IP::WM][IP::WN][4];  // G_c B^T, (j, p), over the slabs
#pragma unroll
  for (int i = 0; i < IP::WM; ++i)
#pragma unroll
    for (int j = 0; j < IP::WN; ++j)
      gbt[i][j][0] = gbt[i][j][1] = gbt[i][j][2] = gbt[i][j][3] = 0.0f;
  float gh = 0.0f;  // this thread's share of <G_c, H_c>
  int kbN[IN::WM], keN[IN::WM];   // k-steps of the K = P products
#pragma unroll
  for (int i = 0; i < IN::WM; ++i) kbN[i] = 0, keN[i] = kP;
  const int nslab = (N + NW - 1) / NW;
  for (int sl = 0; sl < nslab; ++sl) {
    const int c0 = sl * NW, width = min(NW, N - c0);
    const int nlive = (width + 7) / 8;
    if (sl > 0) {
      stage(sB, LDB, b + boff + c0, N, Q, width, QM, NW, tid, kThreads);
      stage(sHG, LDC, states + hoff + c0, N, P, width, kMaxP, NW, tid,
            kThreads);
    }
    stage(sC, LDC, c + boff + c0, N, Q, width, QM, NW, tid, kThreads);
    cp_async_commit();
    if (sl > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    // dc_i = e^cum_i H_c^T dy_i + sum_{j <= i} M2_ij b_j, and c_i . H_c^T dy_i
    float dch[IN::WM][IN::WN][4], mb[IN::WM][IN::WN][4];
    if (warp < IN::kBusy) {
      product(dch, mn, nn0, nlive, kbN, keN,
              [&](int r, int kk, AFrag& fa) {
                a_rows(sDy + 16 * r * LDP + 8 * kk, LDP, g, t, fa);
              },
              [&](int kk, int n, BFrag& fb) {
                b_rows(sHG + 8 * kk * LDC + 8 * n, LDC, g, t, fb);
              });
      int kb[IN::WM], ke[IN::WM];
#pragma unroll
      for (int i = 0; i < IN::WM; ++i)
        kb[i] = 0, ke[i] = min(2 * mn[i] + 2, Q8);
      product(mb, mn, nn0, nlive, kb, ke,
              [&](int r, int kk, AFrag& fa) {
                // M2 (i, j), zero above the diagonal
                if (kk < 2 * r) {
                  a_rows(sM + 16 * r * LDX + 8 * kk, LDX, g, t, fa);
                  return;
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int i = 16 * r + g + 8 * (e & 1);
                  const int j = 8 * kk + t + 4 * (e >> 1);
                  split(j <= i ? sM[i * LDX + j] : 0.0f, fa.h[e], fa.l[e]);
                }
              },
              [&](int kk, int n, BFrag& fb) {
                b_rows(sB + 8 * kk * LDB + 8 * n, LDB, g, t, fb);
              });
    }
    if (sl == 0) {
      cp_async_wait_all();
      __syncthreads();  // C's first slab is in
    }
    if (warp < IN::kBusy) {
      float* dcb = dco + (static_cast<int64_t>(bh) * S + s0) * N + c0;
#pragma unroll
      for (int ia = 0; ia < IN::WM; ++ia)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mn[ia] + g + 8 * h;
          const float ec =
              i < Q ? expf(static_cast<float>(sCum[i])) : 0.0f;
          float part = 0.0f;
#pragma unroll
          for (int jb = 0; jb < IN::WN; ++jb) {
            const int n = 8 * (nn0 + jb) + 2 * t;
            const float v0 = dch[ia][jb][2 * h], v1 = dch[ia][jb][2 * h + 1];
            part = fmaf(sC[i * LDC + n], v0, part);
            part = fmaf(sC[i * LDC + n + 1], v1, part);
            const float d0 = ec * v0 + mb[ia][jb][2 * h];
            const float d1 = ec * v1 + mb[ia][jb][2 * h + 1];
            if (i < Q && n < width) {
              if (n + 1 < width && N % 2 == 0) {
                __stcs(reinterpret_cast<float2*>(dcb + i * N + n),
                       make_float2(d0, d1));
              } else {
                dcb[i * N + n] = d0;
                if (n + 1 < width) dcb[i * N + n + 1] = d1;
              }
            }
          }
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          if (t == 0) sPart[(warp % IN::NG) * QM + i] = part;
        }
    }
    __syncthreads();  // the row sums are in; H_c's slab is read no more
    if (tid < QM) {
      float s = 0.0f;
      for (int q = 0; q < IN::NG; ++q) s += sPart[q * QM + tid];
      sP1[tid] = sl == 0 ? s : sP1[tid] + s;
    }
    // G_c's slab in place of H_c's, <G_c, H_c> on the way
    {
      const float* Gs = gstates + hoff + c0;
#pragma unroll 16
      for (int e = tid; e < kMaxP * NW; e += kThreads) {
        const int p = e / NW, n = e - (e / NW) * NW;
        const float gv = p < P && n < width ? __ldcs(Gs + p * N + n) : 0.0f;
        gh = fmaf(sHG[p * LDC + n], gv, gh);
        sHG[p * LDC + n] = gv;
      }
    }
    __syncthreads();
    // G_c b_j over the slab's columns (Q x P), from zero, added in f32
    if (warp < IP::kBusy) {
      float tl[IP::WM][IP::WN][4];
      int kb[IP::WM], ke[IP::WM];
#pragma unroll
      for (int i = 0; i < IP::WM; ++i) kb[i] = 0, ke[i] = nlive;
      product(tl, mp, np0, kP, kb, ke,
              [&](int r, int kk, AFrag& fa) {
                a_rows(sB + 16 * r * LDB + 8 * kk, LDB, g, t, fa);
              },
              [&](int kk, int n, BFrag& fb) {
                b_cols(sHG + 8 * n * LDC + 8 * kk, LDC, g, t, fb);
              });
#pragma unroll
      for (int i = 0; i < IP::WM; ++i)
#pragma unroll
        for (int j = 0; j < IP::WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gbt[i][j][e] += tl[i][j][e];
    }
    // db_j = e^(cum_Q - cum_j) G_c^T u_j + sum_{i >= j} M2_ij c_i
    if (warp < IN::kBusy) {
      float ug[IN::WM][IN::WN][4], mc[IN::WM][IN::WN][4];
      product(ug, mn, nn0, nlive, kbN, keN,
              [&](int r, int kk, AFrag& fa) {
                a_rows(sU + 16 * r * LDP + 8 * kk, LDP, g, t, fa);
              },
              [&](int kk, int n, BFrag& fb) {
                b_rows(sHG + 8 * kk * LDC + 8 * n, LDC, g, t, fb);
              });
      int kb[IN::WM], ke[IN::WM];
#pragma unroll
      for (int i = 0; i < IN::WM; ++i) kb[i] = 2 * mn[i], ke[i] = Q8;
      product(mc, mn, nn0, nlive, kb, ke,
              [&](int r, int kk, AFrag& fa) {
                // A(j, i) = M2 (i, j), zero where i < j
                if (kk > 2 * r + 1) {
                  a_cols(sM + 8 * kk * LDX + 16 * r, LDX, g, t, fa);
                  return;
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int j = 16 * r + g + 8 * (e & 1);
                  const int i = 8 * kk + t + 4 * (e >> 1);
                  split(i >= j ? sM[i * LDX + j] : 0.0f, fa.h[e], fa.l[e]);
                }
              },
              [&](int kk, int n, BFrag& fb) {
                b_rows(sC + 8 * kk * LDC + 8 * n, LDC, g, t, fb);
              });
      float* dbb = dbo + (static_cast<int64_t>(bh) * S + s0) * N + c0;
#pragma unroll
      for (int ia = 0; ia < IN::WM; ++ia)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 16 * mn[ia] + g + 8 * h;
          if (j >= Q) continue;
          const float eq = expf(static_cast<float>(sCum[Q - 1] - sCum[j]));
#pragma unroll
          for (int jb = 0; jb < IN::WN; ++jb) {
            const int n = 8 * (nn0 + jb) + 2 * t;
            if (n >= width) continue;
            const float d0 = eq * ug[ia][jb][2 * h] + mc[ia][jb][2 * h];
            const float d1 =
                eq * ug[ia][jb][2 * h + 1] + mc[ia][jb][2 * h + 1];
            if (n + 1 < width && N % 2 == 0) {
              __stcs(reinterpret_cast<float2*>(dbb + j * N + n),
                     make_float2(d0, d1));
            } else {
              dbb[j * N + n] = d0;
              if (n + 1 < width) dbb[j * N + n + 1] = d1;
            }
          }
        }
    }
    __syncthreads();  // the slab's B, C and G_c are read no more
  }

  // ---- du_j = e^(cum_Q - cum_j) G_c b_j + sum_{i >= j} M1_ij dy_i; W_j,
  // dx, x_j . du_j
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
  if (lane == 0) sRed[warp] = gh;
  if (warp < IP::kBusy) {
    float md[IP::WM][IP::WN][4];
    int kb[IP::WM], ke[IP::WM];
#pragma unroll
    for (int i = 0; i < IP::WM; ++i) kb[i] = 2 * mp[i], ke[i] = Q8;
    product(md, mp, np0, kP, kb, ke,
            [&](int r, int kk, AFrag& fa) {
              // A(j, i) = M1 (i, j), zero where i < j
              if (kk > 2 * r + 1) {
                a_rows(sM + 16 * r * LDX + 8 * kk, LDX, g, t, fa);
                return;
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = 16 * r + g + 8 * (e & 1);
                const int i = 8 * kk + t + 4 * (e >> 1);
                const float v = i > j    ? sM[j * LDX + i]
                                : i == j ? sD1[j]
                                         : 0.0f;
                split(v, fa.h[e], fa.l[e]);
              }
            },
            [&](int kk, int n, BFrag& fb) {
              b_rows(sDy + 8 * kk * LDP + 8 * n, LDP, g, t, fb);
            });
#pragma unroll
    for (int ia = 0; ia < IP::WM; ++ia)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * mp[ia] + g + 8 * h;
        const float eq =
            j < Q ? expf(static_cast<float>(sCum[Q - 1] - sCum[j])) : 0.0f;
        float wpart = 0.0f, xpart = 0.0f;
#pragma unroll
        for (int jb = 0; jb < IP::WN; ++jb) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int p = 8 * (np0 + jb) + 2 * t + q;
            const float gv = gbt[ia][jb][2 * h + q];
            wpart = fmaf(sU[j * LDP + p], gv, wpart);
            const float du = eq * gv + md[ia][jb][2 * h + q];
            if (j < Q && p < P) {
              xpart = fmaf(x[xoff + j * P + p], du, xpart);
              dx[xoff + j * P + p] = sDt[j] * du;
            }
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          wpart += __shfl_xor_sync(0xffffffffu, wpart, o);
          xpart += __shfl_xor_sync(0xffffffffu, xpart, o);
        }
        if (t == 0) {
          sPart[(warp % IP::NG) * QM + j] = eq * wpart;
          sPart[(kWarps + warp % IP::NG) * QM + j] = xpart;
        }
      }
  }
  __syncthreads();
  if (tid < QM) {
    float w = 0.0f, xd = 0.0f;
    for (int q = 0; q < IP::NG; ++q) {
      w += sPart[q * QM + tid];
      xd += sPart[(kWarps + q) * QM + tid];
    }
    sW[tid] = w;
    sXdu[tid] = xd;
    if (tid < Q) sP1[tid] *= expf(static_cast<float>(sCum[tid]));
  }
  __syncthreads();

  // ---- d da, ddt and the chunk's share of da: the sums over the chunk's
  // steps by one thread in step order, the rest a thread a step
  if (tid == 0) {
    float ghs = 0.0f;
    for (int w = 0; w < kWarps; ++w) ghs += sRed[w];
    sRed[0] = ghs * expf(static_cast<float>(sCum[Q - 1]));
    // W's prefix sums, in place: sW[k] <- sum_{j < k} W_j
    float w = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float wj = sW[j];
      sW[j] = w;
      w += wj;
    }
    // the entering terms' suffix sums, in place: sP1[k] <- sum_{i >= k}
    float p1 = 0.0f;
    for (int i = Q - 1; i >= 0; --i) {
      p1 += sP1[i];
      sP1[i] = p1;
    }
  }
  __syncthreads();
  if (tid < Q) {
    const float dda = sP1[tid] + sA[tid] + sW[tid] + sRed[0];
    ddt[static_cast<int64_t>(bh) * S + s0 + tid] = sXdu[tid] + av * dda;
    sA[tid] = dda;
  }
  __syncthreads();
  if (tid == 0) {
    float dap = 0.0f;
    for (int i = Q - 1; i >= 0; --i) dap = fmaf(sDt[i], sA[i], dap);
    dapart[static_cast<int64_t>(bh) * nc + k] = dap;
  }
}

// ---- 4. db and dc of a row: its R heads' partials in head order ---------
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

// ---- 5. da of a head: its chunks' shares in chunk order -----------------
__global__ void __launch_bounds__(kSumThreads)
    ssd_scan_bwd_sum_chunks_kernel(const float* __restrict__ dapart,
                                   float* __restrict__ da, int BH, int nc) {
  const int bh = blockIdx.x * kSumThreads + threadIdx.x;
  if (bh >= BH) return;
  float s = 0.0f;
  for (int k = 0; k < nc; ++k) s += dapart[static_cast<int64_t>(bh) * nc + k];
  da[bh] = s;
}

struct Args {
  const float *x, *dt, *a, *b, *c, *states, *dy, *dh;
  float *dx, *ddt, *da, *db, *dc, *gst, *cbt, *dec, *dbp, *dcp, *dap;
  int BH, S, P, N, R;
};
struct Plan {
  int walk_cols, walk_warps, walk_stages, slab;
};

template <int Q, int NB>
int launch_walk(const Args& A, const Plan& pl, cudaStream_t s) {
  const int W = pl.walk_warps;
  const size_t smem =
      pl.walk_stages * walk_stage_floats<Q, NB>(W) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_state_kernel<Q, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err) return static_cast<int>(err);
  // two blocks of up to 113 KB an SM
  if ((err = cudaFuncSetAttribute(
           ssd_scan_bwd_state_kernel<Q, NB>,
           cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)))
    return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(A.BH),
                  static_cast<unsigned>((A.N + NB - 1) / NB),
                  static_cast<unsigned>((A.P + 16 * W - 1) / (16 * W)));
  ssd_scan_bwd_state_kernel<Q, NB><<<grid, 32 * W, smem, s>>>(
      A.dec, A.c, A.dy, A.dh, A.gst, A.S, A.P, A.N, A.R, pl.walk_stages);
  return static_cast<int>(cudaGetLastError());
}

template <int Q, int NW>
int launch_chunks(const Args& A, float* dbo, float* dco, cudaStream_t s) {
  const size_t smem = ChunkPlan<Q, NW>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_chunk_kernel<Q, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // all of the SM's 228 KB as shared memory: two blocks of 110 KB
  if (!err)
    err = cudaFuncSetAttribute(ssd_scan_bwd_chunk_kernel<Q, NW>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err) return static_cast<int>(err);
  ssd_scan_bwd_chunk_kernel<Q, NW>
      <<<static_cast<unsigned>(A.BH) * static_cast<unsigned>(A.S / Q),
         kThreads, smem, s>>>(A.x, A.dt, A.a, A.cbt, A.b, A.c, A.states,
                              A.gst, A.dy, A.dx, A.ddt, dbo, dco, A.dap, A.S,
                              A.P, A.N, A.R);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch(const Args& A, const Plan& pl, cudaStream_t s) {
  // 1. C B^T of every (row, chunk), and the decays
  const size_t prep_smem = prep_smem_bytes<Q>(A.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_prep_kernel<Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(prep_smem));
  if (err) return static_cast<int>(err);
  ssd_scan_bwd_prep_kernel<Q>
      <<<dim3(static_cast<unsigned>(A.BH / A.R),
              static_cast<unsigned>(A.S / Q)),
         kPrepThreads, prep_smem, s>>>(A.b, A.c, A.dt, A.a, A.cbt, A.dec,
                                       A.S, A.N, A.R);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  // 2. the walk
  int code;
  switch (pl.walk_cols) {
    case 8: code = launch_walk<Q, 8>(A, pl, s); break;
    case 16: code = launch_walk<Q, 16>(A, pl, s); break;
    case 32: code = launch_walk<Q, 32>(A, pl, s); break;
    default: code = launch_walk<Q, 64>(A, pl, s); break;
  }
  if (code) return code;
  // 3. the chunks: per-head db and dc where R heads share a row, the
  // row's own where not
  float* dbo = A.R > 1 ? A.dbp : A.db;
  float* dco = A.R > 1 ? A.dcp : A.dc;
  switch (pl.slab) {
    case 16: code = launch_chunks<Q, 16>(A, dbo, dco, s); break;
    case 32: code = launch_chunks<Q, 32>(A, dbo, dco, s); break;
    default: code = launch_chunks<Q, 64>(A, dbo, dco, s); break;
  }
  if (code) return code;
  // 4. the heads' partials, 5. the chunks' shares of da
  if (A.R > 1) {
    const int64_t total = static_cast<int64_t>(A.BH / A.R) * A.S * A.N;
    ssd_scan_bwd_sum_heads_kernel<<<static_cast<unsigned>(
                                        (total + kSumThreads - 1) /
                                        kSumThreads),
                                    kSumThreads, 0, s>>>(
        A.dbp, A.dcp, A.db, A.dc, static_cast<int64_t>(A.S) * A.N, total,
        A.R);
    if ((err = cudaGetLastError())) return static_cast<int>(err);
  }
  ssd_scan_bwd_sum_chunks_kernel<<<static_cast<unsigned>(
                                       (A.BH + kSumThreads - 1) /
                                       kSumThreads),
                                   kSumThreads, 0, s>>>(A.dap, A.da, A.BH,
                                                        A.S / Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All float32 and contiguous. chunk one of 8, 16, 32, 64, dividing S;
// 1 <= P <= 64, 1 <= N <= 128. x, dy and dx (BH, S, P); dt and ddt (BH, S);
// a and da (BH,); b, c, db and dc (BH / R, S, N); dh (BH, P, N) or null
// (zero); states (BH, S / chunk, P, N), the states entering each chunk as
// repro_ssd_scan writes them. The plan (ssd_scan.bwd_plan): walk_cols, the
// walk's column tile, 8, 16, 32 or 64 (N in ceil(N / walk_cols) blocks);
// walk_warps, 1, 2 or 4, its warps a block (each 16 rows of the state);
// walk_stages, 2 to 8, its ring of chunk tiles; slab, the chunk pass's
// column slab, 16, 32 or 64. walk_cols and slab fix orders of sums, so
// they are functions of N alone.
// Scratch, none of it read before this call writes it: gstates,
// BH * (S / chunk) * P * N; cbt, (BH / R) * (S / chunk) * chunk * chunk;
// dec, BH * (S / chunk) * (chunk + 4); dbp and dcp, BH * S * N each where
// R > 1 (unused, may be null, where R = 1); dapart, BH * (S / chunk). Four
// launches on the stream, five where R > 1; returns the CUDA error code of
// the first that fails (0 = cudaSuccess).
extern "C" int repro_ssd_scan_bwd(int chunk, const void* x, const void* dt,
                                  const void* a, const void* b,
                                  const void* c, const void* states,
                                  const void* dy, const void* dh, void* dx,
                                  void* ddt, void* da, void* db, void* dc,
                                  void* gstates, void* cbt, void* dec,
                                  void* dbp, void* dcp, void* dapart, int BH,
                                  int S, int P, int N, int R, int walk_cols,
                                  int walk_warps, int walk_stages, int slab,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool plan_ok =
      (walk_cols == 8 || walk_cols == 16 || walk_cols == 32 ||
       walk_cols == 64) &&
      (walk_warps == 1 || walk_warps == 2 || walk_warps == 4) &&
      walk_stages >= 2 && walk_stages <= kMaxStages &&
      (slab == 16 || slab == 32 || slab == 64);
  if (chunk < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || R < 1 ||
      BH < 1 || BH % R != 0 || S < chunk || S % chunk != 0 || !plan_ok ||
      (R > 1 && (dbp == nullptr || dcp == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args A{static_cast<const float*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(a),
               static_cast<const float*>(b),
               static_cast<const float*>(c),
               static_cast<const float*>(states),
               static_cast<const float*>(dy),
               static_cast<const float*>(dh),
               static_cast<float*>(dx),
               static_cast<float*>(ddt),
               static_cast<float*>(da),
               static_cast<float*>(db),
               static_cast<float*>(dc),
               static_cast<float*>(gstates),
               static_cast<float*>(cbt),
               static_cast<float*>(dec),
               static_cast<float*>(dbp),
               static_cast<float*>(dcp),
               static_cast<float*>(dapart),
               BH, S, P, N, R};
  const Plan pl{walk_cols, walk_warps, walk_stages, slab};
  switch (chunk) {
    case 8:
      return launch<8>(A, pl, s);
    case 16:
      return launch<16>(A, pl, s);
    case 32:
      return launch<32>(A, pl, s);
    case 64:
      return launch<64>(A, pl, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
