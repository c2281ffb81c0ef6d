// Chunked SSD (state-space duality) scan, Mamba2's core, for Hopper (sm_90a),
// with every chunk product on the tensor cores.
//
//   h_t = exp(dt_t * a) h_{t-1} + dt_t * x_t b_t^T,   y_t = h_t c_t
//
// computed chunk by chunk as Dao & Gu's chunked algorithm does
// (arXiv:2405.21060, section 6). For a chunk of Q steps with
// cum = cumsum(dt * a) inside the chunk:
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
// Design: three launches on one stream, no atomics, a fixed order of
// every sum, so a card gives the same bits on every run.
//   1. ssd_scan_cbt_kernel, grid (BH / R, S / Q), mma.sync: C B^T of one
//      chunk of one group row, (BH / R, S / Q, Q, Q) f32 scratch, formed
//      once and shared by the row's R heads (mamba2-2.7b: 80), where a
//      kernel per head would form it R times; only the causal tiles. It
//      also writes the chunk's B^T split into TF32 hi and lo images, laid
//      out as pass 2's wgmma reads them from shared memory, again once
//      per row.
//   2. ssd_scan_state_kernel, grid (BH, N / 64), one warpgroup: one block
//      per head and 64 state columns walks the chunks in order with its
//      (P, 64) slice of h in wgmma's accumulator. Per chunk it writes the
//      state ENTERING the chunk to a (BH, S / Q, P, N) f32 scratch, then
//      decays h and adds (x dt decay)^T B: A = (x dt decay)^T from
//      registers, B^T from the images (cp.async). Only this rank-Q update
//      is on the sequential chain.
//   3. ssd_scan_out_kernel, grid (BH, S / Q), one warpgroup: one block per
//      chunk, all chunks in parallel: y = (C B^T o L)(x dt) +
//      exp(cum) (C h_in^T). The A operands (C B^T o L, C) come from L2
//      into registers; x dt and h_in are split into hi and lo images in
//      shared memory. L selects 0 above the diagonal BEFORE the exp: there
//      cum_i - cum_j > 0, so exp could overflow and inf * 0 would be NaN.
// Dao & Gu's GPU form splits step 2 into chunk-local states (chunk
// parallel) and a state-passing scan; that moves the (BH, S / Q, P, N)
// states through device memory twice more (about 1.9 GB against 1.2 GB
// at the serving shape), so the state walk here is one ordered pass.
// Each pass recomputes cum = cumsum(dt * a) of its chunk with the same
// warp-shuffle scan, so every pass sees the same bits.
//
// Precision. The tensor cores take f32 only as TF32 (10 mantissa bits),
// and one TF32 product keeps about three digits, short of the f32
// tolerances the port holds this kernel to. So every product is split
// TF32 (3xTF32): v = hi + lo, hi = v rounded to TF32 (cvt.rna's rounding),
// lo = v - hi, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in
// f32 (wgmma m64n64k8 .tf32 in passes 2 and 3, mma.sync m16n8k8 in pass
// 1). An operand exact in TF32 (x, B and C when the inputs are bf16)
// drops its lo term. .tf32 wgmma reads B only K-major, so B^T, x dt and
// h_in are staged with K contiguous (128-byte swizzled rows).
//
// Bound: bytes. The function reads x, dt, B, C once and writes y and h
// once (357 MB at (320, 2048, 64, 128) f32, 0.107 ms at 3.35 TB/s); its
// flops are 24 GFLOP (0.05 ms at 495 TFLOP/s; split TF32 runs ~3x that,
// 0.15 ms). The design's own traffic is the entering-state scratch,
// written once and read once (2 x 335 MB), and x read twice. On the card
// the state walk is bound by its chain (32 chunks, each waiting on its
// loads) and the output pass by load latency at two blocks an SM
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kCbtThreads = 256;    // 8 warps, one 16 x 8 output tile each
constexpr int kStateThreads = 128;  // 1 warpgroup: 64 state columns
constexpr int kOutThreads = 128;    // 1 warpgroup: all of a chunk's y
constexpr int kBatch = 8;           // global loads in flight a thread

// Row strides of the shared tiles, chosen so the fragment loads below hit
// 32 distinct banks: an A operand read as (row g, column t) wants a stride
// of 4 (mod 32), one read as (row t, column g) a stride of 8 (mod 32).
__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int ld_rows4(int cols) {
  return round_up(cols, 32) + 4;
}
__host__ __device__ constexpr int ld_rows8(int cols) {
  return round_up(cols, 32) + 8;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes from global to shared memory without registers, so every copy
// of a tile is in flight at once; the caller waits with cp_async_wait_all
// before its barrier
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
// Four floats into shared memory: f32 by cp.async, bf16 through registers.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void copy4(float* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<float4*>(dst) = load4(src);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copy a rows x cols tile (source row stride sld) into shared memory as
// f32 with row stride ld, zero-filling it out to rpad x cpad (cpad a
// multiple of 4). 16-byte (f32) or 8-byte (bf16) loads where the tile's
// rows allow them.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src, int64_t sld,
                                      int rows, int cols, int rpad, int cpad,
                                      int tid, int nthreads) {
  const bool vec = cols % 4 == 0 && sld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  if (vec) {
    const int c4 = cpad / 4;
#pragma unroll 4
    for (int e = tid; e < rpad * c4; e += nthreads) {
      const int r = e / c4, cc = (e - r * c4) * 4;
      if (r < rows && cc < cols)
        copy4(dst + r * ld + cc, src + r * sld + cc);
      else
        *reinterpret_cast<float4*>(dst + r * ld + cc) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = tid; e < rpad * cpad; e += nthreads) {
      const int r = e / cpad, cc = e - r * cpad;
      dst[r * ld + cc] =
          r < rows && cc < cols ? to_f32(src[r * sld + cc]) : 0.0f;
    }
  }
}

// One warp: dt of one chunk -> sDt[q] = dt_q and sCum[q] = the inclusive
// cumsum of dt * a, a shuffle scan in a fixed order, 32 steps at a time
// with the running total carried over. Returns the chunk's total in every
// lane. Every pass calls this on the same inputs, so all see the same bits.
template <typename T, int Q>
__device__ __forceinline__ float chunk_cumsum(const T* __restrict__ dt,
                                              float av, float* sDt,
                                              float* sCum, int lane) {
  float carry = 0.0f;
#pragma unroll
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int q = q0 + lane;
    const float d = q < Q ? to_f32(dt[q]) : 0.0f;
    float v = q < Q ? d * av : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, v, o);
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

// ---- split TF32 ---------------------------------------------------------------
// v = hi + lo. hi is v rounded to TF32, to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding, done here with two integer operations: the
// conversion instruction issues at a fraction of the integer rate). lo =
// v - hi is exact in f32 and goes to the tensor cores unrounded; they use
// its TF32 part, and what they drop is below 2^-21 |v|. An operand that is
// exact in TF32 (bf16 inputs) keeps lo = 0 and is not split.
template <bool kExact>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in split TF32, the small terms first
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!kExactA) mma(d, al, bh);
  if (!kExactB) mma(d, ah, bl);
  mma(d, ah, bh);
}
// The m16n8k8 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8"), with
// g = lane / 4 and t = lane % 4: A (16 x 8, row) holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds (t, g), (t + 4, g); the
// accumulator (16 x 8) holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). A(r, k) = s[r * ld + k] here, and B(k, n) = s[n * ld + k]
// ("by column") or s[k * ld + n] ("by row").
template <bool kExact>
__device__ __forceinline__ void load_a(const float* s, int ld, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split<kExact>(s[g * ld + t], hi[0], lo[0]);
  split<kExact>(s[(g + 8) * ld + t], hi[1], lo[1]);
  split<kExact>(s[g * ld + t + 4], hi[2], lo[2]);
  split<kExact>(s[(g + 8) * ld + t + 4], hi[3], lo[3]);
}
template <bool kExact>
__device__ __forceinline__ void load_b_by_column(const float* s, int ld,
                                                 int g, int t,
                                                 uint32_t (&hi)[2],
                                                 uint32_t (&lo)[2]) {
  split<kExact>(s[g * ld + t], hi[0], lo[0]);
  split<kExact>(s[g * ld + t + 4], hi[1], lo[1]);
}
template <typename T>
struct Exact {  // x, B and C are exact in TF32 when they come as bf16
  static constexpr bool value = false;
};
template <>
struct Exact<__nv_bfloat16> {
  static constexpr bool value = true;
};

// ---- wgmma (sm_90a) ---------------------------------------------------------
// A B operand of wgmma in shared memory, K-major (the only order .tf32
// takes): boxes of 32 K values (128 bytes a row) by up to 128 rows, the
// 16-byte chunks of row r swizzled by r % 8 (128B swizzle), each box
// 1024-aligned. A k-step of 8 TF32 values is 32 bytes into a row.
constexpr int kBoxRow = 128;  // bytes of one row of a box
__host__ __device__ constexpr int boxes(int k) { return (k + 31) / 32; }
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}
// byte offset of (row r, k) in an operand whose boxes hold `rows` rows
__device__ __forceinline__ uint32_t operand_offset(int r, int k, int rows) {
  return static_cast<uint32_t>(k / 32) * rows * kBoxRow +
         swizzle(static_cast<uint32_t>(r) * kBoxRow + (k % 32) * 4);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// descriptor of the 8 rows x 8 K values at byte `off` of an operand at
// `base`: 128B swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t operand_desc(uint32_t base,
                                                 uint32_t off) {
  const uint32_t addr = base + off;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// k-step kk (8 K values) of an operand whose boxes hold `rows` rows,
// starting at row `row0` (a multiple of 8)
__device__ __forceinline__ uint64_t kstep_desc(uint32_t base, int kk,
                                               int rows, int row0) {
  return operand_desc(base, static_cast<uint32_t>(kk / 4) * rows * kBoxRow +
                                static_cast<uint32_t>(row0) * kBoxRow +
                                (kk % 4) * 32);
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers in program order: an accumulator is not read, and an A
// fragment not reused, before the wait above it
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
// d (64 x 64, f32) += A (64 x 8 TF32, registers: a warp's 16 rows as in
// mma.m16n8k8) . B (8 x 64 TF32, shared memory, K-major)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d += a b in split TF32 on wgmma, the small terms first: a_lo b_hi,
// a_hi b_lo, a_hi b_hi (an exact operand drops its lo term)
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void wgmma3(float* d, const uint32_t* ah,
                                       const uint32_t* al, uint64_t bh,
                                       uint64_t bl) {
  if (!kExactA) wgmma_tf32(d, al, bh);
  if (!kExactB) wgmma_tf32(d, ah, bl);
  wgmma_tf32(d, ah, bh);
}
// an A fragment of wgmma (and mma.m16n8k8) from values v(r, k): warp w
// of the warpgroup holds rows 16w + g (+8), columns t (+4) of the k-step
template <bool kExact, typename F>
__device__ __forceinline__ void a_fragment(F v, int r0, int k0, int g, int t,
                                           uint32_t* hi, uint32_t* lo) {
  split<kExact>(v(r0 + g, k0 + t), hi[0], lo[0]);
  split<kExact>(v(r0 + g + 8, k0 + t), hi[1], lo[1]);
  split<kExact>(v(r0 + g, k0 + t + 4), hi[2], lo[2]);
  split<kExact>(v(r0 + g + 8, k0 + t + 4), hi[3], lo[3]);
}
// four consecutive K values of one row of a B operand, split into the hi
// and lo images (16 bytes each)
template <bool kExact>
__device__ __forceinline__ void store_split4(uint8_t* hi, uint8_t* lo,
                                             uint32_t off, const float* v) {
  uint4 h, l;
  split<kExact>(v[0], h.x, l.x);
  split<kExact>(v[1], h.y, l.y);
  split<kExact>(v[2], h.z, l.z);
  split<kExact>(v[3], h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  if (!kExact) *reinterpret_cast<uint4*>(lo + off) = l;
}

// ---- pass 1: C B^T per (group row, chunk), and B^T as pass 2 reads it ---
template <int Q>
size_t cbt_smem_floats(int N) {
  const int ld = ld_rows4(round_up(N, 8));
  return static_cast<size_t>(round_up(Q, 16) + Q) * ld;
}
constexpr int kImgRows = 128;                  // rows (n) of a B^T image box
constexpr int kImgBox = kImgRows * kBoxRow;    // bytes of one such box

template <typename T, int Q>
__global__ void __launch_bounds__(kCbtThreads)
    ssd_scan_cbt_kernel(const T* __restrict__ b, const T* __restrict__ c,
                        float* __restrict__ cbt, uint8_t* __restrict__ bt,
                        int S, int N) {
  constexpr int QM = Q < 16 ? 16 : Q;  // rows padded to whole m-tiles
  constexpr int QB = boxes(Q);
  constexpr bool kX = Exact<T>::value;
  const int NK = round_up(N, 8);
  const int ld = ld_rows4(NK);
  extern __shared__ float smem[];
  float* sC = smem;          // QM x ld: C (i, n)
  float* sB = sC + QM * ld;  // Q x ld: B (j, n)
  const int row = blockIdx.x, k = blockIdx.y, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t off = (static_cast<int64_t>(row) * S + k * Q) * N;
  stage(sC, ld, c + off, N, Q, N, QM, NK, tid, kCbtThreads);
  stage(sB, ld, b + off, N, Q, N, Q, NK, tid, kCbtThreads);
  cp_async_wait_all();
  __syncthreads();
  float* out = cbt + (static_cast<int64_t>(row) * nc + k) * Q * Q;
  constexpr int NT = Q / 8;
  for (int tile = warp; tile < (QM / 16) * NT; tile += kCbtThreads / 32) {
    const int m0 = (tile / NT) * 16, n0 = (tile % NT) * 8;
    if (n0 > m0 + 15) continue;  // wholly above the diagonal: never read
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < NK; k0 += 8) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      load_a<kX>(sC + m0 * ld + k0, ld, g, t, ah, al);
      load_b_by_column<kX>(sB + n0 * ld + k0, ld, g, t, bh, bl);
      mma3<kX, kX>(acc, ah, al, bh, bl);
    }
    const int i = m0 + g, j = n0 + 2 * t;
    if (i < Q) store2(out + i * Q + j, acc[0], acc[1]);
    if (i + 8 < Q) store2(out + (i + 8) * Q + j, acc[2], acc[3]);
  }
  // B^T of the chunk, split and swizzled as pass 2's wgmma reads it: rows
  // n (zero past N), K = the chunk's steps; the hi image, then the lo one
  // (not written when B is exact in TF32). One 16-byte slot a thread.
  uint8_t* img = bt + (static_cast<int64_t>(row) * nc + k) * 2 * QB * kImgBox;
  for (int e = tid; e < QB * kImgBox / 16; e += kCbtThreads) {
    const int box = e / (kImgBox / 16), r = (e / 8) % kImgRows;
    const int j0 = box * 32 + ((e % 8) ^ (r & 7)) * 4;  // the slot's chunk
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = r < N && j0 + q < Q ? sB[(j0 + q) * ld + r] : 0.0f;
    store_split4<kX>(img, img + QB * kImgBox, 16u * e, v);
  }
}

// ---- pass 2: the ordered state walk, on wgmma ------------------------------
constexpr int kHalfBox = 64 * kBoxRow;         // 64 of its rows

template <int Q>
size_t state_smem_bytes() {
  return 2 * static_cast<size_t>(boxes(Q)) * kHalfBox +
         (static_cast<size_t>(Q) * ld_rows8(kMaxP) + 3 * Q) * sizeof(float) +
         1024;
}

template <typename T, int Q>
__global__ void __launch_bounds__(kStateThreads, 4)
    ssd_scan_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const float* __restrict__ a,
                          const uint8_t* __restrict__ bt,
                          float* __restrict__ states,
                          float* __restrict__ h_out, int S, int P, int N,
                          int R) {
  constexpr bool kX = Exact<T>::value;
  constexpr int QB = boxes(Q), KS = Q / 8;
  constexpr int kImg = QB * kImgBox;   // bytes of the hi (or lo) image
  constexpr int kHalf = QB * kHalfBox;  // of its 64 rows this block reads
  constexpr int ldx = ld_rows8(kMaxP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sImg = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  float* sX = reinterpret_cast<float*>(sImg + 2 * kHalf);  // Q x ldx: x (j, p)
  float* sDt = sX + Q * ldx;   // Q
  float* sCum = sDt + Q;       // Q
  float* sDecay = sCum + Q;    // Q: exp(cum_last - cum)
  __shared__ float sLast;      // exp(cum_last)

  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * 64;  // the block's 64 state columns
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int nc = S / Q;
  const float av = a[bh];
  const T* xb = x + static_cast<int64_t>(bh) * S * P;
  const T* dtb = dt + static_cast<int64_t>(bh) * S;
  const uint8_t* bimg = bt + static_cast<int64_t>(bh / R) * nc * 2 * kImg;
  float* sb = states + static_cast<int64_t>(bh) * nc * P * N;
  const uint32_t base = smem_u32(sImg);

  // the state in the accumulator's layout: h[16w + g (+8)][n0 + 8i + 2t (+1)]
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  auto for_state = [&](auto&& fn) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * w + g + 8 * half, n = n0 + 8 * i + 2 * t;
        if (p < P) fn(p, n, acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
      }
  };
  auto store_state = [&](float* dst) {
    for_state([&](int p, int n, float v0, float v1) {
      float* d = dst + static_cast<int64_t>(p) * N + n;
      if (n + 1 < N && N % 2 == 0) {
        store2(d, v0, v1);
      } else {
        if (n < N) d[0] = v0;
        if (n + 1 < N) d[1] = v1;
      }
    });
  };

  for (int k = 0; k < nc; ++k) {
    const int s0 = k * Q;
    __syncthreads();  // the last chunk's tiles are no longer read
    // rows n0.. of each box of the hi (and lo) image: 8 KB runs
    const uint8_t* src = bimg + static_cast<int64_t>(k) * 2 * kImg +
                         n0 * kBoxRow;
    for (int e = tid; e < (kX ? 1 : 2) * kHalf / 16; e += kStateThreads) {
      const int run = e / (kHalfBox / 16), at = e % (kHalfBox / 16);
      cp_async16(sImg + run * kHalfBox + 16 * at,
                 src + run * kImgBox + 16 * at);
    }
    stage(sX, ldx, xb + static_cast<int64_t>(s0) * P, P, Q, P, Q, kMaxP, tid,
          kStateThreads);
    if (tid < 32) {
      const float total = chunk_cumsum<T, Q>(dtb + s0, av, sDt, sCum, lane);
      __syncwarp();
      for (int q = lane; q < Q; q += 32) sDecay[q] = expf(total - sCum[q]);
      if (lane == 0) sLast = expf(total);
    }
    store_state(sb + static_cast<int64_t>(k) * P * N);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();

    // h <- exp(cum_last) h + (x dt decay)^T B: A(p, j) = (x[j][p] dt_j)
    // decay_j from registers, B^T from the image
    const float last = sLast;
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= last;
    // each k-step's A fragment split into a buffer of two, reused once the
    // wgmma two steps back has finished
    auto wv = [&](int p, int j) { return sX[j * ldx + p] * sDt[j] * sDecay[j]; };
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t* fh = ah[kk & 1];
      uint32_t* fl = al[kk & 1];
      if (kk >= 2) {
        wgmma_wait<1>();
        fence_regs<4>(fh);
        fence_regs<4>(fl);
      }
      a_fragment<false>(wv, 16 * w, 8 * kk, g, t, fh, fl);
      wgmma_fence();
      wgmma3<false, kX>(acc, fh, fl, kstep_desc(base, kk, 64, 0),
                        kstep_desc(base + kHalf, kk, 64, 0));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs<32>(acc);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      fence_regs<4>(ah[b]);
      fence_regs<4>(al[b]);
    }
  }
  store_state(h_out + static_cast<int64_t>(bh) * P * N);
}

// ---- pass 3: the outputs, one block per chunk, on wgmma --------------------
template <int Q>
size_t out_smem_bytes() {
  return 2 * static_cast<size_t>(boxes(Q) + boxes(kMaxN)) * 64 * kBoxRow +
         2 * Q * sizeof(float) + 1024;
}

template <typename T, int Q>
__global__ void __launch_bounds__(kOutThreads)
    ssd_scan_out_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ a, const T* __restrict__ c,
                        const float* __restrict__ cbt,
                        const float* __restrict__ states, T* __restrict__ y,
                        int S, int P, int N, int R) {
  constexpr bool kX = Exact<T>::value;
  constexpr int XB = boxes(Q) * 64 * kBoxRow;      // bytes of an x dt image
  constexpr int HB = boxes(kMaxN) * 64 * kBoxRow;  // bytes of an h image
  constexpr int KD = Q / 8, KO = kMaxN / 8;        // k-steps of each product
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sXh = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint8_t* sXl = sXh + XB;  // x dt as B (rows p, K = j): hi and lo images
  uint8_t* sHh = sXl + XB;  // h_in as B (rows p, K = n): hi and lo images
  uint8_t* sHl = sHh + HB;
  float* sDt = reinterpret_cast<float*>(sHl + HB);  // Q
  float* sCum = sDt + Q;                            // Q

  // a 1-D grid of (head, chunk), chunks fastest
  const int nc = S / Q;
  const int bh = blockIdx.x / nc, k = blockIdx.x - (blockIdx.x / nc) * nc;
  const int s0 = k * Q, row = bh / R;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the A operands' values for this thread's fragments, from L2: C of the
  // chunk (i, n), and C B^T (i, j) on and below the diagonal only
  const T* cb = c + (static_cast<int64_t>(row) * S + s0) * N;
  const float* mb = cbt + (static_cast<int64_t>(row) * nc + k) * Q * Q;
  float cr[KO][4], mr[KD][4];
#pragma unroll
  for (int kk = 0; kk < KO; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * w + g + 8 * (e & 1), n = 8 * kk + t + 4 * (e >> 1);
      cr[kk][e] = i < Q && n < N ? to_f32(cb[i * N + n]) : 0.0f;
    }
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * w + g + 8 * (e & 1), j = 8 * kk + t + 4 * (e >> 1);
      mr[kk][e] = i < Q && j <= i ? mb[i * Q + j] : 0.0f;
    }
  if (w == 0)
    chunk_cumsum<T, Q>(dt + static_cast<int64_t>(bh) * S + s0, a[bh], sDt,
                       sCum, lane);
  // h entering the chunk: 16-byte rows of K = n, zero past P and N (to
  // kMaxN: the k-loop below has no branch, so ptxas keeps the wgmmas in
  // flight); kBatch rows of four in flight a thread
  const float* hs = states + (static_cast<int64_t>(bh) * nc + k) * P * N;
  constexpr int n4 = kMaxN / 4;
  for (int e0 = tid; e0 < 64 * n4; e0 += kBatch * kOutThreads) {
    float v[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kOutThreads;
      const int p = e / n4, n = (e - p * n4) * 4;
      if (e < 64 * n4 && p < P && n + 3 < N && N % 4 == 0) {
        const float4 f =
            __ldg(reinterpret_cast<const float4*>(hs + p * N + n));
        v[u][0] = f.x, v[u][1] = f.y, v[u][2] = f.z, v[u][3] = f.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[u][q] = e < 64 * n4 && p < P && n + q < N
                        ? __ldg(hs + p * N + n + q)
                        : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kOutThreads;
      const int p = e / n4, n = (e - p * n4) * 4;
      if (e < 64 * n4)
        store_split4<false>(sHh, sHl, operand_offset(p, n, 64), v[u]);
    }
  }
  // x dt (x of step j times dt_j, as the sequential form scales it)
  const T* xb = x + (static_cast<int64_t>(bh) * S + s0) * P;
  const T* db = dt + static_cast<int64_t>(bh) * S + s0;
  for (int e0 = tid; e0 < 64 * (Q / 4); e0 += kBatch * kOutThreads) {
    float v[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kOutThreads;
      const int p = e % 64, j = (e / 64) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[u][q] = e < 64 * (Q / 4) && p < P
                      ? to_f32(xb[(j + q) * P + p]) * to_f32(db[j + q])
                      : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kOutThreads;
      if (e < 64 * (Q / 4))
        store_split4<false>(sXh, sXl,
                            operand_offset(e % 64, (e / 64) * 4, 64), v[u]);
    }
  }
  fence_proxy_async();
  __syncthreads();

  // (C B^T o L)(x dt) and C h^T, each k-step's A fragment split into a
  // ring of kRing buffers, one reused once its wgmma has finished. L is
  // applied as the fragment is formed, selecting 0 above the diagonal (and
  // on padded rows) BEFORE the exp: there cum_i - cum_j > 0, so exp could
  // overflow and inf * 0 would be NaN; C B^T is not formed there.
  float yd[32], yo[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) yd[e] = yo[e] = 0.0f;
  constexpr int kRing = 4;  // A fragments in flight: groups pending <= 3
  uint32_t ah[kRing][4], al[kRing][4];
  const uint32_t xh = smem_u32(sXh), xl = smem_u32(sXl);
  const uint32_t hh = smem_u32(sHh), hl = smem_u32(sHl);
  // the two products' k-steps interleaved (their accumulators are
  // independent, so two chains run at once): C h^T step u, then the
  // diagonal product's step u while u < KD
#pragma unroll
  for (int s = 0; s < KD + KO; ++s) {
    // issue order: off 0, diag 0, off 1, diag 1, ..., then the rest of off
    const bool diag = s < 2 * KD && s % 2 == 1;
    const int kk = s < 2 * KD ? s / 2 : s - KD;
    uint32_t* bh_ = ah[s % kRing];
    uint32_t* bl_ = al[s % kRing];
    if (s >= kRing) {
      wgmma_wait<kRing - 1>();
      fence_regs<4>(bh_);
      fence_regs<4>(bl_);
    }
    if (diag) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * w + g + 8 * (e & 1), j = 8 * kk + t + 4 * (e >> 1);
        const float m =
            i < Q && j <= i ? mr[kk][e] * expf(sCum[i] - sCum[j]) : 0.0f;
        split<false>(m, bh_[e], bl_[e]);
      }
      wgmma_fence();
      wgmma3<false, false>(yd, bh_, bl_, kstep_desc(xh, kk, 64, 0),
                           kstep_desc(xl, kk, 64, 0));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) split<kX>(cr[kk][e], bh_[e], bl_[e]);
      wgmma_fence();
      wgmma3<kX, false>(yo, bh_, bl_, kstep_desc(hh, kk, 64, 0),
                        kstep_desc(hl, kk, 64, 0));
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<32>(yd);
  fence_regs<32>(yo);
#pragma unroll
  for (int b = 0; b < kRing; ++b) {
    fence_regs<4>(ah[b]);
    fence_regs<4>(al[b]);
  }

  // y = diag + exp(cum) (C h^T): the accumulators hold rows 16w + g (+8),
  // columns 8q + 2t (+1). They go through shared memory (the x dt images
  // are read) so that y leaves in whole 16-byte runs of a row.
  constexpr int ldy = kMaxP + 4;
  float* sY = reinterpret_cast<float*>(sXh);  // Q x ldy
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = 16 * w + g + 8 * half;
    if (i >= Q) continue;
    const float ec = expf(sCum[i]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = 8 * q + 2 * t;
      sY[i * ldy + p] = yd[4 * q + 2 * half] + ec * yo[4 * q + 2 * half];
      sY[i * ldy + p + 1] =
          yd[4 * q + 2 * half + 1] + ec * yo[4 * q + 2 * half + 1];
    }
  }
  __syncthreads();
  T* yb = y + (static_cast<int64_t>(bh) * S + s0) * P;
  if (P % 4 == 0) {
    const int p4 = P / 4;
    for (int e = tid; e < Q * p4; e += kOutThreads) {
      const int i = e / p4, p = (e - i * p4) * 4;
      store4(yb + i * P + p, sY + i * ldy + p);
    }
  } else {
    for (int e = tid; e < Q * P; e += kOutThreads) {
      const int i = e / P, p = e - i * P;
      store1(yb + i * P + p, sY[i * ldy + p]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int Q>
int launch(const void* x, const void* dt, const float* a, const void* b,
           const void* c, void* y, float* h, float* cbt, uint8_t* bt,
           float* states, int BH, int S, int P, int N, int R,
           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* bt_in = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const unsigned nc = static_cast<unsigned>(S / Q);
  const size_t cbt_smem = cbt_smem_floats<Q>(N) * sizeof(float);
  const size_t state_smem = state_smem_bytes<Q>();
  const size_t out_smem = out_smem_bytes<Q>();
  cudaError_t err;
  if ((err = allow_smem(ssd_scan_cbt_kernel<T, Q>, cbt_smem)) ||
      (err = allow_smem(ssd_scan_state_kernel<T, Q>, state_smem)) ||
      (err = allow_smem(ssd_scan_out_kernel<T, Q>, out_smem)))
    return static_cast<int>(err);
  ssd_scan_cbt_kernel<T, Q>
      <<<dim3(static_cast<unsigned>(BH / R), nc), kCbtThreads, cbt_smem, s>>>(
          bt_in, ct, cbt, bt, S, N);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_scan_state_kernel<T, Q>
      <<<dim3(static_cast<unsigned>(BH), N > 64 ? 2u : 1u), kStateThreads,
         state_smem, s>>>(
          xt, dtt, a, bt, states, h, S, P, N, R);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_scan_out_kernel<T, Q>
      <<<static_cast<unsigned>(BH) * nc, kOutThreads, out_smem, s>>>(
          xt, dtt, a, ct, cbt, states, static_cast<T*>(y), S, P, N, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_chunk(int chunk, const void* x, const void* dt, const float* a,
                   const void* b, const void* c, void* y, float* h,
                   float* cbt, uint8_t* bt, float* states, int BH, int S,
                   int P, int N, int R, cudaStream_t s) {
  switch (chunk) {
    case 8:
      return launch<T, 8>(x, dt, a, b, c, y, h, cbt, bt, states, BH, S, P, N,
                          R, s);
    case 16:
      return launch<T, 16>(x, dt, a, b, c, y, h, cbt, bt, states, BH, S, P,
                           N, R, s);
    case 32:
      return launch<T, 32>(x, dt, a, b, c, y, h, cbt, bt, states, BH, S, P,
                           N, R, s);
    case 64:
      return launch<T, 64>(x, dt, a, b, c, y, h, cbt, bt, states, BH, S, P,
                           N, R, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c and y share it; a and h are
// float32). chunk one of 8, 16, 32, 64, dividing S; 1 <= P <= 64,
// 1 <= N <= 128. x and y are (BH, S, P), dt (BH, S), a (BH,), b and c
// (BH / R, S, N), h (BH, P, N), all contiguous. Scratch, none of it read
// before this call writes it: cbt, (BH / R) * (S / chunk) * chunk * chunk
// f32; bt, (BH / R) * (S / chunk) * repro_ssd_scan_bt_bytes(chunk) bytes;
// states, BH * (S / chunk) * P * N f32. Three launches on the
// stream; returns the CUDA error code of the first that fails
// (0 = cudaSuccess).
extern "C" int repro_ssd_scan(int dtype, int chunk, const void* x,
                              const void* dt, const void* a, const void* b,
                              const void* c, void* y, void* h, void* cbt,
                              void* bt, void* states, int BH, int S, int P,
                              int N, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || R < 1 ||
      BH < 1 || BH % R != 0 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  float* hf = static_cast<float*>(h);
  float* cf = static_cast<float*>(cbt);
  uint8_t* bf = static_cast<uint8_t*>(bt);
  float* sf = static_cast<float*>(states);
  if (dtype == 0)
    return dispatch_chunk<float>(chunk, x, dt, af, b, c, y, hf, cf, bf, sf,
                                 BH, S, P, N, R, s);
  if (dtype == 1)
    return dispatch_chunk<__nv_bfloat16>(chunk, x, dt, af, b, c, y, hf, cf,
                                         bf, sf, BH, S, P, N, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of the B^T image scratch per (group row, chunk)
extern "C" int repro_ssd_scan_bt_bytes(int chunk) {
  return 2 * boxes(chunk) * kImgBox;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
