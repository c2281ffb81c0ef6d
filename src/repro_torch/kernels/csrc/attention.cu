// Masked online-softmax attention with grouped KV heads in f32, on the
// CUDA cores (sm_90a): the f32 program. bf16 runs the tensor-core program
// of attention_sm90.cu; the wrapper (flash_attention.py) picks one by dtype.
//
//   o[b, i, h, :] = softmax_j(mask(i, j) ? scale * q[b, i, h] . k[b, j, h/G]
//                                        : -1e30) @ v[b, :, h/G, :]
//
// q, o (B, Sq, H, D); k, v (B, Sk, Hkv, D); G = H / Hkv; f32 throughout.
// Query row i sits at position i + Sk - Sq (the causal diagonal is
// right-aligned); key j is kept when j < Sk, j <= qpos if causal, and
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
// Bound: the arithmetic, 4 flops per kept query-key pair per head
// dimension. The tensor cores take f32 only as TF32, which keeps ~3
// digits and would miss the f32 tolerance (rtol 1e-4), so the products
// stay f32 FMAs on the CUDA cores (67 TFLOP/s peak).
//
// Design. A block of 128 threads owns one (batch, head) and a tile of 64
// query rows, and loops over 64-key tiles inside the block; that loop takes
// the place of the TPU's sequential k grid axis, whose running state lived
// in VMEM scratch. Each thread owns 8 query rows (r + 8i) and, per row, 4
// keys of the score tile (c + 16j) and D/16 columns of the accumulator
// (c + 16u), where r = tid / 16 and c = tid % 16; the 16 threads of a row
// group form half a warp, so the row max and row sum are shuffle
// butterflies in a fixed order and every thread of the group holds the same
// m and l. The Q tile stays in shared memory for the whole loop; K, V and
// the probabilities of the current tile are staged there (rows padded by
// one float against bank conflicts): 113 KB at D = 128, so it is dynamic
// shared memory. Tiles that lie wholly outside the causal or window range
// of the query tile are skipped. Key positions >= Sk are masked in the
// kernel, so a ragged non-causal Sk is right (the Pallas kernel pads keys
// with zeros and lets them into the softmax, ROADMAP C1). A masked entry
// has p = 0 even while the row's running max is still -1e30 (as
// flash_attention.py:61 does), so a row whose first tiles are all masked
// accumulates nothing from them. The KV head is read as h / G; nothing is
// repeated in memory. The grid is (query tiles, B * H), so B * H is at most
// 65535. No atomics: a given card gives the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 8 row groups x 16 threads
constexpr int kRows = 8;       // query rows per thread
constexpr int kKeys = 4;       // keys per thread per tile
constexpr float kNegInf = -1e30f;

// max / sum over the 16 threads of a row group (lanes that differ in bits
// 0..3); every lane ends with the same bits
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H,
                     int Hkv, int Sq, int Sk, int causal, int window,
                     float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;     // padded row stride of the Q and K tiles
  constexpr int LDP = kBK + 1;  // padded row stride of the P tile
  constexpr int NU = D / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // kBQ x LD
  float* sK = sQ + kBQ * LD;     // kBK x LD
  float* sV = sK + kBK * LD;     // kBK x D
  float* sP = sV + kBK * D;      // kBQ x LDP

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;

  const int64_t q_stride = static_cast<int64_t>(H) * D;    // per position
  const int64_t k_stride = static_cast<int64_t>(Hkv) * D;
  const float* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  float* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e - (e / D) * D;
    const int qi = q0 + i;
    sQ[i * LD + d] = qi < Sq ? qb[qi * q_stride + d] : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][NU];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = 0.0f;
  }

  // the key positions any row of this query tile may keep: [k_lo, k_hi)
  const int q_offset = Sk - Sq;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q_offset + q_last + 1);
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int t_end = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  for (int t = k_lo / kBK; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's K, V and P are no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e - (e / D) * D;
      const int kj = k0 + j;
      const bool in = kj < Sk;
      sK[j * LD + d] = in ? kb[kj * k_stride + d] : 0.0f;
      sV[j * D + d] = in ? vb[kj * k_stride + d] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(r + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = sK[(c + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q_offset + q0 + r + 8 * i;
      bool keep[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + c + 16 * j;
        keep[j] = kpos < Sk && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.0f;
        sP[(r + 8 * i) * LDP + c + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + group_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < NU; ++u) acc[i][u] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by its own half-warp

    for (int j = 0; j < kBK; ++j) {
      float vv[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) vv[u] = sV[j * D + c + 16 * u];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = sP[(r + 8 * i) * LDP + j];
#pragma unroll
        for (int u = 0; u < NU; ++u) acc[i][u] = fmaf(p, vv[u], acc[i][u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r + 8 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      ob[qi * q_stride + c + 16 * u] = acc[i][u] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  attention_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Sk,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 q, k, v and o; head_dim one of 32, 64, 128. q and o are
// (B, Sq, H, head_dim), k and v (B, Sk, Hkv, head_dim), all contiguous,
// with H % Hkv == 0 and B * H <= 65535. Returns the CUDA error code of the
// launch (0 = cudaSuccess).
extern "C" int repro_attention(int head_dim, const void* q, const void* k,
                               const void* v, void* o, int B, int H, int Hkv,
                               int Sq, int Sk, int causal, int window,
                               float scale, void* stream) {
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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
