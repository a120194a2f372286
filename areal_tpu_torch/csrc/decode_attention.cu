// Dense decode attention (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel `decode_attention_chunk_kernel` / `_chunk_kernel`
// in areal_tpu/ops/pallas/decode_attention.py, whose Q=1 call
// `decode_attention_kernel` is the attention of the static generate path's
// `decode_step`.  Row b carries Q queries over a dense KV window
// k/v[b, :, g, :]; query i attends positions [valid_from[b],
// valid_to0[b] + i), clipped to [0, S).  An empty window gives exact
// zeros.  int8 caches carry one bf16 scale per (row, position, kv head),
// applied in-kernel.  Softmax and accumulation are fp32; the output is in
// q's dtype.
//
// What bounds it on an H100: the bytes of K/V read.  At Q = 1 the work is
// 4 * rep * head_dim flops per 2 * head_dim * elem_bytes of K/V (rep =
// n_q / n_kv, 6 at qwen2-1.5B: 6 flops per bf16 byte), far under the
// card's ~295 flops/byte ridge.  The design reads each live K/V position
// once per (row, kv head):
//   * the Pallas grid (b, kv_head, block) carried m/l/acc across its
//     sequential block steps; here one block per (row, kv head, query
//     tile) walks its window itself, so m/l/acc stay in registers and
//     shared memory;
//   * a query tile is KR / rep queries, all rep heads each: a K/V tile
//     staged in shared memory once serves every query and head of the kv
//     group (GQA in-kernel, no repeat of K/V).  KR is 16 when the row's
//     Q * rep fits (decode: Q = 1), else 64 (chunks), so a decode block
//     computes no more than 16 rows of scores;
//   * the walk starts at valid_from and stops at the widest query's
//     limit: positions outside every query's window are never loaded,
//     and per-query limits mask the last tile.
// Simple first: the decode shape gives B * n_kv blocks (64 at the static
// path's B = 32, for 132 SMs), each walking its window serially; K/V
// tiles are staged with plain loads and scored on the CUDA cores in fp32.
// Splitting a window across blocks (split-KV) and tensor cores are later
// work.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/decode_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;      // key positions per tile
constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;    // query heads per kv head
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Shared memory of one block, in floats.
template <int KR, int D>
constexpr int smem_floats() {
  return KR * (D + 1)            // q rows (padded)
         + kTile * (D + 1)       // K tile (padded)
         + kTile * D             // V tile
         + KR * (kTile + 1)      // scores, then probabilities
         + 3 * KR;               // m, l, alpha per row
}

// Grid: (B, n_kv, ceil(Q / q_tile)).  Block: kThreads.  Row r of a block
// is query i0 + r / rep, head g * rep + r % rep.
template <typename QT, typename KT, int KR, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const QT* __restrict__ q,            // [B, Q, n_q, D]
    const KT* __restrict__ k_cache,      // [B, S, n_kv, D]
    const KT* __restrict__ v_cache,      // [B, S, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [B, S, n_kv]
    const __nv_bfloat16* __restrict__ v_scale,  // (int8 caches only)
    const int* __restrict__ valid_from,  // [B]
    const int* __restrict__ valid_to0,   // [B]
    QT* __restrict__ out,                // [B, Q, n_q, D]
    int nq_tok, int n_q, int n_kv, int S, int q_tile, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int DP = D + 1;  // padded row: conflict-free column reads
  constexpr int kDN = D / 32;  // output columns per lane
  constexpr int kRowsPerWarp = KR / kWarps;
  constexpr int kScoreRows = KR / 16;  // score rows per thread
  constexpr int kStage = kTile * D / kThreads;  // K/V elements per thread

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + KR * DP;
  float* v_s = k_s + kTile * DP;
  float* p_s = v_s + kTile * D;
  float* m_s = p_s + KR * (kTile + 1);
  float* l_s = m_s + KR;
  float* a_s = l_s + KR;

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int i0 = blockIdx.z * q_tile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rep = n_q / n_kv;
  const int rows = min(q_tile, nq_tok - i0) * rep;
  const int lo = max(valid_from[b], 0);
  const int hi0 = valid_to0[b];
  // One past row r's last visible position; 0 for padding rows.
  auto limit = [&](int r) -> int {
    if (r >= rows) return 0;
    return max(0, min(hi0 + i0 + r / rep, S));
  };
  // The block's widest window: its last query's.
  const int kv_end = max(0, min(hi0 + i0 + rows / rep - 1, S));

  const size_t q_row0 = (static_cast<size_t>(b) * nq_tok + i0) * n_q + g * rep;
  for (int idx = tid; idx < KR * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float x = 0.f;
    if (r < rows) {
      x = to_float(q[(q_row0 + static_cast<size_t>(r / rep) * n_q + r % rep) * D + d]);
    }
    q_s[r * DP + d] = x;
  }
  if (tid < KR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kRowsPerWarp][kDN];
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m)
#pragma unroll
    for (int n = 0; n < kDN; ++n) acc[m][n] = 0.f;

  // Score micro-tile of this thread: rows tr + 16 a, positions tc + 16 c.
  const int tr = tid / 16;
  const int tc = tid % 16;
  int lim_sc[kScoreRows];
#pragma unroll
  for (int a = 0; a < kScoreRows; ++a) lim_sc[a] = limit(tr + 16 * a);

  const size_t row_base = static_cast<size_t>(b) * S;
  // The walk starts at the window's first position: every position of a
  // tile is at or past valid_from, and only the upper limits mask.
  for (int tile0 = lo; tile0 < kv_end; tile0 += kTile) {
    const int nvalid = min(kTile, kv_end - tile0);
    __syncthreads();  // the previous tile's readers are done

    // Stage K/V of positions [tile0, tile0 + nvalid) as fp32 (dequantized
    // for int8 caches); the rest of the tile is zero-filled, never read
    // from the cache.  All of a thread's loads are issued before its
    // shared-memory stores.
    float kx[kStage];
    float vx[kStage];
#pragma unroll
    for (int it = 0; it < kStage; ++it) {
      const int idx = tid + it * kThreads;
      const int j = idx / D;
      const int d = idx % D;
      kx[it] = 0.f;
      vx[it] = 0.f;
      if (j < nvalid) {
        const size_t slot = (row_base + tile0 + j) * n_kv + g;
        kx[it] = to_float(k_cache[slot * D + d]);
        vx[it] = to_float(v_cache[slot * D + d]);
        if (kQuant) {
          kx[it] *= __bfloat162float(k_scale[slot]);
          vx[it] *= __bfloat162float(v_scale[slot]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kStage; ++it) {
      const int idx = tid + it * kThreads;
      const int j = idx / D;
      const int d = idx % D;
      k_s[j * DP + d] = kx[it];
      v_s[j * D + d] = vx[it];
    }
    __syncthreads();

    // Scores s[r, j] = q_r . k_j * scale, masked to each row's window.
    {
      float sc[kScoreRows][2];
#pragma unroll
      for (int a = 0; a < kScoreRows; ++a) sc[a][0] = sc[a][1] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float k0 = k_s[tc * DP + d];
        const float k1 = k_s[(tc + 16) * DP + d];
#pragma unroll
        for (int a = 0; a < kScoreRows; ++a) {
          const float qa = q_s[(tr + 16 * a) * DP + d];
          sc[a][0] += qa * k0;
          sc[a][1] += qa * k1;
        }
      }
#pragma unroll
      for (int a = 0; a < kScoreRows; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = tc + 16 * c;
          const bool valid = j < nvalid && tile0 + j < lim_sc[a];
          p_s[(tr + 16 * a) * (kTile + 1) + j] = valid ? sc[a][c] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per row, one lane per position.
    for (int r = warp; r < KR; r += kWarps) {
      const bool valid = lane < nvalid && tile0 + lane < limit(r);
      const float s = p_s[r * (kTile + 1) + lane];
      float tmax = valid ? s : kNegInf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tmax);
      const float p = valid ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      p_s[r * (kTile + 1) + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, d] = acc[r, d] * alpha_r + sum_j p[r, j] * v[j, d]; this
    // warp's rows are warp + kWarps m, its lane's columns lane + 32 n.
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const float alpha = a_s[warp + kWarps * m];
#pragma unroll
      for (int n = 0; n < kDN; ++n) acc[m][n] *= alpha;
    }
    for (int j = 0; j < nvalid; ++j) {
      float vv[kDN];
#pragma unroll
      for (int n = 0; n < kDN; ++n) vv[n] = v_s[j * D + lane + 32 * n];
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        const float p = p_s[(warp + kWarps * m) * (kTile + 1) + j];
#pragma unroll
        for (int n = 0; n < kDN; ++n) acc[m][n] += p * vv[n];
      }
    }
  }
  __syncthreads();

  // Rows that saw no position (empty windows) divide 0 by 1e-30: exact
  // zeros.
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) {
    const int r = warp + kWarps * m;
    if (r < rows) {
      const float l = fmaxf(l_s[r], 1e-30f);
      QT* o_row = out + (q_row0 + static_cast<size_t>(r / rep) * n_q + r % rep) * D;
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        o_row[lane + 32 * n] = from_float<QT>(acc[m][n] / l);
      }
    }
  }
}

template <typename QT, typename KT, int KR, int D>
int launch_rows(const void* q, const void* k_cache, const void* v_cache,
                const void* k_scale, const void* v_scale,
                const void* valid_from, const void* valid_to0, void* out,
                int B, int nq_tok, int n_q, int n_kv, int S, float scale,
                cudaStream_t stream) {
  const int rep = n_q / n_kv;
  const int q_tile = KR / rep;
  const dim3 grid(B, n_kv, (nq_tok + q_tile - 1) / q_tile);
  const size_t smem = smem_floats<KR, D>() * sizeof(float);
  auto* kernel = decode_attention_kernel<QT, KT, KR, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_cache),
      static_cast<const KT*>(v_cache),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(valid_from), static_cast<const int*>(valid_to0),
      static_cast<QT*>(out), nq_tok, n_q, n_kv, S, q_tile, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_typed(const void* q, const void* k_cache, const void* v_cache,
                 const void* k_scale, const void* v_scale,
                 const void* valid_from, const void* valid_to0, void* out,
                 int B, int nq_tok, int n_q, int n_kv, int head_dim, int S,
                 float scale, cudaStream_t stream) {
#define DA_ARGS                                                          \
  q, k_cache, v_cache, k_scale, v_scale, valid_from, valid_to0, out, B, \
      nq_tok, n_q, n_kv, S, scale, stream
  // 16 rows while the row's queries and heads fit them (decode), else 64.
  const bool small = nq_tok * (n_q / n_kv) <= 16;
  if (head_dim == 64) {
    return small ? launch_rows<QT, KT, 16, 64>(DA_ARGS)
                 : launch_rows<QT, KT, 64, 64>(DA_ARGS);
  }
  if (head_dim == 128) {
    return small ? launch_rows<QT, KT, 16, 128>(DA_ARGS)
                 : launch_rows<QT, KT, 64, 128>(DA_ARGS);
  }
#undef DA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (caches only).
// Returns 0 or the cudaError_t of the launch.
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* valid_from,
    const void* valid_to0, void* out, int B, int nq_tok, int n_q, int n_kv,
    int head_dim, int S, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  if (B == 0 || nq_tok == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DA_ARGS                                                            \
  q, k_cache, v_cache, k_scale, v_scale, valid_from, valid_to0, out, B,   \
      nq_tok, n_q, n_kv, head_dim, S, scale, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_typed<float, float>(DA_ARGS);
    if (kv_dtype == 1) return launch_typed<float, __nv_bfloat16>(DA_ARGS);
    if (kv_dtype == 2) return launch_typed<float, int8_t>(DA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_typed<__nv_bfloat16, float>(DA_ARGS);
    if (kv_dtype == 1)
      return launch_typed<__nv_bfloat16, __nv_bfloat16>(DA_ARGS);
    if (kv_dtype == 2) return launch_typed<__nv_bfloat16, int8_t>(DA_ARGS);
  }
#undef DA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
