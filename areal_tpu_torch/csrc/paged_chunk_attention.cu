// Per-slot paged chunk attention (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_chunk_kernel` /
// `_paged_chunk_kernel` in areal_tpu/ops/pallas/paged_attention.py.  Slot
// b carries Q queries; query i attends flat positions
// [0, valid_to0[b] + i) of the slot's sequence through page_table[b, :],
// and only queries i < q_lens[b] are live.  Dead queries write exact
// zeros; a slot with q_lens 0 reads no page.  Unmapped table entries
// (>= n_pool) clamp to the last pool page, as `clamp_page_table` does;
// the window mask removes every position they address, and positions at
// or past a block's widest live window are never loaded.  int8 pools
// carry one bf16 scale per (page, slot, kv head), applied in-kernel.
// Softmax and accumulation are fp32; the output is in q's dtype.
//
// What bounds it on an H100: the bytes of K/V read.  A slot's Q queries
// and its rep = n_q / n_kv query heads all read the same K/V window, so
// the work is 4 * Q * rep * head_dim flops per 2 * head_dim * elem_bytes
// of K/V — at Q = 32, rep = 6 about 190 flops per bf16 byte, under the
// card's ~295 flops/byte ridge.  The design keeps K/V traffic to one read
// per block:
//   * the Pallas grid (b, kv_head, page) carried m/l/acc across its
//     sequential page steps; here one block per (slot, kv head, query
//     tile) loops over its pages itself, so m/l/acc stay in registers
//     and shared memory for the whole window;
//   * a query tile is kRows / rep queries, all rep heads each (kRows
//     rows): a K/V tile staged in shared memory once serves every row
//     (GQA in-kernel, no repeat of K/V).  Tiling Q fills the 132 SMs
//     (64 slots x 2 kv heads x 4 tiles = 512 blocks at qwen2-1.5B, Q=32);
//   * the block loads its own page indices and stops at the last
//     position its widest live query sees, so short windows read only
//     their own pages and dead tiles read none;
//   * the scores are register-tiled (4 rows x 2 positions a thread) and
//     P.V too (8 rows x head_dim/32 columns a thread), so each shared
//     memory read feeds several fp32 FMAs.
// This first version stages tiles with plain loads and computes on the
// CUDA cores in fp32; tensor cores (mma/wgmma), TMA and splitting long
// windows across blocks are later work.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/paged_chunk_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;      // key positions per tile
constexpr int kRows = 64;      // query rows (query x head) per block
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
template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1)          // q rows (padded)
         + kTile * (D + 1)        // K tile (padded)
         + kTile * D              // V tile
         + kRows * (kTile + 1)    // scores, then probabilities
         + 3 * kRows;             // m, l, alpha per row
}

// Grid: (B, n_kv, ceil(Q / q_tile)).  Block: kThreads.  Row r of a block
// is query i0 + r / rep, head g * rep + r % rep.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_chunk_attention_kernel(
    const QT* __restrict__ q,            // [B, Q, n_q, D]
    const KT* __restrict__ k_pool,       // [n_pool, page_size, n_kv, D]
    const KT* __restrict__ v_pool,       // [n_pool, page_size, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [n_pool, page_size, n_kv]
    const __nv_bfloat16* __restrict__ v_scale,  // (int8 pools only)
    const int* __restrict__ page_table,  // [B, max_pages]
    const int* __restrict__ valid_to0,   // [B]
    const int* __restrict__ q_lens,      // [B]
    QT* __restrict__ out,                // [B, Q, n_q, D]
    int nq_tok, int n_q, int n_kv, int n_pool, int page_size, int max_pages,
    int q_tile, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int DP = D + 1;  // padded row: conflict-free column reads
  constexpr int kDN = D / 32;  // output columns per lane
  constexpr int kRowsPerWarp = kRows / kWarps;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kRows * DP;
  float* v_s = k_s + kTile * DP;
  float* p_s = v_s + kTile * D;
  float* m_s = p_s + kRows * (kTile + 1);
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int i0 = blockIdx.z * q_tile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rep = n_q / n_kv;
  const int rows = min(q_tile, nq_tok - i0) * rep;
  const int ql = min(max(q_lens[b], 0), nq_tok);
  const int hi0 = valid_to0[b];
  // The table addresses max_pages pages: a longer window sees only them
  // (as the Pallas grid and the plain gather do).
  const int cap = max_pages * page_size;
  // One past row r's last visible position; 0 for padding rows and dead
  // queries.
  auto limit = [&](int r) -> int {
    if (r >= rows) return 0;
    const int i = i0 + r / rep;
    return i < ql ? max(0, min(hi0 + i, cap)) : 0;
  };
  // The block's widest live window: its last live query's.
  const int last_live = min(ql, i0 + rows / rep) - 1;
  const int kv_end = last_live >= i0 ? max(0, min(hi0 + last_live, cap)) : 0;

  const size_t q_row0 = (static_cast<size_t>(b) * nq_tok + i0) * n_q + g * rep;
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float x = 0.f;
    if (r < rows) {
      x = to_float(q[(q_row0 + static_cast<size_t>(r / rep) * n_q + r % rep) * D + d]);
    }
    q_s[r * DP + d] = x;
  }
  if (tid < kRows) {
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
  int lim_sc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) lim_sc[a] = limit(tr + 16 * a);

  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  for (int tile0 = 0; tile0 < kv_end; tile0 += kTile) {
    const int nvalid = min(kTile, kv_end - tile0);
    __syncthreads();  // the previous tile's readers are done

    // Stage K/V of positions [tile0, tile0 + nvalid) as fp32 (dequantized
    // for int8 pools); the rest of the tile is zero-filled, never read
    // from the pool.
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      float kx = 0.f;
      float vx = 0.f;
      if (j < nvalid) {
        const int pos = tile0 + j;
        const int pi = pos / page_size;
        const int page = min(pt_row[pi], n_pool - 1);  // sentinel clamp
        const size_t slot =
            (static_cast<size_t>(page) * page_size + (pos - pi * page_size)) *
                n_kv + g;
        kx = to_float(k_pool[slot * D + d]);
        vx = to_float(v_pool[slot * D + d]);
        if (kQuant) {
          kx *= __bfloat162float(k_scale[slot]);
          vx *= __bfloat162float(v_scale[slot]);
        }
      }
      k_s[j * DP + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    // Scores s[r, j] = q_r . k_j * scale, masked to each row's window.
    {
      float sc[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) sc[a][0] = sc[a][1] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float k0 = k_s[tc * DP + d];
        const float k1 = k_s[(tc + 16) * DP + d];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float qa = q_s[(tr + 16 * a) * DP + d];
          sc[a][0] += qa * k0;
          sc[a][1] += qa * k1;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
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
    for (int r = warp; r < kRows; r += kWarps) {
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

  // Rows that saw no position (dead queries, empty windows, a q_lens-0
  // slot) divide 0 by 1e-30: exact zeros.
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

template <typename QT, typename KT, int D>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* page_table,
             const void* valid_to0, const void* q_lens, void* out, int B,
             int nq_tok, int n_q, int n_kv, int n_pool, int page_size,
             int max_pages, float scale, cudaStream_t stream) {
  const int rep = n_q / n_kv;
  const int q_tile = kRows / rep;
  const dim3 grid(B, n_kv, (nq_tok + q_tile - 1) / q_tile);
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto* kernel = paged_chunk_attention_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(valid_to0),
      static_cast<const int*>(q_lens), static_cast<QT*>(out), nq_tok, n_q,
      n_kv, n_pool, page_size, max_pages, q_tile, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale,
                 const void* page_table, const void* valid_to0,
                 const void* q_lens, void* out, int B, int nq_tok, int n_q,
                 int n_kv, int head_dim, int n_pool, int page_size,
                 int max_pages, float scale, cudaStream_t stream) {
#define PCA_ARGS                                                           \
  q, k_pool, v_pool, k_scale, v_scale, page_table, valid_to0, q_lens, out, \
      B, nq_tok, n_q, n_kv, n_pool, page_size, max_pages, scale, stream
  if (head_dim == 64) return launch_d<QT, KT, 64>(PCA_ARGS);
  if (head_dim == 128) return launch_d<QT, KT, 128>(PCA_ARGS);
#undef PCA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns 0 or the cudaError_t of the launch.
extern "C" int paged_chunk_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* valid_to0, const void* q_lens, void* out, int B, int nq_tok,
    int n_q, int n_kv, int head_dim, int n_pool, int page_size,
    int max_pages, int q_dtype, int kv_dtype, float scale, void* stream) {
  if (B == 0 || nq_tok == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep ||
      n_pool <= 0 || page_size <= 0 || max_pages <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCA_ARGS                                                              \
  q, k_pool, v_pool, k_scale, v_scale, page_table, valid_to0, q_lens, out, B, \
      nq_tok, n_q, n_kv, head_dim, n_pool, page_size, max_pages, scale, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_typed<float, float>(PCA_ARGS);
    if (kv_dtype == 1) return launch_typed<float, __nv_bfloat16>(PCA_ARGS);
    if (kv_dtype == 2) return launch_typed<float, int8_t>(PCA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_typed<__nv_bfloat16, float>(PCA_ARGS);
    if (kv_dtype == 1)
      return launch_typed<__nv_bfloat16, __nv_bfloat16>(PCA_ARGS);
    if (kv_dtype == 2) return launch_typed<__nv_bfloat16, int8_t>(PCA_ARGS);
  }
#undef PCA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
