// Ragged paged attention over a packed token stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ragged_paged_attention_kernel` /
// `_ragged_stream_kernel` in areal_tpu/ops/pallas/paged_attention.py.
// Token t of the stream attends its own window [0, valid_to[t]) of the
// sequence it belongs to, addressed through its own page-table row
// page_table[t, :].  Unmapped entries (>= n_pool) clamp to the last pool
// page; the window mask removes every position they address.  Dead lanes
// (valid_to == 0) run no tile at all and write exact zeros.  int8 pools
// carry one bf16 scale per (page, slot, kv head).
//
// What bounds it on an H100: the bytes of K/V read.  A decode lane does
// 4 * rep * head_dim flops per 2 * head_dim * elem_bytes of K/V it reads
// (rep = n_q / n_kv query heads per kv head), far below the card's
// ~295 flops/byte ridge, so time is bytes over 3.35 TB/s at best.  The
// design does three things about that:
//   * one thread block per (token, kv head) serves all `rep` query heads
//     of that kv head from ONE read of each K/V tile (GQA in-kernel, no
//     repeat of K/V);
//   * the loop runs only over the tiles below valid_to, so a short
//     window reads only its own positions and a dead lane reads nothing;
//   * scores, the online softmax and P.V stay in shared memory and
//     registers (fp32); only the output row goes back to device memory.
// This first version stages tiles with plain loads and computes on the
// CUDA cores; tensor cores (wgmma), TMA and splitting long windows over
// several blocks are later work.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/ragged_paged_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;      // positions per tile: one per warp lane
constexpr int kThreads = 128;  // four warps per block
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

// Grid: (T, n_kv).  Block: kThreads.  Shared memory is static:
// (kMaxRep + kTile) * (D + 1) + kTile * D + kMaxRep * (kTile + 1) floats,
// 43 KB at D = 128.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const QT* __restrict__ q,            // [T, n_q, D]
    const KT* __restrict__ k_pool,       // [n_pool, page_size, n_kv, D]
    const KT* __restrict__ v_pool,       // [n_pool, page_size, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [n_pool, page_size, n_kv]
    const __nv_bfloat16* __restrict__ v_scale,  // (int8 pools only)
    const int* __restrict__ page_table,  // [T, max_pages]
    const int* __restrict__ valid_to,    // [T]
    QT* __restrict__ out,                // [T, n_q, D]
    int n_q, int n_kv, int n_pool, int page_size, int max_pages,
    float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int DP = D + 1;  // padded row: conflict-free column reads
  constexpr int kAccPer = (kMaxRep * D + kThreads - 1) / kThreads;

  __shared__ float q_s[kMaxRep * DP];
  __shared__ float k_s[kTile * DP];
  __shared__ float v_s[kTile * D];
  __shared__ float p_s[kMaxRep * (kTile + 1)];  // scores, then probs
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ float a_s[kMaxRep];

  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rep = n_q / n_kv;
  // The table addresses max_pages pages: a longer window sees only them
  // (as the Pallas grid and the plain gather do).
  const int vt = min(valid_to[t], max_pages * page_size);

  // This block's rep query rows: heads [g*rep, (g+1)*rep) of token t.
  const QT* q_tok = q + (static_cast<size_t>(t) * n_q + g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) {
    q_s[(i / D) * DP + (i % D)] = to_float(q_tok[i]);
  }
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kAccPer];
#pragma unroll
  for (int e = 0; e < kAccPer; ++e) acc[e] = 0.f;

  const int* pt_row = page_table + static_cast<size_t>(t) * max_pages;
  for (int tile0 = 0; tile0 < vt; tile0 += kTile) {
    const int nvalid = min(kTile, vt - tile0);
    __syncthreads();  // the previous tile's readers are done

    // Stage K/V of positions [tile0, tile0 + nvalid) as fp32 (dequantized
    // for int8 pools); positions past the window are zero-filled, never
    // read from the pool.
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
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

    // Scores s[r, j] = q_r . k_j * scale; a warp covers one row r.
    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile;
      const int j = i % kTile;
      float s = kNegInf;
      if (j < nvalid) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += q_s[r * DP + d] * k_s[j * DP + d];
        s = dot * scale;
      }
      p_s[r * (kTile + 1) + j] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row, one lane per position.
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float s = p_s[r * (kTile + 1) + lane];
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tmax);
      const float p = lane < nvalid ? expf(s - m_new) : 0.f;
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

    // acc[r, d] = acc[r, d] * alpha_r + sum_j p[r, j] * v[j, d].
#pragma unroll
    for (int e = 0; e < kAccPer; ++e) {
      const int i = tid + e * kThreads;
      if (i < rep * D) {
        const int r = i / D;
        const int d = i % D;
        float sum = 0.f;
        for (int j = 0; j < nvalid; ++j)
          sum += p_s[r * (kTile + 1) + j] * v_s[j * D + d];
        acc[e] = acc[e] * a_s[r] + sum;
      }
    }
  }
  __syncthreads();

  // Dead lanes ran no tile: 0 / 1e-30 gives exact zeros.
  QT* o_tok = out + (static_cast<size_t>(t) * n_q + g * rep) * D;
#pragma unroll
  for (int e = 0; e < kAccPer; ++e) {
    const int i = tid + e * kThreads;
    if (i < rep * D) {
      o_tok[i] = from_float<QT>(acc[e] / fmaxf(l_s[i / D], 1e-30f));
    }
  }
}

template <typename QT, typename KT>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale,
                 const void* page_table, const void* valid_to, void* out,
                 int T, int n_q, int n_kv, int head_dim, int n_pool,
                 int page_size, int max_pages, float scale,
                 cudaStream_t stream) {
  const dim3 grid(T, n_kv);
  const dim3 block(kThreads);
#define RPA_LAUNCH(D)                                                       \
  ragged_paged_attention_kernel<QT, KT, D><<<grid, block, 0, stream>>>(     \
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),            \
      static_cast<const KT*>(v_pool),                                       \
      static_cast<const __nv_bfloat16*>(k_scale),                           \
      static_cast<const __nv_bfloat16*>(v_scale),                           \
      static_cast<const int*>(page_table), static_cast<const int*>(valid_to), \
      static_cast<QT*>(out), n_q, n_kv, n_pool, page_size, max_pages, scale)
  if (head_dim == 64) {
    RPA_LAUNCH(64);
  } else if (head_dim == 128) {
    RPA_LAUNCH(128);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns 0 or the cudaError_t of the launch.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* valid_to, void* out, int T, int n_q, int n_kv, int head_dim,
    int n_pool, int page_size, int max_pages, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  if (T == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_ARGS                                                          \
  q, k_pool, v_pool, k_scale, v_scale, page_table, valid_to, out, T, n_q, \
      n_kv, head_dim, n_pool, page_size, max_pages, scale, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_typed<float, float>(RPA_ARGS);
    if (kv_dtype == 1) return launch_typed<float, __nv_bfloat16>(RPA_ARGS);
    if (kv_dtype == 2) return launch_typed<float, int8_t>(RPA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_typed<__nv_bfloat16, float>(RPA_ARGS);
    if (kv_dtype == 1)
      return launch_typed<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
    if (kv_dtype == 2) return launch_typed<__nv_bfloat16, int8_t>(RPA_ARGS);
  }
#undef RPA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
