// Ragged paged attention over a packed token stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ragged_paged_attention_kernel` /
// `_ragged_stream_kernel` in areal_tpu/ops/pallas/paged_attention.py, and
// serves the same file's `paged_decode_attention_kernel` (the chunk
// kernel at Q=1, one token a slot over its page row: the same function),
// which the two-program paged path's decode step calls.
// Token t of the stream attends its own window [0, valid_to[t]) of the
// sequence it belongs to, addressed through its own page-table row
// page_table[t, :]; the table bounds the window (min(valid_to,
// max_pages * page_size)).  Unmapped entries (>= n_pool) clamp to the
// last pool page; the window removes every position they address.  Dead
// lanes (valid_to == 0) load nothing and write exact zeros.  int8 pools
// carry one bf16 scale per (page, slot, kv head).
//
// What bounds it on an H100: the bytes of K/V read.  A decode lane does
// 4 * rep * head_dim flops per 2 * head_dim * elem_bytes of K/V (rep =
// n_q / n_kv = 6 at qwen2-1.5B: 6 flops per bf16 byte), far under the
// card's ~295 flops/byte ridge, so time is bytes over 3.35 TB/s at best.
// The design (split_kv_attention.cuh):
//   * split-KV: the grid is (T, n_kv, n_splits); block (t, g, z) serves
//     the `rep` query heads of kv head g of token t (GQA in-kernel: one
//     read of K/V for all of them) over a span of `span_pages` whole pages
//     (256 positions at page_size 128), so a 2048-position window is
//     eight blocks in parallel instead of one block walking 64 tiles.
//     n_splits = ceil(max_pages / span_pages) comes from shapes alone; a
//     span past the lane's window returns at once with an empty partial.
//     A second kernel, launched by the same C entry point, merges the
//     partials (one launch count per call in the wrapper).  A separate
//     merge, rather than a last-block-done counter, keeps the kernels free
//     of a zeroed counter buffer and of fences, and its order is fixed,
//     so results are bit-for-bit repeatable.
//   * bytes in flight: each warp walks its tiles of 16 positions with a
//     2-stage ring of 16-byte cp.async copies (one position of one kv head
//     is head_dim contiguous elements, 256 B in bf16); the block reads its
//     pages' indices once into shared memory, not once per element.
//   * bf16 tensor cores: Q.K^T and P.V as mma.sync.m16n8k16 bf16 tiles,
//     the 6 heads padded to 16 rows (not wgmma: 64 rows minimum), for bf16
//     q over a bf16 pool and over an int8 pool (int8 tiles in the ring,
//     widened to bf16 in registers; s_k on the scores, P' = bf16(P *
//     s_v)).  fp32 pools and fp32 q keep fp32 CUDA-core products in the
//     same structure.
// Shared memory (head_dim 128): 4 KB of q + 64 KB of rings + 1 KB of page
// indices a block for a bf16 pool, so three blocks share an SM; 42 KB for
// an int8 pool (its rings lie under the 35 KB merge area; 1 KB of
// scales).  Registers and spills of every variant: `nvcc -Xptxas -v`,
// printed by chip_smoke.py's build phase.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/ragged_paged_attention.py).

#include "split_kv_attention.cuh"

namespace {

using namespace splitkv;

constexpr int kMaxSpanPages = 256;

// Grid: (T, n_kv, n_splits).  Block: kThreads.
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
    float* __restrict__ part,            // partials, or nullptr (one span)
    int n_q, int n_kv, int n_pool, int page_size, int max_pages,
    int span_pages, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int pages_s[kMaxSpanPages];

  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int rep = n_q / n_kv;
  const int vt = max(0, min(valid_to[t], max_pages * page_size));
  const int page0 = split * span_pages;
  const int begin = page0 * page_size;
  const int end = min(begin + span_pages * page_size, vt);
  if (begin < end) {
    // This span's page indices, once a page (sentinel clamp); visible to
    // the loads after attend_span's first barrier.
    const int* pt_row = page_table + static_cast<size_t>(t) * max_pages;
    for (int i = threadIdx.x; i < span_pages && page0 + i < max_pages; i += kThreads)
      pages_s[i] = min(pt_row[page0 + i], n_pool - 1);
  }
  const size_t row0 = static_cast<size_t>(t) * n_q + g * rep;
  attend_span<QT, KT, D>(
      k_pool, v_pool, k_scale, v_scale,
      [&](int r) { return q + (row0 + r) * D; },
      [&](int r) { return row0 + r; },
      [&](int pos) {
        const int local = pos - begin;
        const int pi = local / page_size;
        return (static_cast<size_t>(pages_s[pi]) * page_size + (local - pi * page_size)) *
                   n_kv + g;
      },
      [&](int r) { return r < rep ? vt : 0; }, rep, begin, end, scale_log2,
      out, part, split, gridDim.z, gridDim.x * n_q, smem);
}

template <typename QT, int D>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_merge_kernel(
    const float* __restrict__ part, QT* __restrict__ out, int R, int n_splits) {
  merge_rows<QT, D>(part, out, R, n_splits);
}

template <typename QT, typename KT, int D>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* page_table,
             const void* valid_to, void* out, void* scratch, int T, int n_q,
             int n_kv, int n_pool, int page_size, int max_pages, int span_pages,
             int n_splits, float scale, cudaStream_t stream) {
  constexpr int kSmem = Plan<QT, KT, D>::kSmemBytes;
  auto* kernel = ragged_paged_attention_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = n_splits > 1 ? static_cast<float*>(scratch) : nullptr;
  kernel<<<dim3(T, n_kv, n_splits), kThreads, kSmem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(valid_to),
      static_cast<QT*>(out), part, n_q, n_kv, n_pool, page_size, max_pages,
      span_pages, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const int R = T * n_q;
  ragged_paged_attention_merge_kernel<QT, D>
      <<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          part, static_cast<QT*>(out), R, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale,
                 const void* page_table, const void* valid_to, void* out,
                 void* scratch, int T, int n_q, int n_kv, int head_dim,
                 int n_pool, int page_size, int max_pages, int span_pages,
                 int n_splits, float scale, cudaStream_t stream) {
#define RPA_ARGS                                                           \
  q, k_pool, v_pool, k_scale, v_scale, page_table, valid_to, out, scratch, \
      T, n_q, n_kv, n_pool, page_size, max_pages, span_pages, n_splits,    \
      scale, stream
  if (head_dim == 64) return launch_d<QT, KT, 64>(RPA_ARGS);
  if (head_dim == 128) return launch_d<QT, KT, 128>(RPA_ARGS);
#undef RPA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).  The
// caller chooses the split: span_pages pages a block, n_splits blocks a
// (token, kv head), covering the table (span_pages * n_splits >=
// max_pages); with n_splits > 1, `scratch` holds n_splits * T * n_q *
// (head_dim + 2) floats of partials.  Returns 0 or the cudaError_t of a
// launch.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* valid_to, void* out, void* scratch, int T, int n_q, int n_kv,
    int head_dim, int n_pool, int page_size, int max_pages, int span_pages,
    int n_splits, int q_dtype, int kv_dtype, float scale, void* stream) {
  if (T == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep ||
      span_pages < 1 || span_pages > kMaxSpanPages || n_splits < 1 ||
      n_splits > 65535 ||
      static_cast<long long>(span_pages) * n_splits < max_pages ||
      (n_splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_ARGS                                                           \
  q, k_pool, v_pool, k_scale, v_scale, page_table, valid_to, out, scratch, \
      T, n_q, n_kv, head_dim, n_pool, page_size, max_pages, span_pages,    \
      n_splits, scale, s
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
