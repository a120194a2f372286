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
// q's dtype.  The Q=1 form is the chunk form's call, so one body serves
// both.
//
// What bounds it on an H100: the bytes of K/V read.  At Q = 1 the work is
// 4 * rep * head_dim flops per 2 * head_dim * elem_bytes of K/V (rep =
// n_q / n_kv, 6 at qwen2-1.5B: 6 flops per bf16 byte), far under the
// card's ~295 flops/byte ridge.  The design (split_kv_attention.cuh):
//   * a block serves 16 query rows of kv head g: 16 / rep queries of row
//     b with all their rep heads (GQA in-kernel: one read of a K/V tile
//     serves every query and head of the group); a chunk of more queries
//     takes more query tiles in the grid, each reading its K/V again
//     (mostly from L2), because a 64-row block would hold a 64 x 128 fp32
//     accumulator in every warp;
//   * split-KV: the grid is (B, n_kv, q_tiles * n_splits); block z walks
//     the `span` positions (256) starting at valid_from + split * span, up
//     to its widest query's limit, so positions outside every query's
//     window are never loaded, and a span past the window returns at once
//     with an empty partial.  At the static decode step (32 rows of
//     S = 1024, windows of 64..512) that is ~100 live blocks of 64
//     positions a warp; spans of 128 (~190 blocks) and 64 measured slower
//     on the H100, the merge's share growing with the span count.
//     n_splits = ceil(S / span) comes from shapes alone.  A second
//     kernel, launched by the same C entry point, merges the partials (one launch count per call in the
//     wrapper); a separate merge, rather than a last-block-done counter,
//     needs no zeroed counter buffer and no fences, and sums in a fixed
//     order, so results are bit-for-bit repeatable;
//   * bytes in flight: each warp walks its tiles of 16 positions with a
//     2-stage ring of 16-byte cp.async copies (one position of one kv head
//     is head_dim contiguous elements, 256 B in bf16);
//   * bf16 tensor cores: Q.K^T and P.V as mma.sync.m16n8k16 bf16 tiles
//     (not wgmma: 64 rows minimum, 58 idle at decode), for bf16 q over a
//     bf16 cache and over an int8 cache (int8 tiles in the ring, widened
//     to bf16 in registers; s_k on the scores, P' = bf16(P * s_v)).  fp32
//     caches and fp32 q keep fp32 CUDA-core products in the same
//     structure.
// Shared memory (head_dim 128): 4 KB of q + 64 KB of rings a block for a
// bf16 cache, so three blocks share an SM; 41 KB for an int8 cache (its
// 32 KB of rings lie under the 35 KB merge area, then 1 KB of scales).
// Head_dim 256 doubles each (an fp32 cache keeps one ring stage a warp).
// Registers and spills of every variant: `nvcc -Xptxas -v`, printed by
// chip_smoke.py's build phase.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/decode_attention.py).

#include "split_kv_attention.cuh"

namespace {

using namespace splitkv;

// Grid: (B, n_kv, q_tiles * n_splits).  Block: kThreads.  Row r of a
// block is query i0 + r / rep, head g * rep + r % rep.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const QT* __restrict__ q,            // [B, Q, n_q, D]
    const KT* __restrict__ k_cache,      // [B, S, n_kv, D]
    const KT* __restrict__ v_cache,      // [B, S, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [B, S, n_kv]
    const __nv_bfloat16* __restrict__ v_scale,  // (int8 caches only)
    const int* __restrict__ valid_from,  // [B]
    const int* __restrict__ valid_to0,   // [B]
    QT* __restrict__ out,                // [B, Q, n_q, D]
    float* __restrict__ part,            // partials, or nullptr (one span)
    int nq_tok, int n_q, int n_kv, int S, int span, int n_splits,
    float scale_log2) {
  extern __shared__ __align__(16) char smem[];

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z % n_splits;
  const int rep = n_q / n_kv;
  const int q_tile = kRows / rep;
  const int i0 = (blockIdx.z / n_splits) * q_tile;
  const int nq_blk = min(q_tile, nq_tok - i0);
  const int rows = nq_blk * rep;
  const int lo = max(valid_from[b], 0);
  const int hi0 = valid_to0[b];
  // The block's widest window ends at its last query's limit.
  const int kv_end = max(0, min(hi0 + i0 + nq_blk - 1, S));
  const int begin = lo + split * span;
  const int end = min(begin + span, kv_end);
  const size_t q_row0 = (static_cast<size_t>(b) * nq_tok + i0) * n_q + g * rep;
  const size_t pos0 = static_cast<size_t>(b) * S;
  auto out_row = [&](int r) {
    return q_row0 + static_cast<size_t>(r / rep) * n_q + r % rep;
  };
  attend_span<QT, KT, D>(
      k_cache, v_cache, k_scale, v_scale,
      [&](int r) { return q + out_row(r) * D; }, out_row,
      [&](int pos) { return (pos0 + pos) * n_kv + g; },
      [&](int r) { return r < rows ? max(0, min(hi0 + i0 + r / rep, S)) : 0; },
      rows, begin, end, scale_log2, out, part, split, n_splits,
      gridDim.x * nq_tok * n_q, smem);
}

template <typename QT, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_merge_kernel(
    const float* __restrict__ part, QT* __restrict__ out, int R, int n_splits) {
  merge_rows<QT, D>(part, out, R, n_splits);
}

template <typename QT, typename KT, int D>
int launch_d(const void* q, const void* k_cache, const void* v_cache,
             const void* k_scale, const void* v_scale, const void* valid_from,
             const void* valid_to0, void* out, void* scratch, int B,
             int nq_tok, int n_q, int n_kv, int S, int span, int n_splits,
             float scale, cudaStream_t stream) {
  constexpr int kSmem = Plan<QT, KT, D>::kSmemBytes;
  const int q_tile = kRows / (n_q / n_kv);
  const int q_tiles = (nq_tok + q_tile - 1) / q_tile;
  if (static_cast<long long>(q_tiles) * n_splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = decode_attention_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = n_splits > 1 ? static_cast<float*>(scratch) : nullptr;
  kernel<<<dim3(B, n_kv, q_tiles * n_splits), kThreads, kSmem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_cache),
      static_cast<const KT*>(v_cache),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(valid_from), static_cast<const int*>(valid_to0),
      static_cast<QT*>(out), part, nq_tok, n_q, n_kv, S, span, n_splits,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const int R = B * nq_tok * n_q;
  decode_attention_merge_kernel<QT, D>
      <<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          part, static_cast<QT*>(out), R, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_typed(const void* q, const void* k_cache, const void* v_cache,
                 const void* k_scale, const void* v_scale,
                 const void* valid_from, const void* valid_to0, void* out,
                 void* scratch, int B, int nq_tok, int n_q, int n_kv,
                 int head_dim, int S, int span, int n_splits, float scale,
                 cudaStream_t stream) {
#define DA_ARGS                                                          \
  q, k_cache, v_cache, k_scale, v_scale, valid_from, valid_to0, out,    \
      scratch, B, nq_tok, n_q, n_kv, S, span, n_splits, scale, stream
  if (head_dim == 64) return launch_d<QT, KT, 64>(DA_ARGS);
  if (head_dim == 128) return launch_d<QT, KT, 128>(DA_ARGS);
  if (head_dim == 256) return launch_d<QT, KT, 256>(DA_ARGS);
#undef DA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (caches only).  The
// caller chooses the split: `span` positions a block, n_splits blocks a
// (row, kv head, query tile), covering the cache (span * n_splits >= S);
// with n_splits > 1, `scratch` holds n_splits * B * Q * n_q *
// (head_dim + 2) floats of partials.  Returns 0 or the cudaError_t of a
// launch.
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* valid_from,
    const void* valid_to0, void* out, void* scratch, int B, int nq_tok,
    int n_q, int n_kv, int head_dim, int S, int span, int n_splits,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  if (B == 0 || nq_tok == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep || S <= 0 ||
      span < 1 || n_splits < 1 ||
      static_cast<long long>(span) * n_splits < S ||
      (n_splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DA_ARGS                                                            \
  q, k_cache, v_cache, k_scale, v_scale, valid_from, valid_to0, out,      \
      scratch, B, nq_tok, n_q, n_kv, head_dim, S, span, n_splits, scale, s
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
