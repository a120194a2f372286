// A measured variant of K3's bf16-q-over-int8 body, kept outside the
// port's kernels as the yardstick of its design choice; built and timed
// by scripts/k3_int8_registers.py beside the kernel the port ships
// (areal_tpu_torch/csrc/paged_chunk_attention.cu).
//
// The shipped body widens each int8 ring tile once per block into a
// swizzled bf16 tile in shared memory, which K3's bf16 ldmatrix walk
// reads.  This variant widens in registers instead, as split-KV does
// (csrc/split_kv_attention.cuh): every warp reads its int8 K and V bytes
// straight from the ring and turns them into bf16 fragments.  Step kk of
// thread t4 takes head dims t4 * D / 4 + 4 kk + [0, 4), so each thread's
// K bytes of every step are one contiguous run; q follows that order,
// and the P.V columns come out permuted, put back at the store.  K3's
// four warps share each tile, so each element is widened four times a
// block.
//
// Everything else is the shipped body: 64 flattened (query, head) rows a
// block, a kPos = 32, kStages = 3 cp.async ring, each tile's bf16 scale
// words in its cp.async group, s_k on the scores before the online max,
// l over the unscaled P, P' = bf16(P * s_v) into P.V, exact zeros for
// rows that see nothing.  Only bf16 q over an int8 pool, head dim 64 or
// 128.
//
// Build (from the repository root):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//     -Xcompiler -fPIC -I areal_tpu_torch/csrc -o k3_int8_registers.so \
//     scripts/k3_int8_registers.cu

#include "mma_tiles.cuh"

namespace {

using namespace tiles;

constexpr int kRows = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPos = 32;
constexpr int kStages = 3;
constexpr int kMaxRep = 16;

template <int D>
struct Plan {
  // Ring tiles are swizzled where a row holds the 8 chunks the swizzle
  // needs (head dim 128; head dim 64's rows are padded).
  using KV = Tile<int8_t, D, D >= 128, kPos>;
  using QTile = Tile<__nv_bfloat16, D, true, kRows>;
  // q rows, the ring, each stage's scale words (s_k of position j at
  // [j], s_v at [kPos + j], then the two masks of high halves).
  static constexpr int kQBytes = QTile::kBytes;
  static constexpr int kRingBytes = kStages * 2 * KV::kBytes;
  static constexpr int kScaleWords = 2 * kPos + 2;
  static constexpr int kSmemBytes = kQBytes + kRingBytes + kStages * kScaleWords * 4;
  static_assert(kPos * KV::kChunks % kThreads == 0, "whole copies per thread");
};

template <int D>
__global__ void __launch_bounds__(kThreads) k3_int8_registers_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Q, n_q, D]
    const int8_t* __restrict__ k_pool,    // [n_pool, page_size, n_kv, D]
    const int8_t* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale,  // [n_pool, page_size, n_kv]
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ page_table,  // [B, max_pages]
    const int* __restrict__ valid_to0,   // [B]
    const int* __restrict__ q_lens,      // [B]
    __nv_bfloat16* __restrict__ out,     // [B, Q, n_q, D]
    int nq_tok, int n_q, int n_kv, int n_pool, int page_size, int max_pages,
    float scale) {
  using P = Plan<D>;
  using KV = typename P::KV;
  using QTile = typename P::QTile;
  extern __shared__ __align__(16) char smem[];

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rep = n_q / n_kv;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, nq_tok * rep - r0);
  const int ql = min(max(q_lens[b], 0), nq_tok);
  const int hi0 = valid_to0[b];
  const int cap = max_pages * page_size;
  auto limit = [&](int r) -> int {
    if (r >= rows) return 0;
    const int i = (r0 + r) / rep;
    return i < ql ? max(0, min(hi0 + i, cap)) : 0;
  };
  const int i_last = min(ql - 1, (r0 + rows - 1) / rep);
  const int kv_end = i_last >= r0 / rep ? max(0, min(hi0 + i_last, cap)) : 0;
  auto row_off = [&](int r) -> size_t {
    const int fr = r0 + r;
    return ((static_cast<size_t>(b) * nq_tok + fr / rep) * n_q + g * rep + fr % rep) * D;
  };
  if (kv_end == 0) {
    for (int i = tid; i < rows * D; i += kThreads)
      out[row_off(i / D) + i % D] = __float2bfloat16(0.f);
    return;
  }

  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  auto slot = [&](int pos) -> size_t {
    const int pi = pos / page_size;
    const int page = min(pt_row[pi], n_pool - 1);
    return (static_cast<size_t>(page) * page_size + (pos - pi * page_size)) * n_kv + g;
  };
  char* q_s = smem;
  char* ring = smem + P::kQBytes;
  uint32_t* scales = reinterpret_cast<uint32_t*>(ring + P::kRingBytes);
  auto load = [&](int t) {
    char* kt = ring + (t % kStages) * 2 * KV::kBytes;
    char* vt = kt + KV::kBytes;
    const int p0 = t * kPos;
    constexpr int kPer = kPos * KV::kChunks / kThreads;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = e * kThreads + tid;
      const int j = i / KV::kChunks;
      const int c = i % KV::kChunks;
      const bool ok = p0 + j < kv_end;
      const size_t off = (ok ? slot(p0 + j) : 0) * D;
      cp_async16(smem_u32(kt + KV::offset(j, c)),
                 reinterpret_cast<const char*>(k_pool + off) + c * 16, ok);
      cp_async16(smem_u32(vt + KV::offset(j, c)),
                 reinterpret_cast<const char*>(v_pool + off) + c * 16, ok);
    }
    if (warp < 2) {
      uint32_t* st = scales + (t % kStages) * P::kScaleWords;
      const int pos = p0 + lane;
      const bool ok = pos < kv_end;
      const bool high = cp_async_scale(smem_u32(st + warp * kPos + lane),
                                       (warp == 0 ? k_scale : v_scale) + (ok ? slot(pos) : 0),
                                       ok);
      const uint32_t mask = __ballot_sync(0xffffffffu, high);
      if (lane == 0) st[2 * kPos + warp] = mask;
    }
  };
  const int n_tiles = (kv_end + kPos - 1) / kPos;
  const float scale_log2 = scale * kLog2e;
  int wlim = 0;
  for (int r = 0; r < 16; ++r) wlim = max(wlim, limit(warp * 16 + r));

  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  for (int i = tid; i < kRows * QTile::kChunks; i += kThreads) {
    const int r = i / QTile::kChunks;
    const int c = i % QTile::kChunks;
    const bool ok = r < rows;
    cp_async16(smem_u32(q_s + QTile::offset(r, c)),
               reinterpret_cast<const char*>(q + row_off(ok ? r : 0)) + c * 16, ok);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  // q fragments in the permuted contraction order.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int e = t4 * (D / 4) + kk * 4;
    const int r = warp * 16 + g8;
    const uint2 a0 = *reinterpret_cast<const uint2*>(q_s + QTile::offset(r, e / 8) + (e % 8) * 2);
    const uint2 a1 =
        *reinterpret_cast<const uint2*>(q_s + QTile::offset(r + 8, e / 8) + (e % 8) * 2);
    qa[kk][0] = a0.x;
    qa[kk][1] = a1.x;
    qa[kk][2] = a0.y;
    qa[kk][3] = a1.y;
  }
  const int lim0 = limit(warp * 16 + g8);
  const int lim1 = limit(warp * 16 + g8 + 8);
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    cp_async_commit();
    const int p0 = t * kPos;
    if (p0 >= wlim) continue;  // warp-uniform
    const char* kt = ring + (t % kStages) * 2 * KV::kBytes;
    const char* vt = kt + KV::kBytes;
    // S = Q K^T: positions g8 + 8 n are this thread's n8 columns, D / 4
    // bytes of each from byte t4 * D / 4, widened in registers.
    float s[kPos / 8][4];
#pragma unroll
    for (int n = 0; n < kPos / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      uint32_t kw[D / 16];
#pragma unroll
      for (int i = 0; i < D / 64; ++i)
        lds_i8x16(kt + KV::offset(g8 + 8 * n, t4 * (D / 64) + i), &kw[4 * i]);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[n], qa[kk], pack_bf16(i8_float(kw[kk], 0), i8_float(kw[kk], 1)),
                 pack_bf16(i8_float(kw[kk], 2), i8_float(kw[kk], 3)));
    }
    const uint32_t* st = scales + (t % kStages) * P::kScaleWords;
    const uint32_t khigh = st[2 * kPos];
    const uint32_t vhigh = st[2 * kPos + 1];
    float vsc[kPos / 8][2];
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kPos / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t4 + e;
        const int pos = p0 + j;
        const float sl = scale_of(st[j], (khigh >> j) & 1) * scale_log2;
        vsc[n][e] = scale_of(st[kPos + j], (vhigh >> j) & 1);
        s[n][e] = pos < lim0 ? s[n][e] * sl : kNegInf;
        s[n][2 + e] = pos < lim1 ? s[n][2 + e] * sl : kNegInf;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const bool live0 = mn0 > kNegInf;
    const bool live1 = mn1 > kNegInf;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < kPos / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = live0 ? exp2f(s[n][e] - mn0) : 0.f;
        s[n][2 + e] = live1 ? exp2f(s[n][2 + e] - mn1) : 0.f;
        l0 += s[n][e];
        l1 += s[n][2 + e];
        s[n][e] *= vsc[n][e];
        s[n][2 + e] *= vsc[n][e];
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }
    // O += P' V: this thread's B column of n8 tile nt is head dim
    // g8 * D / 8 + nt of positions 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9.
#pragma unroll
    for (int kp = 0; kp < kPos / 16; ++kp) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kp][0], s[2 * kp][1]), pack_bf16(s[2 * kp][2], s[2 * kp][3]),
          pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
          pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
      uint32_t vw[4][D / 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = kp * 16 + 2 * t4 + (r & 1) + (r >> 1) * 8;
        if constexpr (D / 8 == 16) {
          lds_i8x16(vt + KV::offset(row, g8), vw[r]);
        } else {
          lds_i8x8(vt + KV::offset(row, g8 >> 1) + (g8 & 1) * 8, vw[r]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int wi = nt / 4;
        const int k = nt % 4;
        mma_bf16(o[nt], pa, pack_bf16(i8_float(vw[0][wi], k), i8_float(vw[1][wi], k)),
                 pack_bf16(i8_float(vw[2][wi], k), i8_float(vw[3][wi], k)));
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // Column c of n8 tile nt is head dim c * D / 8 + nt: this thread's
  // columns 2 t4 + e of the D / 8 tiles are D / 8 consecutive head dims
  // of its rows, whole 16-byte chunks stored straight to out.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g8 + 8 * h;
    const float inv = h ? inv1 : inv0;
    if (r < rows) {
      char* orow = reinterpret_cast<char*>(out + row_off(r));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = pack_bf16(o[cc * 8 + 2 * k][2 * h + e] * inv,
                             o[cc * 8 + 2 * k + 1][2 * h + e] * inv);
          *reinterpret_cast<uint4*>(orow + ((2 * t4 + e) * (D / 64) + cc) * 16) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }
}

template <int D>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* page_table, const void* valid_to0,
             const void* q_lens, void* out, int B, int nq_tok, int n_q, int n_kv,
             int n_pool, int page_size, int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid(B, n_kv, (nq_tok * (n_q / n_kv) + kRows - 1) / kRows);
  const size_t smem = Plan<D>::kSmemBytes;
  auto* kernel = k3_int8_registers_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(valid_to0), static_cast<const int*>(q_lens),
      static_cast<__nv_bfloat16*>(out), nq_tok, n_q, n_kv, n_pool, page_size, max_pages,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of paged_chunk_attention_launch without the dtype codes
// (bf16 q, int8 pools, bf16 scales).  Returns 0 or the cudaError_t.
extern "C" int k3_int8_registers_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* page_table, const void* valid_to0, const void* q_lens,
    void* out, int B, int nq_tok, int n_q, int n_kv, int head_dim, int n_pool, int page_size,
    int max_pages, float scale, void* stream) {
  if (B == 0 || nq_tok == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep || n_pool <= 0 ||
      page_size <= 0 || max_pages <= 0 ||
      (nq_tok * (n_q / n_kv) + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                              \
  q, k_pool, v_pool, k_scale, v_scale, page_table, valid_to0, q_lens, out, B, nq_tok, n_q, \
      n_kv, n_pool, page_size, max_pages, scale, s
  if (head_dim == 64) return launch_d<64>(ARGS);
  if (head_dim == 128) return launch_d<128>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
