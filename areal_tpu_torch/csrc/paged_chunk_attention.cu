// Per-slot paged chunk attention (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention_chunk_kernel` /
// `_paged_chunk_kernel` in areal_tpu/ops/pallas/paged_attention.py.  Slot
// b carries Q queries; query i attends flat positions
// [0, valid_to0[b] + i) of the slot's sequence through page_table[b, :],
// and only queries i < q_lens[b] are live.  Dead queries write exact
// zeros; a block whose rows are all dead reads no page.  Unmapped table
// entries (>= n_pool) clamp to the last pool page, as `clamp_page_table`
// does; the window mask removes every position they address, and
// positions at or past a block's widest live window are never loaded.
// int8 pools carry one bf16 scale per (page, slot, kv head), applied
// in-kernel.  Softmax and accumulation are fp32; the output is in q's
// dtype.
//
// What bounds it on an H100: the bytes of K/V read, nearly.  A slot's Q
// queries and its rep = n_q / n_kv query heads all read the same K/V
// window, so the work is 4 * Q * rep * head_dim flops per
// 2 * head_dim * elem_bytes of K/V — at Q = 32, rep = 6 about 190 flops
// per bf16 byte, under the card's ~295 flops/byte ridge but close to it,
// so the products have to run on the tensor cores.  An int8 pool moves
// one byte an element plus a bf16 scale a (position, kv head), about
// half the K/V bytes, which doubles the flops a K/V byte: there the
// products on the tensor cores and the widening of the codes are the
// cost.  The design:
//   * the rows of a (slot, kv head) are flattened across queries, as the
//     Pallas kernel's qh layout has them: row r is query r / rep, head
//     g * rep + r % rep.  A block takes 64 consecutive rows, one m16 tile
//     per warp across four warps (Q = 32, rep = 6: 192 rows = exactly 3
//     blocks per (slot, kv head), no idle row); each row keeps its own
//     limit min(valid_to0 + i, max_pages * page_size), 0 when dead;
//   * one K/V ring in shared memory serves all four warps: tiles of
//     kPos = 32 positions, kStages = 3 deep, filled by 16-byte cp.async
//     copies (one page-table lookup per copied row chunk, never per
//     element), so the next tiles' loads are in flight while the current
//     one is computed, and each tile costs one block barrier.  The walk
//     stops at the block's widest live window; positions past it are
//     zero-filled (source size 0);
//   * bf16 q with a bf16 pool (the main path): Q.K^T and P.V are
//     mma.sync.m16n8k16 bf16 tiles with fp32 accumulators, fed by
//     ldmatrix from XOR-swizzled tiles; the online softmax runs in the
//     log2 domain (exp2f), and P goes to bf16 for P.V;
//   * bf16 q with an int8 pool (the resume replay of an int8 serving
//     plane): the same blocks, walk and products; the ring holds int8
//     tiles (half the bytes, the same 16-byte copies), and each tile's
//     bf16 scales travel in its cp.async group (warp 0 copies the words
//     holding s_k, warp 1 those holding s_v; a ballot marks which half).
//     The four warps share each tile, so the block widens it once:
//     every thread turns 8 codes into one 16-byte chunk of a swizzled
//     bf16 tile (exact: an int8 fits bf16's significand), one more
//     barrier a tile, and the bf16 ldmatrix walk reads it.  The
//     scales stay in fp32 outside the products, as in split-KV: each
//     score is multiplied by its position's s_k before the online max,
//     l sums the unscaled P, and P.V takes P' = bf16(P * s_v).  Each
//     warp widening the ring tile in registers instead (split-KV's walk)
//     widens every element four times a block and measured slower
//     (scripts/k3_int8_registers.py times that variant);
//   * every other type pair (fp32 pools, fp32 q over int8, bf16 q over
//     fp32) takes the same rows, ring and walk with fp32 CUDA-core
//     products, so its tolerances hold;
//   * each warp owns its rows for the whole window: no cross-warp merge
//     and no split-KV (windows are <= ~700 positions on the replay path,
//     and 384 blocks of 128 threads fill the 132 SMs).
// A row that sees no position keeps l = 0 and a zero accumulator, so
// 0 / max(l, 1e-30) gives exact zeros.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/paged_chunk_attention.py).

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

using namespace tiles;

constexpr int kRows = 64;     // flattened (query, head) rows per block
constexpr int kWarps = 4;     // one m16 tile of rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPos = 32;      // key positions per ring stage
constexpr int kStages = 3;
constexpr int kMaxRep = 16;   // query heads per kv head

template <typename QT, typename KT, int D>
struct Plan {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr bool kMma = std::is_same<QT, __nv_bfloat16>::value &&
                               (std::is_same<KT, __nv_bfloat16>::value || kQuant);
  // int8 on the tensor cores: the block widens each ring tile into a
  // bf16 tile that the bf16 walk reads.
  static constexpr bool kWide = kMma && kQuant;
  // Tensor-core ring tiles are swizzled where a row holds the 8 chunks
  // the swizzle needs (all but int8 at head_dim 64, whose rows are padded).
  using KV = Tile<KT, D, kMma && D * sizeof(KT) >= 128, kPos>;
  using Wide = Tile<__nv_bfloat16, D, true, kPos>;  // a widened int8 tile
  using QTile = Tile<__nv_bfloat16, D, true, kRows>;  // tensor-core q rows
  // Shared memory: q rows (bf16 swizzled, or fp32 for the CUDA cores;
  // the tensor-core path stages its output there at the end), then
  // (CUDA-core only) per-warp probabilities and rescales, then the ring,
  // then (kWide) the widened K and V tiles, then (int8 on the tensor
  // cores) each stage's scale words: s_k of position j at [j], s_v at
  // [kPos + j], then two masks whose bit j says that word j (kPos + j)
  // holds its scale in its high half.
  static constexpr int kQBytes = kMma ? QTile::kBytes : kRows * D * 4;
  static constexpr int kPFloats = 16 * (kPos + 1) + 16;
  static constexpr int kPBytes = kMma ? 0 : kWarps * kPFloats * 4;
  static constexpr int kRingBytes = kStages * 2 * KV::kBytes;
  static constexpr int kScaleWords = 2 * kPos + 2;
  static constexpr int kScaleBytes = kMma && kQuant ? kStages * kScaleWords * 4 : 0;
  static constexpr int kWideBytes = kWide ? 2 * Wide::kBytes : 0;
  static constexpr int kSmemBytes = kQBytes + kPBytes + kRingBytes + kWideBytes + kScaleBytes;
  static_assert(kPos * KV::kChunks % kThreads == 0, "whole copies per thread");
  static_assert(kPos == 32, "one lane a position in the scale copies");
};

// The ring walk: the first kStages - 1 tiles are requested up front;
// then, per tile, wait until it has landed, one barrier (the tile is
// visible, and every warp is done with the stage the next request
// overwrites), request tile t + kStages - 1, compute tile t.
template <typename Load>
__device__ __forceinline__ void ring_prologue(int n_tiles, Load load) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }
}
template <typename Load, typename Step>
__device__ __forceinline__ void ring_loop(int n_tiles, Load load, Step step) {
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    cp_async_commit();
    step(t);
  }
  cp_async_wait<0>();
}

// Grid: (B, n_kv, ceil(Q * rep / kRows)).  Block: kThreads.  Row r of a
// block is flattened row r0 + r of its (slot, kv head): query
// (r0 + r) / rep, head g * rep + (r0 + r) % rep.
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
    float scale) {
  using P = Plan<QT, KT, D>;
  using KV = typename P::KV;
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
  // The table addresses max_pages pages: a longer window sees only them
  // (as the Pallas grid and the plain gather do).
  const int cap = max_pages * page_size;
  // One past block row r's last visible position; 0 for padding rows
  // and dead queries.
  auto limit = [&](int r) -> int {
    if (r >= rows) return 0;
    const int i = (r0 + r) / rep;
    return i < ql ? max(0, min(hi0 + i, cap)) : 0;
  };
  // The block's widest live window: its last live query's.
  const int i_last = min(ql - 1, (r0 + rows - 1) / rep);
  const int kv_end = i_last >= r0 / rep ? max(0, min(hi0 + i_last, cap)) : 0;
  // Element offset of block row r in q and out.
  auto row_off = [&](int r) -> size_t {
    const int fr = r0 + r;
    return ((static_cast<size_t>(b) * nq_tok + fr / rep) * n_q + g * rep + fr % rep) * D;
  };
  if (kv_end == 0) {  // every row is dead or sees nothing: read no page
    for (int i = tid; i < rows * D; i += kThreads)
      out[row_off(i / D) + i % D] = from_float<QT>(0.f);
    return;
  }

  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  // Row of position pos in a [*, n_kv, D] pool view (sentinels clamped).
  auto slot = [&](int pos) -> size_t {
    const int pi = pos / page_size;
    const int page = min(pt_row[pi], n_pool - 1);
    return (static_cast<size_t>(page) * page_size + (pos - pi * page_size)) * n_kv + g;
  };
  char* q_s = smem;
  float* p_s = reinterpret_cast<float*>(smem + P::kQBytes) + warp * P::kPFloats;
  char* ring = smem + P::kQBytes + P::kPBytes;
  char* wide = ring + P::kRingBytes;
  uint32_t* scales = reinterpret_cast<uint32_t*>(wide + P::kWideBytes);
  // Tile t into its ring stage: 16-byte chunks of whole position rows,
  // neighbouring threads on neighbouring chunks; positions at or past
  // kv_end are zero-filled, never read.  int8 on the tensor cores: warp
  // 0 copies the tile's s_k words (a lane a position), warp 1 its s_v.
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
    if constexpr (P::kMma && P::kQuant) {
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
    }
  };
  const int n_tiles = (kv_end + kPos - 1) / kPos;
  const float scale_log2 = scale * kLog2e;
  // The widest window among this warp's rows: tiles past it are skipped.
  int wlim = 0;
  for (int r = 0; r < 16; ++r) wlim = max(wlim, limit(warp * 16 + r));

  if constexpr (P::kMma) {
    using QTile = typename P::QTile;
    using Wide = typename P::Wide;
    // The tile the ldmatrix walk reads: the ring's (bf16) or the widened one.
    using BT = typename std::conditional<P::kWide, Wide, KV>::type;
    const int g8 = lane >> 2;
    const int t4 = lane & 3;
    // q rows as a swizzled bf16 tile, padding rows 0.
    for (int i = tid; i < kRows * QTile::kChunks; i += kThreads) {
      const int r = i / QTile::kChunks;
      const int c = i % QTile::kChunks;
      const bool ok = r < rows;
      cp_async16(smem_u32(q_s + QTile::offset(r, c)),
                 reinterpret_cast<const char*>(q + row_off(ok ? r : 0)) + c * 16, ok);
    }
    cp_async_commit();
    ring_prologue(n_tiles, load);
    cp_async_wait<kStages - 1>();  // the q group has landed
    __syncthreads();
    // This warp's q fragments, every k16 step.
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(smem_u32(q_s + QTile::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))),
              qa[kk]);
    const int lim0 = limit(warp * 16 + g8);
    const int lim1 = limit(warp * 16 + g8 + 8);
    float o[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    ring_loop(n_tiles, load, [&](int t) {
      const int p0 = t * kPos;
      const char* kt = ring + (t % kStages) * 2 * KV::kBytes;
      const char* vt = kt + KV::kBytes;
      if constexpr (P::kWide) {
        // The block widens the tile once: each thread turns 8 int8 codes
        // into one 16-byte bf16 chunk (exactly), K then V; one barrier
        // publishes them.  The ring_loop barrier of the next tile keeps
        // the widened tiles until every warp is done with them.
        constexpr int kOut = 2 * kPos * Wide::kChunks;
#pragma unroll
        for (int e = 0; e < kOut / kThreads; ++e) {
          const int i = e * kThreads + tid;
          const int h = i / (kPos * Wide::kChunks);  // 0: K, 1: V
          const int j = (i / Wide::kChunks) % kPos;
          const int c = i % Wide::kChunks;
          uint32_t w[2];
          lds_i8x8((h ? vt : kt) + KV::offset(j, c / 2) + (c % 2) * 8, w);
          uint4 x;
          x.x = pack_bf16(i8_float(w[0], 0), i8_float(w[0], 1));
          x.y = pack_bf16(i8_float(w[0], 2), i8_float(w[0], 3));
          x.z = pack_bf16(i8_float(w[1], 0), i8_float(w[1], 1));
          x.w = pack_bf16(i8_float(w[1], 2), i8_float(w[1], 3));
          *reinterpret_cast<uint4*>(wide + h * Wide::kBytes + Wide::offset(j, c)) = x;
        }
        __syncthreads();
        kt = wide;
        vt = wide + Wide::kBytes;
      }
      if (p0 >= wlim) return;  // warp-uniform: no row of this warp sees the tile
      // S = Q K^T over the tile's kPos positions (n8 tiles of positions).
      float s[kPos / 8][4];
#pragma unroll
      for (int n = 0; n < kPos / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kPos / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4(smem_u32(kt + BT::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(s[2 * np], qa[kk], bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], bb[2], bb[3]);
        }
      }
      // int8: this thread's positions' scales, s_k on the scores before
      // the maximum, s_v on P after l has summed it.
      float ksc[kPos / 8][2], vsc[kPos / 8][2];
      if constexpr (P::kQuant) {
        const uint32_t* st = scales + (t % kStages) * P::kScaleWords;
        const uint32_t khigh = st[2 * kPos];
        const uint32_t vhigh = st[2 * kPos + 1];
#pragma unroll
        for (int n = 0; n < kPos / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = n * 8 + 2 * t4 + e;
            ksc[n][e] = scale_of(st[j], (khigh >> j) & 1);
            vsc[n][e] = scale_of(st[kPos + j], (vhigh >> j) & 1);
          }
        }
      }
      // Mask to each row's limit, then the online softmax (a row's
      // scores sit in the 4 threads of a quad).
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kPos / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = p0 + n * 8 + 2 * t4 + e;
          const float sl = P::kQuant ? ksc[n][e] * scale_log2 : scale_log2;
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
      // A row that has seen no position yet keeps p = 0 (exp2f(0) of two
      // sentinels would be 1); once live, masked scores give exp2f(-1e30).
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
          if constexpr (P::kQuant) {  // P' = P * s_v, rounded to bf16 below
            s[n][e] *= vsc[n][e];
            s[n][2 + e] *= vsc[n][e];
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }
      // O += P V: two neighbouring score tiles are the bf16 a fragment of
      // one k16 step of positions.
#pragma unroll
      for (int kp = 0; kp < kPos / 16; ++kp) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kp][0], s[2 * kp][1]), pack_bf16(s[2 * kp][2], s[2 * kp][3]),
            pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
            pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t bb[4];
          ldsm_x4_trans(
              smem_u32(vt + BT::offset(kp * 16 + a_row(lane), nn * 2 + a_chunk(lane))), bb);
          mma_bf16(o[2 * nn], pa, bb[0], bb[1]);
          mma_bf16(o[2 * nn + 1], pa, bb[2], bb[3]);
        }
      }
    });

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // A row that saw no position has o = 0: exact zeros.
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    // Normalise into this warp's own q rows (no other warp reads them
    // any more), then 16-byte stores of whole rows.
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int r = warp * 16 + g8;
      *reinterpret_cast<uint32_t*>(q_s + QTile::offset(r, nt) + 4 * t4) =
          pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
      *reinterpret_cast<uint32_t*>(q_s + QTile::offset(r + 8, nt) + 4 * t4) =
          pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 16 * QTile::kChunks / 32; ++e) {
      const int i = e * 32 + lane;
      const int r = warp * 16 + i / QTile::kChunks;
      const int c = i % QTile::kChunks;
      if (r < rows)
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(out + row_off(r)) + c * 16) =
            *reinterpret_cast<const uint4*>(q_s + QTile::offset(r, c));
    }
  } else {
    // The CUDA-core walk: lane = position p0 + lane of the tile for the
    // scores of all 16 rows of this warp; lane = columns lane + 32 n for
    // P.V.  m and l of every row are kept by every lane.
    constexpr int kDN = D / 32;
    float* qf = reinterpret_cast<float*>(q_s);
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D;
      qf[i] = r < rows ? to_float(q[row_off(r) + i % D]) : 0.f;
    }
    ring_prologue(n_tiles, load);  // the loop's first barrier publishes qf
    float* a_s = p_s + 16 * (kPos + 1);
    int lim[16];
    float m[16], l[16], o[16][kDN];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      lim[r] = limit(warp * 16 + r);
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int n = 0; n < kDN; ++n) o[r][n] = 0.f;
    }
    ring_loop(n_tiles, load, [&](int t) {
      const int p0 = t * kPos;
      if (p0 >= wlim) return;
      const char* kt = ring + (t % kStages) * 2 * KV::kBytes;
      const char* vt = kt + KV::kBytes;
      const int pos = p0 + lane;
      float ksc = 1.f, vsc = 1.f;
      if constexpr (P::kQuant) {  // int8: dequantize with the bf16 scales in fp32
        const bool ok = pos < kv_end;
        const size_t sl = ok ? slot(pos) : 0;
        ksc = ok ? __bfloat162float(k_scale[sl]) : 0.f;
        vsc = ok ? __bfloat162float(v_scale[sl]) : 0.f;
      }
      float sc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) sc[r] = 0.f;
      const char* krow = kt + KV::offset(lane, 0);
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kv = load4<KT>(krow + d * static_cast<int>(sizeof(KT)));
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qf + (warp * 16 + r) * D + d);
          sc[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float s = pos < lim[r] ? sc[r] * ksc * scale_log2 : kNegInf;
        float mx = s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - mn);
        const float p = mn > kNegInf ? exp2f(s - mn) : 0.f;
        float psum = p;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[r] = l[r] * alpha + psum;
        m[r] = mn;
        p_s[r * (kPos + 1) + lane] = p * vsc;
        if (lane == 0) a_s[r] = alpha;
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float alpha = a_s[r];
#pragma unroll
        for (int n = 0; n < kDN; ++n) o[r][n] *= alpha;
      }
#pragma unroll 2
      for (int j = 0; j < kPos; ++j) {
        const KT* vrow = reinterpret_cast<const KT*>(vt + KV::offset(j, 0));
        float vv[kDN];
#pragma unroll
        for (int n = 0; n < kDN; ++n) vv[n] = to_float(vrow[lane + 32 * n]);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float p = p_s[r * (kPos + 1) + j];
#pragma unroll
          for (int n = 0; n < kDN; ++n) o[r][n] += p * vv[n];
        }
      }
      __syncwarp();  // p_s and a_s are free again
    });
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      if (row < rows) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        QT* o_row = out + row_off(row);
#pragma unroll
        for (int n = 0; n < kDN; ++n) o_row[lane + 32 * n] = from_float<QT>(o[r][n] * inv);
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
  const dim3 grid(B, n_kv, (nq_tok * rep + kRows - 1) / kRows);
  const size_t smem = Plan<QT, KT, D>::kSmemBytes;
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
      n_kv, n_pool, page_size, max_pages, scale);
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
    int max_pages, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  if (B == 0 || nq_tok == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxRep ||
      n_pool <= 0 || page_size <= 0 || max_pages <= 0 ||
      (nq_tok * (n_q / n_kv) + kRows - 1) / kRows > 65535) {
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
