// Split-KV attention for query rows of one kv head over a KV window: the
// block body and the merge that the ragged paged attention (K2,
// ragged_paged_attention.cu) and dense decode attention (K4,
// decode_attention.cu) kernels share.  Included by both; compiled with
// each (nvcc, sm_90a).
//
// A block serves kRows = 16 query rows (the `rep` heads of a kv group, for
// one or more queries) over one span of KV positions [begin, end).  Its
// four warps walk the span independently, tile by tile (16 positions a
// tile, tiles w, w + 4, ... for warp w), each with its own ring of
// Plan::kStages K/V tiles in shared memory filled by 16-byte cp.async copies, so
// the next tiles' loads are in flight while the current one is computed
// and no block-wide barrier runs in the loop.  Each warp keeps an online
// softmax (m, l) and a 16 x D fp32 accumulator; at the end the four are
// merged in shared memory and the block writes either the final output
// (the call has one span) or an fp32 partial (o unnormalised, m, l) for
// `merge_rows` to combine across spans.
//
// bf16 q with a bf16 or an int8 cache (the main paths): Q.K^T and P.V
// are mma.sync.m16n8k16 bf16 tiles with fp32 accumulators; P goes to bf16
// for P.V, as in flash attention.  Not wgmma: its 64-row minimum would
// leave 58 of 64 rows idle at decode (rep = 6 heads), and these kernels
// are bounded by bytes, not by the tensor rate.  A bf16 cache feeds the
// products by ldmatrix from XOR-swizzled tiles (conflict-free).  An int8
// cache keeps its ring in int8 (half the bytes, the same 16-byte cp.async
// copies) and each thread reads its K and V bytes straight from the
// swizzled tile into registers and widens them to bf16 there, exactly
// (an int8 fits bf16's 8-bit significand).  The contraction order is
// free, so Q.K^T takes the head dims in an order that makes each
// thread's K bytes contiguous, and P.V gives each thread the n8 column
// of its 16 contiguous V bytes (the output columns are permuted back in
// the merge area).  The scales stay in fp32 outside the products: each
// score is multiplied by its position's s_k before the online max, P.V
// takes P' = bf16(P * s_v), and l sums the unscaled P.  A tile's 16
// scale pairs travel in its cp.async group: each lane copies the aligned
// 4-byte word that holds one scale (a scale is 2 bytes at an
// n_kv-strided, possibly odd, element), and a ballot records which half
// of each word it is.
// Every other type pair (fp32 caches, fp32 q, mixed q/cache types) takes
// the same spans, ring and loads with fp32 CUDA-core products, so its
// tolerances hold.  At head_dim 256 the tensor-core walk reads its Q
// fragments from shared memory every tile (held for the whole walk they
// would take 64 registers beside the accumulator's 128), and an fp32
// cache keeps one ring stage a warp (two would overflow shared memory).
//
// Positions past `end` are zero-filled (cp.async with a source size of 0),
// never read from the cache; positions inside [begin, end) but outside a
// row's own limit get probability 0.  A row that sees no position keeps
// l = 0 and an all-zero accumulator, so 0 / max(l, 1e-30) gives exact
// zeros, and the merge skips partials with l = 0 (never reading their o).
// Scores live in the log2 domain (scale * log2(e) folded in), so m is a
// log2 maximum and the softmax uses exp2f.

#pragma once

#include <type_traits>

#include "mma_tiles.cuh"

namespace splitkv {

using namespace tiles;

constexpr int kRows = 16;   // query rows per block: one m16 tile
constexpr int kTile = 16;   // positions per warp tile: one k16 step of P.V
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// Dynamic shared memory a block may use: the card's 232,448 bytes less
// K2's 1 KB of static page indices.
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kMaxRep = 16;
constexpr int kMergePad = 8;  // floats after each merge-area row

// One warp tile of kTile positions (see tiles::Tile).
template <typename T, int D, bool kSwizzle>
using Tile = tiles::Tile<T, D, kSwizzle, kTile>;

template <typename QT, typename KT, int D>
struct Plan {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr bool kMma = std::is_same<QT, __nv_bfloat16>::value &&
                               (std::is_same<KT, __nv_bfloat16>::value || kQuant);
  // Tensor-core tiles are swizzled where a row holds the 8 chunks the
  // swizzle needs (all but int8 at head_dim 64, whose rows are padded).
  using KV = Tile<KT, D, kMma && D * sizeof(KT) >= 128>;
  using QTile = Tile<__nv_bfloat16, D, true>;  // q rows on the tensor cores
  // Shared memory: q rows, then (CUDA-core only) per-warp probabilities
  // and rescales, then the K/V rings, which the cross-warp merge reuses.
  static constexpr int kQBytes = kRows * D * (kMma ? 2 : 4);
  static constexpr int kPFloats = kRows * (kTile + 1) + kRows;
  static constexpr int kPBytes = kMma ? 0 : kWarps * kPFloats * 4;
  // K/V tiles in flight per warp: 2, or 1 where 2 overflow shared memory
  // (an fp32 cache at head_dim 256: 4 warps x 2 stages x 2 tiles of 16,640 B).
  static constexpr int kStages =
      kQBytes + kPBytes + kWarps * 2 * 2 * KV::kBytes + kWarps * 2 * (2 * kTile + 1) * 4 <=
              kMaxSmem
          ? 2
          : 1;
  static constexpr int kRingBytes = kWarps * kStages * 2 * KV::kBytes;
  static constexpr int kMergeBytes =
      (kWarps * kRows * (D + kMergePad) + 3 * kWarps * kRows + kRows) * 4;
  static constexpr int kSpanBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  // int8 on the tensor cores: each ring stage's scale words (see
  // attend_span's `load`), after the rings.
  static constexpr int kScaleWords = 2 * kTile + 1;
  static constexpr int kScaleBytes = kMma && kQuant ? kWarps * kStages * kScaleWords * 4 : 0;
  static constexpr int kSmemBytes = kQBytes + kPBytes + kSpanBytes + kScaleBytes;
};

// Merge area (floats), laid over the rings once every warp is done:
// o [kWarps][kRows][kStride], m, l and rescale factors [kWarps][kRows],
// l [kRows].  The padded rows keep a warp's float2 stores of its mma
// fragments (rows g and g + 8, columns 2 t4 + [0, 2)) off shared banks.
template <int D>
struct Merge {
  static constexpr int kStride = D + kMergePad;
  float* o;
  float* m;
  float* l;
  float* f;
  float* row_l;
  __device__ explicit Merge(char* base)
      : o(reinterpret_cast<float*>(base)),
        m(o + kWarps * kRows * kStride),
        l(m + kWarps * kRows),
        f(l + kWarps * kRows),
        row_l(f + kWarps * kRows) {}
};

// The tensor-core walk (bf16 q over a bf16 or an int8 cache): rows g and
// g + 8 of the m16 tile are this thread's (g = lane / 4), as in the mma
// fragments.  `load(it)` issues tile it's copies; `scale_stage(it)` is
// an int8 tile's scale words in shared memory: s_k of position j at
// [j], s_v at [16 + j], then a mask whose bit w says that word w holds
// its scale in its high half.
template <typename KT, int D, int kStages, typename Load, typename ScaleStage, typename Limit>
__device__ __forceinline__ void walk_mma(const char* q_s, const char* wring,
                                         int mine, int begin, int end,
                                         Limit limit, float scale_log2,
                                         Load load, ScaleStage scale_stage, Merge<D> mg) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  using KV = typename Plan<__nv_bfloat16, KT, D>::KV;
  using QTile = typename Plan<__nv_bfloat16, KT, D>::QTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // The Q fragment of k16 step kk.  int8: step kk of thread t4 takes
  // head dims t4 * D / 4 + 4 kk + [0, 4), so that its K bytes of every
  // step are one contiguous run; q follows that order.
  auto q_frag = [&](int kk, uint32_t (&r)[4]) {
    if constexpr (kQuant) {
      const int e = t4 * (D / 4) + kk * 4;
      const uint2 r0 = *reinterpret_cast<const uint2*>(q_s + QTile::offset(g, e / 8) + (e % 8) * 2);
      const uint2 r1 =
          *reinterpret_cast<const uint2*>(q_s + QTile::offset(g + 8, e / 8) + (e % 8) * 2);
      r[0] = r0.x;
      r[1] = r1.x;
      r[2] = r0.y;
      r[3] = r1.y;
    } else {  // q rows form a tile like K's
      ldsm_x4(smem_u32(q_s + QTile::offset(a_row(lane), kk * 2 + a_chunk(lane))), r);
    }
  };
  // Every step's fragments stay in registers for the walk up to D = 128;
  // at D = 256 they would take 64 registers a thread beside the 128 of
  // the accumulator, so each tile reads them again from the staged rows.
  constexpr bool kHoldQ = D <= 128;
  uint32_t qa[kHoldQ ? D / 16 : 1][4];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(kk, qa[kk]);
  }
  auto q_step = [&](int kk, uint32_t (&r)[4]) {
    if constexpr (kHoldQ) {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = qa[kk][j];
    } else {
      q_frag(kk, r);
    }
  };
  const int lim0 = min(limit(g), end);
  const int lim1 = min(limit(g + 8), end);
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < mine) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    cp_async_wait<kStages - 1>();  // this tile's group has landed
    __syncwarp();
    const char* kt = wring + (it % kStages) * 2 * KV::kBytes;
    const char* vt = kt + KV::kBytes;
    const int p0 = begin + (warp + it * kWarps) * kTile;

    // S = Q K^T: positions p0 + [0, 8) and p0 + [8, 16).
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    float ksc[2][2] = {}, vsc[2][2] = {};  // int8: this thread's positions' scales
    if constexpr (kQuant) {
      // Positions g and g + 8 are this thread's n8 columns: D / 4 bytes of
      // each, from byte t4 * D / 4.
      uint32_t kw[2][D / 16];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < D / 64; ++i)
          lds_i8x16(kt + KV::offset(g + 8 * n, t4 * (D / 64) + i), &kw[n][4 * i]);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qk[4];
        q_step(kk, qk);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t w = kw[n][kk];
          mma_bf16(s[n], qk, pack_bf16(i8_float(w, 0), i8_float(w, 1)),
                   pack_bf16(i8_float(w, 2), i8_float(w, 3)));
        }
      }
      const uint32_t* st = scale_stage(it);
      const uint32_t high = st[2 * kTile];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + 2 * t4 + e;
          const uint32_t kword = st[j];
          const uint32_t vword = st[kTile + j];
          ksc[n][e] = scale_of(kword, (high >> j) & 1);
          vsc[n][e] = scale_of(vword, (high >> (kTile + j)) & 1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qk[4], b[4];
        q_step(kk, qk);
        ldsm_x4(smem_u32(kt + KV::offset(b_row(lane), kk * 2 + b_chunk(lane))), b);
        mma_bf16(s[0], qk, b[0], b[1]);
        mma_bf16(s[1], qk, b[2], b[3]);
      }
    }
    // Mask to each row's limit, then the online softmax (a row's 16
    // scores sit in the 4 threads of a quad).
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = p0 + n * 8 + 2 * t4 + e;
        if constexpr (kQuant) {
          s[n][e] = pos < lim0 ? s[n][e] * ksc[n][e] * scale_log2 : kNegInf;
          s[n][2 + e] = pos < lim1 ? s[n][2 + e] * ksc[n][e] * scale_log2 : kNegInf;
        } else {
          s[n][e] = pos < lim0 ? s[n][e] * scale_log2 : kNegInf;
          s[n][2 + e] = pos < lim1 ? s[n][2 + e] * scale_log2 : kNegInf;
        }
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
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = live0 ? exp2f(s[n][e] - mn0) : 0.f;
        s[n][2 + e] = live1 ? exp2f(s[n][2 + e] - mn1) : 0.f;
      }
    }
    l0 = l0 * a0 + (s[0][0] + s[0][1]) + (s[1][0] + s[1][1]);
    l1 = l1 * a1 + (s[0][2] + s[0][3]) + (s[1][2] + s[1][3]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }
    if constexpr (kQuant) {
      // O += P' V with P' = P * s_v as bf16: the score accumulators are the
      // A fragment.  This thread's B column of n8 tile nt is head dim
      // g * D / 8 + nt of positions 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9.
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] *= vsc[n][e];
          s[n][2 + e] *= vsc[n][e];
        }
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      uint32_t vw[4][D / 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 2 * t4 + (r & 1) + (r >> 1) * 8;
        if constexpr (D / 8 == 32) {  // 32 bytes: chunks 2g and 2g + 1
          lds_i8x16(vt + KV::offset(row, 2 * g), vw[r]);
          lds_i8x16(vt + KV::offset(row, 2 * g + 1), vw[r] + 4);
        } else if constexpr (D / 8 == 16) {
          lds_i8x16(vt + KV::offset(row, g), vw[r]);
        } else {
          lds_i8x8(vt + KV::offset(row, g >> 1) + (g & 1) * 8, vw[r]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int wi = nt / 4;
        const int k = nt % 4;
        mma_bf16(o[nt], pa, pack_bf16(i8_float(vw[0][wi], k), i8_float(vw[1][wi], k)),
                 pack_bf16(i8_float(vw[2][wi], k), i8_float(vw[3][wi], k)));
      }
    } else {
      // O += P V: the score accumulators are the A fragment of P (bf16).
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(smem_u32(vt + KV::offset(a_row(lane), nn * 2 + a_chunk(lane))), b);
        mma_bf16(o[2 * nn], pa, b[0], b[1]);
        mma_bf16(o[2 * nn + 1], pa, b[2], b[3]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
    if (it + kStages < mine) load(it + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();  // every ring is drained: the merge area may cover it
  // The accumulators in fragment order: column nt * 8 + c of a row holds
  // n8 tile nt's column c (int8: head dim c * D / 8 + nt, which the
  // block's merge puts back in place).
  float* mo = mg.o + warp * kRows * Merge<D>::kStride;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float* at = mo + g * Merge<D>::kStride + nt * 8 + 2 * t4;
    *reinterpret_cast<float2*>(at) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(at + 8 * Merge<D>::kStride) = make_float2(o[nt][2], o[nt][3]);
  }
  if (t4 == 0) {
    mg.m[warp * kRows + g] = m0;
    mg.m[warp * kRows + g + 8] = m1;
    mg.l[warp * kRows + g] = l0;
    mg.l[warp * kRows + g + 8] = l1;
  }
}

// The CUDA-core walk (fp32 caches, fp32 q, mixed types): lane = position
// j of the tile (lane % 16) for rows h * 8 .. h * 8 + 7 (h = lane / 16)
// in the scores; lane = columns lane + 32 n for all 16 rows in P.V.
template <typename KT, int D, int kStages, typename Load, typename Limit, typename Slot>
__device__ __forceinline__ void walk_core(
    const float* q_s, float* p_s, const char* wring, int mine, int begin,
    int end, Limit limit, Slot slot,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, float scale_log2, Load load,
    Merge<D> mg) {
  using KV = Tile<KT, D, false>;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kDN = D / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = lane & 15;
  const int h = lane >> 4;
  float* a_s = p_s + kRows * (kTile + 1);

  int lim[8];
  float m[8], l[8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    lim[rr] = min(limit(h * 8 + rr), end);
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
  float o[kRows][kDN];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < kDN; ++n) o[r][n] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < mine) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const char* kt = wring + (it % kStages) * 2 * KV::kBytes;
    const char* vt = kt + KV::kBytes;
    const int pos = begin + (warp + it * kWarps) * kTile + j;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {  // int8: dequantize with the bf16 scales in fp32
      const bool ok = pos < end;
      const size_t sl = ok ? slot(pos) : 0;
      ksc = ok ? __bfloat162float(k_scale[sl]) : 0.f;
      vsc = ok ? __bfloat162float(v_scale[sl]) : 0.f;
    }
    float sc[8];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) sc[rr] = 0.f;
    const char* krow = kt + KV::offset(j, 0);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = load4<KT>(krow + d * static_cast<int>(sizeof(KT)));
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (h * 8 + rr) * D + d);
        sc[rr] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const float s = pos < lim[rr] ? sc[rr] * ksc * scale_log2 : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[rr], mx);
      const float alpha = exp2f(m[rr] - mn);
      const float p = mn > kNegInf ? exp2f(s - mn) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[rr] = l[rr] * alpha + psum;
      m[rr] = mn;
      p_s[(h * 8 + rr) * (kTile + 1) + j] = p * vsc;
      if (j == 0) a_s[h * 8 + rr] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float alpha = a_s[r];
#pragma unroll
      for (int n = 0; n < kDN; ++n) o[r][n] *= alpha;
    }
#pragma unroll 2
    for (int jj = 0; jj < kTile; ++jj) {
      const KT* vrow = reinterpret_cast<const KT*>(vt + KV::offset(jj, 0));
      float vv[kDN];
#pragma unroll
      for (int n = 0; n < kDN; ++n) vv[n] = to_float(vrow[lane + 32 * n]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_s[r * (kTile + 1) + jj];
#pragma unroll
        for (int n = 0; n < kDN; ++n) o[r][n] += p * vv[n];
      }
    }
    __syncwarp();  // p_s, a_s and this stage are free again
    if (it + kStages < mine) load(it + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the merge area may cover it
  float* mo = mg.o + warp * kRows * Merge<D>::kStride;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int n = 0; n < kDN; ++n) mo[r * Merge<D>::kStride + lane + 32 * n] = o[r][n];
  if (j == 0) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      mg.m[warp * kRows + h * 8 + rr] = m[rr];
      mg.l[warp * kRows + h * 8 + rr] = l[rr];
    }
  }
}

// One block's span.  Row r < rows reads q_row(r) (D elements) and owns
// output row out_row(r) in [0, R); it sees positions [begin, min(limit(r),
// end)); position p's K/V are the D elements at slot(p) * D.  With part
// == nullptr (one span for the call) the block writes out, normalised;
// else split `split` of the partials [n_splits][R][D] o, then
// [n_splits][R] m, then [n_splits][R] l.
template <typename QT, typename KT, int D, typename QRow, typename OutRow,
          typename Slot, typename Limit>
__device__ __forceinline__ void attend_span(
    const KT* __restrict__ k, const KT* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, QRow q_row, OutRow out_row,
    Slot slot, Limit limit, int rows, int begin, int end, float scale_log2,
    QT* __restrict__ out, float* __restrict__ part, int split, int n_splits,
    int R, char* smem) {
  using P = Plan<QT, KT, D>;
  using KV = typename P::KV;
  using QTile = typename P::QTile;
  constexpr int kStages = P::kStages;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t split_rows = static_cast<size_t>(split) * R;

  if (begin >= end) {  // no row sees a position of this span: load nothing
    if (part != nullptr) {  // an empty partial: l = 0 adds no mass
      float* part_m = part + static_cast<size_t>(n_splits) * R * D;
      float* part_l = part_m + static_cast<size_t>(n_splits) * R;
      if (tid < rows) {
        part_m[split_rows + out_row(tid)] = kNegInf;
        part_l[split_rows + out_row(tid)] = 0.f;
      }
    } else {
      for (int i = tid; i < rows * D; i += kThreads)
        out[out_row(i / D) * D + i % D] = from_float<QT>(0.f);
    }
    return;
  }

  char* q_s = smem;
  float* p_s = reinterpret_cast<float*>(smem + P::kQBytes) + warp * P::kPFloats;
  char* ring = smem + P::kQBytes + P::kPBytes;
  if constexpr (P::kMma) {  // q rows as a swizzled bf16 tile, padding rows 0
    for (int i = tid; i < kRows * QTile::kChunks; i += kThreads) {
      const int r = i / QTile::kChunks;
      const int c = i % QTile::kChunks;
      const bool ok = r < rows;
      cp_async16(smem_u32(q_s + QTile::offset(r, c)),
                 reinterpret_cast<const char*>(q_row(ok ? r : 0)) + c * 16, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    float* qf = reinterpret_cast<float*>(q_s);
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D;
      qf[i] = r < rows ? to_float(q_row(r)[i % D]) : 0.f;
    }
  }
  __syncthreads();  // q (and the callers' own staging) is visible

  const int n_tiles = (end - begin + kTile - 1) / kTile;
  const int mine = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  char* wring = ring + warp * (kStages * 2 * KV::kBytes);
  // int8 on the tensor cores: this warp's scale words of ring stage it.
  uint32_t* wscale = reinterpret_cast<uint32_t*>(ring + P::kSpanBytes) +
                     warp * kStages * P::kScaleWords;
  auto scale_stage = [=](int it) { return wscale + (it % kStages) * P::kScaleWords; };
  // Tile `it` of this warp into its ring stage: each lane copies 16-byte
  // chunks of whole position rows (neighbouring lanes, neighbouring
  // chunks); positions at or past `end` are zero-filled.
  auto load = [&](int it) {
    char* kt = wring + (it % kStages) * 2 * KV::kBytes;
    char* vt = kt + KV::kBytes;
    const int p0 = begin + (warp + it * kWarps) * kTile;
    constexpr int kPer = kTile * KV::kChunks / 32;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = e * 32 + lane;
      const int jr = i / KV::kChunks;
      const int c = i % KV::kChunks;
      const bool ok = p0 + jr < end;
      const size_t off = (ok ? slot(p0 + jr) : 0) * D;
      cp_async16(smem_u32(kt + KV::offset(jr, c)),
                 reinterpret_cast<const char*>(k + off) + c * 16, ok);
      cp_async16(smem_u32(vt + KV::offset(jr, c)),
                 reinterpret_cast<const char*>(v + off) + c * 16, ok);
    }
    if constexpr (P::kMma && P::kQuant) {
      // The tile's scales: lane l copies the word holding position
      // l % 16's s_k (l < 16) or s_v (l >= 16), 0 past `end`
      // (cp_async_scale); the ballot says which half holds each scale.
      uint32_t* st = scale_stage(it);
      const int pos = p0 + (lane & 15);
      const bool ok = pos < end;
      const bool high = cp_async_scale(
          smem_u32(st + lane), (lane < kTile ? k_scale : v_scale) + (ok ? slot(pos) : 0), ok);
      const uint32_t mask = __ballot_sync(0xffffffffu, high);
      if (lane == 0) st[2 * kTile] = mask;
    }
  };
  Merge<D> mg(ring);
  if constexpr (P::kMma) {
    walk_mma<KT, D, kStages>(q_s, wring, mine, begin, end, limit, scale_log2, load, scale_stage,
                             mg);
  } else {
    walk_core<KT, D, kStages>(reinterpret_cast<const float*>(q_s), p_s, wring, mine, begin, end,
                     limit, slot, k_scale, v_scale, scale_log2, load, mg);
  }
  __syncthreads();

  // Merge the four warps: per row the largest m, each warp's rescale and
  // the summed l; then every (row, column) of the block.
  if (tid < kRows) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg.m[w * kRows + tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(mg.m[w * kRows + tid] - mx);
      mg.f[w * kRows + tid] = f;
      sum += f * mg.l[w * kRows + tid];
    }
    mg.row_l[tid] = sum;
    if (part != nullptr && tid < rows) {
      float* part_m = part + static_cast<size_t>(n_splits) * R * D;
      float* part_l = part_m + static_cast<size_t>(n_splits) * R;
      part_m[split_rows + out_row(tid)] = mx;
      part_l[split_rows + out_row(tid)] = sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int sc = i % D;  // merge-area column; c: its head dim (int8: see walk_mma)
    const int c = P::kMma && P::kQuant ? (sc % 8) * (D / 8) + sc / 8 : sc;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc += mg.f[w * kRows + r] * mg.o[(w * kRows + r) * Merge<D>::kStride + sc];
    if (part != nullptr) {
      part[(split_rows + out_row(r)) * D + c] = acc;
    } else {
      out[out_row(r) * D + c] = from_float<QT>(acc / fmaxf(mg.row_l[r], 1e-30f));
    }
  }
}

// The merge of a split call: one warp per output row rescales each live
// partial (l > 0) by exp2(m_i - m), sums, and divides by max(l, 1e-30):
// a row that no span saw gives exact zeros.  Partials with l = 0 are
// skipped without reading their o.
template <typename QT, int D>
__device__ __forceinline__ void merge_rows(const float* __restrict__ part,
                                           QT* __restrict__ out, int R,
                                           int n_splits) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const float* pm = part + static_cast<size_t>(n_splits) * R * D;
  const float* pl = pm + static_cast<size_t>(n_splits) * R;
  float mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) {
    const size_t at = static_cast<size_t>(i) * R + row;
    if (pl[at] > 0.f) mx = fmaxf(mx, pm[at]);
  }
  float sum = 0.f;
  float acc[D / 32];
#pragma unroll
  for (int n = 0; n < D / 32; ++n) acc[n] = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const size_t at = static_cast<size_t>(i) * R + row;
    const float l = pl[at];
    if (l > 0.f) {
      const float f = exp2f(pm[at] - mx);
      sum += f * l;
      const float* po = part + at * D;
#pragma unroll
      for (int n = 0; n < D / 32; ++n) acc[n] += f * po[lane + 32 * n];
    }
  }
  QT* o = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int n = 0; n < D / 32; ++n) o[lane + 32 * n] = from_float<QT>(acc[n] / fmaxf(sum, 1e-30f));
}

}  // namespace splitkv
