// Segment-aware causal flash attention over packed rows, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of areal_tpu/ops/pallas/flash_attention.py:
//   K1f, o and logsumexp  <- `_fwd` / `_fwd_kernel`
//   K1dq                  <- `_bwd` / `_dq_kernel`
//   K1dkv                 <- `_bwd` / `_dkv_kernel`
// each twice: bf16, the main path, on the tensor cores
// (tc::flash_fwd_mma_kernel, tc::flash_dq_mma_kernel,
// tc::flash_dkv_mma_kernel), and fp32 on the CUDA cores
// (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel).
//
// Layout: q [B, S, Hq, D], k/v [B, S, Hkv, D] (the model's own layout, no
// transposes), segment ids [B, S] int32 (0 = padding), lse and delta
// [B, S, Hq] fp32.  Query head h reads kv head h / (Hq / Hkv): GQA is
// resolved by index, K/V are never repeated.  Position i attends j when
// seg[i] == seg[j] > 0 and (not causal or j <= i).  Padding rows give
// exact zeros in o, dq, dk and dv, and lse = -1e30.
//
// Tiles are 64 query rows by 64 key rows.  A tile pair is skipped when it
// lies above the causal diagonal or when the non-zero segment ids of the
// two tiles span disjoint ranges (ids are non-decreasing along a packed
// row, padding zeros aside), so the work of a row holding many short
// sequences is near block-diagonal.
//
// What bounds it on an H100: at the main path's shapes (segments of
// 64..640 tokens, D = 128) the bytes of q/k/v/o (each read or written
// once) at the HBM rate, some 20 us per call at B=4 x S=2048; the flops
// of the attended pairs at the bf16 tensor-core rate are smaller, though
// the 64 x 64 tiles along a segment's diagonal and edges compute ~1.3x
// the attended pairs.  What holds the kernels back in practice is the
// traffic inside the card: each q head of a kv group re-reads the
// group's K/V tiles from L2, and a warp on mma.sync re-reads a whole K
// or V tile from shared memory for its 16 rows.  So the bf16 forward
// runs its products as warpgroup MMAs (wgmma), which read each shared
// tile once for 64 rows, and lets one block serve up to three q heads
// of a kv head over one ring of K/V tiles; the bf16 backward kernels
// run bf16 mma.sync tiles.  All three take 16-byte cp.async copies into
// swizzled tiles (no widening, no bank conflicts) through a ring that
// overlaps the next tile's copy with the current one's products, one
// barrier a tile; keep probabilities and dS in registers; list a block's
// live tiles once and read no K/V for a tile none of its rows attends;
// and mask only diagonal and segment-edge tiles.  The fp32 kernels are
// the first versions, kept for the card-vs-CPU checks at 1e-4: they
// compute on the CUDA cores in fp32 (inputs widened in shared memory),
// one 64x64 tile pair at a time, each thread owning a 4x4 block of
// scores.
//
// Head dims 64, 128 and 256 (gemma's).  At 256 a thread's registers and
// a block's shared memory are what run out, and the kernels change only
// there: the bf16 forward runs P V as two n128 warpgroup MMAs and serves
// at most 2 q heads a block (3 Q tiles and the ring would overflow
// shared memory); the bf16 dK/dV kernel splits a key tile's 256 columns
// over two blocks, each recomputing S^T and dP^T over all of D (2 x 128
// fp32 accumulators a thread would not fit beside them); the fp32 dq and
// dk/dv kernels stage 3 tiles, not 4, K and V (or Q and dO) taking turns
// in one buffer.
//
// The backward recomputes P from the saved logsumexp, as the Pallas
// kernels do: dq walks the key tiles of one query tile; dk/dv walk, for
// one key tile of one kv head, every query head of that head's group and
// every query tile, so the group sum of dk/dv happens in registers and
// no per-query-head buffer is written.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by areal_tpu_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPS = kTile + 1; // padded row of a 64-wide score tile
constexpr float kNegInf = -1e30f;

// The CUDA-core kernels below take fp32 (T = float); bf16 runs on the
// tensor-core kernels of namespace tc.
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Stage rows [row0, row0 + 64) of head `h` of a [B, S, H, D] tensor into
// shared memory as fp32 with a padded row stride D + 1; rows past S are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int row0, int h, int S, int H) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S) x = to_float(src[((static_cast<size_t>(b) * S + s) * H + h) * D + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// Warp 0 stages the segment ids of rows [row0, row0 + 64) (0 past S) and
// writes {min non-zero id, max id} to stat[0..1] (max 0 = all padding).
// Optionally stages two per-row fp32 values (lse, delta) for head h.
__device__ __forceinline__ void load_seg_tile(
    int* seg_s, int* stat, const int* __restrict__ seg, int b, int row0, int S,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* lse_s, float* delta_s, int h, int Hq) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int lo = 0x7fffffff;
  int hi = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = lane + 32 * e;
    const int s = row0 + r;
    const int id = s < S ? seg[static_cast<size_t>(b) * S + s] : 0;
    seg_s[r] = id;
    if (id > 0) lo = min(lo, id);
    hi = max(hi, id);
    if (lse != nullptr) {
      const size_t at = (static_cast<size_t>(b) * S + s) * Hq + h;
      lse_s[r] = s < S ? lse[at] : 0.f;
      delta_s[r] = s < S ? delta[at] : 0.f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    stat[0] = lo;
    stat[1] = hi;
  }
}

// Whether a (query tile, key tile) pair can hold any attended position:
// both tiles carry real rows and their segment ranges intersect.  (The
// causal test is in the loop bounds.)
__device__ __forceinline__ bool tiles_overlap(const int* qstat, const int* kstat) {
  return qstat[1] > 0 && kstat[1] > 0 && kstat[0] <= qstat[1] &&
         kstat[1] >= qstat[0];
}

__device__ __forceinline__ bool attends(int sq, int sk, int qpos, int kpos,
                                        int causal) {
  return sq > 0 && sq == sk && (!causal || qpos >= kpos);
}

// ---------------------------------------------------------------------------
// K1f: grid (ceil(S/64), Hq, B).  Thread (ty, tx) owns query rows
// ty + 16 i (i < 4); for scores, key columns tx + 16 jj (jj < 4); for the
// output, head-dim columns tx + 16 j (j < D/16).
// Shared memory: q, k-then-v tiles (64 x (D+1) each), probabilities
// (64 x 65), segment ids and tile stats.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
    int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* kv_s = q_s + kTile * DP;
  float* p_s = kv_s + kTile * DP;
  int* segq_s = reinterpret_cast<int*>(p_s + kTile * kPS);
  int* segk_s = segq_s + kTile;
  int* stat_s = segk_s + kTile;  // q min/max, k min/max

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nk = (S + kTile - 1) / kTile;

  load_seg_tile(segq_s, stat_s, seg, b, q0, S, nullptr, nullptr, nullptr,
                nullptr, 0, 0);
  load_tile<T, D>(q_s, q, b, q0, h, S, Hq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kt_end = causal ? min(nk - 1, qt) : nk - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_seg_tile(segk_s, stat_s + 2, seg, b, k0, S, nullptr, nullptr, nullptr,
                  nullptr, 0, 0);
    __syncthreads();
    if (!tiles_overlap(stat_s, stat_s + 2)) continue;  // uniform
    load_tile<T, D>(kv_s, k, b, k0, hk, S, Hkv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ka[jj] = kv_s[(tx + 16 * jj) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
    }

    // Online softmax: the 16 threads of a row (one half-warp) reduce its
    // 64 scores with shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int sq = segq_s[r];
      unsigned mask = 0;
      float tmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        if (attends(sq, segk_s[c], q0 + r, k0 + c, causal)) {
          mask |= 1u << jj;
          s[i][jj] *= scale;
          tmax = fmaxf(tmax, s[i][jj]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = (mask >> jj) & 1u ? expf(s[i][jj] - m_new) : 0.f;
        psum += p;
        p_s[r * kPS + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // probabilities written, K reads done
    load_tile<T, D>(kv_s, v, b, k0, hk, S, Hkv);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float va[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) va[j] = kv_s[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, va[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_row = q0 + ty + 16 * i;
    if (s_row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // padding rows: 0
    const size_t base = ((static_cast<size_t>(b) * S + s_row) * Hq + h);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[base * D + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
    if (tx == 0) lse[base] = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// K1dq: grid (ceil(S/64), Hq, B).  P = exp(s - lse) is recomputed per key
// tile, dS = P (dP - delta) scale with dP = dO V^T, and dq += dS K.  At
// D = 256 four staged tiles overflow shared memory: V and then K take
// turns in one buffer (dP first, then S and dS K).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  constexpr bool kOneKv = D > 128;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * DP;
  float* k_s = do_s + kTile * DP;
  float* v_s = kOneKv ? k_s : k_s + kTile * DP;
  float* ds_s = v_s + kTile * DP;
  float* lse_s = ds_s + kTile * kPS;
  float* delta_s = lse_s + kTile;
  int* segq_s = reinterpret_cast<int*>(delta_s + kTile);
  int* segk_s = segq_s + kTile;
  int* stat_s = segk_s + kTile;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nk = (S + kTile - 1) / kTile;

  load_seg_tile(segq_s, stat_s, seg, b, q0, S, lse, delta, lse_s, delta_s, h,
                Hq);
  load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
  load_tile<T, D>(do_s, dout, b, q0, h, S, Hq);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int kt_end = causal ? min(nk - 1, qt) : nk - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_seg_tile(segk_s, stat_s + 2, seg, b, k0, S, nullptr, nullptr, nullptr,
                  nullptr, 0, 0);
    __syncthreads();
    if (!tiles_overlap(stat_s, stat_s + 2)) continue;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    if constexpr (kOneKv) {
      load_tile<T, D>(v_s, v, b, k0, hk, S, Hkv);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float da[4], va[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i] = do_s[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) va[jj] = v_s[(tx + 16 * jj) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dp[i][jj] = fmaf(da[i], va[jj], dp[i][jj]);
      }
      __syncthreads();  // V reads done: K takes the buffer
      load_tile<T, D>(k_s, k, b, k0, hk, S, Hkv);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) ka[jj] = k_s[(tx + 16 * jj) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
      }
    } else {
      load_tile<T, D>(k_s, k, b, k0, hk, S, Hkv);
      load_tile<T, D>(v_s, v, b, k0, hk, S, Hkv);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float qa[4], da[4], ka[4], va[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = q_s[(ty + 16 * i) * DP + d];
          da[i] = do_s[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          ka[jj] = k_s[(tx + 16 * jj) * DP + d];
          va[jj] = v_s[(tx + 16 * jj) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
            dp[i][jj] = fmaf(da[i], va[jj], dp[i][jj]);
          }
    }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int sq = segq_s[r];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        float ds = 0.f;
        if (attends(sq, segk_s[c], q0 + r, k0 + c, causal)) {
          const float p = expf(s[i][jj] * scale - lse_s[r]);
          ds = p * (dp[i][jj] - delta_s[r]) * scale;
        }
        ds_s[r * kPS + c] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float ka[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) ka[j] = k_s[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, ka[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_row = q0 + ty + 16 * i;
    if (s_row >= S) continue;
    const size_t base = ((static_cast<size_t>(b) * S + s_row) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K1dkv: grid (ceil(S/64), Hkv, B).  One block per (row, kv head, key
// tile) loops over the kv head's Hq/Hkv query heads and the query tiles
// at or below the diagonal: dV += P^T dO, dK += dS^T Q, summed over the
// group in registers.  Thread (ty, tx) owns key rows ty + 16 i and
// head-dim columns tx + 16 j.  At D = 256 four staged tiles overflow
// shared memory: Q and dO take turns in one buffer (Q for S, dO for dP
// and dV, then Q again for dK).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv, float scale,
    int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  constexpr bool kOneQ = D > 128;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = kOneQ ? q_s : q_s + kTile * DP;
  float* p_s = do_s + kTile * DP;
  float* ds_s = p_s + kTile * kPS;
  float* lse_s = ds_s + kTile * kPS;
  float* delta_s = lse_s + kTile;
  int* segq_s = reinterpret_cast<int*>(delta_s + kTile);
  int* segk_s = segq_s + kTile;
  int* stat_s = segk_s + kTile;

  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nq = (S + kTile - 1) / kTile;

  load_seg_tile(segk_s, stat_s + 2, seg, b, k0, S, nullptr, nullptr, nullptr,
                nullptr, 0, 0);
  load_tile<T, D>(k_s, k, b, k0, hk, S, Hkv);
  load_tile<T, D>(v_s, v, b, k0, hk, S, Hkv);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_seg_tile(segq_s, stat_s, seg, b, q0, S, lse, delta, lse_s, delta_s,
                    h, Hq);
      __syncthreads();
      if (!tiles_overlap(stat_s, stat_s + 2)) continue;  // uniform
      // Score tile: rows are query rows r = ty + 16 i, columns key rows
      // c = tx + 16 jj.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
      if constexpr (kOneQ) {
        load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float qa[4], ka[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) ka[jj] = k_s[(tx + 16 * jj) * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
        }
        __syncthreads();  // Q reads done: dO takes the buffer
        load_tile<T, D>(do_s, dout, b, q0, h, S, Hq);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float da[4], va[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) da[i] = do_s[(ty + 16 * i) * DP + d];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) va[jj] = v_s[(tx + 16 * jj) * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) dp[i][jj] = fmaf(da[i], va[jj], dp[i][jj]);
        }
      } else {
        load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
        load_tile<T, D>(do_s, dout, b, q0, h, S, Hq);
        __syncthreads();
#pragma unroll 2
        for (int d = 0; d < D; ++d) {
          float qa[4], da[4], ka[4], va[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = q_s[(ty + 16 * i) * DP + d];
            da[i] = do_s[(ty + 16 * i) * DP + d];
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            ka[jj] = k_s[(tx + 16 * jj) * DP + d];
            va[jj] = v_s[(tx + 16 * jj) * DP + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
              dp[i][jj] = fmaf(da[i], va[jj], dp[i][jj]);
            }
      }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int sq = segq_s[r];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj;
          float p = 0.f;
          float ds = 0.f;
          if (attends(sq, segk_s[c], q0 + r, k0 + c, causal)) {
            p = expf(s[i][jj] * scale - lse_s[r]);
            ds = p * (dp[i][jj] - delta_s[r]) * scale;
          }
          p_s[r * kPS + c] = p;
          ds_s[r * kPS + c] = ds;
        }
      }
      __syncthreads();
      if constexpr (kOneQ) {
#pragma unroll 2
        for (int r = 0; r < kTile; ++r) {  // dV += P^T dO (the buffer holds dO)
          float da[DJ];
#pragma unroll
          for (int j = 0; j < DJ; ++j) da[j] = do_s[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = p_s[r * kPS + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < DJ; ++j) dv_acc[i][j] = fmaf(p, da[j], dv_acc[i][j]);
          }
        }
        __syncthreads();  // dO reads done: Q again
        load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
        __syncthreads();
#pragma unroll 2
        for (int r = 0; r < kTile; ++r) {  // dK += dS^T Q
          float qa[DJ];
#pragma unroll
          for (int j = 0; j < DJ; ++j) qa[j] = q_s[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = ds_s[r * kPS + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < DJ; ++j) dk_acc[i][j] = fmaf(ds, qa[j], dk_acc[i][j]);
          }
        }
        continue;
      }
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float qa[DJ], da[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          qa[j] = q_s[r * DP + tx + 16 * j];
          da[j] = do_s[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ty + 16 * i;
          const float p = p_s[r * kPS + c];
          const float ds = ds_s[r * kPS + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(p, da[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qa[j], dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_row = k0 + ty + 16 * i;
    if (s_row >= S) continue;
    const size_t base = ((static_cast<size_t>(b) * S + s_row) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = from_float<T>(dk_acc[i][j]);
      dv[base + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernels, the main path, on the tensor cores.  A block's warps
// each own 16 of its 64 rows (a warpgroup of 4 warps per 64 rows); it
// lists once, with warp ballots, the tiles on the other side that survive
// the causal and segment-overlap skips (`list_live`), and walks them
// through a 2-stage cp.async ring of bf16 tiles: the copy of the next
// live tile is in flight while the current one is computed, one barrier
// a tile.  Products have fp32 accumulators; a probability or dS tile goes
// to bf16 in registers and is used as the a operand where it lies (the
// fp32 accumulator layout of a warp's 16 rows is the bf16 a layout).  The
// softmax runs in the log2 domain (exp2f of scores pre-scaled by
// scale * log2 e).  Results leave through shared memory as 16-byte row
// stores; rows past S are never written and padding rows are exact
// zeros.  Causal query-tile grids run their last tiles, the longest
// walks, first.
//   flash_fwd_mma_kernel<D, G>: grid (Hq / G, ceil(S/64), B).  A block
//     serves G q heads of one kv head (G = 3, 2 or 1, the largest that
//     divides Hq / Hkv), one warpgroup each, over one ring of that kv
//     head's K/V tiles, so the group's heads read each tile from L2
//     together.  Its products are warpgroup MMAs (wgmma): S = Q K^T
//     reads Q and K straight from shared memory, O += P V takes P from
//     registers and V from shared memory, so a tile is read once for 64
//     rows and not once a warp; its tiles use wgmma's 128-byte swizzle
//     (WTile).  Per live key tile: S, the mask (only where a warp's rows
//     or the tile's keys are not one segment, or the tile crosses the
//     diagonal), the online softmax, then O += P V.
//   flash_dq_mma_kernel: grid (Hq, ceil(S/64), B), the same walk, one
//     warpgroup on mma.sync.  Q and dO stay in shared memory (a fragments
//     by ldmatrix per k step); per live key tile, S = Q K^T and
//     dP = dO V^T, P = exp2(S scale log2e - lse log2e) under the mask,
//     dS = P (dP - delta) scale, and dQ += dS K with dS split into a bf16
//     hi + lo pair (two products) and K as b fragments by ldmatrix.trans
//     from the same tile.
//   flash_dkv_mma_kernel: grid (ceil(S/64), Hkv, B), mma.sync.  A block
//     owns key rows [k0, k0 + 64) of kv head hk and keeps dK and dV in
//     fp32 accumulators while it walks the group's rep q-heads and, for
//     each, the live query tiles: K and V are loaded once, each (q-head,
//     query tile) pair's Q, dO, segment ids, lse and delta come through
//     the ring.  Per pair and warp: S^T = K Q^T and dP^T = V dO^T,
//     P^T and dS^T as above, dV += P^T dO and dK += dS^T Q with dO and Q
//     as b fragments by ldmatrix.trans.  The group sum stays in
//     registers: no atomics, no per-q-head buffer.
// ---------------------------------------------------------------------------
namespace tc {

using tiles::a_chunk;
using tiles::a_row;
using tiles::b_chunk;
using tiles::b_row;
using tiles::cp_async16;
using tiles::cp_async4;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::kLog2e;
using tiles::ldsm_x4;
using tiles::ldsm_x4_trans;
using tiles::mma_bf16;
using tiles::pack_bf16;
using tiles::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows of a block's own tile and of each walked tile
constexpr int kWarps = 4;  // one m16 tile of the block's rows each: one warpgroup
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kLn2 = 0.6931471805599453f;

// A 64-row bf16 tile in wgmma's 128-byte-swizzle layout: column blocks of
// 64 elements (128-byte rows, 8 KB a block), each row's 16-byte chunks
// XOR-swizzled by row & 7.  On a 1024-byte-aligned base this is the
// hardware's own swizzle of address bits 4-6 by bits 7-9.
template <int D>
struct WTile {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kBlock = kRows * 128;
  static constexpr int kBytes = (D / 64) * kBlock;
  static_assert(D % 64 == 0, "whole 64-element column blocks");
  static __device__ __forceinline__ int offset(int row, int chunk) {
    return (chunk >> 3) * kBlock + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
  }
};

template <int D>
struct Plan {
  using T = tiles::Tile<bf16, D, true, kRows>;  // ldmatrix tiles (dq, dkv)
  using W = WTile<D>;                            // wgmma tiles (forward)
  // A ring stage of the dq walk: K and V tiles, then the key rows'
  // segment ids.  Of the forward's: the same in wgmma tiles, padded so
  // every tile starts on a 1024-byte boundary.
  static constexpr int kKvStage = 2 * T::kBytes + kRows * 4;
  static constexpr int kKvStageW = 2 * W::kBytes + 1024;
  // Of the dkv walk: Q and dO tiles, then segment ids, lse and delta.
  static constexpr int kQStage = 2 * T::kBytes + 3 * kRows * 4;
  // Shared memory before the per-call tail of 3 ints a tile (ranges,
  // list).  The forward's is 1024 bytes of slack to align its base, one
  // Q tile a warpgroup (added by the launch) and the ring.
  static constexpr int kFwdBytes = 1024 + kStages * kKvStageW;
  static constexpr int kDqBytes = 2 * T::kBytes + kStages * kKvStage;
  static constexpr int kDkvBytes = 2 * T::kBytes + kStages * kQStage;
};

// {min non-zero id, max id} of two segment ids a lane, over the warp.
__device__ __forceinline__ void warp_range(int id0, int id1, int& lo, int& hi) {
  lo = 0x7fffffff;
  hi = max(id0, id1);
  if (id0 > 0) lo = id0;
  if (id1 > 0) lo = min(lo, id1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The tiles t in [t0, t1) that can hold an attended pair with the block's
// own tile `own` (one of them): the warps take the segment ranges of
// batches of 4 tiles in turn into rng[2t], rng[2t + 1], then warp 0 lists
// the tiles whose range meets the own tile's, in order, into live[].
// Called by every thread; returns their count (0 when the own tile is
// all padding).
__device__ __forceinline__ int list_live(const int* __restrict__ seg_row, int S,
                                         int t0, int t1, int own, int* rng, int* live) {
  __shared__ int n_live_s;
  constexpr int kBatch = 4;  // tiles a warp reads at once, so their loads overlap
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int tb = t0 + warp * kBatch; tb < t1; tb += n_warps * kBatch) {
    int id[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = (tb + j) * kRows + lane + 32 * e;
        id[j][e] = tb + j < t1 && s < S ? seg_row[s] : 0;
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      int tlo, thi;
      warp_range(id[j][0], id[j][1], tlo, thi);
      if (lane == 0 && tb + j < t1) {
        rng[2 * (tb + j)] = tlo;
        rng[2 * (tb + j) + 1] = thi;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int lo = rng[2 * own];
    const int hi = rng[2 * own + 1];
    int count = 0;
    for (int c = t0; c < t1; c += 32) {
      const int t = c + lane;
      const bool f = t < t1 && hi > 0 && rng[2 * t + 1] > 0 && rng[2 * t] <= hi &&
                     rng[2 * t + 1] >= lo;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) live[count + __popc(m & ((1u << lane) - 1u))] = t;
      count += __popc(m);
    }
    if (lane == 0) n_live_s = count;
  }
  __syncthreads();
  return n_live_s;
}

// A block's own query rows as one warp of the forward or dq kernel sees
// them (16 rows from r0w).
struct QueryRows {
  int r0w;       // first row of this warp
  int sq0, sq1;  // segment ids of this thread's rows r0w + g8 and + 8 (0 past S)
  int wlo, whi;  // segment range of the warp's 16 rows (whi == 0: all padding)
  int wuni;      // their one id if all 16 share it (> 0), else 0
};

__device__ __forceinline__ QueryRows query_rows(const int* __restrict__ seg_row,
                                                int S, int q0, int warp, int lane) {
  QueryRows r;
  r.r0w = q0 + warp * 16;
  const int g8 = lane >> 2;
  r.sq0 = r.r0w + g8 < S ? seg_row[r.r0w + g8] : 0;
  r.sq1 = r.r0w + g8 + 8 < S ? seg_row[r.r0w + g8 + 8] : 0;
  int lo = 0x7fffffff, hi = max(r.sq0, r.sq1), mn = min(r.sq0, r.sq1);
  if (r.sq0 > 0) lo = r.sq0;
  if (r.sq1 > 0) lo = min(lo, r.sq1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  r.wlo = lo;
  r.whi = hi;
  r.wuni = mn == hi ? hi : 0;
  return r;
}

// Whether a warp's rows see nothing of key tile [k0, k0 + 64) with
// segment range [klo, khi] (warp-uniform).
__device__ __forceinline__ bool warp_skips(const QueryRows& r, int k0, int klo,
                                           int khi, int causal) {
  return r.whi == 0 || klo > r.whi || khi < r.wlo || (causal && k0 > r.r0w + 15);
}

// Whether every (row, key) pair of the warp and the staged key tile is
// attended, so no mask is needed: the warp's rows and the tile's keys
// are one segment, and the tile lies at or below the warp's diagonal.
__device__ __forceinline__ bool warp_full(const QueryRows& r, const int* seg_st,
                                          int k0, int causal, int lane) {
  if (r.wuni == 0 || (causal && k0 + kRows - 1 > r.r0w)) return false;
  return __all_sync(0xffffffffu, seg_st[lane] == r.wuni && seg_st[lane + 32] == r.wuni);
}

// Whether this thread's row g8 + 8 hf of the warp attends the key at
// position kpos with segment id sk: the ids agree (> 0) and, if causal,
// the key is not after the row.
__device__ __forceinline__ bool attended(const QueryRows& r, int hf, int sk, int kpos,
                                         int g8, int causal) {
  const int sq = hf ? r.sq1 : r.sq0;
  return sq > 0 && sk == sq && (!causal || kpos <= r.r0w + g8 + 8 * hf);
}

// Copies rows [row0, row0 + 64) of head h of two [B, S, H, D] bf16
// tensors (K and V, or Q and dO) into two tiles of layout L (Plan::T or
// Plan::W) with the block's N threads; rows past S are zero-filled
// (source size 0).
template <typename L, int N = kThreads>
__device__ __forceinline__ void load_rows2(char* dst0, const bf16* __restrict__ src0,
                                           char* dst1, const bf16* __restrict__ src1,
                                           int b, int row0, int h, int S, int H) {
  constexpr int D = L::kRowBytes / 2;
#pragma unroll
  for (int i = threadIdx.x; i < kRows * L::kChunks; i += N) {
    const int r = i / L::kChunks;
    const int c = i % L::kChunks;
    const bool ok = row0 + r < S;
    const size_t off = ((static_cast<size_t>(b) * S + row0 + (ok ? r : 0)) * H + h) * D;
    const uint32_t at = L::offset(r, c);
    cp_async16(smem_u32(dst0 + at), reinterpret_cast<const char*>(src0 + off) + c * 16, ok);
    cp_async16(smem_u32(dst1 + at), reinterpret_cast<const char*>(src1 + off) + c * 16, ok);
  }
}

// Copies this warp's 16 rows (warp * 16 on) of the 64 rows from row0 of
// head h of a [B, S, H, D] bf16 tensor into a tile of layout L.
template <typename L>
__device__ __forceinline__ void load_warp_rows(char* dst, const bf16* __restrict__ src,
                                               int b, int row0, int h, int S, int H,
                                               int warp, int lane) {
  constexpr int D = L::kRowBytes / 2;
#pragma unroll
  for (int e = 0; e < 16 * L::kChunks / 32; ++e) {
    const int i = e * 32 + lane;
    const int r = warp * 16 + i / L::kChunks;
    const int c = i % L::kChunks;
    const bool ok = row0 + r < S;
    const size_t off = ((static_cast<size_t>(b) * S + row0 + (ok ? r : 0)) * H + h) * D;
    cp_async16(smem_u32(dst + L::offset(r, c)),
               reinterpret_cast<const char*>(src + off) + c * 16, ok);
  }
}

// Key tile `t` (K, V, segment ids) of layout L into its ring stage.
template <typename L, int N = kThreads>
__device__ __forceinline__ void load_kv(char* st, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const int* __restrict__ seg_row, int b, int t,
                                        int hk, int S, int Hkv) {
  const int k0 = t * kRows;
  load_rows2<L, N>(st, k, st + L::kBytes, v, b, k0, hk, S, Hkv);
  if (threadIdx.x < kRows) {
    const bool ok = k0 + threadIdx.x < S;
    cp_async4(smem_u32(st + 2 * L::kBytes + 4 * threadIdx.x),
              seg_row + (ok ? k0 + threadIdx.x : 0), ok);
  }
}

// Two fp32 values as packed bf16: hi = their rounding, lo = the rounding
// of what hi leaves out (hi + lo carries ~16 bits of each value).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - r.x, b - r.y);
}

// Writes this warp's 16 rows of acc (rows g8 scaled by sc0, g8 + 8 by sc1;
// DC columns) as bf16 into its own rows of a swizzled DC-wide tile, then
// stores them as columns [c0, c0 + DC) of [B, S, H, D] `dst` with 16-byte
// stores (rows past S are skipped).
template <int D, int DC = D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, char* tile,
                                           const float (&acc)[DC / 8][4], float sc0,
                                           float sc1, int b, int row0, int h, int S,
                                           int H, int warp, int lane, int c0 = 0) {
  using T = tiles::Tile<bf16, DC, true, kRows>;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DC / 8; ++nt) {
    const int r = warp * 16 + g8;
    *reinterpret_cast<uint32_t*>(tile + T::offset(r, nt) + 4 * t4) =
        pack_bf16(acc[nt][0] * sc0, acc[nt][1] * sc0);
    *reinterpret_cast<uint32_t*>(tile + T::offset(r + 8, nt) + 4 * t4) =
        pack_bf16(acc[nt][2] * sc1, acc[nt][3] * sc1);
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 16 * T::kChunks / 32; ++e) {
    const int i = e * 32 + lane;
    const int r = warp * 16 + i / T::kChunks;
    const int c = i % T::kChunks;
    if (row0 + r < S) {
      const size_t off = ((static_cast<size_t>(b) * S + row0 + r) * H + h) * D + c0;
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst + off) + c * 16) =
          *reinterpret_cast<const uint4*>(tile + T::offset(r, c));
    }
  }
}

// ---- warpgroup MMA (wgmma) -------------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Step kk (16 elements of D) of a K-major WTile operand (rows x D): the
// k16 slice sits in column block kk / 4, 32 bytes per step within its
// 128-byte rows; 8-row groups are 1024 bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const char* tile, int kk) {
  return gmma_desc(smem_u32(tile) + (kk >> 2) * WTile<D>::kBlock + (kk & 3) * 32, 16, 1024);
}
// Step kp (16 key rows) of an MN-major WTile operand (keys x D as K x N):
// 8-key groups 1024 bytes apart, 64-element column blocks of N kBlock
// apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const char* tile, int kp) {
  return gmma_desc(smem_u32(tile) + kp * 16 * 128, WTile<D>::kBlock, 1024);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to accumulators across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
// Makes this thread's completed cp.async writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, fp32; this thread's 32) += A * B^T, with A (64 x 16) and B
// (64 x 16) K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32; this thread's 32) += A * B, with A (64 x 16 bf16) in
// registers (this warp's 16 rows, the mma.sync a layout) and B (16 x 64)
// MN-major in shared memory (descriptor; imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4],
                                                  const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[O .. O + 16) (64 x 128, fp32; this thread's 64) += A * B, with A
// (64 x 16 bf16) in registers (this warp's 16 rows, the mma.sync a
// layout) and B (16 x 128) MN-major in shared memory (descriptor;
// imm-trans-b = 1).
template <int N, int O = 0>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[N][4],
                                                  const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(O + 16 <= N, "16 n8 tiles of accumulators from O");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0][0]), "+f"(d[O + 0][1]), "+f"(d[O + 0][2]), "+f"(d[O + 0][3]),
        "+f"(d[O + 1][0]), "+f"(d[O + 1][1]), "+f"(d[O + 1][2]), "+f"(d[O + 1][3]),
        "+f"(d[O + 2][0]), "+f"(d[O + 2][1]), "+f"(d[O + 2][2]), "+f"(d[O + 2][3]),
        "+f"(d[O + 3][0]), "+f"(d[O + 3][1]), "+f"(d[O + 3][2]), "+f"(d[O + 3][3]),
        "+f"(d[O + 4][0]), "+f"(d[O + 4][1]), "+f"(d[O + 4][2]), "+f"(d[O + 4][3]),
        "+f"(d[O + 5][0]), "+f"(d[O + 5][1]), "+f"(d[O + 5][2]), "+f"(d[O + 5][3]),
        "+f"(d[O + 6][0]), "+f"(d[O + 6][1]), "+f"(d[O + 6][2]), "+f"(d[O + 6][3]),
        "+f"(d[O + 7][0]), "+f"(d[O + 7][1]), "+f"(d[O + 7][2]), "+f"(d[O + 7][3]),
        "+f"(d[O + 8][0]), "+f"(d[O + 8][1]), "+f"(d[O + 8][2]), "+f"(d[O + 8][3]),
        "+f"(d[O + 9][0]), "+f"(d[O + 9][1]), "+f"(d[O + 9][2]), "+f"(d[O + 9][3]),
        "+f"(d[O + 10][0]), "+f"(d[O + 10][1]), "+f"(d[O + 10][2]), "+f"(d[O + 10][3]),
        "+f"(d[O + 11][0]), "+f"(d[O + 11][1]), "+f"(d[O + 11][2]), "+f"(d[O + 11][3]),
        "+f"(d[O + 12][0]), "+f"(d[O + 12][1]), "+f"(d[O + 12][2]), "+f"(d[O + 12][3]),
        "+f"(d[O + 13][0]), "+f"(d[O + 13][1]), "+f"(d[O + 13][2]), "+f"(d[O + 13][3]),
        "+f"(d[O + 14][0]), "+f"(d[O + 14][1]), "+f"(d[O + 14][2]), "+f"(d[O + 14][3]),
        "+f"(d[O + 15][0]), "+f"(d[O + 15][1]), "+f"(d[O + 15][2]), "+f"(d[O + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O (64 x D) += P V for one k16 step of keys.  D = 256 takes two n128
// products, the second on V's column blocks 2 and 3 (2 kBlock further
// on; the descriptor's start address is in 16-byte units).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 256) {
    wgmma_m64n128k16_rs<32, 0>(d, a, desc_b);
    wgmma_m64n128k16_rs<32, 16>(d, a, desc_b + ((2 * WTile<D>::kBlock) >> 4));
  } else if constexpr (D == 128) {
    wgmma_m64n128k16_rs(d, a, desc_b);
  } else {
    wgmma_m64n64k16_rs(d, a, desc_b);
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads * G) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg, bf16* __restrict__ o,
    float* __restrict__ lse, int S, int Hq, int Hkv, float scale, int causal) {
  using P = Plan<D>;
  using W = typename P::W;
  extern __shared__ __align__(16) char smem_raw[];
  // wgmma swizzles address bits: the tiles start on 1024-byte boundaries.
  char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nk = (S + kRows - 1) / kRows;
  char* ring = smem + G * W::kBytes;  // after the G Q tiles
  int* rng = reinterpret_cast<int*>(ring + kStages * P::kKvStageW);
  int* live = rng + 2 * nk;

  const int tid = threadIdx.x;
  const int warp = tid / 32 % kWarps;  // within its warpgroup
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  // Warpgroup wg serves q head h; the block's G heads share kv head hk.
  const int wg = tid / kThreads;
  const int h = blockIdx.x * G + wg;
  const int hk = blockIdx.x * G / (Hq / Hkv);
  const int nq = gridDim.y;
  const int qt = causal ? nq - 1 - blockIdx.y : blockIdx.y;  // longest walks first
  const int b = blockIdx.z;
  const int q0 = qt * kRows;
  const int* seg_row = seg + static_cast<size_t>(b) * S;
  char* q_s = smem + wg * W::kBytes;

  const QueryRows rows = query_rows(seg_row, S, q0, warp, lane);
  // Each warp copies its own Q rows, in flight during the listing; a
  // warp of padding rows copies none (whatever they hold, the mask sets
  // their scores, and they are never stored).
  if (rows.whi > 0) load_warp_rows<W>(q_s, q, b, q0, h, S, Hq, warp, lane);
  cp_async_commit();
  const int n_live = list_live(seg_row, S, 0, causal ? qt + 1 : nk, qt, rng, live);
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = tiles::kNegInf, m1 = tiles::kNegInf, l0 = 0.f, l1 = 0.f;

  if (n_live > 0) {  // else every row is padding: zeros, no K/V read
    load_kv<W, kThreads * G>(ring, k, v, seg_row, b, live[0], hk, S, Hkv);
    cp_async_commit();
    for (int i = 0; i < n_live; ++i) {
      cp_async_wait<0>();
      fence_async_proxy();
      __syncthreads();  // tile i (and Q) visible; every warp is done with i - 1
      if (i + 1 < n_live)
        load_kv<W, kThreads * G>(ring + ((i + 1) % kStages) * P::kKvStageW, k, v, seg_row,
                                 b, live[i + 1], hk, S, Hkv);
      cp_async_commit();

      const int k0 = live[i] * kRows;
      const char* kt = ring + (i % kStages) * P::kKvStageW;
      const char* vt = kt + W::kBytes;
      const int* seg_st = reinterpret_cast<const int*>(vt + W::kBytes);

      // S = Q K^T for the block's 64 rows, Q and K read from shared memory.
      float s[kRows / 8][4];
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(s, desc_kmajor<D>(q_s, kk), desc_kmajor<D>(kt, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Scale into the log2 domain and mask, then the online softmax (a
      // row's scores sit in the 4 threads of a quad).
      const bool full = warp_full(rows, seg_st, k0, causal, lane);
      float mx0 = tiles::kNegInf, mx1 = tiles::kNegInf;
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t4 + e;
          s[n][e] *= scale_log2;
          s[n][2 + e] *= scale_log2;
          if (!full) {
            const int sk = seg_st[c];
            if (!attended(rows, 0, sk, k0 + c, g8, causal)) s[n][e] = tiles::kNegInf;
            if (!attended(rows, 1, sk, k0 + c, g8, causal)) s[n][2 + e] = tiles::kNegInf;
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
      // A row that has seen no key yet keeps p = 0 (exp2f(0) of two
      // sentinels would be 1); once live, masked scores give exp2f(-1e30).
      const bool live0 = mn0 > tiles::kNegInf;
      const bool live1 = mn1 > tiles::kNegInf;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] = live0 ? exp2f(s[n][e] - mn0) : 0.f;
          s[n][2 + e] = live1 ? exp2f(s[n][2 + e] - mn1) : 0.f;
          l0 += s[n][e];
          l1 += s[n][2 + e];
        }
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][0] *= a0;
        acc[nt][1] *= a0;
        acc[nt][2] *= a1;
        acc[nt][3] *= a1;
      }
      // O += P V: P in bf16 as the register a operand, one k16 step of
      // keys at a time; V read from shared memory.
      uint32_t pa[kRows / 16][4];
#pragma unroll
      for (int kp = 0; kp < kRows / 16; ++kp) {
        pa[kp][0] = pack_bf16(s[2 * kp][0], s[2 * kp][1]);
        pa[kp][1] = pack_bf16(s[2 * kp][2], s[2 * kp][3]);
        pa[kp][2] = pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]);
        pa[kp][3] = pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kp = 0; kp < kRows / 16; ++kp) wgmma_pv<D>(acc, pa[kp], desc_mnmajor<D>(vt, kp));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with its Q: q_s takes its output

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_rows<D>(o, q_s, acc, l0 > 0.f ? 1.f / l0 : 0.f, l1 > 0.f ? 1.f / l1 : 0.f, b, q0,
                h, S, Hq, warp, lane);
  if (t4 == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = rows.r0w + g8 + 8 * hf;
      const float l = hf ? l1 : l0;
      const float m = hf ? m1 : m0;
      if (row < S)
        lse[(static_cast<size_t>(b) * S + row) * Hq + h] =
            l > 0.f ? m * kLn2 + logf(l) : tiles::kNegInf;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int Hq, int Hkv,
    float scale, int causal) {
  using P = Plan<D>;
  using T = typename P::T;
  extern __shared__ __align__(16) char smem[];
  const int nk = (S + kRows - 1) / kRows;
  char* q_s = smem;
  char* do_s = q_s + T::kBytes;
  char* ring = do_s + T::kBytes;
  int* rng = reinterpret_cast<int*>(ring + kStages * P::kKvStage);
  int* live = rng + 2 * nk;

  const int h = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest walks first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = qt * kRows;
  const int* seg_row = seg + static_cast<size_t>(b) * S;

  const QueryRows rows = query_rows(seg_row, S, q0, warp, lane);
  if (rows.whi > 0) {  // this warp's own Q and dO rows, in flight during the listing
    load_warp_rows<T>(q_s, q, b, q0, h, S, Hq, warp, lane);
    load_warp_rows<T>(do_s, dout, b, q0, h, S, Hq, warp, lane);
  }
  cp_async_commit();
  const int n_live = list_live(seg_row, S, 0, causal ? qt + 1 : nk, qt, rng, live);
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  if (n_live > 0) {
    // lse (log2 domain) and delta of this thread's two rows.
    float lse2[2], dl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = rows.r0w + g8 + 8 * hf;
      const size_t at = (static_cast<size_t>(b) * S + (row < S ? row : 0)) * Hq + h;
      lse2[hf] = row < S ? lse[at] * kLog2e : 0.f;
      dl[hf] = row < S ? delta[at] : 0.f;
    }
    load_kv<T>(ring, k, v, seg_row, b, live[0], hk, S, Hkv);
    cp_async_commit();

    for (int i = 0; i < n_live; ++i) {
      cp_async_wait<0>();
      __syncthreads();  // tile i (and Q, dO) visible; every warp is done with i - 1
      if (i + 1 < n_live)
        load_kv<T>(ring + ((i + 1) % kStages) * P::kKvStage, k, v, seg_row, b,
                   live[i + 1], hk, S, Hkv);
      cp_async_commit();

      const int t = live[i];
      const int k0 = t * kRows;
      if (warp_skips(rows, k0, rng[2 * t], rng[2 * t + 1], causal)) continue;
      const char* kt = ring + (i % kStages) * P::kKvStage;
      const char* vt = kt + T::kBytes;
      const int* seg_st = reinterpret_cast<const int*>(vt + T::kBytes);

      // S = Q K^T and dP = dO V^T, Q and dO a fragments read per k step.
      float s[kRows / 8][4], dp[kRows / 8][4];
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_x4(smem_u32(q_s + T::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))), qa);
        ldsm_x4(smem_u32(do_s + T::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))), da);
#pragma unroll
        for (int np = 0; np < kRows / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4(smem_u32(kt + T::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(s[2 * np], qa, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], qa, bb[2], bb[3]);
          ldsm_x4(smem_u32(vt + T::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(dp[2 * np], da, bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], da, bb[2], bb[3]);
        }
      }
      // dS = P (dP - delta) scale in place of S.  Element (n, 2 hf + e):
      // row g8 + 8 hf, key column n * 8 + 2 t4 + e.
      const bool full = warp_full(rows, seg_st, k0, causal, lane);
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t4 + e;
          const int sk = full ? 0 : seg_st[c];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const bool ok = full || attended(rows, hf, sk, k0 + c, g8, causal);
            const float p = ok ? exp2f(s[n][2 * hf + e] * scale_log2 - lse2[hf]) : 0.f;
            s[n][2 * hf + e] = p * (dp[n][2 * hf + e] - dl[hf]) * scale;
          }
        }
      }
      // dQ += dS K, with dS as a bf16 hi + lo pair (two products on the
      // same K fragments): dS sums to ~0 along a row, so one rounding of
      // it would cost dq more than its own.
#pragma unroll
      for (int kp = 0; kp < kRows / 16; ++kp) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // a fragment j: rows g8 + 8 (j & 1), keys 8 (j >> 1) + 2 t4
          const int n = 2 * kp + (j >> 1);
          const int e = 2 * (j & 1);
          split_bf16(s[n][e], s[n][e + 1], hi[j], lo[j]);
        }
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t bb[4];
          ldsm_x4_trans(smem_u32(kt + T::offset(kp * 16 + a_row(lane), nn * 2 + a_chunk(lane))),
                        bb);
          mma_bf16(acc[2 * nn], hi, bb[0], bb[1]);
          mma_bf16(acc[2 * nn + 1], hi, bb[2], bb[3]);
          mma_bf16(acc[2 * nn], lo, bb[0], bb[1]);
          mma_bf16(acc[2 * nn + 1], lo, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // Only this warp reads its own rows of q_s: dQ goes out through them.
  store_rows<D>(dq, q_s, acc, 1.f, 1.f, b, q0, h, S, Hq, warp, lane);
}

template <int D, int NC>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int Hq, int Hkv, float scale, int causal) {
  using P = Plan<D>;
  using T = typename P::T;
  extern __shared__ __align__(16) char smem[];
  const int nq = (S + kRows - 1) / kRows;
  char* k_s = smem;
  char* v_s = k_s + T::kBytes;
  char* ring = v_s + T::kBytes;
  int* rng = reinterpret_cast<int*>(ring + kStages * P::kQStage);
  int* live = rng + 2 * nq;

  constexpr int DC = D / NC;  // the dK/dV columns this block owns: part blockIdx.x % NC
  const int kt = blockIdx.x / NC;
  const int c0 = blockIdx.x % NC * DC;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int rep = Hq / Hkv;
  const int k0 = kt * kRows;
  const int* seg_row = seg + static_cast<size_t>(b) * S;

  const int n_live = list_live(seg_row, S, causal ? kt : 0, nq, kt, rng, live);
  const int n_items = rep * n_live;  // (q-head, query tile) pairs

  // Pair `it` (q-head it / n_live, the (it % n_live)-th live query tile)
  // into its ring stage; rows past S are zero-filled.
  auto load = [&](int it) {
    const int gi = it / n_live;
    const int q0 = live[it - gi * n_live] * kRows;
    const int h = hk * rep + gi;
    char* q_st = ring + (it % kStages) * P::kQStage;
    char* do_st = q_st + T::kBytes;
    int* seg_st = reinterpret_cast<int*>(do_st + T::kBytes);
    float* lse_st = reinterpret_cast<float*>(seg_st + kRows);
    float* delta_st = lse_st + kRows;
    load_rows2<T>(q_st, q, do_st, dout, b, q0, h, S, Hq);
    if (tid < kRows) {
      const bool ok = q0 + tid < S;
      const int s = ok ? q0 + tid : 0;
      const size_t at = (static_cast<size_t>(b) * S + s) * Hq + h;
      cp_async4(smem_u32(seg_st + tid), seg_row + s, ok);
      cp_async4(smem_u32(lse_st + tid), lse + at, ok);
      cp_async4(smem_u32(delta_st + tid), delta + at, ok);
    }
  };

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int nt = 0; nt < DC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  if (n_items > 0) {
    load_rows2<T>(k_s, k, v_s, v, b, k0, hk, S, Hkv);
    load(0);
    cp_async_commit();
    // This thread's key rows, k0 + warp * 16 + g8 and + 8: segment ids.
    const int kr = k0 + warp * 16 + g8;
    const int sk0 = kr < S ? seg_row[kr] : 0;
    const int sk1 = kr + 8 < S ? seg_row[kr + 8] : 0;
    const float scale_log2 = scale * kLog2e;

    for (int it = 0; it < n_items; ++it) {
      cp_async_wait<0>();
      __syncthreads();  // pair `it` is visible; every warp is done with it - 1
      if (it + 1 < n_items) load(it + 1);
      cp_async_commit();

      const int q0 = live[it % n_live] * kRows;
      const char* q_st = ring + (it % kStages) * P::kQStage;
      const char* do_st = q_st + T::kBytes;
      const int* seg_st = reinterpret_cast<const int*>(do_st + T::kBytes);
      const float* lse_st = reinterpret_cast<const float*>(seg_st + kRows);
      const float* delta_st = lse_st + kRows;

      // S^T and dP^T: this warp's 16 key rows x the tile's 64 queries.
      float st[kRows / 8][4], dpt[kRows / 8][4];
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(smem_u32(k_s + T::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))), ka);
        ldsm_x4(smem_u32(v_s + T::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))), va);
#pragma unroll
        for (int np = 0; np < kRows / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4(smem_u32(q_st + T::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(st[2 * np], ka, bb[0], bb[1]);
          mma_bf16(st[2 * np + 1], ka, bb[2], bb[3]);
          ldsm_x4(smem_u32(do_st + T::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(dpt[2 * np], va, bb[0], bb[1]);
          mma_bf16(dpt[2 * np + 1], va, bb[2], bb[3]);
        }
      }
      // P^T and dS^T in place.  Element (n, 2 hf + e): key row kr + 8 hf,
      // query column n * 8 + 2 t4 + e.
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = n * 8 + 2 * t4 + e;
          const int sq = seg_st[qi];
          const float lse2 = lse_st[qi] * kLog2e;
          const float dl = delta_st[qi];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const bool ok = sq > 0 && sq == (hf ? sk1 : sk0) &&
                            (!causal || q0 + qi >= kr + 8 * hf);
            const float p = ok ? exp2f(st[n][2 * hf + e] * scale_log2 - lse2) : 0.f;
            st[n][2 * hf + e] = p;
            dpt[n][2 * hf + e] = p * (dpt[n][2 * hf + e] - dl) * scale;
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q, one k16 step of queries at a time.
#pragma unroll
      for (int kq = 0; kq < kRows / 16; ++kq) {
        const uint32_t pa[4] = {
            pack_bf16(st[2 * kq][0], st[2 * kq][1]), pack_bf16(st[2 * kq][2], st[2 * kq][3]),
            pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]),
            pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]), pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]),
            pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]),
            pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3])};
#pragma unroll
        for (int nn = 0; nn < DC / 16; ++nn) {
          const int ch = c0 / 8 + nn * 2 + a_chunk(lane);
          uint32_t bb[4];
          ldsm_x4_trans(smem_u32(do_st + T::offset(kq * 16 + a_row(lane), ch)), bb);
          mma_bf16(dva[2 * nn], pa, bb[0], bb[1]);
          mma_bf16(dva[2 * nn + 1], pa, bb[2], bb[3]);
          ldsm_x4_trans(smem_u32(q_st + T::offset(kq * 16 + a_row(lane), ch)), bb);
          mma_bf16(dka[2 * nn], da, bb[0], bb[1]);
          mma_bf16(dka[2 * nn + 1], da, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with the ring: stage 0 holds the output

  store_rows<D, DC>(dk, ring, dka, 1.f, 1.f, b, k0, hk, S, Hkv, warp, lane, c0);
  store_rows<D, DC>(dv, ring + T::kBytes, dva, 1.f, 1.f, b, k0, hk, S, Hkv, warp, lane, c0);
}

}  // namespace tc

// Shared-memory bytes of the fp32 (CUDA-core) kernels at head dim D.
constexpr size_t tile_bytes(int D) { return sizeof(float) * kTile * (D + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kPS; }
constexpr size_t row_bytes() { return sizeof(float) * kTile; }
constexpr size_t seg_bytes() { return sizeof(int) * (2 * kTile + 4); }
constexpr size_t fwd_smem(int D) {
  return 2 * tile_bytes(D) + score_bytes() + seg_bytes();
}
// At D = 256 dq and dkv stage 3 tiles (K/V or Q/dO take turns): 215,056
// and 231,696 bytes of the 232,448 a block may hold.
constexpr int staged_tiles(int D) { return D > 128 ? 3 : 4; }
constexpr size_t dq_smem(int D) {
  return staged_tiles(D) * tile_bytes(D) + score_bytes() + 2 * row_bytes() + seg_bytes();
}
constexpr size_t dkv_smem(int D) {
  return staged_tiles(D) * tile_bytes(D) + 2 * score_bytes() + 2 * row_bytes() + seg_bytes();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Dims {
  int B, S, Hq, Hkv;
  float scale;
  int causal;
};

template <typename T>
constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Launches `kernel` on grid x block with `smem` dynamic bytes; returns 0
// or the cudaError_t of the attribute call or the launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
           Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernels' grid over query tiles and their smem tail (3
// ints a walked tile).
dim3 tc_query_grid(const Dims& a) {
  return dim3(a.Hq, (a.S + tc::kRows - 1) / tc::kRows, a.B);
}
size_t tc_tail(const Dims& a) {
  return 3 * sizeof(int) * ((a.S + tc::kRows - 1) / tc::kRows);
}

// The bf16 forward with G q heads of a kv head a block.
template <int D, int G>
int fwd_heads(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
              const int* seg, __nv_bfloat16* o, float* lse, Dims a, cudaStream_t st) {
  const dim3 grid(a.Hq / G, (a.S + tc::kRows - 1) / tc::kRows, a.B);
  return launch(tc::flash_fwd_mma_kernel<D, G>, grid, G * tc::kThreads,
                G * tc::Plan<D>::W::kBytes + tc::Plan<D>::kFwdBytes + tc_tail(a), st, q, k,
                v, seg, o, lse, a.S, a.Hq, a.Hkv, a.scale, a.causal);
}

template <typename T, int D>
int fwd_typed(const void* q, const void* k, const void* v, const int* seg,
              void* o, float* lse, Dims a, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  if constexpr (is_bf16<T>()) {  // tensor cores: as many heads a block as the group allows
    const int rep = a.Hq / a.Hkv;
    T* op = static_cast<T*>(o);
    // At D = 256 three Q tiles and the ring overflow shared memory (3 x
    // 32 KB + 134 KB): at most 2 heads a block.
    if constexpr (D < 256) {
      if (rep % 3 == 0) return fwd_heads<D, 3>(qp, kp, vp, seg, op, lse, a, st);
    }
    if (rep % 2 == 0) return fwd_heads<D, 2>(qp, kp, vp, seg, op, lse, a, st);
    return fwd_heads<D, 1>(qp, kp, vp, seg, op, lse, a, st);
  } else {  // fp32: CUDA cores (card-vs-CPU checks hold it at 1e-4)
    const dim3 grid((a.S + kTile - 1) / kTile, a.Hq, a.B);
    return launch(flash_fwd_kernel<T, D>, grid, kThreads, fwd_smem(D), st, qp, kp,
                  vp, seg, static_cast<T*>(o), lse, a.S, a.Hq, a.Hkv, a.scale,
                  a.causal);
  }
}

template <typename T, int D>
int dq_typed(const void* q, const void* k, const void* v, const int* seg,
             const void* dout, const float* lse, const float* delta, void* dq,
             Dims a, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  if constexpr (is_bf16<T>()) {
    return launch(tc::flash_dq_mma_kernel<D>, tc_query_grid(a), tc::kThreads,
                  tc::Plan<D>::kDqBytes + tc_tail(a), st, qp, kp, vp, seg, dop, lse,
                  delta, static_cast<T*>(dq), a.S, a.Hq, a.Hkv, a.scale, a.causal);
  } else {
    const dim3 grid((a.S + kTile - 1) / kTile, a.Hq, a.B);
    return launch(flash_dq_kernel<T, D>, grid, kThreads, dq_smem(D), st, qp, kp, vp,
                  seg, dop, lse, delta, static_cast<T*>(dq), a.S, a.Hq, a.Hkv,
                  a.scale, a.causal);
  }
}

template <typename T, int D>
int dkv_typed(const void* q, const void* k, const void* v, const int* seg,
              const void* dout, const float* lse, const float* delta, void* dk,
              void* dv, Dims a, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  if constexpr (is_bf16<T>()) {
    // At D = 256 a warp's dK and dV accumulators (2 x 128 fp32 a thread)
    // do not fit its registers beside S^T and dP^T, so two blocks split a
    // key tile's columns, each recomputing S^T and dP^T over all of D.
    // (dq's 128 accumulators fit beside S and dP with a 120-byte spill;
    // split the same way it ran 1.65x slower on the H100.)
    constexpr int NC = D == 256 ? 2 : 1;
    const dim3 grid((a.S + tc::kRows - 1) / tc::kRows * NC, a.Hkv, a.B);
    return launch(tc::flash_dkv_mma_kernel<D, NC>, grid, tc::kThreads,
                  tc::Plan<D>::kDkvBytes + tc_tail(a), st, qp, kp, vp, seg, dop, lse,
                  delta, static_cast<T*>(dk), static_cast<T*>(dv), a.S, a.Hq, a.Hkv,
                  a.scale, a.causal);
  } else {
    const dim3 grid((a.S + kTile - 1) / kTile, a.Hkv, a.B);
    return launch(flash_dkv_kernel<T, D>, grid, kThreads, dkv_smem(D), st, qp, kp, vp,
                  seg, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a.S,
                  a.Hq, a.Hkv, a.scale, a.causal);
  }
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B > 0 && S > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && B <= 65535 &&
         Hq <= 65535 && (S + kTile - 1) / kTile <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64, 128 or 256.  Each
// returns 0 or the cudaError_t of the launch.
#define FA_DISPATCH(FN, ...)                                             \
  if (dtype == 0 && head_dim == 64) return FN<float, 64>(__VA_ARGS__);   \
  if (dtype == 0 && head_dim == 128) return FN<float, 128>(__VA_ARGS__); \
  if (dtype == 0 && head_dim == 256) return FN<float, 256>(__VA_ARGS__); \
  if (dtype == 1 && head_dim == 64)                                      \
    return FN<__nv_bfloat16, 64>(__VA_ARGS__);                           \
  if (dtype == 1 && head_dim == 128)                                     \
    return FN<__nv_bfloat16, 128>(__VA_ARGS__);                          \
  if (dtype == 1 && head_dim == 256)                                     \
    return FN<__nv_bfloat16, 256>(__VA_ARGS__);                          \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* seg, void* o, void* lse, int B,
                                   int S, int Hq, int Hkv, int head_dim,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims a{B, S, Hq, Hkv, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(fwd_typed, q, k, v, static_cast<const int*>(seg), o,
              static_cast<float*>(lse), a, st)
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* seg,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, int B, int S,
                                      int Hq, int Hkv, int head_dim, int dtype,
                                      int causal, float scale, void* stream) {
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims a{B, S, Hq, Hkv, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(dq_typed, q, k, v, static_cast<const int*>(seg), dout,
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              dq, a, st)
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* seg,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int B, int S, int Hq, int Hkv,
                                       int head_dim, int dtype, int causal,
                                       float scale, void* stream) {
  if (!valid(B, S, Hq, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims a{B, S, Hq, Hkv, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(dkv_typed, q, k, v, static_cast<const int*>(seg), dout,
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              dk, dv, a, st)
}
