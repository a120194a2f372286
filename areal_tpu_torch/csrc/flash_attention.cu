// Segment-aware causal flash attention over packed rows, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of areal_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel  <- `_fwd` / `_fwd_kernel`   (K1f, o and logsumexp)
//   flash_dq_kernel   <- `_bwd` / `_dq_kernel`    (K1dq)
//   flash_dkv_kernel  <- `_bwd` / `_dkv_kernel`   (K1dkv, fp32)
//   dkv::flash_dkv_mma_kernel <- the same, bf16 (K1dkv on the tensor cores)
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
// of the attended pairs at the bf16 tensor-core rate are smaller.  K1f,
// K1dq and the fp32 K1dkv are first versions held by neither: they
// compute on the CUDA cores in fp32 (every input is widened to fp32 in
// shared memory, all sums are fp32), one 64x64 tile pair at a time, each
// thread owning a 4x4 block of scores and a 4x(D/16) block of the
// output; scores and probabilities never leave shared memory, and only
// the attended tile pairs are computed.  The bf16 K1dkv runs its four
// products as bf16 mma.sync tiles fed through a cp.async ring (see
// `namespace dkv`); K1f and K1dq get the same treatment next.
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// tile, dS = P (dP - delta) scale with dP = dO V^T, and dq += dS K.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * DP;
  float* k_s = do_s + kTile * DP;
  float* v_s = k_s + kTile * DP;
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
    load_tile<T, D>(k_s, k, b, k0, hk, S, Hkv);
    load_tile<T, D>(v_s, v, b, k0, hk, S, Hkv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
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
// head-dim columns tx + 16 j.
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
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = q_s + kTile * DP;
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
      load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
      load_tile<T, D>(do_s, dout, b, q0, h, S, Hq);
      __syncthreads();

      // Score tile: rows are query rows r = ty + 16 i, columns key rows
      // c = tx + 16 jj.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
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
// K1dkv for bf16, the main path, on the tensor cores.  Grid (ceil(S/64),
// Hkv, B), dkv::kThreads.  A block owns key rows [k0, k0 + 64) of kv head
// hk in row b, one m16 tile per warp, and keeps dK and dV of its rows in
// fp32 mma accumulators (16 x D per warp) while it walks the group's rep
// q-heads and, for each, the query tiles that survive the causal and
// segment-overlap skips (`tiles_overlap`, listed once per block).  The
// group sum stays in registers: no atomics, no per-q-head buffer, and
// results repeat bitwise.  K and V are loaded once; each surviving
// (q-head, query tile) pair's Q and dO tiles (bf16, 64 x D, swizzled),
// segment ids, lse and delta come through a 2-stage cp.async ring, so the
// next pair loads while the current one is computed.  Per pair and warp:
//   S^T = K Q^T and dP^T = V dO^T (K, V a fragments and Q, dO b fragments
//     by ldmatrix),
//   P^T = exp2(S^T scale log2e - lse log2e) under the mask,
//   dS^T = P^T (dP^T - delta) scale,
//   dV += P^T dO and dK += dS^T Q: P^T and dS^T are rounded to bf16 in
//     registers and used as a fragments as they lie (the accumulator
//     layout is the a layout); dO and Q are b fragments by ldmatrix.trans.
// Padding rows and columns are masked, so they give exact zeros.
// ---------------------------------------------------------------------------
namespace dkv {

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

constexpr int kKeys = 64;  // key rows per block: one m16 tile per warp
constexpr int kQ = 64;     // query rows per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;

template <int D>
struct Plan {
  using KV = tiles::Tile<bf16, D, true, kKeys>;
  using Q = tiles::Tile<bf16, D, true, kQ>;
  // A ring stage: Q and dO tiles, then segment ids, lse and delta.
  static constexpr int kStage = 2 * Q::kBytes + 3 * kQ * 4;
  // Shared memory before the per-call tail of 2 * nq ints (flags, list).
  static constexpr int kFixedBytes = 2 * KV::kBytes + kStages * kStage;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int Hq, int Hkv, float scale, int causal) {
  using P = Plan<D>;
  using KV = typename P::KV;
  using QT = typename P::Q;
  extern __shared__ __align__(16) char smem[];
  __shared__ int n_live_s;
  const int nq = (S + kQ - 1) / kQ;
  char* k_s = smem;
  char* v_s = k_s + KV::kBytes;
  char* ring = v_s + KV::kBytes;
  int* flags = reinterpret_cast<int*>(ring + kStages * P::kStage);
  int* live = flags + nq;

  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int rep = Hq / Hkv;
  const int k0 = kt * kKeys;
  const int* seg_row = seg + static_cast<size_t>(b) * S;

  // Which query tiles can hold an attended pair with this key tile: each
  // warp takes the segment range of the key tile and of every 4th query
  // tile; warp 0 then lists the live ones in order.
  auto tile_range = [&](int row0, int& lo, int& hi) {
    lo = 0x7fffffff;
    hi = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = row0 + lane + 32 * e;
      const int id = s < S ? seg_row[s] : 0;
      if (id > 0) lo = min(lo, id);
      hi = max(hi, id);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
  };
  int klo, khi;
  tile_range(k0, klo, khi);
  const int qt0 = causal ? kt : 0;
  for (int qt = qt0 + warp; qt < nq; qt += kWarps) {
    int qlo, qhi;
    tile_range(qt * kQ, qlo, qhi);
    if (lane == 0) flags[qt] = qhi > 0 && khi > 0 && klo <= qhi && khi >= qlo;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int c = qt0; c < nq; c += 32) {
      const bool f = c + lane < nq && flags[c + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) live[count + __popc(m & ((1u << lane) - 1u))] = c + lane;
      count += __popc(m);
    }
    if (lane == 0) n_live_s = count;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int n_items = rep * n_live;  // (q-head, query tile) pairs

  // Pair `it` (q-head it / n_live, the (it % n_live)-th live query tile)
  // into its ring stage; rows past S are zero-filled.
  auto load = [&](int it) {
    const int gi = it / n_live;
    const int q0 = live[it - gi * n_live] * kQ;
    const int h = hk * rep + gi;
    char* q_st = ring + (it % kStages) * P::kStage;
    char* do_st = q_st + QT::kBytes;
    int* seg_st = reinterpret_cast<int*>(do_st + QT::kBytes);
    float* lse_st = reinterpret_cast<float*>(seg_st + kQ);
    float* delta_st = lse_st + kQ;
    for (int i = tid; i < kQ * QT::kChunks; i += kThreads) {
      const int r = i / QT::kChunks;
      const int c = i % QT::kChunks;
      const bool ok = q0 + r < S;
      const size_t off = ((static_cast<size_t>(b) * S + q0 + (ok ? r : 0)) * Hq + h) * D;
      cp_async16(smem_u32(q_st + QT::offset(r, c)),
                 reinterpret_cast<const char*>(q + off) + c * 16, ok);
      cp_async16(smem_u32(do_st + QT::offset(r, c)),
                 reinterpret_cast<const char*>(dout + off) + c * 16, ok);
    }
    if (tid < kQ) {
      const bool ok = q0 + tid < S;
      const int s = ok ? q0 + tid : 0;
      const size_t at = (static_cast<size_t>(b) * S + s) * Hq + h;
      cp_async4(smem_u32(seg_st + tid), seg_row + s, ok);
      cp_async4(smem_u32(lse_st + tid), lse + at, ok);
      cp_async4(smem_u32(delta_st + tid), delta + at, ok);
    }
  };

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  if (n_items > 0) {
    for (int i = tid; i < kKeys * KV::kChunks; i += kThreads) {
      const int r = i / KV::kChunks;
      const int c = i % KV::kChunks;
      const bool ok = k0 + r < S;
      const size_t off = ((static_cast<size_t>(b) * S + k0 + (ok ? r : 0)) * Hkv + hk) * D;
      cp_async16(smem_u32(k_s + KV::offset(r, c)),
                 reinterpret_cast<const char*>(k + off) + c * 16, ok);
      cp_async16(smem_u32(v_s + KV::offset(r, c)),
                 reinterpret_cast<const char*>(v + off) + c * 16, ok);
    }
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

      const int q0 = live[it % n_live] * kQ;
      const char* q_st = ring + (it % kStages) * P::kStage;
      const char* do_st = q_st + QT::kBytes;
      const int* seg_st = reinterpret_cast<const int*>(do_st + QT::kBytes);
      const float* lse_st = reinterpret_cast<const float*>(seg_st + kQ);
      const float* delta_st = lse_st + kQ;

      // S^T and dP^T: this warp's 16 key rows x the tile's kQ queries.
      float st[kQ / 8][4], dpt[kQ / 8][4];
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(smem_u32(k_s + KV::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))), ka);
        ldsm_x4(smem_u32(v_s + KV::offset(warp * 16 + a_row(lane), kk * 2 + a_chunk(lane))), va);
#pragma unroll
        for (int np = 0; np < kQ / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4(smem_u32(q_st + QT::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(st[2 * np], ka, bb[0], bb[1]);
          mma_bf16(st[2 * np + 1], ka, bb[2], bb[3]);
          ldsm_x4(smem_u32(do_st + QT::offset(np * 16 + b_row(lane), kk * 2 + b_chunk(lane))), bb);
          mma_bf16(dpt[2 * np], va, bb[0], bb[1]);
          mma_bf16(dpt[2 * np + 1], va, bb[2], bb[3]);
        }
      }
      // P^T and dS^T in place.  Element (n, 2 hf + e): key row kr + 8 hf,
      // query column n * 8 + 2 t4 + e.
#pragma unroll
      for (int n = 0; n < kQ / 8; ++n) {
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
      for (int kq = 0; kq < kQ / 16; ++kq) {
        const uint32_t pa[4] = {
            pack_bf16(st[2 * kq][0], st[2 * kq][1]), pack_bf16(st[2 * kq][2], st[2 * kq][3]),
            pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]),
            pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]), pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]),
            pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]),
            pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3])};
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t bb[4];
          ldsm_x4_trans(smem_u32(do_st + QT::offset(kq * 16 + a_row(lane), nn * 2 + a_chunk(lane))),
                        bb);
          mma_bf16(dva[2 * nn], pa, bb[0], bb[1]);
          mma_bf16(dva[2 * nn + 1], pa, bb[2], bb[3]);
          ldsm_x4_trans(smem_u32(q_st + QT::offset(kq * 16 + a_row(lane), nn * 2 + a_chunk(lane))),
                        bb);
          mma_bf16(dka[2 * nn], da, bb[0], bb[1]);
          mma_bf16(dka[2 * nn + 1], da, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with the ring: stage 0 holds the output

  // dK and dV of this warp's rows into stage 0 as bf16 tiles, then
  // 16-byte stores of whole rows (rows past S are not written).
  char* dk_st = ring;
  char* dv_st = ring + QT::kBytes;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int r = warp * 16 + g8;
    const int at0 = QT::offset(r, nt) + 4 * t4;
    const int at1 = QT::offset(r + 8, nt) + 4 * t4;
    *reinterpret_cast<uint32_t*>(dk_st + at0) = pack_bf16(dka[nt][0], dka[nt][1]);
    *reinterpret_cast<uint32_t*>(dk_st + at1) = pack_bf16(dka[nt][2], dka[nt][3]);
    *reinterpret_cast<uint32_t*>(dv_st + at0) = pack_bf16(dva[nt][0], dva[nt][1]);
    *reinterpret_cast<uint32_t*>(dv_st + at1) = pack_bf16(dva[nt][2], dva[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 16 * QT::kChunks / 32; ++e) {
    const int i = e * 32 + lane;
    const int r = warp * 16 + i / QT::kChunks;
    const int c = i % QT::kChunks;
    if (k0 + r < S) {
      const size_t off = ((static_cast<size_t>(b) * S + k0 + r) * Hkv + hk) * D;
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dk + off) + c * 16) =
          *reinterpret_cast<const uint4*>(dk_st + QT::offset(r, c));
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dv + off) + c * 16) =
          *reinterpret_cast<const uint4*>(dv_st + QT::offset(r, c));
    }
  }
}

}  // namespace dkv

// Shared-memory bytes of each kernel at head dim D.
constexpr size_t tile_bytes(int D) { return sizeof(float) * kTile * (D + 1); }
constexpr size_t score_bytes() { return sizeof(float) * kTile * kPS; }
constexpr size_t row_bytes() { return sizeof(float) * kTile; }
constexpr size_t seg_bytes() { return sizeof(int) * (2 * kTile + 4); }
constexpr size_t fwd_smem(int D) {
  return 2 * tile_bytes(D) + score_bytes() + seg_bytes();
}
constexpr size_t dq_smem(int D) {
  return 4 * tile_bytes(D) + score_bytes() + 2 * row_bytes() + seg_bytes();
}
constexpr size_t dkv_smem(int D) {
  return 4 * tile_bytes(D) + 2 * score_bytes() + 2 * row_bytes() + seg_bytes();
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

template <typename T, int D>
int fwd_typed(const void* q, const void* k, const void* v, const int* seg,
              void* o, float* lse, Dims a, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, fwd_smem(D));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.S + kTile - 1) / kTile, a.Hq, a.B);
  kernel<<<grid, kThreads, fwd_smem(D), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(o), lse, a.S, a.Hq, a.Hkv,
      a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq_typed(const void* q, const void* k, const void* v, const int* seg,
             const void* dout, const float* lse, const float* delta, void* dq,
             Dims a, cudaStream_t st) {
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, dq_smem(D));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.S + kTile - 1) / kTile, a.Hq, a.B);
  kernel<<<grid, kThreads, dq_smem(D), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), a.S, a.Hq, a.Hkv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv_typed(const void* q, const void* k, const void* v, const int* seg,
              const void* dout, const float* lse, const float* delta, void* dk,
              void* dv, Dims a, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // tensor cores
    auto kernel = dkv::flash_dkv_mma_kernel<D>;
    const int nq = (a.S + dkv::kQ - 1) / dkv::kQ;
    const size_t smem = dkv::Plan<D>::kFixedBytes + 2 * sizeof(int) * nq;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.S + dkv::kKeys - 1) / dkv::kKeys, a.Hkv, a.B);
    kernel<<<grid, dkv::kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), a.S, a.Hq, a.Hkv, a.scale,
        a.causal);
    return static_cast<int>(cudaGetLastError());
  } else {  // fp32: CUDA cores (card-vs-CPU checks hold it at 1e-4)
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, dkv_smem(D));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.S + kTile - 1) / kTile, a.Hkv, a.B);
    kernel<<<grid, kThreads, dkv_smem(D), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), a.S, a.Hq, a.Hkv, a.scale,
        a.causal);
    return static_cast<int>(cudaGetLastError());
  }
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B > 0 && S > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && B <= 65535 &&
         Hq <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Each returns 0
// or the cudaError_t of the launch.
#define FA_DISPATCH(FN, ...)                                             \
  if (dtype == 0 && head_dim == 64) return FN<float, 64>(__VA_ARGS__);   \
  if (dtype == 0 && head_dim == 128) return FN<float, 128>(__VA_ARGS__); \
  if (dtype == 1 && head_dim == 64)                                      \
    return FN<__nv_bfloat16, 64>(__VA_ARGS__);                           \
  if (dtype == 1 && head_dim == 128)                                     \
    return FN<__nv_bfloat16, 128>(__VA_ARGS__);                          \
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
