// Building blocks of the port's tensor-core attention kernels (sm_90a):
// asynchronous global -> shared copies (cp.async), ldmatrix, the bf16
// mma.sync.m16n8k16 product with fp32 accumulators, the shared-memory
// tile these read, with its 16-byte chunks XOR-swizzled by row, and the
// int8 cache's widening and scale copies.  Included
// by split_kv_attention.cuh (K2, K4), paged_chunk_attention.cu (K3) and
// flash_attention.cu (K1dkv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Four consecutive elements of a staged row as fp32.
template <typename T>
__device__ __forceinline__ float4 load4(const char* p);
template <>
__device__ __forceinline__ float4 load4<float>(const char* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const char* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <>
__device__ __forceinline__ float4 load4<int8_t>(const char* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate.
// Fragments: thread (g = lane / 4, t4 = lane % 4) holds c rows g and
// g + 8, columns 2 t4 and 2 t4 + 1 — so two neighbouring n8 accumulator
// tiles, packed to bf16, are the a fragment of one k16 step.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// int8 -> fp32, exactly: byte k of a word whose bytes were biased by
// 0x80 (x ^ 0x80 = x + 128) becomes the fp32 2^23 + x + 128 (one byte
// permute), less 2^23 + 128.  Every int8 is exact in bf16 too (8-bit
// significand), so the tensor-core paths widen int8 tiles this way.
__device__ __forceinline__ float i8_float(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | k)) - 8388736.f;
}

// The 16 (8) bytes at p as four (two) words, each biased for i8_float.
__device__ __forceinline__ void lds_i8x16(const char* p, uint32_t* w) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  w[0] = u.x ^ 0x80808080u;
  w[1] = u.y ^ 0x80808080u;
  w[2] = u.z ^ 0x80808080u;
  w[3] = u.w ^ 0x80808080u;
}
__device__ __forceinline__ void lds_i8x8(const char* p, uint32_t* w) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  w[0] = u.x ^ 0x80808080u;
  w[1] = u.y ^ 0x80808080u;
}

// One bf16 scale of an int8 cache into shared memory, in the caller's
// cp.async group: a scale is 2 bytes at an n_kv-strided, possibly odd,
// element, which no cp.async can copy alone, so this copies the aligned
// 4-byte word that holds it (inside the scales' allocation, whose
// blocks are 4-byte multiples; zero-filled when !valid) and returns
// whether the scale is the word's high half.  scale_of reads it back.
__device__ __forceinline__ bool cp_async_scale(uint32_t dst, const __nv_bfloat16* src,
                                               bool valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  cp_async4(dst, reinterpret_cast<const void*>(a & ~uintptr_t(3)), valid);
  return (a & 2) != 0;
}
__device__ __forceinline__ float scale_of(uint32_t word, bool high) {
  return __uint_as_float(high ? word & 0xffff0000u : word << 16);
}

// The row and chunk (added to a block's first row and first chunk) that
// each lane hands one ldmatrix.x4 over a 16-row x 16-element bf16 block:
//   a_row / a_chunk: rows are m, elements k: the a fragment of one k16
//     step (ldsm_x4); or rows are k, elements n (ldsm_x4_trans): the b
//     fragments of two n8 tiles, regs {0,1} for n 0..7, {2,3} for n 8..15;
//   b_row / b_chunk: rows are n, elements k (ldsm_x4): the b fragments of
//     the n8 tiles of rows 0..7 (regs {0,1}) and 8..15 (regs {2,3}).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int a_chunk(int lane) { return lane >> 4; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_chunk(int lane) { return (lane >> 3) & 1; }

// One tile of kRowsT rows of D elements in shared memory.  Tensor-core
// tiles are unpadded with their 16-byte chunks XOR-swizzled by row, so
// the eight rows an ldmatrix reads sit in eight distinct bank groups;
// CUDA-core tiles pad each row by 16 bytes instead.
template <typename T, int D, bool kSwizzle, int kRowsT>
struct Tile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kStride = kSwizzle ? kRowBytes : kRowBytes + 16;
  static constexpr int kBytes = kRowsT * kStride;
  static_assert(kRowBytes % 16 == 0, "rows must be whole 16-byte chunks");
  static_assert(!kSwizzle || kChunks >= 8, "the swizzle needs 8 chunks a row");
  static __device__ __forceinline__ int offset(int row, int chunk) {
    return row * kStride + ((kSwizzle ? (chunk ^ (row & 7)) : chunk) << 4);
  }
};

}  // namespace tiles
