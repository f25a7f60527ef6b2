// 8-bit weights dequantized into the wgmma tiles of sm90.cuh (Hopper).
//
// The weight of an 8-bit matmul-layout code (K, N) and its f32 block scale
// (K/block, N) is, as everywhere in the port (dequant8.cuh),
//
//   deq(code) = bf16(levels[code] * scale[row / block, col])
//
// one f32 multiply rounded once (__fmul_rn), then rounded to bf16.
//
// Level table. The 256-entry table is read once per weight at a random
// byte; one copy in shared memory would put up to 32 lanes of a warp on
// random banks (about 3.5-way conflicts on random codes, which would cap a
// memory-bound decode below the HBM rate). So a block keeps 32 copies,
// interleaved: entry c of copy l at word 32c + l, and lane l reads copy l:
// every lookup of a warp hits 32 different banks. 32 KB a block.
//
// Tile. A staged (64 rows of K) x (128 columns of N) slab of raw code bytes
// (row-major, 128 bytes a row) dequantizes into a 64 x 128 bf16 tile in the
// swizzled layout of Tile<128> (rows = K, 128 columns = N in two 64-column
// halves). Under Tile<128>::mn_major that tile is the MN-major B operand of
// out = x @ W (matmul_8bit). The transposed product dx = g @ W^T
// (matmul_8bit_t) wants W's rows as the N of its wgmma and N as the
// reduction: a staged slab of 128 rows of K x 64 columns of N dequantizes
// into a 128-row Tile<64> (two Tile<64>s back to back, rows = K), which
// Tile<64>::k_major reads as the K-major B of an m64n128 product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int LV_COPIES = 32;
constexpr int LV_BYTES = 256 * LV_COPIES * 4;

// The replicated level table into shared memory, by NT threads: every
// load first, then the 16-byte stores (consecutive threads, consecutive
// addresses).
template <int NT>
__device__ __forceinline__ void fill_levels32(float* lv, const float* __restrict__ levels,
                                              int tid) {
  constexpr int N4 = 256 * LV_COPIES / 4, PER = N4 / NT;  // float4s: 8 a code
  static_assert(N4 % NT == 0, "whole float4s a thread");
  float l[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) l[j] = __ldg(levels + (tid + j * NT) / (LV_COPIES / 4));
#pragma unroll
  for (int j = 0; j < PER; ++j)
    reinterpret_cast<float4*>(lv)[tid + j * NT] = make_float4(l[j], l[j], l[j], l[j]);
}

// levels[code] from lane `lane`'s copy
__device__ __forceinline__ float level(const float* lv, uint32_t code, int lane) {
  return lv[code * LV_COPIES + lane];
}

// The 8 scales of row `k` (of K), columns [n, n + 8): zeros past K or N.
__device__ __forceinline__ void load_scales8(float (&s)[8], const float* __restrict__ scales,
                                             int k, int n, int K, int N, int block) {
  const float* src = scales + (int64_t)(k / block) * N + n;
  if (k < K && n + 8 <= N && (N & 3) == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src + 4));
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = k < K && n + e < N ? __ldg(src + e) : 0.0f;
  }
}

// Bytes [c0, c0 + 16) of a row of W's codes into shared memory (`dst`,
// generic, and its shared address `dst_s`): cp.async where the 16 bytes are
// in range and aligned, else byte by byte (zeros past K or N).
__device__ __forceinline__ void stage_codes16(unsigned char* dst, uint32_t dst_s,
                                              const uint8_t* __restrict__ codes, int k, int c0,
                                              int K, int N) {
  const uint8_t* src = codes + (int64_t)k * N + c0;
  if (k >= K) {
    cp_async16(dst_s, codes, 0);
  } else if ((N & 15) == 0 && c0 + 16 <= N) {
    cp_async16(dst_s, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = c0 + e < N ? src[e] : 0;
  }
}

// Elements [c0, c0 + 8) of row `r` of a row-major bf16 (rows, cols) matrix
// into shared memory, as stage_codes16 does (zeros past the edges).
__device__ __forceinline__ void stage_bf16x8(unsigned char* dst, uint32_t dst_s,
                                             const __nv_bfloat16* __restrict__ a, int r, int c0,
                                             int rows, int cols) {
  const __nv_bfloat16* src = a + (int64_t)r * cols + c0;
  if (r >= rows) {
    cp_async16(dst_s, a, 0);
  } else if ((cols & 7) == 0 && c0 + 8 <= cols) {
    cp_async16(dst_s, src, 16);
  } else {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = c0 + e < cols ? src[e] : __float2bfloat16_rn(0.0f);
  }
}

// Rows [k0, k0 + 64) x columns [n0, n0 + 128) of W's codes into a raw slab
// of 64 rows of 128 bytes (`slab`, generic, at shared address `slab_s`).
__device__ __forceinline__ void stage_code_slab(unsigned char* slab, uint32_t slab_s,
                                                const uint8_t* __restrict__ codes, int k0, int n0,
                                                int K, int N, int tid, int nt) {
  for (int i = tid; i < 64 * 8; i += nt) {
    const int r = i / 8, c = (i % 8) * 16;
    stage_codes16(slab + r * 128 + c, slab_s + r * 128 + c, codes, k0 + r, n0 + c, K, N);
  }
}

// Columns [n0, n0 + 4 * chunks) of scale row `row` into shared memory
// (`dst`, generic, at shared address `dst_s`), by threads 0 .. chunks - 1;
// zeros past N. The one scale row of a staged slab or slice of K when the
// block is a multiple of its rows.
__device__ __forceinline__ void stage_scale_row(float* dst, uint32_t dst_s,
                                                const float* __restrict__ scales, int row, int n0,
                                                int N, int chunks, int tid) {
  if (tid >= chunks) return;
  const int n = n0 + 4 * tid;
  const float* src = scales + (int64_t)row * N + n;
  if ((N & 3) == 0 && n + 4 <= N) {
    cp_async16(dst_s + 16 * tid, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 * tid + e] = n + e < N ? src[e] : 0.0f;
  }
}

// Dequantize a staged slab (rows [k0, k0 + 64) of K, columns [n0, n0 + 128)
// of N) into the Tile<128> bf16 tile at shared address `tile`; zeros past K
// or N. Each of the NT threads takes 64 * 16 / NT 16-byte chunks of one
// column range (8 codes in, 8 bf16 out at the swizzled offset), loading all
// of them first. `srow` is the slab's staged scale row, or null: then each
// row reads its own scales from device memory (a block below 64 rows).
template <int NT>
__device__ __forceinline__ void dequant_slab(uint32_t tile, const unsigned char* slab,
                                             const float* srow, const float* __restrict__ scales,
                                             const float* lv, int k0, int n0, int K, int N,
                                             int block, int tid) {
  static_assert(NT % 16 == 0 && (64 * 16) % NT == 0, "whole rows of chunks");
  constexpr int PER = 64 * 16 / NT, ROW_STEP = NT / 16;
  const int lane = tid % 32, c = tid % 16, r0 = tid / 16, n = n0 + 8 * c;
  uint2 raws[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it)
    raws[it] = *reinterpret_cast<const uint2*>(slab + (r0 + it * ROW_STEP) * 128 + 8 * c);
  float s[8];
  if (srow != nullptr) {
    const float4 a = *reinterpret_cast<const float4*>(srow + 8 * c);
    const float4 b = *reinterpret_cast<const float4*>(srow + 8 * c + 4);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int r = r0 + it * ROW_STEP;
    if (srow == nullptr) load_scales8(s, scales, k0 + r, n, K, N, block);
    const uint2 raw = raws[it];
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t word = e < 2 ? raw.x : raw.y;
      const uint32_t c0 = (word >> (16 * (e & 1))) & 0xFF, c1 = (word >> (16 * (e & 1) + 8)) & 0xFF;
      // s is 0 past K or N: the weight is 0 whatever the level
      const __nv_bfloat162 w = __floats2bfloat162_rn(__fmul_rn(level(lv, c0, lane), s[2 * e]),
                                                     __fmul_rn(level(lv, c1, lane), s[2 * e + 1]));
      packed[e] = *reinterpret_cast<const uint32_t*>(&w);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(tile + Tile<128>::offset(r, c)),
                 "r"(packed[0]), "r"(packed[1]), "r"(packed[2]), "r"(packed[3])
                 : "memory");
  }
}

// Rows [k0, k0 + 128) x columns [n0, n0 + 64) of W's codes into a raw slab
// of 128 rows of 64 bytes (zeros past K or N): the transposed product's.
__device__ __forceinline__ void stage_code_slab_t(unsigned char* slab, uint32_t slab_s,
                                                  const uint8_t* __restrict__ codes, int k0,
                                                  int n0, int K, int N, int tid, int nt) {
  for (int i = tid; i < 128 * 4; i += nt) {
    const int r = i / 4, c = (i % 4) * 16;
    stage_codes16(slab + r * 64 + c, slab_s + r * 64 + c, codes, k0 + r, n0 + c, K, N);
  }
}

// Dequantize a staged transposed slab (rows [k0, k0 + 128) of K, columns
// [n0, n0 + 64) of N) into the 128-row Tile<64> at shared address `tile`
// (rows = K). Each of the NT threads takes 128 * 8 / NT 16-byte chunks of
// one column range, loading all of them first. `srow` is the slab's two
// staged scale rows (64 floats for rows k0..k0+63, then 64 for the rest;
// a block of 64 rows or more), or null: then each row reads its own scales
// from device memory. Columns past N give zeros; rows past K are left to
// whatever their codes and scales give, since a B row k only reaches dx
// column k, which the store drops.
template <int NT>
__device__ __forceinline__ void dequant_slab_t(uint32_t tile, const unsigned char* slab,
                                               const float* srow,
                                               const float* __restrict__ scales,
                                               const float* lv, int k0, int n0, int K, int N,
                                               int block, int tid) {
  static_assert(NT % 8 == 0 && (128 * 8) % NT == 0, "whole rows of chunks");
  constexpr int PER = 128 * 8 / NT, ROW_STEP = NT / 8;
  const int lane = tid % 32, c = tid % 8, r0 = tid / 8, n = n0 + 8 * c;
  uint2 raws[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it)
    raws[it] = *reinterpret_cast<const uint2*>(slab + (r0 + it * ROW_STEP) * 64 + 8 * c);
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int r = r0 + it * ROW_STEP;
    float s[8];
    if (srow != nullptr) {
      const float* sr = srow + 64 * (r / 64) + 8 * c;
      const float4 a = *reinterpret_cast<const float4*>(sr);
      const float4 b = *reinterpret_cast<const float4*>(sr + 4);
      s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
      s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    } else {
      load_scales8(s, scales, k0 + r, n, K, N, block);
    }
    const uint2 raw = raws[it];
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t word = e < 2 ? raw.x : raw.y;
      const uint32_t c0 = (word >> (16 * (e & 1))) & 0xFF, c1 = (word >> (16 * (e & 1) + 8)) & 0xFF;
      const __nv_bfloat162 w = __floats2bfloat162_rn(__fmul_rn(level(lv, c0, lane), s[2 * e]),
                                                     __fmul_rn(level(lv, c1, lane), s[2 * e + 1]));
      packed[e] = *reinterpret_cast<const uint32_t*>(&w);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(tile + Tile<64>::offset(r, c)),
                 "r"(packed[0]), "r"(packed[1]), "r"(packed[2]), "r"(packed[3])
                 : "memory");
  }
}

}  // namespace
