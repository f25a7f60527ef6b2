// split_k-packed 4-bit weights dequantized for the Hopper designs of
// matmul_4bit.cu and matmul_4bit_t.cu.
//
// Codes are (K2, N) bytes, K2 = K_pad / 2: the low nibble of byte (k, n) is
// row k of W, the high nibble row K2 + k. Scales are f32 (K_pad / block,
// N). As everywhere in the port,
//
//   deq(code) = bf16(levels[code] * scale[row / block, col])
//
// one f32 multiply rounded once (__fmul_rn), then rounded to bf16 (the f32
// routes keep the f32 product). The 16-entry f32 level table serves every
// 4-bit codebook: for nf4a and int4 the registered levels are the f32
// Horner values, so a lookup gives the same numbers without evaluating the
// polynomial (where nvcc would contract it into FMAs).
//
// Level table. 16 entries, read once per weight at a random nibble; as
// with the 8-bit table (dequant8_sm90.cuh), a block keeps 32 interleaved
// copies (entry c of copy l at word 32c + l, lane l reads copy l), so every
// lookup of a warp hits 32 different banks. 2 KB a block, not 32.
//
// K order. A staged run of P packed rows [kp, kp + P) holds two runs of K:
// [kp, kp + P) from the low nibbles and [K2 + kp, K2 + kp + P) from the
// high ones. Each needs its own run of x, x[:, kp:kp+P] and
// x[:, K2+kp:K2+kp+P], and its own scale row, kp / block and
// (K2 + kp) / block, which lie far apart. Where K2 is not a multiple of P,
// the last run reaches past K2 in both halves: x reads zeros there (never
// x's other half) and the scales read zeros, so those weights are 0.
//
// Tile. A staged slab of 32 packed rows x 128 columns (4 KB of codes)
// dequantizes into one 64 x 128 bf16 tile in the swizzled Tile<128> layout
// of sm90.cuh: rows 0-31 from the low nibbles (K rows kp..kp+31), rows
// 32-63 from the high ones (K2+kp..K2+kp+31). Under Tile<128>::mn_major it
// is the MN-major B of out = x @ W, and the x tile (a swizzled Tile<64>)
// follows the same K order: chunks 0-3 of a row hold x[:, kp:kp+32],
// chunks 4-7 x[:, K2+kp:K2+kp+32].
//
// Transposed tile (matmul_4bit_t.cu). A staged slab of 64 packed rows x 64
// columns dequantizes into one 128-row Tile<64> (rows = dx columns,
// columns = N): the low nibbles in rows 0-63 (dx columns j0..j0+63), the
// high ones in rows 64-127 (K2+j0..K2+j0+63), the K order above read the
// other way. Under Tile<64>::k_major it is the K-major B of dx = g @ W^T,
// as matmul_8bit_t's tile is (dequant8_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "dequant8_sm90.cuh"  // LV_COPIES, level, load_scales8, stage_codes16, stage_scale_row

namespace {

constexpr int LV4_BYTES = 16 * LV_COPIES * 4;

// The replicated 16-entry table into shared memory, by NT threads
// (consecutive threads, consecutive words).
template <int NT>
__device__ __forceinline__ void fill_levels4(float* lv, const float* __restrict__ levels,
                                             int tid) {
  for (int i = tid; i < 16 * LV_COPIES; i += NT) lv[i] = __ldg(levels + i / LV_COPIES);
}

// x[m, h K2 + j .. h K2 + j + 8) of x (M, 2 K2) bf16 into shared memory
// (`dst`, generic, and its shared address `dst_s`): half h = 0 reads the
// columns of the low nibbles, h = 1 those of the high ones. cp.async where
// the 8 values are in range and 16-byte aligned, else one by one; zeros
// past M and past the half's K2 columns.
__device__ __forceinline__ void stage_x_half8(unsigned char* dst, uint32_t dst_s,
                                              const __nv_bfloat16* __restrict__ x, int m, int h,
                                              int j, int M, int K2) {
  const __nv_bfloat16* src = x + (int64_t)m * 2 * K2 + (int64_t)h * K2 + j;
  if (m >= M || j >= K2) {
    cp_async16(dst_s, x, 0);
  } else if ((K2 & 7) == 0 && j + 8 <= K2) {
    cp_async16(dst_s, src, 16);
  } else {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = j + e < K2 ? src[e] : __float2bfloat16_rn(0.0f);
  }
}

// Packed rows [kp, kp + 32) x columns [n0, n0 + 128) of the codes into a
// raw slab of 32 rows of 128 bytes (zeros past K2 or N).
__device__ __forceinline__ void stage_code_slab4(unsigned char* slab, uint32_t slab_s,
                                                 const uint8_t* __restrict__ codes, int kp,
                                                 int n0, int K2, int N, int tid, int nt) {
  for (int i = tid; i < 32 * 8; i += nt) {
    const int r = i / 8, c = (i % 8) * 16;
    stage_codes16(slab + r * 128 + c, slab_s + r * 128 + c, codes, kp + r, n0 + c, K2, N);
  }
}

// The 8 weights of one nibble half (h) of 8 code bytes, times their 8
// scales, as 4 words of two bf16.
__device__ __forceinline__ void deq_nibbles8(uint32_t (&packed)[4], uint2 raw, int h,
                                             const float (&s)[8], const float* lv, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t word = e < 2 ? raw.x : raw.y;
    const int sh = 16 * (e & 1) + 4 * h;
    const uint32_t c0 = (word >> sh) & 0xF, c1 = (word >> (sh + 8)) & 0xF;
    const __nv_bfloat162 w = __floats2bfloat162_rn(__fmul_rn(level(lv, c0, lane), s[2 * e]),
                                                   __fmul_rn(level(lv, c1, lane), s[2 * e + 1]));
    packed[e] = *reinterpret_cast<const uint32_t*>(&w);
  }
}

// Dequantize a staged slab (packed rows [kp, kp + 32), columns [n0, n0 +
// 128)) into the Tile<128> bf16 tile at shared address `tile`, low
// nibbles in rows 0-31 and high nibbles in rows 32-63. Each of the NT
// threads takes 8 code bytes of 32 * 16 / NT packed rows, loading all of
// them first, and writes two 16-byte chunks for each. `srow` is the slab's
// two staged scale rows (128 floats for the low half, then 128 for the
// high one), or null: then each K row reads its own scales from device
// memory (a block below 32 rows, or K2 off the slabs).
template <int NT>
__device__ __forceinline__ void dequant4_slab(uint32_t tile, const unsigned char* slab,
                                              const float* srow,
                                              const float* __restrict__ scales, const float* lv,
                                              int kp, int n0, int K2, int N, int block, int tid) {
  static_assert(NT % 16 == 0 && (32 * 16) % NT == 0, "whole rows of chunks");
  constexpr int PER = 32 * 16 / NT, ROW_STEP = NT / 16;
  const int lane = tid % 32, c = tid % 16, r0 = tid / 16, n = n0 + 8 * c;
  uint2 raws[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it)
    raws[it] = *reinterpret_cast<const uint2*>(slab + (r0 + it * ROW_STEP) * 128 + 8 * c);
  float s[2][8];
  if (srow != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(srow + 128 * h + 8 * c);
      const float4 b = *reinterpret_cast<const float4*>(srow + 128 * h + 8 * c + 4);
      s[h][0] = a.x; s[h][1] = a.y; s[h][2] = a.z; s[h][3] = a.w;
      s[h][4] = b.x; s[h][5] = b.y; s[h][6] = b.z; s[h][7] = b.w;
    }
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int r = r0 + it * ROW_STEP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // K row kp + r or K2 + kp + r: zeros past K2 in either half
      if (srow == nullptr) load_scales8(s[h], scales, h * K2 + kp + r, n, (h + 1) * K2, N, block);
      uint32_t packed[4];
      deq_nibbles8(packed, raws[it], h, s[h], lv, lane);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(tile + Tile<128>::offset(32 * h + r, c)), "r"(packed[0]),
                   "r"(packed[1]), "r"(packed[2]), "r"(packed[3])
                   : "memory");
    }
  }
}

// Packed rows [j0, j0 + 64) x columns [n0, n0 + 64) of the codes into a raw
// slab of 64 rows of 64 bytes (zeros past K2 or N): the transposed
// product's (matmul_4bit_t.cu).
__device__ __forceinline__ void stage_code_slab4_t(unsigned char* slab, uint32_t slab_s,
                                                   const uint8_t* __restrict__ codes, int j0,
                                                   int n0, int K2, int N, int tid, int nt) {
  for (int i = tid; i < 64 * 4; i += nt) {
    const int r = i / 4, c = (i % 4) * 16;
    stage_codes16(slab + r * 64 + c, slab_s + r * 64 + c, codes, j0 + r, n0 + c, K2, N);
  }
}

// Dequantize a staged transposed slab (packed rows [j0, j0 + 64), columns
// [n0, n0 + 64) of N) into the 128-row Tile<64> at shared address `tile`
// (rows = dx columns, columns = N): the low nibbles of packed row j0 + r in
// row r (dx column j0 + r), the high ones in row 64 + r (dx column K2 + j0
// + r). Read K-major it is the B of dx = g @ W^T. Each of the NT threads
// takes 8 code bytes of 64 * 8 / NT packed rows, loading all of them
// first, and writes a 16-byte chunk to each half. `srow` is the slab's
// four staged scale rows, 64 floats each: the low half's for packed rows
// j0.. and j0 + 32.., then the high half's (block and K2 multiples of 32),
// or null: then each K row reads its own scales from device memory, zeros
// past K2 in either half. Columns past N give zeros; rows past K2 reach
// only dx columns the store drops.
template <int NT>
__device__ __forceinline__ void dequant4_slab_t(uint32_t tile, const unsigned char* slab,
                                                const float* srow,
                                                const float* __restrict__ scales,
                                                const float* lv, int j0, int n0, int K2, int N,
                                                int block, int tid) {
  static_assert(NT % 8 == 0 && (64 * 8) % NT == 0, "whole rows of chunks");
  constexpr int PER = 64 * 8 / NT, ROW_STEP = NT / 8;
  const int lane = tid % 32, c = tid % 8, r0 = tid / 8, n = n0 + 8 * c;
  uint2 raws[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it)
    raws[it] = *reinterpret_cast<const uint2*>(slab + (r0 + it * ROW_STEP) * 64 + 8 * c);
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int r = r0 + it * ROW_STEP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[8];
      if (srow != nullptr) {
        const float* sr = srow + 64 * (2 * h + r / 32) + 8 * c;
        const float4 a = *reinterpret_cast<const float4*>(sr);
        const float4 b = *reinterpret_cast<const float4*>(sr + 4);
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
        s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
      } else {
        load_scales8(s, scales, h * K2 + j0 + r, n, (h + 1) * K2, N, block);
      }
      uint32_t packed[4];
      deq_nibbles8(packed, raws[it], h, s, lv, lane);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(tile + Tile<64>::offset(64 * h + r, c)), "r"(packed[0]),
                   "r"(packed[1]), "r"(packed[2]), "r"(packed[3])
                   : "memory");
    }
  }
}

// ------------------------------------------- both layouts, f32 routes
//
// The f32 designs (fma_sm90.cuh, tf32x3_sm90.cuh) take either layout
// through one template over BITS. A "packed row" p of the codes (R of them,
// N bytes each) holds one weight of each of RUNS rows of K: BITS 8 (R = K)
// one run, byte (p, n) is row p; BITS 4 (R = K2) two runs, the low nibble
// row p, the high nibble row R + p.

template <int BITS> struct Codes;
template <> struct Codes<4> {
  static constexpr int RUNS = 2, LEVELS = 16;
  static __device__ __forceinline__ uint32_t code(uint32_t byte, int h) {
    return (byte >> (4 * h)) & 0xF;
  }
};
template <> struct Codes<8> {
  static constexpr int RUNS = 1, LEVELS = 256;
  static __device__ __forceinline__ uint32_t code(uint32_t byte, int) { return byte; }
};

template <int BITS> constexpr int LV_F32_BYTES = Codes<BITS>::LEVELS * LV_COPIES * 4;

template <int BITS, int NT>
__device__ __forceinline__ void fill_levels_f32(float* lv, const float* __restrict__ levels,
                                                int tid) {
  if constexpr (BITS == 4)
    fill_levels4<NT>(lv, levels, tid);
  else
    fill_levels32<NT>(lv, levels, tid);
}

// The scale of K row h R + p, column n, read from device memory: 0 past R
// (in either run) or N.
__device__ __forceinline__ float scale_at(const float* __restrict__ scales, int h, int p, int n,
                                          int R, int N, int block) {
  return p < R && n < N ? __ldg(scales + (int64_t)((h * R + p) / block) * N + n) : 0.0f;
}

}  // namespace
