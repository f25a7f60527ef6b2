// One tile of 8-bit matmul-layout weights, dequantized into shared memory.
//
// The f32 route of the backward (matmul_8bit_t.cu: dx = g @ W^T) of the
// fused 8-bit matmul; the forward's designs dequantize through
// dequant8_sm90.cuh and fma_sm90.cuh. It streams
// W's codes ((K, N) bytes, one code a weight) and f32 block scales
// ((K/block, N): a block runs along K in each column), and dequantizes one
// tile of BK rows by BN columns per step as
//
//   deq(code) = T(levels[code] * scale[row / block, col])
//
// one f32 multiply rounded once, then rounded to the operand type T, as the
// TPU kernels round `w.astype(x.dtype)` (quanta_tpu/ops/matmul.py:289-294).
//
// One 256-entry f32 level table, read by the code's byte, serves all four
// 8-bit formats; the wrapper (ops/matmul.py) picks it:
//   - int8 (signed codes): levels[i] = (int8)i, so byte 0xC8 reads -56;
//   - int8a (unsigned codes, zero point added outside the kernel):
//     levels[i] = i, so byte 0xC8 reads 200. The two formats differ only
//     in signedness: a kernel that read both as int8 would pass every int8
//     test and be wrong for int8a;
//   - nf8 and fp8: the registered codebook tables. fp8 codes are indices
//     into the SORTED e4m3 table (duplicate +-0 and +-448), not e4m3 bit
//     patterns, so Hopper's FP8 conversion cannot read them. nf8's table
//     is tanh(2(2c/255 - 1))/tanh(2) evaluated in float64 and rounded to
//     f32; the TPU kernel evaluates it in f32 and may differ in the last
//     bit (the CPU parity tests state the tolerance that needs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;           // columns of W (N) per tile
constexpr int BK = 64;           // rows of W (K) per tile
constexpr int THREADS = 128;     // 4 warps
constexpr int N_LEVELS = 256;

static_assert(2 * THREADS * 16 == BK * BN, "two 16-byte code loads per thread per tile");

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

// Row stride padding of the shared tiles: 16 bytes keeps rows 16-byte
// aligned and breaks bank conflicts.
template <typename T> constexpr int kPad = 16 / sizeof(T);

// The level table into shared memory (call before the first __syncthreads).
__device__ __forceinline__ void load_levels(float* lv, const float* __restrict__ levels,
                                            int tid) {
  for (int i = tid; i < N_LEVELS; i += THREADS) lv[i] = levels[i];
}

// Dequantize W rows [r0, r0 + BK) x columns [n0, n0 + BN) into BK rows of
// T, row-major with stride BN + kPad<T>. Rows past `rows` and columns past
// N give zeros. `lv` is the level table in shared memory.
template <typename T>
__device__ __forceinline__ void load_b8(T* Bs, const uint8_t* __restrict__ codes,
                                        const float* __restrict__ scales, const float* lv,
                                        int r0, int rows, int n0, int N, int block, int tid) {
  constexpr int B_LD = BN + kPad<T>;
  const bool vec = (N % 16) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int idx = tid + half * THREADS;
    const int r = idx / (BN / 16);
    const int c = (idx % (BN / 16)) * 16;
    const int k = r0 + r;
    const int n = n0 + c;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (k < rows && vec && n + 16 <= N) {
      raw = __ldg(reinterpret_cast<const uint4*>(codes + (int64_t)k * N + n));
    } else if (k < rows) {
      uint8_t* bw = reinterpret_cast<uint8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (n + e < N) bw[e] = codes[(int64_t)k * N + n + e];
    }
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    const float* s = scales + (int64_t)(k / block) * N + n;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float w = 0.0f;
      if (k < rows && n + e < N) w = __fmul_rn(lv[b[e]], __ldg(s + e));
      Bs[r * B_LD + c + e] = from_f32<T>(w);
    }
  }
}

// A tile of a row-major (rows, cols) operand: a[m0:m0+64, c0:c0+64] into
// shared memory with stride 64 + kPad<T>; rows and columns past the edges
// give zeros: g of the backward (cols = N).
template <typename T>
__device__ __forceinline__ void load_rows(T* As, const T* __restrict__ a, int m0, int rows,
                                          int c0, int cols, int tid) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int W = 64;
  constexpr int A_LD = W + kPad<T>;
  const bool a_vec = (cols % VEC) == 0;        // 16-byte loads stay aligned
  for (int idx = tid; idx < 64 * (W / VEC); idx += THREADS) {
    const int r = idx / (W / VEC);
    const int c = (idx % (W / VEC)) * VEC;
    const int m = m0 + r, kk = c0 + c;
    T* dst = As + r * A_LD + c;
    if (m < rows && a_vec && kk + VEC <= cols) {
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(a + (int64_t)m * cols + kk));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = (m < rows && kk + e < cols) ? a[(int64_t)m * cols + kk + e]
                                             : from_f32<T>(0.0f);
    }
  }
}

}  // namespace
