// One tile of split_k-packed 4-bit weights, dequantized into shared memory.
//
// Shared by the f32 forward (matmul_4bit.cu: out = x @ W; its bf16 designs
// dequantize through dequant4_sm90.cuh) and the backward (matmul_4bit_t.cu:
// dx = g @ W^T) of the fused 4-bit matmul. Both stream
// W's packed codes (K2 = K_pad/2 rows of N bytes; the low nibble of byte
// (k, n) is row k of W, the high nibble row k + K2) and f32 block scales
// (K_pad/block rows of N), and dequantize one tile of BKP packed rows by BN
// columns per step as deq(code) = T(levels[code] * scale): one f32 multiply
// rounded once, then rounded to the operand type T, as the TPU kernels round
// `w.astype(x.dtype)`. The 16-entry f32 level table serves every 4-bit
// codebook: for nf4a/int4 the registered levels are the f32 Horner values,
// so a lookup gives the same numbers without evaluating the polynomial
// (where nvcc would contract it into FMAs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;           // columns of W (N) per tile
constexpr int BKP = 32;          // packed rows of W per tile
constexpr int THREADS = 128;     // 4 warps

static_assert(THREADS * 16 == BKP * BN, "one 16-byte code load per thread per tile");

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

// Row stride padding of the shared tiles: 16 bytes keeps rows 16-byte
// aligned and breaks bank conflicts.
template <typename T> constexpr int kPad = 16 / sizeof(T);

// Dequantize packed rows [kp, kp + BKP) x columns [n0, n0 + BN) into
// 2*BKP rows of T, row-major with stride BN + kPad<T>: the lo nibbles in
// rows [0, BKP), the hi nibbles in [BKP, 2*BKP). Packed rows and columns
// past the edges give zeros. `lv` is the level table in shared memory.
template <typename T>
__device__ __forceinline__ void load_b(T* Bs, const uint8_t* __restrict__ codes,
                                       const float* __restrict__ scales, const float* lv,
                                       int n0, int N, int K2, int kp, int block, int tid) {
  constexpr int B_LD = BN + kPad<T>;
  const int r = tid / (BN / 16);
  const int c = (tid % (BN / 16)) * 16;
  const int k = kp + r;
  const int n = n0 + c;
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (k < K2 && (N % 16) == 0 && n + 16 <= N) {
    raw = __ldg(reinterpret_cast<const uint4*>(codes + (int64_t)k * N + n));
  } else if (k < K2) {
    uint8_t* bw = reinterpret_cast<uint8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (n + e < N) bw[e] = codes[(int64_t)k * N + n + e];
  }
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  const float* s_lo = scales + (int64_t)(k / block) * N + n;
  const float* s_hi = scales + (int64_t)((K2 + k) / block) * N + n;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    float w_lo = 0.0f, w_hi = 0.0f;
    if (k < K2 && n + e < N) {
      w_lo = __fmul_rn(lv[b[e] & 0x0F], __ldg(s_lo + e));
      w_hi = __fmul_rn(lv[b[e] >> 4], __ldg(s_hi + e));
    }
    Bs[r * B_LD + c + e] = from_f32<T>(w_lo);
    Bs[(BKP + r) * B_LD + c + e] = from_f32<T>(w_hi);
  }
}

}  // namespace
