// Fused 8-bit dequant-matmul for Hopper (sm_90a), bf16 or f32 activations.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_8bit
// (_mm8_kernel). It computes
//
//   out[m, n] = sum_k x[m, k] * T(levels[code[k, n]] * scale[k / block, n])
//
// for 8-bit matmul-layout codes (K, N) (one byte a weight: int8, nf8,
// fp8 or the unsigned int8a codes) and f32 block scales (K/block, N),
// through one 256-entry level table (dequant8.cuh says how the wrapper
// picks it for each format, and why fp8 codes cannot go through Hopper's
// FP8 conversion). T is the activation type: the weight is one f32 multiply
// rounded once, then rounded to T before the product, as the TPU kernel
// rounds `w.astype(x_ref.dtype)`. Products accumulate in f32: on the tensor
// cores (wmma bf16 16x16x16) for bf16 activations, in plain FMAs for f32
// ones. int8a's zero-point term, blocksum(x) @ zp, is added by the wrapper
// outside the kernel, as the JAX package adds it.
//
// What bounds it on the H100:
//   - decode (M = 8) is bound by memory: every weight streams once at
//     1 B plus 4 B per 64-weight scale (1.0625 B a weight), against
//     3.35 TB/s;
//   - prefill and training (M >= 1024) are bound by compute: 2*M*K*N
//     flops against the bf16 tensor-core rate.
// Design: one 64x64 output tile per block of 4 warps; each step stages a
// 64x64 tile of x and dequantizes 64 rows of codes through the level table
// (1 KB of shared memory, loaded once per block) into a tile of T in shared
// memory, then multiplies. Codes never reach device memory dequantized.
// There is no split-K, no cp.async/TMA pipeline and no wgmma yet: at M = 8
// a 64-column tile grid leaves most SMs idle for narrow N, and each step's
// loads wait in line before its math. Rows, columns and K past the edges
// are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "dequant8.cuh"  // BN, BK, THREADS, N_LEVELS, from_f32, kPad, load_levels, load_b8, load_rows

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int C_LD = BN + 4;     // f32 epilogue tile

static_assert(BK == 64, "load_rows stages 64 columns of x per step");

// bf16: 4 warps as 2 x 2, each 32 x 32 of the tile as 2 x 2 wmma fragments.
__global__ void __launch_bounds__(THREADS)
mm8_bf16_kernel(const __nv_bfloat16* __restrict__ x,    // (M, K)
                const uint8_t* __restrict__ codes,      // (K, N)
                const float* __restrict__ scales,       // (K/block, N)
                const float* __restrict__ levels,       // (256,)
                __nv_bfloat16* __restrict__ out,        // (M, N)
                int M, int N, int K, int block) {
  using T = __nv_bfloat16;
  constexpr int A_LD = BK + kPad<T>;
  constexpr int B_LD = BN + kPad<T>;
  __shared__ __align__(128) T As[BM * A_LD];
  __shared__ __align__(128) T Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ float lv[N_LEVELS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  load_levels(lv, levels, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows(As, x, m0, M, k0, K, tid);
    load_b8(Bs, codes, scales, lv, k0, K, n0, N, block, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * A_LD + ks, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + ks * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: f32 accumulators -> shared -> bf16 out (masked edges)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[(int64_t)m * N + n] = __float2bfloat16_rn(Cs[r * C_LD + c]);
  }
}

// f32: no exact f32 tensor-core path, so plain FMAs. Thread (ty, tx) owns
// rows ty + 8 i (i < 8) and columns tx + 16 j (j < 4): the A reads of a
// warp broadcast, its B reads hit 16 consecutive words.
__global__ void __launch_bounds__(THREADS)
mm8_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scales, const float* __restrict__ levels,
               float* __restrict__ out, int M, int N, int K, int block) {
  constexpr int A_LD = BK + kPad<float>;
  constexpr int B_LD = BN + kPad<float>;
  __shared__ __align__(128) float As[BM * A_LD];
  __shared__ __align__(128) float Bs[BK * B_LD];
  __shared__ float lv[N_LEVELS];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  load_levels(lv, levels, tid);
  float acc[8][4] = {};
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows(As, x, m0, M, k0, K, tid);
    load_b8(Bs, codes, scales, lv, k0, K, n0, N, block, tid);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 8 * i) * A_LD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * B_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 8 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(int64_t)m * N + n] = acc[i][j];
    }
}

}  // namespace

extern "C" int qt_matmul_8bit_bf16(const void* x, const void* codes, const void* scales,
                                   const void* levels, void* out, int M, int N, int K,
                                   int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm8_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<__nv_bfloat16*>(out), M, N, K, block);
  return (int)cudaGetLastError();
}

extern "C" int qt_matmul_8bit_f32(const void* x, const void* codes, const void* scales,
                                  const void* levels, void* out, int M, int N, int K,
                                  int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm8_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<float*>(out), M, N, K, block);
  return (int)cudaGetLastError();
}
