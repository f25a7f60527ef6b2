// Transposed fused 8-bit matmul for Hopper (sm_90a): the backward dx of
// x @ deq(W), bf16 or f32 gradients.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_8bit_t
// (_mm8t_kernel). It computes, with W still 8-bit in device memory,
//
//   dx[m, k] = sum_n g[m, n] * T(levels[code[k, n]] * scale[k / block, n])
//
// for g (M, N) and 8-bit codes (K, N). deq is load_b8's (dequant8.cuh, the
// forward's): one f32 multiply rounded once, then rounded to the gradient
// type T before the product, as the TPU kernel rounds `w.astype(g.dtype)`;
// sums are f32 (wmma bf16 16x16x16 for bf16 g, plain FMAs for f32 g).
// int8a's zero-point term of W^T, repeat(g @ zp^T), is added by the wrapper
// outside the kernel, as the JAX package adds it.
//
// What bounds it on the H100: in QLoRA training M is batch x sequence
// (2048 for batch 4 x seq 512), so the product is bound by compute, 2*M*K*N
// flops against the bf16 tensor-core rate; the codes (1 B a weight) are
// read once per 64-row M tile. Design: one block of 4 warps per output tile
// of 64 rows of g by 64 dx columns (64 rows of W); it streams N in steps
// of 64, staging a tile of g and dequantizing the codes tile into shared
// memory once, whose layout as the col-major B operand is W^T. The dense
// weight never reaches device memory. No cp.async/TMA pipeline and no wgmma
// yet: each step's loads wait before its math. Rows of g, columns of N and
// rows of W past the edges are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "dequant8.cuh"  // BN, BK, THREADS, N_LEVELS, from_f32, kPad, load_levels, load_b8, load_rows

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BJ = BK;           // dx columns per tile: BK rows of W
constexpr int C_LD = BJ + 4;     // f32 epilogue tile

static_assert(BN == 64, "load_rows stages 64 columns of g per step");

// bf16: 4 warps as 2 x 2, each 32 rows x 32 dx columns as 2 x 2 fragments.
__global__ void __launch_bounds__(THREADS)
mm8t_bf16_kernel(const __nv_bfloat16* __restrict__ g,    // (M, N)
                 const uint8_t* __restrict__ codes,      // (K, N)
                 const float* __restrict__ scales,       // (K/block, N)
                 const float* __restrict__ levels,       // (256,)
                 __nv_bfloat16* __restrict__ out,        // (M, K)
                 int M, int N, int K, int block) {
  using T = __nv_bfloat16;
  constexpr int G_LD = BN + kPad<T>;
  constexpr int B_LD = BN + kPad<T>;
  __shared__ __align__(128) T Gs[BM * G_LD];
  __shared__ __align__(128) T Bs[BJ * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ float lv[N_LEVELS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BJ;
  load_levels(lv, levels, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BN) {
    load_rows(Gs, g, m0, M, n0, N, tid);
    load_b8(Bs, codes, scales, lv, j0, K, n0, N, block, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BN; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Gs + (wm * 32 + i * 16) * G_LD + ks, G_LD);
      // Bs row c holds W row j0 + c over n: as a col-major (n x c) operand
      // it is W^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * B_LD + ks, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: f32 accumulators -> shared -> bf16 dx (masked edges)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BJ; idx += THREADS) {
    const int r = idx / BJ, c = idx % BJ;
    const int m = m0 + r, k = j0 + c;
    if (m < M && k < K) out[(int64_t)m * K + k] = __float2bfloat16_rn(Cs[r * C_LD + c]);
  }
}

// f32: no exact f32 tensor-core path, so plain FMAs. Thread (ty, tx) owns
// rows ty + 8 i (i < 8) and dx columns tx + 16 j (j < 4).
__global__ void __launch_bounds__(THREADS)
mm8t_f32_kernel(const float* __restrict__ g, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, const float* __restrict__ levels,
                float* __restrict__ out, int M, int N, int K, int block) {
  constexpr int G_LD = BN + kPad<float>;
  constexpr int B_LD = BN + kPad<float>;
  __shared__ __align__(128) float Gs[BM * G_LD];
  __shared__ __align__(128) float Bs[BJ * B_LD];
  __shared__ float lv[N_LEVELS];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BJ;
  load_levels(lv, levels, tid);
  float acc[8][4] = {};
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BN) {
    load_rows(Gs, g, m0, M, n0, N, tid);
    load_b8(Bs, codes, scales, lv, j0, K, n0, N, block, tid);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BN; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Gs[(ty + 8 * i) * G_LD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * B_LD + k];
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
      const int m = m0 + ty + 8 * i, k = j0 + tx + 16 * j;
      if (m < M && k < K) out[(int64_t)m * K + k] = acc[i][j];
    }
}

}  // namespace

extern "C" int qt_matmul_8bit_t_bf16(const void* g, const void* codes, const void* scales,
                                     const void* levels, void* out, int M, int N, int K,
                                     int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + BJ - 1) / BJ, (M + BM - 1) / BM);
  mm8t_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<__nv_bfloat16*>(out), M, N, K, block);
  return (int)cudaGetLastError();
}

extern "C" int qt_matmul_8bit_t_f32(const void* g, const void* codes, const void* scales,
                                    const void* levels, void* out, int M, int N, int K,
                                    int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + BJ - 1) / BJ, (M + BM - 1) / BM);
  mm8t_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<float*>(out), M, N, K, block);
  return (int)cudaGetLastError();
}
