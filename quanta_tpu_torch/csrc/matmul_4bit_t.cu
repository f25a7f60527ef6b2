// Transposed fused 4-bit matmul for Hopper (sm_90a): the backward dx of
// x @ deq(W), bf16 or f32 gradients.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_4bit_t
// (_mm4t_kernel). It computes, with W still packed,
//
//   dx[:, j]      = g @ deq(lo[j, :])^T       (j < K2)
//   dx[:, K2 + j] = g @ deq(hi[j, :])^T
//
// for g (M, N) and split_k-packed codes (K2, N): one tile of packed rows
// gives both nibble halves' dx columns. deq is load_b's (dequant4.cuh, the
// forward's): T(levels[code] * scale), rounded to the gradient type T
// before the product, as the TPU kernel rounds `w.astype(g.dtype)`; sums
// are f32 (wmma bf16 16x16x16 for bf16 g, plain FMAs for f32 g).
//
// What bounds it on the H100: in QLoRA training M is batch x sequence
// (2048 here), so the product is bound by compute, 2*M*K*N flops against
// the bf16 tensor-core rate; the codes (0.5 B a weight) are read once per
// 64-row M tile. Design: one block of 4 warps per output tile of 64 rows
// of g by 32 packed rows of W, i.e. 64 dx columns (32 lo, 32 hi); it
// streams N in steps of 64, staging a tile of g and dequantizing the
// codes tile into shared memory once, as lo and hi rows, whose layout as
// the col-major B operand is W^T. Warps 0-1 accumulate the lo columns,
// warps 2-3 the hi ones. The dense weight never reaches device memory. No
// cp.async/TMA pipeline and no wgmma yet: each step's loads wait before
// its math. Rows of g, columns of N and packed rows past the edges are
// masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "dequant4.cuh"  // BN, BKP, THREADS, from_f32, kPad, load_b

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BJ = 2 * BKP;      // dx columns per tile: BKP lo + BKP hi
constexpr int C_LD = BJ + 4;     // f32 epilogue tile

// G tile: g[m0:m0+BM, n0:n0+BN], row-major with stride BN + kPad<T>.
template <typename T>
__device__ __forceinline__ void load_g(T* Gs, const T* __restrict__ g, int m0, int M, int N,
                                       int n0, int tid) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int G_LD = BN + kPad<T>;
  const bool g_vec = (N % VEC) == 0;           // 16-byte loads stay aligned
  for (int idx = tid; idx < BM * (BN / VEC); idx += THREADS) {
    const int r = idx / (BN / VEC);
    const int c = (idx % (BN / VEC)) * VEC;
    const int m = m0 + r, n = n0 + c;
    T* dst = Gs + r * G_LD + c;
    if (m < M && g_vec && n + VEC <= N) {
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(g + (int64_t)m * N + n));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = (m < M && n + e < N) ? g[(int64_t)m * N + n + e] : from_f32<T>(0.0f);
    }
  }
}

// Tile column c (< BJ) -> dx column: lo half j0 + c, hi half K2 + j0 + c - BKP.
__device__ __forceinline__ int dx_col(int c, int j0, int K2) {
  return c < BKP ? j0 + c : K2 + j0 + (c - BKP);
}

// bf16: 4 warps as 2 x 2, each 32 rows x 32 dx columns as 2 x 2 fragments.
__global__ void __launch_bounds__(THREADS)
mm4t_bf16_kernel(const __nv_bfloat16* __restrict__ g,    // (M, N)
                 const uint8_t* __restrict__ codes,      // (K2, N)
                 const float* __restrict__ scales,       // (2*K2/block, N)
                 const float* __restrict__ levels,       // (16,)
                 __nv_bfloat16* __restrict__ out,        // (M, 2*K2)
                 int M, int N, int K2, int block) {
  using T = __nv_bfloat16;
  constexpr int G_LD = BN + kPad<T>;
  constexpr int B_LD = BN + kPad<T>;
  __shared__ __align__(128) T Gs[BM * G_LD];
  __shared__ __align__(128) T Bs[BJ * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ float lv[16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;   // wn 0: lo columns, 1: hi columns
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BKP;
  if (tid < 16) lv[tid] = levels[tid];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BN) {
    load_g(Gs, g, m0, M, N, n0, tid);
    load_b(Bs, codes, scales, lv, n0, N, K2, j0, block, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BN; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Gs + (wm * 32 + i * 16) * G_LD + ks, G_LD);
      // Bs row c holds W row (lo or hi) over n: as a col-major (n x c)
      // operand it is W^T
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
  const int64_t ldo = 2 * (int64_t)K2;
  for (int idx = tid; idx < BM * BJ; idx += THREADS) {
    const int r = idx / BJ, c = idx % BJ;
    const int m = m0 + r;
    if (m < M && j0 + c % BKP < K2)
      out[m * ldo + dx_col(c, j0, K2)] = __float2bfloat16_rn(Cs[r * C_LD + c]);
  }
}

// f32: no exact f32 tensor-core path, so plain FMAs. Thread (ty, tx) owns
// rows ty + 8 i (i < 8) and tile columns tx + 16 j (j < 4).
__global__ void __launch_bounds__(THREADS)
mm4t_f32_kernel(const float* __restrict__ g, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, const float* __restrict__ levels,
                float* __restrict__ out, int M, int N, int K2, int block) {
  constexpr int G_LD = BN + kPad<float>;
  constexpr int B_LD = BN + kPad<float>;
  __shared__ __align__(128) float Gs[BM * G_LD];
  __shared__ __align__(128) float Bs[BJ * B_LD];
  __shared__ float lv[16];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BKP;
  if (tid < 16) lv[tid] = levels[tid];
  float acc[8][4] = {};
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BN) {
    load_g(Gs, g, m0, M, N, n0, tid);
    load_b(Bs, codes, scales, lv, n0, N, K2, j0, block, tid);
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
  const int64_t ldo = 2 * (int64_t)K2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 8 * i, c = tx + 16 * j;
      if (m < M && j0 + c % BKP < K2) out[m * ldo + dx_col(c, j0, K2)] = acc[i][j];
    }
}

}  // namespace

extern "C" int qt_matmul_4bit_t_bf16(const void* g, const void* codes, const void* scales,
                                     const void* levels, void* out, int M, int N, int K2,
                                     int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K2 + BKP - 1) / BKP, (M + BM - 1) / BM);
  mm4t_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<__nv_bfloat16*>(out), M, N, K2, block);
  return (int)cudaGetLastError();
}

extern "C" int qt_matmul_4bit_t_f32(const void* g, const void* codes, const void* scales,
                                    const void* levels, void* out, int M, int N, int K2,
                                    int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K2 + BKP - 1) / BKP, (M + BM - 1) / BM);
  mm4t_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<float*>(out), M, N, K2, block);
  return (int)cudaGetLastError();
}
