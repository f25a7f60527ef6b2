// Fused 4-bit dequant-matmul for Hopper (sm_90a), bf16 or f32 activations.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_4bit
// (_mm4_kernel). It computes
//
//   out = x[:, :K2] @ deq(lo) + x[:, K2:] @ deq(hi)
//
// for split_k-packed codes (K2 = K_pad/2 packed rows; the low nibble of
// byte (k, n) is row k, the high nibble row k + K2), where
// deq(code) = T(levels[code] * scale[row / block, n]): one f32 multiply
// rounded once, then rounded to the activation type T before the product,
// as the TPU kernel rounds `w.astype(x.dtype)`, through a 16-entry level
// table (load_b in dequant4.cuh, shared with the backward,
// matmul_4bit_t.cu). Products accumulate in f32: on the tensor cores (wmma
// bf16 16x16x16) for bf16 activations, in plain FMAs for f32 ones.
//
// What bounds it on the H100:
//   - decode (M = 8) is bound by memory: every weight streams once at
//     0.5 B plus 4 B per 64-weight scale, against 3.35 TB/s;
//   - prefill (M = 1024) is bound by compute: 2*M*K*N flops against the
//     bf16 tensor-core rate.
// Design: one 64x64 output tile per block of 4 warps; each step stages
// 32 packed rows (64 logical rows of K) of codes, dequantizes them into a
// tile of T in shared memory and multiplies. Packed weights never reach
// device memory dequantized. There is no split-K, no cp.async/TMA pipeline
// and no wgmma yet: at M = 8 a 64-column tile grid leaves most SMs idle
// for narrow N, and each step's loads wait in line before its math, so
// decode runs far above the bandwidth floor. Rows, columns and packed rows
// past the edges are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "dequant4.cuh"  // BN, BKP, THREADS, from_f32, kPad, load_b

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BK = 2 * BKP;      // logical K per step: BKP lo rows + BKP hi rows
constexpr int C_LD = BN + 4;     // f32 epilogue tile

// A tile: x[m0:m0+BM, kp:kp+BKP] ++ x[m0:m0+BM, K2+kp:K2+kp+BKP], row-major.
template <typename T>
__device__ __forceinline__ void load_a(T* As, const T* __restrict__ x, int m0, int M,
                                       int K2, int kp, int tid) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int A_LD = BK + kPad<T>;
  const int64_t ldx = 2 * (int64_t)K2;
  const bool x_vec = (K2 % VEC) == 0;          // 16-byte loads stay aligned
  for (int idx = tid; idx < BM * (BK / VEC); idx += THREADS) {
    const int r = idx / (BK / VEC), seg = idx % (BK / VEC);
    const int half = seg / (BKP / VEC);
    const int kk = kp + (seg % (BKP / VEC)) * VEC;
    const int m = m0 + r;
    T* dst = As + r * A_LD + seg * VEC;
    if (m < M && x_vec && kk + VEC <= K2) {
      const T* src = x + m * ldx + (int64_t)half * K2 + kk;
      *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = (m < M && kk + e < K2) ? x[m * ldx + (int64_t)half * K2 + kk + e]
                                        : from_f32<T>(0.0f);
    }
  }
}

// bf16: 4 warps as 2 x 2, each 32 x 32 of the tile as 2 x 2 wmma fragments.
__global__ void __launch_bounds__(THREADS)
mm4_bf16_kernel(const __nv_bfloat16* __restrict__ x,    // (M, 2*K2)
                const uint8_t* __restrict__ codes,      // (K2, N)
                const float* __restrict__ scales,       // (2*K2/block, N)
                const float* __restrict__ levels,       // (16,)
                __nv_bfloat16* __restrict__ out,        // (M, N)
                int M, int N, int K2, int block) {
  using T = __nv_bfloat16;
  constexpr int A_LD = BK + kPad<T>;
  constexpr int B_LD = BN + kPad<T>;
  __shared__ __align__(128) T As[BM * A_LD];
  __shared__ __align__(128) T Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ float lv[16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (tid < 16) lv[tid] = levels[tid];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  __syncthreads();

  for (int kp = 0; kp < K2; kp += BKP) {
    load_a(As, x, m0, M, K2, kp, tid);
    load_b(Bs, codes, scales, lv, n0, N, K2, kp, block, tid);
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
mm4_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scales, const float* __restrict__ levels,
               float* __restrict__ out, int M, int N, int K2, int block) {
  constexpr int A_LD = BK + kPad<float>;
  constexpr int B_LD = BN + kPad<float>;
  __shared__ __align__(128) float As[BM * A_LD];
  __shared__ __align__(128) float Bs[BK * B_LD];
  __shared__ float lv[16];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (tid < 16) lv[tid] = levels[tid];
  float acc[8][4] = {};
  __syncthreads();

  for (int kp = 0; kp < K2; kp += BKP) {
    load_a(As, x, m0, M, K2, kp, tid);
    load_b(Bs, codes, scales, lv, n0, N, K2, kp, block, tid);
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

extern "C" int qt_matmul_4bit_bf16(const void* x, const void* codes, const void* scales,
                                   const void* levels, void* out, int M, int N, int K2,
                                   int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm4_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<__nv_bfloat16*>(out), M, N, K2, block);
  return (int)cudaGetLastError();
}

extern "C" int qt_matmul_4bit_f32(const void* x, const void* codes, const void* scales,
                                  const void* levels, void* out, int M, int N, int K2,
                                  int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm4_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<float*>(out), M, N, K2, block);
  return (int)cudaGetLastError();
}
