// int4c matmul for Hopper (sm_90a): int4 weights on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/int4c.py:matmul_int4c_kernel
// (_mm_i4c_kernel). It computes
//
//   out[m, n] = (float)acc[m, n] * row_scale[m] * col_scale[n],
//   acc = xq[:, :K2] @ (lo - 8) + xq[:, K2:] @ (hi - 8)   (int32, exact)
//
// for int8 activations xq (M, 2*K2) and split_k-packed weight codes
// (K2, N) biased by +8 (the low nibble of byte (k, n) is row k, the high
// nibble row k + K2). The int32 sum is exact and the epilogue is two f32
// multiplies in that order, so the result equals the plain version bit for
// bit.
//
// What bounds it on the H100:
//   - decode (M = 8) is bound by memory: 0.5 B per weight plus 4 B per
//     column scale, against 3.35 TB/s;
//   - prefill (M = 1024) is bound by compute: 2*M*K*N int8 operations
//     against the int8 tensor-core rate.
// Design: one 64x64 output tile per block of 4 warps; each step stages 32
// packed rows of codes, unpacks (nibble - 8) to int8 in shared memory and
// runs 4 wmma s8 16x16x16 k-steps into int32 accumulators. Both tiles are
// stored k-tiled ([k/16][row][16]) so every wmma fragment starts on a
// 256-bit boundary. No split-K, no cp.async/TMA pipeline, no wgmma yet.
// Rows, columns and packed rows past the edges are masked.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKP = 32;          // packed rows per step
constexpr int BK = 2 * BKP;      // logical K per step
constexpr int THREADS = 128;     // 4 warps as 2 x 2, each 32 x 32 of the tile
constexpr int C_LD = BN + 4;     // int32 elements

static_assert(THREADS * 16 == BKP * BN, "one 16-byte code load per thread per step");

// k-tiled shared layouts: element (row, k) of a tile with R rows lives at
// ((k / 16) * R + row) * 16 + k % 16.
__device__ __forceinline__ int ktile(int row, int k, int rows) {
  return ((k >> 4) * rows + row) * 16 + (k & 15);
}

__global__ void __launch_bounds__(THREADS)
i4c_kernel(const int8_t* __restrict__ xq,          // (M, 2*K2)
           const uint8_t* __restrict__ codes,      // (K2, N), nibbles biased +8
           const float* __restrict__ row_scale,    // (M,)
           const float* __restrict__ col_scale,    // (N,)
           float* __restrict__ out,                // (M, N)
           int M, int N, int K2) {
  __shared__ __align__(128) int8_t As[BK * BM];
  __shared__ __align__(128) int8_t Bs[BK * BN];
  __shared__ __align__(128) int Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int64_t ldx = 2 * (int64_t)K2;
  const bool x_vec = (K2 % 16) == 0;
  const bool c_vec = (N % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int kp = 0; kp < K2; kp += BKP) {
    // ---- A tile: 16-byte segments; segment s of a row holds logical k in
    // [16 s, 16 s + 16): s = 0, 1 from the lo half of x, s = 2, 3 the hi half
    for (int idx = tid; idx < BM * (BK / 16); idx += THREADS) {
      const int r = idx / (BK / 16), seg = idx % (BK / 16);
      const int half = seg / (BKP / 16);
      const int kk = kp + (seg % (BKP / 16)) * 16;
      const int m = m0 + r;
      int8_t* dst = As + ktile(r, seg * 16, BM);
      if (m < M && x_vec && kk + 16 <= K2) {
        *reinterpret_cast<int4*>(dst) =
            __ldg(reinterpret_cast<const int4*>(xq + m * ldx + (int64_t)half * K2 + kk));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (m < M && kk + e < K2) ? xq[m * ldx + (int64_t)half * K2 + kk + e]
                                          : int8_t(0);
      }
    }
    // ---- B tile: unpack (nibble - 8); lo -> logical k = r, hi -> BKP + r
    {
      const int r = tid / (BN / 16);
      const int c = (tid % (BN / 16)) * 16;
      const int k = kp + r;
      const int n = n0 + c;
      uint4 raw = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      if (k < K2 && c_vec && n + 16 <= N) {
        raw = __ldg(reinterpret_cast<const uint4*>(codes + (int64_t)k * N + n));
      } else {
        // masked codes are 0x88: both nibbles unpack to 0
        uint8_t* bw = reinterpret_cast<uint8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (k < K2 && n + e < N) bw[e] = codes[(int64_t)k * N + n + e];
      }
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        Bs[ktile(c + e, r, BN)] = int8_t(int(b[e] & 0x0F) - 8);
        Bs[ktile(c + e, BKP + r, BN)] = int8_t(int(b[e] >> 4) - 8);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const signed char*>(As + ktile(wm * 32 + i * 16, kt * 16, BM)), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const signed char*>(Bs + ktile(wn * 32 + j * 16, kt * 16, BN)), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: exact int32 -> f32, then * row_scale, then * col_scale
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
    if (m < M && n < N)
      out[(int64_t)m * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(Cs[r * C_LD + c]), row_scale[m]), col_scale[n]);
  }
}

}  // namespace

extern "C" int qt_matmul_int4c(const void* xq, const void* codes, const void* row_scale,
                               const void* col_scale, void* out, int M, int N, int K2,
                               void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  i4c_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
      static_cast<float*>(out), M, N, K2);
  return (int)cudaGetLastError();
}

extern "C" const char* qt_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
