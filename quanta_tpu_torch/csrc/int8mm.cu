// LLM.int8 GEMM for Hopper (sm_90a): int8 activations x int8 weights on the
// int8 tensor cores, exact int32 sums, row x column scales on the sum.
//
// Replaces two Pallas TPU kernels of quanta_tpu/ops/int8mm.py with one
// kernel template:
//   matmul_int8_fused  (_mm_i8_fused_kernel) -> qt_matmul_int8_fused (FUSED)
//   matmul_int8_kernel (_mm_i8_kernel)       -> qt_matmul_int8
// It computes, for codes (K, N) int8 with their outlier rows zeroed,
//
//   FUSED:  xq = clamp(rint(x / row_scale[m]), -127, 127)   (x f32 (M, K))
//           out = (float)(xq @ codes) * row_scale[m] * col_scale[n] + y_out[m, n]
//   plain:  out = (float)(xq @ codes) * row_scale[m] * col_scale[n]
//                                                            (xq int8 (M, K))
//
// The prologue divides with IEEE rounding (__fdiv_rn) and rounds half to
// even (rintf), as torch.round and jnp.round do; the int32 sum is exact;
// the epilogue is __fmul_rn / __fadd_rn in the plain version's order, so
// nvcc cannot contract it into an FMA. Kernel and plain version agree bit
// for bit. Build without --use_fast_math.
//
// What bounds it on the H100:
//   - decode (M = 8) is bound by memory: the K*N int8 code bytes, against
//     3.35 TB/s;
//   - prefill (M = 256) is bound by compute: 2*M*K*N int8 operations
//     against the int8 tensor-core rate.
// Design: one 64x64 output tile per block of 4 warps; each 64-deep step
// stages the x tile (quantized on the way in when FUSED) and the code tile
// in shared memory and runs 4 wmma s8 16x16x16 k-steps into int32
// accumulators, while the next step's tiles load into registers (one
// step of prefetch). The x tile is stored k-tiled ([k/16][m][16]) and the
// code tile n-tiled ([n/16][k][16]), so every wmma fragment starts on a
// 256-bit boundary. No split-K, no cp.async/TMA pipeline, no wgmma yet.
// Rows, columns and depth past the edges are masked. Every block of a
// column of tiles quantizes the same x rows again: at M = 8 that is 8
// rows, and it is what a split of the prologue would save.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;   // 4 warps as 2 x 2, each 32 x 32 of the tile
constexpr int C_LD = BN + 4;   // int32 elements

// x tile element (m, k) of a BM x BK tile
__device__ __forceinline__ int a_off(int m, int k) {
  return ((k >> 4) * BM + m) * 16 + (k & 15);
}

// code tile element (k, n) of a BK x BN tile
__device__ __forceinline__ int b_off(int k, int n) {
  return ((n >> 4) * BK + k) * 16 + (n & 15);
}

__device__ __forceinline__ int8_t quantize(float x, float rs) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, rs)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
i8_kernel(const void* __restrict__ xin,            // FUSED: f32 (M, K); else int8 (M, K)
          const int8_t* __restrict__ codes,        // (K, N)
          const float* __restrict__ row_scale,     // (M,)
          const float* __restrict__ col_scale,     // (N,)
          const float* __restrict__ y_out,         // (M, N), FUSED only
          float* __restrict__ out,                 // (M, N)
          int M, int N, int K) {
  __shared__ __align__(128) int8_t As[BM * BK];
  __shared__ __align__(128) int8_t Bs[BK * BN];
  __shared__ __align__(128) int Cs[BM * C_LD];
  __shared__ float rs_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_vec = FUSED ? (K % 4) == 0 : (K % 16) == 0;
  const bool b_vec = (N % 16) == 0;
  const float* x = static_cast<const float*>(xin);
  const int8_t* xq = static_cast<const int8_t*>(xin);

  for (int r = tid; r < BM; r += THREADS) rs_s[r] = (m0 + r < M) ? row_scale[m0 + r] : 1.f;

  // The next step's tiles are loaded into registers while the tensor cores
  // work on the current one, so each step waits on one round trip to
  // device memory instead of a chain of them.
  constexpr int AF = BM * BK / 4 / THREADS;   // FUSED: float4 per thread
  constexpr int AI = BM * BK / 16 / THREADS;  // plain: 16-byte rows per thread
  constexpr int BI = BK * BN / 16 / THREADS;
  float4 af[FUSED ? AF : 1];
  int4 ai[FUSED ? 1 : AI];
  int4 bi[BI];

  auto load = [&](int k0) {
    if constexpr (FUSED) {
#pragma unroll
      for (int j = 0; j < AF; ++j) {
        const int idx = tid + j * THREADS;
        const int m = m0 + idx / (BK / 4), k = k0 + (idx % (BK / 4)) * 4;
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < M) {
          const float* src = x + (int64_t)m * K + k;
          if (a_vec && k + 4 <= K) {
            f = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            f.x = k < K ? src[0] : 0.f;
            f.y = k + 1 < K ? src[1] : 0.f;
            f.z = k + 2 < K ? src[2] : 0.f;
            f.w = k + 3 < K ? src[3] : 0.f;
          }
        }
        af[j] = f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < AI; ++j) {
        const int idx = tid + j * THREADS;
        const int m = m0 + idx / (BK / 16), k = k0 + (idx % (BK / 16)) * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (m < M && a_vec && k + 16 <= K) {
          v = __ldg(reinterpret_cast<const int4*>(xq + (int64_t)m * K + k));
        } else if (m < M) {
          int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
          for (int e = 0; e < 16; ++e) b[e] = k + e < K ? xq[(int64_t)m * K + k + e] : int8_t(0);
        }
        ai[j] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < BI; ++j) {
      const int idx = tid + j * THREADS;
      const int k = k0 + idx / (BN / 16), n = n0 + (idx % (BN / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < K && b_vec && n + 16 <= N) {
        v = __ldg(reinterpret_cast<const int4*>(codes + (int64_t)k * N + n));
      } else if (k < K) {
        int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
        for (int e = 0; e < 16; ++e) b[e] = n + e < N ? codes[(int64_t)k * N + n + e] : int8_t(0);
      }
      bi[j] = v;
    }
  };

  // registers -> shared tiles; FUSED quantizes x on the way (rows past M
  // stay 0 without a division)
  auto store = [&]() {
    if constexpr (FUSED) {
#pragma unroll
      for (int j = 0; j < AF; ++j) {
        const int idx = tid + j * THREADS;
        const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
        char4 q = make_char4(0, 0, 0, 0);
        if (m0 + r < M) {
          const float rs = rs_s[r];
          q.x = quantize(af[j].x, rs); q.y = quantize(af[j].y, rs);
          q.z = quantize(af[j].z, rs); q.w = quantize(af[j].w, rs);
        }
        *reinterpret_cast<char4*>(As + a_off(r, c)) = q;
      }
    } else {
#pragma unroll
      for (int j = 0; j < AI; ++j) {
        const int idx = tid + j * THREADS;
        *reinterpret_cast<int4*>(As + a_off(idx / (BK / 16), (idx % (BK / 16)) * 16)) = ai[j];
      }
    }
#pragma unroll
    for (int j = 0; j < BI; ++j) {
      const int idx = tid + j * THREADS;
      *reinterpret_cast<int4*>(Bs + b_off(idx / (BN / 16), (idx % (BN / 16)) * 16)) = bi[j];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  __syncthreads();  // rs_s
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);

#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const signed char*>(As + a_off(wm * 32 + i * 16, kt * 16)), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const signed char*>(Bs + b_off(kt * 16, wn * 32 + j * 16)), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: exact int32 -> f32, * row_scale, * col_scale (+ y_out)
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
    if (m < M && n < N) {
      float v = __fmul_rn(__fmul_rn(__int2float_rn(Cs[r * C_LD + c]), rs_s[r]), col_scale[n]);
      if (FUSED) v = __fadd_rn(v, y_out[(int64_t)m * N + n]);
      out[(int64_t)m * N + n] = v;
    }
  }
}

int launch(bool fused, const void* xin, const void* codes, const void* row_scale,
           const void* col_scale, const void* y_out, void* out, int M, int N, int K,
           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int8_t*>(codes);
  auto rs = static_cast<const float*>(row_scale);
  auto cs = static_cast<const float*>(col_scale);
  auto y = static_cast<const float*>(y_out);
  auto o = static_cast<float*>(out);
  if (fused)
    i8_kernel<true><<<grid, THREADS, 0, s>>>(xin, c, rs, cs, y, o, M, N, K);
  else
    i8_kernel<false><<<grid, THREADS, 0, s>>>(xin, c, rs, cs, y, o, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qt_matmul_int8_fused(const void* x, const void* codes, const void* row_scale,
                                    const void* col_scale, const void* y_out, void* out,
                                    int M, int N, int K, void* stream) {
  return launch(true, x, codes, row_scale, col_scale, y_out, out, M, N, K, stream);
}

extern "C" int qt_matmul_int8(const void* xq, const void* codes, const void* row_scale,
                              const void* col_scale, void* out, int M, int N, int K,
                              void* stream) {
  return launch(false, xq, codes, row_scale, col_scale, nullptr, out, M, N, K, stream);
}
