// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Tensors keep the model's layouts: q, out, dO (B, Sq, nh, hd), k, v (B, T,
// nkv, hd), row-major and contiguous, so row s of head h starts at
// ((b * S + s) * heads + h) * hd. A block stages 64-row tiles of them in
// shared memory (rows past the end read as zeros) and each of its 4 warps
// owns 16 rows of every product it computes.
//
// WarpAcc<float, N> is one warp's 16 x N f32 accumulator for the f32
// forward kernel, with the product it needs, acc += A (16 x K) * B (K x N),
// A and B in shared memory in either layout: plain FMAs on the CUDA cores
// (no TF32), lane l holding row l / 2 at columns 2c + l % 2. Its
// elementwise work (masks, softmax) goes through shared memory. The bf16
// kernels and the f32 backward (three TF32 products for each f32 one) are
// built from sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;             // query rows and keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = TILE / WARPS;  // rows each warp owns
constexpr float kDeadLse = 1e30f;    // lse of a row with no live key: exp(s - lse) == 0
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, denormals flushed; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row padding of the shared tiles: 16 bytes keeps rows 16-byte aligned
// (16-byte loads) and spreads rows over the banks.
template <typename T> constexpr int kPad = 16 / sizeof(T);
constexpr int kAccLd(int n) { return n + 4; }  // f32 tiles

struct RowMajor {};  // X(r, c) at p[r * ld + c]
struct ColMajor {};  // X(r, c) at p[c * ld + r]

template <typename L> __device__ __forceinline__ int at(int r, int c, int ld);
template <> __device__ __forceinline__ int at<RowMajor>(int r, int c, int ld) { return r * ld + c; }
template <> __device__ __forceinline__ int at<ColMajor>(int r, int c, int ld) { return c * ld + r; }

template <typename T, int N> struct WarpAcc;

template <int N> struct WarpAcc<float, N> {
  float v[N / 2];  // row lane / 2, columns 2c + lane % 2

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < N / 2; ++c) v[c] = 0.0f;
  }
  __device__ __forceinline__ void store(float* dst, int ld) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int c = 0; c < N / 2; ++c) dst[(lane >> 1) * ld + 2 * c + (lane & 1)] = v[c];
  }
  __device__ __forceinline__ void load(const float* src, int ld) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int c = 0; c < N / 2; ++c) v[c] = src[(lane >> 1) * ld + 2 * c + (lane & 1)];
  }
  template <typename LA, typename LB, int K>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb) {
    const int lane = threadIdx.x % 32;
    const int r = lane >> 1, par = lane & 1;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a = A[at<LA>(r, k, lda)];
#pragma unroll
      for (int c = 0; c < N / 2; ++c) v[c] = fmaf(a, B[at<LB>(k, 2 * c + par, ldb)], v[c]);
    }
  }
};

// Rows [r0, r0 + TILE) of one head of a (B, S, heads, HD) tensor into a
// shared tile of stride HD + kPad<T>; rows at or past `rows` are zeros.
// `src` points at row 0 of that batch row and head; `row_stride` is
// heads * HD. 16-byte loads: the wrapper passes 16-byte aligned bases.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int64_t row_stride,
                                          int r0, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = HD + kPad<T>;
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * row_stride + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Key or query position `pos` can be attended from query position `qpos`.
__device__ __forceinline__ bool live_pair(int kpos, int qpos, int kv_len, int causal) {
  return kpos < kv_len && (!causal || kpos <= qpos);
}

// Keys [0, kv_end) can be live for the query rows [q0, min(q0 + TILE, Sq))
// of a batch row whose queries start at position q_start.
__device__ __forceinline__ int live_kv_end(int q_start, int q0, int Sq, int kv_len, int causal) {
  return causal ? min(kv_len, q_start + min(q0 + TILE, Sq)) : kv_len;
}

// Set the dynamic shared memory a kernel may take, then launch it (blocks
// of THREADS, or of `threads`).
template <typename Kernel, typename... Args>
int launch_n(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  return launch_n(kernel, grid, THREADS, smem, stream, args...);
}

}  // namespace
