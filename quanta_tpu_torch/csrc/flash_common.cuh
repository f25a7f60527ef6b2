// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_f32.cu).
//
// Tensors keep the model's layouts: q, out, dO (B, Sq, nh, hd), k, v (B, T,
// nkv, hd), row-major and contiguous, so row s of head h starts at
// ((b * S + s) * heads + h) * hd. The kernels work on 64-row tiles of them
// (rows past the end read as zeros): the bf16 kernels are built from
// sm90.cuh, the f32 ones (three TF32 products for each f32 one) from
// flash_tf32x3.cuh. Here: the tile size, the masks, the head dims and the
// launch.
//
// Head dims. Each kernel is compiled for HD = 32, 64, 128 and 256 columns; a
// head dim hd (a multiple of 4 up to 256) runs in the smallest HD >= hd,
// with hd passed at run time (PAD true): loads zero columns hd..HD-1 in
// shared memory, so q . k and dO . v (and so lse and D) are those of the
// hd real columns, and stores skip them; the caller's scale is 1/sqrt(hd).
// hd == HD takes the instantiation with PAD false, where hd folds to the
// constant HD and the loads and stores are the unpadded ones; the f32
// backward has none, as its masks cost it nothing (PERF.md). A multiple of
// 4 keeps every f32 row 16-byte aligned and every bf16 row 8-byte aligned;
// the wrapper (ops/attention.py) pads any other head dim with zero columns
// to a multiple of 8 before the launch.
//
// The 256-column instantiations are compiled apart, one nvcc each: a
// source *_w256.cu defines QT_FLASH_WIDE and includes its kernel source,
// whose with_hd then takes 256 alone and whose C entry points end in _w256
// (QT_FLASH_ENTRY); without it, a source takes 32, 64 and 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifdef QT_FLASH_WIDE
#define QT_FLASH_ENTRY(name) name##_w256
#else
#define QT_FLASH_ENTRY(name) name
#endif

namespace {

constexpr int TILE = 64;             // query rows and keys per tile
constexpr float kDeadLse = 1e30f;    // lse of a row with no live key: exp(s - lse) == 0
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, denormals flushed; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The compiled width a head dim runs in: the smallest of 32, 64, 128 and
// 256 that holds it, for a multiple of 4 up to 256; else 0.
inline int padded_hd(int hd) {
  if (hd <= 0 || hd % 4 != 0 || hd > 256) return 0;
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// f(std::integral_constant<int, HD>, std::bool_constant<PAD>) for head dim
// hd, or cudaErrorInvalidValue where no width compiled in this source takes it.
template <typename F> int with_hd(int hd, F f) {
  using P = std::true_type;
  using U = std::false_type;
  switch (padded_hd(hd)) {
#ifdef QT_FLASH_WIDE
    case 256: return hd == 256 ? f(std::integral_constant<int, 256>{}, U{})
                               : f(std::integral_constant<int, 256>{}, P{});
#else
    case 32: return hd == 32 ? f(std::integral_constant<int, 32>{}, U{})
                             : f(std::integral_constant<int, 32>{}, P{});
    case 64: return hd == 64 ? f(std::integral_constant<int, 64>{}, U{})
                             : f(std::integral_constant<int, 64>{}, P{});
    case 128: return hd == 128 ? f(std::integral_constant<int, 128>{}, U{})
                               : f(std::integral_constant<int, 128>{}, P{});
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

// Set the dynamic shared memory a kernel may take, then launch it in blocks
// of `threads`.
template <typename Kernel, typename... Args>
int launch_n(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
