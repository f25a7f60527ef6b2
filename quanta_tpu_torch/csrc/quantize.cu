// Blockwise quantize for Hopper (sm_90a): one warp per block of values.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/quantize.py:
// quantize_blockwise (_quant_kernel). For the flat input x (n values,
// zero-padded to n_blocks * block) it writes, per block b,
//
//   absmax = max |x[b, :]|
//   int8_sym (n_mids == 0):
//     scale[b] = absmax <= 1e-12 ? 1 : absmax / 127
//     codes[b, i] = clamp(rint(x[b, i] / scale[b]), -127, 127)      (int8)
//   codebook (n_mids > 0, midpoints sorted ascending):
//     scale[b] = absmax <= 1e-12 ? 1 : absmax
//     codes[b, i] = #(midpoints < x[b, i] / scale[b])               (uint8)
//
// Divisions are IEEE (__fdiv_rn) and rintf rounds half to even, as the
// plain PyTorch version does, so the two agree bit for bit.
//
// What bounds it on the H100: memory (4 or 2 bytes read and 1 written per
// value; the KV writes of a serving step are a few hundred KB), and at
// those sizes the launch itself. Design: each warp owns one block; lanes
// stride over it (block / 32 values each, 2 at head_dim 64), so loads are
// coalesced; the absmax is a 5-step warp shuffle, so no shared memory and
// no second pass. The codebook search is a compare chain over the
// midpoints, which the wrapper hands over as a device array.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps = 4 blocks of values per CUDA block
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ x, void* __restrict__ codes, float* __restrict__ scale,
             const float* __restrict__ mids, int64_t n, int block, int n_blocks, int n_mids) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (b >= n_blocks) return;  // warp-uniform: the whole warp leaves
  const int64_t base = b * block;

  float amax = 0.f;
  for (int i = lane; i < block; i += 32) {
    const int64_t j = base + i;
    amax = fmaxf(amax, fabsf(j < n ? to_float(x[j]) : 0.f));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  if (n_mids == 0) {
    const float s = amax <= EPS ? 1.f : __fdiv_rn(amax, 127.f);
    int8_t* c = static_cast<int8_t*>(codes) + base;
    for (int i = lane; i < block; i += 32) {
      const int64_t j = base + i;
      const float v = j < n ? to_float(x[j]) : 0.f;
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
      c[i] = static_cast<int8_t>(static_cast<int>(q));
    }
    if (lane == 0) scale[b] = s;
  } else {
    const float s = amax <= EPS ? 1.f : amax;
    uint8_t* c = static_cast<uint8_t*>(codes) + base;
    for (int i = lane; i < block; i += 32) {
      const int64_t j = base + i;
      const float u = __fdiv_rn(j < n ? to_float(x[j]) : 0.f, s);
      int idx = 0;
      for (int t = 0; t < n_mids; ++t) idx += (u > __ldg(mids + t)) ? 1 : 0;
      c[i] = static_cast<uint8_t>(idx);
    }
    if (lane == 0) scale[b] = s;
  }
}

template <typename T>
int launch(const void* x, void* codes, void* scale, const void* mids, long long n, int block,
           int n_blocks, int n_mids, void* stream) {
  if (n <= 0 || block <= 0 || n_blocks <= 0 || n_mids < 0 || n_mids > 255 ||
      (long long)n_blocks * block < n || (n_mids > 0 && mids == nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = (n_blocks + THREADS / 32 - 1) / (THREADS / 32);
  quant_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), codes, static_cast<float*>(scale),
      static_cast<const float*>(mids), (int64_t)n, block, n_blocks, n_mids);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qt_quantize_blockwise_f32(const void* x, void* codes, void* scale,
                                         const void* mids, long long n, int block,
                                         int n_blocks, int n_mids, void* stream) {
  return launch<float>(x, codes, scale, mids, n, block, n_blocks, n_mids, stream);
}

extern "C" int qt_quantize_blockwise_bf16(const void* x, void* codes, void* scale,
                                          const void* mids, long long n, int block,
                                          int n_blocks, int n_mids, void* stream) {
  return launch<__nv_bfloat16>(x, codes, scale, mids, n, block, n_blocks, n_mids, stream);
}
