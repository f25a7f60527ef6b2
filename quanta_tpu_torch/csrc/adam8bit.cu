// Fused blockwise 8-bit Adam step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/adam8bit.py:adam8bit_update
// (_adam_tile). Per quantization block of 256 elements it dequantizes the
// moments (m: int8 codes times the block scale; v: uint8 codes, 4th-root
// companded, (c/255)^4 times the block maximum), takes the Adam step
//
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g g
//   upd = -(lr / bc1) m' / (sqrt(v' / bc2) + eps)
//
// and requantizes m' and v' with fresh block scales (max|m'|/127 and
// max v', each at least 1e-12). f32 moments live only in registers.
//
// Exactness: every operation is the plain version's
// (quanta_tpu_torch/ops/adam8bit.py:adam8bit_update_reference), in its
// order and with its one rounding each: __fmul_rn/__fadd_rn keep nvcc from
// contracting a product and a sum into an FMA, __fdiv_rn/__fsqrt_rn are
// IEEE, rintf rounds half to even as torch.round does. The f32 constants
// come from the host (b1, b2, 1 - b1, 1 - b2, eps, each a double rounded
// once to f32) or are written as doubles rounded once, as Python scalars
// reach torch. Kernel and plain version agree bit for bit.
//
// What bounds it on the H100: memory. Per element it reads g (4 B) and two
// codes (2 B) and writes the update (4 B) and two codes (2 B); a 2048 x
// 5632 leaf moves 138 MB, ~41 us at 3.35 TB/s. The adapter leaves of QLoRA
// (8 to 64 blocks) are bound by the launch. Design: one block of 256
// threads (8 warps) per quantization block, one element a thread; the two
// block maxima are warp shuffles then one pass over 8 partials in shared
// memory. One launch per parameter leaf, as the reference steps each leaf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;           // quantization block == threads a block
constexpr int WARPS = BLOCK / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(BLOCK)
adam8bit_kernel(const float* __restrict__ g,        // (nb, 256)
                const int8_t* __restrict__ mc,      // (nb, 256)
                const float* __restrict__ ms,       // (nb,)
                const uint8_t* __restrict__ vc,     // (nb, 256)
                const float* __restrict__ vs,       // (nb,)
                const float* __restrict__ scalars,  // lr, bc1, bc2
                float* __restrict__ upd, int8_t* __restrict__ mco, float* __restrict__ mso,
                uint8_t* __restrict__ vco, float* __restrict__ vso,
                float b1, float b2, float c1, float c2, float eps) {
  __shared__ float red_m[WARPS], red_v[WARPS];
  const int b = blockIdx.x;
  const int64_t i = (int64_t)b * BLOCK + threadIdx.x;
  const float inv255 = static_cast<float>(1.0 / 255.0);
  const float floor_scale = static_cast<float>(1e-12);

  const float gi = g[i];
  const float m0 = __fmul_rn(static_cast<float>(mc[i]), ms[b]);
  const float vq = __fmul_rn(static_cast<float>(vc[i]), inv255);
  const float v0 = __fmul_rn(__fmul_rn(__fmul_rn(vq, vq), __fmul_rn(vq, vq)), vs[b]);
  const float m = __fadd_rn(__fmul_rn(b1, m0), __fmul_rn(c1, gi));
  const float v = __fadd_rn(__fmul_rn(b2, v0), __fmul_rn(__fmul_rn(c2, gi), gi));

  const float step = -__fdiv_rn(scalars[0], scalars[1]);
  upd[i] = __fdiv_rn(__fmul_rn(step, m), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, scalars[2])), eps));

  const float wm = warp_max(fabsf(m)), wv = warp_max(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    red_m[warp] = wm;
    red_v[warp] = wv;
  }
  __syncthreads();
  float max_m = red_m[0], max_v = red_v[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    max_m = fmaxf(max_m, red_m[w]);
    max_v = fmaxf(max_v, red_v[w]);
  }
  const float s_m = fmaxf(__fdiv_rn(max_m, 127.0f), floor_scale);
  const float s_v = fmaxf(max_v, floor_scale);
  mco[i] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(m, s_m)), -127.0f), 127.0f));
  const float comp = __fsqrt_rn(__fsqrt_rn(fminf(fmaxf(__fdiv_rn(v, s_v), 0.0f), 1.0f)));
  vco[i] = static_cast<uint8_t>(fminf(fmaxf(rintf(__fmul_rn(comp, 255.0f)), 0.0f), 255.0f));
  if (threadIdx.x == 0) {
    mso[b] = s_m;
    vso[b] = s_v;
  }
}

}  // namespace

extern "C" int qt_adam8bit_update(const void* g, const void* m_codes, const void* m_scale,
                                  const void* v_codes, const void* v_scale, const void* scalars,
                                  void* upd, void* m_codes_out, void* m_scale_out,
                                  void* v_codes_out, void* v_scale_out, int n_blocks, float b1,
                                  float b2, float c1, float c2, float eps, void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  adam8bit_kernel<<<n_blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int8_t*>(m_codes),
      static_cast<const float*>(m_scale), static_cast<const uint8_t*>(v_codes),
      static_cast<const float*>(v_scale), static_cast<const float*>(scalars),
      static_cast<float*>(upd), static_cast<int8_t*>(m_codes_out),
      static_cast<float*>(m_scale_out), static_cast<uint8_t*>(v_codes_out),
      static_cast<float*>(v_scale_out), b1, b2, c1, c2, eps);
  return (int)cudaGetLastError();
}
