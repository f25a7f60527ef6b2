// Blockwise quantize for Hopper (sm_90a), and the int8 KV-cache write that
// quantizes K and V straight into the paged pool.
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
// value) and, at the sizes of a serving step (a window's K is 720 KB of
// bf16), the launch. Its production caller is the int8 KV cache, whose
// block is one head_dim vector (64 or 128 values). Design: a group of
// block / 8 lanes owns one block, 8 values a lane, so a warp takes 4
// vectors of 64 (2 of 128); 16-byte loads, the absmax a shuffle over the
// group's lanes (3 steps at 64), the values kept in registers between the
// two passes, 8-byte code stores. A block that is not 8 times a power of
// two up to 256 takes the first port's layout: one warp per block, lanes
// striding over it with scalar accesses. The codebook search is a compare
// chain over the midpoints, which the wrapper hands over as a device array.
//
// The KV write (qt_kv_write_int8_*) quantizes K and V (L, R, nkv, hd) in
// one launch into rows of the int8 pool: vector (l, r, h) lands in codes
// (l, rows[r], h, :) and scale (l, rows[r], h) of a pool (L, pool_rows,
// nkv, hd) / (L, pool_rows, nkv). Where several r name one row (the null
// page that inactive slots and bucket padding write), the row ends up
// with one of them, or a mix: attention never reads it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps a CUDA block
constexpr int PER_LANE = 8;   // values a lane in the grouped layout
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 values from index j on, 0 at and past lim: one or two 16-byte loads
// where `vec` (x 16-byte aligned, blocks a multiple of 8 values)
__device__ __forceinline__ void load8(const float* x, int64_t j, int64_t lim, bool vec,
                                      float (&v)[PER_LANE]) {
  if (vec && j + PER_LANE <= lim) {
    const float4 a = *reinterpret_cast<const float4*>(x + j);
    const float4 b = *reinterpret_cast<const float4*>(x + j + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) v[i] = j + i < lim ? x[j + i] : 0.f;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, int64_t j, int64_t lim, bool vec,
                                      float (&v)[PER_LANE]) {
  if (vec && j + PER_LANE <= lim) {
    const uint4 w = *reinterpret_cast<const uint4*>(x + j);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) v[i] = j + i < lim ? __bfloat162float(x[j + i]) : 0.f;
}

// max over the 2^lg lanes of a group (groups are aligned runs of lanes)
__device__ __forceinline__ float group_max(float a, int lg) {
  for (int off = (1 << lg) >> 1; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// one lane's 8 values of a block -> 8 codes at c (8-byte store where vec);
// returns the block's scale (the same on every lane of the group)
__device__ __forceinline__ float quantize8(const float (&v)[PER_LANE], int lg,
                                           const float* __restrict__ mids, int n_mids,
                                           uint8_t* c, bool vec) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = group_max(amax, lg);
  uint8_t q[PER_LANE];
  float s;
  if (n_mids == 0) {
    s = amax <= EPS ? 1.f : __fdiv_rn(amax, 127.f);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
      q[i] = static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r)));
    }
  } else {
    s = amax <= EPS ? 1.f : amax;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const float u = __fdiv_rn(v[i], s);
      int idx = 0;
      for (int t = 0; t < n_mids; ++t) idx += (u > __ldg(mids + t)) ? 1 : 0;
      q[i] = static_cast<uint8_t>(idx);
    }
  }
  if (vec) {
    uint2 w = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w.x |= (uint32_t)q[i] << (8 * i);
      w.y |= (uint32_t)q[4 + i] << (8 * i);
    }
    *reinterpret_cast<uint2*>(c) = w;
  } else {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) c[i] = q[i];
  }
  return s;
}

// Grouped layout: block = 8 << lg values, a group of 2^lg lanes each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_group_kernel(const T* __restrict__ x, uint8_t* __restrict__ codes,
                   float* __restrict__ scale, const float* __restrict__ mids, int64_t n, int lg,
                   int64_t n_blocks, int n_mids, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t first = ((int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * (32 >> lg);
  if (first >= n_blocks) return;  // warp-uniform: the whole warp leaves
  const int64_t b = first + (lane >> lg);
  const bool live = b < n_blocks;  // dead groups still take part in the shuffles
  const int64_t j = b * (PER_LANE << lg) + (lane & ((1 << lg) - 1)) * PER_LANE;
  float v[PER_LANE];
  load8(x, j, live ? n : 0, vec, v);
  uint8_t q_dead[PER_LANE];
  const float s = quantize8(v, lg, mids, n_mids, live ? codes + j : q_dead, live && vec);
  if (live && (lane & ((1 << lg) - 1)) == 0) scale[b] = s;
}

// First port's layout, for blocks the grouped one does not take: one warp
// per block, lanes striding over it.
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

// The int8 KV write: 2 * n_vec vectors of hd = 8 << lg values, K's then V's.
template <typename T>
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(const T* __restrict__ k, const T* __restrict__ v,
                const int64_t* __restrict__ rows, int8_t* __restrict__ k_codes,
                int8_t* __restrict__ v_codes, float* __restrict__ k_scale,
                float* __restrict__ v_scale, int n_vec, int R, int nkv, int lg,
                int64_t pool_rows, bool vec) {
  // 32-bit index arithmetic (the launcher holds 2 * n_vec below 2^31): a
  // 64-bit division by R or nkv costs several times a 32-bit one
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * (32 >> lg);
  if (first >= 2 * n_vec) return;  // warp-uniform: the whole warp leaves
  const int gv = first + (lane >> lg);
  const bool live = gv < 2 * n_vec;
  const bool is_v = gv >= n_vec;
  const int i = is_v ? gv - n_vec : gv;  // (l, r, h) of K or V
  const int hd = PER_LANE << lg;
  const int sub = (lane & ((1 << lg) - 1)) * PER_LANE;
  float x[PER_LANE];
  load8(is_v ? v : k, (int64_t)i * hd + sub, live ? (int64_t)n_vec * hd : 0, vec, x);
  int64_t dst = 0;
  if (live) {
    const int h = i % nkv, lr = i / nkv, r = lr % R, l = lr / R;
    const int64_t row = rows[r];
    if (row < 0 || row >= pool_rows) __trap();  // as index_put's bounds check
    dst = ((int64_t)l * pool_rows + row) * nkv + h;
  }
  uint8_t q_dead[PER_LANE];
  uint8_t* c = live ? reinterpret_cast<uint8_t*>(is_v ? v_codes : k_codes) + dst * hd + sub
                    : q_dead;
  const float s = quantize8(x, lg, nullptr, 0, c, live && vec);
  if (live && sub == 0) (is_v ? v_scale : k_scale)[dst] = s;
}

// log2(block / 8) where block is 8 << lg for lg in [0, 5], else -1
int group_lg(long long block) {
  for (int lg = 0; lg <= 5; ++lg)
    if (block == (PER_LANE << lg)) return lg;
  return -1;
}

bool is_aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

template <typename T>
int launch(const void* x, void* codes, void* scale, const void* mids, long long n, int block,
           int n_blocks, int n_mids, void* stream) {
  if (n <= 0 || block <= 0 || n_blocks <= 0 || n_mids < 0 || n_mids > 255 ||
      (long long)n_blocks * block < n || (n_mids > 0 && mids == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lg = group_lg(block);
  if (lg >= 0) {
    const int64_t per_cta = (THREADS / 32) * (32 >> lg);
    const bool vec = is_aligned(x, 16) && is_aligned(codes, 8);
    quant_group_kernel<T><<<(unsigned)((n_blocks + per_cta - 1) / per_cta), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(codes), static_cast<float*>(scale),
        static_cast<const float*>(mids), (int64_t)n, lg, n_blocks, n_mids, vec);
  } else {
    const int grid = (n_blocks + THREADS / 32 - 1) / (THREADS / 32);
    quant_kernel<T><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(x), codes, static_cast<float*>(scale),
        static_cast<const float*>(mids), (int64_t)n, block, n_blocks, n_mids);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kv(const void* k, const void* v, const void* rows, void* k_codes, void* v_codes,
              void* k_scale, void* v_scale, int L, int R, int nkv, int hd, long long pool_rows,
              void* stream) {
  const int lg = group_lg(hd);
  if (L <= 0 || R <= 0 || nkv <= 0 || lg < 0 || pool_rows <= 0 || !k || !v || !rows ||
      !k_codes || !v_codes || !k_scale || !v_scale)
    return (int)cudaErrorInvalidValue;
  const int64_t n_vec = (int64_t)L * R * nkv;
  if (2 * n_vec >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int64_t per_cta = (THREADS / 32) * (32 >> lg);
  const int64_t grid = (2 * n_vec + per_cta - 1) / per_cta;
  const bool vec = is_aligned(k, 16) && is_aligned(v, 16) && is_aligned(k_codes, 8) &&
                   is_aligned(v_codes, 8);
  kv_write_kernel<T><<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int64_t*>(rows),
      static_cast<int8_t*>(k_codes), static_cast<int8_t*>(v_codes),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale), (int)n_vec, R, nkv, lg,
      pool_rows, vec);
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

// K, V (L, R, nkv, hd) -> int8 pool rows: codes (L, pool_rows, nkv, hd),
// scales (L, pool_rows, nkv); rows (R,) int64 on the device
extern "C" int qt_kv_write_int8_f32(const void* k, const void* v, const void* rows,
                                    void* k_codes, void* v_codes, void* k_scale, void* v_scale,
                                    int L, int R, int nkv, int hd, long long pool_rows,
                                    void* stream) {
  return launch_kv<float>(k, v, rows, k_codes, v_codes, k_scale, v_scale, L, R, nkv, hd,
                          pool_rows, stream);
}

extern "C" int qt_kv_write_int8_bf16(const void* k, const void* v, const void* rows,
                                     void* k_codes, void* v_codes, void* k_scale, void* v_scale,
                                     int L, int R, int nkv, int hd, long long pool_rows,
                                     void* stream) {
  return launch_kv<__nv_bfloat16>(k, v, rows, k_codes, v_codes, k_scale, v_scale, L, R, nkv,
                                  hd, pool_rows, stream);
}
