// Pieces shared by the int8-tensor-core GEMMs of int4c.cu and int8mm.cu
// (Hopper, sm_90a): the 4 x 4 byte transpose that turns N-contiguous weight
// codes into the K-contiguous words both products read, and the epilogue
// that scales an exact int32 sum by a row and a column scale (and adds an
// f32 partial) in the plain versions' rounding order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// r[i] holds bytes (c = 0..3) of row i; w[c] gets byte c of rows 0..3, row
// i in byte i.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&w)[4]) {
  const uint32_t a0 = __byte_perm(r[0], r[1], 0x5140), a1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t b0 = __byte_perm(r[2], r[3], 0x5140), b1 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(a0, b0, 0x5410);
  w[1] = __byte_perm(a0, b0, 0x7632);
  w[2] = __byte_perm(a1, b1, 0x5410);
  w[3] = __byte_perm(a1, b1, 0x7632);
}

// out[m, n..n+4) = f32(acc) * row_scale[m] * col_scale[n..] (+ y[m, n..]),
// each step rounded on its own (__fmul_rn, __fadd_rn: no FMA), in that
// order; y (M, N) f32 or null; columns past N dropped.
__device__ __forceinline__ void store_scaled(float* __restrict__ out, int m, int n,
                                             const int4& acc, const float* __restrict__ rs,
                                             const float* __restrict__ cs, int N,
                                             const float* __restrict__ y = nullptr) {
  const float r = __ldg(rs + m);
  const int a[4] = {acc.x, acc.y, acc.z, acc.w};
  const bool vec = (N & 3) == 0 && n + 4 <= N;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = n + j < N ? __fmul_rn(__fmul_rn(__int2float_rn(a[j]), r), __ldg(cs + n + j)) : 0.0f;
  if (y != nullptr) {
    const float* yr = y + (int64_t)m * N + n;
    if (vec) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(yr));
      v[0] = __fadd_rn(v[0], b.x);
      v[1] = __fadd_rn(v[1], b.y);
      v[2] = __fadd_rn(v[2], b.z);
      v[3] = __fadd_rn(v[3], b.w);
    } else {
      for (int j = 0; j < 4 && n + j < N; ++j) v[j] = __fadd_rn(v[j], __ldg(yr + j));
    }
  }
  float* o = out + (int64_t)m * N + n;
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && n + j < N; ++j) o[j] = v[j];
  }
}

}  // namespace
