// The launch side shared by the bf16 dequant-matmuls of matmul_8bit.cu and
// matmul_4bit.cu on Hopper (sm_90a): their two designs, the K split over a
// thread block cluster and its fixed-order sum, and the mma.sync product
// of the decode design.
//
// Both kernels pick one of two designs by M inside one entry point:
//   - decode (design 0): a block takes 8 MT rows of x (MT n8 tiles) and 64
//     columns of W; mma.sync m16n8k16 with W^T as A and x^T as the n8
//     operand;
//   - prefill (design 1): a block takes a tile of 128 or 256 rows of x and
//     128 columns of W; wgmma.
// Where the tile grid leaves SMs idle, K is split over a cluster of S
// blocks (MmPlan): rank r takes a contiguous run of K, and the f32
// partials are summed through distributed shared memory in rank, then
// slab order (cluster_sum_store): no atomics, no workspace, the same bits
// on every call.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

// ---------------------------------------------- split-K sum in a cluster

// The f32 partial tiles of the cluster's blocks, `slabs` of them per block
// (rows x cols, stride ld, slab after slab), summed in rank then slab order
// and stored as bf16 at out[m0.., n0..] (rows past M, columns past N
// dropped). Rank r sums and stores rows [r * rows / S, (r + 1) * rows / S).
// Call after every block's partials are in its shared memory (cluster.sync).
__device__ __forceinline__ void cluster_sum_store(cg::cluster_group& cluster, float* red,
                                                  int slabs, int rows, int cols, int ld,
                                                  __nv_bfloat16* __restrict__ out, int m0,
                                                  int n0, int M, int N, int tid, int nt) {
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int r_lo = rank * rows / S, r_hi = (rank + 1) * rows / S, c4 = cols / 4;
  for (int i = tid; i < (r_hi - r_lo) * c4; i += nt) {
    const int row = r_lo + i / c4, col = (i % c4) * 4;
    const int m = m0 + row, n = n0 + col;
    // unrolled to the largest cluster, so the remote loads issue together
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= S) continue;
      const float* rem = cluster.map_shared_rank(red, q) + row * ld + col;
      for (int s = 0; s < slabs; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(rem + s * rows * ld);
        if (q == 0 && s == 0) {
          sum = x;
        } else {
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
      }
    }
    if (m >= M) continue;
    __nv_bfloat16* o = out + (int64_t)m * N + n;
    if ((N & 3) == 0 && n + 4 <= N) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = v;
    } else {
      const float e[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int j = 0; j < 4 && n + j < N; ++j) o[j] = __float2bfloat16_rn(e[j]);
    }
  }
}

// ------------------------------------------------- mma.sync (decode)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------- plans

// The kernel of a bf16 call: design 0 (decode) or 1 (prefill), its
// template (MT for decode, the tile's rows for prefill), and the rows of x
// and columns of W a block takes.
struct MmKind {
  int design, tmpl, rows, cols;
};

// How a bf16 call launches: its kernel, the K split and the grid (S, column
// tiles, row tiles), clusters of S along x.
struct MmPlan {
  MmKind kind;
  int split;
  dim3 grid;
};

// The K split: the largest power of two up to 8 (and `max_split`) that
// keeps the tiles' blocks within `slots`, one wave of resident blocks.
int pick_split(int64_t tiles, int64_t slots, int max_split) {
  int s = 1;
  while (s < 8 && 2 * s <= max_split && tiles * 2 * s <= slots) s *= 2;
  return s;
}

// The plan of kind `k` at (M, N): `resident` is the blocks of its kernel an
// SM holds, `max_split` the most splits K allows.
MmPlan plan_split(const MmKind& k, int M, int N, int max_split, int resident) {
  const int tn = (N + k.cols - 1) / k.cols, tm = (M + k.rows - 1) / k.rows;
  const int s = pick_split((int64_t)tn * tm, (int64_t)resident * sm_count(), max_split);
  return {k, s, dim3(s, tn, tm)};
}

// A plan's launch, for a report: out[11] = design (0 decode, 1 prefill),
// grid x, y, z, cluster size (the K split), blocks resident per SM,
// registers a thread, dynamic shared bytes, local (spill) bytes a thread,
// cp.async stages, rows of x a block.
template <typename Kernel>
int report_plan(const MmPlan& p, Kernel kernel, size_t smem, int resident, int stages,
                int* out) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  const int vals[11] = {p.kind.design, (int)p.grid.x, (int)p.grid.y, (int)p.grid.z, p.split,
                        resident, attr.numRegs, (int)smem, (int)attr.localSizeBytes, stages,
                        p.kind.rows};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return (int)rc;
}

}  // namespace
