// The launch side shared by the dequant-matmuls of matmul_8bit.cu,
// matmul_4bit.cu and int4c.cu on Hopper (sm_90a): their two designs, the K
// split over a thread block cluster and its fixed-order sum (f32 partials,
// or int32 ones for int4c), and the mma.sync products of the decode
// designs (bf16 m16n8k16; s8 m16n8k32 for int4c). The f32 routes of
// matmul_4bit.cu and matmul_8bit.cu (fma_sm90.cuh) use the same split,
// plans and sum, with FMAs in place of the tensor cores.
//
// Each kernel picks one of two designs by M inside one entry point:
//   - decode (design 0): a block takes 8 MT rows of x (MT n8 tiles) and 64
//     columns of W; mma.sync (m16n8k16 bf16, m16n8k32 s8) with W^T as A
//     and x^T as the n8 operand;
//   - prefill (design 1): a block takes a tile of 128 or 256 rows of x and
//     128 columns of W; wgmma.
// Where the tile grid leaves SMs idle, K is split over a cluster of S
// blocks (MmPlan): rank r takes a contiguous run of K, and the
// partials are summed through distributed shared memory in rank, then
// slab order (cluster_sum): no atomics, no workspace, the same bits
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

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// The partial tiles of the cluster's blocks (T: f32 or int32), `slabs` of
// them per block (rows x cols, stride ld, slab after slab), summed in rank
// then slab order, 4 columns at a time; store(m, n, sum) takes the 4 sums
// of out[m, n..n+4) (rows past M are dropped here, columns past N are the
// store's to drop). Rank r sums and stores rows [r * rows / S, (r + 1) *
// rows / S). Call after every block's partials are in its shared memory
// (cluster.sync).
template <typename T, typename Store>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, T* red, int slabs,
                                            int rows, int cols, int ld, int m0, int n0, int M,
                                            int tid, int nt, Store store) {
  using V = typename Vec4<T>::type;
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int r_lo = rank * rows / S, r_hi = (rank + 1) * rows / S, c4 = cols / 4;
  for (int i = tid; i < (r_hi - r_lo) * c4; i += nt) {
    const int row = r_lo + i / c4, col = (i % c4) * 4;
    // unrolled to the largest cluster, so the remote loads issue together
    V sum = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= S) continue;
      const T* rem = cluster.map_shared_rank(red, q) + row * ld + col;
      for (int s = 0; s < slabs; ++s) {
        const V x = *reinterpret_cast<const V*>(rem + s * rows * ld);
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
    if (m0 + row < M) store(m0 + row, n0 + col, sum);
  }
}

// cluster_sum of f32 partials stored as bf16 at out[m0.., n0..] (N columns).
__device__ __forceinline__ void cluster_sum_store(cg::cluster_group& cluster, float* red,
                                                  int slabs, int rows, int cols, int ld,
                                                  __nv_bfloat16* __restrict__ out, int m0,
                                                  int n0, int M, int N, int tid, int nt) {
  cluster_sum(cluster, red, slabs, rows, cols, ld, m0, n0, M, tid, nt,
              [&](int m, int n, const float4& sum) {
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
              });
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

// d (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col): a0/a2 hold
// row g = lane / 4, a1/a3 row g + 8, each 4 values of k (a0, a1: k 4 t ..
// 4 t + 3, a2, a3: 16 + 4 t .., t = lane % 4); b0, b1 the k of a0 and a2
// for column g; d0, d1 row g, columns 2 t, 2 t + 1, d2, d3 row g + 8
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------- plans

// The kernel of a call: design 0 (decode) or 1 (prefill), its
// template (MT for decode, the tile's rows for prefill), and the rows of x
// and columns of W a block takes.
struct MmKind {
  int design, tmpl, rows, cols;
};

// How a call launches: its kernel, the K split and the grid (S, column
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

// The K split of a design bound by its operations (the f32 prefill,
// fma_sm90.cuh): the power of two up to 8 (and `max_split`) that gives the
// SM with the most work the least time, ceil(tiles s / sms) / s tiles' time,
// 9/8 of that where no SM gets a second block (whose warps would fill the
// first's waits at its barrier), the smaller split on a tie. 144 tiles on
// 132 SMs: 2 tiles' time unsplit, 1.25 split in 4; 48: 0.56 split in 2, 0.5
// in 4.
int pick_split_waves(int64_t tiles, int64_t sms, int max_split) {
  int best = 1;
  double best_t = 0.0;
  for (int s = 1; s <= 8 && s <= max_split; s *= 2) {
    const double t = (double)((tiles * s + sms - 1) / sms) / s * (tiles * s <= sms ? 1.125 : 1.0);
    if (s == 1 || t < best_t) {
      best = s;
      best_t = t;
    }
  }
  return best;
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
