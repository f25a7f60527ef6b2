// Transposed fused 8-bit matmul for Hopper (sm_90a): the backward dx of
// x @ deq(W), bf16 or f32 gradients.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_8bit_t
// (_mm8t_kernel). It computes, with W still 8-bit in device memory,
//
//   dx[m, k] = sum_n g[m, n] * T(levels[code[k, n]] * scale[k / block, n])
//
// for g (M, N) and 8-bit codes (K, N) (int8, nf8, fp8 or int8a, through one
// 256-entry level table: dequant8_sm90.cuh). deq is the forward's: one f32
// multiply rounded once, then rounded to the gradient type T before the
// product, as the TPU kernel rounds `w.astype(g.dtype)`; sums are f32.
// int8a's zero-point term of W^T, repeat(g @ zp^T), is added by the wrapper
// outside the kernel, as the JAX package adds it. Rows of g, columns of N
// and rows of W past the edges are masked.
//
// What bounds it on the H100: in QLoRA training M is batch x sequence
// (2048 for batch 4 x seq 512), so the product is bound by compute, 2*M*K*N
// flops against the bf16 tensor-core rate (989 TFLOP/s).
//
// bf16 design (matmul_8bit.cu's prefill, read the other way): a block
// takes BM rows of g by 128 dx columns (128 rows of W) and streams N in
// steps of 64 through a cp.async ring of T_STAGES slots, each holding the
// step's g tile (BM / 64 K-major Tile<64>s, rows = M) and the raw code
// slab of W rows [j0, j0 + 128) over the step's 64 columns with its two
// scale rows (block >= 64). Each step the block dequantizes the slab into
// a bf16 128-row Tile<64> (dequant8_sm90.cuh: rows = K, columns = N;
// double buffered) while the previous step's products run; read K-major,
// that tile is the B of dx = g @ W^T. Two consumer warpgroups of BM / 2
// rows then issue wgmma m64n128k16 (wgmma_ss, both operands K-major). BM is
// 256, so every dequantized weight feeds 256 rows of g as in matmul_8bit's
// 256-row prefill tile, while that grid (K / 128 x M / 256 blocks, one an
// SM) fills at least half the SMs; else 128, twice the blocks. No split of
// N: at the backward's shapes (M = 2048, K >= 2048) the grid is about a
// wave or more. The dense weight never reaches device memory.
//
// Tried on the H100 (kernel_sweep.py; PERF.md), int8 at the five TinyLlama
// (K, N), M = 2048: a first wgmma build, 128 x 64 dx tiles over
// 128-column steps of N (wgmma m64n64k16, each weight feeding 128 rows),
// took 393.0 us at (2048, 5632), 120 TFLOP/s; 256 x 128 tiles take 227.4
// (208 TFLOP/s), 128 x 128 ones 321.4. At M = 1024 the 256-row grid leaves
// half the SMs idle at K = 2048 and 128 x 128 wins (167.3 against 224.4).
//
// f32 (QLoRA on an f32 base): tf32x3_sm90.cuh's design over the 8-bit
// layout, 128 rows of g by 128 dx columns (rows of W) a block, the f32
// product run as three TF32 wgmma products (3xTF32) with each step's
// partial added on the CUDA cores, N split over a cluster where the tile
// grid is under two waves; bound by its operations, 3 x 2 M K N at
// the TF32 rate (495 TFLOP/s), a ceiling of 165 TFLOP/s of f32 work
// against the CUDA cores' 67.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant8_sm90.cuh"  // LV_BYTES, fill_levels32, stage_*, dequant_slab_t
#include "splitk_sm90.cuh"    // MmKind, MmPlan, report_plan
#include "tf32x3_sm90.cuh"    // the f32 route: launch_mmt_tf32x3, report_mmt_tf32x3

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16: wgmma

constexpr int T_STAGES = 3;     // the ring reloads a slot two steps after its products
constexpr int T_THREADS = 256;  // two consumer warpgroups, BM / 2 rows of g each
constexpr int T_BJ = 128;       // dx columns a block: 128 rows of W
constexpr int T_BN = 64;        // columns of N (the reduction) a step

// level table; STAGES x (BM / 64) g tiles; 2 W tiles; STAGES x (code slab, 2 scale rows)
template <int BM> struct TSmem {
  static_assert(BM == 128 || BM == 256, "128 or 256 rows a tile");
  static constexpr uint32_t GT = Tile<64>::BYTES, WT = 2 * Tile<64>::BYTES;
  static constexpr uint32_t SROW = T_BJ * T_BN, SLAB = SROW + 2 * T_BN * 4;
  static constexpr uint32_t G0 = LV_BYTES;                   // 1024-aligned from the base
  static constexpr uint32_t W0 = G0 + T_STAGES * (BM / 64) * GT;
  static constexpr uint32_t C0 = W0 + 2 * WT;
  static constexpr size_t bytes = C0 + T_STAGES * SLAB + 1024;
};

// grid (K / 128, M / BM). Step t stages g[m0:m0+BM, 64 t:64 t+64] as BM / 64
// K-major Tile<64>s (rows = M, columns = N) and the code slab of W rows
// [j0, j0 + 128) over the same columns, which dequant_slab_t turns into a
// 128-row Tile<64> (rows = K, columns = N): the K-major B of dx = g W^T
// (B[n][k] = W[k][n]). Warpgroup wg multiplies its BM / 128 g tiles by it:
// 4 BM / 128 m64n128k16 products a step.
template <int BM>
__global__ void __launch_bounds__(T_THREADS)
mm8t_wgmma(const bf16* __restrict__ g, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ levels,
           bf16* __restrict__ out, int M, int N, int K, int block) {
  using SM = TSmem<BM>;
  constexpr int MT = BM / 128;  // 64-row g tiles a warpgroup
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  float* lv = reinterpret_cast<float*>(gbase);
  auto Gs = [&](int st, int i) { return base + SM::G0 + ((BM / 64) * st + i) * SM::GT; };
  auto Ws = [&](int i) { return base + SM::W0 + i * SM::WT; };
  auto slab = [&](int st) { return gbase + SM::C0 + st * SM::SLAB; };
  // a block of 64 rows or more: each 64-row half of the slab has one scale row
  const bool one_srow = block % 64 == 0;
  auto srow = [&](int st) { return reinterpret_cast<float*>(slab(st) + SM::SROW); };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int j0 = blockIdx.x * T_BJ, m0 = blockIdx.y * BM;
  const int steps = (N + T_BN - 1) / T_BN;
  fill_levels32<T_THREADS>(lv, levels, tid);

  auto load = [&](int t, int st) {  // step t into slot st
    const int n0 = t * T_BN;
    for (int i = tid; i < BM * 8; i += T_THREADS) {  // g rows [m0, m0 + BM), 8 chunks a row
      const int r = i / 8, c = i % 8;
      const uint32_t dst = Gs(st, r / 64) + Tile<64>::offset(r % 64, c);
      stage_bf16x8(gbase + (dst - base), dst, g, m0 + r, n0 + 8 * c, M, N);
    }
    stage_code_slab_t(slab(st), smem_addr(slab(st)), codes, j0, n0, K, N, tid, T_THREADS);
    // threads 0-15 the scale row of rows j0.., 16-31 that of rows j0 + 64..
    // (none past K: those rows reach only dx columns the store drops)
    if (one_srow && tid < 32 && j0 + 64 * (tid / 16) < K) {
      float* dst = srow(st) + 64 * (tid / 16);
      stage_scale_row(dst, smem_addr(dst), scales, (j0 + 64 * (tid / 16)) / block, n0, N,
                      T_BN / 4, tid % 16);
    }
  };
#pragma unroll
  for (int st = 0; st < T_STAGES - 2; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }

  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<T_STAGES - 3>();  // step t has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the products of t - 2 are done (and the level table is in)
    if (t + T_STAGES - 2 < steps) load(t + T_STAGES - 2, (t + T_STAGES - 2) % T_STAGES);
    cp_async_commit();
    // W tile t % 2 was last read by the products of t - 2
    dequant_slab_t<T_THREADS>(Ws(t % 2), slab(t % T_STAGES),
                              one_srow ? srow(t % T_STAGES) : nullptr, scales, lv, j0, t * T_BN,
                              K, N, block, tid);
    fence_proxy_async();
    __syncthreads();  // the W tile is whole
    const uint32_t wt = Ws(t % 2);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t gt = Gs(t % T_STAGES, wg * MT + mt);
#pragma unroll
      for (int kk = 0; kk < T_BN / 16; ++kk)
        wgmma_ss<128>(acc[mt], Tile<64>::k_major(gt, kk), Tile<64>::k_major(wt, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of t - 1 are done; those of t run on
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
  cp_async_wait<0>();

  // accumulator mt: dx row m0 + 64 (MT wg + mt) + 16 warp + lane / 4 + 8 i,
  // column j0 + 8 j + 2 (lane % 4) + c in acc[mt][4 j + 2 i + c]
  const int r_lo = 64 * MT * wg + 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + r_lo + 64 * mt + 8 * i;
      if (m >= M) continue;
      bf16* o = out + (int64_t)m * K + j0 + c_lo;
#pragma unroll
      for (int j = 0; j < T_BJ / 8; ++j) {
        const int k = j0 + 8 * j + c_lo;
        const float v0 = acc[mt][4 * j + 2 * i], v1 = acc[mt][4 * j + 2 * i + 1];
        if ((K & 1) == 0 && k + 2 <= K) {
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (k < K) o[8 * j] = __float2bfloat16_rn(v0);
          if (k + 1 < K) o[8 * j + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// The bf16 launch at (M, K): 256-row tiles while their grid fills at least
// half the SMs (one block an SM), else 128-row ones, twice the blocks.
MmPlan plan_mm8t(int M, int K) {
  const int tj = (K + T_BJ - 1) / T_BJ;
  const int bm = 2 * tj * ((M + 255) / 256) >= sm_count() ? 256 : 128;
  return {{0, bm, bm, T_BJ}, 1, dim3(tj, (M + bm - 1) / bm, 1)};
}

template <typename F> auto with_kernel(const MmPlan& p, F f) {
  return p.kind.rows == 256 ? f(mm8t_wgmma<256>, TSmem<256>::bytes)
                            : f(mm8t_wgmma<128>, TSmem<128>::bytes);
}

}  // namespace

extern "C" int qt_matmul_8bit_t_bf16(const void* g, const void* codes, const void* scales,
                                     const void* levels, void* out, int M, int N, int K,
                                     int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm8t(M, K);
  return with_kernel(p, [&](auto kernel, size_t smem) {
    return launch_cluster(kernel, p.grid, 1, T_THREADS, smem, stream,
                          static_cast<const bf16*>(g), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(scales), static_cast<const float*>(levels),
                          static_cast<bf16*>(out), M, N, K, block);
  });
}

extern "C" int qt_matmul_8bit_t_f32(const void* g, const void* codes, const void* scales,
                                    const void* levels, void* out, int M, int N, int K,
                                    int block, void* stream) {
  return launch_mmt_tf32x3<8>(g, codes, scales, levels, out, M, N, K, block, stream);
}

// The bf16 route's launch at (M, N, K), for a report (report_plan says what
// out[11] holds; design 0, the one wgmma design, no split)
extern "C" int qt_matmul_8bit_t_design(int M, int N, int K, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm8t(M, K);
  return with_kernel(p, [&](auto kernel, size_t smem) {
    return report_plan(p, kernel, smem, blocks_per_sm(kernel, smem, T_THREADS), T_STAGES, out);
  });
}

// The f32 route's launch at (M, N, K), for a report (design 0, the one
// 3xTF32 design, no split)
extern "C" int qt_matmul_8bit_t_f32_design(int M, int N, int K, int* out) {
  return report_mmt_tf32x3<8>(M, N, K, out);
}
