// The f32 route of the transposed fused dequant-matmuls on Hopper (sm_90a):
// the one design of matmul_4bit_t.cu's and matmul_8bit_t.cu's f32 entry
// points, one template over the weight layout (BITS, Codes<BITS> in
// dequant4_sm90.cuh).
//
//   dx[m, j] = sum_n g[m, n] * w[j, n],  w = levels[code] * scale
//
// g and dx f32; w one f32 multiply rounded once (__fmul_rn), as the plain
// versions' `lv[idx] * s` gives it. 4-bit: packed row p gives dx columns p
// (low nibble) and K2 + p (high nibble); 8-bit: row j is dx column j. Rows
// of g, columns of N and packed rows past the edges are masked; any block
// that divides the rows of K.
//
// What bounds it on the H100: dx has M = batch x sequence rows on every
// training path (2048 for TinyLlama-1.1B at batch 4 x seq 512), so the
// product is bound by its operations, 2 M K N. On the CUDA cores that is 67
// TFLOP/s of f32 FMAs; cuBLAS's f32 GEMM runs ~49 and the port's best FMA
// GEMM (fma_sm90.cuh) 34-37, so no FMA design beats the plain version
// (dequantize, then cuBLAS) at these shapes. The tensor cores multiply
// TF32 (10 fraction bits) at 495 TFLOP/s, so the design runs the f32
// product as three TF32 ones (3xTF32): each operand x splits into hi =
// tf32(x) and lo = tf32(x - hi), x = hi + lo to ~22 bits, and
//
//   g w ~ g_lo w_hi + g_hi w_lo + g_hi w_hi
//
// (the dropped g_lo w_lo is ~2^-22 of g w), a ceiling of 495 / 3 = 165
// TFLOP/s. The tensor cores add their products with truncation; over a
// reduction of N = 32000 (the head's dx) that bias alone would pass 1e-5
// of max|dx|. So each step's products go into a fresh partial accumulator
// (12 wgmmas over 32 columns of N) that the CUDA cores add to the running
// sum, rounded to nearest: the truncated chain is 12 products long
// whatever N is.
//
// Design (the bf16 dx designs' structure, matmul_4bit_t.cu's mm4t_wgmma):
// a block takes X3_BM = 128 rows of g by 128 dx columns (4-bit: 64 packed
// rows, both nibble runs; 8-bit: 128 rows of W) and streams N in steps of
// X3_BN = 32 columns, one 128-byte swizzled row of f32, through a cp.async
// ring of X3_STAGES slots: the step's g tile (two Tile<64>s of 64 rows x
// 32 f32), the raw code slab and its four scale rows (one per 32 dx
// columns; a block and, for 4-bit, K2 multiples of 32, else each weight
// reads its own scale from device memory). Two consumer warpgroups of 64
// rows of g each read their g fragments of the step from the staged tile
// into registers, split them there (g is each warpgroup's own operand, W
// the shared one, which the tensor cores read from shared memory), and
// issue wgmma m64n128k8 .tf32 with A in registers and B, the W tile read
// K-major, from shared memory: 3 x 4 products a step. While they run, the
// block dequantizes the next step's slab into an f32 W tile (128 rows = dx
// columns, 32 columns = N), split into a TF32 hi and lo tile (double
// buffered), and issues the loads of the step STAGES - 1 ahead; the step
// ends with the partial's add, the wait for the loads two steps ahead and
// one barrier. Where the tile grid is under two waves of the SMs (GPT-2
// small's dx at M = 1024: 64 tiles), N is split over a cluster of up to 8
// blocks (pick_split_waves, splitk_sm90.cuh), each at least X3_SPLIT_STEPS
// steps, and the partial tiles are summed through distributed shared
// memory in rank order (cluster_sum): no atomics, the same bits on every
// call. The dense weight never reaches device memory.
//
// Tried on the H100 (variants of this file timed at TinyLlama-1.1B's
// (2048, 2048) and (2048, 5632), M = 2048, nf4a and int8; PERF.md):
// one TF32 product a slice in place of three (timing only) takes 22% off,
// no per-step dequantize 16%, no g loads 18%, no loads at all 29%, no
// partial add 3%: the step's work outside the products, not the tensor
// cores, bounds the design (a step costs ~2.2 us against ~0.8 us of TF32
// products). A ring of 4 or 5 slots takes 2-5% off 3; starting the next
// step's dequantize right after the products are issued, and waiting for
// the loads at the step's end, 3-7% more; loads issued after the proxy
// fence change nothing. A warp-specialized form (a producer warpgroup
// loading and dequantizing, two consumer warpgroups, handed over through
// mbarriers, setmaxnreg 72 / 216) gave the same bits 6-19% slower, its
// producer short of issue slots; A from shared memory (g split into hi /
// lo tiles there, wgmma_ss) 6-12% slower; one warpgroup of 64 rows a
// block, two blocks an SM (4-bit; 8-bit's 32 KB level table leaves room
// for one), 1-8% slower where the grid is full. Where the tiles are under
// two waves, the split of N takes GPT-2's (768, 2304) dx at M = 1024 from
// 162 to 133 us.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant4_sm90.cuh"  // Codes, fill_levels_f32, level, scale_at, stage_codes16, ...
#include "splitk_sm90.cuh"    // MmKind, MmPlan, report_plan

namespace {

constexpr int X3_THREADS = 256;  // two consumer warpgroups, 64 rows of g each
constexpr int X3_BM = 128;       // rows of g a block
constexpr int X3_BJ = 128;       // dx columns a block
constexpr int X3_BN = 32;        // columns of N a step: one 128-byte row of f32
constexpr int X3_STAGES = 4;     // g tiles and code slabs land two steps ahead of their products
constexpr int X3_SPLIT_STEPS = 8;  // the least steps of N a split of N leaves a block
constexpr int X3_RED_LD = X3_BJ + 4;  // floats of a row of the partial tile a split sums

// level table; STAGES x g tile; 2 x (W hi, W lo); STAGES x (code slab, 4 scale rows)
template <int BITS> struct X3Smem {
  static constexpr int RUNS = Codes<BITS>::RUNS, PR = X3_BJ / RUNS;  // packed rows a block
  static constexpr uint32_t T = 2 * Tile<64>::BYTES;  // 128 rows x 32 f32: g's or W's
  static constexpr uint32_t CODES = PR * X3_BN, SLOT = CODES + 4 * X3_BN * 4;
  static constexpr uint32_t G0 = LV_F32_BYTES<BITS>;  // 1024-aligned from the base
  static constexpr uint32_t WH0 = G0 + X3_STAGES * T, WL0 = WH0 + 2 * T;
  static constexpr uint32_t C0 = WL0 + 2 * T;
  static constexpr size_t bytes = C0 + X3_STAGES * SLOT + 1024;
};

// g[m, n .. n + 4) of g (M, N) into shared memory: one 16-byte cp.async
// where the 4 values are in range and aligned, else 4-byte ones; zeros past
// M and N.
__device__ __forceinline__ void stage_g4(uint32_t dst, const float* __restrict__ g, int m, int n,
                                         int M, int N) {
  const float* src = g + (int64_t)m * N + n;
  if (m >= M || n >= N) {
    cp_async16(dst, g, 0);
  } else if ((N & 3) == 0) {
    cp_async16(dst, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + 4 * e, n + e < N ? src + e : g, n + e < N ? 4 : 0);
  }
}

// The dx columns of tile columns [tc, tc + k) in row m: j0 + tc (8-bit, and
// 4-bit's low nibbles, tc < 64) or R + j0 + tc - 64 (4-bit's high
// nibbles); packed rows past R are dropped. dx rows hold RUNS R values.
template <int PR> struct StoreDx {
  float* out;
  int R, j0;
  __device__ __forceinline__ float* at(int m, int tc, int& jp) const {
    jp = j0 + tc % PR;
    return out + (int64_t)m * (X3_BJ / PR) * R + (int64_t)(tc / PR) * R + jp;
  }
  // two columns, tc even: one 8-byte store where both are in and aligned
  __device__ __forceinline__ void pair(int m, int tc, float v0, float v1) const {
    int jp;
    float* o = at(m, tc, jp);
    if ((R & 1) == 0 && jp + 2 <= R) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (jp < R) o[0] = v0;
      if (jp + 1 < R) o[1] = v1;
    }
  }
  // four columns, tc a multiple of 4: cluster_sum's store
  __device__ __forceinline__ void operator()(int m, int tc, const float4& v) const {
    int jp;
    float* o = at(m, tc, jp);
    if ((R & 3) == 0 && jp + 4 <= R) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int c = 0; c < 4 && jp + c < R; ++c) o[c] = e[c];
    }
  }
};

// grid (S, packed rows / PR, M / 128), clusters of S along x: rank r takes
// the steps [r * per, (r + 1) * per) of N, per = ceil(steps / S), and the
// partial tiles are summed in rank order (cluster_sum). Step t stages
// g[m0:m0+128, 32 t:32 t+32] (rows = M, columns = N) and the code slab of
// packed rows [j0, j0 + PR) over the same columns, which the block turns
// into the W hi and lo tiles of 128 rows (rows = dx columns, columns = N):
// the K-major B of dx = g W^T.
template <int BITS>
__global__ void __launch_bounds__(X3_THREADS, 1)
mmt_tf32x3(const float* __restrict__ g, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ levels,
           float* __restrict__ out, int M, int N, int R, int block) {
  using C = Codes<BITS>;
  using SM = X3Smem<BITS>;
  constexpr int RUNS = C::RUNS, PR = SM::PR;
  constexpr int CB = PR * X3_BN / X3_THREADS;  // code bytes a thread dequantizes a step
  constexpr int QR = 4 / RUNS;                 // scale rows a run: one per 32 dx columns
  static_assert(CB % 4 == 0 && X3_BN % CB == 0, "whole code words, whole rows");
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  float* lv = reinterpret_cast<float*>(gbase);
  auto gs = [&](int st) { return base + SM::G0 + st * SM::T; };
  auto wh = [&](int b) { return base + SM::WH0 + b * SM::T; };
  auto wl = [&](int b) { return base + SM::WL0 + b * SM::T; };
  auto slot = [&](int st) { return gbase + SM::C0 + st * SM::SLOT; };
  auto srow = [&](int st) { return reinterpret_cast<float*>(slot(st) + SM::CODES); };
  // every 32 dx columns of the tile within one block of K: their scale rows staged
  const bool staged = block % 32 == 0 && (RUNS == 1 || R % 32 == 0);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int j0 = blockIdx.y * PR, m0 = blockIdx.z * X3_BM;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int steps = (N + X3_BN - 1) / X3_BN, per = (steps + S - 1) / S;
  const int t_lo = min(steps, rank * per), n_t = min(steps, t_lo + per) - t_lo;
  fill_levels_f32<BITS, X3_THREADS>(lv, levels, tid);

  auto load = [&](int t, int st) {  // step t into slot st
    const int n0 = t * X3_BN;
    for (int i = tid; i < X3_BM * 8; i += X3_THREADS) {  // g rows [m0, m0 + 128), 8 chunks a row
      const int r = i / 8, c = i % 8;
      stage_g4(gs(st) + (r / 64) * Tile<64>::BYTES + Tile<64>::offset(r % 64, c), g, m0 + r,
               n0 + 4 * c, M, N);
    }
    unsigned char* sl = slot(st);
    const uint32_t sl_s = smem_addr(sl);
    for (int i = tid; i < PR * (X3_BN / 16); i += X3_THREADS) {  // PR rows of 32 code bytes
      const int r = i / (X3_BN / 16), c = (i % (X3_BN / 16)) * 16;
      stage_codes16(sl + r * X3_BN + c, sl_s + r * X3_BN + c, codes, j0 + r, n0 + c, R, N);
    }
    // threads 8 q .. 8 q + 7 the scale row of tile rows 32 q ..: run q / QR,
    // packed rows j0 + 32 (q % QR) .. (none past R: those rows reach only
    // dx columns the store drops)
    const int q = tid / 8, p = j0 + 32 * (q % QR);
    if (staged && tid < 32 && p < R) {
      float* dst = srow(st) + q * X3_BN;
      stage_scale_row(dst, smem_addr(dst), scales, ((q / QR) * R + p) / block, n0, N, X3_BN / 4,
                      tid % 8);
    }
  };

  // Step t's slab (slot st) into W tiles b: thread tid takes CB code bytes
  // of packed row pr, columns c0.., and writes the hi and lo parts of their
  // RUNS x CB weights (tile row h PR + pr for run h). Columns past N read
  // zero scales, so those weights are 0, as g is there.
  auto dequant = [&](int t, int st, int b) {
    const unsigned char* sl = slot(st);
    const int pr = tid / (X3_BN / CB), c0 = (tid % (X3_BN / CB)) * CB, n = t * X3_BN + c0;
    uint32_t words[CB / 4];  // code byte e in bits 8 (e % 4) of word e / 4
#pragma unroll
    for (int i = 0; i < CB / 4; ++i)
      words[i] = reinterpret_cast<const uint32_t*>(sl + pr * X3_BN + c0)[i];
#pragma unroll
    for (int h = 0; h < RUNS; ++h) {
      const int tr = h * PR + pr;  // tile row: dx column
      float s[CB];
      if (staged) {
        const float* sr = srow(st) + (tr / 32) * X3_BN + c0;
#pragma unroll
        for (int e = 0; e < CB; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sr + e);
          s[e] = v.x; s[e + 1] = v.y; s[e + 2] = v.z; s[e + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < CB; ++e) s[e] = scale_at(scales, h, j0 + pr, n + e, R, N, block);
      }
      const uint32_t row = (tr / 64) * Tile<64>::BYTES;
#pragma unroll
      for (int e = 0; e < CB; e += 4) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint32_t byte = (words[(e + f) / 4] >> (8 * ((e + f) % 4))) & 0xFF;
          split_tf32(__fmul_rn(level(lv, C::code(byte, h), lane), s[e + f]), hi[f], lo[f]);
        }
        const uint32_t off = row + Tile<64>::offset(tr % 64, (c0 + e) / 4);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(wh(b) + off), "r"(hi[0]),
                     "r"(hi[1]), "r"(hi[2]), "r"(hi[3])
                     : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(wl(b) + off), "r"(lo[0]),
                     "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                     : "memory");
      }
    }
  };

#pragma unroll
  for (int st = 0; st < X3_STAGES - 1; ++st) {
    if (st < n_t) load(t_lo + st, st);
    cp_async_commit();
  }
  cp_async_wait<X3_STAGES - 3>();  // steps 0 and 1 have landed
  __syncthreads();                 // ... for every thread, and the level table is in
  if (n_t > 0) dequant(t_lo, 0, 0);
  fence_proxy_async();
  __syncthreads();  // W tiles 0 are whole

  // this thread's g fragment rows in its warpgroup's 64: r0 and r0 + 8
  const int r0 = 16 * warp + lane / 4, kc = lane % 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int i = 0; i < n_t; ++i) {
    const int b = i % 2;
    // g's fragments of the block's step i, split: a[kk] rows r0, r0 + 8 at
    // columns 8 kk + kc and 8 kk + kc + 4
    uint32_t ah[X3_BN / 8][4], al[X3_BN / 8][4];
    const unsigned char* gt = gbase + SM::G0 + (i % X3_STAGES) * SM::T + wg * Tile<64>::BYTES;
#pragma unroll
    for (int kk = 0; kk < X3_BN / 8; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = r0 + 8 * (f % 2), c = 2 * kk + f / 2;
        const float v = *reinterpret_cast<const float*>(gt + Tile<64>::offset(r, c) + 4 * kc);
        split_tf32(v, ah[kk][f], al[kk][f]);
      }
#pragma unroll
    for (int kk = 0; kk < X3_BN / 8; ++kk) {  // every A register written before the products
      fence_regs(reinterpret_cast<int(&)[4]>(ah[kk]));
      fence_regs(reinterpret_cast<int(&)[4]>(al[kk]));
    }
    wgmma_fence();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < X3_BN / 8; ++kk) {
      const uint64_t bh = Tile<64>::k_major(wh(b), kk), bl = Tile<64>::k_major(wl(b), kk);
      wgmma_rs_tf32<128>(part, al[kk], bh, kk > 0);  // the small terms first
      wgmma_rs_tf32<128>(part, ah[kk], bl, 1);
      wgmma_rs_tf32<128>(part, ah[kk], bh, 1);
    }
    wgmma_commit();
    // while the products run: step i + 1's slab into W tiles 1 - b (last
    // read by the products of i - 1, done), then step i + STAGES - 1's
    // loads into slot (i - 1) % STAGES (its g fragments were read at step
    // i - 1, its codes by step i - 1's dequantize)
    if (i + 1 < n_t) dequant(t_lo + i + 1, (i + 1) % X3_STAGES, 1 - b);
    fence_proxy_async();
    if (i + X3_STAGES - 1 < n_t)
      load(t_lo + i + X3_STAGES - 1, (i + X3_STAGES - 1) % X3_STAGES);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < X3_BN / 8; ++kk) {  // the registers the products read
      fence_regs(reinterpret_cast<int(&)[4]>(ah[kk]));
      fence_regs(reinterpret_cast<int(&)[4]>(al[kk]));
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
    cp_async_wait<X3_STAGES - 3>();  // step i + 2 has landed (its codes for the next dequantize)
    // W tiles 1 - b are whole, step i + 2's slot is in for every thread,
    // and both warpgroups' products of i are done
    __syncthreads();
  }
  cp_async_wait<0>();

  // acc: dx row m0 + 64 wg + r0 + 8 i, tile column 8 j + 2 kc + c in
  // acc[4 j + 2 i + c]: dx column j0 + that (8-bit, and 4-bit's low nibbles,
  // tile columns < 64) or R + j0 + that - 64 (4-bit's high nibbles)
  const StoreDx<PR> store{out, R, j0};
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 64 * wg + r0 + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store.pair(m, 8 * j + 2 * kc, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    return;
  }
  __syncthreads();  // every tile read: the partials take the shared memory over
  float* red = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(red + (64 * wg + r0 + 8 * i) * X3_RED_LD + 8 * j + 2 * kc) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  cluster.sync();  // every block's partials are in its shared memory
  cluster_sum(cluster, red, 1, X3_BM, X3_BJ, X3_RED_LD, m0, 0, M, tid, X3_THREADS, store);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------------ launches

// The launch of an f32 call at (M, N, R packed rows): one design; N split
// over a cluster (pick_split_waves) only where the tile grid is under two
// waves of the SMs, at least X3_SPLIT_STEPS steps of N a block.
template <int BITS> MmPlan plan_mmt_tf32x3(int M, int N, int R) {
  constexpr int PR = X3Smem<BITS>::PR;
  const int tj = (R + PR - 1) / PR, tm = (M + X3_BM - 1) / X3_BM;
  const int64_t tiles = (int64_t)tj * tm;
  const int steps = (N + X3_BN - 1) / X3_BN;
  const int s = tiles >= 2 * sm_count()
                    ? 1
                    : pick_split_waves(tiles, sm_count(), max(1, steps / X3_SPLIT_STEPS));
  return {{0, X3_BM, X3_BM, X3_BJ}, s, dim3(s, tj, tm)};
}

template <int BITS>
int launch_mmt_tf32x3(const void* g, const void* codes, const void* scales, const void* levels,
                      void* out, int M, int N, int R, int block, void* stream) {
  if (M <= 0 || N <= 0 || R <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mmt_tf32x3<BITS>(M, N, R);
  return launch_cluster(mmt_tf32x3<BITS>, p.grid, p.split, X3_THREADS, X3Smem<BITS>::bytes, stream,
                        static_cast<const float*>(g), static_cast<const uint8_t*>(codes),
                        static_cast<const float*>(scales), static_cast<const float*>(levels),
                        static_cast<float*>(out), M, N, R, block);
}

// The f32 launch at (M, N, R), for a report (report_plan says what out[11]
// holds; design 0, the one 3xTF32 design; the split of N)
template <int BITS> int report_mmt_tf32x3(int M, int N, int R, int* out) {
  if (M <= 0 || N <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const auto kernel = mmt_tf32x3<BITS>;
  constexpr size_t smem = X3Smem<BITS>::bytes;
  return report_plan(plan_mmt_tf32x3<BITS>(M, N, R), kernel, smem,
                     blocks_per_sm(kernel, smem, X3_THREADS), X3_STAGES, out);
}

}  // namespace
