// The f32 routes of the fused dequant-matmuls on Hopper (sm_90a): the two
// designs of matmul_4bit.cu's and matmul_8bit.cu's f32 entry points, one
// template over the weight layout (BITS).
//
//   out[m, n] = sum_k x[m, k] * w[k, n],  w = levels[code] * scale
//
// x and out f32; w one f32 multiply rounded once (__fmul_rn), as the plain
// versions' `lv[idx] * s` gives it, so kernel and plain version differ only
// in the order of the sums. Products and sums are f32 on the CUDA cores: no
// tensor core multiplies f32 exactly (TF32 keeps 10 bits of x and w; the
// transposed products' f32 route, tf32x3_sm90.cuh, splits each operand
// into two TF32 parts and runs three products instead).
//
// Layouts (Codes<BITS>, dequant4_sm90.cuh). A "packed row" p of the codes
// (R of them, N bytes each) holds one weight of each of RUNS rows of K:
//   - BITS 8 (int8, int8a, nf8, fp8; R = K): one run, byte (p, n) is row p;
//   - BITS 4 (split_k; R = K2 = K_pad / 2): two runs, the low nibble of byte
//     (p, n) is row p, the high nibble row R + p.
// x is (M, RUNS R) row-major; run h of packed rows [p, p + j) multiplies
// x[:, h R + p : h R + p + j]. Scales are (RUNS R / block, N). Packed rows
// past R, columns past N and rows past M are masked (zeros staged); any
// block that divides RUNS R.
//
// Both designs keep the level table as 32 interleaved copies in shared
// memory (dequant8_sm90.cuh: lane l reads copy l, so a warp's lookups of
// random codes hit 32 banks), stage codes and scales with 16-byte cp.async
// (x too in the decode design; the prefill stages x through registers), and
// sum in a fixed order: two calls give the same bits.
//
// The two designs, picked by M inside the entry point (plan_mmf):
//   - decode (M <= FMA_DECODE_MAX_M, the serve engine's slots, greedy
//     decode): every weight is read once and used M times, so at M = 8 a
//     4-bit weight costs 0.5 B of memory and 16 FLOP: 32 FLOP a byte, past
//     the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20), but a few microseconds
//     of work that only the whole card finishes quickly. So K is split over
//     a cluster of S blocks per 64 columns of W (S from the runtime's count
//     of blocks an SM holds, as the bf16 decode picks it: pick_split), and
//     each of a block's 4 warps streams its own slices of 16 packed rows,
//     with their runs of x (MT rows) and their scale rows, through a
//     cp.async ring of FD_STAGES slots (no block barrier in the loop). A
//     lane owns 2 columns and all MT rows: it dequantizes each of its
//     weights once in registers and does MT FMAs with it, x read as
//     broadcast float4s. The partials of the 4 warps and the S blocks are
//     summed through distributed shared memory, rank then warp
//     (cluster_sum).
//   - prefill (M > FMA_DECODE_MAX_M: serve prefill, the accuracy proxy's
//     perplexity at M = 8192) is bound by the FMA units: 2 M K N FLOP at 67
//     TFLOP/s. 128 x FP_BN output tiles, 2 FP_BN threads of 8 x 8 outputs
//     (rows 8 ty + i, columns 4 tx + e and FP_BN / 2 + 4 tx + e), 128
//     registers a thread, so two 256-thread blocks share an SM. A step is 16
//     rows of K. A cp.async ring of FP_STAGES slots holds raw code slabs (16
//     / RUNS packed rows x FP_BN columns) and their scale rows, loaded two
//     steps ahead; each step the block dequantizes the next step's slab into
//     an f32 tile (16 x FP_BN, double buffered), reads the next step's x
//     into registers with 16-byte loads, runs this step's FMAs, then stores
//     that x transposed (16 x 128, double buffered), so a thread reads its 8
//     rows of a k as two float4s: one barrier a step. An 8 x 8 thread tile
//     reads 16 floats from shared memory for 64 FMAs, which the SM's shared
//     memory (32 floats a clock) and FMA units (128 a clock) serve at the
//     same rate; the dequantize and the transposed stores add to the shared
//     side. Where the tile grid leaves the SMs unevenly loaded, K is split
//     over a cluster (pick_split_waves) and the partial tiles summed as in
//     the decode design. A grid of few tiles and long K (GPT-2's (3072,
//     768) at M = 1024: 48 tiles) stays unevenly loaded: the runtime holds
//     30 clusters of 8 at once and 62 of 4, so either split leaves SMs with
//     two blocks beside SMs with one.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant4_sm90.cuh"  // Codes, fill_levels_f32, level, scale_at, stage_codes16, stage_scale_row
#include "splitk_sm90.cuh"    // cluster_sum, MmKind, MmPlan, pick_split

namespace {

// x[m, h R + j .. h R + j + 4) of x (M, runs R) into shared memory (`dst_s`):
// one 16-byte cp.async where the 4 values are in range and aligned, else
// 4-byte ones; zeros past M and past the run's R columns. j is a multiple of 4.
__device__ __forceinline__ void stage_f32x4(uint32_t dst_s, const float* __restrict__ x, int m,
                                            int h, int j, int M, int R, int runs) {
  const float* src = x + (int64_t)m * runs * R + (int64_t)h * R + j;
  if (m >= M || j >= R) {
    cp_async16(dst_s, x, 0);
  } else if ((R & 3) == 0 && j + 4 <= R) {
    cp_async16(dst_s, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst_s + 4 * e, j + e < R ? src + e : x, j + e < R ? 4 : 0);
  }
}

// f32 sums of 4 columns at out[m, n..n+4) (N columns), the store of cluster_sum.
struct StoreF32 {
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, const float4& v) const {
    float* o = out + (int64_t)m * N + n;
    if ((N & 3) == 0 && n + 4 <= N) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && n + j < N; ++j) o[j] = e[j];
    }
  }
};

// ------------------------------------------------------------ decode

constexpr int FMA_DECODE_MAX_M = 32;
constexpr int FD_THREADS = 128;  // 4 warps, each its own slices of K
constexpr int FD_STAGES = 3;
constexpr int FD_BN = 64;        // columns of W a block: 2 a lane
constexpr int FD_P = 16;         // packed rows a slice
constexpr int FD_RED_LD = FD_BN + 4;

template <int BITS, int MT> struct FdSmem {  // MT rows of x a block
  static constexpr int RUNS = Codes<BITS>::RUNS;
  // a slot: 16 code rows of 64 bytes, a scale row a run, MT rows of 16 x
  // values a run
  static constexpr int SROW = FD_P * FD_BN, X = SROW + RUNS * FD_BN * 4;
  static constexpr int SLOT = X + RUNS * MT * FD_P * 4;
  static constexpr int RING = 4 * FD_STAGES * SLOT;
  static constexpr int RED = 4 * MT * FD_RED_LD * 4;  // f32 partials, after the loop
  static constexpr size_t bytes = LV_F32_BYTES<BITS> + (RING > RED ? RING : RED);
};

// grid (S, N / 64, M / MT), clusters of S along x: rank r takes the slices
// [r * per, (r + 1) * per) of the packed rows, per = ceil(slices / S), and
// warp w of its block the slices w, w + 4, ... of those.
template <int BITS, int MT>
__global__ void __launch_bounds__(FD_THREADS)
mmf_decode(const float* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ levels,
           float* __restrict__ out, int M, int N, int R, int block) {
  using C = Codes<BITS>;
  using SM = FdSmem<BITS, MT>;
  constexpr int RUNS = C::RUNS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lv = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + LV_F32_BYTES<BITS>;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * FD_BN, m0 = blockIdx.z * MT;
  const int slices = (R + FD_P - 1) / FD_P, per = (slices + S - 1) / S;
  const int s_lo = min(slices, rank * per), s_hi = min(slices, s_lo + per);
  const int mine = s_hi - s_lo > warp ? (s_hi - s_lo - warp + 3) / 4 : 0;
  // one scale row a run, staged with the slice: its 16 rows lie in one block
  const bool one_srow = block % FD_P == 0 && (RUNS == 1 || R % FD_P == 0);
  fill_levels_f32<BITS, FD_THREADS>(lv, levels, tid);

  unsigned char* wring = ring + warp * FD_STAGES * SM::SLOT;
  const uint32_t wring_s = smem_addr(wring);
  auto load = [&](int it, int st) {  // slice s_lo + warp + 4 it into slot st
    const int p0 = FD_P * (s_lo + warp + 4 * it);
    unsigned char* slot = wring + st * SM::SLOT;
    const uint32_t slot_s = wring_s + st * SM::SLOT;
#pragma unroll
    for (int i = lane; i < FD_P * 4; i += 32) {  // 16 rows of 64 code bytes
      const int r = i / 4, c = (i % 4) * 16;
      stage_codes16(slot + r * FD_BN + c, slot_s + r * FD_BN + c, codes, p0 + r, n0 + c, R, N);
    }
#pragma unroll
    for (int i = lane; i < RUNS * MT * 4; i += 32) {  // RUNS x MT rows of 16 x values
      const int h = i / (MT * 4), m = (i / 4) % MT, c = (i % 4) * 4;
      stage_f32x4(slot_s + SM::X + ((h * MT + m) * FD_P + c) * 4, x, m0 + m, h, p0 + c, M, R,
                  RUNS);
    }
    if (one_srow && lane < 16 * RUNS) {  // lanes 16 h .. 16 h + 15: run h's scale row
      const int h = lane / 16, off = SM::SROW + h * FD_BN * 4;
      stage_scale_row(reinterpret_cast<float*>(slot + off), slot_s + off, scales,
                      (h * R + p0) / block, n0, N, FD_BN / 4, lane % 16);
    }
  };
#pragma unroll
  for (int st = 0; st < FD_STAGES - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }
  __syncthreads();  // the level table

  // acc[m][c]: x row m0 + m, column n0 + 2 lane + c
  float acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.0f;
  const int n = n0 + 2 * lane;

  for (int it = 0; it < mine; ++it) {
    cp_async_wait<FD_STAGES - 2>();  // slice it has landed
    __syncwarp();                    // ... for every lane; and slot it - 1 is free
    if (it + FD_STAGES - 1 < mine) load(it + FD_STAGES - 1, (it + FD_STAGES - 1) % FD_STAGES);
    cp_async_commit();
    const unsigned char* slot = wring + (it % FD_STAGES) * SM::SLOT;
    const int p0 = FD_P * (s_lo + warp + 4 * it);
    float s[RUNS][2];
    if (one_srow) {
#pragma unroll
      for (int h = 0; h < RUNS; ++h) {
        const float2 v =
            *reinterpret_cast<const float2*>(slot + SM::SROW + (h * FD_BN + 2 * lane) * 4);
        s[h][0] = v.x;
        s[h][1] = v.y;
      }
    }
#pragma unroll
    for (int j4 = 0; j4 < FD_P / 4; ++j4) {  // packed rows p0 + 4 j4 .. p0 + 4 j4 + 3
      float w[4][RUNS][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * j4 + q;
        const uint32_t b = *reinterpret_cast<const uint16_t*>(slot + r * FD_BN + 2 * lane);
#pragma unroll
        for (int h = 0; h < RUNS; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (!one_srow) s[h][c] = scale_at(scales, h, p0 + r, n + c, R, N, block);
            w[q][h][c] = __fmul_rn(level(lv, C::code((b >> (8 * c)) & 0xFF, h), lane), s[h][c]);
          }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < RUNS; ++h) {
          const float4 xv =
              *reinterpret_cast<const float4*>(slot + SM::X + ((h * MT + m) * FD_P + 4 * j4) * 4);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[m][c] = fmaf(xv.x, w[0][h][c], acc[m][c]);
            acc[m][c] = fmaf(xv.y, w[1][h][c], acc[m][c]);
            acc[m][c] = fmaf(xv.z, w[2][h][c], acc[m][c]);
            acc[m][c] = fmaf(xv.w, w[3][h][c], acc[m][c]);
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is out of the ring: the partials take it over

  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float2*>(red + (warp * MT + m) * FD_RED_LD + 2 * lane) =
        make_float2(acc[m][0], acc[m][1]);
  cluster.sync();  // every block's partials are in its shared memory
  cluster_sum(cluster, red, 4, MT, FD_BN, FD_RED_LD, m0, n0, M, tid, FD_THREADS,
              StoreF32{out, N});
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------------ prefill

constexpr int FP_BM = 128, FP_BN = 128;
constexpr int FP_THREADS = 2 * FP_BN;  // 16 x FP_BN / 8 threads, 8 x 8 outputs each
constexpr int FP_BK = 16;        // rows of K a step: RUNS runs of 16 / RUNS packed rows
constexpr int FP_STAGES = 3;     // code slabs land two steps ahead of their dequantize
constexpr int FP_A_LD = FP_BM + 4;    // floats of a staged (transposed) x row of K
constexpr int FP_RED_LD = FP_BN + 4;
constexpr int FP_XR = FP_BM * FP_BK / 4 / FP_THREADS;  // float4s of x a thread stages a step

// level table; 2 x tiles (transposed, 16 x 128 f32); STAGES x (code slab, a
// scale row a run); 2 f32 W tiles (16 x 128)
template <int BITS> struct FpSmem {
  static constexpr int RUNS = Codes<BITS>::RUNS, PR = FP_BK / RUNS;  // packed rows a step
  static constexpr int XT = FP_BK * FP_A_LD * 4, CT = PR * FP_BN, ST = RUNS * FP_BN * 4;
  static constexpr int X0 = LV_F32_BYTES<BITS>, C0 = X0 + 2 * XT, SLOT = CT + ST;
  static constexpr int W0 = C0 + FP_STAGES * SLOT, WT = FP_BK * FP_BN * 4;
  static constexpr int END = W0 + 2 * WT;
  static constexpr int RED = FP_BM * FP_RED_LD * 4;  // f32 partials, over everything
  static constexpr size_t bytes = END > RED ? END : RED;
};

// grid (S, N / FP_BN, M / 128), clusters of S along x: rank r takes the
// steps [r * per, (r + 1) * per) of 16 rows of K. 128 registers a thread.
template <int BITS>
__global__ void __launch_bounds__(FP_THREADS, 512 / FP_THREADS)
mmf_prefill(const float* __restrict__ x, const uint8_t* __restrict__ codes,
            const float* __restrict__ scales, const float* __restrict__ levels,
            float* __restrict__ out, int M, int N, int R, int block) {
  using C = Codes<BITS>;
  using SM = FpSmem<BITS>;
  constexpr int RUNS = C::RUNS, PR = SM::PR;
  constexpr int CB = PR * FP_BN / FP_THREADS;  // code bytes a thread dequantizes a step
  extern __shared__ __align__(16) unsigned char smem[];
  float* lv = reinterpret_cast<float*>(smem);
  auto xtile = [&](int i) { return reinterpret_cast<float*>(smem + SM::X0 + i * SM::XT); };
  auto slot = [&](int st) { return smem + SM::C0 + st * SM::SLOT; };
  auto wtile = [&](int i) { return reinterpret_cast<float*>(smem + SM::W0 + i * SM::WT); };

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  constexpr int TX = FP_BN / 8, HN = FP_BN / 2;  // threads along N; a thread's second float4
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX, lane = tid % 32;
  const int n0 = blockIdx.y * FP_BN, m0 = blockIdx.z * FP_BM;
  const int steps = (R + PR - 1) / PR, per = (steps + S - 1) / S;
  const int t_lo = min(steps, rank * per), n_t = min(steps, t_lo + per) - t_lo;
  // one scale row a run, staged with the step: its PR rows lie in one block
  const bool one_srow = block % PR == 0 && (RUNS == 1 || R % PR == 0);
  fill_levels_f32<BITS, FP_THREADS>(lv, levels, tid);

  // x goes through registers: step t's 128 x 16 values are read with 16-byte
  // loads (4 threads a row: chunk q holds run 4 q / PR, packed rows p0 + 4 q
  // % PR ..) while step t - 1's FMAs run, and stored transposed after them,
  // As[kc][r] = x[m0 + r, column kc of the step]: a thread then reads its 8
  // rows of one k as two float4s. Zeros past M and past R in either run.
  float4 xr[FP_XR];
  auto xload = [&](int t) {
    const int p0 = (t_lo + t) * PR;
#pragma unroll
    for (int i = 0; i < FP_XR; ++i) {
      const int e = tid + i * FP_THREADS, r = e / 4, q = e % 4;
      const int m = m0 + r, j = p0 + 4 * q % PR;
      const float* src = x + (int64_t)m * RUNS * R + (int64_t)(4 * q / PR) * R + j;
      if (m < M && (R & 3) == 0 && j + 4 <= R) {
        xr[i] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = m < M && j + c < R ? __ldg(src + c) : 0.0f;
        xr[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto xstore = [&](int buf) {
    float* xs = xtile(buf);
#pragma unroll
    for (int i = 0; i < FP_XR; ++i) {
      const int e = tid + i * FP_THREADS, r = e / 4, kc = 4 * (e % 4);
      xs[kc * FP_A_LD + r] = xr[i].x;
      xs[(kc + 1) * FP_A_LD + r] = xr[i].y;
      xs[(kc + 2) * FP_A_LD + r] = xr[i].z;
      xs[(kc + 3) * FP_A_LD + r] = xr[i].w;
    }
  };
  auto load = [&](int t, int st) {  // step t_lo + t's codes and scales into slot st
    const int p0 = (t_lo + t) * PR;
    const uint32_t base = smem_addr(slot(st));
    for (int i = tid; i < PR * FP_BN / 16; i += FP_THREADS) {  // PR code rows of FP_BN bytes
      const int r = i / (FP_BN / 16), c = (i % (FP_BN / 16)) * 16;
      stage_codes16(slot(st) + r * FP_BN + c, base + r * FP_BN + c, codes, p0 + r, n0 + c, R, N);
    }
    if (one_srow && tid < RUNS * FP_BN / 4) {  // FP_BN / 4 threads a run's scale row
      const int h = tid / (FP_BN / 4), off = SM::CT + h * FP_BN * 4;
      stage_scale_row(reinterpret_cast<float*>(slot(st) + off), base + off, scales,
                      (h * R + p0) / block, n0, N, FP_BN / 4, tid % (FP_BN / 4));
    }
  };
  // Step t's slab into W tile t % 2: thread tid takes CB code bytes of
  // packed row pr, columns c0.., and writes their RUNS x CB weights (row h
  // PR + pr of the tile for run h).
  auto dequant = [&](int t) {
    const unsigned char* sl = slot(t % FP_STAGES);
    const int p0 = (t_lo + t) * PR, pr = tid / (FP_BN / CB), c0 = (tid % (FP_BN / CB)) * CB;
    uint32_t words[CB / 4];  // code byte e in bits 8 (e % 4) of word e / 4
#pragma unroll
    for (int i = 0; i < CB / 4; ++i)
      words[i] = reinterpret_cast<const uint32_t*>(sl + pr * FP_BN + c0)[i];
    float* wt = wtile(t % 2);
#pragma unroll
    for (int h = 0; h < RUNS; ++h) {
      float s[CB], w[CB];
      if (one_srow) {
        const float* sr = reinterpret_cast<const float*>(sl + SM::CT) + h * FP_BN + c0;
#pragma unroll
        for (int e = 0; e < CB; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(sr + e);
          s[e] = v.x; s[e + 1] = v.y; s[e + 2] = v.z; s[e + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < CB; ++e) s[e] = scale_at(scales, h, p0 + pr, n0 + c0 + e, R, N, block);
      }
#pragma unroll
      for (int e = 0; e < CB; ++e) {
        const uint32_t byte = (words[e / 4] >> (8 * (e % 4))) & 0xFF;
        w[e] = __fmul_rn(level(lv, C::code(byte, h), lane), s[e]);
      }
#pragma unroll
      for (int e = 0; e < CB; e += 4)
        *reinterpret_cast<float4*>(wt + (h * PR + pr) * FP_BN + c0 + e) =
            make_float4(w[e], w[e + 1], w[e + 2], w[e + 3]);
    }
  };

  if (n_t > 0) {
    xload(0);
    xstore(0);
  }
#pragma unroll
  for (int st = 0; st < FP_STAGES - 1; ++st) {
    if (st < n_t) load(st, st);
    cp_async_commit();
  }
  cp_async_wait<FP_STAGES - 2>();  // step 0 has landed
  __syncthreads();                 // ... for every thread, and the level table is in
  if (n_t > 0) dequant(0);

  // acc[i][4 h + e]: row m0 + 8 ty + i, column n0 + HN h + 4 tx + e
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<FP_STAGES - 3>();  // step t + 1's codes have landed
    // ... for every thread; x and W tiles t % 2 are whole; step t - 1's products are done
    __syncthreads();
    if (t + FP_STAGES - 1 < n_t) load(t + FP_STAGES - 1, (t + FP_STAGES - 1) % FP_STAGES);
    cp_async_commit();
    if (t + 1 < n_t) {
      xload(t + 1);    // into registers, stored after the FMAs
      dequant(t + 1);  // into W tile (t + 1) % 2, last read by step t - 1
    }
    const float* xs = xtile(t % 2) + 8 * ty;
    const float* ws = wtile(t % 2) + 4 * tx;
#pragma unroll
    for (int k = 0; k < FP_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * FP_A_LD);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * FP_A_LD + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + k * FP_BN);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + k * FP_BN + HN);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < n_t) xstore((t + 1) % 2);  // x tile (t + 1) % 2, last read by step t - 1
  }
  cp_async_wait<0>();

  if (S == 1) {
    const StoreF32 store{out, N};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + 8 * ty + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(m, n0 + HN * h + 4 * tx,
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
    return;
  }
  __syncthreads();  // every tile read: the partials take the shared memory over
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(red + (8 * ty + i) * FP_RED_LD + HN * h + 4 * tx) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  cluster.sync();
  cluster_sum(cluster, red, 1, FP_BM, FP_BN, FP_RED_LD, m0, n0, M, tid, FP_THREADS,
              StoreF32{out, N});
  cluster.sync();
}

// ------------------------------------------------------------ launches

MmKind mmf_kind(int M) {
  if (M <= FMA_DECODE_MAX_M) {
    const int mt = M <= 8 ? 8 : M <= 16 ? 16 : 32;
    return {0, mt, mt, FD_BN};
  }
  return {1, FP_BM, FP_BM, FP_BN};
}

template <int BITS, typename F> auto with_mmf(const MmKind& k, F f) {
  if (k.design == 1) return f(mmf_prefill<BITS>, FP_THREADS, FpSmem<BITS>::bytes);
  switch (k.tmpl) {
    case 8: return f(mmf_decode<BITS, 8>, FD_THREADS, FdSmem<BITS, 8>::bytes);
    case 16: return f(mmf_decode<BITS, 16>, FD_THREADS, FdSmem<BITS, 16>::bytes);
    default: return f(mmf_decode<BITS, 32>, FD_THREADS, FdSmem<BITS, 32>::bytes);
  }
}

// Blocks of the kind's kernel an SM holds, asked of the runtime once per kernel.
template <int BITS> int mmf_resident(const MmKind& k) {
  static int n[4] = {};  // decode MT 8, 16, 32; prefill
  int& r = n[k.design ? 3 : k.tmpl / 16];
  if (r == 0)
    r = with_mmf<BITS>(k, [](auto kernel, int threads, size_t smem) {
      return blocks_per_sm(kernel, smem, threads);
    });
  return r;
}

// The plan of an f32 call at (M, N, R packed rows): the decode design splits
// K as the bf16 decode does (each warp at least two slices: no finer than
// 128 packed rows a block); the prefill design at least 256 rows of K a
// split (shorter ones spend their time filling the ring and summing), by
// pick_split_waves.
template <int BITS> MmPlan plan_mmf(int M, int N, int R) {
  const MmKind k = mmf_kind(M);
  if (k.design == 0) return plan_split(k, M, N, max(1, (R + 8 * FD_P - 1) / (8 * FD_P)),
                                       mmf_resident<BITS>(k));
  const int tn = (N + FP_BN - 1) / FP_BN, tm = (M + FP_BM - 1) / FP_BM;
  const int s =
      pick_split_waves((int64_t)tn * tm, sm_count(), max(1, R * Codes<BITS>::RUNS / 256));
  return {k, s, dim3(s, tn, tm)};
}

}  // namespace
