// LLM.int8 GEMM for Hopper (sm_90a): int8 activations x int8 weights on the
// int8 tensor cores, exact int32 sums, row x column scales on the sum.
//
// Replaces two Pallas TPU kernels of quanta_tpu/ops/int8mm.py with one
// pair of designs:
//   matmul_int8_fused  (_mm_i8_fused_kernel) -> qt_matmul_int8_fused (FUSED)
//   matmul_int8_kernel (_mm_i8_kernel)       -> qt_matmul_int8
// It computes, for codes (K, N) int8 with their outlier rows zeroed,
//
//   FUSED:  xq = clamp(rint(x / row_scale[m]), -127, 127)   (x f32 (M, K))
//           out = (float)(xq @ codes) * row_scale[m] * col_scale[n] + y_out[m, n]
//   plain:  out = (float)(xq @ codes) * row_scale[m] * col_scale[n]
//                                                            (xq int8 (M, K))
//
// The prologue divides with IEEE rounding (__fdiv_rn, never a reciprocal)
// and rounds half to even (rintf), as torch.round and jnp.round do; the
// int32 sum is exact in any order; the epilogue is __fmul_rn / __fadd_rn in
// the plain version's order, so nvcc cannot contract it into an FMA. Kernel
// and plain version agree bit for bit. Build without --use_fast_math.
//
// What bounds it on the H100, and the two designs, chosen by M inside each
// entry point (int4c.cu's, without the nibbles, over the launch side of
// splitk_sm90.cuh):
//   - decode (M <= DECODE_MAX_M: greedy decode and the serve windows at M =
//     slots) is bound by memory: the K * N code bytes (plus x and out),
//     against 3.35 TB/s. mma.sync m16n8k32 s8 -> s32 with W^T as A (16
//     columns of W x 32 K values) and x^T as the n8 operand (8 rows of x).
//     Each of a block's 4 warps streams its own slices (32 K rows x 64
//     columns of codes and the 32-value runs of 8 MT rows of x) through a
//     cp.async ring of DEC_STAGES slots. The fused entry point, up to
//     DEC_F32_MAX_M rows, stages x as f32 and quantizes each lane's b
//     operand as it leaves the slot, so a block never holds more x than its
//     ring. K is split over a cluster of S blocks where the N / 64 grid
//     leaves SMs idle (plan_split), and the int32 partials of the 4 warps and
//     the S blocks are summed through distributed shared memory
//     (cluster_sum).
//   - prefill (M > DECODE_MAX_M: the serve prefill buckets and
//     decode_bench's prefill at M = 1024) is bound by the int8 tensor cores
//     (2 * M * K * N operations at 1,979 TOP/s) and, for the fused entry
//     point, by the f32 x, y_out and out bytes. int8 wgmma m64n128k32, both
//     operands K-major (the only layout wgmma takes for 8-bit types): 128 x
//     128 output tiles, two consumer warpgroups of 64 rows; a cp.async ring
//     of PF_STAGES slots holds the int8 x tiles (a swizzled Tile<64> row is
//     128 int8 of K) and PF_STAGES - 1 raw slabs of 128 K rows x 128
//     columns, loaded PF_STAGES - 1 steps ahead; each step the block
//     transposes one slab into an int8 Tile (128 rows of W's columns, each
//     128 K values; double buffered) while the previous step's wgmma runs. K
//     splits over a cluster as in the decode design.
// The fused entry point quantizes x in a first pass of its own (inside the
// same C call) into an int8 scratch (M x K, from the wrapper) wherever its
// kernel does not take f32 x (M > DEC_F32_MAX_M), and the kernel then adds
// y_out in its epilogue.
// Transposing. Codes are (K, N) with N contiguous, but both products want K
// contiguous for each column of W. A thread reads 4 rows x 4 columns as four
// 32-bit words and transposes them with __byte_perm (transpose4x4): in
// registers, straight into the mma's A operand, for decode; into the
// swizzled B tile, 8 bytes at a time, for prefill.
//
// Tried on the H100 (kernel_sweep.py --what i8, the TinyLlama-1.1B (K, N);
// PERF.md): quantizing f32 x inside the prefill kernel, one step ahead
// through registers (177 registers, one block an SM; every column tile
// reads x again in f32), took 392 us at (2048, 5632) and M = 1024 against
// 98.6 for the first pass; the decode kernel with f32 x at M = 32 (MT = 4)
// lost to the first pass and the int8-x kernel (32.4 against 23.8 us there);
// decode still beats prefill at M = 32 over a forward's 155 calls (2.20
// against 2.30 ms, int8 x); a decode ring of 4 stages ties 3; 128-column
// decode blocks win on lm_head (33.6 against 44.6 us) and lose over a
// forward; a prefill ring of 4 stages (one block an SM) loses up to 26%;
// 256-row prefill tiles (four warpgroups of 64 rows, one block an SM) win
// at M = 2048 by up to 7% and lose at M = 64 at every shape (by up to 78%);
// the epilogue's loads sent 4 column pairs at a time (PF_EPI_J) beat 1
// (79.2 against 91.3 us, fused, at (2048, 5632) and M = 1024) and tie 16
// (within 3%).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant8_sm90.cuh"  // stage_codes16 (and sm90.cuh)
#include "int8_sm90.cuh"      // transpose4x4, store_scaled
#include "splitk_sm90.cuh"    // cluster_sum, MmKind, MmPlan, plan_split, mma_s8_16832

namespace {

// ------------------------------------------------------------ prologue

// clamp(rint(x / rs), -127, 127)
__device__ __forceinline__ int quantize(float x, float rs) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, rs)), -127.f), 127.f));
}

// f quantized by rs, as 4 int8 (f.x in the low byte)
__device__ __forceinline__ uint32_t quantize4(const float4& f, float rs) {
  return (uint32_t)(quantize(f.x, rs) & 0xFF) | (uint32_t)(quantize(f.y, rs) & 0xFF) << 8 |
         (uint32_t)(quantize(f.z, rs) & 0xFF) << 16 | (uint32_t)(quantize(f.w, rs) & 0xFF) << 24;
}

// xq = quantize(x / row_scale[m]) for f32 x (M, K), 4 values a thread: the
// fused entry point's first pass, wherever its kernel reads int8 x.
__global__ void i8_quantize_rows(const float* __restrict__ x, const float* __restrict__ row_scale,
                                 int8_t* __restrict__ xq, int M, int K) {
  const int k4 = (K + 3) / 4;
  const int64_t total = (int64_t)M * k4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / k4), k = (int)(i % k4) * 4;
    const float rs = __ldg(row_scale + m);
    const float* src = x + (int64_t)m * K + k;
    int8_t* dst = xq + (int64_t)m * K + k;
    if ((K & 3) == 0) {
      *reinterpret_cast<uint32_t*>(dst) = quantize4(__ldg(reinterpret_cast<const float4*>(src)), rs);
    } else {
      for (int e = 0; e < 4 && k + e < K; ++e) dst[e] = static_cast<int8_t>(quantize(src[e], rs));
    }
  }
}

// ------------------------------------------------------------- staging

// x[m, j .. j + 16) of int8 x (M, K) into shared memory (`dst`, generic, and
// its shared address `dst_s`): cp.async where the 16 values are in range and
// aligned, else byte by byte; zeros past M and K. j is a multiple of 16.
__device__ __forceinline__ void stage_xq16(unsigned char* dst, uint32_t dst_s,
                                           const int8_t* __restrict__ x, int m, int j, int M,
                                           int K) {
  const int8_t* src = x + (int64_t)m * K + j;
  if (m >= M || j >= K) {
    cp_async16(dst_s, x, 0);
  } else if ((K & 15) == 0) {
    cp_async16(dst_s, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = j + e < K ? src[e] : 0;
  }
}

// x[m, j .. j + 4) of f32 x (M, K), as stage_xq16 does; j is a multiple of 4.
__device__ __forceinline__ void stage_xf4(unsigned char* dst, uint32_t dst_s,
                                          const float* __restrict__ x, int m, int j, int M, int K) {
  const float* src = x + (int64_t)m * K + j;
  if (m >= M || j >= K) {
    cp_async16(dst_s, x, 0);
  } else if ((K & 3) == 0) {
    cp_async16(dst_s, src, 16);
  } else {
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = j + e < K ? src[e] : 0.0f;
  }
}

// ------------------------------------------------------------- decode

constexpr int DECODE_MAX_M = 32;
constexpr int DEC_F32_MAX_M = 16;  // FUSED: f32 x quantized in the decode kernel up to here
constexpr int DEC_STAGES = 3;
constexpr int DEC_THREADS = 128;
constexpr int DEC_BN = 64;             // columns of W a block
constexpr int DEC_NP = DEC_BN / 32;    // 32-column groups: two m16 tiles of W^T each
constexpr int DEC_P = 32;              // K rows a slice: one k32 of the mma
constexpr int CODE_LD = DEC_BN + 16;   // bytes of a staged code row: see code_slot
constexpr int RED_LD = DEC_BN + 4;

// The slot of a slice's code row r: lane (g, t) reads rows 4t..4t+3 and
// 16+4t..16+4t+3 at columns 32 p + 4 g; row 16 h + 4 t + i sits at slot
// 16 h + 2 t + i % 2 + 8 (i / 2), CODE_LD bytes apart (2 slots: 8 banks
// on), so each of the 8 loads of a warp hits 32 banks.
__device__ __forceinline__ int code_slot(int r) {
  return 16 * (r >> 4) + 2 * ((r & 15) >> 2) + (r & 1) + 8 * ((r >> 1) & 1);
}

template <bool F32X, int MT> struct DecSmem {  // MT n8 tiles of x rows: M <= 8 * MT a block
  // a slot: 32 code rows, then x's two runs (K values 0-15 and 16-31 of the
  // slice) of 8 MT rows of 16 values each: f32 (F32X) or int8
  static constexpr int X = DEC_P * CODE_LD;
  static constexpr int X_LD = F32X ? 64 : 16;  // bytes of a staged x row of one run
  static constexpr int SLOT = X + 2 * 8 * MT * X_LD;
  static constexpr int RING = 4 * DEC_STAGES * SLOT;
  static constexpr int RED = 4 * 8 * MT * RED_LD * 4;  // int32 partials, after the loop
  static constexpr size_t bytes = RING > RED ? RING : RED;
};

// grid (S, N / 64, M / (8 MT)), clusters of S along x: rank r takes the
// slices [r * per, (r + 1) * per) of 32 K rows, per = ceil(slices / S), and
// warp w of its block the slices w, w + 4, ... of those. `xin` is f32 x
// (F32X: quantized here) or int8 xq; y_out, or null, is added in the
// epilogue.
template <bool F32X, int MT>
__global__ void __launch_bounds__(DEC_THREADS)
i8_decode(const void* __restrict__ xin, const uint8_t* __restrict__ codes,
          const float* __restrict__ row_scale, const float* __restrict__ col_scale,
          const float* __restrict__ y_out, float* __restrict__ out, int M, int N, int K) {
  using SM = DecSmem<F32X, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.y * DEC_BN, m0 = blockIdx.z * 8 * MT;
  const int slices = (K + DEC_P - 1) / DEC_P, per = (slices + S - 1) / S;
  const int s_lo = min(slices, rank * per), s_hi = min(slices, s_lo + per);
  const int mine = s_hi - s_lo > warp ? (s_hi - s_lo - warp + 3) / 4 : 0;

  unsigned char* wring = smem + warp * DEC_STAGES * SM::SLOT;
  const uint32_t wring_s = smem_addr(wring);
  auto load = [&](int it, int st) {  // slice s_lo + warp + 4 it into slot st
    const int kp = DEC_P * (s_lo + warp + 4 * it);
    unsigned char* slot = wring + st * SM::SLOT;
    const uint32_t slot_s = wring_s + st * SM::SLOT;
#pragma unroll
    for (int i = lane; i < DEC_P * (DEC_BN / 16); i += 32) {  // 32 rows of 64 code bytes
      const int r = i / (DEC_BN / 16), c = (i % (DEC_BN / 16)) * 16;
      const int off = code_slot(r) * CODE_LD + c;
      stage_codes16(slot + off, slot_s + off, codes, kp + r, n0 + c, K, N);
    }
    if constexpr (F32X) {
      // run h, x row r, 4-value chunk c at (h * 8 MT + r) * 64 + 16 c
      for (int i = lane; i < 2 * 8 * MT * 4; i += 32) {
        const int h = i / (8 * MT * 4), r = (i / 4) % (8 * MT), off = SM::X + 16 * i;
        stage_xf4(slot + off, slot_s + off, static_cast<const float*>(xin), m0 + r,
                  kp + 16 * h + 4 * (i % 4), M, K);
      }
    } else {
      for (int i = lane; i < 2 * 8 * MT; i += 32) {  // run i / (8 MT), x row i % (8 MT)
        const int off = SM::X + i * SM::X_LD;
        stage_xq16(slot + off, slot_s + off, static_cast<const int8_t*>(xin),
                   m0 + i % (8 * MT), kp + 16 * (i / (8 * MT)), M, K);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }

  // F32X: the scale of each of this lane's x rows 8 i + g; rows past M
  // quantize to 0 without a division
  float rsv[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + 8 * i + g;
    rsv[i] = F32X && m < M ? __ldg(row_scale + m) : 0.0f;
  }

  // Lane (g, t) holds columns 32 p + 4 g + c of group p: A row g of tile
  // 2 p + e is column 32 p + 4 g + 2 e, row g + 8 the next one. A fragment:
  // a0 = K rows 4t..4t+3 of row g's column, a1 the same of row g + 8's, a2
  // and a3 K rows 16+4t..16+4t+3; b0 = x[8 i + g, kp + 4t..], b1 = x[8 i +
  // g, kp + 16 + 4t..]. acc[p][e][i]: tile 2 p + e, x tile i.
  int acc[DEC_NP][2][MT][4];
#pragma unroll
  for (int p = 0; p < DEC_NP; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[p][e][i][v] = 0;

  for (int it = 0; it < mine; ++it) {
    cp_async_wait<DEC_STAGES - 2>();  // slice it has landed
    __syncwarp();                     // ... for every lane; and slot it - 1 is free
    if (it + DEC_STAGES - 1 < mine) load(it + DEC_STAGES - 1, (it + DEC_STAGES - 1) % DEC_STAGES);
    cp_async_commit();
    const unsigned char* slot = wring + (it % DEC_STAGES) * SM::SLOT;
    uint32_t b[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* row = slot + SM::X + (h * 8 * MT + 8 * i + g) * SM::X_LD;
        if constexpr (F32X) {
          const float4 f = *reinterpret_cast<const float4*>(row + 16 * t4);
          b[i][h] = m0 + 8 * i + g < M ? quantize4(f, rsv[i]) : 0u;
        } else {
          b[i][h] = *reinterpret_cast<const uint32_t*>(row + 4 * t4);
        }
      }
#pragma unroll
    for (int p = 0; p < DEC_NP; ++p) {
      uint32_t lo[4], hi[4], wl[4], wh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lo[q] = *reinterpret_cast<const uint32_t*>(slot + code_slot(4 * t4 + q) * CODE_LD +
                                                   32 * p + 4 * g);
        hi[q] = *reinterpret_cast<const uint32_t*>(slot + code_slot(16 + 4 * t4 + q) * CODE_LD +
                                                   32 * p + 4 * g);
      }
      transpose4x4(lo, wl);
      transpose4x4(hi, wh);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t a[4] = {wl[2 * e], wl[2 * e + 1], wh[2 * e], wh[2 * e + 1]};
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8_16832(acc[p][e][i], a, b[i][0], b[i][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is out of the ring: the partials take it over

  // d0, d1: A row g (column 32 p + 4 g + 2 e), x rows 8 i + 2t, 2t + 1; d2,
  // d3 the next column
  int* red = reinterpret_cast<int*>(smem) + warp * 8 * MT * RED_LD;
#pragma unroll
  for (int p = 0; p < DEC_NP; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int* q = red + (8 * i + 2 * t4) * RED_LD + 32 * p + 4 * g + 2 * e;
        *reinterpret_cast<int2*>(q) = make_int2(acc[p][e][i][0], acc[p][e][i][2]);
        *reinterpret_cast<int2*>(q + RED_LD) = make_int2(acc[p][e][i][1], acc[p][e][i][3]);
      }
  cluster.sync();  // every block's partials are in its shared memory
  cluster_sum(cluster, reinterpret_cast<int*>(smem), 4, 8 * MT, DEC_BN, RED_LD, m0, n0, M, tid,
              DEC_THREADS, [&](int m, int n, const int4& sum) {
                store_scaled(out, m, n, sum, row_scale, col_scale, N, y_out);
              });
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------------- prefill

constexpr int PF_BM = 128;             // rows of x a tile: two warpgroups of 64
constexpr int PF_THREADS = 256;
constexpr int PF_STAGES = 3;           // x tile slots; the loads run PF_STAGES - 1 steps ahead
constexpr int PF_AHEAD = PF_STAGES - 1;
constexpr int PF_BN = 128, PF_BK = 128;  // a step: 128 K values
constexpr int PF_RED_LD = PF_BN + 4;
constexpr int PF_EPI_J = 4;            // epilogue: column pairs whose loads go out together

// PF_STAGES x 2 x tiles; 2 W tiles; PF_AHEAD code slabs (a slab is
// transposed in the step it lands and reloaded at once, an x tile reloaded
// only once its products are done)
struct PfSmem {
  static constexpr uint32_t XT = Tile<64>::BYTES;      // 64 rows of 128 int8
  static constexpr uint32_t WT = 2 * Tile<64>::BYTES;  // 128 columns of W, 128 int8 of K each
  static constexpr uint32_t SLAB = PF_BK * PF_BN;      // 128 K rows of 128 bytes
  static constexpr uint32_t W0 = PF_STAGES * 2 * XT;   // the x tiles from the base
  static constexpr uint32_t C0 = W0 + 2 * WT;
  static constexpr uint32_t END = C0 + PF_AHEAD * SLAB;
  static constexpr uint32_t RED = PF_BM * PF_RED_LD * 4;  // int32 partials, over the tiles
  static constexpr size_t bytes = (END > RED ? END : RED) + 1024;
};

// grid (S, N / 128, M / 128), clusters of S along x: rank r takes the steps
// [r * per, (r + 1) * per) of 128 K rows. Warpgroup wg loads and multiplies
// x tile wg; all 256 threads stage and transpose the code slabs.
// `xin` is int8 xq (the fused entry point's scratch); y_out, or null, is
// added in the epilogue.
//
// Step t: wait for slab t and x tile t; transpose slab t into W tile t % 2
// (read last by the products of t - 2); reload its slab slot with step t +
// PF_AHEAD; start the products of t; wait for those of t - 1; reload their
// x slot with step t + PF_AHEAD. Each step commits two cp.async groups, so
// the x tile and slab of step t are those PF_AHEAD - 1 steps (2 (PF_AHEAD -
// 1) groups) back.
__global__ void __launch_bounds__(PF_THREADS, 2)  // two blocks an SM: 128 registers at most
i8_prefill(const void* __restrict__ xin, const uint8_t* __restrict__ codes,
           const float* __restrict__ row_scale, const float* __restrict__ col_scale,
           const float* __restrict__ y_out, float* __restrict__ out, int M, int N, int K) {
  using SM = PfSmem;
  extern __shared__ unsigned char smem[];
  const int8_t* xq = static_cast<const int8_t*>(xin);
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  auto Xs = [&](int st, int i) { return base + (2 * st + i) * SM::XT; };
  auto Ws = [&](int i) { return base + SM::W0 + i * SM::WT; };
  auto slab = [&](int st) { return gbase + SM::C0 + st * SM::SLAB; };

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128, warp = wtid / 32,
            lane = tid % 32;
  const int n0 = blockIdx.y * PF_BN, m0 = blockIdx.z * PF_BM;
  const int steps = (K + PF_BK - 1) / PF_BK, per = (steps + S - 1) / S;
  const int t_lo = min(steps, rank * per), n_t = min(steps, t_lo + per) - t_lo;

  // The slab: K row r's 16-byte chunk c at chunk c ^ (r / 8 % 8), so the
  // transpose's reads (8 row groups x 4 column groups a warp) hit 32 banks.
  auto load_slab = [&](int t) {  // step t_lo + t into slab slot t % PF_AHEAD
    const int k0 = (t_lo + t) * PF_BK;
    unsigned char* sl = slab(t % PF_AHEAD);
    for (int i = tid; i < PF_BK * 8; i += PF_THREADS) {
      const int r = i / 8, c = i % 8, off = r * PF_BN + ((c ^ ((r >> 3) & 7)) << 4);
      stage_codes16(sl + off, smem_addr(sl) + off, codes, k0 + r, n0 + 16 * c, K, N);
    }
  };
  auto load_x = [&](int t) {  // this warpgroup's 64 rows of step t_lo + t into slot t % PF_STAGES
    const int k0 = (t_lo + t) * PF_BK;
    for (int i = wtid; i < 64 * 8; i += 128) {
      const int r = i / 8, c = i % 8;
      const uint32_t dst = Xs(t % PF_STAGES, wg) + Tile<64>::offset(r, c);
      stage_xq16(gbase + (dst - base), dst, xq, m0 + 64 * wg + r, k0 + 16 * c, M, K);
    }
  };
  // Thread: columns 4 cq .. 4 cq + 3 of the block's 128 and K rows 64 j + 8 rg
  // .. 64 j + 8 rg + 7 of the slab (j = 0, 1). Column n's B row holds them at
  // byte 64 j + 8 rg: one 8-byte store each, which a warp spreads over every
  // bank.
  const int rg = lane & 7, cq = 4 * (tid / 32) + (lane >> 3);
  auto transpose = [&](uint32_t wt, const unsigned char* sl) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t r[2][4], w[2][4];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        r[q / 4][q % 4] = *reinterpret_cast<const uint32_t*>(
            sl + (64 * j + 8 * rg + q) * PF_BN + (((cq >> 2) ^ rg) << 4) + 4 * (cq & 3));
      transpose4x4(r[0], w[0]);
      transpose4x4(r[1], w[1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t dst = wt + Tile<64>::offset(4 * cq + c, 4 * j + (rg >> 1)) + 8 * (rg & 1);
        asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst), "r"(w[0][c]), "r"(w[1][c])
                     : "memory");
      }
    }
  };
#pragma unroll
  for (int t = 0; t < PF_AHEAD; ++t) {
    if (t < n_t) load_slab(t);
    cp_async_commit();
    if (t < n_t) load_x(t);
    cp_async_commit();
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<2 * (PF_AHEAD - 1)>();  // slab t and x tile t have landed
    __syncthreads();  // ... for every thread; the products of t - 2 are done
    transpose(Ws(t % 2), slab(t % PF_AHEAD));
    fence_proxy_async();  // this thread's x tile copies and W tile stores, for wgmma
    __syncthreads();      // the W tile is whole; slab slot t % PF_AHEAD is free
    if (t + PF_AHEAD < n_t) load_slab(t + PF_AHEAD);
    cp_async_commit();
    const uint32_t xt = Xs(t % PF_STAGES, wg), wt = Ws(t % 2);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_s8(acc, Tile<64>::k_major(xt, kk), Tile<64>::k_major(wt, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the products of t - 1 are done (x slot (t + PF_AHEAD) % PF_STAGES)
    fence_regs(acc);
    if (t + PF_AHEAD < n_t) load_x(t + PF_AHEAD);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  // acc[4 j + 2 i + c]: row 64 wg + 16 warp + lane / 4 + 8 i, column 8 j +
  // 2 (lane % 4) + c
  const int r_lo = 64 * wg + 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + r_lo + 8 * i;
      if (m >= M) continue;
      const float rs = __ldg(row_scale + m);
      float* o = out + (int64_t)m * N;
      // PF_EPI_J column pairs at a time: their loads (column scales, y_out)
      // first, in flight together, then the math and the stores
#pragma unroll
      for (int j0 = 0; j0 < PF_BN / 8; j0 += PF_EPI_J) {
        float2 cv[PF_EPI_J], yv[PF_EPI_J];
#pragma unroll
        for (int jj = 0; jj < PF_EPI_J; ++jj) {
          const int n = n0 + 8 * (j0 + jj) + c_lo;
          cv[jj] = make_float2(n < N ? __ldg(col_scale + n) : 0.0f,
                               n + 1 < N ? __ldg(col_scale + n + 1) : 0.0f);
          yv[jj] = make_float2(0.0f, 0.0f);
          if (y_out != nullptr) {
            const float* y = y_out + (int64_t)m * N + n;
            if ((N & 1) == 0 && n + 2 <= N) {
              yv[jj] = __ldg(reinterpret_cast<const float2*>(y));
            } else {
              if (n < N) yv[jj].x = __ldg(y);
              if (n + 1 < N) yv[jj].y = __ldg(y + 1);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < PF_EPI_J; ++jj) {
          const int j = j0 + jj, n = n0 + 8 * j + c_lo;
          float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i]), rs), cv[jj].x);
          float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]), rs), cv[jj].y);
          if (y_out != nullptr) {
            v0 = __fadd_rn(v0, yv[jj].x);
            v1 = __fadd_rn(v1, yv[jj].y);
          }
          if ((N & 1) == 0 && n + 2 <= N) {
            *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
          } else {
            if (n < N) o[n] = v0;
            if (n + 1 < N) o[n + 1] = v1;
          }
        }
      }
    }
    return;
  }
  __syncthreads();  // every tile read: the partials take the shared memory over
  int* red = reinterpret_cast<int*>(gbase);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < PF_BN / 8; ++j)
      *reinterpret_cast<int2*>(red + (r_lo + 8 * i) * PF_RED_LD + 8 * j + c_lo) =
          make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  cluster.sync();
  cluster_sum(cluster, red, 1, PF_BM, PF_BN, PF_RED_LD, m0, n0, M, tid, PF_THREADS,
              [&](int m, int n, const int4& sum) {
                store_scaled(out, m, n, sum, row_scale, col_scale, N, y_out);
              });
  cluster.sync();
}

// ------------------------------------------------------------ launches

MmKind kind_i8(int M) {
  if (M <= DECODE_MAX_M) {
    const int mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
    return {0, mt, 8 * mt, DEC_BN};
  }
  return {1, PF_BM, PF_BM, PF_BN};
}

// Whether kind k's kernel reads f32 x and quantizes it itself (the fused
// entry point only): decode up to DEC_F32_MAX_M rows a block. Elsewhere a
// first pass quantizes x into the scratch, and the kernel reads int8 x as
// the plain variant's does.
bool f32_x(const MmKind& k, bool fused) {
  return fused && k.design == 0 && k.rows <= DEC_F32_MAX_M;
}

template <typename F> auto with_kernel(const MmKind& k, bool f32x, F f) {
  if (k.design == 1) return f(i8_prefill, PF_THREADS, PfSmem::bytes);
  switch (k.tmpl) {
    case 1:
      return f32x ? f(i8_decode<true, 1>, DEC_THREADS, DecSmem<true, 1>::bytes)
                  : f(i8_decode<false, 1>, DEC_THREADS, DecSmem<false, 1>::bytes);
    case 2:
      return f32x ? f(i8_decode<true, 2>, DEC_THREADS, DecSmem<true, 2>::bytes)
                  : f(i8_decode<false, 2>, DEC_THREADS, DecSmem<false, 2>::bytes);
    default:
      return f32x ? f(i8_decode<true, 4>, DEC_THREADS, DecSmem<true, 4>::bytes)
                  : f(i8_decode<false, 4>, DEC_THREADS, DecSmem<false, 4>::bytes);
  }
}

// Blocks of the kernel an SM holds, asked of the runtime once per kernel.
int resident(const MmKind& k, bool f32x) {
  static int n[2][4] = {};  // int8 or f32 x; decode MT 1, 2, 4; prefill
  int& r = n[f32x][k.design ? 3 : k.tmpl / 2];
  if (r == 0)
    r = with_kernel(k, f32x, [](auto kernel, int threads, size_t smem) {
      return blocks_per_sm(kernel, smem, threads);
    });
  return r;
}

MmPlan plan_i8(int M, int N, int K, bool fused) {
  const MmKind k = kind_i8(M);
  // decode: each warp at least two slices of 32 K rows, so K splits no
  // finer than 256 rows; prefill: each split at least 4 steps of 128 rows
  const int min_k = k.design ? 4 * PF_BK : 8 * DEC_P;
  return plan_split(k, M, N, max(1, (K + min_k - 1) / min_k), resident(k, f32_x(k, fused)));
}

int launch(bool fused, const void* xin, const void* codes, const void* row_scale,
           const void* col_scale, const void* y_out, void* scratch, void* out, int M, int N,
           int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_i8(M, N, K, fused);
  const bool f32x = f32_x(p.kind, fused);
  auto rs = static_cast<const float*>(row_scale);
  if (fused && !f32x) {  // quantize x once; the kernel reads it as int8
    const int64_t want = ((int64_t)M * ((K + 3) / 4) + 255) / 256, cap = 16 * sm_count();
    const int blocks = (int)(want < cap ? want : cap);
    i8_quantize_rows<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xin), rs, static_cast<int8_t*>(scratch), M, K);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    xin = scratch;
  }
  return with_kernel(p.kind, f32x, [&](auto kernel, int threads, size_t smem) {
    return launch_cluster(kernel, p.grid, p.split, threads, smem, stream, xin,
                          static_cast<const uint8_t*>(codes), rs,
                          static_cast<const float*>(col_scale),
                          static_cast<const float*>(y_out), static_cast<float*>(out), M, N, K);
  });
}

}  // namespace

// scratch: int8 (M, K), written by the first pass where the kernel reads int8 x
extern "C" int qt_matmul_int8_fused(const void* x, const void* codes, const void* row_scale,
                                    const void* col_scale, const void* y_out, void* scratch,
                                    void* out, int M, int N, int K, void* stream) {
  return launch(true, x, codes, row_scale, col_scale, y_out, scratch, out, M, N, K, stream);
}

extern "C" int qt_matmul_int8(const void* xq, const void* codes, const void* row_scale,
                              const void* col_scale, void* out, int M, int N, int K,
                              void* stream) {
  return launch(false, xq, codes, row_scale, col_scale, nullptr, nullptr, out, M, N, K, stream);
}

// The launch at (M, N, K) of the fused (fused != 0) or plain-variant entry
// point, for a report (report_plan says what out[11] holds)
extern "C" int qt_matmul_int8_design(int M, int N, int K, int fused, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_i8(M, N, K, fused != 0);
  const bool f32x = f32_x(p.kind, fused != 0);
  return with_kernel(p.kind, f32x, [&](auto kernel, int, size_t smem) {
    return report_plan(p, kernel, smem, resident(p.kind, f32x),
                       p.kind.design ? PF_STAGES : DEC_STAGES, out);
  });
}
