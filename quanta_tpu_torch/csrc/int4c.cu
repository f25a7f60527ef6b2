// int4c matmul for Hopper (sm_90a): int4 weights on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/int4c.py:matmul_int4c_kernel
// (_mm_i4c_kernel). It computes
//
//   out[m, n] = (float)acc[m, n] * row_scale[m] * col_scale[n],
//   acc = xq[:, :K2] @ (lo - 8) + xq[:, K2:] @ (hi - 8)   (int32, exact)
//
// for int8 activations xq (M, 2*K2) and split_k-packed weight codes
// (K2, N) biased by +8 (the low nibble of byte (k, n) is row k, the high
// nibble row k + K2). The int32 sum is exact in any order and the epilogue
// is two f32 multiplies in that order, so the result equals the plain
// version bit for bit. Rows, columns and packed rows past the edges are
// masked: x reads zeros there, so whatever a masked code unpacks to
// multiplies 0.
//
// What bounds it on the H100, and the two designs, chosen by M inside the
// one entry point (the structure of matmul_4bit.cu's, over the launch side
// of splitk_sm90.cuh):
//   - decode (M <= DECODE_MAX_M: greedy decode and the serve windows at M =
//     slots) is bound by memory: 0.5 B a weight plus 4 B a column scale,
//     against 3.35 TB/s. mma.sync m16n8k32 s8 -> s32 with W^T as A (16
//     columns of W x 32 K values) and x^T as the n8 operand (8 rows of x).
//     A slice of 16 packed rows is one k32 of the mma: K rows kp..kp+15
//     from the low nibbles, K2+kp..K2+kp+15 from the high ones, so the
//     same code bytes give both halves of the A fragment. Each of a
//     block's 4 warps streams its own slices (16 packed rows x 64 columns
//     and their two runs of x) through a cp.async ring of DEC_STAGES slots;
//     K is split over a cluster of S blocks where the N / 64 grid leaves SMs
//     idle (pick_split), and the int32 partials of the 4 warps and the S
//     blocks are summed through distributed shared memory (cluster_sum).
//   - prefill (M > DECODE_MAX_M: decode_bench's and serve's prefills at M =
//     1024) is bound by the int8 tensor cores: 2*M*K*N operations at 1,979
//     TOP/s. int8 wgmma m64n128k32, both operands K-major (the only layout
//     wgmma takes for 8-bit types): 128 x 128 output tiles, two consumer
//     warpgroups of 64 rows; a cp.async ring of PF_STAGES slots holds x
//     tiles (a swizzled Tile<64> row is 128 int8: x[m, kp:kp+64] then
//     x[m, K2+kp:K2+kp+64]) and raw slabs of 64 packed rows x 128 columns;
//     each step the block unpacks one slab into an int8 Tile (128 rows of
//     W's columns, each 128 K values in the x tile's order; double
//     buffered) while the previous step's wgmma runs. K splits over a
//     cluster as in the decode design.
// Unpacking. Codes are (K2, N) with N contiguous, but both products want K
// contiguous for each column of W. A thread reads 4 packed rows x 4 columns
// as four 32-bit words, transposes them with __byte_perm (transpose4x4) to
// four words of one column and 4 packed rows each, and unbiases 4 nibbles
// at a time (s8x4_lo, s8x4_hi). The decode design does this in registers,
// straight into the mma's A operand; the prefill design writes the words
// into the swizzled B tile, 8 bytes at a time.
//
// Tried on the H100 (kernel_sweep.py --what i4c, the TinyLlama-1.1B (K,
// N); PERF.md): decode beats prefill at M = 32 at four of five shapes
// ((2048, 5632) 14.9 against 16.7 us; not lm_head, 48.9 against 41.4) and
// loses at M = 64 at four of five, so the split stays at 32; a decode ring
// of 4 stages ties 3; a prefill ring of 4 (one block an SM, not two) loses
// up to 30% ((2048, 5632) at M = 1024: 74.7 against 62.8 us), and 256-row
// prefill tiles (two 64-row x tiles a warpgroup, one block an SM) lose
// 10-40% (87.1 there).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant8_sm90.cuh"  // stage_codes16 (and sm90.cuh)
#include "int8_sm90.cuh"      // transpose4x4, store_scaled
#include "splitk_sm90.cuh"    // cluster_sum, MmKind, MmPlan, plan_split, mma_s8_16832

namespace {

// ------------------------------------------------------------ unpacking

// The 4 low nibbles of w minus their +8 bias, as 4 int8: the same bytes as
// __vsub4(w & 0x0F0F0F0F, 0x08080808) (adding 0x78 and flipping bit 7 takes
// 0..15 to -8..7, with no carry out of a byte).
__device__ __forceinline__ uint32_t s8x4_lo(uint32_t w) {
  return ((w & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t s8x4_hi(uint32_t w) { return s8x4_lo(w >> 4); }

// x[m, h K2 + j .. h K2 + j + 16) of int8 x (M, 2 K2) into shared memory
// (`dst`, generic, and its shared address `dst_s`): half h = 0 reads the
// columns of the low nibbles, h = 1 those of the high ones. cp.async where
// the 16 values are in range and aligned, else byte by byte; zeros past M
// and past the half's K2 columns (never the other half's).
__device__ __forceinline__ void stage_x_half16(unsigned char* dst, uint32_t dst_s,
                                               const int8_t* __restrict__ x, int m, int h, int j,
                                               int M, int K2) {
  const int8_t* src = x + (int64_t)m * 2 * K2 + (int64_t)h * K2 + j;
  if (m >= M || j >= K2) {
    cp_async16(dst_s, x, 0);
  } else if ((K2 & 15) == 0) {
    cp_async16(dst_s, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = j + e < K2 ? src[e] : 0;
  }
}

// ------------------------------------------------------------- decode

constexpr int DECODE_MAX_M = 32;
constexpr int DEC_STAGES = 3;
constexpr int DEC_THREADS = 128;
constexpr int DEC_BN = 64;       // columns of W a block
constexpr int DEC_P = 16;        // packed rows a slice: one k32 of the mma
constexpr int CODE_LD = 80;      // bytes of a staged code row: see code_slot
constexpr int X_LD = 16;         // bytes of a staged x row (16 values of one run)
constexpr int RED_LD = DEC_BN + 4;

// The slot of a slice's packed row r: lane (g, t) reads rows 4t..4t+3 at
// columns 32 p + 4 g, and rows 4t + i sit at slots 2t + i % 2 + 8 (i / 2),
// 80 bytes apart, so each of the 4 loads of a warp hits 32 banks.
__device__ __forceinline__ int code_slot(int r) {
  return 2 * (r / 4) + (r & 1) + 8 * ((r >> 1) & 1);
}

template <int MT> struct DecSmem {  // MT n8 tiles of x rows: M <= 8 * MT a block
  // a slot: 16 code rows, then x's two runs of 8 MT rows of 16 values
  static constexpr int X = DEC_P * CODE_LD;
  static constexpr int SLOT = X + 2 * 8 * MT * X_LD;
  static constexpr int RING = 4 * DEC_STAGES * SLOT;
  static constexpr int RED = 4 * 8 * MT * RED_LD * 4;  // int32 partials, after the loop
  static constexpr size_t bytes = RING > RED ? RING : RED;
};

// grid (S, N / 64, M / (8 MT)), clusters of S along x: rank r takes the
// slices [r * per, (r + 1) * per) of the packed rows, per = ceil(slices /
// S), and warp w of its block the slices w, w + 4, ... of those.
template <int MT>
__global__ void __launch_bounds__(DEC_THREADS)
i4c_decode(const int8_t* __restrict__ xq, const uint8_t* __restrict__ codes,
           const float* __restrict__ row_scale, const float* __restrict__ col_scale,
           float* __restrict__ out, int M, int N, int K2) {
  using SM = DecSmem<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.y * DEC_BN, m0 = blockIdx.z * 8 * MT;
  const int slices = (K2 + DEC_P - 1) / DEC_P, per = (slices + S - 1) / S;
  const int s_lo = min(slices, rank * per), s_hi = min(slices, s_lo + per);
  const int mine = s_hi - s_lo > warp ? (s_hi - s_lo - warp + 3) / 4 : 0;

  unsigned char* wring = smem + warp * DEC_STAGES * SM::SLOT;
  const uint32_t wring_s = smem_addr(wring);
  auto load = [&](int it, int st) {  // slice s_lo + warp + 4 it into slot st
    const int kp = DEC_P * (s_lo + warp + 4 * it);
    unsigned char* slot = wring + st * SM::SLOT;
    const uint32_t slot_s = wring_s + st * SM::SLOT;
#pragma unroll
    for (int i = lane; i < DEC_P * 4; i += 32) {  // 16 rows of 64 code bytes
      const int r = i / 4, c = (i % 4) * 16, off = code_slot(r) * CODE_LD + c;
      stage_codes16(slot + off, slot_s + off, codes, kp + r, n0 + c, K2, N);
    }
    for (int i = lane; i < 2 * 8 * MT; i += 32) {  // run i / (8 MT), x row i % (8 MT)
      const int off = SM::X + i * X_LD;
      stage_x_half16(slot + off, slot_s + off, xq, m0 + i % (8 * MT), i / (8 * MT), kp, M, K2);
    }
  };
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }

  // Lane (g, t) holds columns 32 p + 4 g + c of tile pair p: A row g of
  // tile 2 p + e is column 32 p + 4 g + 2 e, row g + 8 the next one. A
  // fragment: a0 = low nibbles of packed rows 4t..4t+3 of row g's column,
  // a1 the same of row g + 8's, a2 and a3 their high nibbles; b0 = x[8 i +
  // g, kp + 4t..], b1 = x[8 i + g, K2 + kp + 4t..]. acc[p][e][i]: tile 2 p +
  // e, x tile i.
  int acc[2][2][MT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
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
    for (int i = 0; i < MT; ++i) {
      b[i][0] = *reinterpret_cast<const uint32_t*>(slot + SM::X + (8 * i + g) * X_LD + 4 * t4);
      b[i][1] = *reinterpret_cast<const uint32_t*>(slot + SM::X + (8 * MT + 8 * i + g) * X_LD +
                                                   4 * t4);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t r[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint32_t*>(slot + code_slot(4 * t4 + q) * CODE_LD +
                                                  32 * p + 4 * g);
      transpose4x4(r, w);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t a[4] = {s8x4_lo(w[2 * e]), s8x4_lo(w[2 * e + 1]), s8x4_hi(w[2 * e]),
                               s8x4_hi(w[2 * e + 1])};
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
  for (int p = 0; p < 2; ++p)
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
                store_scaled(out, m, n, sum, row_scale, col_scale, N);
              });
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------------- prefill

constexpr int PF_BM = 128;       // rows of x a tile: two warpgroups of 64
constexpr int PF_STAGES = 3;     // the ring reloads a slot two steps after its products
constexpr int PF_THREADS = 256;
constexpr int PF_BN = 128, PF_P = 64;  // a step: 64 packed rows, 128 K values
constexpr int PF_RED_LD = PF_BN + 4;

// STAGES x 2 x tiles; 2 W tiles; STAGES code slabs
struct PfSmem {
  static constexpr uint32_t XT = Tile<64>::BYTES;      // 64 rows of 128 int8
  static constexpr uint32_t WT = 2 * Tile<64>::BYTES;  // 128 columns of W, 128 int8 of K each
  static constexpr uint32_t SLAB = PF_P * PF_BN;       // 64 packed rows of 128 bytes
  static constexpr uint32_t W0 = PF_STAGES * 2 * XT;   // the x tiles from the base
  static constexpr uint32_t C0 = W0 + 2 * WT;
  static constexpr uint32_t END = C0 + PF_STAGES * SLAB;
  static constexpr uint32_t RED = PF_BM * PF_RED_LD * 4;  // int32 partials, over the tiles
  static constexpr size_t bytes = (END > RED ? END : RED) + 1024;
};

// grid (S, N / 128, M / 128), clusters of S along x: rank r takes the steps
// [r * per, (r + 1) * per) of 64 packed rows. Warpgroup wg owns x tile wg.
__global__ void __launch_bounds__(PF_THREADS)
i4c_prefill(const int8_t* __restrict__ xq, const uint8_t* __restrict__ codes,
            const float* __restrict__ row_scale, const float* __restrict__ col_scale,
            float* __restrict__ out, int M, int N, int K2) {
  using SM = PfSmem;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  auto Xs = [&](int st, int i) { return base + (2 * st + i) * SM::XT; };
  auto Ws = [&](int i) { return base + SM::W0 + i * SM::WT; };
  auto slab = [&](int st) { return gbase + SM::C0 + st * SM::SLAB; };

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.y * PF_BN, m0 = blockIdx.z * PF_BM;
  const int steps = (K2 + PF_P - 1) / PF_P, per = (steps + S - 1) / S;
  const int t_lo = min(steps, rank * per), n_t = min(steps, t_lo + per) - t_lo;

  // The slab: packed row r's 16-byte chunk c at chunk c ^ (r / 8 % 8), so
  // the unpack's reads (8 row groups x 4 column groups a warp) hit 32 banks.
  auto load = [&](int t, int st) {  // step t_lo + t into slot st
    const int kp = (t_lo + t) * PF_P;
    for (int i = tid; i < PF_BM * 8; i += PF_THREADS) {  // x rows [m0, m0 + 128), 8 chunks a row
      const int r = i / 8, c = i % 8;
      const uint32_t dst = Xs(st, r / 64) + Tile<64>::offset(r % 64, c);
      stage_x_half16(gbase + (dst - base), dst, xq, m0 + r, c / 4, kp + 16 * (c % 4), M, K2);
    }
    unsigned char* sl = slab(st);
    for (int i = tid; i < PF_P * 8; i += PF_THREADS) {
      const int r = i / 8, c = i % 8, off = r * PF_BN + ((c ^ ((r >> 3) & 7)) << 4);
      stage_codes16(sl + off, smem_addr(sl) + off, codes, kp + r, n0 + 16 * c, K2, N);
    }
  };
  // Thread: columns 4 cq .. 4 cq + 3 of the block's 128 and packed rows 8 rg
  // .. 8 rg + 7 of the slab. Column n's B row holds K values 8 rg .. 8 rg +
  // 7 (low nibbles) at byte 8 rg and 64 + 8 rg (high ones): one 8-byte
  // store each, which a warp spreads over every bank.
  const int rg = lane & 7, cq = 4 * (tid / 32) + (lane >> 3);
  auto unpack = [&](uint32_t wt, const unsigned char* sl) {
    uint32_t r[2][4], w[2][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      r[q / 4][q % 4] = *reinterpret_cast<const uint32_t*>(
          sl + (8 * rg + q) * PF_BN + (((cq >> 2) ^ rg) << 4) + 4 * (cq & 3));
    transpose4x4(r[0], w[0]);
    transpose4x4(r[1], w[1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 4 * cq + c;
      const uint32_t lo = wt + Tile<64>::offset(n, rg >> 1) + 8 * (rg & 1);
      const uint32_t hi = wt + Tile<64>::offset(n, 4 + (rg >> 1)) + 8 * (rg & 1);
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(lo), "r"(s8x4_lo(w[0][c])),
                   "r"(s8x4_lo(w[1][c]))
                   : "memory");
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(hi), "r"(s8x4_hi(w[0][c])),
                   "r"(s8x4_hi(w[1][c]))
                   : "memory");
    }
  };
#pragma unroll
  for (int st = 0; st < PF_STAGES - 2; ++st) {
    if (st < n_t) load(st, st);
    cp_async_commit();
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<PF_STAGES - 3>();  // step t has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the products of t - 2 are done
    if (t + PF_STAGES - 2 < n_t) load(t + PF_STAGES - 2, (t + PF_STAGES - 2) % PF_STAGES);
    cp_async_commit();
    unpack(Ws(t % 2), slab(t % PF_STAGES));  // W tile t % 2 was last read by the products of t - 2
    fence_proxy_async();
    __syncthreads();  // the W tile is whole
    const uint32_t xt = Xs(t % PF_STAGES, wg), wt = Ws(t % 2);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // k32 slices 0-1 the low nibbles' run, 2-3 the high one's
      wgmma_ss_s8(acc, Tile<64>::k_major(xt, kk), Tile<64>::k_major(wt, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the products of t - 1 are done; those of t run on
    fence_regs(acc);
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
#pragma unroll
      for (int j = 0; j < PF_BN / 8; ++j) {
        const int n = n0 + 8 * j + c_lo;
        const int a0 = acc[4 * j + 2 * i], a1 = acc[4 * j + 2 * i + 1];
        const float v0 =
            n < N ? __fmul_rn(__fmul_rn(__int2float_rn(a0), rs), __ldg(col_scale + n)) : 0.0f;
        const float v1 =
            n + 1 < N ? __fmul_rn(__fmul_rn(__int2float_rn(a1), rs), __ldg(col_scale + n + 1))
                      : 0.0f;
        if ((N & 1) == 0 && n + 2 <= N) {
          *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
        } else {
          if (n < N) o[n] = v0;
          if (n + 1 < N) o[n + 1] = v1;
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
                store_scaled(out, m, n, sum, row_scale, col_scale, N);
              });
  cluster.sync();
}

// ------------------------------------------------------------ launches

MmKind kind_i4c(int M) {
  if (M <= DECODE_MAX_M) {
    const int mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
    return {0, mt, 8 * mt, DEC_BN};
  }
  return {1, PF_BM, PF_BM, PF_BN};
}

template <typename F> auto with_kernel(const MmKind& k, F f) {
  if (k.design == 1) return f(i4c_prefill, PF_THREADS, PfSmem::bytes);
  switch (k.tmpl) {
    case 1: return f(i4c_decode<1>, DEC_THREADS, DecSmem<1>::bytes);
    case 2: return f(i4c_decode<2>, DEC_THREADS, DecSmem<2>::bytes);
    default: return f(i4c_decode<4>, DEC_THREADS, DecSmem<4>::bytes);
  }
}

// Blocks of the kind's kernel an SM holds, asked of the runtime once per kernel.
int resident(const MmKind& k) {
  static int n[4] = {};  // decode MT 1, 2, 4; prefill
  int& r = n[k.design ? 3 : k.tmpl / 2];
  if (r == 0)
    r = with_kernel(k, [](auto kernel, int threads, size_t smem) {
      return blocks_per_sm(kernel, smem, threads);
    });
  return r;
}

MmPlan plan_i4c(int M, int N, int K2) {
  const MmKind k = kind_i4c(M);
  // decode: each warp at least two slices of 16 packed rows, so K splits
  // no finer than 128 packed rows; prefill: each split at least 4 steps of
  // 64 packed rows
  const int min_kp = k.design ? 4 * PF_P : 8 * DEC_P;
  return plan_split(k, M, N, max(1, (K2 + min_kp - 1) / min_kp), resident(k));
}

}  // namespace

extern "C" int qt_matmul_int4c(const void* xq, const void* codes, const void* row_scale,
                               const void* col_scale, void* out, int M, int N, int K2,
                               void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_i4c(M, N, K2);
  return with_kernel(p.kind, [&](auto kernel, int threads, size_t smem) {
    return launch_cluster(kernel, p.grid, p.split, threads, smem, stream,
                          static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(row_scale),
                          static_cast<const float*>(col_scale), static_cast<float*>(out), M, N,
                          K2);
  });
}

// The launch at (M, N, K2), for a report (report_plan says what out[11] holds)
extern "C" int qt_matmul_int4c_design(int M, int N, int K2, int* out) {
  if (M <= 0 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_i4c(M, N, K2);
  return with_kernel(p.kind, [&](auto kernel, int, size_t smem) {
    return report_plan(p, kernel, smem, resident(p.kind),
                       p.kind.design ? PF_STAGES : DEC_STAGES, out);
  });
}

extern "C" const char* qt_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
