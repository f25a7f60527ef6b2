// Fused 4-bit dequant-matmul for Hopper (sm_90a), bf16 or f32 activations.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_4bit
// (_mm4_kernel). It computes
//
//   out = x[:, :K2] @ deq(lo) + x[:, K2:] @ deq(hi)
//
// for split_k-packed codes (K2 = K_pad/2 packed rows; the low nibble of
// byte (k, n) is row k, the high nibble row k + K2), where
// deq(code) = T(levels[code] * scale[row / block, n]): one f32 multiply
// rounded once, then rounded to the activation type T before the product,
// as the TPU kernel rounds `w.astype(x.dtype)`, through a 16-entry level
// table that serves nf4a, nf4, int4 and fp4 (int4a's zero-point term is
// added by the wrapper outside the kernel). Products accumulate in f32.
// Rows, columns and packed rows past the edges are masked; any block that
// divides K_pad.
//
// What bounds it on the H100, and the two bf16 designs, chosen by M (the
// structure of matmul_8bit.cu's, over dequant4_sm90.cuh and the launch
// side of splitk_sm90.cuh):
//   - decode (M <= DECODE_MAX_M: greedy decode and the serve engine at M =
//     slots) is bound by memory: every weight streams once at 0.5 B plus
//     4 B per 64-weight scale (0.5625 B a weight) against 3.35 TB/s. Split
//     K: a cluster of S blocks per 64 columns of W, S from the blocks of
//     the kernel an SM holds (pick_split). Each of a block's 4 warps
//     streams its own slices of 16 packed rows, with their two runs of x
//     and two scale rows, through a cp.async ring of DEC_STAGES slots (no
//     block barrier in the loop); a slice is two k16 runs of K, [kp, kp +
//     16) from the low nibbles and [K2 + kp, K2 + kp + 16) from the high
//     ones, each dequantized in registers straight into the A operand of
//     mma.sync m16n8k16 (W^T as A, x^T as the n8 operand), f32 sums. The
//     partials of the 4 warps and the S blocks are summed in a fixed order
//     (rank, then warp) through distributed shared memory.
//   - prefill and training (M > DECODE_MAX_M: serve prefill, the forward
//     of every nf4 QLoRA step at M = batch x seq) are bound by the tensor
//     cores: 2*M*K*N flops at 989 TFLOP/s. 128 x 128 output tiles, two
//     consumer warpgroups of 64 rows; a cp.async ring of PF_STAGES slots
//     holds x tiles (a swizzled
//     Tile<64> whose chunks 0-3 are x[:, kp:kp+32] and 4-7 are
//     x[:, K2+kp:K2+kp+32]), raw slabs of 32 packed rows x 128 columns and
//     their two scale rows; each step the block dequantizes one slab into
//     a bf16 Tile<128> of 64 K rows (double buffered) while the previous
//     step's wgmma runs, then issues wgmma with x K-major and W MN-major
//     (wgmma_ss_tb). Where the tile grid leaves SMs idle, K is split over
//     a cluster as in the decode design.
// Packed weights never reach device memory dequantized. Both read the
// level table from 32 interleaved copies in shared memory (2 KB).
// Tried on the H100 (each variant a build with the constants below edited,
// timed by kernel_sweep.py; PERF.md), nf4a at the five TinyLlama (K, N):
// decode beats prefill at M = 32 ((2048, 2048) 15.3 against 19.1 us,
// w_down 30.1 against 44.9); a decode ring of 3 stages matches 4 at M = 8
// and beats it at 32 (4 stages hold 2 blocks an SM, not 3: (2048, 2048)
// 15.3 against 20.5), and 6 loses (lm_head at M = 8: 44.2, 42.3, 56.5 us);
// the prefill's 128-row tile matches (within 2%) or beats a 256-row one (matmul_8bit's
// choice above M = 128) from M = 256 to 2048 ((2048, 5632) at M = 2048:
// 251.7 against 259.5 us; 256 rows need 186 registers a thread and hold
// one block an SM, 128 rows 122 and two).
//
// f32 (GPT-2 small at its own f32 through generate, serve and eval; the
// accuracy proxy's perplexity at M = 8192): the same two designs on the CUDA
// cores, chosen by M inside qt_matmul_4bit_f32 (fma_sm90.cuh): split-K FMA
// decode up to M = 32, each lane dequantizing its weights once and using
// each for every row of x, summed through distributed shared memory; a
// register-tiled FMA GEMM above (128 x 128 tiles, 8 x 8 outputs a thread,
// each step's code slab dequantized once into an f32 tile). f32 products and
// sums only, in a fixed order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant4_sm90.cuh"  // LV4_BYTES, fill_levels4, stage_*, dequant4_slab
#include "fma_sm90.cuh"       // the f32 designs: mmf_decode, mmf_prefill, plan_mmf
#include "splitk_sm90.cuh"    // cluster_sum_store, MmKind, MmPlan, plan_split, mma_bf16_16816

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ bf16: decode

constexpr int DECODE_MAX_M = 32;
constexpr int DEC_STAGES = 3;
constexpr int DEC_THREADS = 128;
constexpr int DEC_BN = 64;       // columns of W a block
constexpr int DEC_P = 16;        // packed rows a slice: two k16 runs of K
constexpr int CODE_LD = 80;      // bytes of a staged code row: 8-byte reads of a quad's rows miss each other's banks
constexpr int X_LD = 48;         // bytes of a staged x row (16 bf16): conflict-free 4-byte reads
constexpr int RED_LD = DEC_BN + 4;

template <int MT> struct DecSmem {  // MT n8 tiles of x rows: M <= 8 * MT a block
  // a slot: 16 code rows, their two scale rows (low, high half; a block of
  // 16 rows or more), then x's two runs of 8 MT rows of 16 values
  static constexpr int SROW = DEC_P * CODE_LD, X = SROW + 2 * DEC_BN * 4;
  static constexpr int SLOT = X + 2 * 8 * MT * X_LD;
  static constexpr int RING = 4 * DEC_STAGES * SLOT;
  static constexpr int RED = 4 * 8 * MT * RED_LD * 4;  // f32 partials, after the loop
  static constexpr size_t bytes = LV4_BYTES + (RING > RED ? RING : RED);
};

// grid (S, N / 64, M / (8 MT)), clusters of S along x: rank r takes the
// slices [r * per, (r + 1) * per) of the packed rows, per = ceil(slices /
// S), and warp w of its block the slices w, w + 4, ... of those.
template <int MT>
__global__ void __launch_bounds__(DEC_THREADS)
mm4_decode(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ levels,
           bf16* __restrict__ out, int M, int N, int K2, int block) {
  using SM = DecSmem<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lv = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + LV4_BYTES;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.y * DEC_BN, m0 = blockIdx.z * 8 * MT;
  const int slices = (K2 + DEC_P - 1) / DEC_P, per = (slices + S - 1) / S;
  const int s_lo = min(slices, rank * per), s_hi = min(slices, s_lo + per);
  const int mine = s_hi - s_lo > warp ? (s_hi - s_lo - warp + 3) / 4 : 0;
  // one scale row a run, staged with it: both runs stay inside one block
  const bool one_srow = block % DEC_P == 0 && K2 % DEC_P == 0;
  fill_levels4<DEC_THREADS>(lv, levels, tid);

  unsigned char* wring = ring + warp * DEC_STAGES * SM::SLOT;
  const uint32_t wring_s = smem_addr(wring);
  auto load = [&](int it, int st) {  // slice s_lo + warp + 4 it into slot st
    const int kp = DEC_P * (s_lo + warp + 4 * it);
    unsigned char* slot = wring + st * SM::SLOT;
    const uint32_t slot_s = wring_s + st * SM::SLOT;
#pragma unroll
    for (int i = lane; i < DEC_P * 4; i += 32) {  // 16 rows of 64 code bytes
      const int r = i / 4, c = (i % 4) * 16;
      stage_codes16(slot + r * CODE_LD + c, slot_s + r * CODE_LD + c, codes, kp + r, n0 + c, K2,
                    N);
    }
    for (int i = lane; i < 2 * 16 * MT; i += 32) {  // two runs of 8 MT rows of 16 x values
      const int h = i / (16 * MT), r = (i % (16 * MT)) / 2, c = (i % 2) * 8;
      const int off = SM::X + (8 * MT * h + r) * X_LD + 2 * c;
      stage_x_half8(slot + off, slot_s + off, x, m0 + r, h, kp + c, M, K2);
    }
    if (one_srow) {  // lanes 0-15 the low half's scale row, 16-31 the high half's
      const int h = lane / 16, off = SM::SROW + h * DEC_BN * 4;
      stage_scale_row(reinterpret_cast<float*>(slot + off), slot_s + off, scales,
                      (h * K2 + kp) / block, n0, N, DEC_BN / 4, lane % 16);
    }
  };
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }
  __syncthreads();  // the level table

  // A operand (W^T, 16 columns of W x 16 rows of K) of tile j: its row g
  // is column 8g + 2j of the block's 64, row g + 8 column 8g + 2j + 1, so a
  // lane reads 8 adjacent code bytes of each of its packed rows 2 t4,
  // 2 t4 + 1, 2 t4 + 8, 2 t4 + 9, each byte two weights: K row kp + r (low
  // nibble) and K2 + kp + r (high). acc[j][i]: columns 8g + 2j (+1), x
  // rows 8i + 2 t4 (+1).
  float acc[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.0f;

  for (int it = 0; it < mine; ++it) {
    cp_async_wait<DEC_STAGES - 2>();  // slice it has landed
    __syncwarp();                     // ... for every lane; and slot it - 1 is free
    if (it + DEC_STAGES - 1 < mine) load(it + DEC_STAGES - 1, (it + DEC_STAGES - 1) % DEC_STAGES);
    cp_async_commit();
    const unsigned char* slot = wring + (it % DEC_STAGES) * SM::SLOT;
    const int kp = DEC_P * (s_lo + warp + 4 * it);

    uint2 raw[4];  // packed rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9; columns 8g + e
#pragma unroll
    for (int q = 0; q < 4; ++q)
      raw[q] = *reinterpret_cast<const uint2*>(slot + (2 * t4 + (q & 1) + 8 * (q >> 1)) * CODE_LD +
                                               8 * g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the low nibbles' run of K, then the high one's
      float s[8];
      if (one_srow) {  // 16 | block, 16 | K2: no slice runs past K2
        const float* sr = reinterpret_cast<const float*>(slot + SM::SROW) + h * DEC_BN + 8 * g;
        const float4 a = *reinterpret_cast<const float4*>(sr), b = *reinterpret_cast<const float4*>(sr + 4);
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
        s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
      }
      float w[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 2 * t4 + (q & 1) + 8 * (q >> 1);
        // zeros past K2 in either half
        if (!one_srow) load_scales8(s, scales, h * K2 + kp + r, n0 + 8 * g, (h + 1) * K2, N, block);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t code = ((e < 4 ? raw[q].x : raw[q].y) >> (8 * (e & 3) + 4 * h)) & 0xF;
          w[q][e] = __fmul_rn(level(lv, code, lane), s[e]);
        }
      }
      uint32_t b[MT][2];
      const unsigned char* xs = slot + SM::X + 8 * MT * h * X_LD;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        b[i][0] = *reinterpret_cast<const uint32_t*>(xs + (8 * i + g) * X_LD + 4 * t4);
        b[i][1] = *reinterpret_cast<const uint32_t*>(xs + (8 * i + g) * X_LD + 16 + 4 * t4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {pack_bf16(w[0][2 * j], w[1][2 * j]),
                               pack_bf16(w[0][2 * j + 1], w[1][2 * j + 1]),
                               pack_bf16(w[2][2 * j], w[3][2 * j]),
                               pack_bf16(w[2][2 * j + 1], w[3][2 * j + 1])};
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16_16816(acc[j][i], a, b[i][0], b[i][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is out of the ring: the partials take it over

  float* red = reinterpret_cast<float*>(ring) + warp * 8 * MT * RED_LD;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float* p = red + (8 * i + 2 * t4) * RED_LD + 8 * g + 2 * j;
      *reinterpret_cast<float2*>(p) = make_float2(acc[j][i][0], acc[j][i][2]);
      *reinterpret_cast<float2*>(p + RED_LD) = make_float2(acc[j][i][1], acc[j][i][3]);
    }
  cluster.sync();  // every block's partials are in its shared memory
  cluster_sum_store(cluster, reinterpret_cast<float*>(ring), 4, 8 * MT, DEC_BN, RED_LD, out, m0,
                    n0, M, N, tid, DEC_THREADS);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------ bf16: prefill

constexpr int PF_BM = 128;       // rows of x a tile
constexpr int PF_STAGES = 3;     // the ring reloads a slot two steps after its products
constexpr int PF_THREADS = 256;  // two consumer warpgroups, BM / 2 rows of the tile each
constexpr int PF_BN = 128, PF_BKP = 32;  // a step: 32 packed rows, 64 rows of K
constexpr int PF_RED_LD = PF_BN + 4;

// level table; STAGES x (BM / 64) x tiles; 2 W tiles; STAGES x (code slab, 2 scale rows)
template <int BM> struct PfSmem {
  static_assert(BM == 128 || BM == 256, "128 or 256 rows a tile");
  static constexpr int XTILES = BM / 64;  // 64-row x tiles a step
  static constexpr uint32_t XT = Tile<64>::BYTES, WT = Tile<128>::BYTES;
  static constexpr uint32_t SROW = PF_BKP * PF_BN, SLAB = SROW + 2 * PF_BN * 4;
  static constexpr uint32_t X0 = LV4_BYTES;                  // 1024-aligned from the base
  static constexpr uint32_t W0 = X0 + PF_STAGES * XTILES * XT;
  static constexpr uint32_t C0 = W0 + 2 * WT;
  static constexpr uint32_t END = C0 + PF_STAGES * SLAB;
  static constexpr uint32_t RED = BM * PF_RED_LD * 4;        // f32 partials, over the tiles
  static constexpr size_t bytes = (END > X0 + RED ? END : X0 + RED) + 1024;
};

// grid (S, N / 128, M / BM), clusters of S along x: rank r takes the steps
// [r * per, (r + 1) * per) of 32 packed rows. Each warpgroup owns BM / 128
// of the tile's 64-row x tiles (m64 products a k16 slice).
template <int BM>
__global__ void __launch_bounds__(PF_THREADS)
mm4_prefill(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
            const float* __restrict__ scales, const float* __restrict__ levels,
            bf16* __restrict__ out, int M, int N, int K2, int block) {
  using SM = PfSmem<BM>;
  constexpr int XTILES = SM::XTILES, MT = XTILES / 2;  // x tiles a step; a warpgroup's
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  float* lv = reinterpret_cast<float*>(gbase);
  auto Xs = [&](int st, int i) { return base + SM::X0 + (XTILES * st + i) * SM::XT; };
  auto Ws = [&](int i) { return base + SM::W0 + i * SM::WT; };
  auto slab = [&](int st) { return gbase + SM::C0 + st * SM::SLAB; };
  // one scale row a half-slab, staged with it: both runs stay inside one block
  const bool one_srow = block % PF_BKP == 0 && K2 % PF_BKP == 0;
  auto srow = [&](int st) { return reinterpret_cast<float*>(slab(st) + SM::SROW); };

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.y * PF_BN, m0 = blockIdx.z * BM;
  const int steps = (K2 + PF_BKP - 1) / PF_BKP, per = (steps + S - 1) / S;
  const int t_lo = min(steps, rank * per), n_t = min(steps, t_lo + per) - t_lo;
  fill_levels4<PF_THREADS>(lv, levels, tid);

  auto load = [&](int t, int st) {  // step t_lo + t into slot st
    const int kp = (t_lo + t) * PF_BKP;
    for (int i = tid; i < BM * 8; i += PF_THREADS) {  // x rows [m0, m0 + BM), 8 chunks a row
      const int r = i / 8, c = i % 8;
      const uint32_t dst = Xs(st, r / 64) + Tile<64>::offset(r % 64, c);
      stage_x_half8(gbase + (dst - base), dst, x, m0 + r, c / 4, kp + 8 * (c % 4), M, K2);
    }
    stage_code_slab4(slab(st), smem_addr(slab(st)), codes, kp, n0, K2, N, tid, PF_THREADS);
    if (one_srow && tid < 64) {  // threads 0-31 the low half's scale row, 32-63 the high one's
      float* dst = srow(st) + (tid / 32) * PF_BN;
      stage_scale_row(dst, smem_addr(dst), scales, ((tid / 32) * K2 + kp) / block, n0, N,
                      PF_BN / 4, tid % 32);
    }
  };
#pragma unroll
  for (int st = 0; st < PF_STAGES - 2; ++st) {
    if (st < n_t) load(st, st);
    cp_async_commit();
  }

  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<PF_STAGES - 3>();  // step t has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the products of t - 2 are done (and the level table is in)
    if (t + PF_STAGES - 2 < n_t) load(t + PF_STAGES - 2, (t + PF_STAGES - 2) % PF_STAGES);
    cp_async_commit();
    // W tile t % 2 was last read by the products of t - 2
    dequant4_slab<PF_THREADS>(Ws(t % 2), slab(t % PF_STAGES),
                              one_srow ? srow(t % PF_STAGES) : nullptr, scales, lv,
                              (t_lo + t) * PF_BKP, n0, K2, N, block, tid);
    fence_proxy_async();
    __syncthreads();  // the W tile is whole
    const uint32_t wt = Ws(t % 2);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t xt = Xs(t % PF_STAGES, wg * MT + mt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k16 slices 0-1 the low nibbles' run, 2-3 the high one's
        wgmma_ss_tb<128>(acc[mt], Tile<64>::k_major(xt, kk), Tile<128>::mn_major(wt, kk), 1);
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

  // accumulator mt: row 64 (MT wg + mt) + 16 warp + lane / 4 + 8 i,
  // column 8 j + 2 (lane % 4) + c
  const int r_lo = 64 * MT * wg + 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
  if (S == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + r_lo + 64 * mt + 8 * i;
        if (m >= M) continue;
        bf16* o = out + (int64_t)m * N + n0 + c_lo;
#pragma unroll
        for (int j = 0; j < PF_BN / 8; ++j) {
          const int n = n0 + 8 * j + c_lo;
          const float v0 = acc[mt][4 * j + 2 * i], v1 = acc[mt][4 * j + 2 * i + 1];
          if ((N & 1) == 0 && n + 2 <= N) {
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < N) o[8 * j] = __float2bfloat16_rn(v0);
            if (n + 1 < N) o[8 * j + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    return;
  }
  __syncthreads();  // every tile read: the partials take the shared memory over
  float* red = reinterpret_cast<float*>(gbase + SM::X0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < PF_BN / 8; ++j)
        *reinterpret_cast<float2*>(red + (r_lo + 64 * mt + 8 * i) * PF_RED_LD + 8 * j + c_lo) =
            make_float2(acc[mt][4 * j + 2 * i], acc[mt][4 * j + 2 * i + 1]);
  cluster.sync();
  cluster_sum_store(cluster, red, 1, BM, PF_BN, PF_RED_LD, out, m0, n0, M, N, tid, PF_THREADS);
  cluster.sync();
}

// ------------------------------------------------------ bf16: launches

MmKind kind_mm4(int M) {
  if (M <= DECODE_MAX_M) {
    const int mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
    return {0, mt, 8 * mt, DEC_BN};
  }
  return {1, PF_BM, PF_BM, PF_BN};
}

template <typename F> auto with_kernel(const MmKind& k, F f) {
  if (k.design == 1) return f(mm4_prefill<PF_BM>, PF_THREADS, PfSmem<PF_BM>::bytes);
  switch (k.tmpl) {
    case 1: return f(mm4_decode<1>, DEC_THREADS, DecSmem<1>::bytes);
    case 2: return f(mm4_decode<2>, DEC_THREADS, DecSmem<2>::bytes);
    default: return f(mm4_decode<4>, DEC_THREADS, DecSmem<4>::bytes);
  }
}

// Blocks of the kind's kernel an SM holds (registers, shared memory), asked
// of the runtime once per kernel.
int resident(const MmKind& k) {
  static int n[4] = {};  // decode MT 1, 2, 4; prefill
  int& r = n[k.design ? 3 : k.tmpl / 2];
  if (r == 0)
    r = with_kernel(k, [](auto kernel, int threads, size_t smem) {
      return blocks_per_sm(kernel, smem, threads);
    });
  return r;
}

MmPlan plan_mm4(int M, int N, int K2) {
  const MmKind k = kind_mm4(M);
  // decode: each warp at least two slices of 16 packed rows, so K splits
  // no finer than 128 packed rows; prefill: each split at least 4 steps of
  // 32 packed rows
  const int min_kp = k.design ? 4 * PF_BKP : 8 * DEC_P;
  return plan_split(k, M, N, max(1, (K2 + min_kp - 1) / min_kp), resident(k));
}

}  // namespace

extern "C" int qt_matmul_4bit_bf16(const void* x, const void* codes, const void* scales,
                                   const void* levels, void* out, int M, int N, int K2,
                                   int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm4(M, N, K2);
  return with_kernel(p.kind, [&](auto kernel, int threads, size_t smem) {
    return launch_cluster(kernel, p.grid, p.split, threads, smem, stream,
                          static_cast<const bf16*>(x), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(scales), static_cast<const float*>(levels),
                          static_cast<bf16*>(out), M, N, K2, block);
  });
}

extern "C" int qt_matmul_4bit_f32(const void* x, const void* codes, const void* scales,
                                  const void* levels, void* out, int M, int N, int K2,
                                  int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mmf<4>(M, N, K2);
  return with_mmf<4>(p.kind, [&](auto kernel, int threads, size_t smem) {
    return launch_cluster(kernel, p.grid, p.split, threads, smem, stream,
                          static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(scales), static_cast<const float*>(levels),
                          static_cast<float*>(out), M, N, K2, block);
  });
}

// The bf16 route's launch at (M, N, K2), for a report (report_plan says
// what out[11] holds)
extern "C" int qt_matmul_4bit_design(int M, int N, int K2, int* out) {
  if (M <= 0 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm4(M, N, K2);
  return with_kernel(p.kind, [&](auto kernel, int, size_t smem) {
    return report_plan(p, kernel, smem, resident(p.kind),
                       p.kind.design ? PF_STAGES : DEC_STAGES, out);
  });
}

// The f32 route's launch at (M, N, K2), for a report (report_plan says
// what out[11] holds)
extern "C" int qt_matmul_4bit_f32_design(int M, int N, int K2, int* out) {
  if (M <= 0 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mmf<4>(M, N, K2);
  return with_mmf<4>(p.kind, [&](auto kernel, int, size_t smem) {
    return report_plan(p, kernel, smem, mmf_resident<4>(p.kind),
                       p.kind.design ? FP_STAGES : FD_STAGES, out);
  });
}
