// Fused 8-bit dequant-matmul for Hopper (sm_90a), bf16 or f32 activations.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_8bit
// (_mm8_kernel). It computes
//
//   out[m, n] = sum_k x[m, k] * T(levels[code[k, n]] * scale[k / block, n])
//
// for 8-bit matmul-layout codes (K, N) (one byte a weight: int8, nf8,
// fp8 or the unsigned int8a codes) and f32 block scales (K/block, N),
// through one 256-entry level table (dequant8_sm90.cuh says how the wrapper
// picks it for each format, and why fp8 codes cannot go through Hopper's
// FP8 conversion). T is the activation type: the weight is one f32 multiply
// rounded once, then rounded to T before the product, as the TPU kernel
// rounds `w.astype(x_ref.dtype)`. Products accumulate in f32. int8a's
// zero-point term, blocksum(x) @ zp, is added by the wrapper outside the
// kernel, as the JAX package adds it. Rows, columns and K past the edges
// are masked; any block that divides K.
//
// What bounds it on the H100, and the two bf16 designs, chosen by M:
//   - decode (M <= DECODE_MAX_M) is bound by memory: every weight streams
//     once at 1 B plus 4 B per 64-weight scale (1.0625 B a weight) against
//     3.35 TB/s. Split K: a cluster of S blocks per 64 columns of W (S the
//     largest power of two up to 8 whose blocks still fit on the card at
//     once, by the runtime's count of the kernel's blocks an SM holds, so
//     w_down (K 5632, N 2048) runs 256 blocks, not 32). Each of a block's 4
//     warps streams its own 16-row slices of codes and x through a
//     cp.async ring of DEC_STAGES slots (no block barrier in the loop),
//     dequantizes them in registers straight into the A operand of
//     mma.sync m16n8k16 (W^T as A, so x^T is the n8 operand: at M <= 8
//     no product is wasted on padding rows), and keeps f32 sums. The
//     partials of the 4 warps and the S blocks are summed in a fixed order
//     (rank, then warp) through distributed shared memory: no atomics, no
//     workspace, the same bits on every call.
//   - prefill and training (M > DECODE_MAX_M) are bound by the tensor
//     cores: 2*M*K*N flops at 989 TFLOP/s. BM x 128 output tiles (BM 128
//     up to M = PF_WIDE_M, else 256: the same dequantized W tile then
//     feeds twice the rows), two consumer warpgroups of BM / 2 rows; a
//     cp.async ring of PF_STAGES slots
//     holds x tiles (the swizzled Tile<64>) and raw code slabs; each step
//     the block dequantizes one slab into a bf16 Tile<128> (double
//     buffered, dequant8_sm90.cuh) while the previous step's wgmma runs,
//     then issues wgmma with x K-major and W MN-major (wgmma_ss_tb). Where
//     the tile grid leaves SMs idle (N = 256 at M = 2048: 32 tiles of 128
//     rows), K is split over a cluster as in the decode design.
// Both read the level table from 32 interleaved copies in shared memory
// (dequant8_sm90.cuh): one copy put random codes on random banks.
// Tried on the H100 (each variant a build with the constants below edited,
// timed by kernel_sweep.py; PERF.md), int8 at the five TinyLlama (K, N):
// decode beats prefill up to M = 32 (e.g. (2048, 2048): 11.5 against
// 23.4 us at M = 8, 16.1 against 23.6 at 32) and loses from 64 (29.6 against 23.8); a decode ring of 3
// stages (4 blocks an SM) beats 4 and 6 (the lm_head at M = 8: 54.4, 73.3,
// 74.8 us); the 256-row prefill tile beats the 128-row one from M = 256
// ((2048, 5632) at M = 2048: 256.8 against 321.5 us) and loses below; 3
// prefill stages match 4 and 5 within 3%. The first build read each
// step's scales from device memory inside the dequantize loop, one chunk
// at a time: that held the 128-row prefill to 111 TFLOP/s; the staged scale
// row and a batched dequantize took it to 149.
//
// f32 (GPT-2 small at its own f32 through generate, serve and eval; the
// accuracy proxy's perplexity at M = 8192): the same two designs on the CUDA
// cores, chosen by M inside qt_matmul_8bit_f32 (fma_sm90.cuh, one template
// with matmul_4bit.cu's): split-K FMA decode up to M = 32 and a
// register-tiled FMA GEMM above, f32 products and sums only, in a fixed
// order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant8_sm90.cuh"
#include "fma_sm90.cuh"     // the f32 designs: mmf_decode, mmf_prefill, plan_mmf
#include "splitk_sm90.cuh"  // cluster_sum_store, pick_split, MmKind, MmPlan, mma_bf16_16816

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ bf16: decode

constexpr int DECODE_MAX_M = 32;
constexpr int DEC_STAGES = 3;
constexpr int DEC_THREADS = 128;
constexpr int DEC_BN = 64;       // columns of W a block
constexpr int CODE_LD = 80;      // bytes of a staged code row: 8-byte reads of a quad's rows miss each other's banks
constexpr int X_LD = 48;         // bytes of a staged x row (16 bf16): conflict-free 4-byte reads
constexpr int RED_LD = DEC_BN + 4;

template <int MT> struct DecSmem {  // MT n8 tiles of x rows: M <= 8 * MT a block
  // a slot: 16 code rows, their scale row (a block of 16 rows or more), x
  static constexpr int SROW = 16 * CODE_LD, X = SROW + DEC_BN * 4;
  static constexpr int SLOT = X + 8 * MT * X_LD;
  static constexpr int RING = 4 * DEC_STAGES * SLOT;
  static constexpr int RED = 4 * 8 * MT * RED_LD * 4;  // f32 partials, after the loop
  static constexpr size_t bytes = LV_BYTES + (RING > RED ? RING : RED);
};

// grid (S, N / 64, M / (8 MT)), clusters of S along x: rank r takes the
// 16-row slices [r * per, (r + 1) * per) of K, per = ceil(slices / S), and
// warp w of its block the slices w, w + 4, ... of those.
template <int MT>
__global__ void __launch_bounds__(DEC_THREADS)
mm8_decode(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ levels,
           bf16* __restrict__ out, int M, int N, int K, int block) {
  using SM = DecSmem<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lv = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + LV_BYTES;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.y * DEC_BN, m0 = blockIdx.z * 8 * MT;
  const int slices = (K + 15) / 16, per = (slices + S - 1) / S;
  const int s_lo = min(slices, rank * per), s_hi = min(slices, s_lo + per);
  const int mine = s_hi - s_lo > warp ? (s_hi - s_lo - warp + 3) / 4 : 0;
  const bool one_srow = block % 16 == 0;  // one scale row a slice, staged with it
  fill_levels32<DEC_THREADS>(lv, levels, tid);

  unsigned char* wring = ring + warp * DEC_STAGES * SM::SLOT;
  const uint32_t wring_s = smem_addr(wring);
  auto load = [&](int it, int st) {  // slice s_lo + warp + 4 it into slot st
    const int k0 = 16 * (s_lo + warp + 4 * it);
    unsigned char* slot = wring + st * SM::SLOT;
    const uint32_t slot_s = wring_s + st * SM::SLOT;
#pragma unroll
    for (int i = lane; i < 64; i += 32) {  // 16 rows of 64 code bytes
      const int r = i / 4, c = (i % 4) * 16;
      stage_codes16(slot + r * CODE_LD + c, slot_s + r * CODE_LD + c, codes, k0 + r, n0 + c, K, N);
    }
    for (int i = lane; i < 16 * MT; i += 32) {  // 8 MT rows of 16 x values
      const int r = i / 2, c = (i % 2) * 8;
      const int off = SM::X + r * X_LD + 2 * c;
      stage_bf16x8(slot + off, slot_s + off, x, m0 + r, k0 + c, M, K);
    }
    if (one_srow)
      stage_scale_row(reinterpret_cast<float*>(slot + SM::SROW), slot_s + SM::SROW, scales,
                      k0 / block, n0, N, DEC_BN / 4, lane);
  };
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < mine) load(st, st);
    cp_async_commit();
  }
  __syncthreads();  // the level table

  // A operand (W^T, 16 columns of W x 16 rows of K) of tile j: its row g
  // is column 8g + 2j of the block's 64, row g + 8 column 8g + 2j + 1, so a
  // lane reads 8 adjacent code bytes of each of its K rows 2 t4, 2 t4 + 1,
  // 2 t4 + 8, 2 t4 + 9. acc[j][i]: columns 8g + 2j (+1), x rows 8i + 2 t4 (+1).
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
    const int k0 = 16 * (s_lo + warp + 4 * it);

    float w[4][8];  // K rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9; columns 8g + e
    float s[8];
    if (one_srow) {  // 16 | block | K: no slice runs past K
      const float* sr = reinterpret_cast<const float*>(slot + SM::SROW) + 8 * g;
      const float4 a = *reinterpret_cast<const float4*>(sr), b = *reinterpret_cast<const float4*>(sr + 4);
      s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
      s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 2 * t4 + (q & 1) + 8 * (q >> 1);
      const int k = k0 + r;
      if (!one_srow) load_scales8(s, scales, k, n0 + 8 * g, K, N, block);
      const uint2 raw = *reinterpret_cast<const uint2*>(slot + r * CODE_LD + 8 * g);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t code = ((e < 4 ? raw.x : raw.y) >> (8 * (e & 3))) & 0xFF;
        w[q][e] = __fmul_rn(level(lv, code, lane), s[e]);
      }
    }
    uint32_t b[MT][2];
    const unsigned char* xs = slot + SM::X;
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

constexpr int PF_WIDE_M = 128;   // M above which a tile has 256 rows, not 128
constexpr int PF_STAGES = 3;     // the ring reloads a slot two steps after its products
constexpr int PF_THREADS = 256;  // two consumer warpgroups, BM / 2 rows of the tile each
constexpr int PF_BN = 128, PF_BK = 64;
constexpr int PF_RED_LD = PF_BN + 4;

// level table; STAGES x (BM / 64) x tiles; 2 W tiles; STAGES x (code slab, scale row)
template <int BM> struct PfSmem {
  static_assert(BM == 128 || BM == 256, "128 or 256 rows a tile");
  static constexpr int XTILES = BM / 64;  // 64-row x tiles a step
  static constexpr uint32_t XT = Tile<64>::BYTES, WT = Tile<128>::BYTES;
  static constexpr uint32_t SROW = PF_BK * PF_BN, SLAB = SROW + PF_BN * 4;
  static constexpr uint32_t X0 = LV_BYTES;                   // 1024-aligned from the base
  static constexpr uint32_t W0 = X0 + PF_STAGES * XTILES * XT;
  static constexpr uint32_t C0 = W0 + 2 * WT;
  static constexpr uint32_t END = C0 + PF_STAGES * SLAB;
  static constexpr uint32_t RED = BM * PF_RED_LD * 4;        // f32 partials, over the tiles
  static constexpr size_t bytes = (END > X0 + RED ? END : X0 + RED) + 1024;
};

// grid (S, N / 128, M / BM), clusters of S along x: rank r takes the
// 64-row steps [r * per, (r + 1) * per) of K. Each warpgroup owns BM / 128
// of the tile's 64-row x tiles (m64 products a k16 slice).
template <int BM>
__global__ void __launch_bounds__(PF_THREADS)
mm8_prefill(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
            const float* __restrict__ scales, const float* __restrict__ levels,
            bf16* __restrict__ out, int M, int N, int K, int block) {
  using SM = PfSmem<BM>;
  constexpr int XTILES = SM::XTILES, MT = XTILES / 2;  // x tiles a step; a warpgroup's
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  float* lv = reinterpret_cast<float*>(gbase);
  auto Xs = [&](int st, int i) { return base + SM::X0 + (XTILES * st + i) * SM::XT; };
  auto Ws = [&](int i) { return base + SM::W0 + i * SM::WT; };
  auto slab = [&](int st) { return gbase + SM::C0 + st * SM::SLAB; };
  // a block of 64 rows or more: one scale row a step, staged with its slab
  const bool one_srow = block % PF_BK == 0;
  auto srow = [&](int st) { return reinterpret_cast<float*>(slab(st) + SM::SROW); };

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.y * PF_BN, m0 = blockIdx.z * BM;
  const int steps = (K + PF_BK - 1) / PF_BK, per = (steps + S - 1) / S;
  const int t_lo = min(steps, rank * per), n_t = min(steps, t_lo + per) - t_lo;
  fill_levels32<PF_THREADS>(lv, levels, tid);

  auto load = [&](int t, int st) {  // step t_lo + t into slot st
    const int k0 = (t_lo + t) * PF_BK;
    for (int i = tid; i < BM * 8; i += PF_THREADS) {  // x rows [m0, m0 + BM), 8 chunks a row
      const int r = i / 8, c = i % 8;
      const uint32_t off = Tile<64>::offset(r % 64, c);
      const uint32_t dst = Xs(st, r / 64) + off;
      stage_bf16x8(gbase + (dst - base), dst, x, m0 + r, k0 + 8 * c, M, K);
    }
    stage_code_slab(slab(st), smem_addr(slab(st)), codes, k0, n0, K, N, tid, PF_THREADS);
    if (one_srow)
      stage_scale_row(srow(st), smem_addr(srow(st)), scales, k0 / block, n0, N, PF_BN / 4, tid);
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
    dequant_slab<PF_THREADS>(Ws(t % 2), slab(t % PF_STAGES),
                             one_srow ? srow(t % PF_STAGES) : nullptr, scales, lv,
                             (t_lo + t) * PF_BK, n0, K, N, block, tid);
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
      for (int kk = 0; kk < PF_BK / 16; ++kk)
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

MmKind kind_mm8(int M) {
  if (M <= DECODE_MAX_M) {
    const int mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
    return {0, mt, 8 * mt, DEC_BN};
  }
  const int bm = M > PF_WIDE_M ? 256 : 128;
  return {1, bm, bm, PF_BN};
}

template <typename F> auto with_kernel(const MmKind& k, F f) {
  if (k.design == 1)
    return k.tmpl == 256 ? f(mm8_prefill<256>, PF_THREADS, PfSmem<256>::bytes)
                         : f(mm8_prefill<128>, PF_THREADS, PfSmem<128>::bytes);
  switch (k.tmpl) {
    case 1: return f(mm8_decode<1>, DEC_THREADS, DecSmem<1>::bytes);
    case 2: return f(mm8_decode<2>, DEC_THREADS, DecSmem<2>::bytes);
    default: return f(mm8_decode<4>, DEC_THREADS, DecSmem<4>::bytes);
  }
}

// Blocks of the kind's kernel an SM holds (registers, shared memory), asked
// of the runtime once per kernel.
int resident(const MmKind& k) {
  static int n[5] = {};  // decode MT 1, 2, 4; prefill 128, 256 rows
  int& r = n[k.design ? 2 + k.tmpl / 128 : k.tmpl / 2];
  if (r == 0)
    r = with_kernel(k, [](auto kernel, int threads, size_t smem) {
      return blocks_per_sm(kernel, smem, threads);
    });
  return r;
}

MmPlan plan_mm8(int M, int N, int K) {
  const MmKind k = kind_mm8(M);
  // decode: each warp at least two 16-row slices, so K splits no finer than
  // 128 rows; prefill: each split at least 4 steps of 64 rows
  const int min_k = k.design ? 4 * PF_BK : 128;
  return plan_split(k, M, N, max(1, (K + min_k - 1) / min_k), resident(k));
}

}  // namespace

extern "C" int qt_matmul_8bit_bf16(const void* x, const void* codes, const void* scales,
                                   const void* levels, void* out, int M, int N, int K,
                                   int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm8(M, N, K);
  return with_kernel(p.kind, [&](auto kernel, int threads, size_t smem) {
    return launch_cluster(kernel, p.grid, p.split, threads, smem, stream,
                          static_cast<const bf16*>(x), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(scales), static_cast<const float*>(levels),
                          static_cast<bf16*>(out), M, N, K, block);
  });
}

extern "C" int qt_matmul_8bit_f32(const void* x, const void* codes, const void* scales,
                                  const void* levels, void* out, int M, int N, int K,
                                  int block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mmf<8>(M, N, K);
  return with_mmf<8>(p.kind, [&](auto kernel, int threads, size_t smem) {
    return launch_cluster(kernel, p.grid, p.split, threads, smem, stream,
                          static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(scales), static_cast<const float*>(levels),
                          static_cast<float*>(out), M, N, K, block);
  });
}

// The bf16 route's launch at (M, N, K), for a report (report_plan says
// what out[11] holds)
extern "C" int qt_matmul_8bit_design(int M, int N, int K, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm8(M, N, K);
  return with_kernel(p.kind, [&](auto kernel, int, size_t smem) {
    return report_plan(p, kernel, smem, resident(p.kind),
                       p.kind.design ? PF_STAGES : DEC_STAGES, out);
  });
}

// The f32 route's launch at (M, N, K), for a report (report_plan says what
// out[11] holds)
extern "C" int qt_matmul_8bit_f32_design(int M, int N, int K, int* out) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mmf<8>(M, N, K);
  return with_mmf<8>(p.kind, [&](auto kernel, int, size_t smem) {
    return report_plan(p, kernel, smem, mmf_resident<8>(p.kind),
                       p.kind.design ? FP_STAGES : FD_STAGES, out);
  });
}
