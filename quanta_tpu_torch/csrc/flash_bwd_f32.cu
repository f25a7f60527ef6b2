// Flash-attention backward for Hopper (sm_90a), f32 operands: the dQ kernel
// and the dK/dV kernel. The function, the TPU kernels they replace and the
// bf16 route: flash_bwd.cu; the launch both share: flash_bwd.cuh; head
// dims between the compiled widths: flash_common.cuh.
//
// f32 (QLoRA on an f32 base at S >= 1024, the JAX package's `finetune
// --dtype float32 --seq-len 1024`; the f32 cached prefill): on the CUDA
// cores the products are bound at 67 TFLOP/s of f32 FMAs (~0.19 ms for dQ
// and ~0.26 ms for dK/dV at TinyLlama's s1024 shape). The tensor cores
// multiply TF32 (10 fraction bits), so each f32 product runs as three TF32
// ones, as tf32x3_sm90.cuh does: x = hi + lo, hi = tf32(x), lo = tf32(x -
// hi), a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, a ceiling of 495 / 3 = 165
// TFLOP/s (~0.078 and ~0.104 ms); the pieces, shared with the f32 forward,
// are flash_tf32x3.cuh's. tf32 wgmma reads K-major operands only.
// So every operand a block streams is an A operand, read from its raw f32
// tile in whatever order the product needs and split in registers, and
// every B operand sits in shared memory as split hi and lo tiles: the
// block's own operands, split once, and each tile's p and ds, split as they
// leave the accumulators. Every product is read the other way round from
// the bf16 kernels'. Up to 128 columns a block runs two warpgroups below hd
// 128 (one at 128, where the shared memory holds one), each taking every
// second item of the block with a ring slot and p / ds tiles of its own
// (two slots alone):
//   - dQ: one block per (BQ query rows, head, batch row), BQ = 64 (32 at
//     hd 128), ordered as the bf16 kernel's blocks. Q and dO are split once
//     into hi / lo tiles (rows = queries); the key tiles stream as raw K
//     and V tiles. Per key tile, S^T = K Q^T and dP^T = V dO^T (rows =
//     keys; lse and D per column, from shared memory), ds^T formed in the
//     accumulator registers and written, split, as a dS tile (rows =
//     queries, columns = keys), then dQ^T += K^T dS^T, K^T's fragments read
//     from the raw K tile. The warpgroups' dQ rows are summed in order.
//   - dK/dV: one cluster of C blocks per (BK keys, KV head, batch row), BK
//     = 64 (32 at hd 128), C picked as for the bf16 kernel (TinyLlama's
//     s1024 shape: 128 key tiles, C = 4, 512 blocks). K and V are split
//     once into hi / lo tiles (rows = keys); the block's share of the (rep
//     head, query tile) pairs streams as raw Q and dO tiles with their lse
//     and D. Per pair, S = Q K^T and dP = dO V^T (rows = queries; lse and D
//     per row, in registers), p written, split, as a P tile (rows = keys,
//     columns = queries) for dV^T += dO^T P, then ds into the same tile for
//     dK^T += Q^T dS, the A fragments read transposed from the raw dO and Q
//     tiles. The cluster sums its blocks' and warpgroups' partials through
//     distributed shared memory in that order, as the bf16 kernel does.
// An A fragment holds columns q and q + 4 of a k8 slice; the B tiles of S
// and dP keep hd 2q and 2q + 1 there, so each fragment row is one 8-byte
// load of a raw tile (RAW_PAD floats a row put the rows a half-warp reads
// on distinct banks). Independent products (S and dP; hd 128's two slabs)
// interleave their wgmmas, and each slice's fragments load while the last
// slice's products are issued. The tensor cores add with truncation: over
// the 1024 keys of dQ and the 8 x 1024 query rows of dK/dV that bias would
// approach the 1e-4 rule, so each tile's products go into a fresh partial
// that the CUDA cores add to the running sum, rounded to nearest. p = 2^(s
// scale log2 e - lse log2 e) on the SFU (ex2.approx, ~2 ulp; the gradients
// stay within 5e-6 of max|plain| at chip_smoke.py's shapes, the rule is
// 1e-4). No atomics: two calls give the same bits.
//
// 256 columns (head dims 129-256; flash_bwd_f32_w256.cu compiles this file
// with QT_FLASH_WIDE). A raw 64 x 256 f32 tile pair (K and V, or Q and dO)
// is 128 KB: beside the block's own split operands nothing is left for a
// second item in flight, and only 16 own rows fit, so each streamed byte
// would serve 16 rows (1.14 GB of mostly L2 reads a kernel at Gemma-2B's
// s1024 shape, 30x the operands). Here the two blocks of a cluster split
// hd: block `half` holds columns [128 half, 128 half + 128) of every
// operand, streamed tile and output, and SPLIT_ROWS = 32 own rows (queries
// of dQ, keys of dK/dV), so half the bytes a row. S and dP reduce over hd:
// each block forms its partials over its 128 columns, stores them into the
// other block's shared memory by st.async (completing on that block's
// mbarrier) and adds the other's to its own, own + other, the same f32 sum
// in both blocks, which then form the same p and ds (PairSum). dQ^T, dK^T
// and dV^T read only the block's columns. Each block runs two warpgroups,
// warpgroup w taking every second item through a raw slot (cp.async; 128
// floats a row, the 16-byte chunks XOR-swizzled by row in place of
// RAW_PAD: SplitRaw) and an exchange region of its own, which then holds
// the item's dS (or P) tiles; one arrival a warp on the other block's FREE
// mbarrier hands it back. While one warpgroup's products run, the other's
// loads, exchange, exponentials and stores do. dK/dV splits the (rep head,
// query tile) pairs over C parts as above, C up to 2 (clusters of 2 C
// blocks; 256 blocks at Gemma-2B's shape), and sums them in a fixed order.
// What bounds it (timing-only cuts of a copy, timed by
// benchmarks/flash_bwd_variant.py: ms dQ / dK/dV at that shape on an H100
// 80GB HBM3 at 700 W, from 0.313 / 0.414): without the products
// 0.167 / 0.180, without the loads 0.263 / 0.358, without the exchange
// 0.293 / 0.384: the products and the p / ds stage between them, in
// latency more than in issue slots, as at the narrower widths.
//
// Tried on the H100 (PERF.md's f32 flash findings; variants of this file
// timed at TinyLlama's s1024 shape, ms dQ / dK/dV): one warpgroup a block 0.402 /
// 0.486; two 0.281 / 0.340; with S and dP interleaved, the fragments loaded
// a slice ahead and ex2.approx, 0.227 / 0.286. From there, timing-only
// cuts: one TF32 product for three -8% / -9%, no per-tile loads -9% / -11%,
// no p / ds stage at all -48% / -44%, though its parts alone (no exp, no
// split, no lo tiles, no proxy fence) move it 0-4%: the stage costs in
// latency, not in issue slots. No gain from K^T's fragments held in
// registers to load the next tile before dQ's last product (+2%), one or
// three A buffers (+7%; +2% / +9%, with spills), staggered warpgroups
// (+2%), or S and dP of dK/dV as separate products (+3%). dK/dV's cluster:
// 2 blocks (256, under two blocks an SM) -14%, 3 +3%, 8 +18% against 4.
// At 256 columns (flash_bwd_variant.py; the one-block design of 16 own
// rows and all 256 columns, each raw tile loaded before its products, took
// 0.491 / 0.689): one warpgroup a split block, a 2-slot ring, the
// partials stored by st.shared::cluster with 128 arrivals a phase 0.474 /
// 0.624, by st.async 0.451 / 0.598; two warpgroups 0.309 / 0.424; dK/dV's
// two hd slabs one after the other in place of both at once (the same
// time, 32 fewer live accumulators); C up to 2 in place of 4 (dK/dV 0.414
// -> 0.396); four A buffers +0% / +2%; an opaque tile pointer to keep
// fragment addresses in the loop +11% / +19% (144 bytes spilled); the
// other block's addresses formed where used, no change; four fragment
// addresses a thread for 16 (frag_rows_split) -2% / -2%: 0.288 / 0.373.


#include <cooperative_groups.h>

#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "flash_tf32x3.cuh"
#include "sm90.cuh"
#ifdef QT_FLASH_WIDE
#include "ws_sm90.cuh"
#endif

namespace {

namespace cg = cooperative_groups;

// Both f32 kernels run WGS warpgroups a block (two below hd 128, where the
// shared memory holds two), warpgroup w taking every WGS-th item (key tile
// or pair) of the block from the w-th, through a ring of RS slots of its own
// (one beside a second warpgroup, two alone): while one warpgroup's products
// run, the other's loads, splits, exponentials and stores do. The block's
// own split operands are shared. 256 columns: flash_bwd_dq_f32_split and
// flash_bwd_dkv_f32_split below.
#ifndef QT_FLASH_WIDE
template <int HD> struct DqF32 {
  static_assert(HD <= 128, "256 columns: flash_bwd_dq_f32_split");
  static constexpr int WGS = HD >= 128 ? 1 : 2;
  static constexpr int RS = HD == 128 ? 2 : 1;
  static constexpr int BQ = HD == 128 ? 32 : 64;         // query rows a block
  static constexpr int SLABS = HD >= 128 ? HD / 64 : 1;  // m64 slabs of hd in dQ^T
  using QT = KTile<BQ, HD>;  // Q, dO hi / lo: the B of S^T = K Q^T, dP^T = V dO^T
  using ST = KTile<BQ, 64>;  // dS hi / lo: the B of dQ^T = K^T dS^T
  using RT = RawTile<HD>;
  // Q, dO hi / lo; warpgroup w's dS hi, lo at S0 + 2 w ST::BYTES; its slot s
  // (raw K, V) at RING + 2 (w RS + s) RT::BYTES; lse, D of the block's rows
  static constexpr uint32_t Q_HI = 0, Q_LO = QT::BYTES, O_HI = 2 * QT::BYTES,
                            O_LO = 3 * QT::BYTES, S0 = 4 * QT::BYTES,
                            RING = S0 + WGS * 2 * ST::BYTES,
                            STATS = RING + WGS * RS * 2 * RT::BYTES;
  static constexpr int OUT_LD = HD + 4;  // each warpgroup's dQ rows, over the ring
  static_assert(WGS * BQ * OUT_LD * 4 <= WGS * RS * 2 * RT::BYTES, "the dQ rows fit the ring");
  static constexpr size_t bytes = STATS + 2 * BQ * 4 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(128 * DqF32<HD>::WGS, 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_start, const int* __restrict__ kv_len,
                 float* __restrict__ dq, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                 float scale) {
  using L = DqF32<HD>;
  using RT = typename L::RT;
  using QT = typename L::QT;
  using ST = typename L::ST;
  constexpr int BQ = L::BQ, WGS = L::WGS, RS = L::RS;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  auto raw = [&](uint32_t at) { return reinterpret_cast<const float*>(gbase + (at - base)); };
  float* Ls = reinterpret_cast<float*>(gbase + L::STATS);
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest rows first
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = causal ? min(kvl, qs + min(q0 + BQ, Sq)) : kvl;
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;
  const int n_mine = n_tiles > wg ? (n_tiles - wg + WGS - 1) / WGS : 0;  // tiles wg, wg + WGS, ..

  const int64_t q_off = ((int64_t)b * Sq * nh + h) * hd;
  const float* kb = k + ((int64_t)b * Tk * nkv + g) * hd;
  const float* vb = v + ((int64_t)b * Tk * nkv + g) * hd;
  const int64_t kv_stride = (int64_t)nkv * hd;
  const uint32_t s_hi = base + L::S0 + wg * 2 * ST::BYTES, s_lo = s_hi + ST::BYTES;
  auto slot = [&](int s) { return base + L::RING + (wg * RS + s) * 2 * RT::BYTES; };
  auto load = [&](int i, int s) {  // this warpgroup's i-th tile into its slot s
    const int k0 = (wg + WGS * i) * TILE;
    RT::load(slot(s), kb, kv_stride, k0, Tk, wtid, hd);
    RT::load(slot(s) + RT::BYTES, vb, kv_stride, k0, Tk, wtid, hd);
  };
#pragma unroll
  for (int s = 0; s < RS - 1; ++s) {
    if (s < n_mine) load(s, s);
    cp_async_commit();
  }
  split_hd_tile<BQ, HD>(base + L::Q_HI, base + L::Q_LO, q + q_off, (int64_t)nh * hd, q0, Sq, tid,
                        128 * WGS, hd);
  split_hd_tile<BQ, HD>(base + L::O_HI, base + L::O_LO, dout + q_off, (int64_t)nh * hd, q0, Sq,
                        tid, 128 * WGS, hd);
  for (int i = tid; i < BQ; i += 128 * WGS) {
    const int row = q0 + i;
    const int64_t stat = ((int64_t)b * nh + h) * Sq + row;
    Ls[i] = (row < Sq ? lse[stat] : kDeadLse) * kLog2e;  // base 2
    Ds[i] = row < Sq ? delta[stat] : 0.0f;
  }
  fence_proxy_async();
  __syncthreads();  // the split Q and dO tiles and the statistics are whole
  const float scale2 = scale * kLog2e;

  // this thread's key rows r0, r0 + 8 of a tile (and hd rows of dQ^T);
  // query columns 8 j + 2 q4 + c
  const int r0 = 16 * warp + lane / 4, q4 = lane % 4;
  auto q_hi = [&](int kk) { return QT::desc(base + L::Q_HI, kk); };
  auto q_lo = [&](int kk) { return QT::desc(base + L::Q_LO, kk); };
  auto o_hi = [&](int kk) { return QT::desc(base + L::O_HI, kk); };
  auto o_lo = [&](int kk) { return QT::desc(base + L::O_LO, kk); };
  auto ds_hi = [&](int kk) { return ST::desc(s_hi, kk); };
  auto ds_lo = [&](int kk) { return ST::desc(s_lo, kk); };
  float acc[L::SLABS][BQ / 2];
#pragma unroll
  for (int sl = 0; sl < L::SLABS; ++sl)
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) acc[sl][e] = 0.0f;

  for (int i = 0; i < n_mine; ++i) {
    if constexpr (RS == 1) {
      wg_sync(wg);  // the warpgroup is done with its slot and its dS tiles
      load(i, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<RS - 2>();  // tile i has landed
    }
    wg_sync(wg);  // ... for every thread of the warpgroup; (RS > 1) the slot of i - 1 is free
    if constexpr (RS > 1) {
      if (i + RS - 1 < n_mine) load(i + RS - 1, (i + RS - 1) % RS);
      cp_async_commit();
    }
    const float* Kr = raw(slot(i % RS));
    const float* Vr = Kr + RT::BYTES / 4;
    const int k0 = (wg + WGS * i) * TILE;

    float s[BQ / 2], dp[BQ / 2];
    {
      auto cs = chain<BQ>(s, [&](int kk, float(&a)[4]) { frag_rows<HD>(Kr, r0, q4, kk, a); },
                          q_hi, q_lo);
      auto cd = chain<BQ>(dp, [&](int kk, float(&a)[4]) { frag_rows<HD>(Vr, r0, q4, kk, a); },
                          o_hi, o_lo);
      mma_3xtf32<HD / 8>(cs, cd);
    }

    // ds^T = p^T (dP^T - D) scale, split into the dS tiles (rows = queries);
    // rows past Sq have lse 1e30, so p = 0 there
    const bool edge = k0 + TILE > kvl || (causal && k0 + TILE - 1 > qs + q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + col);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i2 + c, key = r0 + 8 * i2;
          const bool live = !edge || live_pair(k0 + key, qs + q0 + col + c, kvl, causal);
          const float p = live ? fast_exp2(fmaf(s[e], scale2, -(c ? l2.y : l2.x))) : 0.0f;
          const float ds = p * (dp[e] - (c ? d2.y : d2.x)) * scale;
          uint32_t hi, lo;
          split_tf32(ds, hi, lo);
          const uint32_t off = ST::offset(col + c, key);
          st_shared1(s_hi + off, hi);
          st_shared1(s_lo + off, lo);
        }
    }
    fence_proxy_async();
    wg_sync(wg);  // the dS tiles are whole

    // dQ^T += K^T dS^T, the tile's products into a fresh partial (a chain
    // for each m64 slab of hd)
    float part[L::SLABS][BQ / 2];
    auto cols = [&](int sl) {
      return chain<BQ>(part[sl], [&, sl](int kk, float(&a)[4]) {
        frag_cols<HD>(Kr, 64 * sl + r0, q4, kk, a);
      }, ds_hi, ds_lo);
    };
    auto c0 = cols(0);
    if constexpr (L::SLABS == 2) {
      auto c1 = cols(1);
      mma_3xtf32<TILE / 8>(c0, c1);
    } else {
      mma_3xtf32<TILE / 8>(c0);
    }
#pragma unroll
    for (int sl = 0; sl < L::SLABS; ++sl)
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) acc[sl][e] = __fadd_rn(acc[sl][e], part[sl][e]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile read: the dQ rows take the ring over

  // acc[sl][4 j + 2 i + c] is the warpgroup's dQ^T (hd m = 64 sl + r0 + 8 i,
  // query 8 j + 2 q4 + c): staged as rows of queries, one block of rows a
  // warpgroup, then summed in warpgroup order and stored 16 bytes a thread
  float* out = reinterpret_cast<float*>(gbase + L::RING);
#pragma unroll
  for (int sl = 0; sl < L::SLABS; ++sl)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = 64 * sl + r0 + 8 * i;
          if (m < HD)
            out[(wg * BQ + 8 * j + 2 * q4 + c) * L::OUT_LD + m] = acc[sl][4 * j + 2 * i + c];
        }
  __syncthreads();
  constexpr int V4 = HD / 4;
  for (int idx = tid; idx < BQ * V4; idx += 128 * WGS) {
    const int row = idx / V4, col = (idx % V4) * 4;
    float4 sum = *reinterpret_cast<const float4*>(out + row * L::OUT_LD + col);
#pragma unroll
    for (int w = 1; w < WGS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(out + (w * BQ + row) * L::OUT_LD + col);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (q0 + row < Sq && col < hd)
      *reinterpret_cast<float4*>(dq + (((int64_t)b * Sq + q0 + row) * nh + h) * hd + col) = sum;
  }
}

template <int HD> struct DkvF32 {
  static_assert(HD <= 128, "256 columns: flash_bwd_dkv_f32_split");
  static constexpr int WGS = HD >= 128 ? 1 : 2;
  static constexpr int RS = HD == 128 ? 2 : 1;
  static constexpr int BK = HD == 128 ? 32 : 64;         // keys a block
  static constexpr int SLABS = HD >= 128 ? HD / 64 : 1;  // m64 slabs of hd in dK^T, dV^T
  using KT = KTile<BK, HD>;  // K, V hi / lo: the B of S = Q K^T, dP = dO V^T
  using PT = KTile<BK, 64>;  // P, then dS, hi / lo: the B of dV^T = dO^T P, dK^T = Q^T dS
  using RT = RawTile<HD>;
  // K, V hi / lo; warpgroup w's P / dS hi, lo at P0 + 2 w PT::BYTES; its
  // slot s (raw Q, dO; lse, D of the tile's 64 rows) at RING + (w RS + s) SLOT
  static constexpr uint32_t K_HI = 0, K_LO = KT::BYTES, V_HI = 2 * KT::BYTES,
                            V_LO = 3 * KT::BYTES, P0 = 4 * KT::BYTES,
                            RING = P0 + WGS * 2 * PT::BYTES, SLOT = 2 * RT::BYTES + 2 * TILE * 4;
  static constexpr int RED_LD = HD + 4;  // f32 partial rows (keys) the cluster sums
  static constexpr size_t tiles = RING + WGS * RS * SLOT;
  static constexpr size_t red = WGS * 2 * BK * RED_LD * 4;  // each warpgroup's dK, dV rows
  static constexpr size_t bytes = (tiles > red ? tiles : red) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(128 * DkvF32<HD>::WGS, 1)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ q_start, const int* __restrict__ kv_len,
                  float* __restrict__ dk, float* __restrict__ dv, int Sq, int Tk, int nh, int nkv,
                  int hd, int causal, float scale) {
  using L = DkvF32<HD>;
  using RT = typename L::RT;
  using KT = typename L::KT;
  using PT = typename L::PT;
  constexpr int BK = L::BK, WGS = L::WGS, RS = L::RS;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  auto raw = [&](uint32_t at) { return reinterpret_cast<const float*>(gbase + (at - base)); };

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = blockIdx.y % nkv, b = blockIdx.y / nkv, k0 = blockIdx.z * BK;
  const int rep = nh / nkv;
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  // query tiles whose last row reaches key k0: from the one holding row k0 - q_start
  const int qt_begin = causal ? max(0, k0 - qs) / TILE : 0;
  const int qt_end = k0 < kvl ? (Sq + TILE - 1) / TILE : 0;
  const int nq = max(0, qt_end - qt_begin);
  // this block's share of the (rep head, query tile) pairs, in rank order;
  // this warpgroup's: p_lo + wg, p_lo + wg + WGS, ..
  const int n_pairs = rep * nq;
  const int p_lo = rank * n_pairs / C, p_hi = (rank + 1) * n_pairs / C;
  const int n_mine = p_hi - p_lo > wg ? (p_hi - p_lo - wg + WGS - 1) / WGS : 0;

  const uint32_t pd_hi = base + L::P0 + wg * 2 * PT::BYTES, pd_lo = pd_hi + PT::BYTES;
  auto slot = [&](int s) { return base + L::RING + (wg * RS + s) * L::SLOT; };
  auto pair_q0 = [&](int i) { return (qt_begin + (p_lo + wg + WGS * i) % nq) * TILE; };
  auto load = [&](int i, int s) {  // this warpgroup's i-th pair into its slot s
    const int p = p_lo + wg + WGS * i;
    const int h = g * rep + p / nq, q0 = pair_q0(i);
    const int64_t q_off = ((int64_t)b * Sq * nh + h) * hd;
    RT::load(slot(s), q + q_off, (int64_t)nh * hd, q0, Sq, wtid, hd);
    RT::load(slot(s) + RT::BYTES, dout + q_off, (int64_t)nh * hd, q0, Sq, wtid, hd);
    // threads 0-63 fetch lse, 64-127 D, of the tile's 64 rows (zeros past Sq)
    const int row = q0 + (wtid & (TILE - 1));
    const float* src = (wtid < TILE ? lse : delta) + ((int64_t)b * nh + h) * Sq;
    cp_async4(slot(s) + 2 * RT::BYTES + wtid * 4, row < Sq ? src + row : src, row < Sq ? 4 : 0);
  };
#pragma unroll
  for (int s = 0; s < RS - 1; ++s) {
    if (s < n_mine) load(s, s);
    cp_async_commit();
  }
  const int64_t kv_off = ((int64_t)b * Tk * nkv + g) * hd;
  split_hd_tile<BK, HD>(base + L::K_HI, base + L::K_LO, k + kv_off, (int64_t)nkv * hd, k0, Tk,
                        tid, 128 * WGS, hd);
  split_hd_tile<BK, HD>(base + L::V_HI, base + L::V_LO, v + kv_off, (int64_t)nkv * hd, k0, Tk,
                        tid, 128 * WGS, hd);
  fence_proxy_async();
  __syncthreads();  // the split K and V tiles are whole
  const float scale2 = scale * kLog2e;

  // this thread's query rows r0, r0 + 8 of a pair's tile (and hd rows of
  // dK^T, dV^T); key columns 8 j + 2 q4 + c
  const int r0 = 16 * warp + lane / 4, q4 = lane % 4;
  auto k_hi = [&](int kk) { return KT::desc(base + L::K_HI, kk); };
  auto k_lo = [&](int kk) { return KT::desc(base + L::K_LO, kk); };
  auto v_hi = [&](int kk) { return KT::desc(base + L::V_HI, kk); };
  auto v_lo = [&](int kk) { return KT::desc(base + L::V_LO, kk); };
  auto t_hi = [&](int kk) { return PT::desc(pd_hi, kk); };
  auto t_lo = [&](int kk) { return PT::desc(pd_lo, kk); };
  // x (rows = queries, columns = keys, in the accumulator's order), split,
  // into the warpgroup's P / dS tiles (rows = keys)
  auto store_t = [&](const float(&x)[BK / 2]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t off = PT::offset(8 * j + 2 * q4 + c, r0 + 8 * i);
          uint32_t hi, lo;
          split_tf32(x[4 * j + 2 * i + c], hi, lo);
          st_shared1(pd_hi + off, hi);
          st_shared1(pd_lo + off, lo);
        }
    fence_proxy_async();
    wg_sync(wg);  // the tiles are whole
  };
  float acc_k[L::SLABS][BK / 2], acc_v[L::SLABS][BK / 2];
#pragma unroll
  for (int sl = 0; sl < L::SLABS; ++sl)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) acc_k[sl][e] = acc_v[sl][e] = 0.0f;

  for (int i = 0; i < n_mine; ++i) {
    if constexpr (RS == 1) {
      wg_sync(wg);  // the warpgroup is done with its slot and its P / dS tiles
      load(i, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<RS - 2>();  // pair i has landed
    }
    wg_sync(wg);  // ... for every thread of the warpgroup; (RS > 1) the slot of i - 1 is free
    if constexpr (RS > 1) {
      if (i + RS - 1 < n_mine) load(i + RS - 1, (i + RS - 1) % RS);
      cp_async_commit();
    }
    const int q0 = pair_q0(i);
    const float* Qr = raw(slot(i % RS));
    const float* Or = Qr + RT::BYTES / 4;
    const float* Lr = Or + RT::BYTES / 4;  // lse, then D, of the tile's 64 rows

    float s[BK / 2], dp[BK / 2];
    {
      auto cs = chain<BK>(s, [&](int kk, float(&a)[4]) { frag_rows<HD>(Qr, r0, q4, kk, a); },
                          k_hi, k_lo);
      auto cd = chain<BK>(dp, [&](int kk, float(&a)[4]) { frag_rows<HD>(Or, r0, q4, kk, a); },
                          v_hi, v_lo);
      mma_3xtf32<HD / 8>(cs, cd);
    }

    // p in place of s, ds in place of dp (rows = queries, lse and D per row)
    const bool edge = k0 + BK > kvl || q0 + TILE > Sq || (causal && k0 + BK - 1 > qs + q0);
    float lse_r[2], d_r[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      lse_r[i2] = Lr[r0 + 8 * i2] * kLog2e;
      d_r[i2] = Lr[TILE + r0 + 8 * i2];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i2 + c, row = q0 + r0 + 8 * i2;
          const bool live =
              !edge || (row < Sq && live_pair(k0 + 8 * j + 2 * q4 + c, qs + row, kvl, causal));
          s[e] = live ? fast_exp2(fmaf(s[e], scale2, -lse_r[i2])) : 0.0f;
          dp[e] = s[e] * (dp[e] - d_r[i2]) * scale;
        }

    // dV^T += dO^T P, then dK^T += Q^T dS through the same tiles, each
    // pair's products into a fresh partial
    // (a chain for each m64 slab of hd)
    float part[L::SLABS][BK / 2];
    auto cols = [&](const float* raw, float(&acc)[L::SLABS][BK / 2]) {
      auto chain_of = [&](int sl) {
        return chain<BK>(part[sl], [&, sl](int kk, float(&a)[4]) {
          frag_cols<HD>(raw, 64 * sl + r0, q4, kk, a);
        }, t_hi, t_lo);
      };
      auto c0 = chain_of(0);
      if constexpr (L::SLABS == 2) {
        auto c1 = chain_of(1);
        mma_3xtf32<TILE / 8>(c0, c1);
      } else {
        mma_3xtf32<TILE / 8>(c0);
      }
#pragma unroll
      for (int sl = 0; sl < L::SLABS; ++sl)
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) acc[sl][e] = __fadd_rn(acc[sl][e], part[sl][e]);
    };
    store_t(s);
    cols(Or, acc_v);
    wg_sync(wg);  // the products of P are done: dS takes the tiles
    store_t(dp);
    cols(Qr, acc_k);
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile read: the partials take the shared memory over

  // acc[sl][4 j + 2 i + c] is dK^T / dV^T (hd m = 64 sl + r0 + 8 i, key 8 j +
  // 2 q4 + c): staged as rows of keys, warpgroup w's dK rows then its dV rows
  float* red = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int sl = 0; sl < L::SLABS; ++sl)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = 64 * sl + r0 + 8 * i, row = 8 * j + 2 * q4 + c;
          if (m < HD) {
            red[(2 * wg * BK + row) * L::RED_LD + m] = acc_k[sl][4 * j + 2 * i + c];
            red[((2 * wg + 1) * BK + row) * L::RED_LD + m] = acc_v[sl][4 * j + 2 * i + c];
          }
        }
  cluster.sync();  // every block's partials are in its shared memory

  // this block sums rows [rank * BK / C, (rank + 1) * BK / C) of dK and dV
  // over the cluster's blocks and their warpgroups, in that order, and
  // writes them
  const int rows = BK / C, row0 = rank * rows;
  constexpr int V4 = HD / 4;
  for (int idx = tid; idx < 2 * rows * V4; idx += 128 * WGS) {
    const int which = idx / (rows * V4), rem = idx % (rows * V4);
    const int row = row0 + rem / V4, col = (rem % V4) * 4;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < C; ++r)
#pragma unroll
      for (int w = 0; w < WGS; ++w) {
        float* src = red + ((2 * w + which) * BK + row) * L::RED_LD + col;
        const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, r));
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
    if (k0 + row < Tk && col < hd)
      *reinterpret_cast<float4*>((which ? dv : dk) + (((int64_t)b * Tk + k0 + row) * nkv + g) * hd +
                                 col) = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

#endif  // !QT_FLASH_WIDE

#ifdef QT_FLASH_WIDE
// ------------------------------------------------------------ 256 columns
//
// Head dims 129-256: two blocks of a cluster split hd, each holding
// SPLIT_COLS of the 256 columns of every operand and output and
// SPLIT_ROWS own rows (the header comment says why).

constexpr int SPLIT_COLS = 128;  // hd columns of a block of the pair
constexpr int SPLIT_ROWS = 32;   // own rows a block: queries (dQ), keys (dK/dV); wgmma's N

// 64 rows of SPLIT_COLS f32 as cp.async lands them, unpadded (the shared
// memory holds no RAW_PAD here): the 16-byte chunk c of row r sits at chunk
// c ^ 2 (r & 3), so that frag_rows_split's half-warps (rows r..r+3, two
// chunks each) and frag_cols_split's warps (rows 8 kk + q, q < 4, eight
// columns each) meet each bank once.
struct SplitRaw {
  static constexpr int LD = SPLIT_COLS;
  static constexpr uint32_t BYTES = 64 * LD * 4;
  // the float index of element (r, c)
  static __device__ __forceinline__ int at(int r, int c) {
    return r * LD + (((c >> 2) ^ ((r & 3) << 1)) << 2) + (c & 3);
  }
  // rows [r0, r0 + 64), columns [c0, c0 + SPLIT_COLS) of one head of a (B,
  // S, heads, hd) f32 tensor, by a warpgroup's 128 threads (this one
  // `tid`); `src` is row 0 of that batch row and head, `row_stride` heads *
  // hd; rows at or past `rows` and columns at or past hd read as zeros.
  // Thread t copies chunk t % 32 of rows t / 32 + 4 j: its column, and so
  // its swizzled chunk, is the same in every row it copies.
  static __device__ __forceinline__ void load(uint32_t dst, const float* src, int64_t row_stride,
                                              int r0, int rows, int c0, int hd, int tid) {
    static_assert(LD == 128, "one 16-byte chunk a thread in each of its rows");
    const int c = tid % 32, r = tid / 32;
    const bool col_in = c0 + 4 * c < hd;
    const uint32_t to = dst + 4 * at(r, 4 * c);
    const float* from = src + (int64_t)(r0 + r) * row_stride + c0 + 4 * c;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool in = col_in && r0 + r + 4 * j < rows;
      cp_async16(to + j * 4 * LD * 4, in ? from + 4 * j * row_stride : src, in ? 16 : 0);
    }
  }
};

// frag_rows and frag_cols (flash_tf32x3.cuh) over a SplitRaw tile
// (the swizzle moves chunks within 4 k8 slices, so slice kk reads slice kk
// % 4's addresses 32 kk / 4 floats on: four addresses a thread, not 16)
__device__ __forceinline__ void frag_rows_split(const float* raw, int r, int q, int kk,
                                                float (&a)[4]) {
  const float* at = raw + SplitRaw::at(r, 8 * (kk & 3) + 2 * q) + 32 * (kk >> 2);
  const float2 u = *reinterpret_cast<const float2*>(at);
  const float2 w = *reinterpret_cast<const float2*>(at + 8 * SplitRaw::LD);
  a[0] = u.x;
  a[1] = w.x;
  a[2] = u.y;
  a[3] = w.y;
}
__device__ __forceinline__ void frag_cols_split(const float* raw, int m, int q, int kk,
                                                float (&a)[4]) {
  const int r = 8 * kk + q;
  a[0] = raw[SplitRaw::at(r, m)];
  a[1] = raw[SplitRaw::at(r, m + 8)];
  a[2] = raw[SplitRaw::at(r + 4, m)];
  a[3] = raw[SplitRaw::at(r + 4, m + 8)];
}

// ---- the pair's exchange through distributed shared memory

// the address of shared-memory address `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into another block's shared memory at `addr`, completing them
// on that block's mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d,
                                          uint32_t bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
      "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}
// one arrival on another block's mbarrier (a cluster address), releasing
// this thread's writes before it to the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of parity `parity` of this block's mbarrier `bar` has
// completed, acquiring what the arrivals released; a trap after kHangCycles
// (nothing here sets registers with setmaxnreg)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait_cluster(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait_cluster(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// The two blocks of a pair sum their partials of S and dP (E f32 of each a
// thread of a warpgroup, in the accumulator's order) over their halves of
// hd, warpgroup w of one with warpgroup w of the other, through the
// warpgroup's region XCH of each block (float4 j of thread t at j * 128 +
// t: a warp's stores meet each bank once). Each thread stores its partials
// into the other block's XCH by st.async, which completes their bytes on
// that block's FULL mbarrier; it waits on its own FULL for the other's and
// adds them, own + other (the same f32 sum in both blocks: the two then
// form the same p and ds), and thread 0 arms FULL for the next item's
// bytes. The region then holds the item's dS (or P) tiles; once their
// products are done each warp arrives once on the other's FREE (release):
// it may store its next item's partials there.
template <int E> struct PairSum {
  static constexpr uint32_t BYTES = 2 * E * 128 * 4;  // both partials of 128 threads
  uint32_t bars, peer_xch, peer_bars;
  const float4* mine;

  // the warpgroup's region and barriers (FULL at bars, FREE at bars + 8),
  // the other block being `peer`
  __device__ __forceinline__ PairSum(uint32_t xch, uint32_t bars_, const float* mine_,
                                     uint32_t peer)
      : bars(bars_), peer_xch(cluster_addr(xch, peer)), peer_bars(cluster_addr(bars_, peer)),
        mine(reinterpret_cast<const float4*>(mine_)) {}
  // by one thread, before the cluster's first barrier
  static __device__ __forceinline__ void init(uint32_t bars) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 4);
    mbar_init_fence();
    mbar_expect_tx(bars, BYTES);  // item 0's
  }
  // item i's partials s and dp, summed over the pair, by thread t of the
  // warpgroup
  __device__ __forceinline__ void sum(float (&s)[E], float (&dp)[E], int i, int t) {
    mbar_wait_cluster(bars + 8, (i & 1) ^ 1);  // the other is done with item i - 1's region
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      st_async4(peer_xch + (j * 128 + t) * 16, s[4 * j], s[4 * j + 1], s[4 * j + 2],
                s[4 * j + 3], peer_bars);
      st_async4(peer_xch + ((E / 4 + j) * 128 + t) * 16, dp[4 * j], dp[4 * j + 1],
                dp[4 * j + 2], dp[4 * j + 3], peer_bars);
    }
    mbar_wait_cluster(bars, i & 1);  // the other's have landed
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const float4 x = mine[j * 128 + t], y = mine[(E / 4 + j) * 128 + t];
      s[4 * j] += x.x;
      s[4 * j + 1] += x.y;
      s[4 * j + 2] += x.z;
      s[4 * j + 3] += x.w;
      dp[4 * j] += y.x;
      dp[4 * j + 1] += y.y;
      dp[4 * j + 2] += y.z;
      dp[4 * j + 3] += y.w;
    }
    if (t == 0) mbar_expect_tx(bars, BYTES);  // item i + 1's, before any warp frees the region
  }
  // the warpgroup is done with its region (every thread's reads and the
  // products of its tiles): the other block may fill it
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive_cluster(peer_bars + 8);
  }
};

// dQ at 256 columns: a cluster of two blocks per (SPLIT_ROWS query rows,
// head, batch row), block `half` holding hd columns [128 half, 128 half +
// 128), each block two warpgroups, warpgroup w taking key tiles w, w + 2, ..
// through a slot and a region of its own
struct DqSplit {
  static constexpr int BQ = SPLIT_ROWS, WGS = 2;
  using QT = KTile<BQ, SPLIT_COLS>;  // Q, dO hi / lo: the B of S^T = K Q^T, dP^T = V dO^T
  using ST = KTile<BQ, 64>;          // dS hi / lo: the B of dQ^T = K^T dS^T
  static constexpr uint32_t XCH_BYTES = 2 * 64 * BQ * 4;  // the other's S^T, dP^T partials
  static_assert(2 * ST::BYTES == XCH_BYTES, "the dS tiles take the partials' region");
  // Q, dO hi / lo; warpgroup w's region at REG + w XCH_BYTES (the other
  // block's partials, then dS hi / lo) and slot at RING + 2 w RAW (raw K,
  // V); lse, D of the block's rows; warpgroup w's FULL, FREE at BARS + 16 w
  static constexpr uint32_t RAW = SplitRaw::BYTES;
  static constexpr uint32_t Q_HI = 0, Q_LO = QT::BYTES, O_HI = 2 * QT::BYTES,
                            O_LO = 3 * QT::BYTES, REG = 4 * QT::BYTES,
                            RING = REG + WGS * XCH_BYTES, STATS = RING + WGS * 2 * RAW,
                            BARS = STATS + 2 * BQ * 4;
  static constexpr int OUT_LD = SPLIT_COLS + 4;  // each warpgroup's dQ rows, over the ring
  static_assert(WGS * BQ * OUT_LD * 4 <= WGS * 2 * RAW, "the dQ rows fit the ring");
  static constexpr size_t bytes = BARS + 16 * WGS + 1024;
};

__global__ void __launch_bounds__(128 * DqSplit::WGS, 1)
flash_bwd_dq_f32_split(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ q_start, const int* __restrict__ kv_len,
                       float* __restrict__ dq, int Sq, int Tk, int nh, int nkv, int hd,
                       int causal, float scale) {
  using L = DqSplit;
  using QT = L::QT;
  using ST = L::ST;
  constexpr int BQ = L::BQ, WGS = L::WGS;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  auto raw = [&](uint32_t at) { return reinterpret_cast<const float*>(gbase + (at - base)); };
  float* Ls = reinterpret_cast<float*>(gbase + L::STATS);
  float* Ds = Ls + BQ;

  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank(), c0 = half * SPLIT_COLS;
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int h = blockIdx.x / 2, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest rows first
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = causal ? min(kvl, qs + min(q0 + BQ, Sq)) : kvl;
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;  // the pair's alike
  const int n_mine = n_tiles > wg ? (n_tiles - wg + WGS - 1) / WGS : 0;  // tiles wg, wg + 2, ..

  const int64_t q_off = ((int64_t)b * Sq * nh + h) * hd;
  const float* kb = k + ((int64_t)b * Tk * nkv + g) * hd;
  const float* vb = v + ((int64_t)b * Tk * nkv + g) * hd;
  const int64_t kv_stride = (int64_t)nkv * hd;
  const uint32_t reg = base + L::REG + wg * L::XCH_BYTES, slot = base + L::RING + wg * 2 * L::RAW;
  const uint32_t s_hi = reg, s_lo = reg + ST::BYTES;
  const int cols = min(SPLIT_COLS, hd - c0);
  split_hd_tile<BQ, SPLIT_COLS>(base + L::Q_HI, base + L::Q_LO, q + q_off + c0, (int64_t)nh * hd,
                                q0, Sq, tid, 128 * WGS, cols);
  split_hd_tile<BQ, SPLIT_COLS>(base + L::O_HI, base + L::O_LO, dout + q_off + c0,
                                (int64_t)nh * hd, q0, Sq, tid, 128 * WGS, cols);
  for (int i = tid; i < BQ; i += 128 * WGS) {
    const int row = q0 + i;
    const int64_t stat = ((int64_t)b * nh + h) * Sq + row;
    Ls[i] = (row < Sq ? lse[stat] : kDeadLse) * kLog2e;  // base 2
    Ds[i] = row < Sq ? delta[stat] : 0.0f;
  }
  if (tid < WGS) PairSum<BQ / 2>::init(base + L::BARS + 16 * tid);
  PairSum<BQ / 2> pair(reg, base + L::BARS + 16 * wg, raw(reg), half ^ 1);
  fence_proxy_async();
  cluster.sync();  // the split tiles, the statistics and both blocks' barriers are ready
  const float scale2 = scale * kLog2e;

  // this thread's key rows r0, r0 + 8 of a tile (and hd rows of dQ^T);
  // query columns 8 j + 2 q4 + c
  const int r0 = 16 * warp + lane / 4, q4 = lane % 4;
  auto q_hi = [&](int kk) { return QT::desc(base + L::Q_HI, kk); };
  auto q_lo = [&](int kk) { return QT::desc(base + L::Q_LO, kk); };
  auto o_hi = [&](int kk) { return QT::desc(base + L::O_HI, kk); };
  auto o_lo = [&](int kk) { return QT::desc(base + L::O_LO, kk); };
  auto ds_hi = [&](int kk) { return ST::desc(s_hi, kk); };
  auto ds_lo = [&](int kk) { return ST::desc(s_lo, kk); };
  float acc[2][BQ / 2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) acc[sl][e] = 0.0f;

  for (int i = 0; i < n_mine; ++i) {
    const int k0 = (wg + WGS * i) * TILE;
    wg_sync(wg);  // the warpgroup is done with its slot
    SplitRaw::load(slot, kb, kv_stride, k0, Tk, c0, hd, wtid);
    SplitRaw::load(slot + L::RAW, vb, kv_stride, k0, Tk, c0, hd, wtid);
    cp_async_commit();
    cp_async_wait<0>();
    wg_sync(wg);  // the tile has landed for every thread of the warpgroup
    const float* Kr = raw(slot);
    const float* Vr = Kr + L::RAW / 4;

    // the block's partials of S^T and dP^T over its 128 columns, summed
    // with the other block's
    float s[BQ / 2], dp[BQ / 2];
    {
      auto cs = chain<BQ>(s, [&](int kk, float(&a)[4]) { frag_rows_split(Kr, r0, q4, kk, a); },
                          q_hi, q_lo);
      auto cd = chain<BQ>(dp, [&](int kk, float(&a)[4]) { frag_rows_split(Vr, r0, q4, kk, a); },
                          o_hi, o_lo);
      mma_3xtf32<SPLIT_COLS / 8>(cs, cd);
    }
    pair.sum(s, dp, i, wtid);
    wg_sync(wg);  // every thread has read the other's partials: dS takes the region

    // ds^T = p^T (dP^T - D) scale, split into the dS tiles (rows = queries);
    // rows past Sq have lse 1e30, so p = 0 there
    const bool edge = k0 + TILE > kvl || (causal && k0 + TILE - 1 > qs + q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + col);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i2 + c, key = r0 + 8 * i2;
          const bool live = !edge || live_pair(k0 + key, qs + q0 + col + c, kvl, causal);
          const float p = live ? fast_exp2(fmaf(s[e], scale2, -(c ? l2.y : l2.x))) : 0.0f;
          const float ds = p * (dp[e] - (c ? d2.y : d2.x)) * scale;
          uint32_t hi, lo;
          split_tf32(ds, hi, lo);
          const uint32_t off = ST::offset(col + c, key);
          st_shared1(s_hi + off, hi);
          st_shared1(s_lo + off, lo);
        }
    }
    fence_proxy_async();
    wg_sync(wg);  // the dS tiles are whole

    // dQ^T += K^T dS^T over the block's two m64 slabs of hd, the tile's
    // products into a fresh partial
    float part[2][BQ / 2];
    {
      auto c0s = chain<BQ>(part[0], [&](int kk, float(&a)[4]) {
        frag_cols_split(Kr, r0, q4, kk, a);
      }, ds_hi, ds_lo);
      auto c1s = chain<BQ>(part[1], [&](int kk, float(&a)[4]) {
        frag_cols_split(Kr, 64 + r0, q4, kk, a);
      }, ds_hi, ds_lo);
      mma_3xtf32<TILE / 8>(c0s, c1s);
    }
    pair.release();
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) acc[sl][e] = __fadd_rn(acc[sl][e], part[sl][e]);
  }
  __syncthreads();  // every tile read: the dQ rows take the ring over

  // acc[sl][4 j + 2 i + c] is the warpgroup's dQ^T (hd m = c0 + 64 sl + r0
  // + 8 i, query 8 j + 2 q4 + c): staged as rows of queries, one block of
  // rows a warpgroup, then summed in warpgroup order and stored 16 bytes a
  // thread
  float* out = reinterpret_cast<float*>(gbase + L::RING);
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          out[(wg * BQ + 8 * j + 2 * q4 + c) * L::OUT_LD + 64 * sl + r0 + 8 * i] =
              acc[sl][4 * j + 2 * i + c];
  __syncthreads();
  constexpr int V4 = SPLIT_COLS / 4;
  for (int idx = tid; idx < BQ * V4; idx += 128 * WGS) {
    const int row = idx / V4, col = (idx % V4) * 4;
    float4 sum = *reinterpret_cast<const float4*>(out + row * L::OUT_LD + col);
    const float4 x = *reinterpret_cast<const float4*>(out + (BQ + row) * L::OUT_LD + col);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
    if (q0 + row < Sq && c0 + col < hd)
      *reinterpret_cast<float4*>(dq + (((int64_t)b * Sq + q0 + row) * nh + h) * hd + c0 + col) =
          sum;
  }
  cluster.sync();  // no block leaves while the other may still arrive on its barriers
}

// dK/dV at 256 columns: a cluster of 2 C blocks per (SPLIT_ROWS keys, KV
// head, batch row), block rank = 2 part + half: `half` holds hd columns
// [128 half, 128 half + 128), `part` the part-th share of the (rep head,
// query tile) pairs, C picked as dkv_grid picks it, up to MAX_PARTS
// (clusters of at most 8); two warpgroups a block, warpgroup w taking
// every second pair of the share from the w-th through a slot and a
// region of its own
struct DkvSplit {
  static constexpr int BK = SPLIT_ROWS, WGS = 2, MAX_PARTS = 2;
  using KT = KTile<BK, SPLIT_COLS>;  // K, V hi / lo: the B of S = Q K^T, dP = dO V^T
  using PT = KTile<BK, 64>;          // P, then dS, hi / lo: the B of dV^T = dO^T P, dK^T = Q^T dS
  static constexpr uint32_t XCH_BYTES = 2 * 64 * BK * 4;  // the other's S, dP partials
  static_assert(2 * PT::BYTES == XCH_BYTES, "the P / dS tiles take the partials' region");
  // K, V hi / lo; warpgroup w's region at REG + w XCH_BYTES (the other
  // block's partials, then P / dS hi / lo) and slot at RING + w SLOT (raw
  // Q, dO; lse, D of the tile's 64 rows); warpgroup w's FULL, FREE at BARS
  // + 16 w
  static constexpr uint32_t RAW = SplitRaw::BYTES, SLOT = 2 * RAW + 2 * TILE * 4;
  static constexpr uint32_t K_HI = 0, K_LO = KT::BYTES, V_HI = 2 * KT::BYTES,
                            V_LO = 3 * KT::BYTES, REG = 4 * KT::BYTES,
                            RING = REG + WGS * XCH_BYTES, BARS = RING + WGS * SLOT;
  static constexpr int RED_LD = SPLIT_COLS + 4;  // f32 partial rows (keys) the cluster sums
  static_assert(WGS * 2 * BK * RED_LD * 4 <= BARS, "the partials fit below the barriers");
  static constexpr size_t bytes = BARS + 16 * WGS + 1024;
};

__global__ void __launch_bounds__(128 * DkvSplit::WGS, 1)
flash_bwd_dkv_f32_split(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ q_start, const int* __restrict__ kv_len,
                        float* __restrict__ dk, float* __restrict__ dv, int Sq, int Tk, int nh,
                        int nkv, int hd, int causal, float scale) {
  using L = DkvSplit;
  using KT = L::KT;
  using PT = L::PT;
  constexpr int BK = L::BK, WGS = L::WGS;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  auto raw = [&](uint32_t at) { return reinterpret_cast<const float*>(gbase + (at - base)); };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks() / 2;
  const int half = rank & 1, part = rank >> 1, c0 = half * SPLIT_COLS;
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = blockIdx.y % nkv, b = blockIdx.y / nkv, k0 = blockIdx.z * BK;
  const int rep = nh / nkv;
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  // query tiles whose last row reaches key k0: from the one holding row k0 - q_start
  const int qt_begin = causal ? max(0, k0 - qs) / TILE : 0;
  const int qt_end = k0 < kvl ? (Sq + TILE - 1) / TILE : 0;
  const int nq = max(0, qt_end - qt_begin);
  // this part's share of the (rep head, query tile) pairs (the pair of
  // blocks' alike); this warpgroup's: p_lo + wg, p_lo + wg + 2, ..
  const int n_pairs = rep * nq;
  const int p_lo = part * n_pairs / C, p_hi = (part + 1) * n_pairs / C;
  const int n_mine = p_hi - p_lo > wg ? (p_hi - p_lo - wg + WGS - 1) / WGS : 0;

  const uint32_t reg = base + L::REG + wg * L::XCH_BYTES, slot = base + L::RING + wg * L::SLOT;
  const uint32_t pd_hi = reg, pd_lo = reg + PT::BYTES;
  const int64_t kv_off = ((int64_t)b * Tk * nkv + g) * hd + c0;
  const int cols = min(SPLIT_COLS, hd - c0);
  split_hd_tile<BK, SPLIT_COLS>(base + L::K_HI, base + L::K_LO, k + kv_off, (int64_t)nkv * hd, k0,
                                Tk, tid, 128 * WGS, cols);
  split_hd_tile<BK, SPLIT_COLS>(base + L::V_HI, base + L::V_LO, v + kv_off, (int64_t)nkv * hd, k0,
                                Tk, tid, 128 * WGS, cols);
  if (tid < WGS) PairSum<BK / 2>::init(base + L::BARS + 16 * tid);
  PairSum<BK / 2> pair(reg, base + L::BARS + 16 * wg, raw(reg), rank ^ 1);
  fence_proxy_async();
  cluster.sync();  // the split K and V tiles and every block's barriers are ready
  const float scale2 = scale * kLog2e;

  // this thread's query rows r0, r0 + 8 of a pair's tile (and hd rows of
  // dK^T, dV^T); key columns 8 j + 2 q4 + c
  const int r0 = 16 * warp + lane / 4, q4 = lane % 4;
  auto k_hi = [&](int kk) { return KT::desc(base + L::K_HI, kk); };
  auto k_lo = [&](int kk) { return KT::desc(base + L::K_LO, kk); };
  auto v_hi = [&](int kk) { return KT::desc(base + L::V_HI, kk); };
  auto v_lo = [&](int kk) { return KT::desc(base + L::V_LO, kk); };
  auto t_hi = [&](int kk) { return PT::desc(pd_hi, kk); };
  auto t_lo = [&](int kk) { return PT::desc(pd_lo, kk); };
  // x (rows = queries, columns = keys, in the accumulator's order), split,
  // into the warpgroup's P / dS tiles (rows = keys)
  auto store_t = [&](const float(&x)[BK / 2]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t off = PT::offset(8 * j + 2 * q4 + c, r0 + 8 * i);
          uint32_t hi, lo;
          split_tf32(x[4 * j + 2 * i + c], hi, lo);
          st_shared1(pd_hi + off, hi);
          st_shared1(pd_lo + off, lo);
        }
    fence_proxy_async();
    wg_sync(wg);  // the tiles are whole
  };
  float acc_k[2][BK / 2], acc_v[2][BK / 2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) acc_k[sl][e] = acc_v[sl][e] = 0.0f;

  for (int i = 0; i < n_mine; ++i) {
    const int p = p_lo + wg + WGS * i;
    const int h = g * rep + p / nq, q0 = (qt_begin + p % nq) * TILE;
    wg_sync(wg);  // the warpgroup is done with its slot
    {
      const int64_t q_off = ((int64_t)b * Sq * nh + h) * hd;
      SplitRaw::load(slot, q + q_off, (int64_t)nh * hd, q0, Sq, c0, hd, wtid);
      SplitRaw::load(slot + L::RAW, dout + q_off, (int64_t)nh * hd, q0, Sq, c0, hd, wtid);
      // threads 0-63 fetch lse, 64-127 D, of the tile's 64 rows (zeros past Sq)
      const int row = q0 + (wtid & (TILE - 1));
      const float* src = (wtid < TILE ? lse : delta) + ((int64_t)b * nh + h) * Sq;
      cp_async4(slot + 2 * L::RAW + wtid * 4, row < Sq ? src + row : src, row < Sq ? 4 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    wg_sync(wg);  // the pair has landed for every thread of the warpgroup
    const float* Qr = raw(slot);
    const float* Or = Qr + L::RAW / 4;
    const float* Lr = Or + L::RAW / 4;  // lse, then D, of the tile's 64 rows

    // the block's partials of S and dP over its 128 columns, summed with
    // the other block's
    float s[BK / 2], dp[BK / 2];
    {
      auto cs = chain<BK>(s, [&](int kk, float(&a)[4]) { frag_rows_split(Qr, r0, q4, kk, a); },
                          k_hi, k_lo);
      auto cd = chain<BK>(dp, [&](int kk, float(&a)[4]) { frag_rows_split(Or, r0, q4, kk, a); },
                          v_hi, v_lo);
      mma_3xtf32<SPLIT_COLS / 8>(cs, cd);
    }
    pair.sum(s, dp, i, wtid);
    wg_sync(wg);  // every thread has read the other's partials: P takes the region

    // p in place of s, ds in place of dp (rows = queries, lse and D per row)
    const bool edge = k0 + BK > kvl || q0 + TILE > Sq || (causal && k0 + BK - 1 > qs + q0);
    float lse_r[2], d_r[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      lse_r[i2] = Lr[r0 + 8 * i2] * kLog2e;
      d_r[i2] = Lr[TILE + r0 + 8 * i2];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i2 + c, row = q0 + r0 + 8 * i2;
          const bool live =
              !edge || (row < Sq && live_pair(k0 + 8 * j + 2 * q4 + c, qs + row, kvl, causal));
          s[e] = live ? fast_exp2(fmaf(s[e], scale2, -lse_r[i2])) : 0.0f;
          dp[e] = s[e] * (dp[e] - d_r[i2]) * scale;
        }

    // dV^T += dO^T P, then dK^T += Q^T dS through the same tiles, over the
    // block's two m64 slabs of hd one after the other (two chains at once
    // would spill: the four accumulators hold 64 registers), each pair's
    // products into a fresh partial
    auto slab = [&](const float* from, int m0, float(&acc)[BK / 2]) {
      float pt[BK / 2];
      auto cs = chain<BK>(pt, [from, m0, q4](int kk, float(&a)[4]) {
        frag_cols_split(from, m0, q4, kk, a);
      }, t_hi, t_lo);
      mma_3xtf32<TILE / 8>(cs);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) acc[e] = __fadd_rn(acc[e], pt[e]);
    };
    store_t(s);
    slab(Or, r0, acc_v[0]);
    slab(Or, 64 + r0, acc_v[1]);
    wg_sync(wg);  // the products of P are done: dS takes the tiles
    store_t(dp);
    slab(Qr, r0, acc_k[0]);
    slab(Qr, 64 + r0, acc_k[1]);
    pair.release();
  }
  __syncthreads();  // every tile read: the partials take the shared memory over

  // acc[sl][4 j + 2 i + c] is the warpgroup's dK^T / dV^T (hd m = c0 + 64
  // sl + r0 + 8 i, key 8 j + 2 q4 + c): staged as rows of keys, warpgroup
  // w's dK rows then its dV rows
  float* red = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = 64 * sl + r0 + 8 * i, row = 8 * j + 2 * q4 + c;
          red[(2 * wg * BK + row) * L::RED_LD + m] = acc_k[sl][4 * j + 2 * i + c];
          red[((2 * wg + 1) * BK + row) * L::RED_LD + m] = acc_v[sl][4 * j + 2 * i + c];
        }
  cluster.sync();  // every block's partials are in its shared memory

  // this block sums rows [part * BK / C, (part + 1) * BK / C) of its half's
  // dK and dV over the C parts and their warpgroups, in that order, and
  // writes them
  const int rows = BK / C, row0 = part * rows;
  constexpr int V4 = SPLIT_COLS / 4;
  for (int idx = tid; idx < 2 * rows * V4; idx += 128 * WGS) {
    const int which = idx / (rows * V4), rem = idx % (rows * V4);
    const int row = row0 + rem / V4, col = (rem % V4) * 4;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < C; ++r)
#pragma unroll
      for (int w = 0; w < WGS; ++w) {
        float* src = red + ((2 * w + which) * BK + row) * L::RED_LD + col;
        const float4 x =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 2 * r + half));
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
    if (k0 + row < Tk && c0 + col < hd)
      *reinterpret_cast<float4*>((which ? dv : dk) + (((int64_t)b * Tk + k0 + row) * nkv + g) * hd +
                                 c0 + col) = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}
#endif  // QT_FLASH_WIDE

// The f32 route's kernels at compiled width HD: they take hd at run time
// at every width, so PAD picks nothing here
struct F32Route {
  template <int HD, bool PAD> static auto dq(int B, int Sq, int nh) {
#ifdef QT_FLASH_WIDE
    return plan(dim3(2 * nh, B, (Sq + DqSplit::BQ - 1) / DqSplit::BQ), 2, flash_bwd_dq_f32_split,
                DqSplit::WGS, DqSplit::bytes, 1);
#else
    using L = DqF32<HD>;
    return plan(dim3(nh, B, (Sq + L::BQ - 1) / L::BQ), 1, flash_bwd_dq_f32<HD>, L::WGS,
                L::bytes, L::RS);
#endif
  }
  template <int HD, bool PAD> static auto dkv(int B, int Sq, int Tk, int nh, int nkv) {
#ifdef QT_FLASH_WIDE
    // dkv_grid's rule over the pair's blocks, the parts up to MAX_PARTS
    const int key_tiles = (Tk + DkvSplit::BK - 1) / DkvSplit::BK;
    const int64_t blocks = 2LL * key_tiles * nkv * B;
    const int max_pairs = (nh / nkv) * ((Sq + TILE - 1) / TILE);
    int c = 1;
    while (c < DkvSplit::MAX_PARTS && c < max_pairs && blocks * c < 2LL * sm_count()) c *= 2;
    return plan(dim3(2 * c, nkv * B, key_tiles), 2 * c, flash_bwd_dkv_f32_split, DkvSplit::WGS,
                DkvSplit::bytes, 1);
#else
    using L = DkvF32<HD>;
    const DkvGrid lg = dkv_grid(B, Sq, Tk, nh, nkv, L::BK);
    return plan(lg.grid, lg.cluster, flash_bwd_dkv_f32<HD>, L::WGS, L::bytes, L::RS);
#endif
  }
};

}  // namespace

// q, k, v, dO, lse, D (f32 (B, nh, Sq)), q_start, kv_len (int32), dq (f32,
// q's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_dq_f32)(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* q_start, const void* kv_len, void* dq, int B,
                                   int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                   float scale, void* stream) {
  return launch_bwd<F32Route, float, false>(q, k, v, dout, lse, delta, q_start, kv_len, dq,
                                            nullptr, B, Sq, Tk, nh, nkv, hd, causal, scale,
                                            stream);
}

// ... dk, dv (f32, k's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_dkv_f32)(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dk, void* dv,
                                    int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd<F32Route, float, true>(q, k, v, dout, lse, delta, q_start, kv_len, dk, dv,
                                           B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
}

// The launch of this route's kernel for a report (flash_bwd.cuh's design)
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_f32_design)(int dkv, int hd, int B, int Sq, int Tk, int nh, int nkv,
                                       int* out) {
  return design<F32Route>(dkv != 0, hd, B, Sq, Tk, nh, nkv, out);
}
