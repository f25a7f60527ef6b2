// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replace the Pallas TPU kernels of quanta_tpu/ops/attention.py:
// _backward_impl, _flash_bwd_dq_kernel (dQ) and _flash_bwd_dkv_kernel
// (dK, dV). Recompute flash: from the forward's lse (1e30 on rows with no
// live key) and D = rowsum(dO * O), computed by the wrapper,
//
//   p  = exp(s * scale - lse)     (0 where the pair is masked)
//   ds = p * (dO . v - D) * scale
//   dQ = sum_j ds k_j,   dV = sum_i p dO_i,   dK = sum_i ds q_i
//
// with p and ds rounded to the operand type before each product, as the
// TPU kernels round `p.astype(...)` and `ds.astype(...)`, and f32 sums; the
// outputs are f32 (the wrapper casts them). A (query tile, key tile) pair
// is skipped when no pair in it is live.
//
// What bounds them on the H100: at TinyLlama's s1024 b2 training shape the
// dQ kernel does 3 and the dK/dV kernel 4 products of 2 * B * nh *
// (S(S+1)/2) * hd flops (~13 and ~17 GFLOP a layer): bound by the tensor
// cores (bf16: ~30 us together at 989 TFLOP/s; f32: flash_bwd_f32.cu).
//
// bf16 (the pieces are sm90.cuh's). One warpgroup (128 threads) owns a
// 64-row tile, wgmma's M:
//   - dQ: one block per (query tile, head, batch row), blocks ordered so the
//     rep query heads of a KV head run side by side (K and V come from L2)
//     and the query tiles with the most live key tiles start first. It
//     streams K and V tiles through a cp.async ring of STAGES; per tile,
//     S = Q K^T and dP = dO V^T are wgmma from shared memory, ds is formed
//     in the accumulator registers (lse and D are per row, in registers),
//     rounded to bf16 there and is the register A operand of dQ += ds K
//     (K read MN-major: the same tile under a second descriptor).
//   - dK/dV: one cluster of C blocks per (key tile, KV head, batch row),
//     the heavy key tiles of the causal triangle first. The (rep head, live
//     query tile) pairs of a key tile are split evenly over the cluster's
//     blocks, so MHA (rep 1) splits too; each block streams the Q, dO, lse
//     and D of its pairs through the cp.async ring, computes S^T = K Q^T and
//     dP^T = V dO^T from shared memory, forms p^T and ds^T in the
//     accumulator registers (lse and D per query column, from shared memory)
//     and adds p^T dO and ds^T Q with register A operands (dO and Q read
//     MN-major). The blocks then sum their f32 partials through distributed
//     shared memory in rank order, each block summing and writing 64 / C of
//     the rows: no atomics, no extra pass over device memory, the same bits
//     on every run. C is picked from the grid: the smallest power of two up
//     to 8 that gives two blocks an SM, and no more than the pairs a key
//     tile can have (TinyLlama's s1024 shape: 128 key tiles, C = 4;
//     Llama-2-7B's: 512, C = 1). A split costs a K/V load and a partial
//     per block, so larger clusters measured slower where the grid already
//     fills the card. At hd <= 64 the kernel is held to 168 registers, 3
//     blocks an SM (231 unbounded, 2 blocks; 20% faster on the H100).
// No score tile goes through shared memory, and both kernels are
// deterministic.
//
// Head dims: compiled at 32, 64, 128 and (flash_bwd_w256.cu) 256 columns, a
// head dim in between run padded (flash_common.cuh). At 256 the dQ kernel is
// the same (its m64 x 256 accumulator 128 registers a thread, as the
// forward's O); the dK/dV kernel's two accumulators are not, so grid y
// splits each (batch row, KV head) into two blocks that each own 128
// columns of dK and dV, each computing S^T and dP^T over all 256 (DkvSmem::
// SPLITS). The f32 route: flash_bwd_f32.cu; the launch both share:
// flash_bwd.cuh.

#include <cooperative_groups.h>

#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

// ------------------------------------------------------- bf16: Hopper

using bf16 = __nv_bfloat16;
constexpr int STAGES = 2;  // the cp.async ring of streamed tiles (3 measured no faster)

template <int HD> struct DqSmem {  // Q, dO, then STAGES x (K, V)
  static constexpr size_t bytes = (2 + 2 * STAGES) * Tile<HD>::BYTES + 1024;
};

template <int HD> struct DkvSmem {  // K, V, then STAGES x (Q, dO), STAGES x (lse, D)
  // columns of dK and dV a block owns: at HD 256 the two m64 x 256
  // accumulators do not fit one warpgroup's registers, so SPLITS blocks
  // each own 128 columns (S^T and dP^T, over all 256, computed by each)
  static constexpr int OW = HD == 256 ? 128 : HD, SPLITS = HD / OW;
  static constexpr uint32_t STATS = (2 + 2 * STAGES) * Tile<HD>::BYTES;
  static constexpr int RED_LD = OW + 8;  // f32 partial rows: 32-byte shift, few bank conflicts
  static constexpr size_t tiles = STATS + STAGES * 2 * TILE * 4;
  static constexpr size_t red = 2 * TILE * RED_LD * 4;  // dK, dV partials, after the loop
  static constexpr size_t bytes = (tiles > red ? tiles : red) + 1024;
};

template <int HD, bool PAD>
__global__ void __launch_bounds__(128)
flash_bwd_dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ q_start, const int* __restrict__ kv_len,
                  float* __restrict__ dq, int Sq, int Tk, int nh, int nkv, int hd_arg, int causal,
                  float scale) {
  using TL = Tile<HD>;
  const int hd = PAD ? hd_arg : HD;  // the real head dim, of HD columns
  extern __shared__ unsigned char smem[];
  const uint32_t Qs = aligned_base(smem), dOs = Qs + TL::BYTES;
  auto Ks = [&](int st) { return Qs + (2 + 2 * st) * TL::BYTES; };
  auto Vs = [&](int st) { return Qs + (3 + 2 * st) * TL::BYTES; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TILE;  // the longest rows first
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = live_kv_end(qs, q0, Sq, kvl, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;

  const int64_t q_off = ((int64_t)b * Sq * nh + h) * hd;
  const bf16* kb = k + ((int64_t)b * Tk * nkv + g) * hd;
  const bf16* vb = v + ((int64_t)b * Tk * nkv + g) * hd;
  const int64_t kv_stride = (int64_t)nkv * hd;
  TL::load(Qs, q + q_off, (int64_t)nh * hd, q0, Sq, hd);
  TL::load(dOs, dout + q_off, (int64_t)nh * hd, q0, Sq, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      TL::load(Ks(st), kb, kv_stride, st * TILE, Tk, hd);
      TL::load(Vs(st), vb, kv_stride, st * TILE, Tk, hd);
    }
    cp_async_commit();
  }

  // this thread's rows r_lo and r_lo + 8 of the tile: lse (scaled to base
  // 2) and D in registers
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    const int64_t stat = ((int64_t)b * nh + h) * Sq + row;
    lse2[i] = (row < Sq ? lse[stat] : kDeadLse) * kLog2e;
    dlt[i] = row < Sq ? delta[stat] : 0.0f;
  }
  const float scale2 = scale * kLog2e;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; and the ring slot of t - 1 is free
    if (t + STAGES - 1 < n_tiles) {
      const int tn = t + STAGES - 1;
      TL::load(Ks(tn % STAGES), kb, kv_stride, tn * TILE, Tk, hd);
      TL::load(Vs(tn % STAGES), vb, kv_stride, tn * TILE, Tk, hd);
    }
    cp_async_commit();
    const uint32_t Kt = Ks(t % STAGES), Vt = Vs(t % STAGES);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64>(s, TL::k_major(Qs, kk), TL::k_major(Kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64>(dp, TL::k_major(dOs, kk), TL::k_major(Vt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dp - D) scale, in place of dp
    const int k0 = t * TILE;
    const bool edge = k0 + TILE > kvl || (causal && k0 + TILE - 1 > qs + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const bool live =
              !edge || live_pair(k0 + 8 * j + c_lo + c, qs + q0 + r_lo + 8 * i, kvl, causal);
          const float p = live ? exp2f(s[e] * scale2 - lse2[i]) : 0.0f;
          dp[e] = p * (dp[e] - dlt[i]) * scale;
        }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(dp, kk, a[kk]);

    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(acc, a[kk], TL::mn_major(Kt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    if (row >= Sq) continue;
    float* out = dq + (((int64_t)b * Sq + row) * nh + h) * hd + c_lo;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (!PAD || 8 * j + c_lo < hd)  // not a padded column
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int HD, bool PAD>
__global__ void __launch_bounds__(128, HD <= 64 ? 3 : 1)  // HD <= 64: 168 registers, 3 blocks an SM
flash_bwd_dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ q_start, const int* __restrict__ kv_len,
                   float* __restrict__ dk, float* __restrict__ dv, int Sq, int Tk, int nh,
                   int nkv, int hd_arg, int causal, float scale) {
  using TL = Tile<HD>;
  const int hd = PAD ? hd_arg : HD;  // the real head dim, of HD columns
  using SM = DkvSmem<HD>;
  extern __shared__ unsigned char smem[];
  const uint32_t Ks = aligned_base(smem), Vs = Ks + TL::BYTES;
  unsigned char* smem_al = smem + (Ks - smem_addr(smem));  // generic pointer to Ks
  auto Qs = [&](int st) { return Ks + (2 + 2 * st) * TL::BYTES; };
  auto dOs = [&](int st) { return Ks + (3 + 2 * st) * TL::BYTES; };
  auto stats = [&](int st) { return SM::STATS + st * 2 * TILE * 4; };  // lse, then D

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  constexpr int OW = SM::OW;
  // unsigned, as blockIdx.y: g and b are an unsigned remainder and quotient
  // (signed ones changed the 128-column kernel's register allocation)
  const unsigned by = blockIdx.y / SM::SPLITS;
  const int oc = (blockIdx.y % SM::SPLITS) * OW;  // the block's first column of dK, dV
  const int g = by % nkv, b = by / nkv, k0 = blockIdx.z * TILE;
  const int rep = nh / nkv;
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  // query tiles whose last row reaches key k0: from the one holding row k0 - q_start
  const int qt_begin = causal ? max(0, k0 - qs) / TILE : 0;
  const int qt_end = k0 < kvl ? (Sq + TILE - 1) / TILE : 0;
  const int nq = max(0, qt_end - qt_begin);
  // this block's share of the (rep head, query tile) pairs, in rank order
  const int n_pairs = rep * nq;
  const int p_lo = rank * n_pairs / C, p_hi = (rank + 1) * n_pairs / C;

  const int64_t kv_off = ((int64_t)b * Tk * nkv + g) * hd;
  TL::load(Ks, k + kv_off, (int64_t)nkv * hd, k0, Tk, hd);
  TL::load(Vs, v + kv_off, (int64_t)nkv * hd, k0, Tk, hd);
  auto load_pair = [&](int p, int st) {
    const int h = g * rep + p / nq, q0 = (qt_begin + p % nq) * TILE;
    const int64_t q_off = ((int64_t)b * Sq * nh + h) * hd;
    TL::load(Qs(st), q + q_off, (int64_t)nh * hd, q0, Sq, hd);
    TL::load(dOs(st), dout + q_off, (int64_t)nh * hd, q0, Sq, hd);
    // threads 0-63 fetch lse, 64-127 D, of the tile's 64 rows (zeros past Sq)
    const int row = q0 + (tid & (TILE - 1));
    const float* src = (tid < TILE ? lse : delta) + ((int64_t)b * nh + h) * Sq;
    cp_async4(Ks + stats(st) + tid * 4, row < Sq ? src + row : src, row < Sq ? 4 : 0);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (p_lo + st < p_hi) load_pair(p_lo + st, st);
    cp_async_commit();
  }

  // this thread's key rows r_lo and r_lo + 8; query columns 8j + c_lo + c
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  const float scale2 = scale * kLog2e;
  float acc_k[OW / 2], acc_v[OW / 2];
#pragma unroll
  for (int i = 0; i < OW / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
  for (int p = p_lo; p < p_hi; ++p) {
    const int it = p - p_lo, st = it % STAGES;
    cp_async_wait<STAGES - 2>();  // pair p has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; and the ring slot of p - 1 is free
    if (p + STAGES - 1 < p_hi) load_pair(p + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const int q0 = (qt_begin + p % nq) * TILE;
    const uint32_t Qt = Qs(st), dOt = dOs(st);
    const float* L = reinterpret_cast<const float*>(smem_al + stats(st));
    const float* D = L + TILE;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64>(s, TL::k_major(Ks, kk), TL::k_major(Qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64>(dp, TL::k_major(Vs, kk), TL::k_major(dOt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p^T in place of s, ds^T in place of dp
    const bool edge =
        k0 + TILE > kvl || q0 + TILE > Sq || (causal && k0 + TILE - 1 > qs + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c_lo;
      const float2 l2 = *reinterpret_cast<const float2*>(L + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const int kpos = k0 + r_lo + 8 * i, qc = col + c;
          const bool live =
              !edge || (q0 + qc < Sq && live_pair(kpos, qs + q0 + qc, kvl, causal));
          s[e] = live ? exp2f(s[e] * scale2 - (c ? l2.y : l2.x) * kLog2e) : 0.0f;
        }
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, pa[kk]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(D + 8 * j + c_lo);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          dp[e] = s[e] * (dp[e] - (c ? d2.y : d2.x)) * scale;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(dp, kk, da[kk]);

    wgmma_fence();
    fence_regs(acc_v);
    fence_regs(acc_k);
    // (the block's columns of dO and Q: from the 64-column block oc / 64)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<OW>(acc_v, pa[kk], TL::mn_major(dOt + (oc / 64) * TL::HALF, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<OW>(acc_k, da[kk], TL::mn_major(Qt + (oc / 64) * TL::HALF, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile read: the partials take the shared memory over

  float* red = reinterpret_cast<float*>(smem_al);  // dK rows, then dV rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* rk = red + (r_lo + 8 * i) * SM::RED_LD + c_lo;
    float* rv = rk + TILE * SM::RED_LD;
#pragma unroll
    for (int j = 0; j < OW / 8; ++j) {
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(rk + 8 * j) = make_float2(acc_k[e], acc_k[e + 1]);
      *reinterpret_cast<float2*>(rv + 8 * j) = make_float2(acc_v[e], acc_v[e + 1]);
    }
  }
  cluster.sync();  // every block's partials are in its shared memory

  // this block sums rows [rank * 64 / C, (rank + 1) * 64 / C) of dK and dV
  // over the cluster, in rank order, and writes them
  const int rows = TILE / C, row0 = rank * rows;
  constexpr int V4 = OW / 4;
  for (int idx = tid; idx < 2 * rows * V4; idx += 128) {
    const int which = idx / (rows * V4), rem = idx % (rows * V4);
    const int row = row0 + rem / V4, col = (rem % V4) * 4;
    float* src = red + (which * TILE + row) * SM::RED_LD + col;
    float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
    for (int r = 1; r < C; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, r));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (k0 + row < Tk && (!PAD || oc + col < hd))
      *reinterpret_cast<float4*>((which ? dv : dk) + (((int64_t)b * Tk + k0 + row) * nkv + g) * hd +
                                 oc + col) = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The bf16 route's kernels at compiled width HD, padded or not (dK/dV: grid
// y counts each (batch row, KV head) SPLITS times, one block a column slab)
struct Bf16Route {
  template <int HD, bool PAD> static auto dq(int B, int Sq, int nh) {
    return plan(dim3(nh, B, (Sq + TILE - 1) / TILE), 1, flash_bwd_dq_sm90<HD, PAD>, 1,
                DqSmem<HD>::bytes, STAGES);
  }
  template <int HD, bool PAD> static auto dkv(int B, int Sq, int Tk, int nh, int nkv) {
    const DkvGrid lg = dkv_grid(B * DkvSmem<HD>::SPLITS, Sq, Tk, nh, nkv, TILE);
    return plan(lg.grid, lg.cluster, flash_bwd_dkv_sm90<HD, PAD>, 1, DkvSmem<HD>::bytes, STAGES);
  }
};

}  // namespace

// q, k, v, dO, lse, D (f32 (B, nh, Sq)), q_start, kv_len (int32), dq (f32,
// q's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_dq_bf16)(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dq, int B,
                                    int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd<Bf16Route, bf16>(false, q, k, v, dout, lse, delta, q_start, kv_len, dq,
                                     nullptr, B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
}

// ... dk, dv (f32, k's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_dkv_bf16)(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* q_start, const void* kv_len, void* dk, void* dv,
                                     int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                     float scale, void* stream) {
  return launch_bwd<Bf16Route, bf16>(true, q, k, v, dout, lse, delta, q_start, kv_len, dk, dv,
                                     B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
}

// The launch of this route's kernel for a report (flash_bwd.cuh's design)
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_design)(int dkv, int hd, int B, int Sq, int Tk, int nh, int nkv,
                                   int* out) {
  return design<Bf16Route>(dkv != 0, hd, B, Sq, Tk, nh, nkv, out);
}
