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
// forward's O); dK and dV's two accumulators do not fit one warpgroup, so
// the dK/dV kernel is flash_bwd_dkv_ws below (two consumer warpgroups, one
// accumulator each, fed by a TMA producer). The f32 route:
// flash_bwd_f32.cu; the launch both share: flash_bwd.cuh.

#include <cooperative_groups.h>

#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "sm90.cuh"
#ifdef QT_FLASH_WIDE
#include "ws_sm90.cuh"
#endif

namespace {

namespace cg = cooperative_groups;

// ------------------------------------------------------- bf16: Hopper

using bf16 = __nv_bfloat16;
constexpr int STAGES = 2;  // the cp.async ring of streamed tiles (3 measured no faster)

template <int HD> struct DqSmem {  // Q, dO, then STAGES x (K, V)
  static constexpr size_t bytes = (2 + 2 * STAGES) * Tile<HD>::BYTES + 1024;
};

template <int HD> struct DkvSmem {  // K, V, then STAGES x (Q, dO), STAGES x (lse, D)
  static constexpr uint32_t STATS = (2 + 2 * STAGES) * Tile<HD>::BYTES;
  static constexpr int RED_LD = HD + 8;  // f32 partial rows: 32-byte shift, few bank conflicts
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
  // unsigned, as blockIdx.y: g and b are an unsigned remainder and quotient
  // (signed ones changed the 128-column kernel's register allocation)
  const unsigned by = blockIdx.y;
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
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(acc_v, pa[kk], TL::mn_major(dOt, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(acc_k, da[kk], TL::mn_major(Qt, kk));
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
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(rk + 8 * j) = make_float2(acc_k[e], acc_k[e + 1]);
      *reinterpret_cast<float2*>(rv + 8 * j) = make_float2(acc_v[e], acc_v[e + 1]);
    }
  }
  cluster.sync();  // every block's partials are in its shared memory

  // this block sums rows [rank * 64 / C, (rank + 1) * 64 / C) of dK and dV
  // over the cluster, in rank order, and writes them
  const int rows = TILE / C, row0 = rank * rows;
  constexpr int V4 = HD / 4;
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
    if (k0 + row < Tk && (!PAD || col < hd))
      *reinterpret_cast<float4*>((which ? dv : dk) + (((int64_t)b * Tk + k0 + row) * nkv + g) * hd +
                                 col) = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

#ifdef QT_FLASH_WIDE
// ---------------------------------- bf16 dK/dV at 256 columns: warp-specialised

// Shared memory: K, V, then WS_STAGES x (Q, dO), WS_STAGES x (lse, D), p^T
// (f32, 64 x 64), the mbarriers: K and V's full, each slot's full and empty.
// After the loop the f32 partials (dK rows, then dV rows) take the tiles'
// bytes over, up to the mbarriers.
struct DkvWs {
  using TL = Tile<256>;
  static constexpr uint32_t K = 0, V = TL::BYTES, QDO = 2 * TL::BYTES;  // slot s: Q, dO at 2 s
  static constexpr uint32_t STATS = QDO + WS_STAGES * 2 * TL::BYTES;   // slot s: lse, D at s
  static constexpr uint32_t P = STATS + WS_STAGES * 2 * TILE * 4;
  static constexpr uint32_t KV_FULL = P + TILE * TILE * 4, FULL = KV_FULL + 8,
                            EMPTY = FULL + 8 * WS_STAGES;
  static constexpr int RED_LD = 256 + 8;  // f32 partial rows, as DkvSmem's
  static_assert(2 * TILE * RED_LD * 4 <= KV_FULL, "the partials leave the mbarriers alone");
  static constexpr size_t bytes = EMPTY + 8 * WS_STAGES + 1024;
};
// setmaxnreg: the producer's registers and the consumers' (40 x 128 + 232 x 256 = 168 x 384)
constexpr int DKV_WS_PRODUCER_REGS = 40, DKV_WS_CONSUMER_REGS = 232;
// named barriers of the two consumers: p^T written, p^T read, both past the loop
constexpr int P_READY = 1, P_FREE = 2, DKV_DONE = 3;

// Head dims 129-256 (bf16): flash_bwd_dkv_sm90's function with grid y back
// to nkv * B (no column split), by two consumer warpgroups that share one
// key tile and a producer warpgroup (ws_sm90.cuh). The producer's one
// thread loads K and V once by TMA, then streams each (rep head, query
// tile) pair's Q and dO by TMA, and its warp the pair's lse and D by
// cp.async, through a ring of WS_STAGES slots. Consumer 0 computes S^T = K
// Q^T, forms p^T, writes it (f32) to shared memory for consumer 1 and adds
// dV += p^T dO (p^T rounded to bf16 in registers, dO read MN-major).
// Consumer 1 computes dP^T = V dO^T, reads p^T once consumer 0 has written
// it (named barriers), forms ds^T = p^T (dP^T - D) scale and adds dK +=
// ds^T Q. Each of the four products is computed once, each consumer keeps
// one m64 x 256 accumulator (128 registers), and consumer 0 runs ahead by
// its exponentials: its products overlap consumer 1's, its elementwise work
// consumer 1's products. The cluster sums the partials as
// flash_bwd_dkv_sm90 does.
template <bool PAD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkv_ws(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_start, const int* __restrict__ kv_len,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Tk, int nh, int nkv,
                 int hd_arg, int causal, float scale) {
  using TL = Tile<256>;
  using L = DkvWs;
  constexpr int HD = 256;
  const int hd = PAD ? hd_arg : HD;  // the real head dim, of HD columns
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int wg = warpgroup(), wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = threadIdx.x % 32;
  const unsigned by = blockIdx.y;
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
  const int p_lo = rank * n_pairs / C, n = (rank + 1) * n_pairs / C - p_lo;

  if (threadIdx.x == 0) {
    mbar_init(base + L::KV_FULL, 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1 + 32);  // the TMA bytes' arrival, the warp's lse / D
      mbar_init(base + L::EMPTY + 8 * s, 8);      // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WS_CONSUMERS) {  // the producer: its first warp loads
    regs_dec<DKV_WS_PRODUCER_REGS>();
    if (warp == 0 && n > 0) {
      if (lane == 0) {
        mbar_expect_tx(base + L::KV_FULL, 2 * TL::BYTES);
        tma_tile<HD>(base + L::K, &tk, base + L::KV_FULL, g, k0, b);
        tma_tile<HD>(base + L::V, &tv, base + L::KV_FULL, g, k0, b);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % WS_STAGES, p = p_lo + j;
        const int h = g * rep + p / nq, q0 = (qt_begin + p % nq) * TILE;
        const uint32_t full = base + L::FULL + 8 * s, Qt = base + L::QDO + 2 * s * TL::BYTES;
        mbar_wait_guarded(base + L::EMPTY + 8 * s, ((j / WS_STAGES) & 1) ^ 1);  // its last phase
        if (lane == 0) {
          mbar_expect_tx(full, 2 * TL::BYTES);
          tma_tile<HD>(Qt, &tq, full, h, q0, b);
          tma_tile<HD>(Qt + TL::BYTES, &tdo, full, h, q0, b);
        }
        // lse, then D, of the tile's 64 rows (zeros past Sq): 4 a lane
        const int64_t stat = ((int64_t)b * nh + h) * Sq;
#pragma unroll
        for (int i = lane; i < 2 * TILE; i += 32) {
          const int row = q0 + (i & (TILE - 1));
          const float* src = (i < TILE ? lse : delta) + stat;
          cp_async4(base + L::STATS + s * 2 * TILE * 4 + i * 4, row < Sq ? src + row : src,
                    row < Sq ? 4 : 0);
        }
        mbar_arrive_cp_async(full);
      }
    }
    cluster.sync();  // the consumers' two cluster barriers
    cluster.sync();
    return;
  }
  regs_inc<DKV_WS_CONSUMER_REGS>();

  const int c = wg;  // 0: S^T, p^T, dV; 1: dP^T, ds^T, dK
  // this thread's key rows r_lo and r_lo + 8; query columns 8j + c_lo + cc
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  const float scale2 = scale * kLog2e;
  // p^T in the two consumers' common fragment order: element e of thread t at 128 e + t
  float* pt = reinterpret_cast<float*>(gbase + L::P) + wtid;
  float acc[HD / 2];  // consumer 0: dV, 1: dK
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  if (n > 0) mbar_wait(base + L::KV_FULL, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % WS_STAGES, p = p_lo + j;
    const int q0 = (qt_begin + p % nq) * TILE;
    const uint32_t Qt = base + L::QDO + 2 * s * TL::BYTES, dOt = Qt + TL::BYTES;
    const float* Ls = reinterpret_cast<const float*>(gbase + L::STATS + s * 2 * TILE * 4);
    const float* Ds = Ls + TILE;
    mbar_wait(base + L::FULL + 8 * s, (j / WS_STAGES) & 1);
    float x[32];
    uint32_t a[4][4];
    if (c == 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<64>(x, TL::k_major(base + L::K, kk), TL::k_major(Qt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      // p^T in place of S^T (flash_bwd_dkv_sm90's arithmetic, with the
      // forward's fast_exp2: its accurate exp2f took 15% of this kernel at
      // Gemma-2B's shape, on the chain that hands p^T to consumer 1)
      const bool edge =
          k0 + TILE > kvl || q0 + TILE > Sq || (causal && k0 + TILE - 1 > qs + q0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + c_lo;
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + col);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int e = 4 * jj + 2 * i + cc;
            const int kpos = k0 + r_lo + 8 * i, qc = col + cc;
            const bool live =
                !edge || (q0 + qc < Sq && live_pair(kpos, qs + q0 + qc, kvl, causal));
            x[e] = live ? fast_exp2(x[e] * scale2 - (cc ? l2.y : l2.x) * kLog2e) : 0.0f;
          }
      }
      if (j > 0) named_sync(P_FREE, 256);  // consumer 1 has read pair j - 1's
#pragma unroll
      for (int e = 0; e < 32; ++e) pt[128 * e] = x[e];
      named_arrive_if(P_READY, 256, true);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(x, kk, a[kk]);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(acc, a[kk], TL::mn_major(dOt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<64>(x, TL::k_major(base + L::V, kk), TL::k_major(dOt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      named_sync(P_READY, 256);
      // ds^T in place of dP^T, from the f32 p^T (flash_bwd_dkv_sm90's arithmetic)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * jj + c_lo);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int e = 4 * jj + 2 * i + cc;
            x[e] = pt[128 * e] * (x[e] - (cc ? d2.y : d2.x)) * scale;
          }
      }
      named_arrive_if(P_FREE, 256, j + 1 < n);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(x, kk, a[kk]);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(acc, a[kk], TL::mn_major(Qt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive_if(base + L::EMPTY + 8 * s, lane == 0);
  }
  named_sync(DKV_DONE, 256);  // every tile read: the partials take the shared memory over
  fence_proxy_async();

  float* red = reinterpret_cast<float*>(gbase);  // dK rows, then dV rows
  float* own = red + (c == 0 ? TILE : 0) * L::RED_LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* r = own + (r_lo + 8 * i) * L::RED_LD + c_lo;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<float2*>(r + 8 * jj) =
          make_float2(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
  cluster.sync();  // every block's partials are in its shared memory

  // this block sums rows [rank * 64 / C, (rank + 1) * 64 / C) of dK and dV
  // over the cluster, in rank order, and writes them
  const int rows = TILE / C, row0 = rank * rows;
  constexpr int V4 = HD / 4;
  for (int idx = threadIdx.x; idx < 2 * rows * V4; idx += 128 * WS_CONSUMERS) {
    const int which = idx / (rows * V4), rem = idx % (rows * V4);
    const int row = row0 + rem / V4, col = (rem % V4) * 4;
    float* src = red + (which * TILE + row) * L::RED_LD + col;
    float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
    for (int r = 1; r < C; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, r));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (k0 + row < Tk && (!PAD || col < hd))
      *reinterpret_cast<float4*>((which ? dv : dk) + (((int64_t)b * Tk + k0 + row) * nkv + g) * hd +
                                 col) = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}
#endif  // QT_FLASH_WIDE

// The bf16 route's kernels at compiled width HD, padded or not (dK/dV at
// 256 columns: flash_bwd_dkv_ws, two consumer warpgroups and a producer)
struct Bf16Route {
  template <int HD, bool PAD> static auto dq(int B, int Sq, int nh) {
    return plan(dim3(nh, B, (Sq + TILE - 1) / TILE), 1, flash_bwd_dq_sm90<HD, PAD>, 1,
                DqSmem<HD>::bytes, STAGES);
  }
  template <int HD, bool PAD> static auto dkv(int B, int Sq, int Tk, int nh, int nkv) {
#ifdef QT_FLASH_WIDE
    // (dkv_grid's rule: C = 8 at Gemma-2B's s1024 shape, which measured
    // faster than C = 4 with one block an SM; PERF.md)
    const DkvGrid lg = dkv_grid(B, Sq, Tk, nh, nkv, TILE);
    return plan(lg.grid, lg.cluster, flash_bwd_dkv_ws<PAD>, WS_CONSUMERS, DkvWs::bytes,
                WS_STAGES, WS_THREADS);
#else
    const DkvGrid lg = dkv_grid(B, Sq, Tk, nh, nkv, TILE);
    return plan(lg.grid, lg.cluster, flash_bwd_dkv_sm90<HD, PAD>, 1, DkvSmem<HD>::bytes, STAGES);
#endif
  }
};

#ifdef QT_FLASH_WIDE
// q, k, v, dO by TMA: hd a multiple of 8 (the wrapper pads the others)
template <bool PAD>
int launch_dkv_ws(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, const void* q_start, const void* kv_len, void* dk, void* dv,
                  int B, int Sq, int Tk, int nh, int nkv, int hd, int causal, float scale,
                  void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!tile_map(&mq, q, B, Sq, nh, hd) || !tile_map(&mk, k, B, Tk, nkv, hd) ||
      !tile_map(&mv, v, B, Tk, nkv, hd) || !tile_map(&mdo, dout, B, Sq, nh, hd))
    return (int)cudaErrorInvalidValue;
  const auto p = Bf16Route::dkv<256, PAD>(B, Sq, Tk, nh, nkv);
  return launch_cluster(p.kernel, p.grid, p.cluster, p.threads, p.smem, stream, mq, mk,
                        mv, mdo, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<const int*>(q_start),
                        static_cast<const int*>(kv_len), static_cast<float*>(dk),
                        static_cast<float*>(dv), Sq, Tk, nh, nkv, hd, causal, scale);
}
#endif

}  // namespace

// q, k, v, dO, lse, D (f32 (B, nh, Sq)), q_start, kv_len (int32), dq (f32,
// q's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_dq_bf16)(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dq, int B,
                                    int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd<Bf16Route, bf16, false>(q, k, v, dout, lse, delta, q_start, kv_len, dq,
                                            nullptr, B, Sq, Tk, nh, nkv, hd, causal, scale,
                                            stream);
}

// ... dk, dv (f32, k's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_dkv_bf16)(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* q_start, const void* kv_len, void* dk, void* dv,
                                     int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                     float scale, void* stream) {
#ifdef QT_FLASH_WIDE
  if (bad_bwd_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto, auto P) {
    return launch_dkv_ws<decltype(P)::value>(q, k, v, dout, lse, delta, q_start, kv_len, dk, dv,
                                             B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
  });
#else
  return launch_bwd<Bf16Route, bf16, true>(q, k, v, dout, lse, delta, q_start, kv_len, dk, dv,
                                           B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
#endif
}

// The launch of this route's kernel for a report (flash_bwd.cuh's design)
extern "C" int QT_FLASH_ENTRY(qt_flash_bwd_design)(int dkv, int hd, int B, int Sq, int Tk, int nh, int nkv,
                                   int* out) {
  return design<Bf16Route>(dkv != 0, hd, B, Sq, Tk, nh, nkv, out);
}
