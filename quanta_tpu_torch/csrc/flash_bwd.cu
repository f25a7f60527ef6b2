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
// cores (~30 us together at 989 TFLOP/s).
//
// bf16, the route every timed path takes (sm90.cuh has the pieces). One
// warpgroup (128 threads) owns a 64-row tile, wgmma's M:
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
// f32 (a correctness route; no timed path takes it): the design of the
// first port, CUDA-core FMAs (WarpAcc<float> of flash_common.cuh). dQ: one
// block of 4 warps per (batch row, query head, 64 query rows), each warp
// owning 16 rows; it loops over the live key tiles, staging K and V,
// recomputes its scores and dO V^T, forms ds in shared memory and
// accumulates ds @ K. dK/dV: one block per (batch row, KV head, 64 keys),
// looping over the rep query heads and their live query tiles. Every block
// writes its own rows: no atomics.

#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

// ----------------------------------------------------- f32: CUDA-core FMAs

template <int HD>
struct BwdSmem {
  static constexpr int LD = HD + kPad<float>;  // Q, dO, K, V tiles
  static constexpr int S_LD = kAccLd(TILE);  // scores and dO V^T
  static constexpr int P_LD = TILE + kPad<float>;
  static constexpr int C_LD = kAccLd(HD);  // f32 epilogue, over two staged tiles
  static constexpr size_t tiles = 4 * TILE * LD * 4;
  static constexpr size_t bytes =
      tiles + 2 * TILE * S_LD * 4 + 2 * TILE * P_LD * 4 + 2 * TILE * 4;
  static_assert(TILE * C_LD * 4 <= 2 * TILE * LD * 4, "epilogue fits two tiles");
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ q_start,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    int Sq, int Tk, int nh, int nkv, int causal, float scale) {
  using SM = BwdSmem<HD>;
  constexpr int LD = SM::LD, S_LD = SM::S_LD, P_LD = SM::P_LD, C_LD = SM::C_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* dOs = Qs + TILE * LD;
  float* Ss = dOs + TILE * LD;
  float* dPs = Ss + TILE * S_LD;
  float* dSs = dPs + TILE * S_LD;
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue, over Ks and Vs

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = live_kv_end(qs, q0, Sq, kvl, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;

  const int64_t q_off = ((int64_t)b * Sq * nh + h) * HD;
  const float* kb = k + ((int64_t)b * Tk * nkv + g) * HD;
  const float* vb = v + ((int64_t)b * Tk * nkv + g) * HD;
  load_tile<float, HD>(Qs, q + q_off, (int64_t)nh * HD, q0, Sq);
  load_tile<float, HD>(dOs, dout + q_off, (int64_t)nh * HD, q0, Sq);

  const int wr = lane >> 1, par = lane & 1;
  const int row = warp * WROWS + wr;
  const int qpos = qs + q0 + row;
  const int64_t stat = ((int64_t)b * nh + h) * Sq + q0 + row;
  const float lse_r = q0 + row < Sq ? lse[stat] : kDeadLse;
  const float delta_r = q0 + row < Sq ? delta[stat] : 0.0f;
  const float* Qw = Qs + warp * WROWS * LD;
  const float* dOw = dOs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * S_LD;
  float* dPw = dPs + warp * WROWS * S_LD;
  float* dSw = dSs + warp * WROWS * P_LD;

  WarpAcc<float, HD> acc;
  acc.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();
    load_tile<float, HD>(Ks, kb, (int64_t)nkv * HD, k0, Tk);
    load_tile<float, HD>(Vs, vb, (int64_t)nkv * HD, k0, Tk);
    __syncthreads();

    WarpAcc<float, TILE> s;
    s.zero();
    s.template mma<RowMajor, ColMajor, HD>(Qw, LD, Ks, LD);
    s.store(Sw, S_LD);
    s.zero();
    s.template mma<RowMajor, ColMajor, HD>(dOw, LD, Vs, LD);
    s.store(dPw, S_LD);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < TILE / 2; ++c) {
      const int col = 2 * c + par;
      const float p = live_pair(k0 + col, qpos, kvl, causal)
                          ? expf(Sw[wr * S_LD + col] * scale - lse_r) : 0.0f;
      dSw[wr * P_LD + col] = p * (dPw[wr * S_LD + col] - delta_r) * scale;
    }
    __syncwarp();
    acc.template mma<RowMajor, RowMajor, TILE>(dSw, P_LD, Ks, LD);
  }
  __syncthreads();  // Cs overlays K and V

  float* Cw = Cs + warp * WROWS * C_LD;
  acc.store(Cw, C_LD);
  __syncwarp();
  if (q0 + row < Sq) {
    float* drow = dq + (((int64_t)b * Sq + q0 + row) * nh + h) * HD;
#pragma unroll 4
    for (int c = 0; c < HD / 2; ++c) drow[2 * c + par] = Cw[wr * C_LD + 2 * c + par];
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ q_start,
                     const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Tk, int nh, int nkv, int causal,
                     float scale) {
  using SM = BwdSmem<HD>;
  constexpr int LD = SM::LD, S_LD = SM::S_LD, P_LD = SM::P_LD, C_LD = SM::C_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + TILE * LD;
  float* Ks = dOs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * LD;
  float* dPs = Ss + TILE * S_LD;
  float* Ps = dPs + TILE * S_LD;
  float* dSs = Ps + TILE * P_LD;
  float* Ls = dSs + TILE * P_LD;
  float* Ds = Ls + TILE;
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue, over Qs and dOs

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * TILE, g = blockIdx.y, b = blockIdx.z;
  const int rep = nh / nkv;
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  // query tiles whose last row reaches key k0: from the one holding row k0 - q_start
  const int qt_begin = causal ? max(0, k0 - qs) / TILE : 0;
  const int qt_end = k0 < kvl ? (Sq + TILE - 1) / TILE : 0;

  load_tile<float, HD>(Ks, k + ((int64_t)b * Tk * nkv + g) * HD, (int64_t)nkv * HD, k0, Tk);
  load_tile<float, HD>(Vs, v + ((int64_t)b * Tk * nkv + g) * HD, (int64_t)nkv * HD, k0, Tk);

  // lanes 2r and 2r+1 own key row r of this warp's 16; columns are queries
  const int wr = lane >> 1, par = lane & 1;
  const int kpos = k0 + warp * WROWS + wr;
  const float* Kw = Ks + warp * WROWS * LD;
  const float* Vw = Vs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * S_LD;
  float* dPw = dPs + warp * WROWS * S_LD;
  float* Pw = Ps + warp * WROWS * P_LD;
  float* dSw = dSs + warp * WROWS * P_LD;

  WarpAcc<float, HD> acc_k, acc_v;
  acc_k.zero();
  acc_v.zero();
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t q_off = ((int64_t)b * Sq * nh + h) * HD;
    const float* lse_h = lse + ((int64_t)b * nh + h) * Sq;
    const float* delta_h = delta + ((int64_t)b * nh + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();
      load_tile<float, HD>(Qs, q + q_off, (int64_t)nh * HD, q0, Sq);
      load_tile<float, HD>(dOs, dout + q_off, (int64_t)nh * HD, q0, Sq);
      if (tid < TILE) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lse_h[q0 + tid] : kDeadLse;
        Ds[tid] = in ? delta_h[q0 + tid] : 0.0f;
      }
      __syncthreads();

      WarpAcc<float, TILE> s;
      s.zero();
      s.template mma<RowMajor, ColMajor, HD>(Kw, LD, Qs, LD);  // K Q^T
      s.store(Sw, S_LD);
      s.zero();
      s.template mma<RowMajor, ColMajor, HD>(Vw, LD, dOs, LD);  // V dO^T
      s.store(dPw, S_LD);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < TILE / 2; ++c) {
        const int col = 2 * c + par;
        const float p = live_pair(kpos, qs + q0 + col, kvl, causal)
                            ? expf(Sw[wr * S_LD + col] * scale - Ls[col]) : 0.0f;
        Pw[wr * P_LD + col] = p;
        dSw[wr * P_LD + col] = p * (dPw[wr * S_LD + col] - Ds[col]) * scale;
      }
      __syncwarp();
      acc_v.template mma<RowMajor, RowMajor, TILE>(Pw, P_LD, dOs, LD);  // p^T dO
      acc_k.template mma<RowMajor, RowMajor, TILE>(dSw, P_LD, Qs, LD);  // ds^T Q
    }
  }

  float* Cw = Cs + warp * WROWS * C_LD;
  const int64_t out_row = (((int64_t)b * Tk + kpos) * nkv + g) * HD;
  auto write = [&](const WarpAcc<float, HD>& acc, float* out) {
    __syncthreads();  // Cs overlays Q and dO; the last reads of them are done
    acc.store(Cw, C_LD);
    __syncwarp();
    if (kpos < Tk) {
#pragma unroll 4
      for (int c = 0; c < HD / 2; ++c) out[out_row + 2 * c + par] = Cw[wr * C_LD + 2 * c + par];
    }
  };
  write(acc_k, dk);
  write(acc_v, dv);
}

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

template <int HD>
__global__ void __launch_bounds__(128)
flash_bwd_dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ q_start, const int* __restrict__ kv_len,
                  float* __restrict__ dq, int Sq, int Tk, int nh, int nkv, int causal,
                  float scale) {
  using TL = Tile<HD>;
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

  const int64_t q_off = ((int64_t)b * Sq * nh + h) * HD;
  const bf16* kb = k + ((int64_t)b * Tk * nkv + g) * HD;
  const bf16* vb = v + ((int64_t)b * Tk * nkv + g) * HD;
  const int64_t kv_stride = (int64_t)nkv * HD;
  TL::load(Qs, q + q_off, (int64_t)nh * HD, q0, Sq);
  TL::load(dOs, dout + q_off, (int64_t)nh * HD, q0, Sq);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      TL::load(Ks(st), kb, kv_stride, st * TILE, Tk);
      TL::load(Vs(st), vb, kv_stride, st * TILE, Tk);
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
      TL::load(Ks(tn % STAGES), kb, kv_stride, tn * TILE, Tk);
      TL::load(Vs(tn % STAGES), vb, kv_stride, tn * TILE, Tk);
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
    float* out = dq + (((int64_t)b * Sq + row) * nh + h) * HD + c_lo;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(128, HD <= 64 ? 3 : 1)  // hd <= 64: 168 registers, 3 blocks an SM
flash_bwd_dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ q_start, const int* __restrict__ kv_len,
                   float* __restrict__ dk, float* __restrict__ dv, int Sq, int Tk, int nh,
                   int nkv, int causal, float scale) {
  using TL = Tile<HD>;
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
  const int g = blockIdx.y % nkv, b = blockIdx.y / nkv, k0 = blockIdx.z * TILE;
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

  const int64_t kv_off = ((int64_t)b * Tk * nkv + g) * HD;
  TL::load(Ks, k + kv_off, (int64_t)nkv * HD, k0, Tk);
  TL::load(Vs, v + kv_off, (int64_t)nkv * HD, k0, Tk);
  auto load_pair = [&](int p, int st) {
    const int h = g * rep + p / nq, q0 = (qt_begin + p % nq) * TILE;
    const int64_t q_off = ((int64_t)b * Sq * nh + h) * HD;
    TL::load(Qs(st), q + q_off, (int64_t)nh * HD, q0, Sq);
    TL::load(dOs(st), dout + q_off, (int64_t)nh * HD, q0, Sq);
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
    if (k0 + row < Tk)
      *reinterpret_cast<float4*>((which ? dv : dk) + (((int64_t)b * Tk + k0 + row) * nkv + g) * HD +
                                 col) = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The dK/dV launch: grid (C, nkv * B, key tiles), clusters of C blocks.
struct DkvGrid {
  dim3 grid;
  int cluster;
};
DkvGrid dkv_grid(int B, int Sq, int Tk, int nh, int nkv) {
  const int key_tiles = (Tk + TILE - 1) / TILE;
  const int base = key_tiles * nkv * B;
  const int max_pairs = (nh / nkv) * ((Sq + TILE - 1) / TILE);
  int c = 1;
  while (c < 8 && c < max_pairs && (int64_t)base * c < 2LL * sm_count()) c *= 2;
  return {dim3(c, nkv * B, key_tiles), c};
}

template <int HD>
int launch_bwd_sm90(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* q_start, const void* kv_len,
                    void* d0, void* d1, int B, int Sq, int Tk, int nh, int nkv, int causal,
                    float scale, void* stream) {
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* qsp = static_cast<const int*>(q_start);
  const auto* klp = static_cast<const int*>(kv_len);
  auto* o0 = static_cast<float*>(d0);
  if (dkv) {
    const DkvGrid lg = dkv_grid(B, Sq, Tk, nh, nkv);
    return launch_cluster(flash_bwd_dkv_sm90<HD>, lg.grid, lg.cluster, THREADS,
                          DkvSmem<HD>::bytes, stream, qp, kp, vp, dop, lp, dp, qsp, klp, o0,
                          static_cast<float*>(d1), Sq, Tk, nh, nkv, causal, scale);
  }
  return launch(flash_bwd_dq_sm90<HD>, dim3(nh, B, (Sq + TILE - 1) / TILE), DqSmem<HD>::bytes,
                stream, qp, kp, vp, dop, lp, dp, qsp, klp, o0, Sq, Tk, nh, nkv, causal, scale);
}

// bf16: the Hopper kernels
int launch_bwd_bf16(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* q_start, const void* kv_len,
                    void* d0, void* d1, int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch_bwd_sm90<32>(dkv, q, k, v, dout, lse, delta, q_start, kv_len, d0, d1, B, Sq,
                                 Tk, nh, nkv, causal, scale, stream);
    case 64:
      return launch_bwd_sm90<64>(dkv, q, k, v, dout, lse, delta, q_start, kv_len, d0, d1, B, Sq,
                                 Tk, nh, nkv, causal, scale, stream);
    case 128:
      return launch_bwd_sm90<128>(dkv, q, k, v, dout, lse, delta, q_start, kv_len, d0, d1, B, Sq,
                                  Tk, nh, nkv, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// f32: the CUDA-core kernels
int launch_bwd_f32(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* q_start, const void* kv_len,
                   void* d0, void* d1, int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dop = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* qsp = static_cast<const int*>(q_start);
  const auto* klp = static_cast<const int*>(kv_len);
  auto* o0 = static_cast<float*>(d0);
  auto* o1 = static_cast<float*>(d1);
  auto go = [&](auto dq_kernel, auto dkv_kernel, size_t smem) {
    if (dkv)
      return launch(dkv_kernel, dim3((Tk + TILE - 1) / TILE, nkv, B), smem, stream, qp, kp, vp, dop,
                    lp, dp, qsp, klp, o0, o1, Sq, Tk, nh, nkv, causal, scale);
    return launch(dq_kernel, dim3((Sq + TILE - 1) / TILE, nh, B), smem, stream, qp, kp, vp, dop, lp,
                  dp, qsp, klp, o0, Sq, Tk, nh, nkv, causal, scale);
  };
  switch (hd) {
    case 32: return go(flash_bwd_dq_kernel<32>, flash_bwd_dkv_kernel<32>, BwdSmem<32>::bytes);
    case 64: return go(flash_bwd_dq_kernel<64>, flash_bwd_dkv_kernel<64>, BwdSmem<64>::bytes);
    case 128: return go(flash_bwd_dq_kernel<128>, flash_bwd_dkv_kernel<128>, BwdSmem<128>::bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int HD> int design(bool dkv, int B, int Sq, int Tk, int nh, int nkv, int* out) {
  cudaFuncAttributes attr;
  size_t smem;
  dim3 grid;
  int cluster = 1, resident;
  cudaError_t rc;
  if (dkv) {
    const DkvGrid lg = dkv_grid(B, Sq, Tk, nh, nkv);
    grid = lg.grid;
    cluster = lg.cluster;
    smem = DkvSmem<HD>::bytes;
    resident = blocks_per_sm(flash_bwd_dkv_sm90<HD>, smem, THREADS);
    rc = cudaFuncGetAttributes(&attr, flash_bwd_dkv_sm90<HD>);
  } else {
    grid = dim3(nh, B, (Sq + TILE - 1) / TILE);
    smem = DqSmem<HD>::bytes;
    resident = blocks_per_sm(flash_bwd_dq_sm90<HD>, smem, THREADS);
    rc = cudaFuncGetAttributes(&attr, flash_bwd_dq_sm90<HD>);
  }
  const int vals[10] = {(int)grid.x, (int)grid.y, (int)grid.z, cluster, resident,
                        attr.numRegs, (int)smem, (int)attr.localSizeBytes, sm_count(), STAGES};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return (int)rc;
}

}  // namespace

// q, k, v, dO, lse, D (f32 (B, nh, Sq)), q_start, kv_len (int32), dq (f32,
// q's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int qt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dq, int B,
                                    int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd_bf16(false, q, k, v, dout, lse, delta, q_start, kv_len, dq, nullptr, B, Sq,
                         Tk, nh, nkv, hd, causal, scale, stream);
}

extern "C" int qt_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* q_start, const void* kv_len, void* dq, int B,
                                   int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                   float scale, void* stream) {
  return launch_bwd_f32(false, q, k, v, dout, lse, delta, q_start, kv_len, dq, nullptr, B, Sq,
                        Tk, nh, nkv, hd, causal, scale, stream);
}

// ... dk, dv (f32, k's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int qt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* q_start, const void* kv_len, void* dk, void* dv,
                                     int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                     float scale, void* stream) {
  return launch_bwd_bf16(true, q, k, v, dout, lse, delta, q_start, kv_len, dk, dv, B, Sq, Tk,
                         nh, nkv, hd, causal, scale, stream);
}

extern "C" int qt_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dk, void* dv,
                                    int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd_f32(true, q, k, v, dout, lse, delta, q_start, kv_len, dk, dv, B, Sq, Tk,
                        nh, nkv, hd, causal, scale, stream);
}

// The bf16 route's launch, for a report: out[10] = grid x, y, z, cluster
// size, blocks resident per SM, registers a thread, dynamic shared bytes,
// local (spill) bytes a thread, SMs, cp.async stages; dkv 0 (dQ) or 1
extern "C" int qt_flash_bwd_design(int dkv, int hd, int B, int Sq, int Tk, int nh, int nkv,
                                   int* out) {
  if (B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return design<32>(dkv != 0, B, Sq, Tk, nh, nkv, out);
    case 64: return design<64>(dkv != 0, B, Sq, Tk, nh, nkv, out);
    case 128: return design<128>(dkv != 0, B, Sq, Tk, nh, nkv, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
