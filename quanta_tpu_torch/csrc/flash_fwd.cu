// Causal GQA flash-attention forward for Hopper (sm_90a), bf16 or f32.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/attention.py:_forward_impl
// (_flash_kernel). For query row i of batch row b (absolute position
// q_start[b] + i) and query head h, over the keys of KV head h / rep:
//
//   s_j = (q_i . k_j) * scale,  live iff j < kv_len[b] and (not causal or
//                                         j <= q_start[b] + i)
//   out_i = sum_j softmax(s)_j v_j,  lse_i = log sum_j exp(s_j)
//
// with the online softmax: per tile of 64 keys, m' = max(m, max_j s_j),
// alpha = exp(m - m'), p_j = exp(s_j - m'), l = l * alpha + sum_j p_j (one
// rounded multiply, then one rounded add, as the TPU kernel's order),
// o = o * alpha + T(p) @ v (p rounded to the operand type T before the
// product, as the TPU kernel rounds `p.astype(v.dtype)`; the row sum adds
// the f32 p). A row with no live key has l == 0: it writes zeros and lse
// 1e30, so the backward's exp(s - lse) is exactly 0 there. Tiles past the
// causal horizon of the block's last row, or past kv_len, are never loaded,
// and only the tiles that straddle a mask (the diagonal, the ragged end of
// kv_len) are masked.
//
// What bounds it on the H100: at TinyLlama's s1024 b2 training shape the
// causal forward does 4 * B * nh * (S(S+1)/2) * hd = 8.6 GFLOP a layer
// against 8 MB of q, k, v and out: ~8.7 us at 989 TFLOP/s, so the tensor
// cores; beside them the exponentials (one per live score, on the SFU at a
// sixteenth of the FMA rate) and the staging of K/V tiles from L2.
//
// bf16, the route every timed path takes (the pieces are sm90.cuh's, as the
// backward's dQ kernel): a block of FWD_WG consumer warpgroups owns FWD_WG
// consecutive 64-row query tiles of one (batch row, query head); the
// warpgroups share one cp.async ring of FWD_STAGES (K, V) tiles, so a staged
// tile feeds 64 * FWD_WG query rows. Per tile each warpgroup computes
// S = Q K^T by wgmma from shared memory (Q resident, both K-major), masks
// and runs the softmax update on the accumulator registers (a row's 64
// scores sit on the 4 lanes of a quad: row max and sum by two shuffles;
// the max is taken on the raw scores, and each exp(s - m') is one FFMA and
// one SFU ex2, 2^((s - m') * scale * log2 e): the approximate ex2.approx.ftz,
// so p may differ from exp(s - m') in its last bits; against the plain
// version lse stays within 1e-6 and the output within 1 bf16 ulp at
// chip_smoke.py's shapes), rounds p to bf16 into the
// register A operand (pack_a) and adds P V by wgmma, V
// read MN-major under a second descriptor. S (32 f32 a thread) and O (HD/2)
// stay in registers for the whole key loop: no tile round-trips through
// shared memory. Blocks are ordered so the rep query heads of a KV head run
// side by side (K and V come from L2) and the query tiles with the most key
// tiles start first. A warpgroup whose rows end before a staged tile's
// first key skips that tile's products.
//
// Tried on the H100 (each variant a build with FWD_WG and FWD_STAGES
// edited, timed by kernel_sweep.py; PERF.md), us at TinyLlama s1024 /
// Llama-2-7B's shape: one warpgroup a block
// 56.1 / 53.1 (2 stages), 58.1 / 52.1 (3); two 50.2 / 48.3 (2), 50.5 / 48.4
// (3). The scores max on raw values with one FFMA + ex2.approx a score, in
// place of a scaled copy and the accurate exp2f, took it from 75.1 to
// 48.5 us.
//
// f32 (the cached-prefill f32 case; no timed path takes it): the design of
// the first port, CUDA-core FMAs (WarpAcc<float> of flash_common.cuh), one
// block of 4 warps per (batch row, query head, 64 query rows), each warp
// owning 16 rows, K and V staged per tile, the output accumulator in shared
// memory.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

// ----------------------------------------------------- f32: CUDA-core FMAs

template <int HD>
struct FwdSmem {
  static constexpr int LD = HD + kPad<float>;  // Q, K, V tiles
  static constexpr int S_LD = kAccLd(TILE);    // scores
  static constexpr int P_LD = TILE + kPad<float>;
  static constexpr int O_LD = kAccLd(HD);      // output accumulator
  static constexpr size_t bytes = (3 * TILE * LD + TILE * S_LD + TILE * O_LD + TILE * P_LD) * 4;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ q_start,
              const int* __restrict__ kv_len, float* __restrict__ out, float* __restrict__ lse,
              int Sq, int Tk, int nh, int nkv, int causal, float scale) {
  using SM = FwdSmem<HD>;
  constexpr int LD = SM::LD, S_LD = SM::S_LD, P_LD = SM::P_LD, O_LD = SM::O_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * LD;
  float* Os = Ss + TILE * S_LD;
  float* Ps = Os + TILE * O_LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = live_kv_end(qs, q0, Sq, kvl, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;

  const float* qb = q + ((int64_t)b * Sq * nh + h) * HD;
  const float* kb = k + ((int64_t)b * Tk * nkv + g) * HD;
  const float* vb = v + ((int64_t)b * Tk * nkv + g) * HD;
  load_tile<float, HD>(Qs, qb, (int64_t)nh * HD, q0, Sq);
  for (int idx = tid; idx < TILE * HD; idx += THREADS) Os[(idx / HD) * O_LD + idx % HD] = 0.0f;

  // lanes 2r and 2r+1 own row r of this warp's 16; each takes the columns
  // of its parity, and both hold the row's running max m and sum l
  const int wr = lane >> 1, par = lane & 1;
  const int row = warp * WROWS + wr;
  const int qpos = qs + q0 + row;
  const float* Qw = Qs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * S_LD;
  float* Ow = Os + warp * WROWS * O_LD;
  float* Pw = Ps + warp * WROWS * P_LD;
  float m = -INFINITY, l = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // the last tile's K/V reads are done; Q and O are staged
    load_tile<float, HD>(Ks, kb, (int64_t)nkv * HD, k0, Tk);
    load_tile<float, HD>(Vs, vb, (int64_t)nkv * HD, k0, Tk);
    __syncthreads();

    WarpAcc<float, TILE> s;
    s.zero();
    s.template mma<RowMajor, ColMajor, HD>(Qw, LD, Ks, LD);  // Q K^T: K rows are K^T's columns
    s.store(Sw, S_LD);
    __syncwarp();

    float sv[TILE / 2];
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < TILE / 2; ++c) {
      const int col = 2 * c + par;
      sv[c] = live_pair(k0 + col, qpos, kvl, causal) ? Sw[wr * S_LD + col] * scale : -INFINITY;
      mt = fmaxf(mt, sv[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    // no live key yet (m_new == -inf): nothing accumulated, nothing to scale
    const float alpha = m_new == -INFINITY ? 1.0f : expf(m - m_new);
    float ls = 0.0f;
#pragma unroll
    for (int c = 0; c < TILE / 2; ++c) {
      const float p = sv[c] == -INFINITY ? 0.0f : expf(sv[c] - m_new);
      Pw[wr * P_LD + 2 * c + par] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = __fadd_rn(__fmul_rn(l, alpha), ls);  // the TPU kernel's order, not an FMA
    m = m_new;
#pragma unroll 4
    for (int c = 0; c < HD / 2; ++c) Ow[wr * O_LD + 2 * c + par] *= alpha;
    __syncwarp();

    WarpAcc<float, HD> o;
    o.load(Ow, O_LD);
    o.template mma<RowMajor, RowMajor, TILE>(Pw, P_LD, Vs, LD);
    o.store(Ow, O_LD);
    __syncwarp();
  }
  __syncthreads();  // O's zero fill, when no tile ran

  if (q0 + row < Sq) {
    float* orow = out + (((int64_t)b * Sq + q0 + row) * nh + h) * HD;
#pragma unroll 4
    for (int c = 0; c < HD / 2; ++c) {
      const int col = 2 * c + par;
      orow[col] = l > 0.0f ? Ow[wr * O_LD + col] / l : 0.0f;
    }
    if (lse != nullptr && par == 0)
      lse[((int64_t)b * nh + h) * Sq + q0 + row] = l > 0.0f ? m + logf(l) : kDeadLse;
  }
}

// ------------------------------------------------------- bf16: Hopper

using bf16 = __nv_bfloat16;
constexpr int FWD_WG = 2;      // consumer warpgroups a block, 64 query rows each
constexpr int FWD_STAGES = 2;  // the cp.async ring of (K, V) tiles
constexpr int FWD_THREADS = 128 * FWD_WG;
constexpr int FWD_ROWS = TILE * FWD_WG;  // query rows a block

template <int HD> struct FwdSmem90 {  // FWD_WG Q tiles, then FWD_STAGES x (K, V)
  static constexpr size_t bytes = (FWD_WG + 2 * FWD_STAGES) * Tile<HD>::BYTES + 1024;
};

dim3 fwd_grid(int B, int Sq, int nh) { return dim3(nh, B, (Sq + FWD_ROWS - 1) / FWD_ROWS); }

template <int HD>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ q_start, const int* __restrict__ kv_len,
               bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Tk, int nh, int nkv,
               int causal, float scale) {
  using TL = Tile<HD>;
  extern __shared__ unsigned char smem[];
  const uint32_t Qs = aligned_base(smem);
  auto Ks = [&](int st) { return Qs + (FWD_WG + 2 * st) * TL::BYTES; };
  auto Vs = [&](int st) { return Qs + (FWD_WG + 1 + 2 * st) * TL::BYTES; };

  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_ROWS;  // the longest rows first
  const int qw = q0 + wg * TILE;                           // this warpgroup's first row
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  // the block loads the key tiles up to the horizon of its last row; a
  // warpgroup adds those up to its own (none when its rows are past Sq)
  const int kv_end = causal ? min(kvl, qs + min(q0 + FWD_ROWS, Sq)) : kvl;
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;
  const int kv_end_w = qw < Sq ? live_kv_end(qs, qw, Sq, kvl, causal) : 0;
  const int n_tiles_w = kv_end_w > 0 ? (kv_end_w + TILE - 1) / TILE : 0;

  const bf16* kb = k + ((int64_t)b * Tk * nkv + g) * HD;
  const bf16* vb = v + ((int64_t)b * Tk * nkv + g) * HD;
  const int64_t kv_stride = (int64_t)nkv * HD;
  const uint32_t Qw = Qs + wg * TL::BYTES;
  TL::load_part(Qw, q + ((int64_t)b * Sq * nh + h) * HD, (int64_t)nh * HD, qw, Sq, wtid, 128);
#pragma unroll
  for (int st = 0; st < FWD_STAGES - 1; ++st) {
    if (st < n_tiles) {
      TL::load_part(Ks(st), kb, kv_stride, st * TILE, Tk, threadIdx.x, FWD_THREADS);
      TL::load_part(Vs(st), vb, kv_stride, st * TILE, Tk, threadIdx.x, FWD_THREADS);
    }
    cp_async_commit();
  }

  // this thread's rows r_lo and r_lo + 8 of the warpgroup's tile, columns
  // 8j + c_lo + c: running max (of the raw scores) and sum per row, in
  // registers
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<FWD_STAGES - 2>();  // tile t (and Q) has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; and the ring slot of t - 1 is free
    if (t + FWD_STAGES - 1 < n_tiles) {
      const int tn = t + FWD_STAGES - 1;
      TL::load_part(Ks(tn % FWD_STAGES), kb, kv_stride, tn * TILE, Tk, threadIdx.x, FWD_THREADS);
      TL::load_part(Vs(tn % FWD_STAGES), vb, kv_stride, tn * TILE, Tk, threadIdx.x, FWD_THREADS);
    }
    cp_async_commit();
    if (t >= n_tiles_w) continue;  // past this warpgroup's horizon
    const uint32_t Kt = Ks(t % FWD_STAGES), Vt = Vs(t % FWD_STAGES);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64>(s, TL::k_major(Qw, kk), TL::k_major(Kt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // -inf where masked, only on the tiles that straddle the causal
    // diagonal or kv_len; then the row max m' of the raw scores (scale > 0)
    const int k0 = t * TILE;
    if (k0 + TILE > kvl || (causal && k0 + TILE - 1 > qs + qw)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (!live_pair(k0 + 8 * j + c_lo + c, qs + qw + r_lo + 8 * i, kvl, causal))
              s[4 * j + 2 * i + c] = -INFINITY;
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mt[i] = fmaxf(mt[i], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    // alpha = exp(m - m'), p = exp(s - m') as 2^((s - m') scale log2 e):
    // one FFMA and one SFU op a score; a row with no live key yet (m' ==
    // -inf) takes offset 0, so its -inf scores give p = 0 and not NaN
    float alpha[2], mb[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      mt[i] = fmaxf(m[i], mt[i]);  // m'
      alpha[i] = mt[i] == -INFINITY ? 1.0f : fast_exp2((m[i] - mt[i]) * scale2);
      mb[i] = mt[i] == -INFINITY ? 0.0f : mt[i] * scale2;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          s[e] = fast_exp2(fmaf(s[e], scale2, -mb[i]));
          ls[i] += s[e];
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
      ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), ls[i]);  // the TPU kernel's order, not an FMA
      m[i] = mt[i];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, pa[kk]);

    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<HD>(o, pa[kk], TL::mn_major(Vt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r_lo + 8 * i;
    if (row >= Sq) continue;
    bf16* orow = out + (((int64_t)b * Sq + row) * nh + h) * HD + c_lo;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x0 = l[i] > 0.0f ? o[4 * j + 2 * i] / l[i] : 0.0f;
      const float x1 = l[i] > 0.0f ? o[4 * j + 2 * i + 1] / l[i] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * nh + h) * Sq + row] = l[i] > 0.0f ? m[i] * scale + logf(l[i]) : kDeadLse;
  }
}

bool bad_sizes(int B, int Sq, int Tk, int nh, int nkv) {
  return B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0;
}

template <int HD>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const void* q_start,
                    const void* kv_len, void* out, void* lse, int B, int Sq, int Tk, int nh,
                    int nkv, int causal, float scale, void* stream) {
  return launch_n(flash_fwd_sm90<HD>, fwd_grid(B, Sq, nh), FWD_THREADS, FwdSmem90<HD>::bytes,
                  stream, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const int*>(q_start),
                  static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                  static_cast<float*>(lse), Sq, Tk, nh, nkv, causal, scale);
}

template <int HD>
int launch_fwd_f32(const void* q, const void* k, const void* v, const void* q_start,
                   const void* kv_len, void* out, void* lse, int B, int Sq, int Tk, int nh,
                   int nkv, int causal, float scale, void* stream) {
  return launch(flash_fwd_f32<HD>, dim3((Sq + TILE - 1) / TILE, nh, B), FwdSmem<HD>::bytes,
                stream, static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const int*>(q_start),
                static_cast<const int*>(kv_len), static_cast<float*>(out),
                static_cast<float*>(lse), Sq, Tk, nh, nkv, causal, scale);
}

template <int HD> int fwd_design(int B, int Sq, int nh, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, flash_fwd_sm90<HD>);
  const size_t smem = FwdSmem90<HD>::bytes;
  const dim3 grid = fwd_grid(B, Sq, nh);
  const int vals[10] = {(int)grid.x, (int)grid.y, (int)grid.z, FWD_WG,
                        blocks_per_sm(flash_fwd_sm90<HD>, smem, FWD_THREADS), attr.numRegs,
                        (int)smem, (int)attr.localSizeBytes, sm_count(), FWD_STAGES};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return (int)rc;
}

}  // namespace

// q, k, v, q_start, kv_len (int32), out, lse (f32 (B, nh, Sq), or null),
// B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int qt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 const void* q_start, const void* kv_len, void* out, void* lse,
                                 int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                 float scale, void* stream) {
  if (bad_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_fwd_bf16<32>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, causal, scale, stream);
    case 64: return launch_fwd_bf16<64>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, causal, scale, stream);
    case 128: return launch_fwd_bf16<128>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int qt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                const void* q_start, const void* kv_len, void* out, void* lse,
                                int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                float scale, void* stream) {
  if (bad_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_fwd_f32<32>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, causal, scale, stream);
    case 64: return launch_fwd_f32<64>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, causal, scale, stream);
    case 128: return launch_fwd_f32<128>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 route's launch, for a report: out[10] = grid x, y, z, consumer
// warpgroups a block, blocks resident per SM, registers a thread, dynamic
// shared bytes, local (spill) bytes a thread, SMs, cp.async stages
extern "C" int qt_flash_fwd_design(int hd, int B, int Sq, int nh, int* out) {
  if (B <= 0 || Sq <= 0 || nh <= 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return fwd_design<32>(B, Sq, nh, out);
    case 64: return fwd_design<64>(B, Sq, nh, out);
    case 128: return fwd_design<128>(B, Sq, nh, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
