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
// alpha = exp(m - m'), p_j = exp(s_j - m'), l = l * alpha + sum_j p_j,
// o = o * alpha + bf16(p) @ v (p rounded to the operand type before the
// product, as the TPU kernel rounds `p.astype(v.dtype)`). A row with no
// live key has l == 0: it writes zeros and lse 1e30, so the backward's
// exp(s - lse) is exactly 0 there. Tiles past the causal horizon of the
// block's last row, or past kv_len, are never loaded.
//
// Design: one block of 4 warps per (batch row, query head, 64 query rows);
// each warp owns 16 rows. Per key tile the block stages K and V in shared
// memory; each warp computes its 16 x 64 scores (wmma bf16 16x16x16, f32
// sums; f32 inputs: FMAs, no TF32, as JAX's Precision.HIGHEST), masks them
// and runs the softmax update with lanes 2r and 2r+1 on row r (running max
// and sum in registers), writes p, rescales its rows of the f32 output
// accumulator in shared memory and adds p @ v. GQA reuse of a KV tile by
// the rep query heads comes from L2 (each head's block reads it).
//
// What bounds it on the H100: at TinyLlama's s1024 b2 training shape the
// causal forward does 4 * B * nh * (S(S+1)/2) * hd = 8.6 GFLOP a layer
// against 8 MB of q, k, v and out: ~8.7 us at 989 TFLOP/s, so bound by
// compute. What this simple design leaves on the table: no cp.async/TMA
// pipeline (each tile's loads wait before its math), no wgmma (wmma's
// mma.sync runs well below Hopper's peak), the output accumulator round
// trips through shared memory every tile, and the rep heads of a group do
// not share one staged KV tile.

#include "flash_common.cuh"

namespace {

template <typename T, int HD>
struct FwdSmem {
  static constexpr int LD = HD + kPad<T>;   // Q, K, V tiles
  static constexpr int S_LD = kAccLd(TILE);  // f32 scores
  static constexpr int P_LD = TILE + kPad<T>;
  static constexpr int O_LD = kAccLd(HD);    // f32 output accumulator
  static constexpr size_t bytes =
      3 * TILE * LD * sizeof(T) + TILE * S_LD * 4 + TILE * O_LD * 4 + TILE * P_LD * sizeof(T);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_start, const int* __restrict__ kv_len,
                 T* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Tk, int nh, int nkv, int causal, float scale) {
  using SM = FwdSmem<T, HD>;
  constexpr int LD = SM::LD, S_LD = SM::S_LD, P_LD = SM::P_LD, O_LD = SM::O_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  float* Ss = reinterpret_cast<float*>(Vs + TILE * LD);
  float* Os = Ss + TILE * S_LD;
  T* Ps = reinterpret_cast<T*>(Os + TILE * O_LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = live_kv_end(qs, q0, Sq, kvl, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;

  const T* qb = q + ((int64_t)b * Sq * nh + h) * HD;
  const T* kb = k + ((int64_t)b * Tk * nkv + g) * HD;
  const T* vb = v + ((int64_t)b * Tk * nkv + g) * HD;
  load_tile<T, HD>(Qs, qb, (int64_t)nh * HD, q0, Sq);
  for (int idx = tid; idx < TILE * HD; idx += THREADS) Os[(idx / HD) * O_LD + idx % HD] = 0.0f;

  // lanes 2r and 2r+1 own row r of this warp's 16; each takes the columns
  // of its parity, and both hold the row's running max m and sum l
  const int wr = lane >> 1, par = lane & 1;
  const int row = warp * WROWS + wr;
  const int qpos = qs + q0 + row;
  const T* Qw = Qs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * S_LD;
  float* Ow = Os + warp * WROWS * O_LD;
  T* Pw = Ps + warp * WROWS * P_LD;
  float m = -INFINITY, l = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // the last tile's K/V reads are done; Q and O are staged
    load_tile<T, HD>(Ks, kb, (int64_t)nkv * HD, k0, Tk);
    load_tile<T, HD>(Vs, vb, (int64_t)nkv * HD, k0, Tk);
    __syncthreads();

    WarpAcc<T, TILE> s;
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
      Pw[wr * P_LD + 2 * c + par] = from_f32<T>(p);
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = __fadd_rn(__fmul_rn(l, alpha), ls);  // the TPU kernel's order, not an FMA
    m = m_new;
#pragma unroll 4
    for (int c = 0; c < HD / 2; ++c) Ow[wr * O_LD + 2 * c + par] *= alpha;
    __syncwarp();

    WarpAcc<T, HD> o;
    o.load(Ow, O_LD);
    o.template mma<RowMajor, RowMajor, TILE>(Pw, P_LD, Vs, LD);
    o.store(Ow, O_LD);
    __syncwarp();
  }
  __syncthreads();  // O's zero fill, when no tile ran

  if (q0 + row < Sq) {
    T* orow = out + (((int64_t)b * Sq + q0 + row) * nh + h) * HD;
#pragma unroll 4
    for (int c = 0; c < HD / 2; ++c) {
      const int col = 2 * c + par;
      orow[col] = from_f32<T>(l > 0.0f ? Ow[wr * O_LD + col] / l : 0.0f);
    }
    if (lse != nullptr && par == 0)
      lse[((int64_t)b * nh + h) * Sq + q0 + row] = l > 0.0f ? m + logf(l) : kDeadLse;
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* q_start,
               const void* kv_len, void* out, void* lse, int B, int Sq, int Tk, int nh, int nkv,
               int hd, int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + TILE - 1) / TILE, nh, B);
  auto args = [&](auto kernel, size_t smem) {
    return launch(kernel, grid, smem, stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
                  static_cast<T*>(out), static_cast<float*>(lse), Sq, Tk, nh, nkv, causal, scale);
  };
  switch (hd) {
    case 32: return args(flash_fwd_kernel<T, 32>, FwdSmem<T, 32>::bytes);
    case 64: return args(flash_fwd_kernel<T, 64>, FwdSmem<T, 64>::bytes);
    case 128: return args(flash_fwd_kernel<T, 128>, FwdSmem<T, 128>::bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, q_start, kv_len (int32), out, lse (f32 (B, nh, Sq), or null),
// B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int qt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 const void* q_start, const void* kv_len, void* out, void* lse,
                                 int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                 float scale, void* stream) {
  return launch_fwd<__nv_bfloat16>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, hd,
                                   causal, scale, stream);
}

extern "C" int qt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                const void* q_start, const void* kv_len, void* out, void* lse,
                                int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                float scale, void* stream) {
  return launch_fwd<float>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, hd, causal,
                           scale, stream);
}
