// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel, bf16 or f32.
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
// outputs are f32 (the wrapper casts them). Masks and dead tiles follow the
// forward: a (query tile, key tile) pair is skipped when no pair in it is
// live.
//
// Design. dQ: one block of 4 warps per (batch row, query head, 64 query
// rows), each warp owning 16 rows; it loops over the live key tiles,
// staging K and V, recomputes its 16 x 64 scores and dO V^T (wmma bf16, or
// FMAs for f32 inputs), forms ds in shared memory and accumulates ds @ K in
// registers. dK/dV: one block per (batch row, KV head, 64 keys), each warp
// owning 16 keys; it loops over the rep query heads of the group and their
// live query tiles, staging Q and dO, computes the transposed tiles K Q^T
// and V dO^T, forms p^T and ds^T and accumulates p^T @ dO and ds^T @ Q in
// registers. Every block writes its own rows, so neither kernel needs
// atomics: both are deterministic.
//
// What bounds them on the H100: at TinyLlama's s1024 b2 training shape the
// dQ kernel does 3 and the dK/dV kernel 4 products of 2 * B * nh *
// (S(S+1)/2) * hd flops (~13 and ~17 GFLOP a layer): bound by compute
// (~30 us together at 989 TFLOP/s). What this simple design leaves on the
// table: no cp.async/TMA pipeline, no wgmma, and the dK/dV grid has only
// B * nkv * T/64 blocks (128 at that shape, under one wave of the 132
// SMs), each walking rep * Sq/64 query tiles.

#include "flash_common.cuh"

namespace {

template <typename T, int HD>
struct BwdSmem {
  static constexpr int LD = HD + kPad<T>;   // Q, dO, K, V tiles
  static constexpr int S_LD = kAccLd(TILE);  // f32 scores and dO V^T
  static constexpr int P_LD = TILE + kPad<T>;
  static constexpr int C_LD = kAccLd(HD);    // f32 epilogue, over two staged tiles
  static constexpr size_t tiles = 4 * TILE * LD * sizeof(T);
  static constexpr size_t bytes =
      tiles + 2 * TILE * S_LD * 4 + 2 * TILE * P_LD * sizeof(T) + 2 * TILE * 4;
  static_assert(TILE * C_LD * 4 <= 2 * TILE * LD * sizeof(T), "epilogue fits two tiles");
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ q_start,
                    const int* __restrict__ kv_len, float* __restrict__ dq,
                    int Sq, int Tk, int nh, int nkv, int causal, float scale) {
  using SM = BwdSmem<T, HD>;
  constexpr int LD = SM::LD, S_LD = SM::S_LD, P_LD = SM::P_LD, C_LD = SM::C_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + TILE * LD;
  T* Qs = Vs + TILE * LD;
  T* dOs = Qs + TILE * LD;
  float* Ss = reinterpret_cast<float*>(dOs + TILE * LD);
  float* dPs = Ss + TILE * S_LD;
  T* dSs = reinterpret_cast<T*>(dPs + TILE * S_LD);
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue, over Ks and Vs

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = live_kv_end(qs, q0, Sq, kvl, causal);
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;

  const int64_t q_off = ((int64_t)b * Sq * nh + h) * HD;
  const T* kb = k + ((int64_t)b * Tk * nkv + g) * HD;
  const T* vb = v + ((int64_t)b * Tk * nkv + g) * HD;
  load_tile<T, HD>(Qs, q + q_off, (int64_t)nh * HD, q0, Sq);
  load_tile<T, HD>(dOs, dout + q_off, (int64_t)nh * HD, q0, Sq);

  const int wr = lane >> 1, par = lane & 1;
  const int row = warp * WROWS + wr;
  const int qpos = qs + q0 + row;
  const int64_t stat = ((int64_t)b * nh + h) * Sq + q0 + row;
  const float lse_r = q0 + row < Sq ? lse[stat] : kDeadLse;
  const float delta_r = q0 + row < Sq ? delta[stat] : 0.0f;
  const T* Qw = Qs + warp * WROWS * LD;
  const T* dOw = dOs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * S_LD;
  float* dPw = dPs + warp * WROWS * S_LD;
  T* dSw = dSs + warp * WROWS * P_LD;

  WarpAcc<T, HD> acc;
  acc.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();
    load_tile<T, HD>(Ks, kb, (int64_t)nkv * HD, k0, Tk);
    load_tile<T, HD>(Vs, vb, (int64_t)nkv * HD, k0, Tk);
    __syncthreads();

    WarpAcc<T, TILE> s;
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
      dSw[wr * P_LD + col] = from_f32<T>(p * (dPw[wr * S_LD + col] - delta_r) * scale);
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ q_start,
                     const int* __restrict__ kv_len, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Tk, int nh, int nkv, int causal,
                     float scale) {
  using SM = BwdSmem<T, HD>;
  constexpr int LD = SM::LD, S_LD = SM::S_LD, P_LD = SM::P_LD, C_LD = SM::C_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TILE * LD;
  T* Ks = dOs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  float* Ss = reinterpret_cast<float*>(Vs + TILE * LD);
  float* dPs = Ss + TILE * S_LD;
  T* Ps = reinterpret_cast<T*>(dPs + TILE * S_LD);
  T* dSs = Ps + TILE * P_LD;
  float* Ls = reinterpret_cast<float*>(dSs + TILE * P_LD);
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

  load_tile<T, HD>(Ks, k + ((int64_t)b * Tk * nkv + g) * HD, (int64_t)nkv * HD, k0, Tk);
  load_tile<T, HD>(Vs, v + ((int64_t)b * Tk * nkv + g) * HD, (int64_t)nkv * HD, k0, Tk);

  // lanes 2r and 2r+1 own key row r of this warp's 16; columns are queries
  const int wr = lane >> 1, par = lane & 1;
  const int kpos = k0 + warp * WROWS + wr;
  const T* Kw = Ks + warp * WROWS * LD;
  const T* Vw = Vs + warp * WROWS * LD;
  float* Sw = Ss + warp * WROWS * S_LD;
  float* dPw = dPs + warp * WROWS * S_LD;
  T* Pw = Ps + warp * WROWS * P_LD;
  T* dSw = dSs + warp * WROWS * P_LD;

  WarpAcc<T, HD> acc_k, acc_v;
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
      load_tile<T, HD>(Qs, q + q_off, (int64_t)nh * HD, q0, Sq);
      load_tile<T, HD>(dOs, dout + q_off, (int64_t)nh * HD, q0, Sq);
      if (tid < TILE) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lse_h[q0 + tid] : kDeadLse;
        Ds[tid] = in ? delta_h[q0 + tid] : 0.0f;
      }
      __syncthreads();

      WarpAcc<T, TILE> s;
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
        Pw[wr * P_LD + col] = from_f32<T>(p);
        dSw[wr * P_LD + col] = from_f32<T>(p * (dPw[wr * S_LD + col] - Ds[col]) * scale);
      }
      __syncwarp();
      acc_v.template mma<RowMajor, RowMajor, TILE>(Pw, P_LD, dOs, LD);  // p^T dO
      acc_k.template mma<RowMajor, RowMajor, TILE>(dSw, P_LD, Qs, LD);  // ds^T Q
    }
  }

  float* Cw = Cs + warp * WROWS * C_LD;
  const int64_t out_row = (((int64_t)b * Tk + kpos) * nkv + g) * HD;
  auto write = [&](const WarpAcc<T, HD>& acc, float* out) {
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

template <typename T>
int launch_bwd(bool dkv, const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* q_start, const void* kv_len,
               void* d0, void* d1, int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
               float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* dop = static_cast<const T*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* qsp = static_cast<const int*>(q_start);
  const auto* klp = static_cast<const int*>(kv_len);
  auto* o0 = static_cast<float*>(d0);
  auto* o1 = static_cast<float*>(d1);
  auto go = [&](auto dq_kernel, auto dkv_kernel, size_t smem) {
    if (dkv)
      return launch(dkv_kernel, dim3((Tk + TILE - 1) / TILE, nkv, B), smem, stream, qp, kp, vp,
                    dop, lp, dp, qsp, klp, o0, o1, Sq, Tk, nh, nkv, causal, scale);
    return launch(dq_kernel, dim3((Sq + TILE - 1) / TILE, nh, B), smem, stream, qp, kp, vp, dop,
                  lp, dp, qsp, klp, o0, Sq, Tk, nh, nkv, causal, scale);
  };
  switch (hd) {
    case 32:
      return go(flash_bwd_dq_kernel<T, 32>, flash_bwd_dkv_kernel<T, 32>, BwdSmem<T, 32>::bytes);
    case 64:
      return go(flash_bwd_dq_kernel<T, 64>, flash_bwd_dkv_kernel<T, 64>, BwdSmem<T, 64>::bytes);
    case 128:
      return go(flash_bwd_dq_kernel<T, 128>, flash_bwd_dkv_kernel<T, 128>,
                BwdSmem<T, 128>::bytes);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dO, lse, D (f32 (B, nh, Sq)), q_start, kv_len (int32), dq (f32,
// q's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int qt_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dq, int B,
                                    int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd<__nv_bfloat16>(false, q, k, v, dout, lse, delta, q_start, kv_len, dq,
                                   nullptr, B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
}

extern "C" int qt_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* q_start, const void* kv_len, void* dq, int B,
                                   int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                   float scale, void* stream) {
  return launch_bwd<float>(false, q, k, v, dout, lse, delta, q_start, kv_len, dq, nullptr, B, Sq,
                           Tk, nh, nkv, hd, causal, scale, stream);
}

// ... dk, dv (f32, k's shape), B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int qt_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* q_start, const void* kv_len, void* dk, void* dv,
                                     int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                     float scale, void* stream) {
  return launch_bwd<__nv_bfloat16>(true, q, k, v, dout, lse, delta, q_start, kv_len, dk, dv, B,
                                   Sq, Tk, nh, nkv, hd, causal, scale, stream);
}

extern "C" int qt_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* q_start, const void* kv_len, void* dk, void* dv,
                                    int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                    float scale, void* stream) {
  return launch_bwd<float>(true, q, k, v, dout, lse, delta, q_start, kv_len, dk, dv, B, Sq, Tk,
                           nh, nkv, hd, causal, scale, stream);
}
