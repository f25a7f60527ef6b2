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
// with the online softmax: per key tile (64 keys; 32 in f32 from hd 128),
// m' = max(m, max_j s_j),
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
// Head dims (flash_common.cuh): both routes are compiled at 32, 64, 128 and
// (flash_fwd_w256.cu) 256 columns; a head dim in between runs padded to the
// next, the extra columns zero in shared memory and never stored. The
// padded bf16 forward is held to two blocks an SM below 256. At 256 the
// bf16 route is flash_fwd_ws (O is m64 x 256 f32, 128 registers a thread:
// a producer warpgroup and two consumers, one block an SM); the f32
// route's two warpgroups share 64 query
// rows, each computing S and owning 128 columns of O (FwdF32::SPLIT_O), with
// one buffer of split K / V tiles.
//
// bf16 (the pieces are sm90.cuh's, as the backward's dQ kernel): a block of FWD_WG consumer warpgroups owns FWD_WG
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
// f32 (QLoRA on an f32 base at S >= 1024, the JAX package's `finetune
// --dtype float32 --seq-len 1024`, timed by chip_smoke.py's phase 33 and
// its f32 kernel rows; the f32 cached prefill). The TPU kernel's f32 dots
// run at Precision.HIGHEST. Here each f32 product runs as three TF32 wgmma
// products, a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (flash_tf32x3.cuh): a
// ceiling of 495 / 3 = 165 TFLOP/s, 0.052 ms at TinyLlama's shape (f32 FMAs
// on the CUDA cores: 0.128 ms). tf32 wgmma reads K-major operands only, B
// from shared memory. A block of FwdF32::WGS warpgroups owns 64 query rows
// each, ordered as the bf16 blocks; a warpgroup reads Q's A fragments from
// its raw tile (frag_rows) and splits them in registers. Per key tile (64
// keys; 32 at hd 128, where the shared memory holds no more) the block's
// threads split K into hi / lo B tiles (rows = keys, hd in the fragments'
// order) and V into transposed hi / lo B tiles (rows = hd), staged through
// registers a tile ahead (coalesced loads, 16-byte stores that meet each
// bank once) into one of two buffers. Each warpgroup then computes S = Q
// K^T, masks it and runs the online softmax on the accumulator registers as
// the bf16 route does, and adds P V with P's accumulator registers as its A
// fragments: S's accumulator holds columns 2q and 2q + 1 of each 8-key
// chunk, a tf32 A fragment columns q and q + 4 of a k8 slice, so V^T's tiles
// keep keys 0, 2, 4, 6 of each slice at positions 0-3 and 1, 3, 5, 7 at
// 4-7, and p is split in registers: no tile of p goes through shared
// memory. Each tile's P V goes into a fresh partial (the tensor cores add
// with truncation), folded in on the CUDA cores as o = o alpha + partial,
// rounded to nearest. Against the plain version: ~1e-6 of max|plain| at
// chip_smoke.py's shapes, lse within 1e-6.
//
// Tried on the H100 (PERF.md's f32 flash forward findings; kernel_sweep.py
// --what flash --dtype float32 on copies of this file, ms at TinyLlama
// s1024 / Llama-2-7B's shape; the first port's CUDA-core design 0.730 /
// 0.931): K and V staged a lane per key (a load touching 32 rows, 4-byte
// V^T stores) 0.147 / 0.170; coalesced loads and 16-byte stores 0.128 /
// 0.146 (kept; the V^T stores alone 0.144 / 0.167). No gain from:
// warpgroup 1 running half a tile behind warpgroup 0, so one's softmax
// meets the other's products (0.146 / 0.164 with P split up front, 0.191 /
// 0.208 through the chain's waits); Q as split tiles that wgmma reads from
// shared memory, the staging placed between the products' issue and wait
// (0.155 / 0.189: a branch there makes ptxas serialize the products, so
// every warpgroup multiplies every tile, masked); P split up front (0.147 /
// 0.169); three warpgroups a block (0.157 at hd 64, 168 registers, spills).
// Timing-only cuts from 0.147: no K / V staging -30%, no per-tile loads
// -16%, one TF32 product for three -22%, no exponentials -4%.

#include "flash_common.cuh"
#include "flash_tf32x3.cuh"
#include "sm90.cuh"
#ifdef QT_FLASH_WIDE
#include "ws_sm90.cuh"
#endif

namespace {

// ------------------------------------------------------- f32: 3xTF32 on Hopper

template <int HD> struct FwdF32 {
  static constexpr int WGS = 2;  // warpgroups a block
  // HD 256: O (m64 x 256) and each tile's partial do not fit one warpgroup's
  // registers, so the two warpgroups share 64 query rows, each computing S
  // and owning 128 columns of O; below, each owns 64 query rows and all of O
  static constexpr bool SPLIT_O = HD == 256;
  static constexpr int ROW_WGS = SPLIT_O ? 1 : WGS;  // warpgroups along the query rows
  static constexpr int OW = SPLIT_O ? HD / 2 : HD;   // columns of O a warpgroup owns
  static constexpr int BK = HD >= 128 ? 32 : 64;     // keys a tile
  static constexpr int ROWS = 64 * ROW_WGS;          // query rows a block
  static constexpr int THREADS = 128 * WGS;
  using KT = KTile<BK, HD>;  // K hi / lo: the B of S = Q K^T (rows = keys)
  using VT = KTile<HD, BK>;  // V^T hi / lo: the B of P V (rows = hd, keys in P's fragment order)
  using RT = RawTile<HD>;    // each row warpgroup's Q, the A of S
  // the items of K (key, 8 hd) and of V (4 keys, 4 hd) each thread stages a tile
  static constexpr int ITEMS = BK * HD / 8 / THREADS;
  static_assert(ITEMS * THREADS * 8 == BK * HD, "whole K items a thread");
  static constexpr int N_VITEMS = BK * HD / 16, VITEMS = (N_VITEMS + THREADS - 1) / THREADS;
  // split K / V tiles: the next tile's beside the current one; at HD 256
  // one buffer (128 KB), refilled once every warpgroup is done with it
  static constexpr int BUFS = SPLIT_O ? 1 : 2;
  // buffer u: K hi, K lo, V^T hi, V^T lo at u BUF; row warpgroup w's raw Q at Q0 + w RT::BYTES
  static constexpr uint32_t BUF = 2 * KT::BYTES + 2 * VT::BYTES, Q0 = BUFS * BUF;
  static constexpr size_t bytes = Q0 + ROW_WGS * RT::BYTES + 1024;
};

// grid (query head, batch row, blocks of `rows` query rows)
dim3 fwd_grid(int B, int Sq, int nh, int rows) { return dim3(nh, B, (Sq + rows - 1) / rows); }

template <int HD, bool PAD>
__global__ void __launch_bounds__(FwdF32<HD>::THREADS, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const int* __restrict__ q_start, const int* __restrict__ kv_len,
              float* __restrict__ out, float* __restrict__ lse, int Sq, int Tk, int nh, int nkv,
              int hd_arg, int causal, float scale) {
  using L = FwdF32<HD>;
  const int hd = PAD ? hd_arg : HD;  // the real head dim, of HD columns
  using KT = typename L::KT;
  using VT = typename L::VT;
  using RT = typename L::RT;
  constexpr int BK = L::BK, NT = L::THREADS;
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int rwg = L::SPLIT_O ? 0 : wg;      // this warpgroup's rows
  const int oc = L::SPLIT_O ? wg * L::OW : 0;  // its first column of O
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::ROWS;  // the longest rows first
  const int qw = q0 + rwg * TILE;                         // this warpgroup's first row
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  // the block splits the key tiles up to the horizon of its last row; a
  // warpgroup multiplies those up to its own (none when its rows are past Sq)
  const int kv_end = causal ? min(kvl, qs + min(q0 + L::ROWS, Sq)) : kvl;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int kv_end_w = qw < Sq ? live_kv_end(qs, qw, Sq, kvl, causal) : 0;
  const int n_tiles_w = kv_end_w > 0 ? (kv_end_w + BK - 1) / BK : 0;

  const uint32_t Qw = base + L::Q0 + rwg * RT::BYTES;
  const float* Qr = reinterpret_cast<const float*>(gbase + (Qw - base));
  if (!L::SPLIT_O || wg == 0)
    RT::load(Qw, q + ((int64_t)b * Sq * nh + h) * hd, (int64_t)nh * hd, qw, Sq, wtid, hd);
  cp_async_commit();

  // Each thread stages its items of a key tile's K and V in registers, a
  // tile ahead, and splits them into a buffer, 16-byte stores that meet
  // each bank once, from loads that read 128 contiguous bytes of each row
  // they touch. K: (key, 8 hd) items, lanes 0-7 of a warp 4 k8 slices of 2
  // keys. V: (4 keys of one parity in a k8 slice, 4 hd) items, one V^T row
  // a store: lanes 0-7 two hd chunks x both parities x two slices, lanes
  // 8-31 the next hd chunks.
  const float* kb = k + ((int64_t)b * Tk * nkv + g) * hd;
  const float* vb = v + ((int64_t)b * Tk * nkv + g) * hd;
  const int64_t kv_stride = (int64_t)nkv * hd;
  constexpr int NC = HD / 4;  // V's hd chunks
  float4 kx[L::ITEMS][2], vx[L::VITEMS][4];
  auto k_item = [&](int i, int& key, int& kk) {
    key = ((i >> 3) / (HD / 32)) << 1 | ((i >> 2) & 1);
    kk = (i & 3) | ((i >> 3) % (HD / 32)) << 2;
  };
  auto v_item = [&](int i, int& c, int& par, int& sl) {
    c = (i & 1) | ((i >> 3) % (NC / 2)) << 1;
    par = (i >> 1) & 1;
    sl = ((i >> 2) & 1) | ((i >> 3) / (NC / 2)) << 1;
  };
  auto fetch = [&](int t) {  // tile t's items into the registers (zeros past Tk and hd)
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int n = 0; n < L::ITEMS; ++n) {
      int key, kk;
      k_item(tid + NT * n, key, kk);
      key += t * BK;
      kx[n][0] = kx[n][1] = zero;
      if (key < Tk) {
        const float4* kp = reinterpret_cast<const float4*>(kb + key * kv_stride + 8 * kk);
        if (!PAD || 8 * kk < hd) kx[n][0] = __ldg(kp);
        if (!PAD || 8 * kk + 4 < hd) kx[n][1] = __ldg(kp + 1);
      }
    }
#pragma unroll
    for (int n = 0; n < L::VITEMS; ++n) {
      const int i = tid + NT * n;
      int c, par, sl;
      v_item(i, c, par, sl);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * BK + 8 * sl + par + 2 * j;
        vx[n][j] = zero;
        if (i < L::N_VITEMS && key < Tk && (!PAD || 4 * c < hd))
          vx[n][j] = __ldg(reinterpret_cast<const float4*>(vb + key * kv_stride + 4 * c));
      }
    }
  };
  auto stash = [&](int u) {  // the staged items, split, into buffer u
    const uint32_t k_hi = base + u * L::BUF, k_lo = k_hi + KT::BYTES;
    const uint32_t v_hi = k_lo + KT::BYTES, v_lo = v_hi + VT::BYTES;
#pragma unroll
    for (int n = 0; n < L::ITEMS; ++n) {
      int key, kk;
      k_item(tid + NT * n, key, kk);
      split_store<BK, HD>(k_hi, k_lo, key, kk, kx[n][0], kx[n][1]);
    }
    // V^T: rows hd 4 c .. 4 c + 3; keys 8 sl + par + 2 j at positions 8 sl
    // + 4 par + j (P's fragment order: keys 0, 2, 4, 6 of a k8 slice, then
    // 1, 3, 5, 7)
#pragma unroll
    for (int n = 0; n < L::VITEMS; ++n) {
      const int i = tid + NT * n;
      int c, par, sl;
      v_item(i, c, par, sl);
      if (i >= L::N_VITEMS) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32(reinterpret_cast<const float*>(&vx[n][j])[e], hi[j], lo[j]);
        const uint32_t off = VT::offset(4 * c + e, 8 * sl + 4 * par);
        st_shared4(v_hi + off, hi[0], hi[1], hi[2], hi[3]);
        st_shared4(v_lo + off, lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };
  if (n_tiles > 0) {
    fetch(0);
    stash(0);
  }
  if (L::BUFS > 1 && n_tiles > 1) fetch(1);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q and the first split tile are whole

  // this thread's rows r0 and r0 + 8 of the warpgroup's tile, columns 8 j +
  // 2 q4 + c: running max (of the raw scores) and sum per row, in registers
  const int r0 = 16 * warp + lane / 4, q4 = lane % 4;
  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[L::OW / 2];
#pragma unroll
  for (int e = 0; e < L::OW / 2; ++e) o[e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t k_hi = base + (t % L::BUFS) * L::BUF, k_lo = k_hi + KT::BYTES;
    const uint32_t v_hi = k_lo + KT::BYTES, v_lo = v_hi + VT::BYTES;
    if (t < n_tiles_w) {
      // S = Q K^T, Q's fragments read from its raw tile
      float s[BK / 2];
      {
        auto cs = chain<BK>(s, [&](int kk, float(&a)[4]) { frag_rows<HD>(Qr, r0, q4, kk, a); },
                            [&](int kk) { return KT::desc(k_hi, kk); },
                            [&](int kk) { return KT::desc(k_lo, kk); });
        mma_3xtf32<HD / 8>(cs);
      }

      // -inf where masked, only on the tiles that straddle the causal
      // diagonal or kv_len; then the row max m' of the raw scores (scale > 0)
      const int k0 = t * BK;
      if (k0 + BK > kvl || (causal && k0 + BK - 1 > qs + qw)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (!live_pair(k0 + 8 * j + 2 * q4 + c, qs + qw + r0 + 8 * i, kvl, causal))
                s[4 * j + 2 * i + c] = -INFINITY;
      }
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
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
      for (int j = 0; j < BK / 8; ++j)
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

      // the tile's P V into a fresh partial, P's accumulator registers
      // being its A fragments: slice kk's columns q, q + 4 are keys 8 kk +
      // 2 q, 8 kk + 2 q + 1, which V^T's tiles hold at positions q, q + 4;
      // the warpgroup's columns of O are V^T's rows from oc (128-byte rows)
      float part[L::OW / 2];
      {
        auto cp = chain<L::OW>(part, [&](int kk, float(&a)[4]) {
          a[0] = s[4 * kk];
          a[1] = s[4 * kk + 2];
          a[2] = s[4 * kk + 1];
          a[3] = s[4 * kk + 3];
        }, [&](int kk) { return VT::desc(v_hi + oc * 128, kk); },
           [&](int kk) { return VT::desc(v_lo + oc * 128, kk); });
        mma_3xtf32<BK / 8>(cp);
      }
#pragma unroll
      for (int j = 0; j < L::OW / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            o[e] = fmaf(o[e], alpha[i], part[e]);
          }
    }
    // the next tile, split into the other buffer (its last reader, tile t -
    // 1, is done on every warpgroup), and the one after into the registers;
    // with one buffer, the next tile's loads and then, once every
    // warpgroup is done with this one, its split
    if constexpr (L::BUFS == 1) {
      if (t + 1 < n_tiles) {
        fetch(t + 1);
        __syncthreads();
        stash(0);
      }
    } else if (t + 1 < n_tiles) {
      stash((t + 1) % L::BUFS);
      if (t + 2 < n_tiles) fetch(t + 2);
    }
    fence_proxy_async();
    __syncthreads();  // the next tile's split is whole; every warpgroup is done with this one
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r0 + 8 * i;
    if (row >= Sq) continue;
    float* orow = out + (((int64_t)b * Sq + row) * nh + h) * hd + oc + 2 * q4;
#pragma unroll
    for (int j = 0; j < L::OW / 8; ++j) {
      if (PAD && oc + 8 * j + 2 * q4 >= hd) continue;  // a padded column
      const float x0 = l[i] > 0.0f ? o[4 * j + 2 * i] / l[i] : 0.0f;
      const float x1 = l[i] > 0.0f ? o[4 * j + 2 * i + 1] / l[i] : 0.0f;
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(x0, x1);
    }
    if (lse != nullptr && q4 == 0 && oc == 0)
      lse[((int64_t)b * nh + h) * Sq + row] = l[i] > 0.0f ? m[i] * scale + logf(l[i]) : kDeadLse;
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

// A padded head dim is held to two blocks an SM (128 registers, 20-24
// bytes spilled at HD 128): unbounded, its runtime column masks took 162,
// one block an SM, 26% longer at hd 128's work. The unpadded widths stay
// unbounded (0): 96-126 registers, two blocks an SM, where a bound of one
// block gave them 104-146 and hd 128 one block an SM, 3% slower (PERF.md).
// (Built at 32, 64 and 128 columns; 256: flash_fwd_ws below.)
template <int HD, bool PAD>
__global__ void __launch_bounds__(FWD_THREADS, PAD ? 2 : 0)
flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ q_start, const int* __restrict__ kv_len,
               bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Tk, int nh, int nkv,
               int hd_arg, int causal, float scale) {
  using TL = Tile<HD>;
  const int hd = PAD ? hd_arg : HD;  // the real head dim, of HD columns
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

  const bf16* kb = k + ((int64_t)b * Tk * nkv + g) * hd;
  const bf16* vb = v + ((int64_t)b * Tk * nkv + g) * hd;
  const int64_t kv_stride = (int64_t)nkv * hd;
  const uint32_t Qw = Qs + wg * TL::BYTES;
  TL::load_part(Qw, q + ((int64_t)b * Sq * nh + h) * hd, (int64_t)nh * hd, qw, Sq, wtid, 128, hd);
#pragma unroll
  for (int st = 0; st < FWD_STAGES - 1; ++st) {
    if (st < n_tiles) {
      TL::load_part(Ks(st), kb, kv_stride, st * TILE, Tk, threadIdx.x, FWD_THREADS, hd);
      TL::load_part(Vs(st), vb, kv_stride, st * TILE, Tk, threadIdx.x, FWD_THREADS, hd);
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
      TL::load_part(Ks(tn % FWD_STAGES), kb, kv_stride, tn * TILE, Tk, threadIdx.x, FWD_THREADS,
                    hd);
      TL::load_part(Vs(tn % FWD_STAGES), vb, kv_stride, tn * TILE, Tk, threadIdx.x, FWD_THREADS,
                    hd);
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
    bf16* orow = out + (((int64_t)b * Sq + row) * nh + h) * hd + c_lo;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (PAD && 8 * j + c_lo >= hd) continue;  // a padded column
      const float x0 = l[i] > 0.0f ? o[4 * j + 2 * i] / l[i] : 0.0f;
      const float x1 = l[i] > 0.0f ? o[4 * j + 2 * i + 1] / l[i] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * nh + h) * Sq + row] = l[i] > 0.0f ? m[i] * scale + logf(l[i]) : kDeadLse;
  }
}

#ifdef QT_FLASH_WIDE
// ------------------------------------------ bf16 at 256 columns: warp-specialised

// Shared memory: two Q tiles (one for each consumer), a ring of WS_STAGES K tiles
// and one of V tiles, then the mbarriers: Q's full, K's and V's full and
// empty a slot.
struct FwdWs {
  using TL = Tile<256>;
  static constexpr uint32_t Q = 0, K = 2 * TL::BYTES, V = K + WS_STAGES * TL::BYTES;
  static constexpr uint32_t Q_FULL = V + WS_STAGES * TL::BYTES, K_FULL = Q_FULL + 8,
                            V_FULL = K_FULL + 8 * WS_STAGES, K_EMPTY = V_FULL + 8 * WS_STAGES,
                            V_EMPTY = K_EMPTY + 8 * WS_STAGES;
  static constexpr uint32_t ZERO = V_EMPTY + 8 * WS_STAGES;  // a word that holds 0 (PASS_ON)
  static constexpr size_t bytes = ZERO + 8 + 1024;
};
constexpr int PING = 1;  // named barriers PING + c: consumer c's turn to issue its products
// setmaxnreg: the producer's registers and the consumers' (24 x 128 + 240 x 256 = 168 x 384)
constexpr int FWD_WS_PRODUCER_REGS = 24, FWD_WS_CONSUMER_REGS = 240;

// The online softmax of one key tile's scores s (flash_fwd_sm90's
// arithmetic), for this thread's rows i = 0, 1 and its columns 8j + c of
// the tile (keys k0 + 8j + c_lo + c): -inf from the row's first dead key
// on (FwdTurn's end[i], less k0: one compare a score, no branch, and
// nothing masked off the causal diagonal and kv_len's tile); p = 2^((s -
// m') scale log2 e) in place of s; l and m updated; alpha = exp(m - m')
// for O.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const int (&end)[2], int k0,
                                               float scale2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        s[4 * j + 2 * i + c] = 8 * j + c < end[i] - k0 ? s[4 * j + 2 * i + c] : -INFINITY;
  // row max and (below) row sum as trees over the row's 16 scores: short
  // dependency chains, where one warp a scheduler has little else to run
  float mt[2], mb[2], ls[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    mt[i] = t[0];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    mt[i] = fmaxf(m[i], mt[i]);  // m'
    alpha[i] = mt[i] == -INFINITY ? 1.0f : fast_exp2((m[i] - mt[i]) * scale2);
    mb[i] = mt[i] == -INFINITY ? 0.0f : mt[i] * scale2;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = fast_exp2(fmaf(s[e], scale2, -mb[(e >> 1) & 1]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    ls[i] = t[0];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
    ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
    l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), ls[i]);  // the TPU kernel's order, not an FMA
    m[i] = mt[i];
  }
}

// S = Q K^T of one key tile into s, and O += P V of one, issued as a
// commit group each (not waited for)
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t Qw, uint32_t Kt) {
#pragma unroll
  for (int kk = 0; kk < 256 / 16; ++kk)
    wgmma_ss<64>(s, Tile<256>::k_major(Qw, kk), Tile<256>::k_major(Kt, kk), kk > 0);
  wgmma_commit();
}
__device__ __forceinline__ void issue_pv(float (&o)[128], const uint32_t (&pa)[4][4], uint32_t Vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<256>(o, pa[kk], Tile<256>::mn_major(Vt, kk));
  wgmma_commit();
}
// O *= alpha, row by row
__device__ __forceinline__ void rescale(float (&o)[128], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
}

// A consumer's values that hold through its turns; end[i]: this thread's
// row i's first dead key, less its first column c_lo
struct FwdTurn {
  uint32_t base, Qw;
  int n_w, n_tiles, turns, c, lane, end[2];
  float scale2;
};
__device__ __forceinline__ uint32_t ws_slot(int t) {  // t >= -1
  return (t + WS_STAGES) % WS_STAGES;
}
__device__ __forceinline__ uint32_t ws_parity(int t) { return (t / WS_STAGES) & 1; }

// Turn k of a consumer (see flash_fwd_ws): S_k in cur, S_{k+1} issued into
// nxt. The turns run in pairs with cur and nxt swapped: a register copy of
// S would wait on the products in flight. (P still packs into pa, the A
// operand of P_{k-1} V_{k-1}: ptxas moves those packs into the softmax and
// the products' wait with them; a second P buffer does not fit the 240
// registers beside O and the two S; PERF.md.)
__device__ __forceinline__ void fwd_turn(const FwdTurn& f, int k, float (&o)[128], float (&m)[2],
                                         float (&l)[2], uint32_t (&pa)[4][4], float (&cur)[32],
                                         float (&nxt)[32]) {
  using L = FwdWs;
  using TL = Tile<256>;
  const uint32_t base = f.base;
  const int mine = PING + f.c, other = PING + 1 - f.c;
  // consumer 1 passes its last turn on to no one: every barrier phase is whole
  const bool pass = f.c == 0 || k + 1 < f.turns;
  if (k + 1 < f.n_tiles) mbar_wait(base + L::K_FULL + 8 * ws_slot(k + 1), ws_parity(k + 1));
  if (k > 0) mbar_wait(base + L::V_FULL + 8 * ws_slot(k - 1), ws_parity(k - 1));
  named_sync(mine, 256);
  const uint32_t Kn = base + L::K + ws_slot(k + 1) * TL::BYTES;
  const uint32_t Vp = base + L::V + ws_slot(k - 1) * TL::BYTES;
  const int k0 = k * TILE;
  float alpha[2];
  if (k + 1 < f.n_w && k > 0) {  // S_{k+1} and P_{k-1} V_{k-1} beside tile k's softmax
    wgmma_fence();
    fence_regs(o);
    issue_s(nxt, f.Qw, Kn);
    issue_pv(o, pa, Vp);
    named_arrive_if(other, 256, pass);
    // after the arrive (PASS_ON)
    online_softmax(cur, m, l, alpha, f.end, k0 + ld_shared_u32(base + L::ZERO), f.scale2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(nxt);
    rescale(o, alpha);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(cur, kk, pa[kk]);
  } else if (k + 1 < f.n_w) {  // k = 0: S_1 beside tile 0's softmax (O is zero: no rescale)
    wgmma_fence();
    issue_s(nxt, f.Qw, Kn);
    named_arrive_if(other, 256, pass);
    online_softmax(cur, m, l, alpha, f.end, k0 + ld_shared_u32(base + L::ZERO), f.scale2);
    wgmma_wait<0>();
    fence_regs(nxt);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(cur, kk, pa[kk]);
  } else if (k < f.n_w && k > 0) {  // the last tile's softmax beside P_{k-1} V_{k-1}
    wgmma_fence();
    fence_regs(o);
    issue_pv(o, pa, Vp);
    named_arrive_if(other, 256, pass);
    online_softmax(cur, m, l, alpha, f.end, k0 + ld_shared_u32(base + L::ZERO), f.scale2);
    wgmma_wait<0>();
    fence_regs(o);
    rescale(o, alpha);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(cur, kk, pa[kk]);
  } else if (k < f.n_w) {  // a single tile: its softmax alone
    named_arrive_if(other, 256, pass);
    online_softmax(cur, m, l, alpha, f.end, k0, f.scale2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(cur, kk, pa[kk]);
  } else if (k > 0 && k <= f.n_w) {  // the last tile's P V
    wgmma_fence();
    fence_regs(o);
    issue_pv(o, pa, Vp);
    named_arrive_if(other, 256, pass);
    wgmma_wait<0>();
    fence_regs(o);
  } else {  // past this consumer's horizon: the turn passes on
    named_arrive_if(other, 256, pass);
  }
  // the slots this turn is done with: K_{k+1} (its S waited for, or not
  // this consumer's), V_{k-1}
  mbar_arrive_if(base + L::K_EMPTY + 8 * ws_slot(k + 1), f.lane == 0 && k + 1 < f.n_tiles);
  mbar_arrive_if(base + L::V_EMPTY + 8 * ws_slot(k - 1), f.lane == 0 && k > 0);
}

// Head dims 129-256 (bf16): the same function as flash_fwd_sm90, by two
// consumer warpgroups and a producer warpgroup (ws_sm90.cuh). The
// producer's one thread loads the block's two Q tiles once, then streams
// K and V tiles by TMA through rings of WS_STAGES slots. Each consumer owns
// 64 query rows and holds S of the next key tile beside this one's: its
// turn k issues S_{k+1} = Q K_{k+1}^T and O += P_{k-1} V_{k-1} (P of the
// tile before, in registers as the A operand) back to back, runs tile k's
// softmax on S_k while both run, waits for both, rescales O by tile k's
// alpha and packs P_k: O = O alpha_k + P_k V_k as flash_fwd_sm90 adds it,
// one turn later, and no product's latency between two softmaxes. The two
// consumers take turns on two named barriers (ping-pong): consumer c issues
// turn k once the other has issued its turn k - 1 (c = 0) or k (c = 1).
// PASS_ON: tile k's softmax reads S_k, which the turn before completed, so
// nothing held it after the arrive that passes the turn on; ptxas moved it
// into the products' issue, above the arrive, the other consumer waited
// for the whole softmax, and the two softmaxes ran one after the other
// (PERF.md). The softmax now takes its first key from a word of shared
// memory (0) loaded after the arrive, which ptxas cannot see through.
// Every consumer takes n_tiles + 1 turns: one past its causal horizon only
// passes the turn on and releases the slots. No __syncthreads in the key
// loop; between a product's issue and its wait only straight-line code
// (masks as selects, predicated arrivals).
template <bool PAD>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_ws(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_start,
             const int* __restrict__ kv_len, bf16* __restrict__ out, float* __restrict__ lse,
             int Sq, int Tk, int nh, int nkv, int hd_arg, int causal, float scale) {
  using TL = Tile<256>;
  using L = FwdWs;
  constexpr int HD = 256;
  const int hd = PAD ? hd_arg : HD;  // the real head dim, of HD columns
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);

  const int wg = warpgroup(), wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_ROWS;  // the longest rows first
  const int g = h / (nh / nkv);
  const int qs = q_start[b];
  const int kvl = max(0, min(kv_len[b], Tk));
  const int kv_end = causal ? min(kvl, qs + min(q0 + FWD_ROWS, Sq)) : kvl;
  const int n_tiles = kv_end > 0 ? (kv_end + TILE - 1) / TILE : 0;

  if (threadIdx.x == 0) {
    st_shared_u32(base + L::ZERO, 0);
    mbar_init(base + L::Q_FULL, 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(base + L::K_FULL + 8 * s, 1);
      mbar_init(base + L::V_FULL + 8 * s, 1);
      mbar_init(base + L::K_EMPTY + 8 * s, 8);  // one arrival a consumer warp
      mbar_init(base + L::V_EMPTY + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WS_CONSUMERS) {  // the producer
    regs_dec<FWD_WS_PRODUCER_REGS>();
    if (wtid == 0 && n_tiles > 0) {
      mbar_expect_tx(base + L::Q_FULL, 2 * TL::BYTES);
      tma_tile<HD>(base + L::Q, &tq, base + L::Q_FULL, h, q0, b);
      tma_tile<HD>(base + L::Q + TL::BYTES, &tq, base + L::Q_FULL, h, q0 + TILE, b);
      // K runs a tile ahead of V, as the consumers read them (S_{k+1} beside P_{k-1} V_{k-1})
      auto load = [&](uint32_t tiles, uint32_t full, uint32_t empty, const CUtensorMap* map,
                      int t) {
        const int s = t % WS_STAGES;
        mbar_wait_guarded(empty + 8 * s, ((t / WS_STAGES) & 1) ^ 1);  // the slot's last phase
        mbar_expect_tx(full + 8 * s, TL::BYTES);
        tma_tile<HD>(tiles + s * TL::BYTES, map, full + 8 * s, g, t * TILE, b);
      };
      load(base + L::K, base + L::K_FULL, base + L::K_EMPTY, &tk, 0);
      for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) load(base + L::K, base + L::K_FULL, base + L::K_EMPTY, &tk, t + 1);
        load(base + L::V, base + L::V_FULL, base + L::V_EMPTY, &tv, t);
      }
    }
    return;
  }
  regs_inc<FWD_WS_CONSUMER_REGS>();

  const int c = wg;  // this consumer: query rows qw .. qw + 63
  const int qw = q0 + c * TILE;
  const int kv_end_w = qw < Sq ? live_kv_end(qs, qw, Sq, kvl, causal) : 0;
  const int n_w = kv_end_w > 0 ? (kv_end_w + TILE - 1) / TILE : 0;
  const uint32_t Qw = base + L::Q + c * TL::BYTES;
  // this thread's rows r_lo and r_lo + 8 of the consumer's tile, columns
  // 8j + c_lo + c: running max (of the raw scores) and sum per row
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[HD / 2], s[32], sn[32];  // S of this tile and of the next, by turns
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  // tile 0's S, outside the turns
  if (n_tiles > 0) mbar_wait(base + L::K_FULL, 0);
  if (n_w > 0) {
    mbar_wait(base + L::Q_FULL, 0);
    wgmma_fence();
    issue_s(s, Qw, base + L::K);
    wgmma_wait<0>();
    fence_regs(s);
  }
  mbar_arrive_if(base + L::K_EMPTY, lane == 0 && n_tiles > 0);

  const int turns = n_tiles > 0 ? n_tiles + 1 : 0;
  FwdTurn f{base, Qw, n_w, n_tiles, turns, c, lane, {0, 0}, scale * kLog2e};
#pragma unroll
  for (int i = 0; i < 2; ++i)  // keys past kv_len, or (causal) past the row's position, are dead
    f.end[i] = (causal ? min(kvl, qs + qw + r_lo + 8 * i + 1) : kvl) - c_lo;
  named_arrive_if(PING, 256, c == 1 && turns > 0);  // consumer 0 issues first
  for (int k = 0; k < turns; k += 2) {
    fwd_turn(f, k, o, m, l, pa, s, sn);
    if (k + 1 < turns) fwd_turn(f, k + 1, o, m, l, pa, sn, s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r_lo + 8 * i;
    if (row >= Sq) continue;
    bf16* orow = out + (((int64_t)b * Sq + row) * nh + h) * hd + c_lo;
    // o times 1/l rounded to nearest: 128 divisions a thread, each with its
    // slow path, held the block's last rows (within an f32 ulp or so of o / l)
    const float inv = l[i] > 0.0f ? __frcp_rn(l[i]) : 0.0f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (PAD && 8 * j + c_lo >= hd) continue;  // a padded column
      const float x0 = __fmul_rn(o[4 * j + 2 * i], inv);
      const float x1 = __fmul_rn(o[4 * j + 2 * i + 1], inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * nh + h) * Sq + row] = l[i] > 0.0f ? m[i] * scale + logf(l[i]) : kDeadLse;
  }
}

// q, k, v by TMA: hd a multiple of 8 (the wrapper pads the others)
template <bool PAD>
int launch_fwd_ws(const void* q, const void* k, const void* v, const void* q_start,
                  const void* kv_len, void* out, void* lse, int B, int Sq, int Tk, int nh, int nkv,
                  int hd, int causal, float scale, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!tile_map(&mq, q, B, Sq, nh, hd) || !tile_map(&mk, k, B, Tk, nkv, hd) ||
      !tile_map(&mv, v, B, Tk, nkv, hd))
    return (int)cudaErrorInvalidValue;
  return launch_n(flash_fwd_ws<PAD>, fwd_grid(B, Sq, nh, FWD_ROWS), WS_THREADS, FwdWs::bytes,
                  stream, mq, mk, mv, static_cast<const int*>(q_start),
                  static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                  static_cast<float*>(lse), Sq, Tk, nh, nkv, hd, causal, scale);
}
#endif  // QT_FLASH_WIDE

bool bad_sizes(int B, int Sq, int Tk, int nh, int nkv) {
  return B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0;
}

template <int HD, bool PAD>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const void* q_start,
                    const void* kv_len, void* out, void* lse, int B, int Sq, int Tk, int nh,
                    int nkv, int hd, int causal, float scale, void* stream) {
  return launch_n(flash_fwd_sm90<HD, PAD>, fwd_grid(B, Sq, nh, FWD_ROWS), FWD_THREADS,
                  FwdSmem90<HD>::bytes, stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const int*>(q_start),
                  static_cast<const int*>(kv_len), static_cast<bf16*>(out),
                  static_cast<float*>(lse), Sq, Tk, nh, nkv, hd, causal, scale);
}

template <int HD, bool PAD>
int launch_fwd_f32(const void* q, const void* k, const void* v, const void* q_start,
                   const void* kv_len, void* out, void* lse, int B, int Sq, int Tk, int nh,
                   int nkv, int hd, int causal, float scale, void* stream) {
  using L = FwdF32<HD>;
  return launch_n(flash_fwd_f32<HD, PAD>, fwd_grid(B, Sq, nh, L::ROWS), L::THREADS, L::bytes,
                  stream, static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const int*>(q_start),
                  static_cast<const int*>(kv_len), static_cast<float*>(out),
                  static_cast<float*>(lse), Sq, Tk, nh, nkv, hd, causal, scale);
}

// The launch of a route at a shape, for a report (see qt_flash_fwd_design)
template <typename Kernel>
int report(Kernel kernel, dim3 grid, int warpgroups, size_t smem, int stages, int* out,
           int threads = 0) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (threads == 0) threads = 128 * warpgroups;
  const int vals[11] = {(int)grid.x, (int)grid.y, (int)grid.z, warpgroups,
                        blocks_per_sm(kernel, smem, threads), attr.numRegs, (int)smem,
                        (int)attr.localSizeBytes, sm_count(), stages, threads};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return (int)rc;
}

template <int HD, bool PAD> int fwd_design(bool f32, int B, int Sq, int nh, int* out) {
  using L = FwdF32<HD>;
  if (f32)
    return report(flash_fwd_f32<HD, PAD>, fwd_grid(B, Sq, nh, L::ROWS), L::WGS, L::bytes, L::BUFS,
                  out);
#ifdef QT_FLASH_WIDE
  return report(flash_fwd_ws<PAD>, fwd_grid(B, Sq, nh, FWD_ROWS), WS_CONSUMERS, FwdWs::bytes,
                WS_STAGES, out, WS_THREADS);
#else
  return report(flash_fwd_sm90<HD, PAD>, fwd_grid(B, Sq, nh, FWD_ROWS), FWD_WG,
                FwdSmem90<HD>::bytes, FWD_STAGES, out);
#endif
}

int design(bool f32, int hd, int B, int Sq, int nh, int* out) {
  if (B <= 0 || Sq <= 0 || nh <= 0) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto H, auto P) {
    return fwd_design<decltype(H)::value, decltype(P)::value>(f32, B, Sq, nh, out);
  });
}

}  // namespace

// q, k, v, q_start, kv_len (int32), out, lse (f32 (B, nh, Sq), or null),
// B, Sq, T, nh, nkv, hd, causal, scale, stream
extern "C" int QT_FLASH_ENTRY(qt_flash_fwd_bf16)(const void* q, const void* k, const void* v,
                                 const void* q_start, const void* kv_len, void* out, void* lse,
                                 int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                 float scale, void* stream) {
  if (bad_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto H, auto P) {
#ifdef QT_FLASH_WIDE
    return launch_fwd_ws<decltype(P)::value>(q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh,
                                             nkv, hd, causal, scale, stream);
#else
    return launch_fwd_bf16<decltype(H)::value, decltype(P)::value>(
        q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
#endif
  });
}

extern "C" int QT_FLASH_ENTRY(qt_flash_fwd_f32)(const void* q, const void* k, const void* v,
                                const void* q_start, const void* kv_len, void* out, void* lse,
                                int B, int Sq, int Tk, int nh, int nkv, int hd, int causal,
                                float scale, void* stream) {
  if (bad_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto H, auto P) {
    return launch_fwd_f32<decltype(H)::value, decltype(P)::value>(
        q, k, v, q_start, kv_len, out, lse, B, Sq, Tk, nh, nkv, hd, causal, scale, stream);
  });
}

// A route's launch, for a report: out[11] = grid x, y, z, warpgroups a
// block (64 query rows each), blocks resident per SM, registers a thread,
// dynamic shared bytes, local (spill) bytes a thread, SMs, stages (bf16:
// the cp.async ring of K / V tiles, at 256 columns the TMA rings; f32: the
// split K / V buffers), threads a block (at 256 columns in bf16 the
// producer warpgroup's too), of the kernel that head dim hd runs (its compiled
// width, padded or not)
extern "C" int QT_FLASH_ENTRY(qt_flash_fwd_design)(int hd, int B, int Sq, int nh, int* out) {
  return design(false, hd, B, Sq, nh, out);
}

extern "C" int QT_FLASH_ENTRY(qt_flash_fwd_f32_design)(int hd, int B, int Sq, int nh, int* out) {
  return design(true, hd, B, Sq, nh, out);
}
