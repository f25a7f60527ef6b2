// Transposed fused 4-bit matmul for Hopper (sm_90a): the backward dx of
// x @ deq(W), bf16 or f32 gradients.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/matmul.py:matmul_4bit_t
// (_mm4t_kernel). It computes, with W still packed,
//
//   dx[:, j]      = g @ deq(lo[j, :])^T       (j < K2)
//   dx[:, K2 + j] = g @ deq(hi[j, :])^T
//
// for g (M, N) and split_k-packed codes (K2, N): one slab of packed rows
// gives both nibble halves' dx columns. deq is the forward's
// (dequant4_sm90.cuh): T(levels[code] * scale), rounded to the gradient
// type T before the product, as the TPU kernel rounds `w.astype(g.dtype)`;
// sums are f32. Rows of g, columns of N and packed rows past the edges are
// masked; any block that divides K_pad.
//
// What bounds it on the H100: in QLoRA training M is batch x sequence
// (2048 for TinyLlama batch 4 x seq 512, 1024 for Llama-2-7B batch 1 x seq
// 1024), so the product is bound by compute, 2*M*K*N flops against the bf16
// tensor-core rate (989 TFLOP/s); the codes (0.5 B a weight) are read once
// per tile of BM rows of g.
//
// bf16 design (matmul_8bit_t.cu's, over the 4-bit slab): a block takes BM
// rows of g by 128 dx columns, the 64 packed rows [j0, j0 + 64): tile rows
// 0-63 are their low nibbles (dx columns j0..j0+63), rows 64-127 their
// high ones (K2+j0..K2+j0+63). It streams N in steps of 64 through a
// cp.async ring of T_STAGES slots, each holding the step's g tile (BM / 64
// K-major Tile<64>s, rows = M), the raw 64 x 64 code slab (4 KB) and its
// four scale rows (the low and the high half's, for packed rows j0.. and
// j0 + 32..; block and K2 multiples of 32, else each weight reads its own
// scale from device memory). Each step the block dequantizes the slab into
// a bf16 128-row Tile<64> (dequant4_slab_t, double buffered; the 16-entry
// level table in 32 interleaved copies, 2 KB) while the previous step's
// products run; read K-major, that tile is the B of dx = g @ W^T. Two
// consumer warpgroups of BM / 2 rows issue wgmma m64n128k16 (wgmma_ss,
// both operands K-major). BM is 256, so every dequantized weight feeds 256
// rows of g, while that grid (K2 / 64 x M / 256 blocks, one an SM) fills at
// least half the SMs; else 128, twice the blocks. The epilogue writes two
// runs of 64 dx columns, K2 apart. No split of N: no atomics, the same bits
// on every call. The dense weight never reaches device memory.
//
// Tried on the H100 (kernel_sweep.py --what mm4t, nf4, the TinyLlama-1.1B
// and Llama-2-7B (K, N), M in {256, 1024, 2048}; PERF.md): a ring of 4
// stages takes 2-4% off every 256-row shape ((2048, 5632) at M = 2048:
// 214.2 against 220.2 us with 3) and leaves the 128-row ones as they were
// (they then hold one block an SM, not two); 256-row tiles everywhere lose
// 40% where their grid is under half the SMs ((2048, 5632) at M = 1024:
// 217.7 against 154.0 us), 128-row ones everywhere win at two shapes
// ((5632, 2048) at M = 1024: 137.4 against 169.2; (11008, 4096) at M =
// 2048: 861.2 against 911.7) and lose or tie at the rest, so the rule
// stays the grid fill.
//
// f32 (the accuracy proxy; no timed path takes it): the design of the first
// port, plain FMAs on a tile of 64 rows of g by 64 dx columns (32 lo, 32
// hi) per block of 4 warps, the codes tile dequantized into shared memory
// once per step of 64 columns of N (load_b, dequant4.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant4.cuh"       // BN, BKP, THREADS, kPad, load_b
#include "dequant4_sm90.cuh"  // LV4_BYTES, fill_levels4, stage_code_slab4_t, dequant4_slab_t
#include "splitk_sm90.cuh"    // MmKind, MmPlan, report_plan

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16: wgmma

constexpr int T_STAGES = 4;     // the ring reloads a slot two steps after its products
constexpr int T_THREADS = 256;  // two consumer warpgroups, BM / 2 rows of g each
constexpr int T_BJP = 64;       // packed rows a block: 128 dx columns
constexpr int T_BN = 64;        // columns of N (the reduction) a step

// level table; STAGES x (BM / 64) g tiles; 2 W tiles; STAGES x (code slab, 4 scale rows)
template <int BM> struct TSmem {
  static_assert(BM == 128 || BM == 256, "128 or 256 rows a tile");
  static constexpr uint32_t GT = Tile<64>::BYTES, WT = 2 * Tile<64>::BYTES;
  static constexpr uint32_t SROW = T_BJP * T_BN, SLAB = SROW + 4 * T_BN * 4;
  static constexpr uint32_t G0 = LV4_BYTES;                  // 1024-aligned from the base
  static constexpr uint32_t W0 = G0 + T_STAGES * (BM / 64) * GT;
  static constexpr uint32_t C0 = W0 + 2 * WT;
  static constexpr size_t bytes = C0 + T_STAGES * SLAB + 1024;
};

// grid (K2 / 64, M / BM). Step t stages g[m0:m0+BM, 64 t:64 t+64] as BM / 64
// K-major Tile<64>s (rows = M, columns = N) and the code slab of packed rows
// [j0, j0 + 64) over the same columns, which dequant4_slab_t turns into a
// 128-row Tile<64> (rows = dx columns, columns = N): the K-major B of
// dx = g W^T. Warpgroup wg multiplies its BM / 128 g tiles by it: 4 BM /
// 128 m64n128k16 products a step.
template <int BM>
__global__ void __launch_bounds__(T_THREADS)
mm4t_wgmma(const bf16* __restrict__ g, const uint8_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ levels,
           bf16* __restrict__ out, int M, int N, int K2, int block) {
  using SM = TSmem<BM>;
  constexpr int MT = BM / 128;  // 64-row g tiles a warpgroup
  extern __shared__ unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  unsigned char* gbase = smem + (base - smem_addr(smem));  // generic pointer to the base
  float* lv = reinterpret_cast<float*>(gbase);
  auto Gs = [&](int st, int i) { return base + SM::G0 + ((BM / 64) * st + i) * SM::GT; };
  auto Ws = [&](int i) { return base + SM::W0 + i * SM::WT; };
  auto slab = [&](int st) { return gbase + SM::C0 + st * SM::SLAB; };
  // every 32 packed rows of either half within one block: their scale rows staged
  const bool staged = block % 32 == 0 && K2 % 32 == 0;
  auto srow = [&](int st) { return reinterpret_cast<float*>(slab(st) + SM::SROW); };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int j0 = blockIdx.x * T_BJP, m0 = blockIdx.y * BM;
  const int steps = (N + T_BN - 1) / T_BN;
  fill_levels4<T_THREADS>(lv, levels, tid);

  auto load = [&](int t, int st) {  // step t into slot st
    const int n0 = t * T_BN;
    for (int i = tid; i < BM * 8; i += T_THREADS) {  // g rows [m0, m0 + BM), 8 chunks a row
      const int r = i / 8, c = i % 8;
      const uint32_t dst = Gs(st, r / 64) + Tile<64>::offset(r % 64, c);
      stage_bf16x8(gbase + (dst - base), dst, g, m0 + r, n0 + 8 * c, M, N);
    }
    stage_code_slab4_t(slab(st), smem_addr(slab(st)), codes, j0, n0, K2, N, tid, T_THREADS);
    // threads 16 q .. 16 q + 15 scale row q: half q / 2, packed rows j0 +
    // 32 (q % 2).. (none past K2: those rows reach only dx columns the
    // store drops)
    const int q = tid / 16, jr = j0 + 32 * (q % 2);
    if (staged && tid < 64 && jr < K2) {
      float* dst = srow(st) + 64 * q;
      stage_scale_row(dst, smem_addr(dst), scales, ((q / 2) * K2 + jr) / block, n0, N,
                      T_BN / 4, tid % 16);
    }
  };
#pragma unroll
  for (int st = 0; st < T_STAGES - 2; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }

  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<T_STAGES - 3>();  // step t has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; the products of t - 2 are done (and the level table is in)
    if (t + T_STAGES - 2 < steps) load(t + T_STAGES - 2, (t + T_STAGES - 2) % T_STAGES);
    cp_async_commit();
    // W tile t % 2 was last read by the products of t - 2
    dequant4_slab_t<T_THREADS>(Ws(t % 2), slab(t % T_STAGES),
                               staged ? srow(t % T_STAGES) : nullptr, scales, lv, j0, t * T_BN,
                               K2, N, block, tid);
    fence_proxy_async();
    __syncthreads();  // the W tile is whole
    const uint32_t wt = Ws(t % 2);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t gt = Gs(t % T_STAGES, wg * MT + mt);
#pragma unroll
      for (int kk = 0; kk < T_BN / 16; ++kk)
        wgmma_ss<128>(acc[mt], Tile<64>::k_major(gt, kk), Tile<64>::k_major(wt, kk), 1);
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

  // accumulator mt: dx row m0 + 64 (MT wg + mt) + 16 warp + lane / 4 + 8 i,
  // tile column 8 j + 2 (lane % 4) + c in acc[mt][4 j + 2 i + c]: dx column
  // j0 + that (j < 8, the low nibbles) or K2 + j0 + that - 64 (the high ones)
  const int r_lo = 64 * MT * wg + 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
  const int64_t ldo = 2 * (int64_t)K2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + r_lo + 64 * mt + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int jp = j0 + 8 * (j % 8) + c_lo;  // packed row of the pair's first column
        const int64_t col = (j < 8 ? 0 : K2) + jp;
        bf16* o = out + (int64_t)m * ldo + col;
        const float v0 = acc[mt][4 * j + 2 * i], v1 = acc[mt][4 * j + 2 * i + 1];
        if ((col & 1) == 0 && jp + 2 <= K2) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (jp < K2) o[0] = __float2bfloat16_rn(v0);
          if (jp + 1 < K2) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// The bf16 launch at (M, K2): 256-row tiles while their grid fills at least
// half the SMs (one block an SM), else 128-row ones, twice the blocks.
MmPlan plan_mm4t(int M, int K2) {
  const int tj = (K2 + T_BJP - 1) / T_BJP;
  const int bm = 2 * tj * ((M + 255) / 256) >= sm_count() ? 256 : 128;
  return {{0, bm, bm, 2 * T_BJP}, 1, dim3(tj, (M + bm - 1) / bm, 1)};
}

template <typename F> auto with_kernel(const MmPlan& p, F f) {
  return p.kind.rows == 256 ? f(mm4t_wgmma<256>, TSmem<256>::bytes)
                            : f(mm4t_wgmma<128>, TSmem<128>::bytes);
}

// ------------------------------------------------- f32: CUDA-core FMAs

constexpr int BM = 64;
constexpr int BJ = 2 * BKP;      // dx columns per tile: BKP lo + BKP hi

// G tile: g[m0:m0+BM, n0:n0+BN], row-major with stride BN + kPad<float>.
__device__ __forceinline__ void load_g(float* Gs, const float* __restrict__ g, int m0, int M,
                                       int N, int n0, int tid) {
  constexpr int G_LD = BN + kPad<float>;
  const bool g_vec = (N % 4) == 0;             // 16-byte loads stay aligned
  for (int idx = tid; idx < BM * (BN / 4); idx += THREADS) {
    const int r = idx / (BN / 4);
    const int c = (idx % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + c;
    float* dst = Gs + r * G_LD + c;
    if (m < M && g_vec && n + 4 <= N) {
      *reinterpret_cast<float4*>(dst) =
          __ldg(reinterpret_cast<const float4*>(g + (int64_t)m * N + n));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (m < M && n + e < N) ? g[(int64_t)m * N + n + e] : 0.0f;
    }
  }
}

// Tile column c (< BJ) -> dx column: lo half j0 + c, hi half K2 + j0 + c - BKP.
__device__ __forceinline__ int dx_col(int c, int j0, int K2) {
  return c < BKP ? j0 + c : K2 + j0 + (c - BKP);
}

// f32: no exact f32 tensor-core path, so plain FMAs. Thread (ty, tx) owns
// rows ty + 8 i (i < 8) and tile columns tx + 16 j (j < 4).
__global__ void __launch_bounds__(THREADS)
mm4t_f32_kernel(const float* __restrict__ g, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, const float* __restrict__ levels,
                float* __restrict__ out, int M, int N, int K2, int block) {
  constexpr int G_LD = BN + kPad<float>;
  constexpr int B_LD = BN + kPad<float>;
  __shared__ __align__(128) float Gs[BM * G_LD];
  __shared__ __align__(128) float Bs[BJ * B_LD];
  __shared__ float lv[16];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BKP;
  if (tid < 16) lv[tid] = levels[tid];
  float acc[8][4] = {};
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BN) {
    load_g(Gs, g, m0, M, N, n0, tid);
    load_b(Bs, codes, scales, lv, n0, N, K2, j0, block, tid);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BN; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Gs[(ty + 8 * i) * G_LD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * B_LD + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int64_t ldo = 2 * (int64_t)K2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 8 * i, c = tx + 16 * j;
      if (m < M && j0 + c % BKP < K2) out[m * ldo + dx_col(c, j0, K2)] = acc[i][j];
    }
}

}  // namespace

extern "C" int qt_matmul_4bit_t_bf16(const void* g, const void* codes, const void* scales,
                                     const void* levels, void* out, int M, int N, int K2,
                                     int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm4t(M, K2);
  return with_kernel(p, [&](auto kernel, size_t smem) {
    return launch_cluster(kernel, p.grid, 1, T_THREADS, smem, stream,
                          static_cast<const bf16*>(g), static_cast<const uint8_t*>(codes),
                          static_cast<const float*>(scales), static_cast<const float*>(levels),
                          static_cast<bf16*>(out), M, N, K2, block);
  });
}

extern "C" int qt_matmul_4bit_t_f32(const void* g, const void* codes, const void* scales,
                                    const void* levels, void* out, int M, int N, int K2,
                                    int block, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((K2 + BKP - 1) / BKP, (M + BM - 1) / BM);
  mm4t_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(levels),
      static_cast<float*>(out), M, N, K2, block);
  return (int)cudaGetLastError();
}

// The bf16 route's launch at (M, N, K2), for a report (report_plan says
// what out[11] holds; design 0, the one wgmma design, no K split)
extern "C" int qt_matmul_4bit_t_design(int M, int N, int K2, int* out) {
  if (M <= 0 || N <= 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  const MmPlan p = plan_mm4t(M, K2);
  return with_kernel(p, [&](auto kernel, size_t smem) {
    return report_plan(p, kernel, smem, blocks_per_sm(kernel, smem, T_THREADS), T_STAGES, out);
  });
}
