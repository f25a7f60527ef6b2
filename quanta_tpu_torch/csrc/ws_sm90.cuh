// Hopper (sm_90a) pieces of the warp-specialised kernels (the 256-column
// bf16 flash forward and dK/dV: flash_fwd.cu, flash_bwd.cu under
// QT_FLASH_WIDE): mbarriers, TMA tile loads from tensor maps made on the
// host, named barriers and setmaxnreg.
//
// A block of WS_THREADS is two consumer warpgroups (threads 0-255) and a
// producer warpgroup (one of its threads issues every TMA copy). One block
// an SM gives every thread 168 registers (the register file is split over
// the SM's four quarters, three warps on each); setmaxnreg then takes the
// producer down and the consumers up, each kernel keeping the block at 168
// x 384 (e.g. 40 x 128 + 232 x 256), so the consumers' increase never waits
// on registers the block does not hold. ptxas
// compiles the consumers' code for their count only where nothing in it
// can trap (a __trap there kept them at 168: spills, and every product
// serialized, C7512; PERF.md), so only the producer's waits carry the hang
// guard. A ring slot has a full mbarrier (the producer's arrival with the
// bytes to come; TMA completes them) and an empty one (one arrival from
// each consumer warp once its products have read the slot).
//
// Tensor maps. A (B, S, heads, hd) bf16 tensor is mapped as 4-D (hd,
// heads, S, B) in boxes of 64 columns x 64 rows of one head, swizzled by
// 128 bytes: one box fills one 64-column block of a Tile<HD> (sm90.cuh)
// exactly as its wgmma descriptors read it. Rows past S and columns past
// hd land as zeros. TMA needs every stride a multiple of 16 bytes, so hd a
// multiple of 8 (the wrapper pads other head dims, ops/attention.py).
// cuTensorMapEncodeTiled is looked up in libcuda at run time
// (cudaGetDriverEntryPoint): the library links nothing new.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WS_CONSUMERS = 2;                      // consumer warpgroups
constexpr int WS_THREADS = 128 * (WS_CONSUMERS + 1);  // and the producer warpgroup
constexpr int WS_STAGES = 2;                          // ring slots
// a producer's mbarrier wait that lasts ~10 s at the H100's clocks traps:
// a launch failure in place of a hung card
constexpr long long kHangCycles = 20000000000LL;

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival, and `bytes` more for the TMA copies to complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// one arrival where `pred` holds (no branch: a predicated instruction)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}
// one arrival once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of parity `parity` has completed (a fresh barrier: the
// phase of parity 1 counts as completed); the consumers' form
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// the producer's form: a trap after kHangCycles
__device__ __forceinline__ void mbar_wait_guarded(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// a word of shared memory, loaded and stored as the compiler must (volatile)
__device__ __forceinline__ int ld_shared_u32(uint32_t addr) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, int v) {
  asm volatile("st.volatile.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// ------------------------------------------------------------ TMA

// the box at (c0, c1, c2, c3) of `map` into shared memory at `dst`,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// rows [r0, r0 + 64) of head `head`, batch row `b`, into a Tile<HD> at dst:
// one box a 64-column block
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int r0, int b) {
#pragma unroll
  for (int cb = 0; cb < HD / 64; ++cb)
    tma_load_4d(dst + cb * 64 * 128, map, bar, cb * 64, head, r0, b);
}

// ------------------------------------------------------------ warpgroups

// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: wait, or
// arrive without waiting (predicated: no branch)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive_if(int id, int n, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n@p bar.arrive %0, %1;\n}\n" ::"r"(id),
               "r"(n), "r"((uint32_t)pred)
               : "memory");
}

// This thread's warpgroup (WS_CONSUMERS: the producer), broadcast from
// lane 0 so that the compiler sees a warp-uniform role
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, S, heads, hd) bf16 tensor for tma_tile; false where the
// driver refuses it (hd not a multiple of 8, a base off 16 bytes)
bool tile_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || hd % 8 != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
