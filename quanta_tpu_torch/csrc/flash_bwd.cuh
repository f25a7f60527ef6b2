// The launch of the flash-attention backward kernels, shared by their
// bf16 route (flash_bwd.cu) and their f32 route (flash_bwd_f32.cu), which
// are compiled apart, one nvcc each, side by side.
//
// A route is a type with two static templates, dq<HD, PAD>(B, Sq, nh) and
// dkv<HD, PAD>(B, Sq, Tk, nh, nkv), each giving the Plan of its kernel at
// compiled width HD (padded or not: flash_common.cuh) for a shape.

#pragma once

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

// The dK/dV launch: grid (C, nkv * B, key tiles of `bk` keys), clusters of
// C blocks, C the smallest power of two up to 8 that gives two blocks an SM
// and no more than the pairs a key tile can have (TinyLlama's s1024 shape:
// 128 key tiles, C = 4, in both routes).
struct DkvGrid {
  dim3 grid;
  int cluster;
};
DkvGrid dkv_grid(int B, int Sq, int Tk, int nh, int nkv, int bk) {
  const int key_tiles = (Tk + bk - 1) / bk;
  const int base = key_tiles * nkv * B;
  const int max_pairs = (nh / nkv) * ((Sq + TILE - 1) / TILE);
  int c = 1;
  while (c < 8 && c < max_pairs && (int64_t)base * c < 2LL * sm_count()) c *= 2;
  return {dim3(c, nkv * B, key_tiles), c};
}

// One kernel's launch at a shape: grid, cluster size, kernel, warpgroups
// a block, dynamic shared bytes, ring stages (f32: slots a warpgroup),
// threads a block (128 a warpgroup; a warp-specialised kernel's producer
// warpgroup counts here, not in warpgroups).
template <typename Kernel> struct Plan {
  dim3 grid;
  int cluster;
  Kernel kernel;
  int warpgroups;
  size_t smem;
  int stages;
  int threads;
};
template <typename Kernel>
Plan<Kernel> plan(dim3 grid, int cluster, Kernel kernel, int warpgroups, size_t smem, int stages,
                  int threads = 0) {
  return {grid, cluster, kernel, warpgroups, smem, stages, threads ? threads : 128 * warpgroups};
}

bool bad_bwd_sizes(int B, int Sq, int Tk, int nh, int nkv) {
  return B <= 0 || Sq <= 0 || Tk <= 0 || nkv <= 0 || nh % nkv != 0;
}

// dQ into d0 (DKV false), or dK into d0 and dV into d1, by the route's
// kernels on T (bf16 or float) operands at head dim hd
template <typename Route, typename T, bool DKV>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_start, const void* kv_len, void* d0, void* d1,
               int B, int Sq, int Tk, int nh, int nkv, int hd, int causal, float scale,
               void* stream) {
  if (bad_bwd_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* dop = static_cast<const T*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* qsp = static_cast<const int*>(q_start);
  const auto* klp = static_cast<const int*>(kv_len);
  auto* o0 = static_cast<float*>(d0);
  return with_hd(hd, [&](auto H, auto P) {
    constexpr int HD = decltype(H)::value;
    constexpr bool PAD = decltype(P)::value;
    if constexpr (DKV) {
      const auto p = Route::template dkv<HD, PAD>(B, Sq, Tk, nh, nkv);
      return launch_cluster(p.kernel, p.grid, p.cluster, p.threads, p.smem, stream, qp,
                            kp, vp, dop, lp, dp, qsp, klp, o0, static_cast<float*>(d1), Sq, Tk,
                            nh, nkv, hd, causal, scale);
    } else {
      const auto p = Route::template dq<HD, PAD>(B, Sq, nh);
      if (p.cluster > 1)  // the f32 route at 256 columns: a pair of blocks splits hd
        return launch_cluster(p.kernel, p.grid, p.cluster, p.threads, p.smem, stream, qp, kp,
                              vp, dop, lp, dp, qsp, klp, o0, Sq, Tk, nh, nkv, hd, causal, scale);
      return launch_n(p.kernel, p.grid, p.threads, p.smem, stream, qp, kp, vp, dop, lp,
                      dp, qsp, klp, o0, Sq, Tk, nh, nkv, hd, causal, scale);
    }
  });
}

template <typename P> int report(const P& p, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, p.kernel);
  const int vals[12] = {(int)p.grid.x, (int)p.grid.y, (int)p.grid.z, p.cluster,
                        blocks_per_sm(p.kernel, p.smem, p.threads), attr.numRegs,
                        (int)p.smem, (int)attr.localSizeBytes, sm_count(), p.stages,
                        p.warpgroups, p.threads};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return (int)rc;
}

// A route's launch, for a report: out[12] = grid x, y, z, cluster size,
// blocks resident per SM, registers a thread, dynamic shared bytes, local
// (spill) bytes a thread, SMs, cp.async stages (f32: ring slots a
// warpgroup), warpgroups a block, threads a block; dkv 0 (dQ) or 1
// (dK/dV); of the kernel
// that head dim hd runs (its compiled width; bf16: padded or not)
template <typename Route>
int design(bool dkv, int hd, int B, int Sq, int Tk, int nh, int nkv, int* out) {
  if (bad_bwd_sizes(B, Sq, Tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  return with_hd(hd, [&](auto H, auto P) {
    constexpr int HD = decltype(H)::value;
    constexpr bool PAD = decltype(P)::value;
    return dkv ? report(Route::template dkv<HD, PAD>(B, Sq, Tk, nh, nkv), out)
               : report(Route::template dq<HD, PAD>(B, Sq, nh), out);
  });
}

}  // namespace
