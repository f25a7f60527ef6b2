// The f32 pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd_f32.cu):
// each f32 product as three TF32 wgmma products on Hopper (sm_90a).
//
// The tensor cores multiply TF32 (10 fraction bits), so an f32 operand x is
// split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (sm90.cuh's
// split_tf32), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi. tf32 wgmma reads
// K-major operands only, and B only from shared memory. So a streamed
// operand is a register A operand, read from its raw f32 tile (RawTile) in
// whatever order the product needs (frag_rows, frag_cols) and split in
// registers, and a B operand sits in shared memory as split hi and lo
// KTiles. An A fragment holds columns q and q + 4 of a k8 slice, so the B
// tiles keep a row's k8 slices in the order of the fragments: positions 0-3
// of a slice hold its elements 0, 2, 4, 6, positions 4-7 its elements 1, 3,
// 5, 7 (split_hd_tile), and each fragment row is one 8-byte load of a raw
// tile. mma_3xtf32 runs the chains of such products. The tensor cores add
// with truncation, so the kernels sum long reductions as fresh partials that
// the CUDA cores add, rounded to nearest.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int RAW_PAD = 8;  // floats after each raw f32 row: fragment loads meet each bank once

// The barrier of warpgroup `wg` alone (ids from 1; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// 64 rows of HD f32, row-major with RAW_PAD floats of padding, as cp.async
// lands them: the A operands, read into registers in any order.
template <int HD> struct RawTile {
  static constexpr int LD = HD + RAW_PAD;
  static constexpr uint32_t BYTES = 64 * LD * 4;
  // rows [r0, r0 + 64) of one head of a (B, S, heads, hd) f32 tensor, by
  // the 128 threads of a warpgroup (this one `tid`); `src` is row 0 of that
  // batch row and head, `row_stride` heads * hd; rows at or past `rows`,
  // and columns at or past `cols` (hd, a multiple of 4 up to HD), read as
  // zeros
  static __device__ __forceinline__ void load(uint32_t dst, const float* src, int64_t row_stride,
                                              int r0, int rows, int tid, int cols = HD) {
    constexpr int CH = HD / 4;  // 16-byte chunks a row
    for (int i = tid; i < 64 * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      const bool in = r0 + r < rows && (cols == HD || 4 * c < cols);
      const float* from = in ? src + (int64_t)(r0 + r) * row_stride + 4 * c : src;
      cp_async16(dst + (r * LD + 4 * c) * 4, from, in ? 16 : 0);
    }
  }
};

// A K-major tf32 B operand: ROWS rows (wgmma's N) by KC columns (the
// reduction, a multiple of 32), in blocks of 32 columns, each block ROWS
// rows of 128 bytes with the 128-byte swizzle (Tile<64>'s f32 layout,
// sm90.cuh), the blocks one after the other.
template <int ROWS, int KC> struct KTile {
  static constexpr uint32_t BLOCK = ROWS * 128;
  static constexpr uint32_t BYTES = BLOCK * (KC / 32);
  // byte offset of element (r, k)
  static __device__ __forceinline__ uint32_t offset(int r, int k) {
    return (k >> 5) * BLOCK + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4) + (k & 3) * 4;
  }
  // the k8 slice kk
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int kk) {
    return smem_desc(base + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024, kSwizzle128);
  }
};

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_shared1(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}

// The 8 f32 of row r, k8 slice kk (x0: elements 0-3, x1: 4-7), split into
// hi and lo KTile<ROWS, KC>s in the order of the A fragments: positions 0-3
// of the slice hold elements 0, 2, 4, 6, positions 4-7 elements 1, 3, 5, 7.
template <int ROWS, int KC>
__device__ __forceinline__ void split_store(uint32_t hi, uint32_t lo, int r, int kk, float4 x0,
                                            float4 x1) {
  using KT = KTile<ROWS, KC>;
  const float x[8] = {x0.x, x0.z, x1.x, x1.z, x0.y, x0.w, x1.y, x1.w};
  uint32_t h[8], l[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) split_tf32(x[p], h[p], l[p]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t off = KT::offset(r, 8 * kk + 4 * half);
    const int e = 4 * half;
    st_shared4(hi + off, h[e], h[e + 1], h[e + 2], h[e + 3]);
    st_shared4(lo + off, l[e], l[e + 1], l[e + 2], l[e + 3]);
  }
}

// Rows [r0, r0 + ROWS) of one head of a (B, S, heads, hd) f32 tensor into
// hi and lo KTile<ROWS, HD>s (zeros at or past `rows`, and at or past
// column `cols`, hd, a multiple of 4 up to HD), by `nt` threads (this one
// `tid`), in split_store's hd order.
template <int ROWS, int HD>
__device__ __forceinline__ void split_hd_tile(uint32_t hi, uint32_t lo,
                                              const float* __restrict__ src, int64_t row_stride,
                                              int r0, int rows, int tid, int nt, int cols = HD) {
  for (int i = tid; i < ROWS * (HD / 8); i += nt) {
    const int r = i / (HD / 8), kk = i % (HD / 8);
    float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
    if (r0 + r < rows) {
      const float* row = src + (int64_t)(r0 + r) * row_stride + 8 * kk;
      const float4* s = reinterpret_cast<const float4*>(row);
      if (cols == HD || 8 * kk < cols) x0 = __ldg(s);
      if (cols == HD || 8 * kk + 4 < cols) x1 = __ldg(s + 1);
    }
    split_store<ROWS, HD>(hi, lo, r, kk, x0, x1);
  }
}

// The A fragment (wgmma_rs_tf32) of rows r and r + 8 of a raw tile, k8
// slice kk of hd in split_hd_tile's order: a[0], a[2] (columns q, q + 4)
// are hd 8 kk + 2q and 8 kk + 2q + 1 of row r, a[1], a[3] those of r + 8.
template <int HD>
__device__ __forceinline__ void frag_rows(const float* raw, int r, int q, int kk, float (&a)[4]) {
  constexpr int LD = RawTile<HD>::LD;
  const float2 u = *reinterpret_cast<const float2*>(raw + r * LD + 8 * kk + 2 * q);
  const float2 w = *reinterpret_cast<const float2*>(raw + (r + 8) * LD + 8 * kk + 2 * q);
  a[0] = u.x;
  a[1] = w.x;
  a[2] = u.y;
  a[3] = w.y;
}

// The A fragment of a raw tile read transposed: rows m and m + 8 are hd
// columns, the k8 slice kk is raw rows 8 kk.. in order (a[0] = raw[8 kk +
// q][m], a[1] = raw[8 kk + q][m + 8], a[2], a[3] the same at row 8 kk + q +
// 4); zeros where m >= HD (hd 32 fills half of wgmma's 64 rows). Columns
// past a padded head dim read the zeros the load left there.
template <int HD>
__device__ __forceinline__ void frag_cols(const float* raw, int m, int q, int kk, float (&a)[4]) {
  constexpr int LD = RawTile<HD>::LD;
  if (m < HD) {
    const float* p = raw + (8 * kk + q) * LD + m;
    a[0] = p[0];
    a[1] = p[8];
    a[2] = p[4 * LD];
    a[3] = p[4 * LD + 8];
  } else {
    a[0] = a[1] = a[2] = a[3] = 0.0f;
  }
}

constexpr int A_BUFS = 2;  // split A fragments in flight: slices whose products may run at once

// One product of mma_3xtf32: d (m64 x N, f32) = A B, frag(kk, a) giving
// A's fragment of the k8 slice kk, b_hi(kk) and b_lo(kk) the descriptors of
// B's split tiles; with the slice's raw fragment loaded ahead and A_BUFS
// buffers of its split one.
template <int N, typename Frag, typename DescHi, typename DescLo> struct Chain {
  float (&d)[N / 2];
  Frag frag;
  DescHi b_hi;
  DescLo b_lo;
  float next[4];
  uint32_t ah[A_BUFS][4], al[A_BUFS][4];

  __device__ __forceinline__ void hold(int bb) {  // keep buffer bb as the products read it
    fence_regs(reinterpret_cast<int(&)[4]>(ah[bb]));
    fence_regs(reinterpret_cast<int(&)[4]>(al[bb]));
  }
  __device__ __forceinline__ void split(int bb) {
#pragma unroll
    for (int f = 0; f < 4; ++f) split_tf32(next[f], ah[bb][f], al[bb][f]);
    hold(bb);
  }
  // the j-th of the slice's three TF32 products, the small terms first
  __device__ __forceinline__ void issue(int kk, int j) {
    const int bb = kk % A_BUFS;
    if (j == 0) wgmma_rs_tf32<N>(d, al[bb], b_hi(kk), kk > 0);
    if (j == 1) wgmma_rs_tf32<N>(d, ah[bb], b_lo(kk), 1);
    if (j == 2) wgmma_rs_tf32<N>(d, ah[bb], b_hi(kk), 1);
  }
};
template <int N, typename Frag, typename DescHi, typename DescLo>
__device__ __forceinline__ Chain<N, Frag, DescHi, DescLo> chain(float (&d)[N / 2], Frag frag,
                                                               DescHi b_hi, DescLo b_lo) {
  return {d, frag, b_hi, b_lo};
}

// The products of independent chains over NK k8 slices, each f32 product
// as three TF32 ones (a_lo b_hi + a_hi b_lo + a_hi b_hi), A split here in
// registers. Per slice the chains' products interleave in one commit group,
// the next slice's fragments are loaded while they are issued, and the
// splits of the next slices overlap the products of the A_BUFS - 1 before.
// Returns with every product done.
template <int NK, typename... C>
__device__ __forceinline__ void mma_3xtf32(C&... c) {
  (fence_regs(c.d), ...);
  (c.frag(0, c.next), ...);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk >= A_BUFS) {
      wgmma_wait<A_BUFS - 1>();  // slice kk - A_BUFS's products, which read this buffer, are done
      (c.hold(kk % A_BUFS), ...);
    }
    (c.split(kk % A_BUFS), ...);
    if (kk + 1 < NK) (c.frag(kk + 1, c.next), ...);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 3; ++j) (c.issue(kk, j), ...);
    wgmma_commit();
  }
  wgmma_wait<0>();
  (fence_regs(c.d), ...);
#pragma unroll
  for (int bb = 0; bb < A_BUFS; ++bb) (c.hold(bb), ...);
}

}  // namespace
