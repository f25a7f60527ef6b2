// Blockwise 8-bit Adam for Hopper (sm_90a): one launch steps a whole table
// of parameter leaves and updates the parameters in place.
//
// Replaces the Pallas TPU kernel quanta_tpu/ops/adam8bit.py:adam8bit_update
// (_adam_tile). Per quantization block of 256 elements it dequantizes the
// moments (m: int8 codes times the block scale; v: uint8 codes, 4th-root
// companded, (c/255)^4 times the block maximum), takes the Adam step
//
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g g
//   u  = -(lr / bc1) m' / (sqrt(v' / bc2) + eps)
//
// and requantizes m' and v' with fresh block scales (max|m'|/127 and
// max v', each at least 1e-12). Where the leaf names its parameter p, it
// then applies the decoupled weight decay and the update to p in place:
//
//   u  = u - (float)(lr * wd) * float(p)          (where lr * wd != 0)
//   p  = round_to_p(float(p) + float(round_to_p(u)))
//
// which is what `upd - lr * wd * p.float()` and `p.add_(upd.to(p.dtype))`
// compute in torch (the Python double lr * wd rounded once to f32, bf16
// rounding to nearest even). Where it names an update output, u is written
// there (the one-leaf op, ops/adam8bit.py:adam8bit_update). f32 moments
// and updates live only in registers.
//
// Exactness: every operation is the plain version's
// (quanta_tpu_torch/ops/adam8bit.py:adam8bit_update_reference, then the
// decay and the add), in its order and with its one rounding each:
// __fmul_rn/__fadd_rn keep nvcc from contracting a product and a sum into
// an FMA, __fdiv_rn/__fsqrt_rn are IEEE, rintf rounds half to even as
// torch.round does. The f32 constants come from the host (b1, b2, 1 - b1,
// 1 - b2, eps, lr * wd: each a double rounded once to f32) or are written
// as doubles rounded once, as Python scalars reach torch. Kernel and plain
// version agree bit for bit.
//
// What bounds it on the H100: memory, and for the small leaves of LoRA
// the launch. A QLoRA step of TinyLlama-1.1B has 88 adapter leaves of 8
// to 64 blocks (4,400 blocks, 1.1 M elements); per element one step reads
// the bf16 gradient (2 B), reads and writes p (4 B) and both codes (4 B):
// ~11 MB, ~3.4 us at 3.35 TB/s. The first port launched one 256-thread
// block per quantization block, one launch per leaf, and left the f32
// update in device memory for three more torch ops per leaf (cast, add_,
// the decay). Design: one launch per optimizer step. The leaves travel as
// a table passed BY VALUE as a __grid_constant__ kernel parameter (CUDA
// 12.1 and later take up to 32,764 bytes of parameters), so there is no
// device-side table, no upload, and the gradients may move every step
// (they are fresh tensors after zero_grad(set_to_none=True)). The C entry
// point cuts the caller's table into launches of TABLE_LEAVES leaves.
// One warp per quantization block, 8 elements a lane, WARPS warps a CTA;
// a warp finds its leaf by a binary search over the table's first blocks
// (warp-uniform reads of the constant bank). Both block maxima are 5-step
// warp shuffles: no shared memory, no __syncthreads. A warp reads its
// whole block (codes, scales, g, p) before it writes, so the state may be
// updated in place (input and output pointers equal). 16- and 8-byte
// vector accesses where the leaf's pointers are aligned; the ragged tail
// (n not a multiple of 256 or of 8) is masked: elements past n count as
// g = 0, as the plain version's zero pad does, and their codes are
// written, but p and the update are not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;        // quantization block
constexpr int PER_LANE = BLOCK / 32;
constexpr int WARPS = 8;          // quantization blocks (warps) a CTA
constexpr int TABLE_LEAVES = 128;  // leaves one launch takes

// One leaf, as the host fills it (ops/adam8bit.py:AdamLeaf).
struct Leaf {
  const void* g;          // n gradient values, bf16 or f32
  void* p;                // n parameter values, bf16 or f32, or null
  float* upd;             // n update values out, or null
  const int8_t* mc;       // (nb, 256) m codes in
  const float* ms;        // (nb,) m scales in
  const uint8_t* vc;      // (nb, 256) v codes in
  const float* vs;        // (nb,) v scales in
  int8_t* mco;            // the same four out (may equal the inputs)
  float* mso;
  uint8_t* vco;
  float* vso;
  long long n;
  int g_bf16, p_bf16;
};
static_assert(sizeof(Leaf) == 104, "Leaf must match ops/adam8bit.py:AdamLeaf");

// One launch's parameters: its leaves and where each begins in its grid.
struct Table {
  Leaf leaf[TABLE_LEAVES];
  long long first[TABLE_LEAVES + 1];  // first block of each leaf; first[count] = blocks
  const float* scalars;               // lr, bc1, bc2 (f32, device)
  float b1, b2, c1, c2, eps, lr_wd;
  int count;
};
static_assert(sizeof(Table) < 32764, "kernel parameters are limited to 32,764 bytes");

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// 8 values from element e0 on of a bf16 or f32 array of n; 0 past n
__device__ __forceinline__ void load8(const void* ptr, bool bf16, long long e0, long long n,
                                      float (&x)[PER_LANE]) {
  const bool aligned = (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  if (aligned && e0 + PER_LANE <= n) {
    if (bf16) {
      const uint4 w = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(ptr) + e0);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = bf16_bits_to_float(u[i] & 0xffffu);
        x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    } else {
      const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(ptr) + e0);
      const float4 a = f[0], b = f[1];
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const long long j = e0 + i;
    x[i] = j >= n ? 0.f
                  : bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(ptr)[j])
                         : static_cast<const float*>(ptr)[j];
  }
}

// 8 values to element e0 on of a bf16 (rounded to nearest even) or f32
// array of n; nothing past n
__device__ __forceinline__ void store8(void* ptr, bool bf16, long long e0, long long n,
                                       const float (&x)[PER_LANE]) {
  const bool aligned = (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  if (aligned && e0 + PER_LANE <= n) {
    if (bf16) {
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(ptr) + e0) =
          make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      float4* f = reinterpret_cast<float4*>(static_cast<float*>(ptr) + e0);
      f[0] = make_float4(x[0], x[1], x[2], x[3]);
      f[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const long long j = e0 + i;
    if (j >= n) break;
    if (bf16)
      static_cast<__nv_bfloat16*>(ptr)[j] = __float2bfloat16_rn(x[i]);
    else
      static_cast<float*>(ptr)[j] = x[i];
  }
}

// 8 one-byte codes from offset o on (the state holds whole blocks)
template <typename C>
__device__ __forceinline__ void load_codes(const C* ptr, long long o, float (&x)[PER_LANE]) {
  if ((reinterpret_cast<uintptr_t>(ptr) & 7) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(ptr + o);
    const C* c = reinterpret_cast<const C*>(&w);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) x[i] = static_cast<float>(c[i]);
  } else {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) x[i] = static_cast<float>(ptr[o + i]);
  }
}

template <typename C>
__device__ __forceinline__ void store_codes(C* ptr, long long o, const C (&c)[PER_LANE]) {
  if ((reinterpret_cast<uintptr_t>(ptr) & 7) == 0) {
    uint2 w = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w.x |= (uint32_t)(uint8_t)c[i] << (8 * i);
      w.y |= (uint32_t)(uint8_t)c[4 + i] << (8 * i);
    }
    *reinterpret_cast<uint2*>(ptr + o) = w;
  } else {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) ptr[o + i] = c[i];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
adam8bit_step_kernel(const __grid_constant__ Table t) {
  const long long blk = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (blk >= t.first[t.count]) return;  // warp-uniform: the whole warp leaves
  int lo = 0, hi = t.count - 1;         // the last leaf whose first block <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first[mid] <= blk) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long b = blk - t.first[lo];
  const int lane = threadIdx.x & 31;
  const long long o = b * BLOCK + lane * PER_LANE;  // this lane's first element
  const float inv255 = static_cast<float>(1.0 / 255.0);
  const float floor_scale = static_cast<float>(1e-12);

  // read everything this warp's block needs before anything is written
  float g[PER_LANE], m[PER_LANE], v[PER_LANE];
  load8(L.g, L.g_bf16, o, L.n, g);
  load_codes(L.mc, o, m);
  load_codes(L.vc, o, v);
  const float ms = L.ms[b], vs = L.vs[b];
  const float lr = t.scalars[0], bc1 = t.scalars[1], bc2 = t.scalars[2];

  float u[PER_LANE];
  float amax_m = 0.f, max_v = 0.f;
  const float step = -__fdiv_rn(lr, bc1);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const float m0 = __fmul_rn(m[i], ms);
    const float vq = __fmul_rn(v[i], inv255);
    const float v0 = __fmul_rn(__fmul_rn(__fmul_rn(vq, vq), __fmul_rn(vq, vq)), vs);
    m[i] = __fadd_rn(__fmul_rn(t.b1, m0), __fmul_rn(t.c1, g[i]));
    v[i] = __fadd_rn(__fmul_rn(t.b2, v0), __fmul_rn(__fmul_rn(t.c2, g[i]), g[i]));
    u[i] = __fdiv_rn(__fmul_rn(step, m[i]),
                     __fadd_rn(__fsqrt_rn(__fdiv_rn(v[i], bc2)), t.eps));
    amax_m = fmaxf(amax_m, fabsf(m[i]));
    max_v = fmaxf(max_v, v[i]);
  }
  amax_m = warp_max(amax_m);
  max_v = warp_max(max_v);

  if (L.p != nullptr) {
    float p[PER_LANE];
    load8(L.p, L.p_bf16, o, L.n, p);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (t.lr_wd != 0.f) u[i] = __fsub_rn(u[i], __fmul_rn(t.lr_wd, p[i]));
      const float du = L.p_bf16 ? __bfloat162float(__float2bfloat16_rn(u[i])) : u[i];
      p[i] = __fadd_rn(p[i], du);
    }
    store8(L.p, L.p_bf16, o, L.n, p);
  }
  if (L.upd != nullptr) store8(L.upd, false, o, L.n, u);

  const float s_m = fmaxf(__fdiv_rn(amax_m, 127.0f), floor_scale);
  const float s_v = fmaxf(max_v, floor_scale);
  int8_t mc[PER_LANE];
  uint8_t vc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    mc[i] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(m[i], s_m)), -127.0f), 127.0f));
    const float comp = __fsqrt_rn(__fsqrt_rn(fminf(fmaxf(__fdiv_rn(v[i], s_v), 0.0f), 1.0f)));
    vc[i] = static_cast<uint8_t>(fminf(fmaxf(rintf(__fmul_rn(comp, 255.0f)), 0.0f), 255.0f));
  }
  store_codes(L.mco, o, mc);
  store_codes(L.vco, o, vc);
  if (lane == 0) {
    L.mso[b] = s_m;
    L.vso[b] = s_v;
  }
}

}  // namespace

// Leaves one launch takes: a table of more is cut into launches of this many.
extern "C" int qt_adam8bit_table_leaves() { return TABLE_LEAVES; }

// One Adam step over n_leaves leaves (a host array of Leaf), in launches of
// TABLE_LEAVES leaves on `stream`. scalars: lr, bc1, bc2 as f32 on the device.
extern "C" int qt_adam8bit_step(const void* leaves, int n_leaves, const void* scalars, float b1,
                                float b2, float c1, float c2, float eps, float lr_wd,
                                void* stream) {
  if (leaves == nullptr || scalars == nullptr || n_leaves <= 0) return (int)cudaErrorInvalidValue;
  const Leaf* in = static_cast<const Leaf*>(leaves);
  Table t;
  t.scalars = static_cast<const float*>(scalars);
  t.b1 = b1, t.b2 = b2, t.c1 = c1, t.c2 = c2, t.eps = eps, t.lr_wd = lr_wd;
  for (int s = 0; s < n_leaves; s += TABLE_LEAVES) {
    t.count = n_leaves - s < TABLE_LEAVES ? n_leaves - s : TABLE_LEAVES;
    long long blocks = 0;
    for (int i = 0; i < t.count; ++i) {
      const Leaf& L = in[s + i];
      if (L.n <= 0 || L.g == nullptr || L.mc == nullptr || L.ms == nullptr ||
          L.vc == nullptr || L.vs == nullptr || L.mco == nullptr || L.mso == nullptr ||
          L.vco == nullptr || L.vso == nullptr)
        return (int)cudaErrorInvalidValue;
      t.leaf[i] = L;
      t.first[i] = blocks;
      blocks += (L.n + BLOCK - 1) / BLOCK;
    }
    t.first[t.count] = blocks;
    const long long grid = (blocks + WARPS - 1) / WARPS;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    adam8bit_step_kernel<<<(unsigned)grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
