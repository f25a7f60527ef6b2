"""int4c: 4-bit weights on the int8 tensor cores (per-column scales).

Port of ``quanta_tpu/ops/int4c.py``. Weights are symmetric int4 with one
f32 scale per output column (absmax/7), split_k-packed two per byte and
biased by +8; activations are row-quantized to int8 (absmax/127) in plain
torch, as the JAX package does it in XLA outside its kernel. The GEMM is
``csrc/int4c.cu`` (it replaces the Pallas ``_mm_i4c_kernel``): int8 x int8
-> int32, then ``acc * row_scale * col_scale``, with two Hopper designs
picked by M inside the one entry point (split-K int8 ``mma.sync`` for
decode, int8 wgmma tiles above; :func:`matmul_int4c_design` says which).

The plain version computes the integer product as an f32 matmul of the
integer values: ``int8 @ int8`` in torch returns int8 on the CPU (and
overflows), and int32 ``matmul`` does not exist on CUDA. The f32 product is
exact while |acc| < 2**24, which holds for K_pad * 127 * 8 < 2**24, i.e.
K_pad < 16513, and only with TF32 off on CUDA; both are checked. The
kernel's int32 sum is exact too, so kernel and plain version agree bit for
bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops.matmul import _aligned, _design

_EPS = 1e-12
_EXACT_F32 = 2**24


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class Int4cWeight:
    """int4c weight state. Layout (K, N) like x @ W; codes hold rows
    (k, k + K_pad/2) split_k-packed per byte."""

    codes: torch.Tensor  # uint8 (K_pad/2, N_pad), nibbles biased +8
    scale: torch.Tensor  # f32 (N_pad,) per-output-column scales
    shape: tuple = ()

    def __post_init__(self):
        self.shape = tuple(self.shape)


def quantize_int4c_weight(w: torch.Tensor) -> Int4cWeight:
    """Quantize a dense (K, N) weight to int4c (pads K to 512, N to 128)."""
    k, n = w.shape
    wf = w.to(torch.float32)
    scale = wf.abs().amax(dim=0) / 7.0 + _EPS
    q = torch.clamp(torch.round(wf / scale[None, :]), -7, 7)

    k_pad, n_pad = _round_up(k, 512), _round_up(n, 128)
    q = F.pad(q, (0, n_pad - n, 0, k_pad - k))
    scale = F.pad(scale, (0, n_pad - n), value=1.0)
    half = k_pad // 2
    lo = (q[:half] + 8).to(torch.uint8)
    hi = (q[half:] + 8).to(torch.uint8)
    return Int4cWeight(codes=lo | (hi << 4), scale=scale.to(torch.float32), shape=(k, n))


def _unpack_values(codes: torch.Tensor) -> torch.Tensor:
    """(K_pad/2, N_pad) biased nibbles -> (K_pad, N_pad) int values in f32."""
    c = codes.to(torch.int32)
    return torch.cat([(c & 0x0F) - 8, (c >> 4) - 8], dim=0).to(torch.float32)


def dequantize_int4c(qw: Int4cWeight) -> torch.Tensor:
    """Dense f32 (K, N) reconstruction."""
    k, n = qw.shape
    return (_unpack_values(qw.codes) * qw.scale[None, :])[:k, :n]


def matmul_int4c_reference(xq, codes, row_scale, col_scale) -> torch.Tensor:
    """Plain version of the kernel: exact integer product (as f32), then
    ``acc * row_scale * col_scale`` in that order. Returns (M, N_pad) f32."""
    k_pad = codes.shape[0] * 2
    if k_pad * 127 * 8 >= _EXACT_F32:
        raise ValueError(f"K_pad={k_pad}: the f32 integer product is no longer exact")
    if xq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain int4c product needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False to be exact")
    acc = xq.to(torch.float32) @ _unpack_values(codes)
    return acc * row_scale[:, None] * col_scale[None, :]


_NO_BACKWARD = ("int4c weights have no backward in the JAX package either; "
                "QLoRA bases are QuantizedTensors (nf4, nf4a, ...)")


def matmul_int4c_kernel(
    xq: torch.Tensor,
    codes: torch.Tensor,
    row_scale: torch.Tensor,
    col_scale: torch.Tensor,
    *,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``xq (M, K_pad) int8 @ unpack(codes (K_pad/2, N_pad))`` scaled by
    row_scale (M,) x col_scale (N_pad,) -> (M, N_pad) f32."""
    m, k_dim = xq.shape
    k2, n = codes.shape
    if k_dim != 2 * k2:
        raise ValueError(f"xq K={k_dim} != packed K={2 * k2}")
    if not _build.use_kernel_for(use_kernel, xq):
        return matmul_int4c_reference(xq, codes, row_scale, col_scale)
    if (xq.dtype, codes.dtype, row_scale.dtype, col_scale.dtype) != (
            torch.int8, torch.uint8, torch.float32, torch.float32):
        raise TypeError("int4c kernel takes int8 xq, uint8 codes, f32 scales")
    if row_scale.shape != (m,) or col_scale.shape != (n,):
        raise ValueError("row_scale must be (M,) and col_scale (N_pad,)")
    dev = xq.device
    if any(t.device != dev for t in (codes, row_scale, col_scale)):
        raise ValueError("all int4c operands must be on one device")
    xq, codes = _aligned(xq), _aligned(codes)
    row_scale, col_scale = row_scale.contiguous(), col_scale.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m:
        lib = _build.library()
        rc = lib.qt_matmul_int4c(
            xq.data_ptr(), codes.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(),
            out.data_ptr(), m, n, k2, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "matmul_int4c")
        _build.launches["matmul_int4c"] += 1
    return out


def matmul_int4c_design(m, n, k):
    """How the ``matmul_int4c`` kernel launches for xq (m, k) and packed
    codes (k / 2, n), k = K_pad, on this card: the keys of
    ``matmul.matmul_8bit_design``, ``design`` "decode" (split-K int8
    ``mma.sync``, memory bound) or "prefill" (int8 wgmma tiles of 128 rows),
    its grid, K split, blocks per SM, registers, shared and spill bytes,
    stages and rows of xq a block."""
    if k % 2:
        raise ValueError(f"k={k}: split_k packing needs an even K_pad")
    return _design("qt_matmul_int4c_design", "matmul_int4c", m, n, k // 2)


def matmul_int4c(
    x: torch.Tensor,
    qw: Int4cWeight,
    *,
    out_dtype=None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``x (.., K) @ W (K, N)``: row-quantize activations to int8, then the
    int4c GEMM with scales on the accumulator."""
    if _build.use_kernel_for(use_kernel, x):
        _build.refuse_grad(x, "matmul_int4c", _NO_BACKWARD)
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = qw.shape
    k_pad = qw.codes.shape[0] * 2
    x2 = x.reshape(-1, k).to(torch.float32)

    row_scale = torch.clamp(x2.abs().amax(dim=1) / 127.0, min=_EPS)
    xq = torch.clamp(torch.round(x2 / row_scale[:, None]), -127, 127).to(torch.int8)
    if k_pad != k:
        xq = F.pad(xq, (0, k_pad - k))

    y = matmul_int4c_kernel(xq, qw.codes, row_scale, qw.scale, use_kernel=use_kernel)
    return y[:, :n].to(out_dtype).reshape(*lead, n)
