"""Fused 4-bit and 8-bit dequant-matmuls and their backward: CUDA kernel
wrappers and their plain versions.

Port of ``quanta_tpu/ops/matmul.py``: ``matmul_4bit``, ``matmul_4bit_t``,
``matmul_8bit``, ``matmul_8bit_t`` and the ``matmul_quantized`` dispatch
(``_mmq`` and its custom VJP). The kernels are ``csrc/matmul_4bit.cu``
(the Pallas ``_mm4_kernel``), ``csrc/matmul_4bit_t.cu`` (``_mm4t_kernel``),
``csrc/matmul_8bit.cu`` (``_mm8_kernel``) and ``csrc/matmul_8bit_t.cu``
(``_mm8t_kernel``); each source says what bounds it on the H100 and how it
is laid out. The bf16 ``matmul_4bit`` and ``matmul_8bit`` kernels each have
two Hopper designs, picked by M inside the one entry point (split-K
``mma.sync`` for decode, wgmma tiles above); :func:`matmul_4bit_design` and
:func:`matmul_8bit_design` report which one a shape takes. The bf16
``matmul_4bit_t`` and ``matmul_8bit_t`` kernels are wgmma dx tiles over a
dequantized tile read K-major (:func:`matmul_4bit_t_design`).

Layouts (``core.codecs.quantize_matmul_weight``): scales ``(K_pad/block,
N_pad)`` f32; 4-bit codes ``(K_pad/2, N_pad)`` uint8 split_k-packed, 8-bit
codes ``(K_pad, N_pad)``, int8 for int8 and uint8 for nf8, fp8 and int8a.
The forward computes ``x @ deq(W)`` (for 4-bit ``x[:, :K/2] @ deq(lo) +
x[:, K/2:] @ deq(hi)``), the backward ``dx = g @ deq(W)^T`` with W still
quantized, both with ``deq = T(level[code] * scale)`` (T the activation or
gradient dtype) and f32 accumulation. A level table per layout: 16 entries
for 4-bit, 256 for 8-bit (``_levels8_np`` says which for each format).

Dispatch: ``use_kernel=None`` means the kernel for a CUDA tensor and the
plain version for a CPU one; ``use_kernel=True`` on a CPU tensor raises;
``use_kernel=False`` runs the plain version anywhere. A CUDA tensor never
falls back to the plain version on its own. ``matmul_quantized`` is
differentiable in x (``_MatmulQuantized``, a ``torch.autograd.Function``):
the codes are frozen, so only dx flows, through ``matmul_4bit_t`` or
``matmul_8bit_t``. The raw forward kernel routes raise under autograd
rather than return a tensor that carries no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from quanta_tpu_torch.core import codebooks
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.ops import _build


# activation dtype -> C entry point of csrc/matmul_4bit.cu
_ENTRY = {torch.bfloat16: "qt_matmul_4bit_bf16", torch.float32: "qt_matmul_4bit_f32"}
# gradient dtype -> C entry point of csrc/matmul_4bit_t.cu
_ENTRY_T = {torch.bfloat16: "qt_matmul_4bit_t_bf16", torch.float32: "qt_matmul_4bit_t_f32"}
# operand dtype -> C entry point of csrc/matmul_8bit.cu and of csrc/matmul_8bit_t.cu
_ENTRY8 = {torch.bfloat16: "qt_matmul_8bit_bf16", torch.float32: "qt_matmul_8bit_f32"}
_ENTRY8_T = {torch.bfloat16: "qt_matmul_8bit_t_bf16", torch.float32: "qt_matmul_8bit_t_f32"}
_NO_BACKWARD = ("differentiate through matmul_quantized, whose backward runs "
                "matmul_4bit_t or matmul_8bit_t (QLoRA bases are QuantizedTensors)")


def _levels_np(codebook: str | None) -> np.ndarray:
    """The 16-entry f32 table for a 4-bit layout. codebook=None is the
    unsigned affine int4a layout, whose codes are their own values."""
    if codebook is None:
        return np.arange(16, dtype=np.float32)
    lv = codebooks.get_levels(codebook)
    if lv.shape != (16,):
        raise ValueError(f"codebook {codebook!r} is not 4-bit")
    return lv


@functools.lru_cache(maxsize=None)
def _levels_on(codebook: str | None, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_levels_np(codebook)).to(device)


def _levels8_np(codebook: str | None, codes_dtype: torch.dtype) -> np.ndarray:
    """The 256-entry f32 table for an 8-bit layout, indexed by the code's
    byte. codebook=None is int8 (signed codes: byte 0xC8 is -56) or int8a
    (unsigned codes: byte 0xC8 is 200), told apart by the codes' dtype,
    as the JAX kernel tells them apart by widening int8 or uint8 to int32.
    nf8 and fp8 are their registered tables; fp8 codes index the sorted
    e4m3 table (with its duplicate +-0 and +-448), not e4m3 bit patterns."""
    if codebook is None:
        if codes_dtype == torch.int8:
            return np.arange(256).astype(np.uint8).view(np.int8).astype(np.float32)
        if codes_dtype == torch.uint8:
            return np.arange(256, dtype=np.float32)
        raise TypeError(f"8-bit codes must be int8 or uint8, got {codes_dtype}")
    lv = codebooks.get_levels(codebook)
    if lv.shape != (256,):
        raise ValueError(f"codebook {codebook!r} is not 8-bit")
    return lv


@functools.lru_cache(maxsize=None)
def _levels8_on(codebook: str | None, codes_dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_levels8_np(codebook, codes_dtype)).to(device)


def _pad_k(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    k = x.shape[1]
    if k < k_pad:
        return F.pad(x, (0, k_pad - k))
    if k != k_pad:
        raise ValueError(f"x K={k} > packed K={k_pad}")
    return x


def _pad_n(g: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad a gradient's N to the codes' N_pad (the forward sliced it off)."""
    n = g.shape[1]
    if n < n_pad:
        return F.pad(g, (0, n_pad - n))
    if n != n_pad:
        raise ValueError(f"g N={n} > codes N={n_pad}")
    return g


def _dequant_4bit(codes_packed, scales, codebook, block, dtype) -> torch.Tensor:
    """The (K_pad, N_pad) weight the kernels multiply: rows [0, K_pad/2)
    from the low nibbles, the rest from the high ones, rounded to dtype."""
    lv = _levels_on(codebook, codes_packed.device)
    idx = torch.cat([codes_packed & 0x0F, codes_packed >> 4], dim=0).long()
    s = torch.repeat_interleave(scales, block, dim=0)
    return (lv[idx] * s).to(dtype)


def _check_4bit_operands(a, codes_packed, scales, block, entries, name):
    entry = entries.get(a.dtype)
    if entry is None:
        raise TypeError(f"the {name} CUDA kernel takes bf16 or f32, got {a.dtype}")
    k2, n = codes_packed.shape
    if codes_packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("codes must be uint8 and scales float32")
    if scales.shape != (2 * k2 // block, n) or (2 * k2) % block:
        raise ValueError(f"scales {tuple(scales.shape)} do not match codes "
                         f"{tuple(codes_packed.shape)} at block {block}")
    if codes_packed.device != a.device or scales.device != a.device:
        raise ValueError(f"{name}: operands, codes and scales must be on one device")
    return entry


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels load 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def matmul_4bit_reference(
    x: torch.Tensor,
    codes_packed: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = "nf4a",
    block: int = 64,
    out_dtype=None,
) -> torch.Tensor:
    """Plain-torch version of the kernel: dequantize to x.dtype, multiply
    with f32 accumulation (f32 operands; TF32 must be off for it to be
    exact on CUDA). Returns (M, N_pad)."""
    x = _pad_k(x, 2 * codes_packed.shape[0])
    w = _dequant_4bit(codes_packed, scales, codebook, block, x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def matmul_4bit(
    x: torch.Tensor,
    codes_packed: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = "nf4a",
    block: int = 64,
    out_dtype=None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``x (M, K) @ W (K_pad, N_pad)`` with W split_k-packed 4-bit codes.

    x may have logical K <= K_pad; it is zero-padded. Returns (M, N_pad) in
    ``out_dtype`` (default x.dtype). The CUDA kernel takes bf16 or f32 x;
    its route raises under autograd (see ``matmul_quantized``).
    """
    if not _build.use_kernel_for(use_kernel, x):
        return matmul_4bit_reference(x, codes_packed, scales, codebook=codebook,
                                     block=block, out_dtype=out_dtype)
    _build.refuse_grad(x, "matmul_4bit", _NO_BACKWARD)
    entry = _check_4bit_operands(x, codes_packed, scales, block, _ENTRY, "matmul_4bit")
    k2, n = codes_packed.shape
    dev = x.device
    x = _aligned(_pad_k(x, 2 * k2))
    codes_packed, scales = _aligned(codes_packed), _aligned(scales)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m:
        levels = _levels_on(codebook, dev)
        rc = getattr(_build.library(), entry)(
            x.data_ptr(), codes_packed.data_ptr(), scales.data_ptr(), levels.data_ptr(),
            out.data_ptr(), m, n, k2, block, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "matmul_4bit")
        _build.launches["matmul_4bit"] += 1
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


def matmul_4bit_design(m, n, k):
    """How the bf16 ``matmul_4bit`` kernel launches for x (m, k) and
    split_k-packed codes (k / 2, n), k = K_pad, on this card: the keys of
    :func:`matmul_8bit_design` (``design`` "decode" or "prefill", grid, K
    split, blocks per SM, registers, shared and spill bytes, stages, rows
    of x a block)."""
    if k % 2:
        raise ValueError(f"k={k}: split_k packing needs an even K_pad")
    return _design("qt_matmul_4bit_design", "matmul_4bit", m, n, k // 2)


def matmul_4bit_t_design(m, n, k):
    """How the bf16 ``matmul_4bit_t`` kernel launches for g (m, n) and
    split_k-packed codes (k / 2, n), k = K_pad, on this card: the keys of
    :func:`matmul_8bit_design`, with ``design`` "wgmma" (its one design:
    tiles of ``rows`` rows of g, 256 where that grid fills at least half
    the SMs, else 128, by 128 dx columns; no K split)."""
    if k % 2:
        raise ValueError(f"k={k}: split_k packing needs an even K_pad")
    return _design("qt_matmul_4bit_t_design", "matmul_4bit_t", m, n, k // 2, names=("wgmma",))


def matmul_4bit_t_reference(
    g: torch.Tensor,
    codes_packed: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = "nf4a",
    block: int = 64,
    out_dtype=None,
) -> torch.Tensor:
    """Plain-torch version of the transposed kernel: dequantize to g.dtype,
    ``g @ W^T`` with f32 accumulation (TF32 must be off for it to be exact
    on CUDA). Returns (M, K_pad): column j < K_pad/2 from the low nibbles of
    packed row j, column j + K_pad/2 from the high ones."""
    g = _pad_n(g, codes_packed.shape[1])
    w = _dequant_4bit(codes_packed, scales, codebook, block, g.dtype)
    return (g.float() @ w.float().T).to(out_dtype or g.dtype)


def matmul_4bit_t(
    g: torch.Tensor,
    codes_packed: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = "nf4a",
    block: int = 64,
    out_dtype=None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``g (M, N) @ W^T`` for split_k-packed W: the backward of ``matmul_4bit``.

    g may have logical N <= N_pad; it is zero-padded. Returns (M, K_pad) in
    ``out_dtype`` (default g.dtype). The CUDA kernel takes bf16 or f32 g.
    """
    if not _build.use_kernel_for(use_kernel, g):
        return matmul_4bit_t_reference(g, codes_packed, scales, codebook=codebook,
                                       block=block, out_dtype=out_dtype)
    _build.refuse_grad(g, "matmul_4bit_t", "double backward through 4-bit weights is "
                                           "not supported")
    entry = _check_4bit_operands(g, codes_packed, scales, block, _ENTRY_T, "matmul_4bit_t")
    k2, n = codes_packed.shape
    dev = g.device
    g = _aligned(_pad_n(g, n))
    codes_packed, scales = _aligned(codes_packed), _aligned(scales)
    m = g.shape[0]
    out = torch.empty((m, 2 * k2), dtype=g.dtype, device=dev)
    if m:
        levels = _levels_on(codebook, dev)
        rc = getattr(_build.library(), entry)(
            g.data_ptr(), codes_packed.data_ptr(), scales.data_ptr(), levels.data_ptr(),
            out.data_ptr(), m, n, k2, block, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "matmul_4bit_t")
        _build.launches["matmul_4bit_t"] += 1
    return out if out_dtype in (None, g.dtype) else out.to(out_dtype)


def _dequant_8bit(codes, scales, codebook, block, dtype) -> torch.Tensor:
    """The (K_pad, N_pad) weight the 8-bit kernels multiply, rounded to dtype:
    the level table read by each code's byte, times its block's scale."""
    lv = _levels8_on(codebook, codes.dtype, codes.device)
    s = torch.repeat_interleave(scales, block, dim=0)
    return (lv[codes.view(torch.uint8).long()] * s).to(dtype)


def _check_8bit_operands(a, codes, scales, block, entries, name):
    entry = entries.get(a.dtype)
    if entry is None:
        raise TypeError(f"the {name} CUDA kernel takes bf16 or f32, got {a.dtype}")
    k, n = codes.shape
    if codes.dtype not in (torch.int8, torch.uint8) or scales.dtype != torch.float32:
        raise TypeError("codes must be int8 or uint8 and scales float32")
    if scales.shape != (k // block, n) or k % block:
        raise ValueError(f"scales {tuple(scales.shape)} do not match codes "
                         f"{tuple(codes.shape)} at block {block}")
    if codes.device != a.device or scales.device != a.device:
        raise ValueError(f"{name}: operands, codes and scales must be on one device")
    return entry


def matmul_8bit_reference(
    x: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = None,
    block: int = 64,
    out_dtype=None,
) -> torch.Tensor:
    """Plain-torch version of the 8-bit kernel: dequantize to x.dtype,
    multiply with f32 accumulation (TF32 must be off for it to be exact on
    CUDA). Returns (M, N_pad)."""
    x = _pad_k(x, codes.shape[0])
    w = _dequant_8bit(codes, scales, codebook, block, x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def matmul_8bit(
    x: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = None,
    block: int = 64,
    out_dtype=None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``x (M, K) @ W (K_pad, N_pad)`` with W 8-bit codes and block scales.

    codes are int8 (int8, codebook=None), or uint8 (nf8 / fp8 codebooks,
    and int8a with codebook=None, whose zero-point term the caller adds).
    x may have logical K <= K_pad; it is zero-padded. Returns (M, N_pad) in
    ``out_dtype`` (default x.dtype). The CUDA kernel takes bf16 or f32 x;
    its route raises under autograd (see ``matmul_quantized``).
    """
    if not _build.use_kernel_for(use_kernel, x):
        return matmul_8bit_reference(x, codes, scales, codebook=codebook, block=block,
                                     out_dtype=out_dtype)
    _build.refuse_grad(x, "matmul_8bit", _NO_BACKWARD)
    entry = _check_8bit_operands(x, codes, scales, block, _ENTRY8, "matmul_8bit")
    k, n = codes.shape
    dev = x.device
    x = _aligned(_pad_k(x, k))
    codes, scales = _aligned(codes), _aligned(scales)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m:
        levels = _levels8_on(codebook, codes.dtype, dev)
        rc = getattr(_build.library(), entry)(
            x.data_ptr(), codes.data_ptr(), scales.data_ptr(), levels.data_ptr(),
            out.data_ptr(), m, n, k, block, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "matmul_8bit")
        _build.launches["matmul_8bit"] += 1
    return out if out_dtype in (None, x.dtype) else out.to(out_dtype)


_MM_DESIGN_KEYS = ("design", "grid_x", "grid_y", "grid_z", "split", "blocks_per_sm",
                   "registers", "shared_bytes", "spill_bytes", "stages", "rows")


def _design(entry, name, m, n, k, *extra, names=("decode", "prefill")):
    """The report of design entry point ``entry(m, n, k, *extra, out)``."""
    out = (ctypes.c_int * len(_MM_DESIGN_KEYS))()
    _build.check(getattr(_build.library(), entry)(m, n, k, *extra, out), name)
    res = dict(zip(_MM_DESIGN_KEYS, out))
    res["design"] = names[res["design"]]
    return res


def matmul_8bit_design(m, n, k):
    """How the bf16 ``matmul_8bit`` kernel launches for x (m, k) and codes
    (k, n) on this card: ``design`` "decode" (split K, mma.sync, memory
    bound) or "prefill" (wgmma tiles of 128 or 256 rows), its grid, the K
    split (the cluster size), blocks resident per SM, registers a thread,
    dynamic shared bytes and spill bytes a thread
    (``cudaFuncGetAttributes``), the stages of its cp.async ring and the
    rows of x a block takes."""
    return _design("qt_matmul_8bit_design", "matmul_8bit", m, n, k)


def matmul_8bit_t_reference(
    g: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = None,
    block: int = 64,
    out_dtype=None,
) -> torch.Tensor:
    """Plain-torch version of the transposed 8-bit kernel: dequantize to
    g.dtype, ``g @ W^T`` with f32 accumulation (TF32 must be off for it to
    be exact on CUDA). Returns (M, K_pad)."""
    g = _pad_n(g, codes.shape[1])
    w = _dequant_8bit(codes, scales, codebook, block, g.dtype)
    return (g.float() @ w.float().T).to(out_dtype or g.dtype)


def matmul_8bit_t(
    g: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    codebook: str | None = None,
    block: int = 64,
    out_dtype=None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``g (M, N) @ W^T`` for 8-bit W: the backward of ``matmul_8bit``.

    g may have logical N <= N_pad; it is zero-padded. Returns (M, K_pad) in
    ``out_dtype`` (default g.dtype). The CUDA kernel takes bf16 or f32 g.
    """
    if not _build.use_kernel_for(use_kernel, g):
        return matmul_8bit_t_reference(g, codes, scales, codebook=codebook, block=block,
                                       out_dtype=out_dtype)
    _build.refuse_grad(g, "matmul_8bit_t", "double backward through 8-bit weights is "
                                           "not supported")
    entry = _check_8bit_operands(g, codes, scales, block, _ENTRY8_T, "matmul_8bit_t")
    k, n = codes.shape
    dev = g.device
    g = _aligned(_pad_n(g, n))
    codes, scales = _aligned(codes), _aligned(scales)
    m = g.shape[0]
    out = torch.empty((m, k), dtype=g.dtype, device=dev)
    if m:
        levels = _levels8_on(codebook, codes.dtype, dev)
        rc = getattr(_build.library(), entry)(
            g.data_ptr(), codes.data_ptr(), scales.data_ptr(), levels.data_ptr(),
            out.data_ptr(), m, n, k, block, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "matmul_8bit_t")
        _build.launches["matmul_8bit_t"] += 1
    return out if out_dtype in (None, g.dtype) else out.to(out_dtype)


def _mmq_forward(x2, qt, use_kernel, out_dtype):
    """(M, K) @ dequant(qt) -> (M, N): the forward of ``_mmq``."""
    if qt.packed == "split_k":
        out = matmul_4bit(x2, qt.codes, qt.scale, codebook=qt.codebook,
                          block=qt.block_size, out_dtype=out_dtype, use_kernel=use_kernel)
    elif qt.bits == 8:
        out = matmul_8bit(x2, qt.codes, qt.scale, codebook=qt.codebook, block=qt.block_size,
                          out_dtype=out_dtype, use_kernel=use_kernel)
    else:
        raise ValueError(f"unsupported matmul layout: {qt.packed}/{qt.bits}bit")
    if qt.scheme == "affine":
        # zero-point term: x @ expand(zp) == blocksum(x) @ zp. Padded x
        # columns are zero, so padded blocks contribute nothing.
        b = qt.block_size
        k_pad = qt.zero_point.shape[0] * b
        xp = _pad_k(x2.float(), k_pad)
        xb = xp.reshape(xp.shape[0], k_pad // b, b).sum(dim=2)
        out = out + (xb @ qt.zero_point).to(out.dtype)
    return out[:, : qt.shape[1]]


def _mmq_backward(g2, qt, k, x_dtype, use_kernel):
    """dx (M, K) of ``_mmq`` for its output gradient g2 (M, N)."""
    if qt.packed == "split_k":
        dx = matmul_4bit_t(g2, qt.codes, qt.scale, codebook=qt.codebook, block=qt.block_size,
                           use_kernel=use_kernel)
    elif qt.bits == 8:
        dx = matmul_8bit_t(g2, qt.codes, qt.scale, codebook=qt.codebook, block=qt.block_size,
                           use_kernel=use_kernel)
    else:
        raise ValueError(f"unsupported matmul layout: {qt.packed}/{qt.bits}bit")
    if qt.scheme == "affine":
        # zp term of W^T: dx_zp[m, k] = (g @ zp^T)[m, block(k)]
        gz = _pad_n(g2, qt.zero_point.shape[1]).float() @ qt.zero_point.T  # (M, K_pad/B)
        dx = dx + torch.repeat_interleave(gz, qt.block_size, dim=1).to(dx.dtype)
    return dx[:, :k].to(x_dtype)  # drop K padding


class _MatmulQuantized(torch.autograd.Function):
    """``x @ dequant(qt)`` with dx through the transposed kernel. Saves the
    codes (the QuantizedTensor), never a dense weight; the codes are frozen,
    so they get no gradient (QLoRA semantics, ``quanta_tpu/ops/matmul.py:
    626-666``)."""

    @staticmethod
    def forward(ctx, x2, qt, use_kernel, out_dtype):
        ctx.qt, ctx.use_kernel = qt, use_kernel
        ctx.k, ctx.x_dtype = x2.shape[1], x2.dtype
        return _mmq_forward(x2, qt, use_kernel, out_dtype)

    @staticmethod
    def backward(ctx, g):
        return _mmq_backward(g, ctx.qt, ctx.k, ctx.x_dtype, ctx.use_kernel), None, None, None


def matmul_quantized(
    x: torch.Tensor,
    qt: QuantizedTensor,
    *,
    use_kernel: bool | None = None,
    out_dtype=None,
) -> torch.Tensor:
    """``x @ dequant(qt)`` for a matmul-layout QuantizedTensor.

    Accepts x of any leading batch shape; contracts over the last axis and
    drops the N padding. 4-bit layouts run ``matmul_4bit``, 8-bit layouts
    (int8, nf8, fp8, int8a) ``matmul_8bit``; the affine zero-point term
    ``blocksum(x) @ zp`` of int4a and int8a is added in plain torch,
    outside the kernel, as the JAX package adds it. Differentiable in x:
    under autograd, when x requires a gradient, the call goes through
    ``_MatmulQuantized``, whose backward runs ``matmul_4bit_t`` or
    ``matmul_8bit_t`` (the affine term's transpose outside it); otherwise
    it runs the forward directly.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and x2.requires_grad:
        out = _MatmulQuantized.apply(x2, qt, use_kernel, out_dtype)
    else:
        out = _mmq_forward(x2, qt, use_kernel, out_dtype)
    return out.reshape(*lead, out.shape[-1])
