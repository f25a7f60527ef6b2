"""Fused 4-bit dequant-matmul and its backward: CUDA kernel wrappers and
their plain versions.

Port of ``quanta_tpu/ops/matmul.py``: ``matmul_4bit``, ``matmul_4bit_t``
and the ``matmul_quantized`` dispatch (``_mmq`` and its custom VJP). The
kernels are ``csrc/matmul_4bit.cu`` (the Pallas ``_mm4_kernel``) and
``csrc/matmul_4bit_t.cu`` (``_mm4t_kernel``); each source says what bounds
it on the H100 and how it is laid out.

Layout (``core.codecs.quantize_matmul_weight``): codes ``(K_pad/2, N_pad)``
uint8 split_k-packed, scales ``(K_pad/block, N_pad)`` f32. The forward
computes ``x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi)``, the backward
``dx = g @ deq(W)^T`` with W still packed, both with ``deq = T(level[code]
* scale)`` (T the activation or gradient dtype) and f32 accumulation.

Dispatch: ``use_kernel=None`` means the kernel for a CUDA tensor and the
plain version for a CPU one; ``use_kernel=True`` on a CPU tensor raises;
``use_kernel=False`` runs the plain version anywhere. A CUDA tensor never
falls back to the plain version on its own. ``matmul_quantized`` is
differentiable in x (``_MatmulQuantized``, a ``torch.autograd.Function``):
the codes are frozen, so only dx flows, through ``matmul_4bit_t``. The raw
``matmul_4bit`` kernel route raises under autograd rather than return a
tensor that carries no gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from quanta_tpu_torch.core import codebooks, codecs
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.ops import _build


# activation dtype -> C entry point of csrc/matmul_4bit.cu
_ENTRY = {torch.bfloat16: "qt_matmul_4bit_bf16", torch.float32: "qt_matmul_4bit_f32"}
# gradient dtype -> C entry point of csrc/matmul_4bit_t.cu
_ENTRY_T = {torch.bfloat16: "qt_matmul_4bit_t_bf16", torch.float32: "qt_matmul_4bit_t_f32"}
_NO_BACKWARD = ("differentiate through matmul_quantized, whose backward runs "
                "matmul_4bit_t (QLoRA bases are QuantizedTensors)")


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


def _mmq_forward(x2, qt, use_kernel, out_dtype):
    """(M, K) @ dequant(qt) -> (M, N): the forward of ``_mmq``."""
    if qt.packed == "split_k":
        out = matmul_4bit(x2, qt.codes, qt.scale, codebook=qt.codebook,
                          block=qt.block_size, out_dtype=out_dtype, use_kernel=use_kernel)
    elif qt.bits == 8:
        if _build.use_kernel_for(use_kernel, x2):
            raise NotImplementedError(
                "8-bit matmul layouts have no CUDA kernel yet (matmul_8bit, "
                "ROADMAP Queue 2 item 3); pass use_kernel=False for the plain path")
        # logical (K, N) weight, zero point included for int8a
        w = codecs.dequantize_matmul_weight(qt).to(x2.dtype)
        return (x2.float() @ w.float()).to(out_dtype or x2.dtype)
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
    if qt.packed != "split_k":
        if _build.use_kernel_for(use_kernel, g2):
            raise NotImplementedError(
                "8-bit matmul layouts have no CUDA kernels yet (matmul_8bit and "
                "matmul_8bit_t, ROADMAP Queue 2 items 3 and 7)")
        w = codecs.dequantize_matmul_weight(qt).to(g2.dtype)
        return (g2.float() @ w.float().T).to(x_dtype)
    dx = matmul_4bit_t(g2, qt.codes, qt.scale, codebook=qt.codebook, block=qt.block_size,
                       use_kernel=use_kernel)
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
    drops the N padding. 4-bit layouts run ``matmul_4bit``; the affine
    zero-point term ``blocksum(x) @ zp`` is added in plain torch, outside
    the kernel, as the JAX package adds it. 8-bit layouts have a plain
    version only: on CUDA they raise until ``matmul_8bit`` is ported
    (ROADMAP Queue 2 item 3). Differentiable in x: under autograd, when x
    requires a gradient, the call goes through ``_MatmulQuantized``, whose
    backward runs ``matmul_4bit_t`` (the affine term's transpose outside
    it); otherwise it runs the forward directly.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and x2.requires_grad:
        out = _MatmulQuantized.apply(x2, qt, use_kernel, out_dtype)
    else:
        out = _mmq_forward(x2, qt, use_kernel, out_dtype)
    return out.reshape(*lead, out.shape[-1])
