"""Fused 4-bit dequant-matmul: CUDA kernel wrapper and its plain version.

Port of the forward half of ``quanta_tpu/ops/matmul.py``: ``matmul_4bit``
and the ``matmul_quantized`` dispatch (``_mmq``). The kernel is
``csrc/matmul_4bit.cu`` (it replaces the Pallas ``_mm4_kernel``); the
source says what bounds it on the H100 and how it is laid out.

Layout (``core.codecs.quantize_matmul_weight``): codes ``(K_pad/2, N_pad)``
uint8 split_k-packed, scales ``(K_pad/block, N_pad)`` f32; the kernel and
the plain version compute ``x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi)``
with ``deq = x.dtype(level[code] * scale)`` and f32 accumulation.

Dispatch: ``use_kernel=None`` means the kernel for a CUDA tensor and the
plain version for a CPU one; ``use_kernel=True`` on a CPU tensor raises;
``use_kernel=False`` runs the plain version anywhere. A CUDA tensor never
falls back to the plain version on its own. No backward yet (the
transposed kernels are ROADMAP Queue 2 item 7).
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
    lv = torch.from_numpy(_levels_np(codebook)).to(x.device)
    idx = torch.cat([codes_packed & 0x0F, codes_packed >> 4], dim=0).long()
    s = torch.repeat_interleave(scales, block, dim=0)
    w = (lv[idx] * s).to(x.dtype)
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
    ``out_dtype`` (default x.dtype). The CUDA kernel takes bf16 or f32 x.
    """
    if not _build.use_kernel_for(use_kernel, x):
        return matmul_4bit_reference(x, codes_packed, scales, codebook=codebook,
                                     block=block, out_dtype=out_dtype)
    k2, n = codes_packed.shape
    entry = _ENTRY.get(x.dtype)
    if entry is None:
        raise TypeError(f"the matmul_4bit CUDA kernel takes bf16 or f32 x, got {x.dtype}")
    if codes_packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("codes must be uint8 and scales float32")
    if scales.shape != (2 * k2 // block, n) or (2 * k2) % block:
        raise ValueError(f"scales {tuple(scales.shape)} do not match codes "
                         f"{tuple(codes_packed.shape)} at block {block}")
    dev = x.device
    if codes_packed.device != dev or scales.device != dev:
        raise ValueError("x, codes and scales must be on one device")
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
    (ROADMAP Queue 2 item 3).
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if qt.packed == "split_k":
        out = matmul_4bit(x2, qt.codes, qt.scale, codebook=qt.codebook,
                          block=qt.block_size, out_dtype=out_dtype,
                          use_kernel=use_kernel)
    elif qt.bits == 8:
        if _build.use_kernel_for(use_kernel, x2):
            raise NotImplementedError(
                "8-bit matmul layouts have no CUDA kernel yet (matmul_8bit, "
                "ROADMAP Queue 2 item 3); pass use_kernel=False for the plain path")
        # logical (K, N) weight, zero point included for int8a
        w = codecs.dequantize_matmul_weight(qt).to(x2.dtype)
        out = (x2.float() @ w.float()).to(out_dtype or x2.dtype)
        return out.reshape(*lead, out.shape[-1])
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
    out = out[:, : qt.shape[1]]
    return out.reshape(*lead, out.shape[-1])
