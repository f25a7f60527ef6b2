"""Blockwise quantize / dequantize in plain torch — the port's reference core.

A line-for-line port of ``quanta_tpu/core/codecs.py``: the same padding,
the same scale convention and the same rounding, so codes, scales and zero
points are bit-equal to the JAX package's (``tests/test_torch_core.py``).

Rounding rules that make that hold:
  - ``torch.round`` rounds half to even, as ``jnp.round`` does;
  - ``torch.searchsorted`` with its default ``right=False`` sends a value
    equal to a midpoint to the lower code, as ``jnp.searchsorted``'s
    default ``side="left"`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from quanta_tpu_torch.core import codebooks, packing
from quanta_tpu_torch.core.qtensor import QuantizedTensor

_EPS = 1e-12


def _blockify(x: torch.Tensor, block_size: int):
    """Flatten + pad to (n_blocks, block) blocks. block_size=0 -> 1 block."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    bs = n if block_size == 0 else block_size
    n_blocks = -(-n // bs)
    pad = n_blocks * bs - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n_blocks, bs), n


def _safe_scale(s: torch.Tensor) -> torch.Tensor:
    """Replace zero scales (constant-zero blocks) with 1.0."""
    return torch.where(s <= _EPS, torch.ones_like(s), s)


# ---------------------------------------------------------------- quantize


def quantize(
    x: torch.Tensor,
    *,
    bits: int = 8,
    scheme: str = "symmetric",
    codebook: Optional[str] = None,
    block_size: int = 0,
    pack: bool = False,
) -> QuantizedTensor:
    """Quantize ``x`` blockwise ("symmetric", "affine" or "codebook")."""
    if scheme == "codebook":
        if codebook is None:
            codebook = {4: "nf4", 8: "nf8"}[bits]
        if codebooks.bits_of(codebook) != bits:
            raise ValueError(f"codebook {codebook} is not {bits}-bit")

    blocks, _n = _blockify(x, block_size)

    if scheme == "symmetric":
        qmax = 2 ** (bits - 1) - 1
        scale = _safe_scale(blocks.abs().amax(dim=1) / qmax)
        q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax, qmax)
        codes = q.to(torch.int8)
        if bits == 4:
            codes = (codes + 8).to(torch.uint8)  # store offset for packing
        zp = None
    elif scheme == "affine":
        qmax = 2**bits - 1
        mn = torch.clamp(blocks.amin(dim=1), max=0.0)
        mx = torch.clamp(blocks.amax(dim=1), min=0.0)
        scale = _safe_scale((mx - mn) / qmax)
        zp = torch.clamp(torch.round(-mn / scale), 0, qmax)
        q = torch.clamp(torch.round(blocks / scale[:, None]) + zp[:, None], 0, qmax)
        codes = q.to(torch.uint8)
    elif scheme == "codebook":
        scale = _safe_scale(blocks.abs().amax(dim=1))
        normalized = blocks / scale[:, None]
        mids = codebooks.get_midpoints(codebook, device=x.device)
        codes = torch.searchsorted(mids, normalized).to(torch.uint8)
        zp = None
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    packed = "none"
    if pack:
        if bits != 4:
            raise ValueError("packing is only for 4-bit codes")
        codes = packing.pack_nibbles(codes)
        packed = "nibbles"

    return QuantizedTensor(
        codes=codes,
        scale=scale.to(torch.float32),
        zero_point=None if zp is None else zp.to(torch.float32),
        bits=bits,
        scheme=scheme,
        codebook=codebook,
        shape=tuple(x.shape),
        dtype=x.dtype,
        block_size=block_size,
        packed=packed,
    )


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """Reconstruct the (approximate) original tensor."""
    if qt.packed == "split_k":  # matmul layout: blocks run along K per column
        return dequantize_matmul_weight(qt)
    n = math.prod(qt.shape) if qt.shape else 1
    bs = n if qt.block_size == 0 else qt.block_size

    codes = qt.codes
    if qt.packed == "nibbles":
        codes = packing.unpack_nibbles(codes, qt.scale.shape[0] * bs)
    blocks = codes.reshape(-1, bs)

    if qt.scheme == "symmetric":
        vals = blocks.to(torch.int32)
        if qt.bits == 4:
            vals = vals - 8
        out = vals.to(torch.float32) * qt.scale[:, None]
    elif qt.scheme == "affine":
        out = (blocks.to(torch.float32) - qt.zero_point[:, None]) * qt.scale[:, None]
    elif qt.scheme == "codebook":
        lv = codebooks.get_codebook(qt.codebook, device=codes.device)
        out = lv[blocks.long()] * qt.scale[:, None]
    else:
        raise ValueError(qt.scheme)

    return out.reshape(-1)[:n].reshape(qt.shape).to(qt.dtype)


# --------------------------------------------- matmul-layout weight quant


def quantize_matmul_weight(
    w: torch.Tensor,
    *,
    fmt: str = "nf4",
    block_size: int = 64,
) -> QuantizedTensor:
    """Quantize a 2-D weight ``(K, N)`` in the fused-matmul layout.

    Blocks run along K per column: ``scale`` is ``(K_pad/block, N_pad)``.
    K is zero-padded to a multiple of ``16*block_size`` and N to a multiple
    of 128, exactly as the JAX package pads, so the stored arrays are the
    same bytes; ``shape`` records the logical (K, N). 4-bit formats are
    packed ``split_k``; 8-bit formats keep ``(K_pad, N_pad)`` codes.

    fmt: "nf4" | "nf4a" | "fp4" | "int4" | "int8" | "nf8" | "fp8" |
    "int8a" | "int4a"
    """
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got shape {tuple(w.shape)}")
    k, n_cols = w.shape
    logical_shape = (k, n_cols)
    k_pad = -(-k // (16 * block_size)) * (16 * block_size)
    n_pad = -(-n_cols // 128) * 128
    if (k_pad, n_pad) != (k, n_cols):
        w = F.pad(w, (0, n_pad - n_cols, 0, k_pad - k))
        k = k_pad

    blocks = w.to(torch.float32).reshape(k // block_size, block_size, -1)
    zp = None

    if fmt == "int8":
        scale = _safe_scale(blocks.abs().amax(dim=1) / 127.0)
        q = torch.round(blocks / scale[:, None, :])
        codes = torch.clamp(q, -127, 127).to(torch.int8).reshape(k, -1)
        bits, scheme, cb, packed = 8, "symmetric", None, "none"
    elif fmt in ("nf8", "fp8", "nf4", "nf4a", "fp4", "int4"):
        scale = _safe_scale(blocks.abs().amax(dim=1))
        mids = codebooks.get_midpoints(fmt, device=w.device)
        idx = torch.searchsorted(mids, (blocks / scale[:, None, :]).contiguous())
        codes = idx.to(torch.uint8).reshape(k, -1)
        bits, scheme, cb, packed = codebooks.bits_of(fmt), "codebook", fmt, "none"
        if bits == 4:
            codes, packed = packing.pack_split_k(codes), "split_k"
    elif fmt in ("int8a", "int4a"):
        # affine blockwise: w = codes * scale + zp, zp = block min. The
        # matmul adds the zp term as blocksum(x) @ zp (ops/matmul.py).
        qmax = 255 if fmt == "int8a" else 15
        lo = blocks.amin(dim=1)
        hi = blocks.amax(dim=1)
        scale = _safe_scale((hi - lo) / qmax)
        zp = lo
        q = torch.clamp(torch.round((blocks - zp[:, None, :]) / scale[:, None, :]),
                        0, qmax)
        codes = q.to(torch.uint8).reshape(k, -1)
        bits, scheme, cb, packed = 8, "affine", None, "none"
        if fmt == "int4a":
            codes, bits, packed = packing.pack_split_k(codes), 4, "split_k"
    else:
        raise ValueError(f"unknown matmul weight format {fmt!r}")

    return QuantizedTensor(
        codes=codes,
        scale=scale.to(torch.float32),
        zero_point=None if zp is None else zp.to(torch.float32),
        bits=bits,
        scheme=scheme,
        codebook=cb,
        shape=logical_shape,
        dtype=w.dtype,
        block_size=block_size,
        packed=packed,
    )


def dequantize_matmul_weight(qt: QuantizedTensor) -> torch.Tensor:
    """Dequantize a matmul-layout weight back to the logical (K, N)."""
    k, n = qt.shape
    codes = packing.unpack_split_k(qt.codes) if qt.packed == "split_k" else qt.codes
    scale = torch.repeat_interleave(qt.scale, qt.block_size, dim=0)
    if qt.scheme == "affine":  # int8a / int4a: w = codes*scale + zp
        zp = torch.repeat_interleave(qt.zero_point, qt.block_size, dim=0)
        vals = codes.to(torch.float32) * scale + zp
    elif qt.scheme == "symmetric":  # int8
        vals = codes.to(torch.float32) * scale
    else:
        lv = codebooks.get_codebook(qt.codebook, device=codes.device)
        vals = lv[codes.long()] * scale
    return vals[:k, :n].to(qt.dtype)
