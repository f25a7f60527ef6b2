"""Blockwise quantize: CUDA kernel wrapper and its plain version.

Port of ``quanta_tpu/ops/quantize.py``. The kernel is ``csrc/quantize.cu``
(it replaces the Pallas ``_quant_kernel``); the source says what bounds it
on the H100 and how it is laid out.

``quantize_blockwise(x, fmt, block)`` flattens x, zero-pads it to whole
blocks and returns ``(codes (n_blocks, block), scale (n_blocks, 1) f32)``:

  - ``fmt="int8_sym"``: scale = 1 if absmax <= 1e-12 else absmax / 127,
    codes = clip(round(x / scale), -127, 127) as int8;
  - a codebook name (``"nf4"``, ``"nf4a"``, ``"fp4"``, ...): scale = 1 if
    absmax <= 1e-12 else absmax, codes = #(midpoints < x / scale) as
    uint8, with the registry's f32 midpoints (a value on a midpoint takes
    the lower level, as the JAX kernel's strict compare does).

Its production caller is the int8 KV cache (``serve/kvcache.py``, block =
head_dim), whose writes take :func:`write_kv_int8`: K and V quantized by
the same rule straight into rows of the pool, in one launch. Dispatch is
that of every wrapper (``_build.use_kernel_for``): the kernel for a CUDA
tensor, the plain version for a CPU one.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from quanta_tpu_torch.core import codebooks
from quanta_tpu_torch.ops import _build

_EPS = 1e-12
# input dtype -> C entry point of csrc/quantize.cu
_ENTRY = {torch.float32: "qt_quantize_blockwise_f32",
          torch.bfloat16: "qt_quantize_blockwise_bf16"}
_KV_ENTRY = {torch.float32: "qt_kv_write_int8_f32", torch.bfloat16: "qt_kv_write_int8_bf16"}
_KV_HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # hd = 8 lanes' values times a power of two


@functools.lru_cache(maxsize=None)
def _mids_on(fmt: str, device: torch.device) -> torch.Tensor:
    return codebooks.get_midpoints(fmt, device=device)


def _n_blocks(n: int, block: int) -> int:
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    return -(-n // block)


def quantize_blockwise_reference(x: torch.Tensor, *, fmt: str = "nf4", block: int = 64):
    """Plain-torch version of the kernel (same arithmetic, same order)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    nb = _n_blocks(n, block)
    if nb * block != n:
        flat = F.pad(flat, (0, nb * block - n))
    blocks = flat.reshape(nb, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    if fmt == "int8_sym":
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # product with its reciprocal, which would tie the plain version's
        # scales to the device it runs on
        scale = torch.where(absmax <= _EPS, 1.0, absmax / torch.full_like(absmax, 127.0))
        codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    else:
        scale = torch.where(absmax <= _EPS, 1.0, absmax)
        # the left insertion point is the count of midpoints strictly below
        idx = torch.searchsorted(_mids_on(fmt, x.device), (blocks / scale).contiguous())
        codes = idx.to(torch.uint8)
    return codes, scale


def quantize_blockwise(
    x: torch.Tensor,
    *,
    fmt: str = "nf4",
    block: int = 64,
    use_kernel: bool | None = None,
):
    """Quantize a flat view of x blockwise.

    Returns (codes, scale): codes (n_blocks, block), uint8 for a codebook
    or int8 for ``"int8_sym"``; scale (n_blocks, 1) f32. The CUDA kernel
    takes f32 or bf16 x.
    """
    if fmt != "int8_sym":
        codebooks.get_levels(fmt)  # raises on an unknown format
    if not _build.use_kernel_for(use_kernel, x):
        return quantize_blockwise_reference(x, fmt=fmt, block=block)
    entry = _ENTRY.get(x.dtype)
    if entry is None:
        raise TypeError(f"the quantize_blockwise CUDA kernel takes f32 or bf16 x, got {x.dtype}")
    x = x.contiguous()
    n = x.numel()
    nb = _n_blocks(n, block)
    if nb >= 2**31:
        raise ValueError(f"{nb} blocks exceed the kernel's int32 block count")
    dev = x.device
    ctype = torch.int8 if fmt == "int8_sym" else torch.uint8
    codes = torch.empty((nb, block), dtype=ctype, device=dev)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=dev)
    if nb:
        mids = None if fmt == "int8_sym" else _mids_on(fmt, dev)
        rc = getattr(_build.library(), entry)(
            x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            None if mids is None else mids.data_ptr(), n, block, nb,
            0 if mids is None else mids.numel(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "quantize_blockwise")
        _build.launches["quantize_blockwise"] += 1
    return codes, scale


def write_kv_int8_reference(k, v, rows, k_codes, v_codes, k_scale, v_scale) -> None:
    """Plain version of :func:`write_kv_int8`: ``quantize_blockwise`` per
    head_dim vector, then an index_put of codes and scales by row."""
    for x, codes, scale in ((k, k_codes, k_scale), (v, v_codes, v_scale)):
        c, s = quantize_blockwise_reference(x, fmt="int8_sym", block=x.shape[-1])
        codes[:, rows] = c.reshape(x.shape)
        scale[:, rows] = s.reshape(x.shape[:-1])


def write_kv_int8(k: torch.Tensor, v: torch.Tensor, rows: torch.Tensor, k_codes: torch.Tensor,
                  v_codes: torch.Tensor, k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                  use_kernel: bool | None = None) -> None:
    """Quantize K and V per head_dim vector (``fmt="int8_sym"``, block =
    hd) into rows of an int8 KV pool, IN PLACE.

    k, v: (L, R, nkv, hd) f32 or bf16; rows: (R,) int64, the pool row of
    each r (page * page_size + offset); k_codes, v_codes: (L, P, nkv, hd)
    int8 and k_scale, v_scale: (L, P, nkv) f32, the pool's P rows. Vector
    (l, r, h) lands in row rows[r]. Where several r name one row, it ends
    up holding one of them (the plain version: the last) or, on the
    kernel, a mix of them: the serve path sends only the null page's rows
    twice, and attention never reads them.
    """
    if not _build.use_kernel_for(use_kernel, k):
        return write_kv_int8_reference(k, v, rows, k_codes, v_codes, k_scale, v_scale)
    n_layers, n_rows, nkv, hd = k.shape
    pool_rows = k_codes.shape[1]
    entry = _KV_ENTRY.get(k.dtype)
    if entry is None or v.dtype != k.dtype:
        raise TypeError(f"the int8 KV write kernel takes f32 or bf16 K and V, got {k.dtype}, "
                        f"{v.dtype}")
    if hd not in _KV_HEAD_DIMS:
        raise ValueError(f"the int8 KV write kernel takes head_dim in {_KV_HEAD_DIMS}, got {hd}")
    if v.shape != k.shape or rows.shape != (n_rows,) or rows.dtype != torch.int64 or \
            k_codes.shape != (n_layers, pool_rows, nkv, hd) or v_codes.shape != k_codes.shape or \
            k_scale.shape != k_codes.shape[:-1] or v_scale.shape != k_scale.shape:
        raise ValueError("write_kv_int8: K, V (L, R, nkv, hd), rows (R,) int64, codes "
                         "(L, P, nkv, hd), scales (L, P, nkv)")
    if (k_codes.dtype, v_codes.dtype, k_scale.dtype, v_scale.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32):
        raise TypeError("write_kv_int8 writes int8 codes and f32 scales")
    pool = (k_codes, v_codes, k_scale, v_scale)
    if not all(t.is_contiguous() for t in pool):
        raise ValueError("write_kv_int8 writes into a contiguous pool")
    k, v, rows = k.contiguous(), v.contiguous(), rows.contiguous()
    dev = k.device
    if any(t.device != dev for t in (v, rows, *pool)):
        raise ValueError("write_kv_int8: every operand must be on one device")
    if not k.numel():
        return None
    rc = getattr(_build.library(), entry)(
        k.data_ptr(), v.data_ptr(), rows.data_ptr(), *(t.data_ptr() for t in pool), n_layers,
        n_rows, nkv, hd, pool_rows, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "write_kv_int8")
    _build.launches["quantize_blockwise"] += 1
    return None


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, *, fmt: str = "nf4"):
    """Inverse of :func:`quantize_blockwise` (flat, unshaped), f32."""
    if fmt == "int8_sym":
        return codes.to(torch.float32) * scale
    return codebooks.get_codebook(fmt, device=codes.device)[codes.long()] * scale
