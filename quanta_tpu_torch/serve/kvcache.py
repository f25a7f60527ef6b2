"""Paged KV cache: a fixed page pool and page-table indirection.

Port of ``quanta_tpu/serve/kvcache.py``:

  - one page pool per model, ``(n_layers, n_pages, page_size, n_kv_heads,
    head_dim)``, with page 0 reserved as the null page that unused
    page-table entries point at (attention always masks it);
  - an ``(n_slots, max_pages_per_slot)`` int32 page table maps each
    serving slot's logical positions onto physical pages; it is host data
    (the engine uploads the slice it needs), so allocation is host Python;
  - pages are allocated as sequences grow and freed when a request ends.

PyTorch idiom: the writers (``write_token``, ``write_token_layer``,
``write_prefill``) update the pool IN PLACE, where JAX returns a new
(donated) array, and return it for the same call shape.

The int8 pool (``kv_quant=True``) keeps int8 codes with one f32 scale per
(token, kv-head) vector. It has ONE quantize rule, that of
``ops.quantize.quantize_blockwise`` with ``fmt="int8_sym"`` and block =
head_dim: scale = 1 if absmax <= 1e-12 else absmax / 127, codes
clip(round(x / scale), -127, 127). On CUDA a prompt's or a window's K and
V go into the pool through one launch of ``ops.quantize.write_kv_int8``,
which quantizes straight into the pool's rows: in eager PyTorch one
launch is cheaper than the ~6 ops of the plain version. (The JAX package
has two rules: its kernel's, for tensors of 2**18 values or more on a
TPU, and an XLA one, absmax / 127 + 1e-12 without the clip, elsewhere; the
two agree to one code step.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from quanta_tpu_torch.ops.quantize import quantize_blockwise, write_kv_int8


def init_pool(cfg, n_pages: int, page_size: int, kv_quant: bool = False,
              device=None) -> dict:
    """Allocate the page pool (zeros). ``kv_quant=True`` stores K/V as int8
    codes plus f32 scales ``(L, n_pages, page, nkv)``: 8 + 32/64 bits per
    element at head_dim 64 instead of 16."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if not kv_quant:
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    sshape = shape[:-1]
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
    }


def is_quantized(pool: dict) -> bool:
    return "k_scale" in pool


def pool_bytes(pool: dict) -> int:
    """Device bytes the pool's tensors hold."""
    return sum(t.numel() * t.element_size() for t in pool.values())


def quantize_kv(x: torch.Tensor, *, use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-vector quantization over the trailing head_dim:
    x (..., hd) -> (codes int8 (..., hd), scale f32 (...)). Dispatch is that
    of every kernel wrapper: the kernel for a CUDA x, the plain version for
    a CPU one, the plain version anywhere with ``use_kernel=False``."""
    hd = x.shape[-1]
    codes, scale = quantize_blockwise(x, fmt="int8_sym", block=hd, use_kernel=use_kernel)
    return codes.reshape(x.shape), scale.reshape(x.shape[:-1])


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


def gather_layer(pool_l: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(n_pages, page, ...) gathered by (n_slots, max_pages) ->
    (n_slots, max_pages * page, ...): each slot's logical KV stream. Works
    for the KV tensors (..., nkv, hd) and their scales (..., nkv). The
    read scales with the table's WIDTH: the engine passes a column slice."""
    return _gather(pool_l, page_table, 0)


def _gather(pool: torch.Tensor, page_table: torch.Tensor, axis: int) -> torch.Tensor:
    g = pool[(slice(None),) * axis + (page_table,)]  # (.., S, maxp, page, ...)
    s, mp, pg = g.shape[axis:axis + 3]
    return g.reshape(*g.shape[:axis], s, mp * pg, *g.shape[axis + 3:])


def gather_all_layers(pool_a: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """:func:`gather_layer` for every layer of a stacked (L, n_pages, ...)
    pool in one op: (L, n_slots, max_pages * page, ...)."""
    return _gather(pool_a, page_table, 1)


def _slots_of(page_table, positions, page_size):
    page_idx = page_table.gather(1, torch.div(positions, page_size, rounding_mode="floor")
                                 .long()[:, None])[:, 0]
    return page_idx, positions % page_size


def write_token(pool_l, page_table, positions, kv_new, page_size: int) -> torch.Tensor:
    """Write one new token's K (or V) per slot into its current page, IN
    PLACE. pool_l: (n_pages, page, nkv, hd); positions: (n_slots,)
    absolute positions; kv_new: (n_slots, nkv, hd). Slot i writes
    unconditionally to its mapped page; inactive slots must map to the
    null page."""
    page_idx, offset = _slots_of(page_table, positions, page_size)
    pool_l[page_idx, offset] = kv_new.to(pool_l.dtype)
    return pool_l


def write_token_layer(pool_a, layer: int, page_table, positions, kv_new,
                      page_size: int) -> torch.Tensor:
    """:func:`write_token` against the full stacked pool (L, n_pages, ...),
    layer ``layer``, IN PLACE. Active slots own their pages, so their
    targets are unique; inactive ones all land on (null page 0, offset 0),
    whose content attention never reads."""
    page_idx, offset = _slots_of(page_table, positions, page_size)
    pool_a[layer, page_idx, offset] = kv_new.to(pool_a.dtype)
    return pool_a


def write_rows(pool: dict, rows: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               use_kernel: Optional[bool] = None) -> dict:
    """Write K and V (n_layers, R, nkv, hd) into pool rows, IN PLACE.

    rows: (R,) int64, ``page * page_size + offset`` of each r. A quantized
    pool takes int8 codes per (token, head) vector, through one
    ``write_kv_int8`` (one launch on CUDA). Where several r name one row
    (the null page), attention never reads it.
    """
    n_layers, n_pages, page = pool["k"].shape[:3]
    flat = {name: t.view(n_layers, n_pages * page, *t.shape[3:]) for name, t in pool.items()}
    if not is_quantized(pool):
        flat["k"][:, rows] = k.to(flat["k"].dtype)
        flat["v"][:, rows] = v.to(flat["v"].dtype)
        return pool
    write_kv_int8(k, v, rows, flat["k"], flat["v"], flat["k_scale"], flat["v_scale"],
                  use_kernel=use_kernel)
    return pool


def write_prefill(pool: dict, pages: torch.Tensor, k_seq: torch.Tensor, v_seq: torch.Tensor,
                  *, use_kernel: Optional[bool] = None) -> dict:
    """Write a full prompt's KV into the given pages, IN PLACE.

    pages: (n_prompt_pages,) physical page ids (0 for bucket padding).
    k_seq/v_seq: (n_layers, S_pad, nkv, hd) with S_pad == len(pages) *
    page. A quantized pool takes int8 codes per (token, head) vector.
    """
    page = pool["k"].shape[2]
    rows = (pages.long()[:, None] * page + torch.arange(page, device=pages.device)).reshape(-1)
    return write_rows(pool, rows, k_seq, v_seq, use_kernel=use_kernel)


@dataclasses.dataclass
class PageAllocator:
    """Host-side free list over physical pages (page 0 reserved as null)."""

    n_pages: int

    def __post_init__(self):
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"bad page id {p}")
        self._free.extend(pages)
