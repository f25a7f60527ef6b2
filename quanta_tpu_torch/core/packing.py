"""4-bit code packing: two nibbles per byte.

Two layouts, byte-identical to ``quanta_tpu/core/packing.py``:

  - ``"nibbles"`` (serialization layout): flat, low-nibble-first —
    ``packed[i] = codes[2i] | codes[2i+1] << 4``.
  - ``"split_k"`` (matmul layout): for a 2-D weight ``(K, N)``, rows ``k``
    and ``k + K/2`` share a byte: ``packed[k, n] = codes[k, n] |
    codes[k + K/2, n] << 4``. The matmul kernels read ``x[:, :K/2]``
    against the low nibbles and ``x[:, K/2:]`` against the high ones.
"""

from __future__ import annotations

import torch


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Flat low-nibble-first packing; odd length is zero-padded."""
    flat = codes.reshape(-1).to(torch.uint8)
    if flat.shape[0] % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.reshape(-1, 2)
    return pairs[:, 0] | (pairs[:, 1] << 4)


def unpack_nibbles(packed: torch.Tensor, numel: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`; returns flat uint8 of ``numel``."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.stack([lo, hi], dim=-1).reshape(-1)[:numel]


def pack_split_k(codes: torch.Tensor) -> torch.Tensor:
    """Matmul layout: (K, N) uint8 codes -> (K/2, N) uint8. K must be even."""
    k = codes.shape[0]
    if k % 2:
        raise ValueError(f"split_k packing needs even K, got {k}")
    lo = codes[: k // 2].to(torch.uint8)
    hi = codes[k // 2 :].to(torch.uint8)
    return lo | (hi << 4)


def unpack_split_k(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_split_k`: (K/2, N) -> (K, N)."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.cat([lo, hi], dim=0)
