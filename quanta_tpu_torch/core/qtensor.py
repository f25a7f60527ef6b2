"""QuantizedTensor: the quantized-array container (torch tensors).

Same fields and scale convention as ``quanta_tpu/core/qtensor.py``:

  - ``scheme == "symmetric"``: dequant = codes * scale (signed codes).
  - ``scheme == "affine"``: blockwise ``(codes - zero_point) * scale``; in
    the matmul layout ``codes * scale + zero_point`` (zero_point = block min).
  - ``scheme == "codebook"``: dequant = codebook[codes] * scale.

``shape``, ``dtype`` (a ``torch.dtype``), ``bits``, ``scheme``,
``codebook``, ``block_size`` and ``packed`` are plain Python metadata.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized array plus everything needed to reconstruct it."""

    codes: torch.Tensor  # uint8/int8 codes (possibly packed)
    scale: torch.Tensor  # f32 (n_blocks,) or (K_pad/block, N_pad)
    zero_point: Optional[torch.Tensor]  # f32, affine only

    bits: int = 8
    scheme: str = "symmetric"
    codebook: Optional[str] = None
    shape: tuple = ()
    dtype: torch.dtype = torch.float32
    block_size: int = 0
    packed: str = "none"  # "none" | "nibbles" | "split_k"

    def __post_init__(self):
        self.shape = tuple(self.shape)

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.codes) + _nbytes(self.scale)
        if self.zero_point is not None:
            n += _nbytes(self.zero_point)
        return n

    @property
    def compression_ratio(self) -> float:
        orig = math.prod(self.shape) * self.dtype.itemsize
        return orig / max(self.nbytes, 1)

    def astype_meta(self, **kw) -> "QuantizedTensor":
        return dataclasses.replace(self, **kw)

    def dequantize(self) -> torch.Tensor:
        from quanta_tpu_torch.core import codecs

        return codecs.dequantize(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
