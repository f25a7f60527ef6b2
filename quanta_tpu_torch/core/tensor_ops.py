"""Quantized elementwise and matmul ops over ``QuantizedTensor`` (port of
``quanta_tpu/core/tensor_ops.py``).

Every op is dequantize -> float op -> requantize under the settings of the
first quantized operand; ``quantized_relu`` works on the codes where the
grid allows it. Codes and scales are bit for bit the JAX package's (the
products of ``quantized_matmul`` are, where the float matmul sums exactly).
These are reference-path semantics for tensors outside the model graph;
the model's matmuls go through ``ops.matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from quanta_tpu_torch.core import codebooks
from quanta_tpu_torch.core.codecs import dequantize, quantize
from quanta_tpu_torch.core.qtensor import QuantizedTensor

TensorOrQT = Union[torch.Tensor, QuantizedTensor]


def _to_tensor(x: TensorOrQT) -> torch.Tensor:
    return dequantize(x) if isinstance(x, QuantizedTensor) else torch.as_tensor(x)


def _requant_like(x: torch.Tensor, like: QuantizedTensor) -> QuantizedTensor:
    """Quantize ``x`` under ``like``'s bits, scheme, codebook, block size and
    packing."""
    return quantize(x, bits=like.bits, scheme=like.scheme, codebook=like.codebook,
                    block_size=like.block_size, pack=like.packed != "none")


def _pick_like(a: TensorOrQT, b: Optional[TensorOrQT] = None) -> QuantizedTensor:
    for x in (a, b):
        if isinstance(x, QuantizedTensor):
            return x
    raise TypeError("at least one operand must be a QuantizedTensor")


def quantized_add(a: TensorOrQT, b: TensorOrQT) -> QuantizedTensor:
    return _requant_like(_to_tensor(a) + _to_tensor(b), _pick_like(a, b))


def quantized_mul(a: TensorOrQT, b: TensorOrQT) -> QuantizedTensor:
    return _requant_like(_to_tensor(a) * _to_tensor(b), _pick_like(a, b))


def quantized_matmul(a: TensorOrQT, b: TensorOrQT) -> QuantizedTensor:
    """Matmul with a requantized output (for speed, ``ops.matmul``'s
    kernels never materialize the product in float)."""
    return _requant_like(torch.matmul(_to_tensor(a), _to_tensor(b)), _pick_like(a, b))


def quantized_relu(qt: QuantizedTensor) -> QuantizedTensor:
    """ReLU, on the codes where that is exact:

      * symmetric, unpacked: clamp the codes at the code of 0 (0 for
        8-bit int8 codes, 8 for 4-bit codes stored offset by 8), same
        scales. The JAX package clamps at 0 for both, which leaves 4-bit
        codes as they are (ROADMAP lists it under the reference's faults);
      * codebook, unpacked, with an exact 0 level (NF4's code 7): map each
        negative level's code to it;
      * anything else requantizes ``max(x, 0)``.
    """
    if qt.scheme == "symmetric" and qt.packed == "none":
        zero = 8 if qt.bits == 4 else 0
        return dataclasses.replace(qt, codes=torch.clamp(qt.codes, min=zero))
    if qt.scheme == "codebook" and qt.packed == "none":
        levels = codebooks._REGISTRY[qt.codebook]
        zero_codes = (levels == 0.0).nonzero()[0]
        if len(zero_codes):
            zc = int(zero_codes[0])
            remap = torch.tensor([zc if lv < 0.0 else i for i, lv in enumerate(levels)],
                                 dtype=qt.codes.dtype, device=qt.codes.device)
            return dataclasses.replace(qt, codes=remap[qt.codes.long()])
    return _requant_like(torch.clamp(_to_tensor(qt), min=0.0), qt)
