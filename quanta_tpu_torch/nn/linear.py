"""Quantized linear layers (port of quanta_tpu/nn/linear.py).

The functional entry point is :func:`linear`, which dispatches on the
weight leaf: a dense tensor, a ``QuantizedTensor`` (matmul layout) or an
``Int4cWeight``. Whole-model quantization is a transformation of the
parameter tree (:func:`quantize_params`), not module surgery; the
``Linear4bit`` module wraps ``linear`` for callers who want a module.

Weights are (in_features, out_features): ``y = x @ W``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.ops.int4c import Int4cWeight, dequantize_int4c, matmul_int4c, quantize_int4c_weight
from quanta_tpu_torch.ops.matmul import matmul_quantized

WeightLike = Any  # torch.Tensor | QuantizedTensor | Int4cWeight

# Weight leaves of the JAX package that the port does not have yet, and the
# ROADMAP item that ports each.
_NOT_PORTED = {
    "Int8Weight": "ROADMAP Queue 1 item 4 (ops/int8mm.py, LLM.int8)",
    "LoRAWeight": "ROADMAP Queue 1 item 5 (nn/lora.py)",
    "TapWeight": "ROADMAP Queue 1 item 12 (calib.py)",
    "ActQuantWeight": "ROADMAP Queue 1 item 12 (calib.py)",
}


def linear(
    x: torch.Tensor,
    w: WeightLike,
    b: Optional[torch.Tensor] = None,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """``x @ W (+ b)`` for any supported weight representation.

    ``use_kernel=None`` runs the CUDA kernel for a CUDA ``x`` and the plain
    version for a CPU one; ``False`` forces the plain version.
    """
    name = type(w).__name__
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} leaves are not ported yet: {_NOT_PORTED[name]}")
    if isinstance(w, QuantizedTensor):
        y = matmul_quantized(x, w, use_kernel=use_kernel)
    elif isinstance(w, Int4cWeight):
        y = matmul_int4c(x, w, use_kernel=use_kernel)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def quantize_linear_weight(
    w: torch.Tensor,
    *,
    mode: str = "nf4",
    block_size: int = 64,
    threshold: float = 6.0,
) -> WeightLike:
    """Convert a dense (in, out) weight into a quantized representation.

    mode: "nf4"/"nf4a"/"int4"/"fp4"/"int8"/"nf8"/"fp8", "int8a"/"int4a"
    (affine), or "int4c". "llm_int8" is not ported yet.
    """
    if mode == "llm_int8":
        raise NotImplementedError(
            f"llm_int8 (threshold={threshold}) is not ported yet: {_NOT_PORTED['Int8Weight']}")
    if mode == "int4c":
        return quantize_int4c_weight(w)
    return codecs.quantize_matmul_weight(w, fmt=mode, block_size=block_size)


def _map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def quantize_params(
    params,
    *,
    mode: str = "nf4",
    block_size: int = 64,
    threshold: float = 6.0,
    predicate=None,
    min_size: int = 4096,
):
    """Tree transformation: replace 2-D weight leaves with quantized ones.

    ``predicate(path, leaf) -> bool`` selects the leaves; ``path`` is the
    tuple of dict keys and list indices. Default: 2-D float tensors with at
    least ``min_size`` elements, except embeddings (``emb``, ``wte``,
    ``wpe`` in the path), which are gathered, not multiplied.
    """

    def default_pred(path, leaf):
        names = "/".join(str(p) for p in path)
        return (
            isinstance(leaf, torch.Tensor)
            and leaf.ndim == 2
            and leaf.is_floating_point()
            and leaf.numel() >= min_size
            and "emb" not in names
            and "wte" not in names
            and "wpe" not in names
        )

    pred = predicate or default_pred

    def maybe_quant(path, leaf):
        if pred(path, leaf):
            return quantize_linear_weight(leaf, mode=mode, block_size=block_size,
                                          threshold=threshold)
        return leaf

    return _map_with_path(maybe_quant, params)


def dequantize_params(params):
    """Inverse transformation: materialize dense weights from quantized."""

    def deq(_path, leaf):
        if isinstance(leaf, QuantizedTensor):
            return codecs.dequantize_matmul_weight(leaf)
        if isinstance(leaf, Int4cWeight):
            return dequantize_int4c(leaf)
        return leaf

    return _map_with_path(deq, params)


class Linear4bit(nn.Module):
    """QLoRA-style 4-bit linear over :func:`linear`.

    Holds a dense (in, out) weight after construction, as the JAX module
    does; :meth:`quantize_` swaps it for its ``quant_type`` quantization.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 compute_dtype: torch.dtype = torch.bfloat16, quant_type: str = "nf4",
                 block_size: int = 64, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.quant_type = quant_type
        self.block_size = block_size
        # kaiming-uniform over fan_in, as flax's default kernel init
        bound = math.sqrt(3.0 / in_features) * math.sqrt(2.0)
        w = torch.empty((in_features, out_features), dtype=dtype, device=device)
        w.uniform_(-bound, bound, generator=generator)
        self.weight: WeightLike = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype, device=device))
                     if bias else None)

    @torch.no_grad()
    def quantize_(self) -> "Linear4bit":
        w = self.weight.detach()
        del self.weight  # a registered Parameter cannot be reassigned a non-Parameter
        self.weight = quantize_linear_weight(w, mode=self.quant_type,
                                             block_size=self.block_size)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x.to(self.compute_dtype), self.weight, self.bias)
