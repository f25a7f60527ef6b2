"""LoRA adapters over frozen quantized base weights (port of quanta_tpu/nn/lora.py).

A LoRA layer is a parameter-tree pattern, not a module rewrite: the base
weight stays whatever leaf it was (a ``QuantizedTensor`` for QLoRA) and a
``LoRAWeight`` leaf wraps it with two adapter tensors. The adapters are
leaf tensors with ``requires_grad=True``; they are what an optimizer
steps (:func:`lora_parameters`), and nothing else in the tree needs a
gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch


@dataclasses.dataclass
class LoRAWeight:
    """A (possibly quantized, frozen) base weight plus trainable adapters.

    y = x @ base + (x @ A) @ B * (alpha / rank)
    A: (in, rank), B: (rank, out); B starts at zero, so the adapter starts
    as the identity.
    """

    base: Any  # WeightLike
    lora_a: torch.Tensor
    lora_b: torch.Tensor
    alpha: float = 16.0

    @property
    def rank(self) -> int:
        return self.lora_a.shape[-1]


def init_lora(
    base,
    generator: torch.Generator,
    *,
    rank: int = 8,
    alpha: float = 16.0,
    in_features: Optional[int] = None,
    out_features: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> LoRAWeight:
    """Wrap a base weight with adapters: A normal / sqrt(rank), B zero.
    ``generator`` draws A on its own device, which ``device`` must match."""
    if in_features is None or out_features is None:
        shape = getattr(base, "shape", None)
        if shape is None:
            raise ValueError("pass in_features/out_features for this base type")
        in_features, out_features = shape
    a = torch.randn((in_features, rank), generator=generator, device=device,
                    dtype=torch.float32).to(dtype) * (1.0 / math.sqrt(rank))
    b = torch.zeros((rank, out_features), dtype=dtype, device=device)
    return LoRAWeight(base=base, lora_a=a.requires_grad_(), lora_b=b.requires_grad_(),
                      alpha=alpha)


def lora_linear(
    x: torch.Tensor,
    w: LoRAWeight,
    b: Optional[torch.Tensor] = None,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """The base through ``linear`` (the fused quantized kernel) plus the
    low-rank adapter, whose two rank-r products are plain ``torch.matmul``
    (the JAX package computes them outside any Pallas kernel too)."""
    from quanta_tpu_torch.nn.linear import linear  # linear dispatches here

    y = linear(x, w.base, b, use_kernel=use_kernel)
    scaling = w.alpha / w.rank
    delta = (x.to(w.lora_a.dtype) @ w.lora_a) @ w.lora_b
    return y + (delta * scaling).to(y.dtype)


def lora_parameters(tree) -> Iterator[torch.Tensor]:
    """The adapter tensors of a parameter tree, in tree order: the
    trainable leaves of QLoRA, for an optimizer's param groups (the role
    of the JAX package's ``lora_params_filter`` mask). In a sharded tree
    (``parallel.shard_params``) they are the rank's own slices."""
    if isinstance(tree, LoRAWeight):
        for t in (tree.lora_a, tree.lora_b):
            yield getattr(t, "local", t)  # a parallel.sharding.Shard: its local tensor
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from lora_parameters(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from lora_parameters(v)


@torch.no_grad()
def merge_lora(w: LoRAWeight) -> torch.Tensor:
    """Materialize base + adapter as a dense f32 weight (for export)."""
    from quanta_tpu_torch.nn.linear import dequantize_params

    base = dequantize_params(w.base)
    scaling = w.alpha / w.rank
    return base.to(torch.float32) + scaling * (
        w.lora_a.to(torch.float32) @ w.lora_b.to(torch.float32))
