"""Hand parameter trees from the JAX package to the port.

``from_jax_params(tree, device)`` turns a ``quanta_tpu`` parameter tree
(dicts and lists of arrays, ``QuantizedTensor``, ``Int8Weight``,
``Int4cWeight`` and ``LoRAWeight`` leaves) into the port's tree with the
same keys. It never imports jax: leaves are recognised by their
attributes, and arrays go through ``np.asarray``. LoRA adapters arrive as
trainable tensors (``requires_grad=True``), as ``nn.init_lora`` makes
them. A leaf that is neither an array nor one of those weights
(``TapWeight``, ...) raises a ``TypeError`` that names its type:
converting it as something else would compute garbage.

bf16 arrays arrive from ``np.asarray`` as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` does not take; they go through f32, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.nn.lora import LoRAWeight
from quanta_tpu_torch.ops.int4c import Int4cWeight
from quanta_tpu_torch.ops.int8mm import Int8Weight

_QT_FIELDS = ("codes", "scale", "zero_point", "bits", "scheme", "codebook",
              "shape", "block_size", "packed")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def to_torch_dtype(dtype) -> torch.dtype:
    """A numpy / jax dtype (or its name) -> the torch dtype."""
    name = getattr(dtype, "name", None) or np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"no torch counterpart for dtype {name}")
    return _DTYPES[name]


def to_tensor(a, device=None) -> torch.Tensor:
    """Any array ``np.asarray`` accepts -> a torch tensor of the same dtype."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def from_jax_params(tree, device=None):
    """Convert a JAX-package parameter tree to the port's (same keys)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if all(hasattr(tree, f) for f in ("base", "lora_a", "lora_b", "alpha")):
        return LoRAWeight(base=from_jax_params(tree.base, device),
                          lora_a=to_tensor(tree.lora_a, device).requires_grad_(),
                          lora_b=to_tensor(tree.lora_b, device).requires_grad_(),
                          alpha=float(tree.alpha))
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QuantizedTensor(
            codes=to_tensor(tree.codes, device),
            scale=to_tensor(tree.scale, device),
            zero_point=None if tree.zero_point is None else to_tensor(tree.zero_point, device),
            bits=tree.bits, scheme=tree.scheme, codebook=tree.codebook,
            shape=tuple(tree.shape), dtype=to_torch_dtype(tree.dtype),
            block_size=tree.block_size, packed=tree.packed,
        )
    # Int8Weight also has codes, scale and shape: test it before Int4cWeight
    if all(hasattr(tree, f) for f in ("codes", "scale", "outlier_idx", "w_outlier", "shape")):
        return Int8Weight(codes=to_tensor(tree.codes, device),
                          scale=to_tensor(tree.scale, device),
                          outlier_idx=to_tensor(tree.outlier_idx, device),
                          w_outlier=to_tensor(tree.w_outlier, device),
                          threshold=float(tree.threshold), shape=tuple(tree.shape))
    if all(hasattr(tree, f) for f in ("codes", "scale", "shape")):
        return Int4cWeight(codes=to_tensor(tree.codes, device),
                           scale=to_tensor(tree.scale, device), shape=tuple(tree.shape))
    if hasattr(tree, "__array__") or isinstance(tree, (bool, int, float, np.generic)):
        return to_tensor(tree, device)
    raise TypeError(f"from_jax_params: a {type(tree).__name__} leaf has no counterpart "
                    "in the port")
