"""Quantized linear layers (port of quanta_tpu/nn/linear.py).

The functional entry point is :func:`linear`, which dispatches on the
weight leaf: a dense tensor, a ``QuantizedTensor`` (matmul layout), an
``Int8Weight`` (LLM.int8), an ``Int4cWeight`` or a ``LoRAWeight`` (a base
leaf plus adapters, ``nn/lora.py``), each possibly wrapped by the
calibration leaves of ``calib.py``: a ``TapWeight`` records its input's
statistics, an ``ActQuantWeight`` fake-quantizes it. Whole-model quantization
is a transformation of the parameter tree (:func:`quantize_params`), not
module surgery; the ``Linear8bitLt`` and ``Linear4bit`` modules wrap
``linear`` for callers who want a module.

Weights are (in_features, out_features): ``y = x @ W``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from quanta_tpu_torch import calib
from quanta_tpu_torch.calib import _map_with_path
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.nn.lora import LoRAWeight, lora_linear
from quanta_tpu_torch.ops.int4c import Int4cWeight, dequantize_int4c, matmul_int4c, quantize_int4c_weight
from quanta_tpu_torch.ops.int8mm import Int8Weight, matmul_int8, quantize_int8_weight
from quanta_tpu_torch.ops.matmul import matmul_quantized

WeightLike = Any  # torch.Tensor | QuantizedTensor | Int8Weight | Int4cWeight | LoRAWeight


def linear(
    x: torch.Tensor,
    w: WeightLike,
    b: Optional[torch.Tensor] = None,
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """``x @ W (+ b)`` for any supported weight representation.

    ``use_kernel=None`` runs the CUDA kernel for a CUDA ``x`` and the plain
    version for a CPU one; ``False`` forces the plain version. Under
    autograd, gradients reach x through dense, ``QuantizedTensor`` and
    ``LoRAWeight`` leaves (and the adapters); the LLM.int8 and int4c
    kernels have no backward and raise rather than drop it. A ``TapWeight``
    records x's statistics (under ``calib.taping``) and an
    ``ActQuantWeight`` fake-quantizes x, each before its wrapped leaf runs.
    """
    if isinstance(w, calib.TapWeight):  # calibration stats hook
        calib.tap_record(w.name, x)
        w = w.w
    if isinstance(w, calib.ActQuantWeight):  # calibrated activation quant
        x = calib.fake_quant(x, w.lo, w.hi, w.bits)
        w = w.w
    if isinstance(w, LoRAWeight):
        return lora_linear(x, w, b, use_kernel=use_kernel)
    if isinstance(w, QuantizedTensor):
        y = matmul_quantized(x, w, use_kernel=use_kernel)
    elif isinstance(w, Int8Weight):
        y = matmul_int8(x, w, use_kernel=use_kernel)
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
    calib_colmax: Optional[torch.Tensor] = None,
) -> WeightLike:
    """Convert a dense (in, out) weight into a quantized representation.

    mode: "nf4"/"nf4a"/"int4"/"fp4"/"int8"/"nf8"/"fp8", "int8a"/"int4a"
    (affine), "llm_int8" (outlier decomposition; ``calib_colmax`` picks the
    outlier features where calibration gave one), or "int4c".
    """
    if mode == "llm_int8":
        return quantize_int8_weight(w, threshold=threshold, calib_colmax=calib_colmax)
    if mode == "int4c":
        return quantize_int4c_weight(w)
    return codecs.quantize_matmul_weight(w, fmt=mode, block_size=block_size)


def quantize_params(
    params,
    *,
    mode: str = "nf4",
    block_size: int = 64,
    threshold: float = 6.0,
    predicate=None,
    min_size: int = 4096,
    stats=None,
):
    """Tree transformation: replace 2-D weight leaves with quantized ones.

    ``predicate(path, leaf) -> bool`` selects the leaves; ``path`` is the
    tuple of dict keys and list indices. Default: 2-D float tensors with at
    least ``min_size`` elements, except embeddings (``emb``, ``wte``,
    ``wpe`` in the path), which are gathered, not multiplied. The map walks
    into ``LoRAWeight`` (its base, at ``<path>/base``), ``TapWeight`` and
    ``ActQuantWeight`` (``<path>/w``) as JAX's does, but leaves a
    LoRAWeight's adapters as they are, where JAX quantizes them too
    (``calib._map_with_path``).

    ``stats``: optional {tree path: calib.ActivationStats} from
    ``calib.collect_stats``; with mode="llm_int8" the per-feature activation
    colmax selects the outlier set instead of the weight-norm proxy.
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
            colmax = None
            st = None if stats is None else stats.get(calib._path_name(path))
            if st is not None:
                colmax = torch.as_tensor(st.colmax, device=leaf.device)
            return quantize_linear_weight(leaf, mode=mode, block_size=block_size,
                                          threshold=threshold, calib_colmax=colmax)
        return leaf

    return _map_with_path(maybe_quant, params)


def init_quantized_params(generator: torch.Generator, cfg, *, mode: str = "nf4a",
                          block_size: int = 64, device=None) -> dict:
    """Random-init a Llama parameter tree directly in quantized form (port
    of ``quanta_tpu.nn.linear.init_quantized_params``): every linear's codes
    and scales are drawn at the layout ``quantize_matmul_weight`` would give
    (K padded to 16 * block, N to 128), uniform codes and scales
    ``uniform / sqrt(K) + 1e-4``, so the dense tree never exists (a dense
    Llama-2-7B is 13.5 GB of bf16). Speed depends on shapes and formats,
    not on weight values. The embedding is dense, ``randn * 0.02``; the
    norms are ones. ``mode`` is a matmul-layout format without a zero point
    (the affine int8a/int4a would need one drawn per block).
    """
    template = codecs.quantize_matmul_weight(
        torch.zeros((16 * block_size, 128)), fmt=mode, block_size=block_size)
    if template.zero_point is not None:
        raise ValueError(f"init_quantized_params: {mode!r} is affine; its zero points are "
                         "not drawn")

    def quantized(k, n):
        k_pad = -(-k // (16 * block_size)) * (16 * block_size)
        n_pad = -(-n // 128) * 128
        if template.packed == "split_k":
            shape, low, high = (k_pad // 2, n_pad), 0, 256
        elif template.codes.dtype == torch.int8:
            shape, low, high = (k_pad, n_pad), -127, 128
        else:
            shape, low, high = (k_pad, n_pad), 0, 256
        codes = torch.randint(low, high, shape, generator=generator, device=device,
                              dtype=template.codes.dtype)
        scale = torch.rand((k_pad // block_size, n_pad), generator=generator, device=device)
        scale = scale * (1.0 / math.sqrt(k)) + 1e-4
        return dataclasses.replace(template, codes=codes, scale=scale, shape=(k, n),
                                   dtype=torch.bfloat16)

    def ones():
        return torch.ones((cfg.dim,), dtype=cfg.dtype, device=device)

    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    emb = torch.randn((cfg.vocab_size, cfg.dim), generator=generator, device=device)
    params = {"tok_emb": (emb * 0.02).to(cfg.dtype), "norm_f": ones(), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": ones(),
            "wq": quantized(cfg.dim, nh * hd),
            "wk": quantized(cfg.dim, nkv * hd),
            "wv": quantized(cfg.dim, nkv * hd),
            "wo": quantized(nh * hd, cfg.dim),
            "ffn_norm": ones(),
            "w_gate": quantized(cfg.dim, cfg.hidden_dim),
            "w_up": quantized(cfg.dim, cfg.hidden_dim),
            "w_down": quantized(cfg.hidden_dim, cfg.dim),
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = quantized(cfg.dim, cfg.vocab_size)
    return params


def dequantize_params(params):
    """Inverse transformation: materialize dense weights from quantized.

    As JAX's: a ``TapWeight`` or ``ActQuantWeight`` gives its dense weight
    (the wrapper goes), a ``LoRAWeight`` keeps its adapters over a dense
    base."""

    def deq(_path, leaf):
        if isinstance(leaf, (calib.TapWeight, calib.ActQuantWeight)):
            leaf = leaf.w
        if isinstance(leaf, QuantizedTensor):
            return codecs.dequantize_matmul_weight(leaf)
        if isinstance(leaf, Int8Weight):
            k, n = leaf.shape
            dense = leaf.codes.to(torch.float32) * leaf.scale[None, :]
            dense[leaf.outlier_idx] = leaf.w_outlier.to(torch.float32)  # in place, fresh tensor
            return dense[:k, :n]  # drop the kernel-tile padding
        if isinstance(leaf, Int4cWeight):
            return dequantize_int4c(leaf)
        return leaf

    return _map_with_path(deq, params, is_leaf=lambda x: isinstance(
        x, (calib.TapWeight, calib.ActQuantWeight)))


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


class Linear8bitLt(nn.Module):
    """LLM.int8 linear over :func:`linear`.

    Holds a dense (in, out) weight after construction
    (``has_fp16_weights`` semantics), as the JAX module does;
    :meth:`quantize_` swaps it for an ``Int8Weight`` with outliers at
    ``threshold``. ``forward`` handles both.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 has_fp16_weights: bool = False, threshold: float = 6.0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.has_fp16_weights = has_fp16_weights
        self.threshold = threshold
        # kaiming-uniform over fan_in, as flax's default kernel init
        bound = math.sqrt(3.0 / in_features) * math.sqrt(2.0)
        w = torch.empty((in_features, out_features), dtype=dtype, device=device)
        w.uniform_(-bound, bound, generator=generator)
        self.weight: WeightLike = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype, device=device))
                     if bias else None)

    @torch.no_grad()
    def quantize_(self) -> "Linear8bitLt":
        w = self.weight.detach()
        del self.weight  # a registered Parameter cannot be reassigned a non-Parameter
        self.weight = quantize_linear_weight(w, mode="llm_int8", threshold=self.threshold)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)
