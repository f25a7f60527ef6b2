"""Quantized module layer (port of quanta_tpu/nn)."""

from quanta_tpu_torch.nn.linear import (
    Linear4bit,
    dequantize_params,
    linear,
    quantize_linear_weight,
    quantize_params,
)

__all__ = [
    "Linear4bit",
    "linear",
    "quantize_linear_weight",
    "quantize_params",
    "dequantize_params",
]
