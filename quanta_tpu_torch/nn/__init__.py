"""Quantized module layer (port of quanta_tpu/nn)."""

from quanta_tpu_torch.nn.linear import (
    Linear4bit,
    Linear8bitLt,
    dequantize_params,
    linear,
    quantize_linear_weight,
    quantize_params,
)

__all__ = [
    "Linear4bit",
    "Linear8bitLt",
    "linear",
    "quantize_linear_weight",
    "quantize_params",
    "dequantize_params",
]
