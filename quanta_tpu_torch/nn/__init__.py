"""Quantized module layer (port of quanta_tpu/nn)."""

from quanta_tpu_torch.nn.linear import (
    Linear4bit,
    Linear8bitLt,
    dequantize_params,
    init_quantized_params,
    linear,
    quantize_linear_weight,
    quantize_params,
)
from quanta_tpu_torch.nn.lora import LoRAWeight, init_lora, lora_linear, lora_parameters, merge_lora

__all__ = [
    "Linear4bit",
    "Linear8bitLt",
    "linear",
    "quantize_linear_weight",
    "quantize_params",
    "dequantize_params",
    "init_quantized_params",
    "LoRAWeight",
    "init_lora",
    "lora_linear",
    "lora_parameters",
    "merge_lora",
]
