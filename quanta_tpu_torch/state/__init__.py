"""Quantization configuration and the per-tensor registry (port of
quanta_tpu/state)."""

from quanta_tpu_torch.state.config import ConfigTree, QuantConfig
from quanta_tpu_torch.state.registry import QuantizationState, tensor_params

__all__ = ["QuantConfig", "ConfigTree", "QuantizationState", "tensor_params"]
