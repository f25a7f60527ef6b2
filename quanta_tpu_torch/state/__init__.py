"""Quantization configuration (port of quanta_tpu/state; the per-tensor
``QuantizationState`` registry is not ported yet: ROADMAP Queue 1)."""

from quanta_tpu_torch.state.config import ConfigTree, QuantConfig

__all__ = ["QuantConfig", "ConfigTree"]
