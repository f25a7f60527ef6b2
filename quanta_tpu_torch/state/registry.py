"""QuantizationState: a registry of named quantized tensors and their
parameters (port of ``quanta_tpu/state/registry.py``).

The registry keeps whole ``QuantizedTensor``s, which carry their own
metadata, and derives each tensor's parameters from them; it also holds
per-layer free-form parameters and a ``ConfigTree`` that ``quantize``
resolves by name. ``summary_json`` is the JAX package's snapshot, key for
key, so a snapshot written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from quanta_tpu_torch.core import dequantize, quantize
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.state.config import ConfigTree, QuantConfig


def tensor_params(qt: QuantizedTensor) -> Dict[str, Any]:
    """A tensor's parameters, derived from it."""
    from quanta_tpu_torch.utils.serialization import dtype_name

    return {
        "bits": qt.bits,
        "scheme": qt.scheme,
        "codebook": qt.codebook,
        "shape": list(qt.shape),
        "dtype": dtype_name(qt.dtype),
        "block_size": qt.block_size,
        "packed": qt.packed,
    }


class QuantizationState:
    """Registry mapping tensor names -> QuantizedTensor (+ config tree)."""

    def __init__(self, config: Optional[ConfigTree] = None):
        self.config = config or ConfigTree()
        self._tensors: Dict[str, QuantizedTensor] = {}
        self._layer_params: Dict[str, Dict[str, Any]] = {}

    # ---------------------------------------------------------- registry
    def register(self, name: str, qt: QuantizedTensor) -> None:
        self._tensors[name] = qt

    def get(self, name: str) -> QuantizedTensor:
        return self._tensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    def names(self):
        return sorted(self._tensors)

    def get_tensor_params(self, name: str) -> Dict[str, Any]:
        return tensor_params(self._tensors[name])

    def set_layer_params(self, layer: str, **params) -> None:
        self._layer_params.setdefault(layer, {}).update(params)

    def get_layer_params(self, layer: str) -> Dict[str, Any]:
        return dict(self._layer_params.get(layer, {}))

    # ------------------------------------------------------- quant paths
    def quantize(self, name: str, x: torch.Tensor) -> QuantizedTensor:
        """Quantize ``x`` under the config resolved for ``name`` and register
        it. ``calibration != "minmax"`` first clips x to the range reduced
        from its own 256-bin histogram (percentile / entropy)."""
        cfg: QuantConfig = self.config.resolve(name)
        if cfg.calibration != "minmax":
            from quanta_tpu_torch import calib

            lo, hi = calib.weight_clip_range(x, cfg.calibration, cfg.bits)
            x = torch.clamp(x, lo, hi)
        qt = quantize(x, bits=cfg.bits, scheme=cfg.scheme, codebook=cfg.codebook,
                      block_size=cfg.block_size, pack=cfg.pack)
        self.register(name, qt)
        return qt

    def dequantize(self, name: str) -> torch.Tensor:
        return dequantize(self._tensors[name])

    # -------------------------------------------------------- persistence
    def save_tensor(self, name: str, path: str) -> None:
        """Persist one registered tensor (.qtn or .npz by extension)."""
        from quanta_tpu_torch.utils import serialization

        serialization.save_quantized_tensor(self._tensors[name], path)

    def load_tensor(self, name: str, path: str) -> QuantizedTensor:
        from quanta_tpu_torch.utils import serialization

        qt = serialization.load_quantized_tensor(path)
        self.register(name, qt)
        return qt

    def summary_json(self) -> str:
        """JSON snapshot of the config, every registered tensor's
        parameters and the layer parameters (codes and scales live in
        checkpoints, not here)."""
        return json.dumps(
            {
                "config": json.loads(self.config.to_json()),
                "tensors": {n: tensor_params(t) for n, t in self._tensors.items()},
                "layers": self._layer_params,
            },
            indent=2,
        )

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.summary_json())

    @staticmethod
    def load_json(path: str) -> "QuantizationState":
        """Rebuild the config and layer parameters (tensor data loads
        separately)."""
        with open(path) as f:
            d = json.load(f)
        st = QuantizationState(ConfigTree.from_json(json.dumps(d["config"])))
        st._layer_params = d.get("layers", {})
        return st
