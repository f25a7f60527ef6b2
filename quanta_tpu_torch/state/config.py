"""Quantization configuration with three-tier precedence (port of
``quanta_tpu/state/config.py``).

Settings resolve in three tiers: global defaults, per-layer overrides and
per-tensor pinned values. Per-layer overrides match by regex over the
parameter-tree path (``layers/0/wq``), and everything serializes to and
from plain JSON. This is the port's own copy of the pure-Python JAX
module, kept line for line: ``to_json`` of one tree gives the same bytes in
both packages (``tests/test_torch_ptq.py``), so a configuration file
written for one drives the other.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

_VALID_SCHEMES = ("symmetric", "affine", "codebook", "llm_int8", "int4c")
_VALID_CALIBRATION = ("minmax", "entropy", "percentile")


@dataclasses.dataclass
class QuantConfig:
    """Settings for quantizing one tensor (or the global default).

    The keys are bits / scheme / codebook / block_size / pack /
    weights_only / calibration / percentile, on the framework's single
    scale convention (core/qtensor.py).
    """

    bits: int = 8
    scheme: str = "symmetric"  # symmetric | affine | codebook | llm_int8
    codebook: Optional[str] = None  # nf4/nf8/fp4/fp8/int4 when scheme=codebook
    block_size: int = 64  # 0 = per-tensor
    pack: bool = False  # pack 4-bit codes two-per-byte
    weights_only: bool = True  # False adds activation fake-quant
    calibration: str = "minmax"  # minmax | entropy | percentile
    # clip percentiles for calibration="percentile" (configuration, not a
    # constant: the right clip depends on the model)
    percentile: tuple = (0.1, 99.9)

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.scheme not in _VALID_SCHEMES:
            raise ValueError(f"scheme must be one of {_VALID_SCHEMES}")
        if self.calibration not in _VALID_CALIBRATION:
            raise ValueError(f"calibration must be one of {_VALID_CALIBRATION}")
        if self.pack and self.bits != 4:
            raise ValueError("pack=True requires bits=4")
        if self.scheme == "int4c" and self.bits != 4:
            raise ValueError("scheme='int4c' requires bits=4")
        self.percentile = tuple(self.percentile)  # JSON round trip -> list
        if not (0.0 <= self.percentile[0] < self.percentile[1] <= 100.0):
            raise ValueError(f"bad percentile bounds {self.percentile}")

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QuantConfig":
        return QuantConfig(**d)

    @staticmethod
    def from_mode(mode: str, *, block_size: int = 64, **kw) -> "QuantConfig":
        """Build a config from a matmul weight-format name (the inverse of
        ptq.config_to_mode): int8/int4 -> symmetric, nf4/nf4a/nf8/fp4/fp8
        -> codebook, int8a/int4a -> affine, llm_int8 -> llm_int8, int4c ->
        int4c."""
        if mode == "llm_int8":
            return QuantConfig(bits=8, scheme="llm_int8",
                               block_size=block_size, **kw)
        if mode == "int4c":
            # per-output-column scales (no blocks) — see ops/int4c.py
            return QuantConfig(bits=4, scheme="int4c", block_size=0, **kw)
        if mode in ("int8", "int4"):
            return QuantConfig(bits=int(mode[3:]), scheme="symmetric",
                               block_size=block_size, **kw)
        if mode in ("int8a", "int4a"):
            return QuantConfig(bits=int(mode[3]), scheme="affine",
                               block_size=block_size, **kw)
        if mode in ("nf4", "nf4a", "fp4"):
            return QuantConfig(bits=4, scheme="codebook", codebook=mode,
                               block_size=block_size, **kw)
        if mode in ("nf8", "fp8"):
            return QuantConfig(bits=8, scheme="codebook", codebook=mode,
                               block_size=block_size, **kw)
        raise ValueError(f"unknown weight format {mode!r}")


class ConfigTree:
    """Three-tier config resolution: global -> per-layer regex -> per-tensor.

    The most specific tier wins, field by field. *All* matching per-layer
    rules apply in registration order (later rules win field by field), so
    re-configuring a layer replaces its earlier config.
    """

    def __init__(self, default: Optional[QuantConfig] = None):
        self.default = default or QuantConfig()
        self._layer_rules: List[Tuple[str, Dict[str, Any]]] = []
        self._tensor_overrides: Dict[str, Dict[str, Any]] = {}

    # -- tier 2: per-layer regex rules --
    def config_layer(self, pattern: str, **overrides) -> "ConfigTree":
        re.compile(pattern)  # validate eagerly
        bad = set(overrides) - {f.name for f in dataclasses.fields(QuantConfig)}
        if bad:
            raise ValueError(f"unknown QuantConfig fields: {sorted(bad)}")
        self._layer_rules.append((pattern, dict(overrides)))
        return self

    # -- tier 3: per-tensor pinned params --
    def config_tensor(self, name: str, **overrides) -> "ConfigTree":
        bad = set(overrides) - {f.name for f in dataclasses.fields(QuantConfig)}
        if bad:
            raise ValueError(f"unknown QuantConfig fields: {sorted(bad)}")
        self._tensor_overrides.setdefault(name, {}).update(overrides)
        return self

    def resolve(
        self, name: str, counts: Optional[Dict[int, int]] = None
    ) -> QuantConfig:
        """Resolve the effective config for a tensor-tree path like
        ``layers/0/attn/wq``.

        ``counts``: optional dict the caller threads through a whole-model
        pass; each matching layer-rule index increments its entry, so the
        caller can detect rules that matched zero tensors (a silently-dead
        regex is the classic config sharp edge — e.g. ``layers\\.0\\.``
        against '/'-joined paths)."""
        merged = self.default.to_dict()
        for i, (pattern, ov) in enumerate(self._layer_rules):
            if re.search(pattern, name):
                merged.update(ov)
                if counts is not None:
                    counts[i] = counts.get(i, 0) + 1
        merged.update(self._tensor_overrides.get(name, {}))
        return QuantConfig.from_dict(merged)

    @property
    def layer_rules(self) -> List[Tuple[str, Dict[str, Any]]]:
        return list(self._layer_rules)

    # -- JSON round trip --
    def to_json(self) -> str:
        return json.dumps(
            {
                "default": self.default.to_dict(),
                "layer_rules": self._layer_rules,
                "tensor_overrides": self._tensor_overrides,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "ConfigTree":
        d = json.loads(s)
        t = ConfigTree(QuantConfig.from_dict(d["default"]))
        for pattern, ov in d.get("layer_rules", []):
            t.config_layer(pattern, **ov)
        for name, ov in d.get("tensor_overrides", {}).items():
            t.config_tensor(name, **ov)
        return t

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "ConfigTree":
        with open(path) as f:
            return ConfigTree.from_json(f.read())
