"""Structured metrics: counters, gauges and timers with JSONL export.

Port of ``quanta_tpu/metrics.py``; the serving ``Engine`` takes a
:class:`MetricsRecorder` as its ``recorder``. Device memory comes from
``torch.cuda.memory_stats`` under the JAX package's key names.

Usage:
    rec = MetricsRecorder(path="metrics.jsonl")   # path optional
    rec.count("output_tokens", 32)
    rec.gauge("bytes_in_use", device_memory_stats().get("bytes_in_use", 0.0))
    with rec.timer("decode_step"):
        ...
    rec.emit(step=12)          # one JSON line with counters+gauges+timers
    rec.summary()              # dict with p50/p99 for timers
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Dict, Optional

import torch

# torch.cuda.memory_stats key -> the JAX package's name for it
_STATS = {"allocated_bytes.all.current": "bytes_in_use",
          "allocated_bytes.all.peak": "peak_bytes_in_use"}


def device_memory_stats(device=None) -> Dict[str, float]:
    """Device memory stats in bytes ({} without a CUDA device)."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {name: float(stats[key]) for key, name in _STATS.items() if key in stats}
    out["bytes_limit"] = float(torch.cuda.get_device_properties(device).total_memory)
    return out


def _pct(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class MetricsRecorder:
    """Counters + gauges + timers with optional JSONL export."""

    def __init__(self, path: Optional[str] = None):
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.timings: Dict[str, list] = collections.defaultdict(list)
        self._fh = open(path, "a") if path else None

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        self.timings[name].append(float(seconds))

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.counters)
        out.update(self.gauges)
        for name, vals in self.timings.items():
            sv = sorted(vals)
            out[f"{name}_p50_s"] = round(_pct(sv, 0.50), 6)
            out[f"{name}_p99_s"] = round(_pct(sv, 0.99), 6)
            out[f"{name}_total_s"] = round(sum(vals), 6)
            out[f"{name}_count"] = len(vals)
        return out

    def emit(self, **extra) -> Dict[str, float]:
        """Snapshot + write one JSON line (if a path was given)."""
        snap = {**self.snapshot(), **extra, "t": round(time.time(), 3)}
        if self._fh:
            self._fh.write(json.dumps(snap) + "\n")
            self._fh.flush()
        return snap

    def summary(self) -> Dict[str, float]:
        return self.snapshot()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
