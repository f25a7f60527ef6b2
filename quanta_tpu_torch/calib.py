"""Activation calibration: stats collection, range reduction, fake-quant.

Port of ``quanta_tpu/calib.py``:

  - ``add_taps(params)`` wraps each 2-D weight leaf in a ``TapWeight``
    carrying its tree path; ``nn.linear`` sees the wrapper and, under
    ``taping``, records statistics of its input activation
    (``tap_record``);
  - ``collect_stats`` runs the model forward eagerly under
    ``torch.inference_mode()``, twice over the same batches, as any honest
    histogram calibrator does: pass 1 finds (min, max, per-feature absmax),
    pass 2 fills 2048-bin histograms over the fixed pass-1 range. The
    statistics are computed and merged on the device; each pass reads them
    back once, in one copy, not once per linear;
  - ``reduce_range`` turns the statistics into a quantization range
    (minmax / percentile / entropy: the numpy of the JAX module, copied);
  - ``ActQuantWeight`` wraps any weight leaf with a calibrated (lo, hi), so
    ``linear`` fake-quantizes the incoming activation (``fake_quant``) before
    the matmul; ``apply_activation_quant`` wraps the leaves of a tree.

Consumers: LLM.int8 outlier selection (``colmax`` feeds
``quantize_int8_weight(calib_colmax=...)``), W8A8 through ``ptq``, and
``weight_clip_range`` (the same reductions over a weight's own values).
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# Histogram resolution. Must be >> the largest quant level count (256 for
# 8-bit) or entropy calibration degenerates (rebinning N bins to N levels
# is the identity, KL == 0 at zero trim); 2048 gives 8x oversampling at
# 8-bit.
_NBINS = 2048


# ------------------------------------------------------------- tap wrapper


@dataclasses.dataclass
class TapWeight:
    """A weight leaf instrumented to record its input-activation stats."""

    w: object
    name: str = ""


class _TapState(threading.local):
    def __init__(self):
        self.active = False
        self.phase = "minmax"
        self.bounds: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.buf: Dict[str, Dict[str, torch.Tensor]] = {}


_tap = _TapState()


@contextmanager
def taping(phase: str = "minmax", bounds=None):
    """Activate stat recording for the duration of one forward. ``bounds``
    ({name: (lo, hi)} as f32 0-dim tensors on the activations' device)
    fixes each histogram's range in the "hist" phase."""
    _tap.active, _tap.phase = True, phase
    _tap.bounds, _tap.buf = bounds or {}, {}
    try:
        yield _tap.buf
    finally:
        _tap.active = False


def tap_record(name: str, x: torch.Tensor) -> None:
    """Called by nn.linear when it hits a TapWeight under an active tap.
    Everything stays on x's device; nothing is read back here."""
    if not _tap.active:
        return
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    rec = {"amin": x2.amin(), "amax": x2.amax(), "colmax": x2.abs().amax(dim=0)}
    if _tap.phase == "hist":
        lo, hi = _tap.bounds[name]
        width = torch.clamp(hi - lo, min=1e-12)
        # truncation toward zero, as the JAX module's astype(int32)
        idx = torch.clamp(((x2 - lo) / width * _NBINS).to(torch.int32), 0, _NBINS - 1)
        rec["hist"] = torch.bincount(idx.reshape(-1), minlength=_NBINS)
    prev = _tap.buf.get(name)
    if prev is not None:  # same weight used twice in one forward: merge
        rec["amin"] = torch.minimum(rec["amin"], prev["amin"])
        rec["amax"] = torch.maximum(rec["amax"], prev["amax"])
        rec["colmax"] = torch.maximum(rec["colmax"], prev["colmax"])
        if "hist" in rec:
            rec["hist"] = rec["hist"] + prev["hist"]
    _tap.buf[name] = rec


def _path_name(path) -> str:
    return "/".join(str(p) for p in path)


def default_tap_predicate(path, leaf) -> bool:
    name = _path_name(path)
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.ndim == 2
        and leaf.is_floating_point()
        and "emb" not in name
        and "wte" not in name
        and "wpe" not in name
    )


def _map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over a tree of dicts, lists and tuples
    (weight dataclasses are leaves)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def add_taps(params, predicate: Optional[Callable] = None):
    """Wrap matching weight leaves in TapWeight (names = tree paths)."""
    pred = predicate or default_tap_predicate

    def wrap(path, leaf):
        if pred(path, leaf):
            return TapWeight(w=leaf, name=_path_name(path))
        return leaf

    return _map_with_path(wrap, params)


# -------------------------------------------------------- stats collection


@dataclasses.dataclass
class ActivationStats:
    """Merged calibration statistics for one layer input."""

    amin: float
    amax: float
    colmax: np.ndarray  # (K,) per-feature absmax
    hist: np.ndarray  # (_NBINS,) counts over [amin, amax]

    @property
    def edges(self) -> np.ndarray:
        return np.linspace(self.amin, self.amax, _NBINS + 1)


def _read_back(tensors: list) -> list:
    """One device-to-host copy for a list of same-dtype tensors."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


def collect_stats(
    forward: Callable, params, batches: Iterable, *, histogram: bool = True
) -> Dict[str, ActivationStats]:
    """Run ``forward(tapped_params, batch)`` over calibration batches and
    return merged per-layer activation statistics.

    ``forward`` must call quanta_tpu_torch.nn.linear for its projections
    (any model in quanta_tpu_torch.models qualifies). Two eager passes over
    the same batches under ``torch.inference_mode()``.
    """
    tapped = add_taps(params)
    batches = list(batches)

    merged: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.inference_mode():
        for batch in batches:
            with taping("minmax") as buf:
                forward(tapped, batch)
            for name, rec in buf.items():
                m = merged.get(name)
                if m is None:
                    merged[name] = dict(rec)
                else:
                    m["amin"] = torch.minimum(m["amin"], rec["amin"])
                    m["amax"] = torch.maximum(m["amax"], rec["amax"])
                    m["colmax"] = torch.maximum(m["colmax"], rec["colmax"])
    names = list(merged)
    host = _read_back([merged[n][f] for n in names for f in ("amin", "amax", "colmax")])
    stats = {n: {"amin": host[3 * i], "amax": host[3 * i + 1], "colmax": host[3 * i + 2]}
             for i, n in enumerate(names)}

    hists = {n: np.zeros(_NBINS, np.int64) for n in names}
    if histogram and names:
        bounds = {n: (torch.tensor(float(s["amin"]), dtype=torch.float32,
                                   device=merged[n]["amin"].device),
                      torch.tensor(float(s["amax"]), dtype=torch.float32,
                                   device=merged[n]["amax"].device))
                  for n, s in stats.items()}
        totals: Dict[str, torch.Tensor] = {}
        with torch.inference_mode():
            for batch in batches:
                with taping("hist", bounds) as buf:
                    forward(tapped, batch)
                for name, rec in buf.items():
                    totals[name] = rec["hist"] if name not in totals else totals[name] + rec["hist"]
        for name, h in zip(totals, _read_back(list(totals.values()))):
            hists[name] += h.astype(np.int64)

    return {
        n: ActivationStats(
            amin=float(s["amin"]),
            amax=float(s["amax"]),
            colmax=np.asarray(s["colmax"]),
            hist=hists[n],
        )
        for n, s in stats.items()
    }


# --------------------------------------------------------- range reduction


def _percentile_range(
    hist: np.ndarray, edges: np.ndarray, lo_pct: float, hi_pct: float
) -> Tuple[float, float]:
    cdf = np.cumsum(hist) / max(hist.sum(), 1)
    lo_idx = int(np.searchsorted(cdf, lo_pct / 100.0))
    hi_idx = int(np.searchsorted(cdf, hi_pct / 100.0))
    hi_idx = max(hi_idx, lo_idx + 1)
    return float(edges[lo_idx]), float(edges[min(hi_idx + 1, len(edges) - 1)])


def _entropy_range(
    hist: np.ndarray, edges: np.ndarray, bits: int
) -> Tuple[float, float]:
    """KL-divergence-minimizing clip threshold (the TensorRT algorithm).

    Works on the |x| histogram (signed bins folded about zero), with the
    left edge pinned at 0: candidate thresholds T sweep the right edge
    only, clamped-out mass folds into the last kept bin, and each
    candidate's reference distribution is compared against itself
    re-binned to 2**bits levels. Returns the symmetric range (-T, T)
    intersected with the observed [amin, amax].
    """
    levels = 2**bits
    total = int(hist.sum())
    if total == 0 or len(hist) < 4 * levels:  # too coarse: degenerate
        return float(edges[0]), float(edges[-1])

    # fold the signed histogram about zero into an |x| histogram at full
    # bin resolution: the KL sweep needs several histogram bins per
    # quantization level to discriminate
    centers = (edges[:-1] + edges[1:]) / 2
    abs_max = max(abs(float(edges[0])), abs(float(edges[-1])))
    nabs = len(hist)
    abs_idx = np.minimum(
        (np.abs(centers) / abs_max * nabs).astype(int), nabs - 1
    )
    ahist = np.zeros(nabs, np.float64)
    np.add.at(ahist, abs_idx, hist.astype(np.float64))
    awidth = abs_max / nabs

    best_i, best_kl = nabs, np.inf
    # start where quantization actually smears (>= 2 bins a level): at
    # i == levels each level maps to exactly one bin, q == p and KL == 0
    # identically, a degenerate argmin
    for i in range(2 * levels, nabs + 1, 4):
        p = ahist[:i].copy()
        p[-1] += ahist[i:].sum()  # clamp outliers into the last kept bin
        splits = np.array_split(p, levels)
        q = np.concatenate(
            [np.full(len(s), s.sum() / max(len(s), 1)) for s in splits]
        )
        mask = p > 0
        pp = p[mask] / p.sum()
        qq = np.maximum(q[mask], 1e-12)
        qq = qq / qq.sum()
        kl = float(np.sum(pp * np.log(pp / qq)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    t = best_i * awidth
    return max(-t, float(edges[0])), min(t, float(edges[-1]))


def reduce_range(
    stats: ActivationStats, method: str = "minmax", bits: int = 8,
    percentile: Tuple[float, float] = (0.1, 99.9),
) -> Tuple[float, float]:
    """Reduce collected stats to a quantization range (lo, hi).

    percentile: (lo, hi) clip percentiles for method="percentile"
    (QuantConfig.percentile), model-dependent; the default keeps 99.8% of
    the activation mass.
    """
    if method == "minmax":
        return stats.amin, stats.amax
    if method == "percentile":
        return _percentile_range(stats.hist, stats.edges, *percentile)
    if method == "entropy":
        return _entropy_range(stats.hist, stats.edges, bits)
    raise ValueError(f"unknown calibration method {method!r}")


def weight_clip_range(
    w: torch.Tensor, method: str = "minmax", bits: int = 8
) -> Tuple[float, float]:
    """Apply a calibration reduction to a weight's own distribution."""
    wf = w.detach().to(torch.float32).cpu().numpy().ravel()
    lo, hi = float(wf.min()), float(wf.max())
    if method == "minmax":
        return lo, hi
    hist, _ = np.histogram(wf, bins=_NBINS, range=(lo, hi))
    st = ActivationStats(amin=lo, amax=hi, colmax=np.zeros(1), hist=hist)
    return reduce_range(st, method, bits)


# ------------------------------------------------------ activation quant


@dataclasses.dataclass
class ActQuantWeight:
    """Wraps any weight leaf; fake-quantizes the incoming activation to
    ``bits`` over the calibrated range before the matmul."""

    w: object  # torch.Tensor | QuantizedTensor | Int8Weight | LoRAWeight
    lo: torch.Tensor  # f32 0-dim
    hi: torch.Tensor  # f32 0-dim
    bits: int = 8


def fake_quant(x: torch.Tensor, lo, hi, bits: int) -> torch.Tensor:
    """Affine fake-quant of activations over [lo, hi]. lo and hi are f32
    0-dim tensors on x's device; every division is by a tensor, so CUDA
    divides as the CPU does (it multiplies by the reciprocal of a Python
    scalar)."""
    qmax = 2**bits - 1
    lo = torch.clamp(lo, max=0.0)  # range must include 0 (exact zero point)
    hi = torch.clamp(hi, min=1e-12)
    scale = (hi - lo) / torch.full_like(hi, float(qmax))
    q = torch.clamp(torch.round((x.to(torch.float32) - lo) / scale), 0, qmax)
    return (q * scale + lo).to(x.dtype)


def tree_device(tree) -> torch.device:
    """The device of the first tensor in a parameter tree (dicts, lists and
    weight dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        children = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    elif dataclasses.is_dataclass(tree):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        children = []
    for child in children:
        try:
            return tree_device(child)
        except ValueError:
            continue
    raise ValueError("no tensor in the parameter tree")


def apply_activation_quant(
    params,
    ranges: Dict[str, Tuple[float, float]],
    *,
    bits: int = 8,
):
    """Wrap weight leaves named in ``ranges`` with ActQuantWeight."""

    def wrap(path, leaf):
        name = _path_name(path)
        if name in ranges:
            lo, hi = ranges[name]
            dev = tree_device(leaf)
            return ActQuantWeight(
                w=leaf,
                lo=torch.tensor(lo, dtype=torch.float32, device=dev),
                hi=torch.tensor(hi, dtype=torch.float32, device=dev),
                bits=bits,
            )
        return leaf

    return _map_with_path(wrap, params)
