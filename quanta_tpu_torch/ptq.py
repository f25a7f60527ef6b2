"""Whole-model post-training quantization driven by a ConfigTree.

Port of ``quanta_tpu/ptq.py``: collect activation statistics, quantize
each weight under its resolved config, install activation fake-quant. The
model is a parameter tree and a forward function; quantization is a tree
transform.

Example::

    tree = (ConfigTree(QuantConfig.from_mode("int8"))
            .config_layer(r"layers/0/", scheme="codebook", codebook="nf8")
            .config_layer(r"w_down", scheme="affine", weights_only=False,
                          calibration="entropy"))
    fwd = lambda p, batch: llama.forward(p, batch, cfg)[0]
    qparams = quantize_model(params, tree, forward=fwd, calib_batches=batches)
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, Optional

import torch

from quanta_tpu_torch import calib
from quanta_tpu_torch.nn.linear import quantize_linear_weight
from quanta_tpu_torch.state.config import ConfigTree, QuantConfig


def config_to_mode(cfg: QuantConfig) -> str:
    """Map a QuantConfig onto a matmul weight format / weight mode."""
    if cfg.scheme == "llm_int8":
        return "llm_int8"
    if cfg.scheme == "int4c":
        return "int4c"
    if cfg.scheme == "codebook":
        return cfg.codebook or {4: "nf4", 8: "nf8"}[cfg.bits]
    if cfg.scheme == "symmetric":
        return {4: "int4", 8: "int8"}[cfg.bits]
    if cfg.scheme == "affine":
        return {4: "int4a", 8: "int8a"}[cfg.bits]
    raise ValueError(f"scheme {cfg.scheme!r} has no fused matmul layout")


def quantize_model(
    params,
    tree: Optional[ConfigTree] = None,
    *,
    forward: Optional[Callable] = None,
    calib_batches: Optional[Iterable] = None,
    stats: Optional[Dict[str, calib.ActivationStats]] = None,
    min_size: int = 4096,
    predicate: Optional[Callable] = None,
    strict_rules: bool = False,
):
    """Quantize a whole parameter tree under three-tier config resolution.

    - ``tree`` resolves a QuantConfig per tree path (global default ->
      regex layer rules -> per-tensor overrides, state/config.py);
    - when ``calib_batches`` is given, ``forward(params, batch)`` runs over
      them first to collect activation statistics (calib.collect_stats);
    - leaves whose resolved config says ``weights_only=False`` get their
      input activations fake-quantized over the range reduced from the
      stats by the configured calibration method;
    - ``scheme="llm_int8"`` leaves use calibrated per-feature activation
      maxima for outlier selection when stats are available;
    - layer rules that match zero quantizable tensors are reported: a
      warning by default, ValueError with ``strict_rules=True`` (tree
      paths are '/'-joined, ``layers/0/wq``, so a dotted regex like
      ``layers\\.0\\.`` silently matches nothing otherwise);
    - the map walks into a ``LoRAWeight`` and quantizes its dense base under
      the path ``<path>/base``, as JAX's does; unlike JAX's, it leaves the
      adapters ``lora_a``/``lora_b`` as they are (``calib._map_with_path``).
    """
    tree = tree or ConfigTree()
    if calib_batches is not None:
        if forward is None:
            raise ValueError("calib_batches requires forward=")
        stats = calib.collect_stats(forward, params, calib_batches)

    pred = predicate or (lambda path, leaf: calib.default_tap_predicate(path, leaf)
                         and leaf.numel() >= min_size)

    act_ranges: Dict[str, tuple] = {}
    rule_counts: Dict[int, int] = {}

    def maybe_quant(path, leaf):
        name = calib._path_name(path)
        if not pred(path, leaf):
            return leaf
        cfg = tree.resolve(name, counts=rule_counts)
        mode = config_to_mode(cfg)
        colmax = None
        if stats is not None and name in stats:
            colmax = torch.as_tensor(stats[name].colmax, device=leaf.device)
        qleaf = quantize_linear_weight(leaf, mode=mode, block_size=cfg.block_size,
                                       calib_colmax=colmax)
        if not cfg.weights_only:
            if stats is None or name not in stats:
                raise ValueError(f"{name}: weights_only=False needs activation stats; "
                                 "pass calib_batches= or stats=")
            act_ranges[name] = calib.reduce_range(stats[name], cfg.calibration, bits=8,
                                                  percentile=cfg.percentile)
        return qleaf

    out = calib._map_with_path(maybe_quant, params)
    dead = [pattern for i, (pattern, _) in enumerate(tree.layer_rules)
            if rule_counts.get(i, 0) == 0]
    if dead:
        msg = (f"config layer rules matched zero quantizable tensors: {dead}. "
               "Tree paths are '/'-joined (e.g. 'layers/0/wq'); check the regex "
               "against quanta_tpu_torch.calib._path_name output.")
        if strict_rules:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    if act_ranges:
        out = calib.apply_activation_quant(out, act_ranges, bits=8)
    return out
