"""Port parity: the whole-tree maps over weight wrappers, against quanta_tpu's.

JAX's tree maps walk into the weight wrappers it registers as pytrees:
``LoRAWeight`` (``nn/lora.py``), ``TapWeight`` and ``ActQuantWeight``
(``calib.py``). ``nn.dequantize_params``, ``nn.quantize_params`` and
``ptq.quantize_model`` of the port must do the same, with the same paths
(the base of the LoRAWeight at ``layers/0/wq`` is ``layers/0/wq/base``).
Both trees are built from the same numpy arrays, in f32.

Tolerances: codes, scales and zero points bit for bit; dense weights
equal (the same f32 products). The one deliberate divergence: JAX also
quantizes a LoRAWeight's adapters once they reach ``min_size``; the port
leaves them as they are (they are the trainable leaves), and
``test_lora_adapters_stay_dense`` pins both sides of that. One fault the
port shares with the reference, a W8A8 rule on a LoRAWeight's base that
makes no ActQuantWeight, is pinned by
``test_w8a8_rule_on_lora_base_is_dropped_on_both_sides``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import calib as jcalib
from quanta_tpu import nn as jnn
from quanta_tpu import ptq as jptq
from quanta_tpu.state import config as jconfig
from quanta_tpu_torch import calib as tcalib
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch import ptq as tptq
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.state import config as tconfig

K, N = 256, 128


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class _Side:
    """One framework's constructors, so a test builds both trees alike."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.nn = jnn if jax_side else tnn
        self.calib = jcalib if jax_side else tcalib
        self.ptq = jptq if jax_side else tptq
        self.config = jconfig if jax_side else tconfig

    def array(self, a):
        return jnp.asarray(a) if self.jax else torch.from_numpy(a.copy())

    def scalar(self, v):
        return jnp.float32(v) if self.jax else torch.tensor(v, dtype=torch.float32)

    def weight(self, seed, fmt=None):
        w = self.array(_rand((K, N), seed))
        return w if fmt is None else self.nn.quantize_linear_weight(w, mode=fmt)

    def lora(self, base, rank=4, seed=1):
        return self.nn.LoRAWeight(base=base, lora_a=self.array(_rand((K, rank), seed)),
                                  lora_b=self.array(_rand((rank, N), seed + 1)))

    def tap(self, w):
        return self.calib.TapWeight(w=w, name="layers/0/wq")

    def actq(self, w):
        return self.calib.ActQuantWeight(w=w, lo=self.scalar(-1.5), hi=self.scalar(2.25))


SIDES = (_Side(True), _Side(False))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_leaf(t, j):
    """A port leaf against a JAX leaf: type, codes/scales bit for bit, or
    equal dense values."""
    assert type(t).__name__ == type(j).__name__ or (
        isinstance(t, torch.Tensor) and hasattr(j, "dtype")), (type(t), type(j))
    if isinstance(t, torch.Tensor):
        np.testing.assert_array_equal(_np(t), _np(j))
        return
    for f in ("codes", "scale", "zero_point", "outlier_idx", "w_outlier"):
        tv, jv = getattr(t, f, None), getattr(j, f, None)
        assert (tv is None) == (jv is None), f
        if tv is not None:
            np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=f)


# ---------------------------------------------------------- dequantize_params


@pytest.mark.parametrize("wrap,fmt", [("tap", None), ("tap", "nf4"), ("actq", "int8"),
                                      ("actq", "nf4")])
def test_dequantize_unwraps_calibration_leaves(wrap, fmt):
    """JAX's dequantize_params returns the dense weight under a TapWeight or
    an ActQuantWeight (``quanta_tpu/nn/linear.py:322-324``)."""
    j, t = (s.nn.dequantize_params({"layers": [{"wq": getattr(s, wrap)(s.weight(3, fmt))}]})
            for s in SIDES)
    jw, tw = j["layers"][0]["wq"], t["layers"][0]["wq"]
    assert isinstance(tw, torch.Tensor) and tw.shape == (K, N)
    _same_leaf(tw, jw)


@pytest.mark.parametrize("fmt", ["nf4", "int8", "llm_int8"])
def test_dequantize_lora_gives_dense_base(fmt):
    j, t = (s.nn.dequantize_params({"wq": s.lora(s.weight(4, fmt))}) for s in SIDES)
    assert type(t["wq"]).__name__ == type(j["wq"]).__name__ == "LoRAWeight"
    assert isinstance(t["wq"].base, torch.Tensor)
    for f in ("base", "lora_a", "lora_b"):
        _same_leaf(getattr(t["wq"], f), getattr(j["wq"], f))


# ----------------------------------------------- quantize_params / quantize_model


def _wrapped_tree(s):
    """A LoRAWeight, a TapWeight and an ActQuantWeight over dense weights."""
    return {"tok_emb": s.weight(5),
            "layers": [{"wq": s.lora(s.weight(6)), "wk": s.tap(s.weight(7)),
                        "wv": s.actq(s.weight(8))}]}


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
def test_quantize_params_walks_into_wrappers(fmt):
    j, t = (s.nn.quantize_params(_wrapped_tree(s), mode=fmt) for s in SIDES)
    jl, tl = j["layers"][0], t["layers"][0]
    assert isinstance(tl["wq"].base, QuantizedTensor)
    _same_leaf(tl["wq"].base, jl["wq"].base)
    for name in ("wk", "wv"):  # the wrapper stays, its weight is quantized
        assert type(tl[name]).__name__ == type(jl[name]).__name__
        _same_leaf(tl[name].w, jl[name].w)
    _same_leaf(tl["wv"].lo, jl["wv"].lo)
    _same_leaf(t["tok_emb"], j["tok_emb"])  # embeddings stay dense


def test_quantize_model_rule_on_lora_base():
    """A ConfigTree rule sees the base at ``layers/0/wq/base``."""
    outs = []
    for s in SIDES:
        rules = (s.config.ConfigTree(s.config.QuantConfig.from_mode("int8"))
                 .config_layer(r"layers/0/wq/base", scheme="codebook", codebook="nf8")
                 .config_tensor("layers/0/wk/w", block_size=128))
        outs.append(s.ptq.quantize_model(_wrapped_tree(s), rules, strict_rules=True))
    j, t = outs
    jl, tl = j["layers"][0], t["layers"][0]
    assert (tl["wq"].base.codebook, tl["wk"].w.block_size) == ("nf8", 128)
    _same_leaf(tl["wq"].base, jl["wq"].base)
    _same_leaf(tl["wk"].w, jl["wk"].w)
    _same_leaf(tl["wv"].w, jl["wv"].w)


def test_tree_paths_match_jax():
    """The paths the predicate sees: JAX's, less the adapters."""
    seen = {}
    for s in SIDES:
        names = seen.setdefault(s.jax, set())

        def pred(path, leaf, names=names, s=s):
            names.add((s.calib._path_name(path), tuple(leaf.shape)))
            return False

        s.nn.quantize_params(_wrapped_tree(s), predicate=pred)
    adapters = {n for n in seen[True] if n[0].endswith(("/lora_a", "/lora_b"))}
    assert len(adapters) == 2 and ("layers/0/wq/base", (K, N)) in seen[False]
    assert seen[False] == seen[True] - adapters


@pytest.mark.parametrize("how", ["quantize_params", "quantize_model"])
def test_lora_adapters_stay_dense(how):
    """The deliberate divergence: adapters of min_size elements (rank 16 x
    256) stay dense in the port, where JAX quantizes them."""
    outs = []
    for s in SIDES:
        tree = {"wq": s.lora(s.weight(9), rank=16)}
        outs.append(s.nn.quantize_params(tree, mode="nf4") if how == "quantize_params"
                    else s.ptq.quantize_model(tree))
        if not s.jax:
            adapters = (tree["wq"].lora_a, tree["wq"].lora_b)
    j, t = outs
    _same_leaf(t["wq"].base, j["wq"].base)
    assert t["wq"].lora_a is adapters[0] and t["wq"].lora_b is adapters[1]
    assert type(j["wq"].lora_a).__name__ == "QuantizedTensor"


def test_w8a8_rule_on_lora_base_is_dropped_on_both_sides():
    """A known fault shared with the reference: ``quantize_model`` quantizes a
    LoRAWeight's base under a W8A8 rule and reduces its activation range at
    ``layers/0/wq/base``, but ``apply_activation_quant`` stops at the
    LoRAWeight (path ``layers/0/wq``), so no ActQuantWeight is made and the
    range goes unused. The plain ``wv`` leaf under the same rule is wrapped."""
    colmax = np.abs(_rand((K,), 11)) + 0.5
    hist = np.ones(256, np.float64)
    outs = []
    for s in SIDES:
        stats = {name: s.calib.ActivationStats(amin=-2.0, amax=3.0, colmax=colmax.copy(),
                                               hist=hist.copy())
                 for name in ("layers/0/wq/base", "layers/0/wv")}
        rules = (s.config.ConfigTree(s.config.QuantConfig.from_mode("int8"))
                 .config_layer(r"layers/0/w[qv]", weights_only=False))
        tree = {"layers": [{"wq": s.lora(s.weight(12)), "wv": s.weight(13)}]}
        outs.append(s.ptq.quantize_model(tree, rules, stats=stats, strict_rules=True))
    j, t = outs
    jl, tl = j["layers"][0], t["layers"][0]
    for side in (jl, tl):
        assert type(side["wq"]).__name__ == "LoRAWeight"
        assert type(side["wq"].base).__name__ == "QuantizedTensor"
        assert type(side["wv"]).__name__ == "ActQuantWeight"
    _same_leaf(tl["wq"].base, jl["wq"].base)
    _same_leaf(tl["wv"].w, jl["wv"].w)
    for f in ("lo", "hi"):
        _same_leaf(getattr(tl["wv"], f), getattr(jl["wv"], f))
