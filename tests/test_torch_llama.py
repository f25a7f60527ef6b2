"""Port parity: quanta_tpu_torch.models.llama against quanta_tpu's.

The JAX package makes the parameters (from a seed) and quantizes them;
``interop.from_jax_params`` hands the same numbers to the port. Tokens come
from numpy. In f32, logits differ only by the two frameworks' f32 rounding
(sin/cos/pow, summation order), so they are held to 1e-4; greedy tokens
must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import nn as jnn
from quanta_tpu.models import llama as jllama
from quanta_tpu_torch import interop
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.ops.int4c import Int4cWeight

JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.PRNGKey(0), JCFG)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (b, s), dtype=np.int32)


def test_config_presets_match():
    for name in ("tiny", "tinyllama_1b", "llama2_7b", "llama2_13b"):
        j, t = getattr(jllama.LlamaConfig, name)(), getattr(tllama.LlamaConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
                  "norm_eps", "rope_theta", "max_seq_len", "tie_embeddings", "head_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.dtype == torch.bfloat16


def test_init_params_same_tree_shapes():
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig.tiny())
    tp = tllama.init_params(torch.Generator().manual_seed(0), tllama.LlamaConfig.tiny())
    jl, jt = jax.tree_util.tree_flatten_with_path(jp)
    flat_t = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            flat_t[path] = t

    walk(tp, ())
    assert len(jl) == len(flat_t)
    for path, leaf in jl:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        assert tuple(flat_t[key].shape) == leaf.shape
        assert flat_t[key].dtype == torch.bfloat16


def test_forward_no_cache_matches_jax(jparams):
    toks = _tokens(2, 12)
    jl, _ = jllama.forward(jparams, jnp.asarray(toks), JCFG)
    tl, _ = tllama.forward(interop.from_jax_params(jparams), torch.from_numpy(toks), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_cached_prefill_and_decode_match_jax(jparams):
    toks = _tokens(2, 9, seed=1)
    tp = interop.from_jax_params(jparams)
    jc = jllama.init_cache(JCFG, 2, max_len=16)
    tc = tllama.init_cache(TCFG, 2, max_len=16)
    jl, jc = jllama.forward(jparams, jnp.asarray(toks[:, :6]), JCFG, cache=jc)
    tl, tc = tllama.forward(tp, torch.from_numpy(toks[:, :6]), TCFG, cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(6, 9):  # one token at a time through the cache
        jl, jc = jllama.forward(jparams, jnp.asarray(toks[:, i:i + 1]), JCFG, cache=jc)
        tl, tc = tllama.forward(tp, torch.from_numpy(toks[:, i:i + 1]), TCFG, cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    # and the cached path agrees with the uncached one
    full, _ = tllama.forward(tp, torch.from_numpy(toks), TCFG)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, -1].numpy(), **TOL)


def test_per_row_cache_positions(jparams):
    """Rows at different positions write and attend at their own slots."""
    tp = interop.from_jax_params(jparams)
    toks = _tokens(2, 5, seed=2)
    jc = jllama.init_cache(JCFG, 2, max_len=8)
    jc["pos"] = jnp.asarray([0, 3], jnp.int32)
    tc = tllama.init_cache(TCFG, 2, max_len=8)
    tc["pos"] = torch.tensor([0, 3], dtype=torch.int32)
    jl, jc = jllama.forward(jparams, jnp.asarray(toks[:, :2]), JCFG, cache=jc)
    tl, tc = tllama.forward(tp, torch.from_numpy(toks[:, :2]), TCFG, cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)


@pytest.mark.parametrize("mode", ["nf4a", "int4c"])
def test_quantized_forward_matches_jax(jparams, mode):
    jq = jnn.quantize_params(jparams, mode=mode, block_size=64, min_size=1024)
    tq = interop.from_jax_params(jq)
    leaf = tq["layers"][0]["w_gate"]
    assert isinstance(leaf, Int4cWeight if mode == "int4c" else QuantizedTensor)
    toks = _tokens(2, 10, seed=3)
    jl, _ = jllama.forward(jq, jnp.asarray(toks), JCFG, use_kernel=True, interpret=True)
    tl, _ = tllama.forward(tq, torch.from_numpy(toks), TCFG)
    # int4c row-quantizes activations: a value within f32 rounding of a
    # rounding boundary may take the neighbouring int8 code, hence 1e-3
    tol = TOL if mode == "nf4a" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


@pytest.mark.parametrize("mode", [None, "nf4a"])
def test_greedy_decode_tokens_identical(jparams, mode):
    params = jparams if mode is None else jnn.quantize_params(jparams, mode=mode,
                                                             min_size=1024)
    prompt = _tokens(3, 7, seed=4)
    jout = jllama.greedy_decode(params, jnp.asarray(prompt), JCFG, max_new_tokens=6,
                                use_kernel=mode is not None, interpret=mode is not None)
    tout = tllama.greedy_decode(interop.from_jax_params(params), torch.from_numpy(prompt),
                                TCFG, max_new_tokens=6)
    assert tout.shape == (3, 13)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_use_flash_raises(jparams):
    with pytest.raises(NotImplementedError, match="flash"):
        tllama.forward(interop.from_jax_params(jparams), torch.zeros((1, 4), dtype=torch.int32),
                       TCFG, use_flash=True)


def test_from_jax_params_bf16_tree():
    jp = jllama.init_params(jax.random.PRNGKey(1), jllama.LlamaConfig.tiny())
    jq = jnn.quantize_params(jp, mode="nf4", min_size=1024)
    tp = interop.from_jax_params(jq)
    emb = tp["tok_emb"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(), np.asarray(jp["tok_emb"].astype(jnp.float32)))
    q = tp["layers"][1]["wo"]
    jqq = jq["layers"][1]["wo"]
    assert q.dtype == torch.bfloat16 and q.shape == jqq.shape and q.packed == "split_k"
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jqq.codes))
    # bf16 model end to end on the port's plain path: finite logits
    logits, _ = tllama.forward(tp, torch.from_numpy(_tokens(1, 4)), tllama.LlamaConfig.tiny())
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
