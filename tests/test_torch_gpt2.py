"""Port parity: models.gpt2 and the GPT-2 serving path against
quanta_tpu's, at a tiny GPT-2 in f32.

The JAX package makes the parameters (and quantizes them);
``interop.from_jax_params`` hands the same numbers to the port; tokens
come from numpy. Tolerances:
  - f32 logits, cached or not, dense or quantized (nf4a, llm_int8, int4c
    through the plain routes): max |difference| within 1e-5 of max |JAX|
    (the frameworks' f32 rounding and summation order; measured ~1e-7);
  - greedy tokens, the engine's outputs and the runner's argmax: equal;
  - parameter trees handed across: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import nn as jnn
from quanta_tpu.models import gpt2 as jgpt2
from quanta_tpu.serve import kvcache as jkv
from quanta_tpu.serve import runner as jrunner
from quanta_tpu_torch import interop
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.models import gpt2 as tgpt2
from quanta_tpu_torch.ops.int4c import Int4cWeight
from quanta_tpu_torch.ops.int8mm import Int8Weight
from quanta_tpu_torch.serve import Engine, Request
from quanta_tpu_torch.serve import kvcache as tkv
from quanta_tpu_torch.serve import runner as trunner

JCFG = jgpt2.GPT2Config.tiny(max_seq_len=96)
TCFG = tgpt2.GPT2Config.tiny(max_seq_len=96)
REL = 1e-5
FORMATS = ("nf4a", "llm_int8", "int4c")


@pytest.fixture(scope="module")
def jparams():
    return jgpt2.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.from_jax_params(jparams)


@pytest.fixture(scope="module")
def jquant(jparams):
    return {fmt: jnn.quantize_params(jparams, mode=fmt, block_size=64, min_size=1024)
            for fmt in FORMATS}


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape, dtype=np.int32)


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_config_matches_jax():
    for j, t in ((JCFG, TCFG), (jgpt2.GPT2Config.small(), tgpt2.GPT2Config.small())):
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "max_seq_len", "norm_eps",
                  "head_dim", "n_kv_heads", "hidden_dim"):
            assert getattr(t, f) == getattr(j, f), f
    assert TCFG.dtype == torch.float32


def test_init_params_shapes_match_jax(jparams):
    tp = tgpt2.init_params(torch.Generator().manual_seed(0), TCFG)
    jl, tl = jax.tree_util.tree_leaves_with_path(jparams), []

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            tl.append((path, tuple(node.shape), node.dtype))
    walk(tp)
    want = sorted((tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), a.shape)
                  for p, a in jl)
    assert want == sorted((p, s) for p, s, _ in tl)
    assert all(d == torch.float32 for *_, d in tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {"w": jnp.asarray(w, jd), "b": jnp.asarray(b, jd)}
    tp = {"w": torch.from_numpy(w).to(td), "b": torch.from_numpy(b).to(td)}
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    rel = REL if dtype == "float32" else 2.0 ** -7  # one bf16 ulp
    _close(tgpt2.layer_norm(tx, tp, 1e-5).float().numpy(),
           np.asarray(jgpt2.layer_norm(jx, jp, 1e-5), np.float32), rel)
    _close(tgpt2._gelu_new(tx).float().numpy(), np.asarray(jgpt2._gelu_new(jx), np.float32),
           rel)


def test_forward_without_cache_matches_jax(jparams, tparams):
    toks = _tokens((2, 11))
    jl, _ = jgpt2.forward(jparams, jnp.asarray(toks), JCFG)
    tl, cache = tgpt2.forward(tparams, torch.from_numpy(toks), TCFG)
    assert cache is None and tl.dtype == torch.float32
    _close(tl.numpy(), jl)


def test_forward_with_cache_matches_jax(jparams, tparams):
    """Prefill 6 tokens into an 11-slot cache, then two single-token steps;
    rows at different positions (the second row starts 2 tokens later)."""
    toks = _tokens((2, 8), seed=2)
    jcache = jgpt2.init_cache(JCFG, 2, max_len=11)
    jcache["pos"] = jnp.asarray([0, 2], jnp.int32)
    tcache = tgpt2.init_cache(TCFG, 2, max_len=11)
    tcache["pos"] = torch.tensor([0, 2], dtype=torch.int32)
    for lo, hi in ((0, 6), (6, 7), (7, 8)):
        jl, jcache = jgpt2.forward(jparams, jnp.asarray(toks[:, lo:hi]), JCFG, cache=jcache)
        tl, tcache = tgpt2.forward(tparams, torch.from_numpy(toks[:, lo:hi]), TCFG,
                                   cache=tcache)
        _close(tl.numpy(), jl)
        assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    _close(tcache["k"].numpy(), jcache["k"])
    _close(tcache["v"].numpy(), jcache["v"])


def test_cached_steps_equal_the_full_forward(tparams):
    toks = torch.from_numpy(_tokens((1, 6), seed=3))
    full, _ = tgpt2.forward(tparams, toks, TCFG)
    cache = tgpt2.init_cache(TCFG, 1, max_len=8)
    _, cache = tgpt2.forward(tparams, toks[:, :4], TCFG, cache=cache)
    for i in (4, 5):
        step, cache = tgpt2.forward(tparams, toks[:, i:i + 1], TCFG, cache=cache)
        torch.testing.assert_close(step[:, 0], full[:, i], rtol=1e-4, atol=1e-4)


def test_greedy_decode_tokens_equal_jax(jparams, tparams):
    prompt = _tokens((3, 7), seed=4)
    want = np.asarray(jgpt2.greedy_decode(jparams, jnp.asarray(prompt), JCFG, max_new_tokens=10))
    got = tgpt2.greedy_decode(tparams, torch.from_numpy(prompt), TCFG, max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tgpt2.greedy_decode(tparams, got[:, :7], TCFG, max_new_tokens=0),
                       got[:, :7])


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_forward_matches_jax(jquant, fmt):
    """Every linear quantized (the tied head and the embeddings stay
    dense, as JAX's default predicate leaves them), through the plain
    routes on both sides."""
    jq = jquant[fmt]
    tq = interop.from_jax_params(jq)
    kind = {"nf4a": QuantizedTensor, "llm_int8": Int8Weight, "int4c": Int4cWeight}[fmt]
    lp = tq["layers"][0]
    assert all(isinstance(lp[n]["w"], kind) for n in ("attn_qkv", "attn_out", "mlp_fc",
                                                      "mlp_out"))
    assert isinstance(tq["wte"], torch.Tensor) and isinstance(tq["wpe"], torch.Tensor)
    toks = _tokens((2, 9), seed=5)
    jl, _ = jgpt2.forward(jq, jnp.asarray(toks), JCFG, use_kernel=False)
    tl, _ = tgpt2.forward(tq, torch.from_numpy(toks), TCFG, use_kernel=False)
    _close(tl.numpy(), jl)
    want = np.asarray(jgpt2.greedy_decode(jq, jnp.asarray(toks), JCFG, max_new_tokens=6,
                                          use_kernel=False))
    got = tgpt2.greedy_decode(tq, torch.from_numpy(toks), TCFG, max_new_tokens=6,
                              use_kernel=False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", (None,) + FORMATS)
def test_from_jax_params_takes_a_gpt2_tree(jparams, jquant, fmt):
    jtree = jparams if fmt is None else jquant[fmt]
    ttree = interop.from_jax_params(jtree)
    assert ttree.keys() == jtree.keys() and len(ttree["layers"]) == JCFG.n_layers
    jleaves = jax.tree_util.tree_leaves(jtree)

    def leaves(node):  # in JAX's order: dict keys sorted
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in leaves(node[k])]
        if isinstance(node, list):
            return [x for v in node for x in leaves(v)]
        if isinstance(node, torch.Tensor):
            return [node]
        return [getattr(node, f) for f in ("codes", "scale", "zero_point", "outlier_idx",
                                           "w_outlier") if getattr(node, f, None) is not None]
    tleaves = leaves(ttree)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        if j.dtype.name == "bfloat16":  # numpy has no bf16 of its own: compare in f32
            t, j = t.float(), j.astype(np.float32)
        np.testing.assert_array_equal(t.numpy(), j)


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("kv_quant", [False, True])
def test_runner_prefill_and_window_match_jax(jparams, tparams, kv_quant):
    """Prefill two prompts (padded to a 16-token bucket), write them into
    both pools, then one 4-step greedy window over both slots."""
    page, n_pages, k = 8, 10, 4
    prompts = [_tokens((n,), seed=6 + n) for n in (11, 5)]
    jpool = jkv.init_pool(JCFG, n_pages, page, kv_quant=kv_quant)
    tpool = tkv.init_pool(TCFG, n_pages, page, kv_quant=kv_quant)
    first = []
    for prompt, pages in zip(prompts, ([3, 5], [2, 0])):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, jk, jv = jrunner.prefill(jparams, jnp.asarray(toks), jnp.int32(len(prompt)), JCFG,
                                     arch="gpt2")
        tl, tk, tv = trunner.prefill(tparams, torch.from_numpy(toks), len(prompt), TCFG,
                                     arch="gpt2")
        _close(tl.numpy(), jl)
        _close(tk.numpy(), jk)
        jpool = jkv.write_prefill(jpool, jnp.asarray(pages, jnp.int32), jk, jv)
        tkv.write_prefill(tpool, torch.tensor(pages, dtype=torch.int32), tk, tv)
        first.append(int(jnp.argmax(jl)))
        assert int(tl.argmax()) == first[-1]
    table = np.asarray([[3, 5, 0], [2, 4, 0]], np.int32)
    positions = np.asarray([11, 5], np.int32)
    zeros = np.zeros((2,), np.int32)
    jt, jpos, _, _ = jrunner.decode_multi_step(
        jparams, jpool, jnp.asarray(table), jnp.asarray(positions), jnp.asarray(first, jnp.int32),
        jax.random.PRNGKey(0), jnp.zeros((2,), jnp.float32), jnp.asarray(zeros), JCFG, page, k,
        arch="gpt2")
    tt, tpos, _ = trunner.decode_multi_step(
        tparams, tpool, torch.from_numpy(table), torch.from_numpy(positions),
        torch.tensor(first, dtype=torch.int32), torch.Generator().manual_seed(0),
        torch.zeros(2), torch.zeros(2, dtype=torch.int32), TCFG, page, k, arch="gpt2")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def _greedy(params, prompt, n, use_kernel=None):
    return tgpt2.greedy_decode(params, torch.from_numpy(prompt)[None], TCFG, max_new_tokens=n,
                               use_kernel=use_kernel)[0, len(prompt):].tolist()


@pytest.mark.parametrize("fmt,kv_quant", [(None, False), (None, True), ("llm_int8", True)])
def test_engine_serves_gpt2(tparams, jquant, fmt, kv_quant):
    """The Engine serves GPT-2 through the same scheduler and paged KV
    (``arch="gpt2"``): more requests than slots, mixed prompt lengths; with
    a dense pool every output equals ``gpt2.greedy_decode``'s, with the
    int8 pool (whose windows read quantized K and V) the first token does
    and the run is the same through the kernel and plain routes."""
    params = tparams if fmt is None else interop.from_jax_params(jquant[fmt])
    prompts = [_tokens((n,), seed=10 + n) for n in (3, 9, 17, 5)]
    outs = {}
    for use_kernel in (None, False):
        eng = Engine(params, TCFG, n_slots=2, page_size=8, prefill_buckets=(8, 16, 32),
                     arch="gpt2", multi_step=4, kv_quant=kv_quant, use_kernel=use_kernel)
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        outs[use_kernel] = {r.uid: list(r.output) for r in done}
        assert eng.metrics()["admissions"] == len(prompts)
    assert outs[None] == outs[False] and len(outs[None]) == len(prompts)
    for uid, prompt in enumerate(prompts):
        want = _greedy(params, prompt, 8, use_kernel=False)
        if kv_quant:
            assert outs[None][uid][0] == want[0], f"request {uid}'s first token"
        else:
            assert outs[None][uid] == want, f"gpt2 request {uid} diverged"


def test_engine_refuses_an_unknown_arch(tparams):
    with pytest.raises(ValueError, match="unknown serving architecture"):
        Engine(tparams, TCFG, arch="gpt3")
