"""Port parity: quanta_tpu_torch.serve against quanta_tpu.serve, and the
port's engine against the port's greedy decode.

The JAX package makes the parameters and quantizes them;
``interop.from_jax_params`` hands the same numbers to the port. Prompts
and KV inputs come from numpy. The JAX engine itself is not driven here
(its tests are slow-marked for minutes of compiles); its scheduler cases
are ported against the port's ``greedy_decode`` instead.

Tolerances, with their reasons:
  - pool writes and gathers move values: bit-exact;
  - int8 KV codes: the port's one rule is JAX's kernel rule, bit-exact
    wherever the scales agree; XLA on the CPU turns the jitted
    absmax / 127 into a product with the reciprocal, so a scale may be
    one ulp off and its vector's codes one step. Against JAX's XLA rule
    (absmax / 127 + 1e-12, no clip) codes are within one step and scales
    within rtol 1e-5, except a zero vector's scale (1 here, 1e-12 there;
    codes 0 in both);
  - f32 logits and K/V of the runner, dense and llm_int8: rtol 1e-5 (the
    frameworks' f32 rounding and summation order). Greedy tokens are
    identical.
"""

import ctypes
import json
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import nn as jnn
from quanta_tpu.models import llama as jllama
from quanta_tpu.ops import quantize as jquantize
from quanta_tpu.serve import kvcache as jkv
from quanta_tpu.serve import runner as jrunner
from quanta_tpu_torch import interop
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch.benchmarks import serve_bench
from quanta_tpu_torch.metrics import MetricsRecorder, device_memory_stats
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import quantize as tquantize
from quanta_tpu_torch.serve import Engine, PageAllocator, Request, SamplingParams
from quanta_tpu_torch.serve import kvcache as tkv
from quanta_tpu_torch.serve import runner as trunner
from quanta_tpu_torch.serve.sampling import _sample_batch

JCFG = jllama.LlamaConfig.tiny(max_seq_len=96, dtype=jnp.float32)
TCFG = tllama.LlamaConfig.tiny(max_seq_len=96, dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.from_jax_params(jparams)


@pytest.fixture(scope="module")
def jquant(jparams):
    """The JAX package's quantized parameter trees per format."""
    return {fmt: jnn.quantize_params(jparams, mode=fmt, block_size=64, min_size=1024)
            for fmt in ("nf4", "llm_int8")}


@pytest.fixture(scope="module")
def tquant(jquant):
    """The port's parameter trees per format, converted from JAX's."""
    return {fmt: interop.from_jax_params(jp) for fmt, jp in jquant.items()}


def _prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, size=n).astype(np.int32) for n in lengths]


def _greedy(params, prompt, n):
    return tllama.greedy_decode(params, torch.from_numpy(prompt)[None], TCFG,
                                max_new_tokens=n)[0, len(prompt):].tolist()


def _serve(params, prompts, max_new, **kw):
    kw = {"n_slots": 2, "page_size": 8, "prefill_buckets": (16,), **kw}
    eng = Engine(params, TCFG, **kw)
    done = eng.run([Request(uid=i, prompt=p, max_new_tokens=max_new)
                    for i, p in enumerate(prompts)])
    return {r.uid: list(r.output) for r in done}, eng


def _assert_kv_codes(tc, ts, jc, js, *, exact_rule):
    """int8 KV codes and scales of the port against JAX's: ``exact_rule``
    (JAX's kernel rule) allows only the one-ulp scale of XLA's
    reciprocal; otherwise (JAX's XLA rule) codes within one step and
    scales within rtol 1e-5."""
    tc, jc = np.asarray(tc).astype(np.int32), np.asarray(jc).astype(np.int32)
    ts, js = np.asarray(ts, np.float32), np.asarray(js, np.float32)
    assert tc.shape == jc.shape and ts.shape == js.shape
    assert np.abs(tc - jc).max(initial=0) <= 1
    if exact_rule:
        ulps = np.abs(ts.view(np.int32).astype(np.int64) - js.view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= 1
        np.testing.assert_array_equal(tc[ulps == 0], jc[ulps == 0])
    else:
        # a zero vector's scale is 1 in the port and 1e-12 in XLA's rule;
        # both give codes 0
        live = js > 2e-12
        np.testing.assert_allclose(ts[live], js[live], rtol=1e-5)
        assert (tc[~live] == 0).all() and (jc[~live] == 0).all()


# ------------------------------------------------------------------ kvcache


def test_page_allocator():
    a = PageAllocator(8)  # page 0 reserved
    assert a.free_pages == 7
    p = a.alloc(3)
    assert len(set(p)) == 3 and all(0 < x < 8 for x in p)
    a.free(p)
    assert a.free_pages == 7
    with pytest.raises(MemoryError):
        a.alloc(8)
    with pytest.raises(ValueError):
        a.free([0])


def _kv_inputs(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 2).astype(np.float32)


def test_dense_pool_write_gather_matches_jax():
    page, n_pages = 8, 7
    L, nkv, hd = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    k_seq, v_seq = _kv_inputs(0, (L, 3 * page, nkv, hd)), _kv_inputs(1, (L, 3 * page, nkv, hd))
    pages = np.asarray([2, 5, 0], np.int32)  # the bucket's last page is padding
    jp = jkv.write_prefill(jkv.init_pool(JCFG, n_pages, page), jnp.asarray(pages),
                           jnp.asarray(k_seq), jnp.asarray(v_seq))
    tp = tkv.init_pool(TCFG, n_pages, page)
    assert tkv.write_prefill(tp, torch.from_numpy(pages), torch.from_numpy(k_seq),
                             torch.from_numpy(v_seq)) is tp  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    table = np.asarray([[2, 5, 0], [5, 2, 2]], np.int32)
    for layer in range(L):
        np.testing.assert_array_equal(
            tkv.gather_layer(tp["k"][layer], torch.from_numpy(table)).numpy(),
            np.asarray(jkv.gather_layer(jp["k"][layer], jnp.asarray(table))))
    # one token per slot at its own position, layer 1, in place
    table = np.asarray([[2, 5, 0], [3, 4, 6]], np.int32)
    positions = np.asarray([9, 20], np.int32)
    tok = _kv_inputs(2, (2, nkv, hd))
    jk = jkv.write_token_layer(jp["k"], 1, jnp.asarray(table), jnp.asarray(positions),
                               jnp.asarray(tok), page)
    tkv.write_token_layer(tp["k"], 1, torch.from_numpy(table), torch.from_numpy(positions),
                          torch.from_numpy(tok), page)
    np.testing.assert_array_equal(tp["k"].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp["k"][1, 5, 1].numpy(), tok[0])
    np.testing.assert_array_equal(tp["k"][1, 6, 4].numpy(), tok[1])
    # the same through one layer's pool, in place
    jv = jkv.write_token(jp["v"][0], jnp.asarray(table), jnp.asarray(positions),
                         jnp.asarray(tok), page)
    assert tkv.write_token(tp["v"][0], torch.from_numpy(table), torch.from_numpy(positions),
                           torch.from_numpy(tok), page).data_ptr() == tp["v"][0].data_ptr()
    np.testing.assert_array_equal(tp["v"][0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp["v"][0, 6, 4].numpy(), tok[1])


def test_int8_pool_write_gather_matches_jax():
    page, n_pages = 8, 6
    L, nkv, hd = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    k_seq, v_seq = _kv_inputs(3, (L, 2 * page, nkv, hd)), _kv_inputs(4, (L, 2 * page, nkv, hd))
    k_seq[:, 3] = 0.0  # zero vectors stay zero
    pages = np.asarray([4, 1], np.int32)
    jp = jkv.write_prefill(jkv.init_pool(JCFG, n_pages, page, kv_quant=True),
                           jnp.asarray(pages), jnp.asarray(k_seq), jnp.asarray(v_seq))
    tp = tkv.write_prefill(tkv.init_pool(TCFG, n_pages, page, kv_quant=True),
                           torch.from_numpy(pages), torch.from_numpy(k_seq),
                           torch.from_numpy(v_seq))
    assert tkv.is_quantized(tp) and tp["k"].dtype == torch.int8
    # JAX's write_prefill quantizes with its XLA rule on the CPU
    for name in ("k", "v"):
        _assert_kv_codes(tp[name][:, 1:].numpy(), tp[f"{name}_scale"][:, 1:].numpy(),
                         np.asarray(jp[name])[:, 1:], np.asarray(jp[f"{name}_scale"])[:, 1:],
                         exact_rule=False)
    # and its kernel rule, which is the port's
    jc, js = jkv.quantize_kv(jnp.asarray(k_seq), use_kernel=True)
    got = tkv.gather_all_layers(tp["k"], torch.from_numpy(pages[None]))[:, 0]
    got_s = tkv.gather_all_layers(tp["k_scale"], torch.from_numpy(pages[None]))[:, 0]
    _assert_kv_codes(got.numpy(), got_s.numpy(), np.asarray(jc), np.asarray(js),
                     exact_rule=True)
    assert (got[:, 3] == 0).all() and (got_s[:, 3] == 1.0).all()
    # gather and token writes of given codes and scales: bit-exact
    table = np.asarray([[4, 1], [1, 4]], np.int32)
    for layer in range(L):
        for name in ("k", "k_scale"):
            np.testing.assert_array_equal(
                tkv.gather_layer(tp[name][layer], torch.from_numpy(table)).numpy(),
                np.asarray(jkv.gather_layer(jnp.asarray(tp[name][layer].numpy()),
                                            jnp.asarray(table))))
    codes = np.random.default_rng(5).integers(-127, 128, (2, nkv, hd)).astype(np.int8)
    scales = np.abs(_kv_inputs(6, (2, nkv)))
    positions = np.asarray([12, 3], np.int32)
    for name, val in (("v", codes), ("v_scale", scales)):
        want = jkv.write_token_layer(jnp.asarray(tp[name].numpy()), 0, jnp.asarray(table),
                                     jnp.asarray(positions), jnp.asarray(val), page)
        tkv.write_token_layer(tp[name], 0, torch.from_numpy(table), torch.from_numpy(positions),
                              torch.from_numpy(val), page)
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(want))


def test_quantize_kv_matches_both_jax_rules():
    x = _kv_inputs(7, (64, 4, 64)) * 3
    x[5, 2] = 0.0
    tc, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.shape == (64, 4)
    kc, ks = jkv.quantize_kv(jnp.asarray(x), use_kernel=True)
    _assert_kv_codes(tc.numpy(), ts.numpy(), np.asarray(kc), np.asarray(ks), exact_rule=True)
    xc, xs = jkv.quantize_kv(jnp.asarray(x), use_kernel=False)
    _assert_kv_codes(tc.numpy(), ts.numpy(), np.asarray(xc), np.asarray(xs), exact_rule=False)
    back = tkv.dequantize_kv(tc, ts, torch.float32)
    assert (back - torch.from_numpy(x)).abs().max().item() <= np.abs(x).max() / 200.0
    # zero vectors stay exactly zero; bf16 in gives the same codes as f32
    z = tkv.quantize_kv(torch.zeros((8, 2, 64)))
    assert tkv.dequantize_kv(*z, torch.float32).abs().max().item() == 0.0
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(tkv.quantize_kv(xb)[0], tkv.quantize_kv(xb.float())[0])


def test_int8_pool_rows_match_jax_kernel_rule():
    """``write_rows`` into an int8 pool (the plain version of the fused KV
    write on the CPU) against JAX's kernel rule: ``quantize_blockwise(...,
    interpret=True)`` codes and scales placed by row with numpy. Rows on
    page 0 repeat (inactive slots and bucket padding write the null page),
    so page 0 is left out: the writers that share its rows need not agree
    on what it holds, and attention never reads it."""
    page, n_pages = 8, 6
    L, nkv, hd = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    rows = np.asarray([4 * page + 3, 2, 9, 2, 5 * page + 7, 0, 1 * page, 2], np.int64)
    k, v = (_kv_inputs(seed, (L, len(rows), nkv, hd)) for seed in (8, 9))
    k[:, 2, 1] = 0.0  # a zero vector: scale 1, codes 0
    pool = tkv.write_rows(tkv.init_pool(TCFG, n_pages, page, kv_quant=True),
                          torch.from_numpy(rows), torch.from_numpy(k), torch.from_numpy(v))
    for name, x in (("k", k), ("v", v)):
        jc, js = jquantize.quantize_blockwise(jnp.asarray(x), fmt="int8_sym", block=hd,
                                              interpret=True)
        want_c = np.zeros((L, n_pages * page, nkv, hd), np.int8)
        want_s = np.zeros((L, n_pages * page, nkv), np.float32)
        want_c[:, rows] = np.asarray(jc).reshape(x.shape)
        want_s[:, rows] = np.asarray(js).reshape(x.shape[:-1])
        got_c = pool[name].reshape(L, -1, nkv, hd)[:, page:].numpy()
        got_s = pool[f"{name}_scale"].reshape(L, -1, nkv)[:, page:].numpy()
        _assert_kv_codes(got_c, got_s, want_c[:, page:], want_s[:, page:], exact_rule=True)
    assert (pool["k_scale"][:, 1, 1, 1] == 1.0).all() and (pool["k"][:, 1, 1, 1] == 0).all()


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    """The tensor behind a data pointer (a CPU tensor here)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr),
                            dtype=dtype).reshape(shape)


class FakeQuantKernels:
    """Stands in for ``_build.library()`` on the serve path: the int8 KV
    write's C entry points run the plain version on the tensors behind the
    pointers."""

    def __getattr__(self, name):
        if not name.startswith("qt_kv_write_int8_"):
            raise AttributeError(name)
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32

        def write(k, v, rows, kc, vc, ks, vs, n_layers, n_rows, nkv, hd, pool_rows, _stream):
            kv, codes, scales = (n_layers, n_rows, nkv, hd), (n_layers, pool_rows, nkv, hd), \
                (n_layers, pool_rows, nkv)
            tquantize.write_kv_int8_reference(
                _view(k, kv, dtype), _view(v, kv, dtype), _view(rows, (n_rows,), torch.int64),
                _view(kc, codes, torch.int8), _view(vc, codes, torch.int8),
                _view(ks, scales, torch.float32), _view(vs, scales, torch.float32))
            return 0
        return write


class _Stream:
    cuda_stream = 0


def test_engine_kv8_kernel_route_launches(tparams):
    """An int8-KV engine on the kernel routes (``FakeQuantKernels``): each
    prefill and each window writes K and V through one ``quantize_blockwise``
    launch, so a run counts admissions + windows; the tokens are the plain
    route's."""
    prompts = _prompts([3, 11, 20, 7])
    outs = {}
    with mock.patch.object(_build, "use_kernel_for", lambda uk, t: uk is not False), \
            mock.patch.object(_build, "library", lambda: FakeQuantKernels()), \
            mock.patch.object(torch.cuda, "current_stream", lambda dev=None: _Stream()):
        for use_kernel in (None, False):
            _build.reset_launches()
            outs[use_kernel], eng = _serve(tparams, prompts, 6, kv_quant=True,
                                           prefill_buckets=(8, 16, 32), multi_step=4,
                                           use_kernel=use_kernel)
            m = eng.metrics()
            expected = dict.fromkeys(_build.launches, 0)
            if use_kernel is None:
                expected["quantize_blockwise"] = m["admissions"] + m["decode_steps"]
            assert dict(_build.launches) == expected
    assert outs[None] == outs[False] and len(outs[None]) == 4


# ------------------------------------------------------------------- runner


def _runner_case(jp, tp, kv_quant):
    """Prefill two prompts (JAX and port), write them into both pools,
    then one 4-step greedy window over both slots."""
    page, n_pages, k = 8, 10, 4
    prompts = _prompts([11, 5], seed=3)
    jpool = jkv.init_pool(JCFG, n_pages, page, kv_quant=kv_quant)
    tpool = tkv.init_pool(TCFG, n_pages, page, kv_quant=kv_quant)
    writes = [[3, 5], [2, 0]]
    first, prefill_out = [], []
    for prompt, pages in zip(prompts, writes):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, jk, jv = jrunner.prefill(jp, jnp.asarray(toks), jnp.int32(len(prompt)), JCFG)
        tl, tk, tv = trunner.prefill(tp, torch.from_numpy(toks), len(prompt), TCFG)
        prefill_out.append(((jl, jk, jv), (tl, tk, tv)))
        jpool = jkv.write_prefill(jpool, jnp.asarray(pages, jnp.int32), jk, jv)
        tkv.write_prefill(tpool, torch.tensor(pages, dtype=torch.int32), tk, tv)
        first.append(int(jnp.argmax(jl)))
        assert int(tl.argmax()) == first[-1]
    table = np.asarray([[3, 5, 0], [2, 4, 0]], np.int32)
    positions = np.asarray([11, 5], np.int32)
    zeros = np.zeros((2,), np.int32)
    jt, jpos, _, jpool = jrunner.decode_multi_step(
        jp, jpool, jnp.asarray(table), jnp.asarray(positions), jnp.asarray(first, jnp.int32),
        jax.random.PRNGKey(0), jnp.zeros((2,), jnp.float32), jnp.asarray(zeros), JCFG, page, k)
    tt, tpos, tpool = trunner.decode_multi_step(
        tp, tpool, torch.from_numpy(table), torch.from_numpy(positions),
        torch.tensor(first, dtype=torch.int32), torch.Generator().manual_seed(0),
        torch.zeros(2), torch.from_numpy(zeros), TCFG, page, k)
    return prefill_out, (jt, jpos, jpool), (tt, tpos, tpool)


@pytest.mark.parametrize("fmt,kv_quant", [(None, False), (None, True), ("llm_int8", True)])
def test_runner_prefill_and_window_match_jax(jparams, tparams, jquant, tquant, fmt, kv_quant):
    jp = jparams if fmt is None else jquant[fmt]
    tp = tparams if fmt is None else tquant[fmt]
    prefill_out, (jt, jpos, jpool), (tt, tpos, tpool) = _runner_case(jp, tp, kv_quant)
    for (jl, jk, jv), (tl, tk, tv) in prefill_out:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert tt.dtype == torch.int32 and tt.shape == (4, 2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    if not kv_quant:
        np.testing.assert_allclose(tpool["k"][:, 1:].numpy(), np.asarray(jpool["k"])[:, 1:], **TOL)
        return
    # JAX quantizes the window with its XLA rule on the CPU: one code step
    for name in ("k", "v"):
        tc, jc = tpool[name][:, 1:].numpy(), np.asarray(jpool[name])[:, 1:]
        assert np.abs(tc.astype(np.int32) - jc.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(tpool[f"{name}_scale"][:, 1:].numpy(),
                                   np.asarray(jpool[f"{name}_scale"])[:, 1:], **TOL)


def test_decode_step_writes_and_tracks_window(tparams):
    """decode_step (one token, written then read through the pool) gives
    the window's first token and the dense pool gets the same K."""
    page = 8
    prompt = _prompts([6], seed=9)[0]
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = prompt
    tl, tk, tv = trunner.prefill(tparams, torch.from_numpy(toks), 6, TCFG)
    pools = [tkv.init_pool(TCFG, 4, page) for _ in range(2)]
    for p in pools:
        tkv.write_prefill(p, torch.tensor([1], dtype=torch.int32), tk, tv)
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([6, -1], dtype=torch.int32)
    first = torch.tensor([int(tl.argmax()), 0], dtype=torch.int32)
    logits, _ = trunner.decode_step(tparams, pools[0], table, pos, first, TCFG, page)
    win, _, _ = trunner.decode_multi_step(tparams, pools[1], table, pos, first, None,
                                          torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                                          TCFG, page, 1)
    assert int(logits[0].argmax()) == int(win[0, 0])
    np.testing.assert_allclose(pools[0]["k"][:, 1, 6].numpy(), pools[1]["k"][:, 1, 6].numpy(),
                               **TOL)


# ------------------------------------------------------------------- engine


@pytest.mark.parametrize("fmt", [None, "nf4", "llm_int8"])
def test_engine_matches_greedy_decode(tparams, tquant, fmt):
    """More requests than slots (slot reuse), mixed prompt lengths."""
    params = tparams if fmt is None else tquant[fmt]
    prompts = _prompts([3, 9, 17, 5, 33])
    out, eng = _serve(params, prompts, 8, prefill_buckets=(8, 16, 32, 64))
    assert len(out) == len(prompts)
    for uid, prompt in enumerate(prompts):
        assert out[uid] == _greedy(params, prompt, 8), f"request {uid} diverged"
    assert eng.metrics()["admissions"] == len(prompts)


def test_engine_matches_jax_greedy_decode(jparams, tparams):
    """Three prompts of one length, so JAX decodes them as one batch (one
    trace); mixed lengths are held against the port's greedy decode."""
    prompts = _prompts([9, 9, 9], seed=2)
    out, _ = _serve(tparams, prompts, 6, multi_step=4)
    want = np.asarray(jllama.greedy_decode(jparams, jnp.asarray(np.stack(prompts)), JCFG,
                                           max_new_tokens=6))[:, 9:]
    for uid in range(len(prompts)):
        assert out[uid] == want[uid].tolist()


def test_engine_pipeline_equals_sync(tparams):
    prompts = _prompts([3, 9, 14, 5], seed=7)
    out_p, eng_p = _serve(tparams, prompts, 8, pipeline=True)
    out_s, eng_s = _serve(tparams, prompts, 8, pipeline=False)
    assert out_p == out_s
    m_p, m_s = eng_p.metrics(), eng_s.metrics()
    assert m_p["output_tokens"] == m_s["output_tokens"]
    assert m_p["requests_finished"] == m_s["requests_finished"] == 4


@pytest.mark.parametrize("ms", [2, 8])
def test_engine_multi_step_equals_single(tparams, ms):
    prompts = _prompts([3, 9, 14], seed=11)
    assert _serve(tparams, prompts, 11, multi_step=ms)[0] == \
        _serve(tparams, prompts, 11, multi_step=1)[0]


def test_engine_window_longer_than_a_page(tparams):
    """A window of more tokens than a page (multi_step 16, pages of 8):
    the window's write of an inactive slot spans two page columns, more
    than the narrowest page-table bucket holds; it must land in the null
    page, as JAX's clamped gather puts it, not index past the table (the
    port raised here: on the card a device-side assert). ``warm_widths``
    runs every bucket, the narrowest of one page included, and the served
    tokens equal per-token stepping's."""
    prompts = _prompts([3, 9, 14], seed=13)
    _, eng = _serve(tparams, prompts[:1], 2, multi_step=16)
    eng.warm_widths(eng.max_pages_per_slot, max_prompt_len=14)
    assert _serve(tparams, prompts, 20, multi_step=16)[0] == \
        _serve(tparams, prompts, 20, multi_step=1)[0]


def test_engine_multi_step_with_eos(tparams):
    """EOS inside a window: the window's tail is dropped and the output
    trimmed exactly as per-token stepping would."""
    prompts = _prompts([5, 8], seed=13)
    base, _ = _serve(tparams, prompts, 12)
    eos = base[0][2]
    out4, eng = _serve(tparams, prompts, 12, multi_step=4, eos_id=eos)
    assert out4 == _serve(tparams, prompts, 12, eos_id=eos)[0]
    assert out4[0] == base[0][:3]
    assert eng.alloc.free_pages == eng.alloc.n_pages - 1


def test_engine_preemption_under_pool_pressure(tparams):
    """Two requests outgrow the pool mid-decode: the junior one is
    preempted (requeued, re-prefilled), both still give exactly the
    greedy continuation, and every page comes back."""
    prompts = _prompts([3, 5])
    for ms in (1, 4):
        out, eng = _serve(tparams, prompts, 20, n_pages=6, prefill_buckets=(8,), multi_step=ms)
        m = eng.metrics()
        assert m["preemptions"] > 0 and m["admissions"] == 2 + m["preemptions"]
        for uid, prompt in enumerate(prompts):
            assert out[uid] == _greedy(tparams, prompt, 20), f"request {uid} after preemption"
        assert eng.alloc.free_pages == 5
        assert not eng._pending and not eng._fresh_admit


def test_engine_submit_rejects_impossible(tparams):
    eng = Engine(tparams, TCFG, n_slots=2, page_size=8, n_pages=4, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="worst-case page need"):
        eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=60))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(Request(uid=1, prompt=np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=TCFG.max_seq_len))
    with pytest.raises(ValueError, match="max_top_k"):
        eng.submit(Request(uid=2, prompt=np.asarray([1, 2], np.int32), max_new_tokens=2,
                           sampling=SamplingParams(top_k=4)))
    # window headroom: prompt + max_new + multi_step - 1 must fit
    eng8 = Engine(tparams, TCFG, n_slots=1, page_size=8, multi_step=8)
    with pytest.raises(ValueError, match="window headroom"):
        eng8.submit(Request(uid=3, prompt=np.zeros(80, np.int32), max_new_tokens=10))


def test_engine_decode_page_bucketing(tparams):
    """Short sequences decode through a narrow page table and widen only
    as they grow."""
    eng = Engine(tparams, TCFG, n_slots=2, page_size=8, prefill_buckets=(8,))
    assert eng.decode_page_buckets == [1, 2, 4, 8, 12]
    eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=30))
    widths = []
    while eng._draining:
        eng.step()
        widths.append(eng._last_decode_width)
    assert widths[0] == 1 and max(widths) <= 8 and widths == sorted(widths)


def test_engine_steady_steps_and_recorder(tparams, tmp_path):
    """Windows with no scheduling event count as steady (page growth is
    none: the table is uploaded with every window); the recorder exports
    JSON lines."""
    path = str(tmp_path / "metrics.jsonl")
    rec = MetricsRecorder(path=path)
    eng = Engine(tparams, TCFG, n_slots=2, page_size=8, prefill_buckets=(8,), recorder=rec)
    eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=40))
    while eng._draining:
        eng.step()
    snap = rec.snapshot()
    assert snap["decode_dispatches"] >= 35
    # only the admission and the width changes (1 -> 2 -> 4 -> 8) are events
    assert snap["steady_steps"] >= snap["decode_dispatches"] - 5
    assert snap["window_upload_count"] == snap["decode_dispatches"]
    m = eng.metrics()
    assert m["output_tokens"] == 40 and m["decode_tokens"] == 39  # prefill gives the first
    assert m["decode_step_count"] == m["decode_steps"] and m["ttft_p50_ms"] > 0
    rec.gauge("bytes_in_use", device_memory_stats().get("bytes_in_use", 0.0))  # {} on the CPU
    rec.emit(step=1)
    rec.close()
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[-1]["step"] == 1 and lines[-1]["decode_tokens"] == 39


def test_engine_per_request_top_k_every_step(tparams):
    """top_k=1 with temperature > 0 equals greedy on every token."""
    prompt = np.asarray([1, 2, 3], np.int32)
    eng = Engine(tparams, TCFG, n_slots=1, page_size=8, max_top_k=4, rng_seed=7, multi_step=4)
    out = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=10,
                           sampling=SamplingParams(temperature=1.0, top_k=1))])[0].output
    assert out == _greedy(tparams, prompt, 10)


def test_engine_sampling_temperature_seeds(tparams):
    prompt = np.asarray([1, 2, 3], np.int32)
    outs = []
    for seed in (1, 2):
        eng = Engine(tparams, TCFG, n_slots=1, page_size=8, rng_seed=seed)
        outs.append(eng.run([Request(uid=0, prompt=prompt, max_new_tokens=12,
                                     sampling=SamplingParams(temperature=1.5))])[0].output)
    assert outs[0] != outs[1]
    assert all(0 <= t < TCFG.vocab_size for t in outs[0] + outs[1])


def test_engine_kv_quant_end_to_end(tparams, tquant):
    prompts = _prompts([3, 11, 20])
    for params in (tparams, tquant["llm_int8"]):
        out, eng = _serve(params, prompts, 6, kv_quant=True, prefill_buckets=(8, 16, 32),
                          multi_step=4)
        assert tkv.is_quantized(eng.pool) and len(out) == 3
        assert all(0 <= t < TCFG.vocab_size for o in out.values() for t in o)
        # the int8 pool tracks the dense one closely on a tiny model
        dense, _ = _serve(params, prompts, 6, prefill_buckets=(8, 16, 32), multi_step=4)
        agree = np.mean([a == b for u in out for a, b in zip(out[u], dense[u])])
        assert agree >= 0.5


def test_run_one_serves_a_trace_on_cpu(tparams):
    cfg = tllama.LlamaConfig.tiny(max_seq_len=512, dtype=torch.float32)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    m = serve_bench.run_one(params, cfg, fmt_name="tiny", n_requests=4, rate=1000.0,
                            max_new=8, n_slots=2, multi_step=4, kv_quant=True)
    assert m["requests_finished"] == 4 and m["output_tokens"] == 32 and m["all_finished"]
    pool = tkv.init_pool(cfg, 1 + 2 * 32, 16, kv_quant=True)
    assert m["kv_pool_mib"] == round(tkv.pool_bytes(pool) / 2**20, 1)
    t1 = serve_bench.make_trace(5, 24.0, 250, 48, 32000, seed=0)
    from quanta_tpu.benchmarks import serve_bench as jbench
    t2 = jbench.make_trace(5, 24.0, 250, 48, 32000, seed=0)
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(t1, t2))


# ----------------------------------------------------------------- sampling


def test_temperature_sampling_distribution():
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 1.5, -0.5, 0.2])
    n = 4000
    gen = torch.Generator().manual_seed(0)
    for temp in (1.0, 0.7):
        draws = _sample_batch(logits.expand(n, -1).contiguous(), gen, torch.full((n,), temp))
        freq = torch.bincount(draws.long(), minlength=8).float() / n
        want = torch.softmax(logits / temp, dim=-1)
        assert (freq - want).abs().max().item() <= 0.03
    draws = _sample_batch(logits.expand(n, -1).contiguous(), gen, torch.full((n,), 1.0),
                          top_k=3)
    assert set(draws.tolist()) <= {0, 1, 5}
    top3 = torch.softmax(logits[[0, 1, 5]], dim=-1)
    freq = torch.bincount(draws.long(), minlength=8).float()[[0, 1, 5]] / n
    assert (freq - top3).abs().max().item() <= 0.03
    # per-row top-k under a cap, and greedy rows exact
    top_ks = torch.tensor([2, 0, 1, 8] * (n // 4), dtype=torch.int32)
    temps = torch.tensor([1.0, 0.0, 1.0, 1.0] * (n // 4))
    draws = _sample_batch(logits.expand(n, -1).contiguous(), gen, temps, top_ks=top_ks,
                          max_top_k=8).view(-1, 4)
    assert set(draws[:, 0].tolist()) <= {0, 5}
    assert (draws[:, 1] == 0).all() and (draws[:, 2] == 0).all()
    assert len(set(draws[:, 3].tolist())) > 3
