"""Port parity for the flash-attention slice: quanta_tpu_torch's
``flash_attention`` (its plain versions, on the CPU), ``llama.forward(
use_flash=True)`` and ``nn.init_quantized_params`` against quanta_tpu's.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_attention.py runs them. Inputs are made with numpy from a seed
and handed to both. Tolerances are JAX's own in tests/test_attention.py:
2e-5 for the f32 forward, 2e-2 for bf16, 2e-4 for gradients and for the
tiny model's logits. The CUDA kernels themselves: tests/test_torch_cuda.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import nn as jnn
from quanta_tpu.models import llama as jllama
from quanta_tpu.ops import attention as jattn
from quanta_tpu_torch import interop
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.ops import attention as tattn

F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)

# b, s, t, nh, nkv, hd, tq, tk, q_start: tests/test_attention.py's shapes and
# its cached-prefill offset
SHAPES = [
    (2, 64, 64, 4, 2, 64, 32, 32, None),     # GQA, self-attention
    (1, 128, 128, 4, 4, 64, 128, 128, None), # MHA, one tile
    (2, 48, 80, 4, 2, 64, 32, 32, None),     # ragged: padded q and kv tiles
    (2, 32, 96, 8, 2, 64, 16, 32, [16, 40]), # prefill at a cache offset
]


def _inputs(b, s, t, nh, nkv, hd, q_start, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd)))
    q_start = np.zeros(b, np.int32) if q_start is None else np.asarray(q_start, np.int32)
    kv_len = (q_start + s).astype(np.int32)
    return q, k, v, q_start, kv_len


def _jax_flash(q, k, v, q_start, kv_len, tq, tk, causal=True, dtype=jnp.float32):
    return jattn.flash_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                                 jnp.asarray(v, dtype), jnp.asarray(q_start),
                                 jnp.asarray(kv_len), causal=causal, tq=tq, tk=tk,
                                 interpret=True)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("b,s,t,nh,nkv,hd,tq,tk,q_start", SHAPES)
def test_forward_matches_jax(b, s, t, nh, nkv, hd, tq, tk, q_start):
    q, k, v, qs, kl = _inputs(b, s, t, nh, nkv, hd, q_start)
    want = _jax_flash(q, k, v, qs, kl, tq, tk)
    got = tattn.flash_attention(*_t(q, k, v, qs, kl))
    assert got.dtype == torch.float32 and got.shape == (b, s, nh, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_forward_bf16_matches_jax():
    q, k, v, qs, kl = _inputs(1, 64, 64, 4, 2, 64, None, seed=1)
    want = _jax_flash(q, k, v, qs, kl, 32, 32, dtype=jnp.bfloat16)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = tattn.flash_attention(tq, tk, tv, *_t(qs, kl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_dead_row_and_non_causal(causal):
    """A row whose kv_len is 0 gives zeros and the 1e30 logsumexp (the
    einsum attention would average V over it); causal=False attends the
    whole valid prefix."""
    q, k, v, qs, kl = _inputs(2, 32, 48, 4, 2, 64, [0, 8], seed=2)
    kl = np.asarray([0, 40], np.int32)
    want = _jax_flash(q, k, v, qs, kl, 16, 16, causal=causal)
    args = _t(q, k, v, qs, kl)
    got = tattn.flash_attention(*args, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert torch.count_nonzero(got[0]).item() == 0
    out, lse = tattn.flash_forward(*args, causal=causal, save_lse=True)
    assert torch.equal(out, got) and lse.shape == (2, 4, 32)
    assert bool((lse[0] == tattn.DEAD_LSE).all()) and bool((lse[1] < 1e3).all())


@pytest.mark.parametrize("b,s,t,nh,nkv,hd,tq,tk,q_start", [SHAPES[0], SHAPES[2], SHAPES[3]])
def test_grad_matches_jax(b, s, t, nh, nkv, hd, tq, tk, q_start):
    """Autograd through the port (its plain forward and backward versions)
    against jax.grad through the JAX kernels: GQA, ragged, offset."""
    q, k, v, qs, kl = _inputs(b, s, t, nh, nkv, hd, q_start, seed=3)
    w = np.random.default_rng(4).standard_normal((b, s, nh, hd)).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_flash(q_, k_, v_, qs, kl, tq, tk) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk_, tv_ = (x.requires_grad_() for x in _t(q, k, v))
    (tattn.flash_attention(tq_, tk_, tv_, *_t(qs, kl)) * torch.from_numpy(w)).sum().backward()
    for got, wnt in zip((tq_.grad, tk_.grad, tv_.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(wnt), **GRAD)


# head dims the kernels run padded to a compiled width (100 in 128, as
# OpenLLaMA-3B's; 80 in 128; 160 in 256; 37 and 98, off a multiple of 4,
# padded by the wrapper to 40 and 104 first) and Gemma-2B's 256: b, s, t,
# nh, nkv, tq, tk, q_start (GQA, ragged tiles, a cached offset)
PADDED_HDS = [100, 80, 37, 98, 160, 256]


@pytest.mark.parametrize("hd", PADDED_HDS)
def test_forward_and_grad_at_padded_head_dims_match_jax(hd):
    """The plain flash forward and its gradients at a head dim off the
    compiled widths against the Pallas kernels (interpret mode), whose
    blocks span the whole head dim: forward within 2e-5, q, k and v
    gradients within 2e-4 (tests/test_attention.py's tolerances)."""
    b, s, t, nh, nkv = 2, 48, 80, 4, 2
    q, k, v, qs, kl = _inputs(b, s, t, nh, nkv, hd, [0, 24], seed=11)
    kl = np.asarray([48, 72], np.int32)
    want = _jax_flash(q, k, v, qs, kl, 16, 32)
    got = tattn.flash_attention(*_t(q, k, v, qs, kl))
    assert got.shape == (b, s, nh, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    w = np.random.default_rng(12).standard_normal((b, s, nh, hd)).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_flash(q_, k_, v_, qs, kl, 16, 32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk_, tv_ = (x.requires_grad_() for x in _t(q, k, v))
    (tattn.flash_attention(tq_, tk_, tv_, *_t(qs, kl)) * torch.from_numpy(w)).sum().backward()
    for got_g, want_g in zip((tq_.grad, tk_.grad, tv_.grad), grads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **GRAD)


@pytest.mark.parametrize("hd", PADDED_HDS)
def test_forward_and_grad_bf16_at_padded_head_dims_match_jax(hd):
    """The same in bf16: the plain forward and its q, k and v gradients
    against the Pallas kernels (interpret mode) on bf16 operands, within
    2e-2 (the file's bf16 tolerance). Both round p (and ds) to bf16, at
    other points of the sum (the kernels per tile, against the running
    max), so they differ by bf16 roundings."""
    b, s, t, nh, nkv = 2, 48, 80, 4, 2
    q, k, v, qs, kl = _inputs(b, s, t, nh, nkv, hd, [0, 24], seed=15)
    kl = np.asarray([48, 72], np.int32)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))
    bf = dict(rtol=2e-2, atol=2e-2)
    want = _jax_flash(q, k, v, qs, kl, 16, 32, dtype=jnp.bfloat16)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = tattn.flash_attention(tq, tk, tv, *_t(qs, kl))
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, nh, hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **bf)
    w = np.random.default_rng(16).standard_normal((b, s, nh, hd)).astype(np.float32)

    def loss(q_, k_, v_):
        out = _jax_flash(q_, k_, v_, qs, kl, 16, 32, dtype=jnp.bfloat16)
        return jnp.sum(out.astype(jnp.float32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq_, tk_, tv_ = (x.requires_grad_() for x in (tq, tk, tv))
    (tattn.flash_attention(tq_, tk_, tv_, *_t(qs, kl)).float() * torch.from_numpy(w)) \
        .sum().backward()
    for got_g, want_g in zip((tq_.grad, tk_.grad, tv_.grad), grads):
        np.testing.assert_allclose(got_g.float().numpy(), np.asarray(want_g, np.float32), **bf)


def test_kernel_takes_and_padded_head_dims():
    """The one rule for which head dims the CUDA kernels take: bf16 or f32,
    any head dim from 1 to 256 (as the TPU kernels), each run in the
    smallest compiled width that holds it; off a multiple of 4, after the
    wrapper's zero columns up to a multiple of 8."""
    for hd, width in ((4, 32), (32, 32), (48, 64), (64, 64), (80, 128), (96, 128),
                      (100, 128), (128, 128), (1, 32), (2, 32), (37, 64), (102, 128),
                      (132, 256), (160, 256), (192, 256), (255, 256), (256, 256)):
        assert tattn.padded_head_dim(hd) == width, hd
        assert tattn.kernel_takes(hd, torch.bfloat16) and tattn.kernel_takes(hd, torch.float32)
        assert not tattn.kernel_takes(hd, torch.float16)
    for hd, kernel_hd in ((37, 40), (98, 104), (102, 104), (2, 8), (255, 256), (100, 100)):
        assert tattn.kernel_head_dim(hd) == kernel_hd
    for hd in (0, 288):
        assert tattn.padded_head_dim(hd) == 0 and not tattn.kernel_takes(hd, torch.bfloat16)


# (hd, dtype, the head dim the kernels see): a multiple of 4 as it is, up to
# 128 columns and in f32; off one, the next multiple of 8; in bf16 above
# 128 columns (the TMA rows of the 256-column kernels) a multiple of 8 too
KERNEL_HDS = [(132, torch.bfloat16, 136), (132, torch.float32, 132), (100, torch.bfloat16, 100),
              (136, torch.bfloat16, 136), (252, torch.bfloat16, 256), (252, torch.float32, 252),
              (37, torch.bfloat16, 40), (37, torch.float32, 40), (255, torch.float32, 256)]


@pytest.mark.parametrize("hd,dtype,kernel_hd", KERNEL_HDS)
def test_kernel_head_dim_gives_tma_rows_in_bf16_above_128(hd, dtype, kernel_hd):
    """The head dim the wrapper hands the kernels: its zero columns reach a
    multiple of 8 wherever the rows must be 16-byte multiples, in the same
    compiled width."""
    assert tattn.kernel_head_dim(hd, dtype) == kernel_hd
    assert tattn.padded_head_dim(kernel_hd) == tattn.padded_head_dim(hd)


def _design_library():
    """A library whose design entry points fill their report with 1s and
    record the head dim they were given."""
    seen = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                seen.append((name, args[1] if "bwd" in name else args[0]))
                out = args[-1]
                for i in range(len(out)):
                    out[i] = 1
                return 0
            return entry
    return Lib(), seen


@pytest.mark.parametrize("hd,dtype,want", [
    (256, torch.bfloat16, ("wgmma_ws", "wgmma", "wgmma_ws")),
    (132, torch.bfloat16, ("wgmma_ws", "wgmma", "wgmma_ws")),
    (128, torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    (256, torch.float32, ("wgmma_3xtf32", "wgmma_3xtf32_split", "wgmma_3xtf32_split")),
    (160, torch.float32, ("wgmma_3xtf32", "wgmma_3xtf32_split", "wgmma_3xtf32_split")),
    (128, torch.float32, ("wgmma_3xtf32",) * 3)])
def test_flash_design_names_the_warp_specialised_kernels(hd, dtype, want):
    """The design reports name the warp-specialised forward and dK/dV
    ("wgmma_ws") for bf16 head dims run in 256 columns, the dQ kernel and
    narrower widths "wgmma"; f32 "wgmma_3xtf32", but for the dQ and dK/dV
    kernels at 256 columns, whose pair of blocks splits hd
    ("wgmma_3xtf32_split"); each reports its threads and reaches the
    256-column entry points (``_w256``) with the head dim the kernels
    see."""
    lib, seen = _design_library()
    with mock.patch.object(tattn._build, "library", lambda: lib):
        got = (tattn.flash_fwd_design(2, 1024, 8, hd, dtype=dtype),
               tattn.flash_bwd_design("flash_bwd_dq", 2, 1024, 1024, 8, 1, hd, dtype=dtype),
               tattn.flash_bwd_design("flash_bwd_dkv", 2, 1024, 1024, 8, 1, hd, dtype=dtype))
    assert tuple(d["design"] for d in got) == want
    assert all("threads" in d for d in got)
    wide = tattn.padded_head_dim(hd) == 256
    assert all(name.endswith("_w256") == wide for name, _ in seen)
    assert {h for _, h in seen} == {tattn.kernel_head_dim(hd, dtype)}


def test_flash_kernel_route_at_head_dim_132_bf16_pads_to_136():
    """bf16 at hd 132 (4 mod 8) on the kernel route (the fake library on
    the CPU): the wrapper pads q, k, v and dO to 136 columns for the
    256-column entry points, the scale stays 1/sqrt(132), and the output
    and the gradients, sliced back to 132, are the plain route's."""
    from torch_fakes import kernel_routes

    b, s, t, nh, nkv, hd = 2, 48, 80, 4, 2, 132
    q, k, v, qs, kl = _inputs(b, s, t, nh, nkv, hd, [0, 24], seed=21)
    kl = np.asarray([48, 72], np.int32)
    w = torch.from_numpy(np.random.default_rng(22).standard_normal((b, s, nh, hd)).astype(
        np.float32))
    outs = {}
    for route in (None, False):
        tq, tk, tv = (x.to(torch.bfloat16).requires_grad_() for x in _t(q, k, v))
        with kernel_routes():
            out = tattn.flash_attention(tq, tk, tv, *_t(qs, kl), use_kernel=route)
            (out.float() * w).sum().backward()
            launches = {n: tattn._build.launches[n]
                        for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert launches == dict.fromkeys(launches, 1 if route is None else 0)
        outs[route] = (out, tq.grad, tk.grad, tv.grad)
    for got, want in zip(outs[None], outs[False]):
        assert got.shape[-1] == hd and got.dtype == torch.bfloat16
        assert torch.equal(got, want)


@pytest.mark.parametrize("hd,flash", [(64, True), (100, True), (160, True), (256, True),
                                      (288, False)])
def test_use_flash_default_follows_the_kernels(hd, flash):
    """use_flash=None on CUDA tokens at S >= FLASH_MIN_SEQ takes flash only
    where the kernels take the head dim (64, 100, 160 and 256; not 288,
    which takes the einsum attention); on the CPU it never does. Rehearsed on the CPU
    with the tokens' ``is_cuda`` patched (the plain versions computing) and
    the flash route counted."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_layers=1, dim=2 * hd, n_heads=2,
                                  n_kv_heads=1)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (1, 5)))
    with mock.patch.object(tllama, "FLASH_MIN_SEQ", 4), \
            mock.patch.object(tllama, "flash_attention", wraps=tllama.flash_attention) as fa:
        tllama.forward(params, toks, cfg)
        assert fa.call_count == 0
        with mock.patch.object(torch.Tensor, "is_cuda", True):
            tllama.forward(params, toks, cfg, use_kernel=False)
        assert fa.call_count == (cfg.n_layers if flash else 0)


def test_llama_forward_use_flash_at_head_dim_100_matches_jax():
    """llama.forward(use_flash=True) on a tiny Llama of OpenLLaMA-3B's head
    dim (dim 200, 2 heads on one KV head, 2 layers) against JAX's, without
    and with a cache larger than the prompt."""
    kw = dict(dim=200, n_heads=2, n_kv_heads=1, n_layers=2)
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **kw)
    assert tcfg.head_dim == 100
    jparams = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = interop.from_jax_params(jparams)
    toks = np.random.default_rng(14).integers(0, jcfg.vocab_size, (2, 40), dtype=np.int32)
    want, _ = jllama.forward(jparams, jnp.asarray(toks), jcfg, use_kernel=False,
                             use_flash=True, interpret=True)
    got, _ = tllama.forward(tparams, torch.from_numpy(toks), tcfg, use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
    want_c, _ = jllama.forward(jparams, jnp.asarray(toks), jcfg,
                               cache=jllama.init_cache(jcfg, 2, max_len=64), use_kernel=False,
                               use_flash=True, interpret=True)
    got_c, _ = tllama.forward(tparams, torch.from_numpy(toks), tcfg,
                              cache=tllama.init_cache(tcfg, 2, max_len=64), use_flash=True)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **GRAD)


def test_backward_references_match_jax_vjp():
    """Each backward plain version alone, on the forward's lse and D, against
    jax.vjp of the JAX kernel (dead row included: its gradients are zero)."""
    b, s, t, nh, nkv, hd = 2, 48, 80, 4, 2, 64
    q, k, v, qs, kl = _inputs(b, s, t, nh, nkv, hd, [0, 16], seed=5)
    kl = np.asarray([0, 64], np.int32)
    g = np.random.default_rng(6).standard_normal((b, s, nh, hd)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, b_, c: _jax_flash(a, b_, c, qs, kl, 16, 32),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(g))
    args = _t(q, k, v, qs, kl)
    out, lse = tattn.flash_forward_reference(*args)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **F32)
    tg = torch.from_numpy(g)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    bwd = (args[0], args[1], args[2], tg, lse, delta, args[3], args[4])
    dq = tattn.flash_bwd_dq_reference(*bwd)
    dk, dv = tattn.flash_bwd_dkv_reference(*bwd)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
    assert torch.count_nonzero(dq[0]).item() == 0
    assert torch.count_nonzero(dk[0]).item() == 0 and torch.count_nonzero(dv[0]).item() == 0


def test_llama_forward_use_flash_matches_jax():
    """llama.forward(use_flash=True) on the tiny f32 config, without and
    with a cache larger than the prompt, against JAX's."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.from_jax_params(jparams)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 40), dtype=np.int32)
    want, _ = jllama.forward(jparams, jnp.asarray(toks), jcfg, use_kernel=False,
                             use_flash=True, interpret=True)
    got, _ = tllama.forward(tparams, torch.from_numpy(toks), tcfg, use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)

    jcache = jllama.init_cache(jcfg, 2, max_len=64)
    want_c, jcache = jllama.forward(jparams, jnp.asarray(toks), jcfg, cache=jcache,
                                    use_kernel=False, use_flash=True, interpret=True)
    tcache = tllama.init_cache(tcfg, 2, max_len=64)
    got_c, tcache = tllama.forward(tparams, torch.from_numpy(toks), tcfg, cache=tcache,
                                   use_flash=True)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **GRAD)
    # a second prefill at offset 40 into the same cache: q_start > 0
    more = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    want_o, _ = jllama.forward(jparams, jnp.asarray(more), jcfg, cache=jcache,
                               use_kernel=False, use_flash=True, interpret=True)
    got_o, _ = tllama.forward(tparams, torch.from_numpy(more), tcfg, cache=tcache,
                              use_flash=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **GRAD)


def test_use_flash_default_is_einsum_on_cpu():
    """use_flash=None takes the einsum attention on the CPU, even at S >=
    FLASH_MIN_SEQ, and S == 1 never takes the flash route."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_layers=1)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 5)))
    with mock.patch.object(tllama, "FLASH_MIN_SEQ", 4), \
            mock.patch.object(tllama, "flash_attention", wraps=tllama.flash_attention) as fa:
        tllama.forward(params, toks, cfg)
        tllama.forward(params, toks[:, :1], cfg, use_flash=True)
        assert fa.call_count == 0
        tllama.forward(params, toks, cfg, use_flash=True)
        assert fa.call_count == cfg.n_layers


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _flat(val, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _flat(val, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("mode", ["nf4a", "nf4", "int8"])
def test_init_quantized_params_layout_matches_jax(mode):
    """Same keys, shapes, dtypes, packing and padded layout as JAX's tree
    (the numbers differ: torch and JAX draw differently); a forward runs."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jtree = dict(_flat(jnn.init_quantized_params(jax.random.PRNGKey(0), jcfg, mode=mode)))
    ttree = dict(_flat(tnn.init_quantized_params(torch.Generator().manual_seed(0), tcfg,
                                                 mode=mode)))
    assert jtree.keys() == ttree.keys()
    for path, jl in jtree.items():
        tl = ttree[path]
        if hasattr(jl, "codes"):
            for f in ("shape", "bits", "scheme", "codebook", "block_size", "packed"):
                assert getattr(tl, f) == getattr(jl, f), (path, f)
            assert tl.dtype == torch.bfloat16 and tl.zero_point is None
            assert tuple(tl.codes.shape) == jl.codes.shape
            assert str(tl.codes.dtype).split(".")[-1] == str(jl.codes.dtype)
            assert tuple(tl.scale.shape) == jl.scale.shape and tl.scale.dtype == torch.float32
            k = tl.shape[0]
            assert float(tl.scale.min()) >= 1e-4 and float(tl.scale.max()) <= 1 / np.sqrt(k) + 1e-4
        else:
            assert tuple(tl.shape) == jl.shape and tl.dtype == torch.bfloat16
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, 256, (1, 6)))
    logits, _ = tllama.forward(tnn.init_quantized_params(torch.Generator().manual_seed(0), tcfg,
                                                         mode=mode), toks, tcfg)
    assert logits.shape == (1, 6, 256) and bool(torch.isfinite(logits).all())


def test_init_quantized_params_refuses_affine():
    with pytest.raises(ValueError, match="affine"):
        tnn.init_quantized_params(torch.Generator().manual_seed(0), tllama.LlamaConfig.tiny(),
                                  mode="int4a")


@pytest.mark.parametrize("report", [
    lambda dtype: tattn.flash_fwd_design(2, 1024, 32, 64, dtype=dtype),
    lambda dtype: tattn.flash_bwd_design("flash_bwd_dq", 2, 1024, 1024, 32, 4, 64, dtype=dtype)],
    ids=["fwd", "bwd"])
def test_flash_design_reports_refuse_other_dtypes(report):
    """The flash design reports name the bf16 and f32 routes only, and say
    so before they reach the kernels' library."""
    def no_library():
        raise AssertionError("the report reached the library")
    with mock.patch.object(tattn._build, "library", no_library), \
            pytest.raises(ValueError, match="bf16 or f32"):
        report(torch.float16)
