"""The port's CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where jax is not
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: ``matmul_4bit`` and ``matmul_4bit_t`` kernels and plain
versions multiply the same bf16 weights and differ only in f32 summation
order, so they agree within 2 bf16 ulps of max|plain|; ``matmul_int4c``,
both LLM.int8 kernels, ``quantize_blockwise`` and ``adam8bit_update``
compute exactly what their plain versions compute, in the same rounding
order, and must agree bit for bit. The flash-attention kernels sum in
another order than their plain versions and round p to bf16 against the
running maximum rather than the final one: bf16 outputs within 2 bf16 ulps
of max|plain| and rel-L2 1e-2, lse within 1e-4 (1e30 exactly on rows with
no live key), gradients within rel-L2 2e-2; in f32, 1e-5 of max|plain| for
the output and 1e-4 for gradients; the backward kernels are deterministic,
two calls give the same bits. ``matmul_8bit`` and ``matmul_8bit_t``
read the same 256-entry level table as their plain versions and differ
only in f32 summation order: bf16 within 2 bf16 ulps of max|plain|, f32
within 1e-5 of it; the bf16 ``matmul_4bit`` and ``matmul_8bit`` sum their
split-K partials in a fixed order, and the bf16 ``matmul_8bit_t`` and
``matmul_4bit_t`` split nothing, so two calls give the same bits too.
``matmul_int4c``'s and the LLM.int8 kernels' int32 partials are exact in
any order: both designs of each equal the plain versions bit for bit, and
the LLM.int8 ones give the same bits on a second call.
"""

import math

import numpy as np

import pytest
import torch

from quanta_tpu_torch import core as tcore
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch import train as ttrain
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import adam8bit as tadam
from quanta_tpu_torch.ops import attention as tattn
from quanta_tpu_torch.ops import int4c as tint4c
from quanta_tpu_torch.ops import int8mm as tint8
from quanta_tpu_torch.ops import matmul as tmm
from quanta_tpu_torch.ops import quantize as tquant
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.optim import Adam8bit
from quanta_tpu_torch.serve import Engine, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("fmt", ["nf4a", "nf4", "int4a"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (70, 1000, 200), (1, 96, 64)])
def test_matmul_4bit_kernel_matches_plain(cuda, fmt, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((k, n), generator=g, device=cuda)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    tq = tcore.quantize_matmul_weight(w, fmt=fmt, block_size=32)
    before = _build.launches["matmul_4bit"]
    out = tmm.matmul_quantized(x, tq)
    ref = tmm.matmul_quantized(x, tq, use_kernel=False)
    torch.cuda.synchronize()
    assert _build.launches["matmul_4bit"] == before + 1
    # same bf16 weights, f32 sums in another order: within 2 bf16 ulps of max|ref|
    tol = 2.0 ** -6 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("m,k,n", [(8, 5632, 2048), (33, 1000, 300)])
def test_int4c_kernel_bit_exact(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(1)
    w = torch.randn((k, n), generator=g, device=cuda)
    x = torch.randn((m, k), generator=g, device=cuda)
    qw = tint4c.quantize_int4c_weight(w)
    out = tint4c.matmul_int4c(x, qw)
    ref = tint4c.matmul_int4c(x, qw, use_kernel=False)
    assert torch.equal(out, ref)


def test_raw_kernel_ragged_columns(cuda):
    """N not a multiple of the 64-column tile nor of 16: masked loads."""
    g = torch.Generator(device=cuda).manual_seed(2)
    codes = torch.randint(0, 256, (256, 72), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((512 // 64, 72), generator=g, device=cuda)
    x = torch.randn((5, 512), generator=g, device=cuda).to(torch.bfloat16)
    out = tmm.matmul_4bit(x, codes, scales, codebook="nf4")
    ref = tmm.matmul_4bit(x, codes, scales, codebook="nf4", use_kernel=False)
    tol = 2.0 ** -6 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    xq = torch.randint(-127, 128, (5, 512), generator=g, device=cuda, dtype=torch.int8)
    rs, cs = torch.rand(5, device=cuda), torch.rand(72, device=cuda)
    assert torch.equal(tint4c.matmul_int4c_kernel(xq, codes, rs, cs),
                       tint4c.matmul_int4c_kernel(xq, codes, rs, cs, use_kernel=False))


@pytest.mark.parametrize("mode", ["nf4a", "int4c"])
def test_tiny_model_kernel_path_matches_plain(cuda, mode):
    cfg = tllama.LlamaConfig.tiny(dim=256, hidden_dim=512)
    dense = tllama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    params = tnn.quantize_params(dense, mode=mode, min_size=1024)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), device=cuda, dtype=torch.int32)
    _build.reset_launches()
    out = tllama.greedy_decode(params, prompt, cfg, max_new_tokens=5)
    kernel = "matmul_4bit" if mode == "nf4a" else "matmul_int4c"
    assert _build.launches[kernel] == 5 * (7 * cfg.n_layers + 1)
    lk, _ = tllama.forward(params, prompt, cfg)
    lp, _ = tllama.forward(params, prompt, cfg, use_kernel=False)
    if mode == "int4c":  # bit-exact kernel: the whole path is identical
        assert torch.equal(lk, lp)
        assert torch.equal(out, tllama.greedy_decode(params, prompt, cfg, 5, use_kernel=False))
    else:  # bf16 rounding of a few outputs may differ by one ulp per layer
        assert ((lk - lp).norm() / lp.norm()).item() < 2e-2


@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (37, 200, 100)])
def test_matmul_4bit_f32_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(3)
    tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda), fmt="nf4a")
    x = torch.randn((2, m, k), generator=g, device=cuda)
    out = tmm.matmul_quantized(x, tq)
    ref = tmm.matmul_quantized(x, tq, use_kernel=False)
    assert out.dtype == torch.float32 and out.shape == (2, m, n)
    # f32 products, f32 sums in another order
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_tiny_model_f32_kernel_path_matches_plain(cuda):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    dense = tllama.init_params(torch.Generator(device=cuda).manual_seed(1), cfg, device=cuda)
    params = tnn.quantize_params(dense, mode="nf4", min_size=1024)
    prompt = torch.randint(0, cfg.vocab_size, (2, 7), device=cuda, dtype=torch.int32)
    lk, _ = tllama.forward(params, prompt, cfg)
    lp, _ = tllama.forward(params, prompt, cfg, use_kernel=False)
    assert ((lk - lp).norm() / lp.norm()).item() < 1e-5


# ------------------------------------------------------------------ LLM.int8


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 70])
@pytest.mark.parametrize("k,n", [(200, 72), (200, 300), (1000, 72), (1000, 300)])
def test_int8_routes_bit_exact(cuda, xdtype, m, k, n):
    """Both kernels (fused, plain variant) against the plain versions: the
    same exact integer sums and the same f32 rounding order."""
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    qw = tint8.quantize_int8_weight(torch.randn((k, n), generator=g, device=cuda) * 0.1)
    x = torch.randn((m, k), generator=g, device=cuda)
    x[:, qw.outlier_idx[:3].long()] *= 20.0
    x = x.to(xdtype)
    before = dict(_build.launches)
    fused = tint8.matmul_int8(x, qw)
    unfused = tint8.matmul_int8(x, qw, fused=False)
    plain = tint8.matmul_int8(x, qw, use_kernel=False)
    plain_fused = tint8.matmul_int8(x, qw, use_kernel=False, fused=True)
    torch.cuda.synchronize()
    assert _build.launches["matmul_int8_fused"] == before["matmul_int8_fused"] + 1
    assert _build.launches["matmul_int8"] == before["matmul_int8"] + 1
    assert fused.dtype == xdtype and fused.shape == (m, n)
    for out in (fused, unfused, plain_fused):
        assert torch.equal(out, plain)


@pytest.mark.parametrize("k,n", [(203, 77), (200, 130)])
def test_int8_raw_kernels_ragged(cuda, k, n):
    """Unpadded K and N: the kernels' masked (scalar) loads."""
    g = torch.Generator(device=cuda).manual_seed(k)
    m = 37
    codes = torch.randint(-127, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    x = torch.randn((m, k), generator=g, device=cuda) * 30
    rs = torch.rand(m, generator=g, device=cuda) + 0.05
    cs = torch.rand(n, generator=g, device=cuda) * 0.01
    y_out = torch.randn((m, n), generator=g, device=cuda)
    xq = tint8.quantize_rows(x, rs)
    assert torch.equal(tint8.matmul_int8_fused(x, codes, rs, cs, y_out),
                       tint8.matmul_int8_fused(x, codes, rs, cs, y_out, use_kernel=False))
    assert torch.equal(tint8.matmul_int8_kernel(xq, codes, rs, cs),
                       tint8.matmul_int8_kernel(xq, codes, rs, cs, use_kernel=False))


@pytest.mark.parametrize("fmt", ["int8_sym", "nf4", "nf4a", "fp4", "nf8"])
@pytest.mark.parametrize("n,block,dtype,offset", [(64 * 1000, 64, torch.float32, 0),
                                                  (1000, 64, torch.bfloat16, 0),
                                                  (517, 32, torch.float32, 0),
                                                  (1000, 100, torch.float32, 0),
                                                  (128 * 77 + 5, 128, torch.bfloat16, 0),
                                                  (8 * 333, 8, torch.float32, 0),
                                                  (64 * 50, 64, torch.bfloat16, 3)])
def test_quantize_blockwise_bit_exact(cuda, fmt, n, block, dtype, offset):
    """Blocks of 8 << k values take the grouped layout (16-byte loads,
    unless x starts ``offset`` values past an aligned address), others the
    first port's; a ragged last block is zero-padded."""
    g = torch.Generator(device=cuda).manual_seed(n + block)
    x = (torch.randn(n + offset, generator=g, device=cuda) * 3).to(dtype)[offset:]
    x[:block] = 0.0  # an all-zero block
    before = _build.launches["quantize_blockwise"]
    codes, scale = tquant.quantize_blockwise(x, fmt=fmt, block=block)
    ref_codes, ref_scale = tquant.quantize_blockwise(x, fmt=fmt, block=block, use_kernel=False)
    torch.cuda.synchronize()
    assert _build.launches["quantize_blockwise"] == before + 1
    assert codes.shape == (-(-n // block), block) and scale.shape == (codes.shape[0], 1)
    assert torch.equal(codes, ref_codes) and torch.equal(scale, ref_scale)
    assert scale[0, 0].item() == 1.0


def test_tiny_engine_llm_int8_kv8_kernels_match_plain(cuda):
    """The serve path through the kernels gives the plain path's tokens,
    with the launches the design implies: every forward (one prefill per
    admission, multi_step per window) runs 7 L + 1 fused int8 GEMMs, and
    every prefill and window writes K and V into the int8 pool in one
    launch."""
    cfg = tllama.LlamaConfig.tiny(dim=256, hidden_dim=512)
    dense = tllama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    params = tnn.quantize_params(dense, mode="llm_int8")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 33, 9)]
    outs = {}
    for use_kernel in (None, False):
        eng = Engine(params, cfg, n_slots=2, page_size=8, prefill_buckets=(16, 32, 64),
                     kv_quant=True, multi_step=4, use_kernel=use_kernel)
        _build.reset_launches()
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=10)
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        outs[use_kernel] = {r.uid: r.output for r in done}
        m = eng.metrics()
        forwards = m["admissions"] + 4 * m["decode_steps"]
        expected = dict.fromkeys(_build.launches, 0)
        if use_kernel is None:
            expected["matmul_int8_fused"] = (7 * cfg.n_layers + 1) * forwards
            expected["quantize_blockwise"] = m["admissions"] + m["decode_steps"]
        assert dict(_build.launches) == expected
    assert outs[None] == outs[False]
    assert all(len(o) == 10 for o in outs[None].values())


# ------------------------------------------------------------------ QLoRA


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", ["nf4a", "nf4"])
@pytest.mark.parametrize("m,k,n", [(2048, 2048, 256), (70, 1000, 200), (1, 96, 72)])
def test_matmul_4bit_t_kernel_matches_plain(cuda, dtype, fmt, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(4)
    tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda),
                                      fmt=fmt, block_size=64)
    grad = torch.randn((m, n), generator=g, device=cuda).to(dtype)
    before = _build.launches["matmul_4bit_t"]
    out = tmm.matmul_4bit_t(grad, tq.codes, tq.scale, codebook=fmt)
    ref = tmm.matmul_4bit_t(grad, tq.codes, tq.scale, codebook=fmt, use_kernel=False)
    torch.cuda.synchronize()
    assert _build.launches["matmul_4bit_t"] == before + 1
    assert out.dtype == dtype and out.shape == (m, 2 * tq.codes.shape[0])
    ulps = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5  # 2 bf16 ulps; f32 sums
    assert (out.float() - ref.float()).abs().max().item() <= ulps * ref.float().abs().max().item()


def test_matmul_4bit_t_raw_ragged(cuda):
    """N not a multiple of 16 and packed rows off the 32-row tile: masks."""
    g = torch.Generator(device=cuda).manual_seed(5)
    codes = torch.randint(0, 256, (48, 72), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((96 // 32, 72), generator=g, device=cuda)
    grad = torch.randn((5, 70), generator=g, device=cuda).to(torch.bfloat16)
    out = tmm.matmul_4bit_t(grad, codes, scales, codebook="nf4", block=32)
    ref = tmm.matmul_4bit_t(grad, codes, scales, codebook="nf4", block=32, use_kernel=False)
    assert out.shape == (5, 96)
    assert (out.float() - ref.float()).abs().max().item() <= \
        2.0 ** -6 * ref.float().abs().max().item()


@pytest.mark.parametrize("fmt", ["nf4", "int4a"])
def test_autograd_dx_kernel_matches_plain(cuda, fmt):
    g = torch.Generator(device=cuda).manual_seed(6)
    tq = tcore.quantize_matmul_weight(torch.randn((300, 200), generator=g, device=cuda),
                                      fmt=fmt, block_size=64)
    x0 = torch.randn((2, 9, 300), generator=g, device=cuda).to(torch.bfloat16)
    grads = []
    for use_kernel in (None, False):
        x = x0.clone().requires_grad_()
        (tmm.matmul_quantized(x, tq, use_kernel=use_kernel).float() ** 2).sum().backward()
        grads.append(x.grad.float())
    assert grads[0].shape == x0.shape
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    assert rel < 1e-2  # bf16 forward outputs then bf16 dx: a few ulps apart


@pytest.mark.parametrize("nb", [1, 8, 64, 1000])
def test_adam8bit_kernel_bit_exact(cuda, nb):
    """Five chained steps, kernel and plain version each feeding itself,
    with one all-zero block: updates, codes and scales equal bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(nb)
    zeros = torch.zeros((nb, 256), device=cuda)
    state = {}
    for route in (True, False):
        state[route] = [zeros.to(torch.int8), torch.full((nb, 1), 1e-12, device=cuda),
                        zeros.to(torch.uint8), torch.full((nb, 1), 1e-12, device=cuda)]
    before = _build.launches["adam8bit_update"]
    for step in range(1, 6):
        grad = torch.randn((nb, 256), generator=g, device=cuda) * 10.0 ** (step - 3)
        grad[0] = 0.0
        bc1 = 1.0 - 0.9 ** torch.tensor(float(step), device=cuda)
        bc2 = 1.0 - 0.999 ** torch.tensor(float(step), device=cuda)
        outs = {route: tadam.adam8bit_update(grad, *state[route], 1e-3, bc1, bc2,
                                             use_kernel=route) for route in (True, False)}
        for a, b in zip(outs[True], outs[False]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.count_nonzero(outs[True][0][0]) == 0
        for route in (True, False):
            state[route] = list(outs[route][1:])
    torch.cuda.synchronize()
    assert _build.launches["adam8bit_update"] == before + 5


# adapter leaves of a TinyLlama-1.1B QLoRA step: A of wq and wv (2048, 8), B of
# wq (8, 2048), B of wv (8, 256), 22 layers
TINYLLAMA_ADAPTERS = [(2048, 8), (8, 2048), (2048, 8), (8, 256)] * 22


def _adam_leaves(cuda, shapes, dtypes, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    params = [torch.randn(s, generator=g, device=cuda).to(d) for s, d in zip(shapes, dtypes)]
    states = []
    for p in params:
        nb = -(-p.numel() // 256)
        states.append({"m_codes": torch.zeros((nb, 256), dtype=torch.int8, device=cuda),
                       "m_scale": torch.full((nb, 1), 1e-12, device=cuda),
                       "v_codes": torch.zeros((nb, 256), dtype=torch.uint8, device=cuda),
                       "v_scale": torch.full((nb, 1), 1e-12, device=cuda)})
    return params, states


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("case", ["ragged", "tinyllama_adapters", "two_launches"])
def test_adam8bit_step_bit_exact(cuda, case, wd):
    """The multi-leaf step against its plain version over 5 chained steps,
    each feeding itself: every p and every state tensor equal bit for bit.
    bf16 and f32 parameters in one call; leaves whose n is no multiple of
    256 or of 8; one gradient block all zero (its p moves by the decay
    alone); the TinyLlama QLoRA adapters (88 leaves, one launch); 300
    leaves (more than one launch's table: the C call makes 3)."""
    shapes = {"ragged": [(700,), (3, 5), (64, 40), (2, 256), (1,), (4099,)],
              "tinyllama_adapters": TINYLLAMA_ADAPTERS,
              "two_launches": [(33,), (256,), (40, 12)] * 100}[case]
    dtypes = [(torch.bfloat16, torch.float32)[i % 2 if case != "tinyllama_adapters" else 0]
              for i in range(len(shapes))]
    runs = {}
    for route in (True, False):
        params, states = _adam_leaves(cuda, shapes, dtypes, 0)
        g = torch.Generator(device=cuda).manual_seed(1)
        _build.reset_launches()
        for step in range(1, 6):
            grads = [(torch.randn(p.shape, generator=g, device=cuda) * 10.0 ** (step - 4)).to(
                p.dtype) for p in params]
            grads[0].view(-1)[:256] = 0.0
            count = torch.tensor(float(step), device=cuda)
            scalars = torch.stack([torch.tensor(1e-3, device=cuda), 1.0 - 0.9 ** count,
                                   1.0 - 0.999 ** count])
            tadam.adam8bit_step(params, grads, states, scalars, lr=1e-3, weight_decay=wd,
                                use_kernel=route)
        torch.cuda.synchronize()
        launches = -(-len(shapes) // _build.library().qt_adam8bit_table_leaves())
        assert _build.launches["adam8bit_update"] == (5 * launches if route else 0)
        runs[route] = (params, states)
    assert case != "two_launches" or launches == 3
    for p, q in zip(runs[True][0], runs[False][0]):
        assert p.dtype == q.dtype and torch.equal(p, q)
    for a, b in zip(runs[True][1], runs[False][1]):
        for k in tadam.STATE_KEYS:
            assert torch.equal(a[k], b[k]), k
    assert torch.count_nonzero(runs[True][1][0]["m_codes"][0]) == 0


def test_adam8bit_step_refuses_what_the_kernel_does_not_take(cuda):
    params, states = _adam_leaves(cuda, [(300,)], [torch.float16], 0)
    scalars = torch.tensor([1e-3, 0.1, 0.001], device=cuda)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tadam.adam8bit_step(params, [torch.ones_like(params[0])], states, scalars, lr=1e-3)
    params, states = _adam_leaves(cuda, [(300,)], [torch.float32], 0)
    with pytest.raises(ValueError, match="dense gradient"):
        tadam.adam8bit_step(params, [torch.ones(299, device=cuda)], states, scalars, lr=1e-3)
    states[0]["m_codes"] = states[0]["m_codes"][:1]
    with pytest.raises(ValueError, match="state"):
        tadam.adam8bit_step(params, [torch.ones(300, device=cuda)], states, scalars, lr=1e-3)


def _kv_write_case(cuda, shape, seed):
    """K, V of ``shape`` (L, tokens.., nkv, hd) bf16 with zero vectors, and
    destination rows of a 40-page pool of 16 that repeat on page 0 (bucket
    padding, inactive slots), else unique."""
    n_layers, *tok, nkv, hd = shape
    n_rows = math.prod(tok)
    g = torch.Generator(device=cuda).manual_seed(seed)
    k, v = ((torch.randn(shape, generator=g, device=cuda) * 2).to(torch.bfloat16)
            for _ in range(2))
    k.view(n_layers, n_rows, nkv, hd)[:, 3, 1] = 0.0
    v.view(n_layers, n_rows, nkv, hd)[:, 5] = 0.0
    perm = torch.randperm(39 * 16, generator=g, device=cuda)[:n_rows] + 16
    rows = torch.where(torch.arange(n_rows, device=cuda) % 7 == 6, perm % 16, perm)
    return k.reshape(n_layers, n_rows, nkv, hd), v.reshape(n_layers, n_rows, nkv, hd), rows


@pytest.mark.parametrize("shape", [(22, 256, 4, 64), (22, 8, 8, 4, 64), (3, 40, 2, 128)])
def test_kv_write_int8_matches_quantize_and_index_put(cuda, shape):
    """The fused K+V write into the int8 pool (one launch) against
    ``quantize_kv`` plus ``index_put`` by row, at a prefill's and a
    window's shape (every layer at once) and at head_dim 128: codes and
    scales equal outside page 0. Page 0 takes several writers (its rows
    repeat), and attention never reads it."""
    from quanta_tpu_torch.serve import kvcache as tkv

    cfg = tllama.LlamaConfig.tiny(n_layers=shape[0], n_heads=shape[-2], n_kv_heads=shape[-2],
                                  dim=shape[-2] * shape[-1])
    k, v, rows = _kv_write_case(cuda, shape, 0)
    pools = {}
    for route in (None, False):
        pool = tkv.init_pool(cfg, 40, 16, kv_quant=True, device=cuda)
        before = _build.launches["quantize_blockwise"]
        tkv.write_rows(pool, rows, k, v, use_kernel=route)
        torch.cuda.synchronize()
        assert _build.launches["quantize_blockwise"] == before + (route is None)
        pools[route] = pool
    plain = {name: torch.zeros_like(t) for name, t in pools[False].items()}
    for name, x in (("k", k), ("v", v)):
        codes, scale = tkv.quantize_kv(x, use_kernel=False)
        plain[name].view(shape[0], -1, *shape[-2:])[:, rows] = codes
        plain[f"{name}_scale"].view(shape[0], -1, shape[-2])[:, rows] = scale
    for name in pools[None]:
        assert torch.equal(pools[None][name][:, 1:], plain[name][:, 1:]), name
        assert torch.equal(pools[False][name][:, 1:], plain[name][:, 1:]), name
    assert (pools[None]["v"][:, 1:] == 0).sum() > 0


def test_tiny_qlora_step_kernels_match_plain(cuda):
    """Two QLoRA steps (nf4 base, bf16 adapters) through the kernels and
    through the plain versions: step-1 loss within 1e-2 relative, step-1
    lora_b gradients within rel-L2 3e-2, lora_a gradients zero; the
    launches the design implies (layer 0's wq, wk, wv need no dx; one
    optimizer launch over every adapter)."""
    cfg = tllama.LlamaConfig.tiny(dim=256, hidden_dim=512)
    dense = tllama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    base = tnn.quantize_params(dense, mode="nf4", min_size=1024)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    losses, grads = {}, {}
    for route in (None, False):
        params = ttrain.add_lora(base, torch.Generator(device=cuda).manual_seed(2),
                                 device=cuda)
        opt = Adam8bit(tnn.lora_parameters(params), lr=1e-3, use_kernel=route)
        step = ttrain.make_qlora_train_step(cfg, opt, use_kernel=route)
        _build.reset_launches()
        losses[route] = [step(params, batch).item()]
        grads[route] = [(ad[n]["a"].grad.float(), ad[n]["b"].grad.float())
                        for ad in ttrain.extract_adapters(params) for n in ("wq", "wv")]
        counts = dict(_build.launches)
        losses[route].append(step(params, batch).item())
        per_forward = 7 * cfg.n_layers + 1
        expected = dict.fromkeys(_build.launches, 0)
        if route is None:
            expected.update(matmul_4bit=per_forward, matmul_4bit_t=per_forward - 3,
                            adam8bit_update=1)
        assert counts == expected
    assert abs(losses[None][0] - losses[False][0]) <= 1e-2 * abs(losses[False][0])
    for (ak, bk), (ap, bp) in zip(grads[None], grads[False]):
        assert torch.count_nonzero(ak) == 0 and torch.count_nonzero(ap) == 0
        assert ((bk - bp).norm() / bp.norm()).item() < 3e-2


def test_forward_only_kernels_refuse_autograd(cuda):
    """LLM.int8 and int4c weights, and the raw matmul_4bit kernel, raise
    under autograd instead of returning an output with no gradient."""
    g = torch.Generator(device=cuda).manual_seed(7)
    w = torch.randn((256, 128), generator=g, device=cuda)
    x = torch.randn((4, 256), generator=g, device=cuda, requires_grad=True)
    for leaf in (tint8.quantize_int8_weight(w), tint4c.quantize_int4c_weight(w)):
        with pytest.raises(NotImplementedError, match="QuantizedTensor"):
            tnn.linear(x, leaf)
        with torch.no_grad():
            assert tnn.linear(x, leaf).shape == (4, 128)
    tq = tcore.quantize_matmul_weight(w, fmt="nf4")
    with pytest.raises(NotImplementedError, match="no backward"):
        tmm.matmul_4bit(x, tq.codes, tq.scale, codebook="nf4")
    tnn.linear(x, tq).float().sum().backward()  # the differentiable route
    assert x.grad is not None and torch.isfinite(x.grad).all()


# b, sq, t, nh, nkv, q_start, kv_len, causal: GQA self-attention; ragged S
# and T with a cached offset; a dead row (kv_len 0) beside MHA rows; the
# ragged case without the causal mask; rep 8 with a cached offset, and rep
# 4 and rep 8 with a dead row (each at every head_dim)
FLASH_CASES = [
    (2, 64, 64, 4, 2, [0, 0], [64, 64], True),
    (2, 50, 77, 4, 1, [0, 27], [50, 77], True),
    (3, 70, 130, 2, 2, [0, 60, 0], [70, 130, 0], True),
    (2, 50, 77, 4, 1, [0, 27], [50, 77], False),
    (2, 100, 150, 8, 1, [0, 50], [100, 150], True),
    (2, 90, 100, 4, 1, [10, 0], [100, 0], True),
    (3, 70, 130, 8, 1, [0, 60, 0], [70, 130, 0], True),
]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _flash_inputs(cuda, b, sq, t, nh, nkv, hd, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((b, sq, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd), (b, sq, nh, hd))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("b,sq,t,nh,nkv,q_start,kv_len,causal", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, hd, b, sq, t, nh, nkv, q_start, kv_len, causal):
    """Each of the three flash kernels against its plain version on the same
    inputs; dead rows give zeros, the 1e30 lse and zero gradients."""
    q, k, v, do = _flash_inputs(cuda, b, sq, t, nh, nkv, hd, dtype)
    qs = torch.tensor(q_start, dtype=torch.int32, device=cuda)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = {n: _build.launches[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out, lse = tattn.flash_forward(q, k, v, qs, kl, causal=causal, save_lse=True)
    ref, ref_lse = tattn.flash_forward_reference(q, k, v, qs, kl, causal=causal)
    delta = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, qs, kl)
    dq = tattn.flash_bwd_dq(*args, causal=causal)
    dk, dv = tattn.flash_bwd_dkv(*args, causal=causal)
    dq_ref = tattn.flash_bwd_dq_reference(*args, causal=causal)
    dk_ref, dv_ref = tattn.flash_bwd_dkv_reference(*args, causal=causal)
    torch.cuda.synchronize()
    assert {n: _build.launches[n] - c for n, c in before.items()} == dict.fromkeys(before, 1)
    assert out.dtype == dtype and dq.dtype == dk.dtype == dv.dtype == torch.float32
    live = kl > 0
    assert bool((lse[~live] == tattn.DEAD_LSE).all()) and not bool(out[~live].any())
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-4
    for d in (dq[~live], dk[~live], dv[~live]):
        assert not bool(d.any())
    big = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        assert err <= 2 * 2.0 ** -7 * big and _rel(out, ref) <= 1e-2
        for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
            assert _rel(got, want) <= 2e-2
    else:
        assert err <= 1e-5 * big
        for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _bwd_args(cuda, b, sq, t, nh, nkv, hd, q_start, kv_len, dtype=torch.bfloat16, seed=2):
    q, k, v, do = _flash_inputs(cuda, b, sq, t, nh, nkv, hd, dtype, seed=seed)
    qs = torch.tensor(q_start, dtype=torch.int32, device=cuda)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    ref, lse = tattn.flash_forward_reference(q, k, v, qs, kl)
    delta = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, qs, kl


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_bwd_deterministic(cuda, dtype, hd):
    """Two calls on the same inputs give the same bits: dK/dV's blocks sum
    their partials in a fixed order, and nothing uses atomics."""
    args = _bwd_args(cuda, 2, 300, 330, 8, 2, hd, [0, 30], [300, 330], dtype)
    first = (tattn.flash_bwd_dq(*args), *tattn.flash_bwd_dkv(*args))
    second = (tattn.flash_bwd_dq(*args), *tattn.flash_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (nkv, cluster) for B=2 x T=1024 (16 key tiles) at rep 2: base grids of
# 32, 96, 160 and 288 blocks, which on a 132-SM H100 take clusters of 8, 4,
# 2 and 1
SPLIT_CASES = [(1, 8), (3, 4), (5, 2), (9, 1)]


@pytest.mark.parametrize("nkv,cluster", SPLIT_CASES)
def test_flash_dkv_cluster_split_covers_every_pair(cuda, nkv, cluster):
    """dK/dV splits each key tile's (rep head, live query tile) pairs over a
    cluster's blocks: at Sq = 1000 (a ragged last query tile), q_start 0
    and 24, the causal triangle gives every key tile another count of pairs,
    which no cluster size divides evenly. A pair missed or summed twice
    would move dK and dV by far more than the 1e-3 rel-L2 allowed here: the
    kernel and the plain version round p and ds alike and differ only in
    f32 summation order and exp2 against exp (~3e-5 measured)."""
    nh, hd = 2 * nkv, 64
    args = _bwd_args(cuda, 2, 1000, 1024, nh, nkv, hd, [0, 24], [1000, 1024])
    design = tattn.flash_bwd_design("flash_bwd_dkv", 2, 1000, 1024, nh, nkv, hd)
    if design["sms"] != 132:
        pytest.skip(f"the cluster sizes are worked out for 132 SMs, not {design['sms']}")
    assert design["cluster"] == cluster and design["grid_x"] == cluster
    dk, dv = tattn.flash_bwd_dkv(*args)
    dk_ref, dv_ref = tattn.flash_bwd_dkv_reference(*args)
    assert _rel(dk, dk_ref) <= 1e-3 and _rel(dv, dv_ref) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_autograd_kernel_matches_plain(cuda, dtype):
    """Autograd through flash_attention: the kernel route's dq, dk, dv
    against the plain route's (GQA, ragged, offset)."""
    b, sq, t, nh, nkv, hd = 2, 90, 150, 8, 2, 64
    q0, k0, v0, w = _flash_inputs(cuda, b, sq, t, nh, nkv, hd, dtype, seed=1)
    qs = torch.tensor([0, 60], dtype=torch.int32, device=cuda)
    kl = qs + sq
    grads = []
    for use_kernel in (None, False):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        out = tattn.flash_attention(q, k, v, qs, kl, use_kernel=use_kernel)
        (out.float() * w.float()).sum().backward()
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(*grads):
        assert got.dtype == dtype and _rel(got, want) <= tol


def test_flash_in_tiny_model_matches_plain(cuda):
    """llama.forward(use_flash=True) through the kernel and through the
    plain versions, prefill into a cache larger than the prompt."""
    cfg = tllama.LlamaConfig.tiny(dim=256, n_heads=8, n_kv_heads=2)
    params = tllama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    logits = {}
    for use_kernel in (None, False):
        cache = tllama.init_cache(cfg, 2, max_len=128, device=cuda)
        before = _build.launches["flash_fwd"]
        logits[use_kernel], _ = tllama.forward(params, toks, cfg, cache=cache,
                                               use_kernel=use_kernel, use_flash=True)
        assert _build.launches["flash_fwd"] - before == (cfg.n_layers if use_kernel is None else 0)
    assert _rel(logits[None], logits[False]) <= 1e-2


def test_flash_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(cuda, 1, 16, 16, 2, 2, 80, torch.bfloat16)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(q, k, v, pos, pos + 16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tattn.flash_attention(*(x[..., :64].half() for x in (q, k, v)), pos, pos + 16)
    q, k, v, do = (x[..., :64].contiguous() for x in _flash_inputs(cuda, 1, 16, 16, 2, 2, 80,
                                                                  torch.bfloat16))
    stats = torch.zeros((1, 2, 15), device=cuda)  # one query row short
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_bwd_dq(q, k, v, do, stats, stats, pos, pos + 16)


# ------------------------------------------------------------------ 8-bit


EIGHT_BIT = ["int8", "nf8", "fp8", "int8a"]


def _tol(ref, dtype):
    """2 bf16 ulps of max|plain| in bf16; 1e-5 of it in f32."""
    return (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * ref.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", EIGHT_BIT)
@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (70, 1000, 200), (1, 96, 64)])
def test_matmul_8bit_kernels_match_plain(cuda, fmt, dtype, m, k, n):
    """Forward and transposed kernels at ragged (K, N) (the quantizer pads
    them to 16 x block and 128; M is not a multiple of the 64-row tile)."""
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda), fmt=fmt,
                                      block_size=32)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    gr = torch.randn((m, n), generator=g, device=cuda).to(dtype)
    before = dict(_build.launches)
    out = tmm.matmul_8bit(x, tq.codes, tq.scale, codebook=tq.codebook, block=32)
    out_t = tmm.matmul_8bit_t(gr, tq.codes, tq.scale, codebook=tq.codebook, block=32)
    ref = tmm.matmul_8bit(x, tq.codes, tq.scale, codebook=tq.codebook, block=32,
                          use_kernel=False)
    ref_t = tmm.matmul_8bit_t(gr, tq.codes, tq.scale, codebook=tq.codebook, block=32,
                              use_kernel=False)
    torch.cuda.synchronize()
    assert (_build.launches["matmul_8bit"], _build.launches["matmul_8bit_t"]) == (
        before["matmul_8bit"] + 1, before["matmul_8bit_t"] + 1)
    assert out.dtype == dtype and out.shape == ref.shape == (m, tq.codes.shape[1])
    assert out_t.shape == ref_t.shape == (m, tq.codes.shape[0])
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, dtype)
    assert (out_t.float() - ref_t.float()).abs().max().item() <= _tol(ref_t, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_matmul_8bit_raw_ragged_and_signedness(cuda, dtype):
    """Unpadded codes (K = 192, N = 72: no 16-byte code loads at the edge),
    and the same bytes read as int8a's unsigned codes and as int8's signed
    ones: two different weights, each matched by the kernels."""
    g = torch.Generator(device=cuda).manual_seed(5)
    raw = torch.randint(0, 256, (192, 72), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((192 // 64, 72), generator=g, device=cuda) * 0.01
    x = torch.randn((5, 192), generator=g, device=cuda).to(dtype)
    gr = torch.randn((5, 72), generator=g, device=cuda).to(dtype)
    outs = {}
    for codes in (raw, raw.view(torch.int8)):
        out = tmm.matmul_8bit(x, codes, scales)
        ref = tmm.matmul_8bit(x, codes, scales, use_kernel=False)
        out_t = tmm.matmul_8bit_t(gr, codes, scales)
        ref_t = tmm.matmul_8bit_t(gr, codes, scales, use_kernel=False)
        assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, dtype)
        assert (out_t.float() - ref_t.float()).abs().max().item() <= _tol(ref_t, dtype)
        outs[codes.dtype] = out.float()
    assert (outs[torch.uint8] - outs[torch.int8]).abs().max().item() > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fmt", ["int8", "nf8", "int8a"])
def test_autograd_8bit_kernels_match_plain(cuda, fmt, dtype):
    """dx through matmul_quantized: matmul_8bit forward, matmul_8bit_t
    backward (int8a's zero-point terms outside both)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    tq = tcore.quantize_matmul_weight(torch.randn((300, 200), generator=g, device=cuda),
                                      fmt=fmt)
    x = torch.randn((3, 40, 300), generator=g, device=cuda).to(dtype)
    c = torch.randn((3, 40, 200), generator=g, device=cuda).to(dtype)
    res = {}
    for uk in (None, False):
        xr = x.clone().requires_grad_()
        before = dict(_build.launches)
        y = tmm.matmul_quantized(xr, tq, use_kernel=uk)
        (y.float() * c.float()).sum().backward()
        launched = (_build.launches["matmul_8bit"] - before["matmul_8bit"],
                    _build.launches["matmul_8bit_t"] - before["matmul_8bit_t"])
        assert launched == ((1, 1) if uk is None else (0, 0))
        res[uk] = (y.detach(), xr.grad)
    for a, b in zip(res[None], res[False]):
        assert a.dtype == dtype and (a.float() - b.float()).abs().max().item() <= 2 * _tol(b, dtype)


def test_tiny_model_ptq_tree_kernel_path_matches_plain(cuda):
    """A PTQ tree with every 8-bit format and an ActQuantWeight: every
    quantized linear launches matmul_8bit, and the logits and perplexity
    match the plain route. f32 with TF32 off, so without the W8A8 leaves
    kernel and plain differ in the last bits only (logits within 1e-5
    rel-L2). With them, the fake-quant rounds an activation whose last
    bits differ to the neighbouring level now and then, one quantization
    step of (hi - lo)/255: logits within 5e-3 rel-L2 (1.6e-3 measured on
    one draw of tokens), perplexity within 1e-3."""
    from quanta_tpu_torch import eval as teval, ptq
    from quanta_tpu_torch.calib import ActQuantWeight
    from quanta_tpu_torch.state.config import ConfigTree, QuantConfig

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(2)
    dense = tllama.init_params(gen, cfg, device=cuda)
    tree = (ConfigTree(QuantConfig.from_mode("int8"))
            .config_layer("layers/0/", scheme="codebook", codebook="nf8")
            .config_layer("lm_head", scheme="codebook", codebook="fp8")
            .config_layer("w_down", scheme="affine", weights_only=False, calibration="entropy"))
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen, device=cuda,
                         dtype=torch.int32)
    params = ptq.quantize_model(dense, tree, forward=lambda p, b: tllama.forward(p, b, cfg)[0],
                                calib_batches=[toks[:2], toks[2:]], min_size=1024)
    weights_only = {**params, "layers": [
        {k: v.w if isinstance(v, ActQuantWeight) else v for k, v in lp.items()}
        for lp in params["layers"]]}
    for tree_, tol in ((weights_only, 1e-5), (params, 5e-3)):
        _build.reset_launches()
        lk, _ = tllama.forward(tree_, toks, cfg)
        assert _build.launches["matmul_8bit"] == 7 * cfg.n_layers + 1
        lp, _ = tllama.forward(tree_, toks, cfg, use_kernel=False)
        assert ((lk - lp).norm() / lp.norm()).item() < tol
    flat = toks.reshape(-1).cpu().numpy()
    pk = teval.perplexity(params, flat, cfg, seq_len=32, batch=2)
    pp = teval.perplexity(params, flat, cfg, seq_len=32, batch=2, use_kernel=False)
    assert abs(pk - pp) <= 1e-3 * pp


# The bf16 kernel's two designs, picked by M (csrc/matmul_8bit.cu): split-K
# mma.sync for decode M (kernels of 8, 16 and 32 rows), 128 x 128 wgmma tiles
# above. M runs across the split; N = 200 is ragged (no 16-byte code loads
# at the edge).
MM8_MS = [1, 8, 16, 20, 32, 33, 64, 65, 256, 2048]


def _mm8_operands(cuda, fmt, m, k, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda), fmt=fmt,
                                      block_size=32)
    # the quantizer pads K and N: cut them back (k is a multiple of the block)
    codes, scales = tq.codes[:k, :n].contiguous(), tq.scale[:k // 32, :n].contiguous()
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    return x, codes, scales, tq.codebook


@pytest.mark.parametrize("fmt", EIGHT_BIT)
@pytest.mark.parametrize("m", MM8_MS)
def test_matmul_8bit_designs_match_plain(cuda, fmt, m):
    x, codes, scales, cb = _mm8_operands(cuda, fmt, m, 1024, 200, seed=m)
    out = tmm.matmul_8bit(x, codes, scales, codebook=cb, block=32)
    ref = tmm.matmul_8bit(x, codes, scales, codebook=cb, block=32, use_kernel=False)
    assert out.shape == ref.shape == (m, 200)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)


def test_matmul_8bit_ms_cover_both_designs(cuda):
    designs = [tmm.matmul_8bit_design(m, 200, 1024)["design"] for m in MM8_MS]
    assert designs[0] == "decode" and designs[-1] == "prefill"
    assert designs == sorted(designs)  # decode below the split, prefill above


@pytest.mark.parametrize("m", [8, 16, 32, 64, 2048])
def test_matmul_8bit_split_fits_one_wave(cuda, m):
    """A K split never asks for more blocks than the card holds at once: the
    split counts the blocks an SM holds of the kernel that runs (the decode
    kernels of 16 and 32 rows hold fewer than that of 8)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in [(2048, 256), (5632, 2048), (2048, 2048)]:
        d = tmm.matmul_8bit_design(m, n, k)
        if d["split"] > 1:
            assert d["grid_x"] * d["grid_y"] * d["grid_z"] <= d["blocks_per_sm"] * sms


@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (8, 5632, 2048), (2048, 2048, 256)])
def test_matmul_8bit_bit_identical_over_two_calls(cuda, m, k, n):
    """The split-K partials are summed in a fixed order: no atomics."""
    x, codes, scales, cb = _mm8_operands(cuda, "int8", m, k, n, seed=3)
    assert tmm.matmul_8bit_design(m, n, k)["split"] > 1
    first = tmm.matmul_8bit(x, codes, scales, codebook=cb, block=32)
    assert torch.equal(first, tmm.matmul_8bit(x, codes, scales, codebook=cb, block=32))


# (m, k, n): decode with 50 slices of 16 rows over a split of 4 (13, 13,
# 13, 11 slices; 4, 3, 3, 3 a warp), and prefill with 37 steps of 64 rows
# over a split of 8 (5 each, 2 on the last rank)
SPLIT8_CASES = [(8, 800, 128), (256, 2368, 256)]


@pytest.mark.parametrize("m,k,n", SPLIT8_CASES)
def test_matmul_8bit_split_covers_every_k_block(cuda, m, k, n):
    """Each split takes a contiguous run of K that no split size divides
    evenly here; a K block missed or summed twice would move the output by
    far more than the 2 bf16 ulps of max|plain| allowed (the kernel and the
    plain version multiply the same bf16 weights)."""
    design = tmm.matmul_8bit_design(m, n, k)
    assert design["split"] > 1
    if torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        assert design["split"] == (4 if m == 8 else 8)
    for fmt in EIGHT_BIT:
        x, codes, scales, cb = _mm8_operands(cuda, fmt, m, k, n, seed=k)
        out = tmm.matmul_8bit(x, codes, scales, codebook=cb, block=32)
        ref = tmm.matmul_8bit(x, codes, scales, codebook=cb, block=32, use_kernel=False)
        assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_fwd_without_lse_and_deterministic(cuda, hd):
    """save_lse=False (the prefill's call) writes the same output bits as
    with the lse, and two calls agree bit for bit."""
    q, k, v, _ = _flash_inputs(cuda, 2, 300, 330, 8, 2, hd, torch.bfloat16, seed=4)
    qs = torch.tensor([0, 30], dtype=torch.int32, device=cuda)
    kl = torch.tensor([300, 330], dtype=torch.int32, device=cuda)
    out, lse = tattn.flash_forward(q, k, v, qs, kl, save_lse=True)
    again, none = tattn.flash_forward(q, k, v, qs, kl)
    assert none is None and lse is not None and torch.equal(out, again)
    ref, _ = tattn.flash_forward_reference(q, k, v, qs, kl)
    assert (out.float() - ref.float()).abs().max().item() <= 2 * 2.0 ** -7 * ref.float().abs().max().item()


@pytest.mark.parametrize("m", [5, 40])
def test_matmul_8bit_block_off_the_slices(cuda, m):
    """A block of 24 rows (K = 96): no 16-row slice (decode, M = 5) or 64-row
    step (prefill, M = 40) keeps one scale row, so both designs read each
    K row's scales on their own."""
    g = torch.Generator(device=cuda).manual_seed(8)
    codes = torch.randint(0, 256, (96, 72), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((96 // 24, 72), generator=g, device=cuda) * 0.01
    x = torch.randn((m, 96), generator=g, device=cuda).to(torch.bfloat16)
    assert tmm.matmul_8bit_design(m, 72, 96)["design"] == ("decode" if m == 5 else "prefill")
    out = tmm.matmul_8bit(x, codes, scales, block=24)
    ref = tmm.matmul_8bit(x, codes, scales, block=24, use_kernel=False)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)


# The bf16 matmul_4bit kernel's two designs, picked by M (csrc/matmul_4bit.cu):
# split-K mma.sync for decode M (kernels of 8, 16 and 32 rows), 128- or
# 256-row wgmma tiles above, over the 16-entry codebooks of the path. M
# runs across the split; N = 200 is ragged (no 16-byte code loads at the
# edge).
FOUR_BIT_CB = ["nf4a", "nf4", "int4", "fp4"]
MM4_MS = [1, 8, 16, 20, 32, 33, 64, 65, 256, 2048]


def _mm4_operands(cuda, fmt, m, k, n, seed, block=32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda), fmt=fmt,
                                      block_size=block)
    # the quantizer pads K and N: cut them back. Packed row j holds K rows j
    # and K2 + j, so the codes keep their first k / 2 rows and the scales
    # are re-cut to the blocks of those k rows (random, any will do)
    k2 = k // 2
    codes = tq.codes[:k2, :n].contiguous()
    scales = torch.rand((k // block, n), generator=g, device=cuda) * 0.1
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    return x, codes, scales, tq.codebook


def _mm4_check(x, codes, scales, cb, block):
    out = tmm.matmul_4bit(x, codes, scales, codebook=cb, block=block)
    ref = tmm.matmul_4bit(x, codes, scales, codebook=cb, block=block, use_kernel=False)
    assert out.shape == ref.shape == (x.shape[0], codes.shape[1])
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)
    return out


@pytest.mark.parametrize("fmt", FOUR_BIT_CB)
@pytest.mark.parametrize("m", MM4_MS)
def test_matmul_4bit_designs_match_plain(cuda, fmt, m):
    x, codes, scales, cb = _mm4_operands(cuda, fmt, m, 1024, 200, seed=m)
    before = _build.launches["matmul_4bit"]
    _mm4_check(x, codes, scales, cb, 32)
    assert _build.launches["matmul_4bit"] == before + 1


def test_matmul_4bit_ms_cover_both_designs(cuda):
    designs = [tmm.matmul_4bit_design(m, 200, 1024)["design"] for m in MM4_MS]
    assert designs[0] == "decode" and designs[-1] == "prefill"
    assert designs == sorted(designs)  # decode below the split, prefill above


@pytest.mark.parametrize("m", [8, 16, 32, 64, 2048])
def test_matmul_4bit_split_fits_one_wave(cuda, m):
    """A K split never asks for more blocks than the card holds at once: the
    split counts the blocks an SM holds of the kernel that runs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in [(2048, 256), (5632, 2048), (2048, 2048)]:
        d = tmm.matmul_4bit_design(m, n, k)
        if d["split"] > 1:
            assert d["grid_x"] * d["grid_y"] * d["grid_z"] <= d["blocks_per_sm"] * sms


@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (8, 5632, 2048), (2048, 2048, 256)])
def test_matmul_4bit_bit_identical_over_two_calls(cuda, m, k, n):
    """The split-K partials are summed in a fixed order: no atomics."""
    x, codes, scales, cb = _mm4_operands(cuda, "nf4a", m, k, n, seed=3)
    assert tmm.matmul_4bit_design(m, n, k)["split"] > 1
    first = tmm.matmul_4bit(x, codes, scales, codebook=cb, block=32)
    assert torch.equal(first, tmm.matmul_4bit(x, codes, scales, codebook=cb, block=32))


# (m, k, n): decode with K2 = 800 packed rows, 50 slices of 16 over a split
# of 4 (13, 13, 13, 11 slices), and prefill with K2 = 1184, 37 steps of 32
# packed rows over a split of 8 (5 each, 2 on the last rank)
SPLIT4_CASES = [(8, 1600, 128), (256, 2368, 256)]


@pytest.mark.parametrize("m,k,n", SPLIT4_CASES)
def test_matmul_4bit_split_covers_every_k_block(cuda, m, k, n):
    """Each split takes a contiguous run of packed rows that no split size
    divides evenly here; a run missed or summed twice, in either nibble
    half, would move the output by far more than 2 bf16 ulps."""
    design = tmm.matmul_4bit_design(m, n, k)
    assert design["split"] > 1
    if torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        assert design["split"] == (4 if m == 8 else 8)
    for fmt in FOUR_BIT_CB:
        _mm4_check(*_mm4_operands(cuda, fmt, m, k, n, seed=k), 32)


# (m, K2, block): K2 = 200 is a multiple of neither 16 nor 32 (the last
# slice or slab runs past K2 in both halves, and the two halves' scale
# rows are read row by row); K2 = 100 also puts x's high half off 16-byte
# alignment; block 40 is a multiple of neither 16 nor 32
OFF4_CASES = [(5, 200, 16), (40, 200, 16), (5, 100, 40), (40, 100, 40)]


@pytest.mark.parametrize("m,k2,block", OFF4_CASES)
def test_matmul_4bit_k2_off_the_slices(cuda, m, k2, block):
    g = torch.Generator(device=cuda).manual_seed(k2 + block)
    codes = torch.randint(0, 256, (k2, 72), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((2 * k2 // block, 72), generator=g, device=cuda) * 0.1
    x = torch.randn((m, 2 * k2), generator=g, device=cuda).to(torch.bfloat16)
    assert tmm.matmul_4bit_design(m, 72, 2 * k2)["design"] == ("decode" if m == 5 else "prefill")
    for cb in FOUR_BIT_CB:
        _mm4_check(x, codes, scales, cb, block)


# The bf16 matmul_8bit_t kernel: wgmma tiles of 128 rows of g by 64 dx
# columns (csrc/matmul_8bit_t.cu). K = 992 leaves the last 64-column tile
# half full; N = 200 is off the 128-column steps.
MM8T_MS = [1, 33, 64, 2048]


@pytest.mark.parametrize("fmt", EIGHT_BIT)
@pytest.mark.parametrize("m", MM8T_MS)
def test_matmul_8bit_t_wgmma_matches_plain(cuda, fmt, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    tq = tcore.quantize_matmul_weight(torch.randn((992, 200), generator=g, device=cuda), fmt=fmt,
                                      block_size=32)
    codes, scales = tq.codes[:992, :200].contiguous(), tq.scale[:992 // 32, :200].contiguous()
    gr = torch.randn((m, 200), generator=g, device=cuda).to(torch.bfloat16)
    before = _build.launches["matmul_8bit_t"]
    out = tmm.matmul_8bit_t(gr, codes, scales, codebook=tq.codebook, block=32)
    ref = tmm.matmul_8bit_t(gr, codes, scales, codebook=tq.codebook, block=32, use_kernel=False)
    assert _build.launches["matmul_8bit_t"] == before + 1
    assert out.shape == ref.shape == (m, 992)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)


@pytest.mark.parametrize("k,n,block", [(96, 203, 32), (200, 77, 40), (1024, 300, 64)])
def test_matmul_8bit_t_raw_ragged(cuda, k, n, block):
    """N off 8 (g read value by value) and off 16 (codes byte by byte),
    blocks below the 64-row slab (scales row by row), K off the 64-column
    tile."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    codes = torch.randint(0, 256, (k, n), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((k // block, n), generator=g, device=cuda) * 0.01
    gr = torch.randn((37, n), generator=g, device=cuda).to(torch.bfloat16)
    for c in (codes, codes.view(torch.int8)):
        out = tmm.matmul_8bit_t(gr, c, scales, block=block)
        ref = tmm.matmul_8bit_t(gr, c, scales, block=block, use_kernel=False)
        assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(2048, 2048, 256), (2048, 5632, 2048), (33, 2048, 32000)])
def test_matmul_8bit_t_bit_identical_over_two_calls(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(9)
    codes = torch.randint(-128, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    scales = torch.rand((k // 64, n), generator=g, device=cuda) * 0.01
    gr = torch.randn((m, n), generator=g, device=cuda).to(torch.bfloat16)
    first = tmm.matmul_8bit_t(gr, codes, scales)
    assert torch.equal(first, tmm.matmul_8bit_t(gr, codes, scales))


# The bf16 matmul_4bit_t kernel: wgmma dx tiles of 256 or 128 rows of g by
# 128 dx columns, the low and high nibbles of 64 packed rows
# (csrc/matmul_4bit_t.cu), at the (K, N) of the TinyLlama-1.1B and
# Llama-2-7B linears, block 64, over the 16-entry codebooks; M across
# both tile widths.
MM4T_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000),
               (4096, 4096), (4096, 11008), (11008, 4096)]
MM4T_MS = [1, 64, 256, 1024, 2048]


def _mm4t_check(gr, codes, scales, cb, block):
    out = tmm.matmul_4bit_t(gr, codes, scales, codebook=cb, block=block)
    ref = tmm.matmul_4bit_t(gr, codes, scales, codebook=cb, block=block, use_kernel=False)
    assert out.shape == ref.shape == (gr.shape[0], 2 * codes.shape[0])
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)
    return out


@pytest.mark.parametrize("fmt", FOUR_BIT_CB)
@pytest.mark.parametrize("m", MM4T_MS)
def test_matmul_4bit_t_wgmma_matches_plain(cuda, fmt, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    for k, n in MM4T_SHAPES:
        tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda) * 0.1,
                                          fmt=fmt, block_size=64)
        gr = torch.randn((m, n), generator=g, device=cuda).to(torch.bfloat16)
        before = _build.launches["matmul_4bit_t"]
        _mm4t_check(gr, tq.codes, tq.scale, tq.codebook, 64)
        assert _build.launches["matmul_4bit_t"] == before + 1


def test_matmul_4bit_t_ms_take_both_tile_widths(cuda):
    """256-row tiles where their grid fills at least half the SMs, else 128."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in MM4T_MS:
        for k, n in MM4T_SHAPES:
            d = tmm.matmul_4bit_t_design(m, n, k)
            tiles = (k // 128) * -(-m // 256)
            assert d["design"] == "wgmma" and d["split"] == 1
            assert d["rows"] == (256 if 2 * tiles >= sms else 128)
            assert (d["grid_x"], d["grid_y"]) == (k // 128, -(-m // d["rows"]))
    if sms == 132:
        assert tmm.matmul_4bit_t_design(2048, 5632, 2048)["rows"] == 256
        assert tmm.matmul_4bit_t_design(1024, 5632, 2048)["rows"] == 128


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("fmt", FOUR_BIT_CB)
def test_matmul_4bit_t_quantizer_blocks(cuda, fmt, block):
    """Quantizer-made weights at blocks below and above the 64 packed rows
    of a tile: the staged scale rows of each 32-row group."""
    g = torch.Generator(device=cuda).manual_seed(block)
    for m, k, n in [(256, 2048, 5632), (1024, 5632, 2048)]:
        tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda) * 0.1,
                                          fmt=fmt, block_size=block)
        gr = torch.randn((m, n), generator=g, device=cuda).to(torch.bfloat16)
        _mm4t_check(gr, tq.codes, tq.scale, tq.codebook, block)


# (m, K2, block): K2 = 200 is off the 64-row tile and the 32-row scale
# groups, block 16 below them (every weight reads its own scale); K2 = 100
# with block 40 also puts g's rows and the high half off alignment
OFF4T_CASES = [(5, 200, 16), (300, 200, 16), (5, 100, 40), (300, 100, 40)]


@pytest.mark.parametrize("m,k2,block", OFF4T_CASES)
def test_matmul_4bit_t_k2_off_the_tiles(cuda, m, k2, block):
    g = torch.Generator(device=cuda).manual_seed(k2 + block)
    codes = torch.randint(0, 256, (k2, 72), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((2 * k2 // block, 72), generator=g, device=cuda) * 0.1
    gr = torch.randn((m, 72), generator=g, device=cuda).to(torch.bfloat16)
    for cb in FOUR_BIT_CB:
        _mm4t_check(gr, codes, scales, cb, block)


@pytest.mark.parametrize("m,k,n", [(2048, 2048, 256), (2048, 5632, 2048), (1024, 4096, 11008)])
def test_matmul_4bit_t_bit_identical_over_two_calls(cuda, m, k, n):
    """No split of N, no atomics: the same bits on every call."""
    g = torch.Generator(device=cuda).manual_seed(11)
    codes = torch.randint(0, 256, (k // 2, n), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((k // 64, n), generator=g, device=cuda) * 0.01
    gr = torch.randn((m, n), generator=g, device=cuda).to(torch.bfloat16)
    first = tmm.matmul_4bit_t(gr, codes, scales, codebook="nf4")
    assert torch.equal(first, tmm.matmul_4bit_t(gr, codes, scales, codebook="nf4"))


# matmul_int4c's two designs, picked by M (csrc/int4c.cu): split-K int8
# mma.sync for decode M (kernels of 8, 16 and 32 rows), int8 wgmma tiles
# of 128 rows above; bit for bit against the plain version at every
# TinyLlama-1.1B (K, N), on the activations the wrapper quantizes.
I4C_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
I4C_MS = [1, 8, 16, 32, 33, 64, 256, 1024, 2048]


def _i4c_operands(cuda, m, k2, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, 2 * k2), generator=g, device=cuda, dtype=torch.int8)
    codes = torch.randint(0, 256, (k2, n), generator=g, device=cuda, dtype=torch.uint8)
    rs = torch.rand(m, generator=g, device=cuda) * 0.01
    cs = torch.rand(n, generator=g, device=cuda) * 0.1
    return xq, codes, rs, cs


@pytest.mark.parametrize("m", I4C_MS)
def test_matmul_int4c_designs_bit_exact(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    for k, n in I4C_SHAPES:
        qw = tint4c.quantize_int4c_weight(torch.randn((k, n), generator=g, device=cuda))
        x = torch.randn((m, k), generator=g, device=cuda)
        before = _build.launches["matmul_int4c"]
        out = tint4c.matmul_int4c(x, qw)
        assert _build.launches["matmul_int4c"] == before + 1
        assert torch.equal(out, tint4c.matmul_int4c(x, qw, use_kernel=False))
        # every code and activation value, not only the quantizer's
        ops = _i4c_operands(cuda, m, k // 2, n, seed=k + n)
        assert torch.equal(tint4c.matmul_int4c_kernel(*ops),
                           tint4c.matmul_int4c_kernel(*ops, use_kernel=False))


def test_matmul_int4c_ms_cover_both_designs(cuda):
    designs = [tint4c.matmul_int4c_design(m, 2048, 2048)["design"] for m in I4C_MS]
    assert designs[0] == "decode" and designs[-1] == "prefill"
    assert designs == sorted(designs)  # decode below the split, prefill above
    assert [tint4c.matmul_int4c_design(m, 2048, 2048)["rows"] for m in (1, 16, 32, 33)] == \
        [8, 16, 32, 128]


@pytest.mark.parametrize("m", [8, 32, 64, 1024])
def test_matmul_int4c_split_fits_one_wave(cuda, m):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in I4C_SHAPES:
        d = tint4c.matmul_int4c_design(m, n, k)
        if d["split"] > 1:
            assert d["grid_x"] * d["grid_y"] * d["grid_z"] <= d["blocks_per_sm"] * sms


# (m, K2, N): K2 off 16 (x read byte by byte, the last slice and step run
# past K2 in both halves), N off 16, 64 and 128 (codes byte by byte, masked
# columns); decode and prefill M, ragged M
I4C_RAGGED = [(5, 1000, 77), (8, 200, 200), (30, 1000, 77), (40, 200, 200), (300, 1000, 77),
              (1000, 1000, 200)]


@pytest.mark.parametrize("m,k2,n", I4C_RAGGED)
def test_matmul_int4c_ragged(cuda, m, k2, n):
    ops = _i4c_operands(cuda, m, k2, n, seed=m + k2)
    assert torch.equal(tint4c.matmul_int4c_kernel(*ops),
                       tint4c.matmul_int4c_kernel(*ops, use_kernel=False))


# matmul_int8_fused's and matmul_int8's two designs, picked by M
# (csrc/int8mm.cu): split-K int8 mma.sync for decode M (kernels of 8, 16
# and 32 rows), int8 wgmma tiles of 128 rows above (the fused entry point
# first quantizes x into int8 there); bit for bit against the plain
# versions at every TinyLlama-1.1B (K, N), on the operands matmul_int8
# hands the kernels, with the quantizer's outlier set and x's outlier
# columns scaled by 20.
I8_MS = [1, 8, 16, 32, 33, 64, 256, 1024]


def _i8_operands(cuda, m, k, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qw = tint8.quantize_int8_weight(torch.randn((k, n), generator=g, device=cuda) / k ** 0.5)
    x = torch.randn((m, k), generator=g, device=cuda)
    x[:, qw.outlier_idx.long()] *= 20.0
    y_out = x.index_select(1, qw.outlier_idx) @ qw.w_outlier.float()
    xa = x.abs()
    xa[:, qw.outlier_idx] = 0.0
    rs = torch.clamp(xa.amax(dim=1) / 127.0, min=1e-12)
    return qw, x, rs, y_out


def _i8_check(x, codes, rs, cs, y_out):
    """Both entry points against their plain versions, bit for bit, one
    launch each, and the same bits on a second call."""
    xq = tint8.quantize_rows(x, rs)
    before = dict(_build.launches)
    fused = tint8.matmul_int8_fused(x, codes, rs, cs, y_out)
    plain = tint8.matmul_int8_kernel(xq, codes, rs, cs)
    assert _build.launches["matmul_int8_fused"] == before["matmul_int8_fused"] + 1
    assert _build.launches["matmul_int8"] == before["matmul_int8"] + 1
    assert torch.equal(fused, tint8.matmul_int8_fused(x, codes, rs, cs, y_out, use_kernel=False))
    assert torch.equal(plain, tint8.matmul_int8_kernel(xq, codes, rs, cs, use_kernel=False))
    assert torch.equal(fused, tint8.matmul_int8_fused(x, codes, rs, cs, y_out))
    assert torch.equal(plain, tint8.matmul_int8_kernel(xq, codes, rs, cs))


@pytest.mark.parametrize("m", I8_MS)
def test_matmul_int8_designs_bit_exact(cuda, m):
    for k, n in I4C_SHAPES:
        qw, x, rs, y_out = _i8_operands(cuda, m, k, n, seed=m + k + n)
        _i8_check(x, qw.codes, rs, qw.scale, y_out)


def test_matmul_int8_ms_cover_both_designs(cuda):
    for fused in (True, False):
        ds = [tint8.matmul_int8_design(m, 2048, 2048, fused=fused) for m in I8_MS]
        assert [d["design"] for d in ds] == ["decode"] * 4 + ["prefill"] * 4
        assert [d["rows"] for d in ds] == [8, 8, 16, 32, 128, 128, 128, 128]
        assert all(d["spill_bytes"] == 0 for d in ds)


@pytest.mark.parametrize("m", [8, 32, 64, 1024])
def test_matmul_int8_split_fits_one_wave(cuda, m):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, n in I4C_SHAPES:
        for fused in (True, False):
            d = tint8.matmul_int8_design(m, n, k, fused=fused)
            if d["split"] > 1:
                assert d["grid_x"] * d["grid_y"] * d["grid_z"] <= d["blocks_per_sm"] * sms


# (m, K, N): K off 4 (203: x read one value or byte at a time) and off 16
# (1000: int8 x byte by byte, f32 x by cp.async), N off 16 and 128 (codes
# byte by byte, masked columns, y_out and out one by one); decode and
# prefill M, ragged M
I8_RAGGED = [(5, 203, 77), (30, 1000, 200), (300, 203, 77), (1000, 1000, 200)]


@pytest.mark.parametrize("m,k,n", I8_RAGGED)
def test_int8_raw_kernels_ragged_designs(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    codes = torch.randint(-127, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    x = torch.randn((m, k), generator=g, device=cuda) * 30
    rs = torch.rand(m, generator=g, device=cuda) + 0.05
    cs = torch.rand(n, generator=g, device=cuda) * 0.01
    _i8_check(x, codes, rs, cs, torch.randn((m, n), generator=g, device=cuda))


@pytest.mark.parametrize("m", [8, 256])
def test_matmul_int8_fused_rounds_ties_to_even(cuda, m):
    """x / row_scale lands exactly on k + 0.5 (a power-of-two scale): the
    prologue rounds half to even, as torch.round does."""
    g = torch.Generator(device=cuda).manual_seed(m)
    k, n = 2048, 256
    codes = torch.randint(-127, 128, (k, n), generator=g, device=cuda, dtype=torch.int8)
    rs = torch.full((m,), 0.125, device=cuda)
    x = (torch.randint(-130, 130, (m, k), generator=g, device=cuda) + 0.5) * 0.125
    assert (x / rs[:, None] % 1 == 0.5).all()
    _i8_check(x, codes, rs, torch.rand(n, generator=g, device=cuda) * 0.01,
              torch.zeros((m, n), device=cuda))
