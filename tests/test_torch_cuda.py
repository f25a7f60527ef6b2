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
two calls give the same bits. The flash kernels take any head dim from 1
to 256, run in the smallest compiled width of 32, 64, 128 and 256 that
holds it (FLASH_HDS: each compiled width unpadded and, padded, 48, 80, 96,
OpenLLaMA-3B's 100, 160 and 192; 37 and 98, off a multiple of 4, padded
by the wrapper to 40 and 104 first; 132, 4 mod 8, padded by the wrapper to
136 in bf16, whose 256-column kernels load by TMA). ``matmul_8bit`` and ``matmul_8bit_t``
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
from quanta_tpu_torch.models import gpt2 as tgpt2
from quanta_tpu_torch.models import hf as thf
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


def test_gpt2_full_train_step_adam_on_the_card(cuda):
    """Full-parameter GPT-2 training (``make_train_step(forward=
    gpt2.forward)``) at GPT-2 small's depth and tiny width: one backward's
    gradients leave parameters and 8-bit state bit for bit equal through
    the optimizer's kernel route (2 launches for 148 leaves) and the
    kernel's plain version; 3 steps through the kernels and through
    ``use_kernel=False`` from one init give losses within rel 1e-5 (the
    embedding's backward sums with atomics)."""
    cfg = tgpt2.GPT2Config.tiny(n_layers=12)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    def model():
        params = tgpt2.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
        return params, ttrain.dense_parameters(params)

    params, leaves = model()
    assert len(leaves) == 148
    logits, _ = tgpt2.forward(params, batch["inputs"], cfg)
    ttrain.causal_lm_loss(logits, batch["targets"]).backward()
    grads = [p.grad.clone() for p in leaves]
    ref = [p.detach().clone() for p in leaves]
    states = [Adam8bit._init_state(p) for p in ref]
    opt = Adam8bit(leaves, lr=1e-3)
    _build.reset_launches()
    opt.step()
    torch.cuda.synchronize()
    assert _build.launches["adam8bit_update"] == 2
    tadam.adam8bit_step_reference(ref, grads, states,
                                  Adam8bit._scalars(1e-3, 0.9, 0.999, 1, cuda), lr=1e-3)
    for p, q, st in zip(leaves, ref, states):
        assert torch.equal(p.detach(), q)
        for k in tadam.STATE_KEYS:
            assert torch.equal(opt.state[p][k], st[k]), k
    losses = {}
    for route in (None, False):
        params, leaves = model()
        step = ttrain.make_train_step(cfg, Adam8bit(leaves, lr=1e-3, use_kernel=route),
                                      forward=tgpt2.forward)
        losses[route] = [step(params, batch).item() for _ in range(3)]
    np.testing.assert_allclose(losses[None], losses[False], rtol=1e-5)
    assert losses[None][2] < losses[None][0]


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
    k.view(n_layers, n_rows, nkv, hd)[:, 3, min(1, nkv - 1)] = 0.0
    v.view(n_layers, n_rows, nkv, hd)[:, 5] = 0.0
    perm = torch.randperm(39 * 16, generator=g, device=cuda)[:n_rows] + 16
    rows = torch.where(torch.arange(n_rows, device=cuda) % 7 == 6, perm % 16, perm)
    return k.reshape(n_layers, n_rows, nkv, hd), v.reshape(n_layers, n_rows, nkv, hd), rows


@pytest.mark.parametrize("shape", [(22, 256, 4, 64), (22, 8, 8, 4, 64), (3, 40, 2, 128),
                                   (12, 256, 12, 64), (12, 8, 8, 12, 64), (3, 40, 2, 24),
                                   (4, 40, 3, 80), (4, 8, 8, 2, 96), (26, 256, 32, 100),
                                   (26, 8, 8, 32, 100), (18, 256, 1, 256), (18, 8, 8, 1, 256)])
def test_kv_write_int8_matches_quantize_and_index_put(cuda, shape):
    """The fused K+V write into the int8 pool (one launch) against
    ``quantize_kv`` plus ``index_put`` by row, at a prefill's and a
    window's shape (every layer at once), at head_dim 128 and at head dims
    off the kernel's 8-lane groups (24, 80, 96, and OpenLLaMA-3B's 100 at
    its prefill and window shapes), and at Gemma-2B's geometry (hd 256, one
    KV head: the grouped layout at hd = 8 << 5): codes and scales equal
    outside page 0.
    Page 0 takes several writers (its rows repeat), and attention never
    reads it."""
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


# head dims: the compiled widths 32, 64, 128 and 256, and head dims run
# padded to them (48 in 64; 80, 96 and OpenLLaMA-3B's 100 in 128; 132, 160
# and 192 in 256; 100 is off the 16-byte rows of bf16), and two off a
# multiple of 4 that the wrapper pads with zero columns first (37 to 40, in
# 64; 98 to 104, in 128); in bf16 the wrapper pads 132 to 136 too (the
# 256-column kernels' TMA rows are multiples of 16 bytes)
FLASH_HDS = [32, 37, 48, 64, 80, 96, 98, 100, 128, 132, 160, 192, 256]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _flash_inputs(cuda, b, sq, t, nh, nkv, hd, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((b, sq, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd), (b, sq, nh, hd))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", FLASH_HDS)
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
@pytest.mark.parametrize("hd", [32, 64, 100, 128, 132, 160, 256])
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


@pytest.mark.parametrize("hd", [200, 256])
def test_flash_dkv_ws_cluster_split_covers_every_pair(cuda, hd):
    """The 256-column bf16 dK/dV kernel (two consumer warpgroups, consumer 0
    handing p^T to consumer 1 through shared memory) at Gemma-2B's MQA
    geometry (8 query heads to one KV head), Sq = 1000, T = 1024, q_start 0
    and 24: grid y is nkv * B (no column split), each key tile's pairs split
    over a cluster of 8 on a 132-SM card, and dK and dV within the same
    1e-3 rel-L2 as test_flash_dkv_cluster_split_covers_every_pair. A pair
    missed or summed twice, or a p^T read before it was written, would move
    them by far more."""
    nh, nkv = 8, 1
    args = _bwd_args(cuda, 2, 1000, 1024, nh, nkv, hd, [0, 24], [1000, 1024])
    design = tattn.flash_bwd_design("flash_bwd_dkv", 2, 1000, 1024, nh, nkv, hd)
    assert design["design"] == "wgmma_ws" and design["grid_y"] == nkv * 2
    if design["sms"] != 132:
        pytest.skip(f"the cluster sizes are worked out for 132 SMs, not {design['sms']}")
    assert design["cluster"] == 8 and design["grid_x"] == 8
    dk, dv = tattn.flash_bwd_dkv(*args)
    dk_ref, dv_ref = tattn.flash_bwd_dkv_reference(*args)
    assert _rel(dk, dk_ref) <= 1e-3 and _rel(dv, dv_ref) <= 1e-3


# registers and spill bytes a thread of the kernels this file pins: the
# 32-, 64- and 128-column ones (hd 100 runs padded in 128) of both dtypes,
# the f32 routes and the bf16 dQ at 256, as nvcc 12.9's ptxas built them
# before the 256-column forward and dK/dV were redesigned
# ((kernel, hd, dtype): (registers, spill_bytes))
KEPT_REGISTERS = {
    ("flash_fwd", 32, "bf16"): (96, 0), ("flash_bwd_dq", 32, "bf16"): (116, 0),
    ("flash_bwd_dkv", 32, "bf16"): (167, 0), ("flash_fwd", 64, "bf16"): (102, 0),
    ("flash_bwd_dq", 64, "bf16"): (124, 0), ("flash_bwd_dkv", 64, "bf16"): (168, 24),
    ("flash_fwd", 100, "bf16"): (128, 24), ("flash_bwd_dq", 100, "bf16"): (168, 0),
    ("flash_bwd_dkv", 100, "bf16"): (254, 0), ("flash_fwd", 128, "bf16"): (126, 0),
    ("flash_bwd_dq", 128, "bf16"): (159, 0), ("flash_bwd_dkv", 128, "bf16"): (254, 0),
    ("flash_bwd_dq", 256, "bf16"): (227, 0),
    ("flash_fwd", 32, "f32"): (158, 0), ("flash_bwd_dq", 32, "f32"): (197, 0),
    ("flash_bwd_dkv", 32, "f32"): (255, 32), ("flash_fwd", 64, "f32"): (203, 0),
    ("flash_bwd_dq", 64, "f32"): (197, 0), ("flash_bwd_dkv", 64, "f32"): (255, 32),
    ("flash_fwd", 100, "f32"): (246, 0), ("flash_bwd_dq", 100, "f32"): (162, 0),
    ("flash_bwd_dkv", 100, "f32"): (246, 0), ("flash_fwd", 128, "f32"): (245, 0),
    ("flash_bwd_dq", 128, "f32"): (162, 0), ("flash_bwd_dkv", 128, "f32"): (246, 0),
    ("flash_fwd", 256, "f32"): (241, 0), ("flash_bwd_dq", 256, "f32"): (182, 0),
    ("flash_bwd_dkv", 256, "f32"): (255, 16),
}


def _design(name, hd, dtype, b=2, s=1024, nh=8, nkv=1):
    if name == "flash_fwd":
        return tattn.flash_fwd_design(b, s, nh, hd, dtype=dtype)
    return tattn.flash_bwd_design(name, b, s, s, nh, nkv, hd, dtype=dtype)


def test_flash_ws_design_at_gemma_and_kept_widths(cuda):
    """At Gemma-2B's geometry's s1024 shape (B 2, S = T = 1024, 8 query
    heads to one KV head, hd 256) the bf16 forward and dK/dV are the
    warp-specialised kernels: two consumer warpgroups and a producer
    warpgroup (384 threads), a 2-slot ring, no spill; dK/dV's grid y is nkv
    * B (no column split). Every other kernel keeps the registers and
    spills pinned in KEPT_REGISTERS (their code is unchanged, but for the
    f32 dQ and dK/dV at 256 columns: the split design's)."""
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for name in ("flash_fwd", "flash_bwd_dkv"):
        d = _design(name, 256, torch.bfloat16)
        assert d["design"] == "wgmma_ws" and d["spill_bytes"] == 0, d
        assert d["warpgroups"] == 2 and d["threads"] == 384 and d["stages"] == 2, d
        assert d["blocks_per_sm"] == 1, d
    assert _design("flash_bwd_dkv", 256, torch.bfloat16)["grid_y"] == 1 * 2
    got = {key: (lambda d: (d["registers"], d["spill_bytes"]))(
        _design(key[0], key[1], dtypes[key[2]])) for key in KEPT_REGISTERS}
    assert got == KEPT_REGISTERS


# (b, sq, t, nh, nkv, q_start, kv_len): GQA at rep 8 and MHA, each with a
# ragged last query and key tile, a cached offset (q_start 30) and a dead
# row (kv_len 0)
F32_BWD_CASES = {"gqa": (3, 200, 230, 8, 1, [0, 30, 0], [200, 230, 0]),
                 "mha": (3, 200, 230, 4, 4, [0, 30, 0], [200, 230, 0])}


@pytest.mark.parametrize("shape", list(F32_BWD_CASES))
@pytest.mark.parametrize("hd", [32, 64, 100, 128, 132, 160, 252, 256])
def test_flash_bwd_f32_kernels_match_plain(cuda, hd, shape):
    """The f32 dQ and dK/dV kernels (each f32 product as three TF32
    tensor-core products) against their plain versions: within 1e-4 of
    max|plain|, zero gradients on the dead row, the same bits over two
    calls, one launch a call. Head dims 132, 160, 252 and 256 run in 256
    columns, where a pair of blocks splits hd (132: the second block holds
    4 real columns)."""
    b, sq, t, nh, nkv, q_start, kv_len = F32_BWD_CASES[shape]
    args = _bwd_args(cuda, b, sq, t, nh, nkv, hd, q_start, kv_len, torch.float32, seed=5)
    before = {n: _build.launches[n] for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    got = (tattn.flash_bwd_dq(*args), *tattn.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert {n: _build.launches[n] - c for n, c in before.items()} == dict.fromkeys(before, 1)
    again = (tattn.flash_bwd_dq(*args), *tattn.flash_bwd_dkv(*args))
    want = (tattn.flash_bwd_dq_reference(*args), *tattn.flash_bwd_dkv_reference(*args))
    dead = args[7] == 0
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and torch.equal(g, a)
        assert not bool(g[dead].any())
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_flash_bwd_f32_split_design_at_gemma(cuda):
    """At Gemma-2B's geometry's s1024 shape (B 2, S = T = 1024, 8 query
    heads to one KV head, hd 256) the f32 dQ and dK/dV kernels are the
    256-column split design: two warpgroups (256 threads) a block, taking
    every second item each through a slot of their own, one block an SM;
    clusters of two blocks that split hd (dQ: grid x 2 * nh), and for dK/dV
    two blocks for each of C parts of the pairs, C = 2 on a 132-SM card
    (32-key tiles: 32 key tiles x B 2 x 2 halves = 128 blocks; C stops at
    2). dQ spills nothing, dK/dV 16 bytes (the one-block design before it:
    24)."""
    dq, dkv = (_design(name, 256, torch.float32) for name in ("flash_bwd_dq", "flash_bwd_dkv"))
    for d in (dq, dkv):
        assert d["design"] == "wgmma_3xtf32_split", d
        assert d["warpgroups"] == 2 and d["threads"] == 256 and d["stages"] == 1, d
        assert d["blocks_per_sm"] == 1, d
    assert dq["spill_bytes"] == 0 and dkv["spill_bytes"] <= 16, (dq, dkv)
    assert dq["cluster"] == 2 and (dq["grid_x"], dq["grid_y"], dq["grid_z"]) == (16, 2, 32), dq
    assert (dkv["grid_y"], dkv["grid_z"]) == (2, 32) and dkv["grid_x"] == dkv["cluster"], dkv
    if dkv["sms"] != 132:
        pytest.skip(f"the cluster size is worked out for 132 SMs, not {dkv['sms']}")
    assert dkv["cluster"] == 4, dkv


def test_flash_bwd_f32_design_fills_the_card(cuda):
    """At TinyLlama-1.1B's s1024 training shape (B 2, S = T = 1024, 32 / 4
    heads, hd 64) each f32 backward kernel runs the 3xTF32 design on a grid
    of at least two blocks an SM (dK/dV's 128 key tiles split over
    clusters)."""
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        d = tattn.flash_bwd_design(name, 2, 1024, 1024, 32, 4, 64, dtype=torch.float32)
        assert d["design"] == "wgmma_3xtf32"
        assert d["grid_x"] * d["grid_y"] * d["grid_z"] >= 2 * d["sms"], d


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
    """Head dims above 256 (288, and 258 off a multiple of 4), fp16, and
    statistics of the wrong shape raise on the kernel route."""
    q, k, v, _ = _flash_inputs(cuda, 1, 16, 16, 2, 2, 288, torch.bfloat16)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(q, k, v, pos, pos + 16)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(*(x[..., :258].contiguous() for x in (q, k, v)), pos, pos + 16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tattn.flash_attention(*(x[..., :64].half() for x in (q, k, v)), pos, pos + 16)
    q, k, v, do = (x[..., :64].contiguous() for x in _flash_inputs(cuda, 1, 16, 16, 2, 2, 288,
                                                                  torch.bfloat16))
    stats = torch.zeros((1, 2, 15), device=cuda)  # one query row short
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_bwd_dq(q, k, v, do, stats, stats, pos, pos + 16)


@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_default_at_head_dim_80_matches_plain(cuda, dtype, hd):
    """A tiny Llama with head dim 80 (and 256) at S = 1024 with
    use_flash=None (which once took flash and raised there): n_layers flash
    launches, logits within rel-L2 1e-2 (bf16) / 1e-4 (f32) of the plain
    route. At head dim 288, which the kernels do not take, use_flash=None
    takes the einsum attention (no launch) and use_flash=True raises."""
    cfg = tllama.LlamaConfig.tiny(dim=2 * hd, n_heads=2, n_kv_heads=1, max_seq_len=1024,
                                  dtype=dtype)
    assert cfg.head_dim == hd
    params = tllama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 1024), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    logits = {}
    for use_kernel in (None, False):
        before = _build.launches["flash_fwd"]
        logits[use_kernel], _ = tllama.forward(params, toks, cfg, use_kernel=use_kernel)
        torch.cuda.synchronize()
        assert _build.launches["flash_fwd"] - before == (cfg.n_layers if use_kernel is None
                                                         else 0)
    assert torch.isfinite(logits[None]).all()
    assert _rel(logits[None], logits[False]) <= (1e-2 if dtype == torch.bfloat16 else 1e-4)
    wide = tllama.LlamaConfig.tiny(dim=576, n_heads=2, n_kv_heads=1, max_seq_len=1024,
                                   dtype=dtype)
    assert wide.head_dim == 288
    wparams = tllama.init_params(torch.Generator(device=cuda).manual_seed(0), wide, device=cuda)
    before = _build.launches["flash_fwd"]
    out, _ = tllama.forward(wparams, toks, wide)
    assert _build.launches["flash_fwd"] == before and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="head_dim"):
        tllama.forward(wparams, toks, wide, use_flash=True)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 100, 128, 160, 256])
def test_flash_fwd_without_lse_and_deterministic(cuda, hd, dtype):
    """save_lse=False (the prefill's call) writes the same output bits as
    with the lse, and two calls agree bit for bit (bf16 within 2 bf16 ulps
    of max|plain|, f32 within 1e-5 of it)."""
    q, k, v, _ = _flash_inputs(cuda, 2, 300, 330, 8, 2, hd, dtype, seed=4)
    qs = torch.tensor([0, 30], dtype=torch.int32, device=cuda)
    kl = torch.tensor([300, 330], dtype=torch.int32, device=cuda)
    out, lse = tattn.flash_forward(q, k, v, qs, kl, save_lse=True)
    again, none = tattn.flash_forward(q, k, v, qs, kl)
    assert none is None and lse is not None and torch.equal(out, again)
    ref, _ = tattn.flash_forward_reference(q, k, v, qs, kl)
    tol = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


# (causal, q_start): 4096 keys for every query row, and the causal rows of a
# 1096-token chunk cached after 0 and after 3000 tokens
LONG_KEY_CASES = [(False, [0, 0]), (True, [0, 3000])]


@pytest.mark.parametrize("causal,q_start", LONG_KEY_CASES)
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_fwd_f32_long_keys(cuda, hd, causal, q_start):
    """The f32 forward over T = 4096 keys (64 or 128 key tiles) stays within
    1e-5 of max|plain| and its lse within 1e-4: each tile's P V goes into a
    fresh partial that the CUDA cores fold in, so the tensor cores'
    truncating adds do not pile up along the keys."""
    b, sq, t, nh, nkv = 2, 1096, 4096, 8, 2
    q, k, v, _ = _flash_inputs(cuda, b, sq, t, nh, nkv, hd, torch.float32, seed=7)
    qs = torch.tensor(q_start, dtype=torch.int32, device=cuda)
    kl = torch.tensor([t, t], dtype=torch.int32, device=cuda)
    out, lse = tattn.flash_forward(q, k, v, qs, kl, causal=causal, save_lse=True)
    ref, ref_lse = tattn.flash_forward_reference(q, k, v, qs, kl, causal=causal)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_flash_fwd_f32_design_fills_the_card(cuda):
    """At TinyLlama-1.1B's s1024 training shape (B 2, S 1024, 32 heads, hd
    64) the f32 forward runs the 3xTF32 design on a grid of at least two
    blocks an SM; the bf16 forward reports its wgmma design."""
    d = tattn.flash_fwd_design(2, 1024, 32, 64, dtype=torch.float32)
    assert d["design"] == "wgmma_3xtf32"
    assert d["grid_x"] * d["grid_y"] * d["grid_z"] >= 2 * d["sms"], d
    assert tattn.flash_fwd_design(2, 1024, 32, 64)["design"] == "wgmma"


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


# Llama-2-7B's and -13B's (K, N) (q/k/v/o, gate/up, down, the head) at the
# decode M, the serve trace's prefill buckets, the 13B QLoRA row's M and the
# model-scale prefill's M, in nf4a with the quantizer's own padding (K 11008 and 13824 pad to
# 11264 and 14336)
MODEL_MM4_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                    (5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000)]


@pytest.mark.parametrize("m", [8, 64, 256, 512, 1024])
def test_matmul_4bit_model_scale_shapes_match_plain(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    for k, n in MODEL_MM4_SHAPES:
        w = torch.randn((k, n), generator=g, device=cuda) / math.sqrt(k)
        tq = tcore.quantize_matmul_weight(w, fmt="nf4a", block_size=64)
        x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        d = tmm.matmul_4bit_design(m, tq.codes.shape[1], 2 * tq.codes.shape[0])
        assert d["design"] == ("decode" if m <= 32 else "prefill"), (k, n, d)
        before = _build.launches["matmul_4bit"]
        out = tmm.matmul_quantized(x, tq)
        ref = tmm.matmul_quantized(x, tq, use_kernel=False)
        torch.cuda.synchronize()
        assert _build.launches["matmul_4bit"] == before + 1
        assert out.shape == ref.shape == (m, n)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= _tol(ref, torch.bfloat16), (k, n, err)
        assert torch.equal(out, tmm.matmul_quantized(x, tq)), (k, n)


# OpenLLaMA-3B v2's (K, N) (q/k/v/o, gate/up, down, the head) with the
# quantizer's own padding at block 64: K 3200 -> 4096 and 8640 -> 9216, N
# 8640 -> 8704; N 3200 is 25 tiles of 128, an odd count
OPENLLAMA_3B_SHAPES = [(3200, 3200), (3200, 8640), (8640, 3200), (3200, 32000)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [8, 256, 2048])
def test_openllama_3b_shapes_match_plain(cuda, m, dtype):
    """#1 (nf4a) and #3 (int8) forward and, through autograd, #4 and #5's
    dx at OpenLLaMA-3B's (K, N) for a decode step (M 8), a prefill bucket
    (256) and its QLoRA row (b2 x s1024): each within 2 bf16 ulps (f32:
    1e-5) of max|plain|, one launch of each kernel a call."""
    _linears_match_plain(cuda, OPENLLAMA_3B_SHAPES, m, dtype, seed=m + 3)


def _linears_match_plain(cuda, shapes, m, dtype, seed):
    """#1 (nf4a) and #3 (int8) forward and #4 and #5's dx through autograd
    at each (K, N) of ``shapes``, M rows, against the plain route."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    for k, n in shapes:
        w = torch.randn((k, n), generator=g, device=cuda) / math.sqrt(k)
        x0 = torch.randn((m, k), generator=g, device=cuda).to(dtype)
        gr = torch.randn((m, n), generator=g, device=cuda).to(dtype)
        for fmt, fwd, bwd in (("nf4a", "matmul_4bit", "matmul_4bit_t"),
                              ("int8", "matmul_8bit", "matmul_8bit_t")):
            tq = tcore.quantize_matmul_weight(w, fmt=fmt, block_size=64)
            outs = {}
            for use_kernel in (None, False):
                x = x0.clone().requires_grad_()
                before = dict(_build.launches)
                out = tmm.matmul_quantized(x, tq, use_kernel=use_kernel)
                out.backward(gr)
                torch.cuda.synchronize()
                n_launch = int(use_kernel is None)
                assert (_build.launches[fwd] - before[fwd], _build.launches[bwd] - before[bwd]) \
                    == (n_launch, n_launch), (k, n, fmt)
                outs[use_kernel] = (out.detach(), x.grad)
            for got, ref in zip(outs[None], outs[False]):
                assert got.shape == ref.shape and got.dtype == dtype
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= _tol(ref, dtype), (k, n, fmt, m, err)


# Gemma-2B's geometry (google/gemma-2b's config.json, run in the repo's
# Llama block: no Gemma support): (K, N) of wq / wo, wk / wv (one KV head of
# 256), gate / up and down (its head is tied to the bf16 embedding)
GEMMA_2B_SHAPES = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [8, 2048])
def test_gemma_2b_geometry_shapes_match_plain(cuda, m, dtype):
    """#1 (nf4a) and #3 (int8) forward and, through autograd, #4 and #5's
    dx at Gemma-2B's (K, N) for a decode step (M 8) and its QLoRA row (b2
    x s1024): each within 2 bf16 ulps (f32: 1e-5) of max|plain|, one launch
    of each kernel a call; and the three flash kernels at its attention (hd
    256, 8 query heads to one KV head) at S 1024 against their plain
    versions."""
    _linears_match_plain(cuda, GEMMA_2B_SHAPES, m, dtype, seed=m + 5)
    if m != 2048:
        return
    args = _bwd_args(cuda, 2, 1024, 1024, 8, 1, 256, [0, 0], [1024, 1024], dtype, seed=6)
    q, k, v, _, _, _, qs, kl = args
    out, lse = tattn.flash_forward(q, k, v, qs, kl, save_lse=True)
    ref, ref_lse = tattn.flash_forward_reference(q, k, v, qs, kl)
    got = (tattn.flash_bwd_dq(*args), *tattn.flash_bwd_dkv(*args))
    want = (tattn.flash_bwd_dq_reference(*args), *tattn.flash_bwd_dkv_reference(*args))
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    big = ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        assert (out.float() - ref.float()).abs().max().item() <= 2 * 2.0 ** -7 * big
        assert _rel(out, ref) <= 1e-2 and all(_rel(a, b) <= 2e-2 for a, b in zip(got, want))
    else:
        assert (out - ref).abs().max().item() <= 1e-5 * big
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


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


@pytest.mark.parametrize("fmt", ["nf4", "nf4a"])
def test_matmul_4bit_t_13b_shapes_match_plain(cuda, fmt):
    """Llama-2-13B's (K, N) with the head at its QLoRA row's M (b1 x
    s512), with the quantizer's own padding (13824 pads to 14336)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    for k, n in [(5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000)]:
        tq = tcore.quantize_matmul_weight(torch.randn((k, n), generator=g, device=cuda) * 0.1,
                                          fmt=fmt, block_size=64)
        gr = torch.randn((512, n), generator=g, device=cuda).to(torch.bfloat16)
        d = tmm.matmul_4bit_t_design(512, tq.codes.shape[1], 2 * tq.codes.shape[0])
        assert d["design"] == "wgmma"
        before = _build.launches["matmul_4bit_t"]
        out = _mm4t_check(gr, tq.codes, tq.scale, tq.codebook, 64)
        assert _build.launches["matmul_4bit_t"] == before + 1
        assert torch.equal(out, tmm.matmul_4bit_t(gr, tq.codes, tq.scale, codebook=fmt))


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


# ------------------------------------------------------------------ GPT-2
# GPT-2 small's linears (K, N), each with a bias: attn_qkv, attn_out,
# mlp_fc, mlp_out. The 4-bit layout pads K = 768 to 1024; LLM.int8 keeps
# K = 768, new ground for its split-K decode (TinyLlama's least K is 2048).
GPT2_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize("dtype,m", [(torch.bfloat16, 8), (torch.bfloat16, 64),
                                     (torch.bfloat16, 1024), (torch.float32, 8),
                                     (torch.float32, 64)], ids=lambda v: str(v).split(".")[-1])
@pytest.mark.parametrize("k,n", GPT2_SHAPES)
def test_gpt2_matmul_4bit_with_bias(cuda, k, n, dtype, m):
    """nf4a at GPT-2's shapes: the kernel within 2 bf16 ulps (f32: 1e-5) of
    max|plain|, one launch, the same bits on a second call; the linear's
    bias is added after the kernel, as on the plain route."""
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    qt = tcore.quantize_matmul_weight((torch.randn((k, n), generator=g, device=cuda) * 0.02)
                                      .to(dtype), fmt="nf4a", block_size=64)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    b = (torch.randn(n, generator=g, device=cuda) * 0.1).to(dtype)
    before = _build.launches["matmul_4bit"]
    out = tmm.matmul_quantized(x, qt)
    assert _build.launches["matmul_4bit"] == before + 1
    ref = tmm.matmul_quantized(x, qt, use_kernel=False)
    assert out.dtype == ref.dtype == dtype and out.shape == ref.shape == (m, n)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, dtype)
    assert torch.equal(tnn.linear(x, qt, b), out + b)


@pytest.mark.parametrize("m", [1, 8, 64, 256, 1024])
@pytest.mark.parametrize("k,n", GPT2_SHAPES)
def test_gpt2_matmul_int8_fused_with_bias(cuda, k, n, m):
    """LLM.int8 at GPT-2's shapes, f32 x: both entry points bit for bit
    against their plain versions, and the linear with its bias equal to
    the plain route's."""
    qw, x, rs, y_out = _i8_operands(cuda, m, k, n, seed=k + n + m)
    _i8_check(x, qw.codes, rs, qw.scale, y_out)
    b = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    before = _build.launches["matmul_int8_fused"]
    out = tnn.linear(x, qw, b)
    assert _build.launches["matmul_int8_fused"] == before + 1
    assert torch.equal(out, tnn.linear(x, qw, b, use_kernel=False))


def test_tiny_gpt2_engine_llm_int8_kv8_kernels_match_plain(cuda):
    """GPT-2 through the engine (``arch="gpt2"``), LLM.int8 weights and the
    int8 pool: the plain path's tokens, 4 L fused int8 GEMMs a forward (the
    tied head stays dense) and one K+V pool write a prefill and a window."""
    cfg = tgpt2.GPT2Config.tiny(dim=256, n_heads=4, max_seq_len=128)
    dense = tgpt2.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    params = tnn.quantize_params(dense, mode="llm_int8")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 33, 9)]
    outs = {}
    for use_kernel in (None, False):
        eng = Engine(params, cfg, n_slots=2, page_size=8, prefill_buckets=(16, 32, 64),
                     kv_quant=True, multi_step=4, use_kernel=use_kernel, arch="gpt2")
        _build.reset_launches()
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=10)
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        outs[use_kernel] = {r.uid: r.output for r in done}
        m = eng.metrics()
        expected = dict.fromkeys(_build.launches, 0)
        if use_kernel is None:
            expected["matmul_int8_fused"] = 4 * cfg.n_layers * (m["admissions"]
                                                                + 4 * m["decode_steps"])
            expected["quantize_blockwise"] = m["admissions"] + m["decode_steps"]
        assert dict(_build.launches) == expected
    assert outs[None] == outs[False]
    assert all(len(o) == 10 for o in outs[None].values())


def test_safetensors_codec_on_cuda_tensors(cuda, tmp_path):
    """The port's safetensors codec writes CUDA tensors and reads them back
    onto the card, bit for bit, in every dtype it reads."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((5, 7), generator=g, device=cuda)
    tensors = {"f32": x, "f16": x.half(), "bf16": x.bfloat16(), "t": x.T,
               "i8": (x * 40).to(torch.int8), "u8": (x.abs() * 40).to(torch.uint8),
               "i32": (x * 1e6).to(torch.int32), "i64": (x * 1e12).to(torch.int64)}
    path = str(tmp_path / "cuda.safetensors")
    thf.write_safetensors(tensors, path)
    back = thf.read_safetensors(path, device=cuda)
    assert sorted(back) == sorted(tensors)
    for k, t in tensors.items():
        assert back[k].device.type == "cuda" and back[k].dtype == t.dtype, k
        assert torch.equal(back[k], t), k


@pytest.mark.parametrize("route", [{}, {"fused": False}, {"use_kernel": False}],
                         ids=["fused", "unfused", "plain"])
def test_matmul_int8_never_waits_for_the_device(cuda, route):
    """An LLM.int8 decode call queues its work and returns: no copy from
    host memory and no stream synchronize (the outlier columns' zeroing,
    an index assignment of a Python 0.0, did both on every call, so the
    device idled while the host caught up)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(0)
    qw = tint8.quantize_int8_weight(torch.randn((2048, 2048), generator=g, device=cuda))
    x = torch.randn((8, 2048), generator=g, device=cuda).to(torch.bfloat16)
    tint8.matmul_int8(x, qw, **route)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tint8.matmul_int8(x, qw, **route)
    names = {e.name for e in prof.events()}
    assert not names & {"cudaStreamSynchronize", "cudaMemcpyAsync"}, sorted(names)


# ------------------------------------------------ f32 routes of #1 and #3
# matmul_4bit's and matmul_8bit's f32 entry points: split-K FMA decode up
# to M = 32, the 128 x 128 FMA GEMM above. f32 products of the same
# weights as the plain versions, f32 sums in another order: within 1e-5 of
# max|plain|; partials summed in a fixed order: the same bits on a second
# call. GPT-2 small's four (K, N) and the accuracy proxy's four.
F32_MS = [1, 8, 17, 32, 33, 128, 1024]
F32_SHAPES = GPT2_SHAPES + [(512, 512), (512, 128), (512, 1536), (1536, 512)]
FOUR_BIT_CODEBOOKS = ["nf4a", "nf4", "int4", "fp4"]


def _f32_route_check(x, qt, kernel):
    """matmul_quantized on f32 x: one launch of ``kernel``, within 1e-5 of
    max|plain|, the same bits on a second call; returns the output."""
    before = _build.launches[kernel]
    out = tmm.matmul_quantized(x, qt)
    again = tmm.matmul_quantized(x, qt)
    ref = tmm.matmul_quantized(x, qt, use_kernel=False)
    torch.cuda.synchronize()
    assert _build.launches[kernel] == before + 2
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("m", F32_MS)
@pytest.mark.parametrize("k,n", F32_SHAPES)
def test_matmul_f32_routes_match_plain(cuda, k, n, m):
    """nf4a through matmul_4bit and int8 through matmul_8bit on f32 x, and
    the design each call takes (its name by M, a K split in 1..8)."""
    g = torch.Generator(device=cuda).manual_seed(k * n + m)
    w = torch.randn((k, n), generator=g, device=cuda) * 0.02
    x = torch.randn((m, k), generator=g, device=cuda)
    for fmt, kernel, report in (("nf4a", "matmul_4bit", tmm.matmul_4bit_design),
                                ("int8", "matmul_8bit", tmm.matmul_8bit_design)):
        qt = tcore.quantize_matmul_weight(w, fmt=fmt, block_size=64)
        _f32_route_check(x, qt, kernel)
        k_pad = qt.codes.shape[0] * (2 if kernel == "matmul_4bit" else 1)
        d = report(m, qt.codes.shape[1], k_pad, dtype=torch.float32)
        assert d["design"] == ("fma_decode" if m <= 32 else "fma_prefill")
        assert 1 <= d["split"] <= 8 and d["spill_bytes"] <= 64


@pytest.mark.parametrize("m", [8, 33])
@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("fmt", FOUR_BIT_CODEBOOKS + EIGHT_BIT)
def test_matmul_f32_routes_every_format_and_block(cuda, fmt, block, m):
    """Every 16-entry codebook through matmul_4bit and every 8-bit format
    (int8's signed codes, int8a's unsigned ones with its zero-point term
    outside the kernel, nf8, fp8) through matmul_8bit, at blocks 32, 64 and
    128, on either side of the design switch."""
    g = torch.Generator(device=cuda).manual_seed(block + m)
    w = torch.randn((768, 768), generator=g, device=cuda) * 0.02
    x = torch.randn((m, 768), generator=g, device=cuda)
    qt = tcore.quantize_matmul_weight(w, fmt=fmt, block_size=block)
    _f32_route_check(x, qt, "matmul_8bit" if fmt in EIGHT_BIT else "matmul_4bit")


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("bits,k,n,block", [(4, 416, 72, 32), (4, 400, 72, 8), (4, 2048, 200, 64),
                                            (8, 192, 72, 64), (8, 200, 72, 8), (8, 1000, 200, 40)])
def test_matmul_f32_raw_ragged(cuda, bits, k, n, block, m):
    """Unpadded codes: K, N and M off every tile, blocks that stage one scale
    row a slice or step and blocks that read their scales row by row."""
    g = torch.Generator(device=cuda).manual_seed(k + n + block + m)
    rows = k // 2 if bits == 4 else k
    codes = torch.randint(0, 256, (rows, n), generator=g, device=cuda, dtype=torch.uint8)
    scales = torch.rand((k // block, n), generator=g, device=cuda) * 0.01
    x = torch.randn((m, k), generator=g, device=cuda)
    fn = tmm.matmul_4bit if bits == 4 else tmm.matmul_8bit
    kw = {"codebook": "nf4"} if bits == 4 else {"codebook": "nf8"}
    out = fn(x, codes, scales, block=block, **kw)
    ref = fn(x, codes, scales, block=block, use_kernel=False, **kw)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(out, fn(x, codes, scales, block=block, **kw))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k_pad,m", [(1024, 16), (3072, 48)], ids=["decode", "prefill"])
def test_matmul_f32_split_covers_every_k_block(cuda, bits, k_pad, m):
    """A K split that leaves out or repeats a block of K shows here: row i of
    x is nonzero only in block i % blocks, so each row of the output is the
    product of one block of W's rows, and each must equal the plain
    version's. The shapes split K over a cluster (split > 1) in both
    designs."""
    g = torch.Generator(device=cuda).manual_seed(k_pad + bits)
    n, block = 768, 64
    qt = tcore.quantize_matmul_weight(torch.randn((k_pad, n), generator=g, device=cuda),
                                      fmt="nf4a" if bits == 4 else "int8", block_size=block)
    blocks = k_pad // block
    x = torch.zeros((m, k_pad), device=cuda)
    for i in range(m):
        b = i % blocks
        x[i, b * block:(b + 1) * block] = torch.randn(block, generator=g, device=cuda)
    kernel = "matmul_4bit" if bits == 4 else "matmul_8bit"
    report = tmm.matmul_4bit_design if bits == 4 else tmm.matmul_8bit_design
    assert report(m, n, k_pad, dtype=torch.float32)["split"] > 1
    out = _f32_route_check(x, qt, kernel)
    ref = tmm.matmul_quantized(x, qt, use_kernel=False)
    scale = ref.abs().amax(dim=1)
    assert bool((scale > 0).all())
    assert bool(((out - ref).abs().amax(dim=1) <= 1e-5 * scale).all())


# ------------------------------------------------ f32 routes of #4 and #5
# matmul_4bit_t's and matmul_8bit_t's f32 entry points: 128 x 128 dx tiles,
# each f32 product as three TF32 products on the tensor cores, each
# 32-column step of N summed on the tensor cores and added to the running
# sum on the CUDA cores (csrc/tf32x3_sm90.cuh). The same f32 weights as the
# plain versions, products to ~2^-22 and sums in another order: within 1e-5
# of max|plain|. Where N is split over a cluster, the partials are summed
# in rank order (cluster_sum): the same bits on a second call. GPT-2
# small's four (K, N) at M = 1024, the accuracy proxy's at M = 8192 and
# TinyLlama-1.1B's five at its QLoRA backward's M = 2048 (the head's N =
# 32000 among them).
F32_T_CASES = ([(kn, 1024) for kn in GPT2_SHAPES]
               + [(kn, 8192) for kn in [(512, 512), (512, 128), (512, 1536), (1536, 512)]]
               + [(kn, 2048) for kn in [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                                        (2048, 32000)]])
T_F32_MS = [1, 130, 257]


def _f32_t_check(g, qt):
    """matmul_4bit_t or matmul_8bit_t, as ``qt``'s layout takes, on f32 g:
    one launch a call, within 1e-5 of max|plain|, the same bits on a second
    call; returns the output."""
    fn, kernel = ((tmm.matmul_4bit_t, "matmul_4bit_t") if qt.packed == "split_k"
                  else (tmm.matmul_8bit_t, "matmul_8bit_t"))
    codes, scales, codebook, block = qt.codes, qt.scale, qt.codebook, qt.block_size
    before = _build.launches[kernel]
    out = fn(g, codes, scales, codebook=codebook, block=block)
    again = fn(g, codes, scales, codebook=codebook, block=block)
    ref = fn(g, codes, scales, codebook=codebook, block=block, use_kernel=False)
    torch.cuda.synchronize()
    assert _build.launches[kernel] == before + 2
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= _tol(ref, torch.float32)
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("k,n,m", [(k, n, m) for (k, n), m in F32_T_CASES])
def test_matmul_t_f32_routes_match_plain(cuda, k, n, m):
    """nf4a through matmul_4bit_t and int8 through matmul_8bit_t on f32 g,
    and the design each call takes: the one 3xTF32 design, no spills, a
    grid of 128-row tiles by 128 dx columns, N split over a cluster of up
    to 8 only where those tiles are under two waves of the SMs."""
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    w = torch.randn((k, n), generator=g, device=cuda) * 0.02
    gr = torch.randn((m, n), generator=g, device=cuda)
    for fmt, report in (("nf4a", tmm.matmul_4bit_t_design), ("int8", tmm.matmul_8bit_t_design)):
        qt = tcore.quantize_matmul_weight(w, fmt=fmt, block_size=64)
        out = _f32_t_check(gr, qt)
        k_pad = out.shape[1]
        d = report(m, qt.codes.shape[1], k_pad, dtype=torch.float32)
        assert d["design"] == "wgmma_3xtf32" and 1 <= d["split"] <= 8 and d["spill_bytes"] == 0
        assert (d["grid_x"], d["grid_y"], d["grid_z"], d["rows"]) == (
            d["split"], k_pad // 128, -(-m // 128), 128)
        if (k_pad // 128) * -(-m // 128) >= 2 * sms:
            assert d["split"] == 1


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("fmt", FOUR_BIT_CB + ["int4a"] + EIGHT_BIT)
def test_matmul_t_f32_every_format_and_block(cuda, fmt, block):
    """Every 16-entry codebook (int4a's codes their own values) and every
    8-bit format (int8's signed codes, int8a's unsigned ones, nf8, fp8) at
    blocks 32, 64 and 128, M in ``T_F32_MS`` (one row, past one and past
    two 128-row tiles); K = 1000 and N = 300 are off the tiles before the
    quantizer pads them."""
    g = torch.Generator(device=cuda).manual_seed(block)
    qt = tcore.quantize_matmul_weight(torch.randn((1000, 300), generator=g, device=cuda) * 0.02,
                                      fmt=fmt, block_size=block)
    for m in T_F32_MS:
        gr = torch.randn((m, qt.codes.shape[1]), generator=g, device=cuda)
        _f32_t_check(gr, qt)


@pytest.mark.parametrize("m", [5, 130])
@pytest.mark.parametrize("bits,rows,n,block", [(4, 200, 72, 16), (4, 100, 70, 40),
                                               (4, 208, 203, 32), (4, 1024, 300, 64),
                                               (8, 200, 77, 40), (8, 96, 203, 32),
                                               (8, 1000, 300, 8), (8, 992, 200, 32)])
def test_matmul_t_f32_raw_ragged(cuda, bits, rows, n, block, m):
    """Unpadded codes: packed rows off the 64-row (4-bit) and 128-row
    (8-bit) tiles, N off 4 (g staged value by value) and off 16 (codes byte
    by byte), blocks that stage a scale row per 32 dx columns and blocks
    that read their scales weight by weight, M off the 128-row tile."""
    g = torch.Generator(device=cuda).manual_seed(rows + n + block + m)
    codes = torch.randint(0, 256, (rows, n), generator=g, device=cuda, dtype=torch.uint8)
    k = 2 * rows if bits == 4 else rows
    scales = torch.rand((k // block, n), generator=g, device=cuda) * 0.01
    gr = torch.randn((m, n), generator=g, device=cuda)
    fn = tmm.matmul_4bit_t if bits == 4 else tmm.matmul_8bit_t
    cb = "nf4" if bits == 4 else "nf8"
    out = fn(gr, codes, scales, codebook=cb, block=block)
    ref = fn(gr, codes, scales, codebook=cb, block=block, use_kernel=False)
    assert out.shape == ref.shape == (m, k)
    assert (out - ref).abs().max().item() <= _tol(ref, torch.float32)
    assert torch.equal(out, fn(gr, codes, scales, codebook=cb, block=block))


@pytest.mark.parametrize("bits", [4, 8])
def test_matmul_t_f32_sums_every_n_step(cuda, bits):
    """A step of N left out of the sum, or added twice, shows here: row i of
    g is nonzero only in the 32 columns of step i % steps, so each dx row
    is the product of one step's columns of W, and each must equal the
    plain version's within 1e-5 of that row's own max. N = 2048 gives 64
    steps; 130 rows cover them all twice, across two row tiles; the 16
    tiles split N over a cluster, so each rank's run of steps and the
    cluster's sum are covered too."""
    g = torch.Generator(device=cuda).manual_seed(bits)
    n, m, step = 2048, 130, 32
    qt = tcore.quantize_matmul_weight(torch.randn((1024, n), generator=g, device=cuda),
                                      fmt="nf4a" if bits == 4 else "int8", block_size=64)
    gr = torch.zeros((m, n), device=cuda)
    for i in range(m):
        s = i % (n // step)
        gr[i, s * step:(s + 1) * step] = torch.randn(step, generator=g, device=cuda)
    report = tmm.matmul_4bit_t_design if bits == 4 else tmm.matmul_8bit_t_design
    assert report(m, n, 1024, dtype=torch.float32)["split"] > 1
    out = _f32_t_check(gr, qt)
    fn = tmm.matmul_4bit_t if bits == 4 else tmm.matmul_8bit_t
    ref = fn(gr, qt.codes, qt.scale, codebook=qt.codebook, use_kernel=False)
    scale = ref.abs().amax(dim=1)
    assert bool((scale > 0).all())
    assert bool(((out - ref).abs().amax(dim=1) <= 1e-5 * scale).all())


# ------------------------------------------------ tensor-parallel local shapes

# (K, N) of Llama-2-7B's and -13B's linears and their TP split (1: N, the
# column-parallel ones; 0: K, the row-parallel ones, whose output runs in
# two chunks): at tp = 2 the local shapes are new ground for the kernels'
# designs (13B: w_down's K_loc 6912 pads to 7168, w_gate/w_up's N_loc is
# 6912, wq/wk/wv's 2560)
TP_LINEARS = {
    "7b": {"wq": (4096, 4096, 1), "wo": (4096, 4096, 0), "w_gate": (4096, 11008, 1),
           "w_down": (11008, 4096, 0), "lm_head": (4096, 32000, 1)},
    "13b": {"wq": (5120, 5120, 1), "wo": (5120, 5120, 0), "w_gate": (5120, 13824, 1),
            "w_down": (13824, 5120, 0), "lm_head": (5120, 32000, 1)},
}


@pytest.mark.parametrize("fmt,kernel", [("nf4a", "matmul_4bit"), ("int8", "matmul_8bit")])
@pytest.mark.parametrize("model", ["7b", "13b"])
def test_tp_shards_match_plain_at_model_shapes(cuda, model, fmt, kernel):
    """Each rank's shards from ``from_global`` (tp = 2, row-parallel ones
    in two chunks) through its kernel at decode and prefill M, within 2
    bf16 ulps of max|plain|, one launch a call, its design reported."""
    from quanta_tpu_torch.parallel import from_global

    g = torch.Generator(device=cuda).manual_seed(0)
    for name, (k, n, axis) in TP_LINEARS[model].items():
        w = torch.randn((k, n), generator=g, device=cuda) / math.sqrt(k)
        sq = from_global(tcore.quantize_matmul_weight(w, fmt=fmt), 2, axis=axis)
        for rank in range(2):
            parts = sq.shard(rank, n_chunks=2)
            for qt in parts if axis == 0 else (parts,):
                k_loc, n_loc = qt.shape
                for m in (8, 128):
                    x = torch.randn((m, k_loc), generator=g, device=cuda).to(torch.bfloat16)
                    before = _build.launches[kernel]
                    out = tmm.matmul_quantized(x, qt)
                    ref = tmm.matmul_quantized(x, qt, use_kernel=False)
                    torch.cuda.synchronize()
                    assert _build.launches[kernel] == before + 1
                    assert out.shape == (m, n_loc) == ref.shape
                    tol = 2.0 ** -6 * ref.float().abs().max().item()
                    err = (out.float() - ref.float()).abs().max().item()
                    assert err <= tol, (model, name, rank, m, err, tol)
                    if fmt == "nf4a":
                        k_pad = 2 * qt.codes.shape[0]
                        design = tmm.matmul_4bit_design(m, qt.codes.shape[1], k_pad)
                        assert design["design"] == ("decode" if m <= 32 else "prefill")


def test_gloo_collectives_take_cuda_tensors(cuda):
    """Two ranks sharing the card over gloo: the mesh hands its
    collectives CUDA tensors as they are; the async all-reduces (bf16 and
    f32 in flight together) and the all-gather come back on the card,
    right."""
    import torch_tp_worker
    from quanta_tpu_torch.parallel import spawn_local

    res = spawn_local(torch_tp_worker.mesh_collectives, 2, 1, 2, "cuda", timeout=120)
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for out in res:
        np.testing.assert_array_equal(out["model"]["sum_f32"], 2 * base + 10)
        np.testing.assert_array_equal(out["model"]["sum_bf16"], 2 * base + 10)
        np.testing.assert_array_equal(out["model"]["gather"],
                                      np.concatenate([base, base + 10], 1))


def test_spmd_gather_autograd_on_the_card(cuda):
    """Two ranks sharing the card over gloo: ``parallel.spmd``'s gather
    Function on CUDA tensors (forward: the ranks' slices in order;
    backward: summed over 'data', the rank's own slice over 'model') and
    an nf4 linear split along K on 'data', gathered at use through
    ``matmul_4bit`` and, for dx, ``matmul_4bit_t``, against the unsharded
    linear."""
    import torch_spmd_worker
    from quanta_tpu_torch.parallel import spawn_local

    torch_spmd_worker.check_gather_grads(spawn_local(torch_spmd_worker.gather_grads, 2, "cuda",
                                                     timeout=120))


def test_tp_two_ranks_on_one_card_match_single_card(cuda):
    """Two ranks share the card over gloo: a Llama-2-7B-width model of 2
    layers in nf4a, each rank's shards drawn through ``from_global``; rank
    0's prefill logits within the rule of the single-card forward, the
    launches per forward as designed and the greedy tokens agreeing across
    ranks (checked inside ``tp_bench.rank_main``)."""
    from quanta_tpu_torch.benchmarks import tp_bench
    from quanta_tpu_torch.parallel import spawn_local

    leg = dict(model="7b", fmt="nf4a", layers=2, batch=2, prompt_len=16, new=4)
    rows = [r[0] for r in spawn_local(tp_bench.rank_legs, 2, [leg], timeout=300)]
    assert [r["rank"] for r in rows] == [0, 1]
    assert rows[0]["prefill_logits_rel_l2"] <= rows[0]["tol"]
    for r in rows:
        assert r["launches_per_forward"] == {"matmul_4bit": (5 + 2 * 2) * 2 + 1}
