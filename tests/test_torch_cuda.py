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
the output and 1e-4 for gradients. ``matmul_8bit`` and ``matmul_8bit_t``
read the same 256-entry level table as their plain versions and differ
only in f32 summation order: bf16 within 2 bf16 ulps of max|plain|, f32
within 1e-5 of it.
"""

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
@pytest.mark.parametrize("n,block,dtype", [(64 * 1000, 64, torch.float32),
                                           (1000, 64, torch.bfloat16),
                                           (517, 32, torch.float32),
                                           (1000, 100, torch.float32)])
def test_quantize_blockwise_bit_exact(cuda, fmt, n, block, dtype):
    g = torch.Generator(device=cuda).manual_seed(n + block)
    x = (torch.randn(n, generator=g, device=cuda) * 3).to(dtype)
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
    every prefill and window writes K and V through one quantize each."""
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
            expected["quantize_blockwise"] = 2 * (m["admissions"] + m["decode_steps"])
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


def test_tiny_qlora_step_kernels_match_plain(cuda):
    """Two QLoRA steps (nf4 base, bf16 adapters) through the kernels and
    through the plain versions: step-1 loss within 1e-2 relative, step-1
    lora_b gradients within rel-L2 3e-2, lora_a gradients zero; the
    launches the design implies (layer 0's wq, wk, wv need no dx)."""
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
                            adam8bit_update=4 * cfg.n_layers)
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
# ragged case without the causal mask
FLASH_CASES = [
    (2, 64, 64, 4, 2, [0, 0], [64, 64], True),
    (2, 50, 77, 4, 1, [0, 27], [50, 77], True),
    (3, 70, 130, 2, 2, [0, 60, 0], [70, 130, 0], True),
    (2, 50, 77, 4, 1, [0, 27], [50, 77], False),
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
