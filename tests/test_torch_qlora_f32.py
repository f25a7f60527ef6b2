"""QLoRA on an f32 base: the f32 routes of the transposed kernels and the
f32 QLoRA step against the JAX package, on the CPU.

The JAX package runs this as ``finetune --toy tinyllama --dtype float32``:
an f32 Llama, quantized, with LoRA on wq and wv and 8-bit Adam. On the CPU
the port's ``matmul_4bit_t`` / ``matmul_8bit_t`` run their plain versions
(the CUDA kernels, the 3xTF32 dx tiles of ``csrc/tf32x3_sm90.cuh``,
against those: tests/test_torch_cuda.py), and the kernel routes of the
step run through ``torch_fakes.FakeKernels``, whose f32 entry points run
the plain arithmetic on the tensors behind the pointers; the JAX side runs
its Pallas kernels in interpret mode, or its XLA route inside the step.
The step runs with the einsum attention and, as ``finetune --dtype
float32 --seq-len 1024`` runs it on the JAX package's chip, through flash
attention (the Pallas flash kernels interpreted; the port's flash entry
points faked; the CUDA kernels, the f32 dQ and dK/dV of
``csrc/flash_bwd_f32.cu``, against their plain versions:
tests/test_torch_cuda.py). Inputs come from numpy seeds and are handed to
both.

Tolerances:
  - the transposed products, every format and block: rtol 1e-5 and atol
    1e-5 of max|JAX| (the same f32 weights and products, summed in another
    order; nf8's table differs from the TPU kernel's f32 tanh in the last
    bit, 2.4e-7 at most, which moves an output by up to ~2.4e-7 of its
    terms' sum of magnitudes: an absolute error, so atol scales with the
    output, as the repo's f32 rule, 1e-5 of max|plain|, does);
  - the step: loss within rel 1e-4 and each lora_b gradient within rel-L2
    1e-4 of JAX's at every step, the port started before each step from
    JAX's adapters and 8-bit state, so that a step's differences are its
    own (Adam divides each element by its own sqrt(v_hat), which turns the
    frameworks' f32 rounding of a gradient into a step of up to lr).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from unittest import mock

import torch_fakes
from quanta_tpu import core as jcore
from quanta_tpu import nn as jnn
from quanta_tpu import optim as joptim
from quanta_tpu import train as jtrain
from quanta_tpu.models import llama as jllama
from quanta_tpu.ops import matmul as jmm
from quanta_tpu_torch import core as tcore
from quanta_tpu_torch import interop
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch import train as ttrain
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import matmul as tmm
from quanta_tpu_torch.ops.adam8bit import STATE_KEYS
from quanta_tpu_torch.optim import Adam8bit

# the package attribute ``quanta_tpu.optim.adam8bit`` is the function
jadam = importlib.import_module("quanta_tpu.optim.adam8bit")

FOUR_BIT = ["nf4a", "nf4", "int4", "fp4", "int4a"]
EIGHT_BIT = ["int8", "int8a", "nf8", "fp8"]
# the dx tile's edges: one row, one past a 128-row tile, one past two
T_MS = (1, 130, 257)
REL = 1e-5
# TinyLlama-1.1B's 32 / 4 heads at 2 layers and a narrow width
CFG_KW = dict(dim=256, n_layers=2, n_heads=32, n_kv_heads=4, hidden_dim=512)
STEP_REL = 1e-4
# the flash steps: head dim 32 (the smallest compiled width of the flash
# kernels), rep 8; and OpenLLaMA-3B's head dim, 100, which they run padded
# to 128 columns (2 heads, MHA as OpenLLaMA's)
FLASH_CFG_KW = dict(dim=256, n_layers=2, n_heads=8, n_kv_heads=1, hidden_dim=512)
FLASH_HD100_KW = dict(dim=200, n_layers=2, n_heads=2, n_kv_heads=2, hidden_dim=512)
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_ENTRIES = {f"qt_{k}_f32" for k in FLASH_KERNELS}
LR = 1e-2
# the kernels an f32 base's linears launch, and the entry points they reach
ROUTES = {"nf4": (("matmul_4bit", "matmul_4bit_t"), {"qt_matmul_4bit_f32", "qt_matmul_4bit_t_f32"}),
          "int8": (("matmul_8bit", "matmul_8bit_t"), {"qt_matmul_8bit_f32", "qt_matmul_8bit_t_f32"})}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("fmt", FOUR_BIT + EIGHT_BIT)
def test_transposed_f32_plain_matches_jax_kernel(fmt, block):
    """dx = g W^T in f32 through the port's plain version against the
    Pallas kernel (interpret), codes and scales equal, at M in ``T_MS``: K
    = 300 and N = 200 are off the 128-wide tiles (the quantizer pads them
    to 512 and 256)."""
    w = _rand((300, 200), block)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=block)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=block)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    jfn, tfn = ((jmm.matmul_4bit_t, tmm.matmul_4bit_t) if jq.packed == "split_k"
                else (jmm.matmul_8bit_t, tmm.matmul_8bit_t))
    for m in T_MS:
        g = _rand((m, 200), m + block)
        ref = np.asarray(jfn(jnp.asarray(g), jq.codes, jq.scale, codebook=jq.codebook,
                             block=block, interpret=True, out_dtype=jnp.float32))
        out = tfn(torch.from_numpy(g), tq.codes, tq.scale, codebook=tq.codebook, block=block)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=REL, atol=REL * np.abs(ref).max())


class _Recording(torch_fakes.FakeKernels):
    """FakeKernels that records the entry points the wrappers reach."""

    def __init__(self):
        self.entries = set()

    def __getattr__(self, name):
        fn = super().__getattr__(name)
        self.entries.add(name)
        return fn


def _steps_against_jax(fmt, cfg_kw, use_flash):
    """Three QLoRA steps of JAX's and of the port's, plain and through the
    kernel routes, on one batch (see the tests below); with ``use_flash``
    through flash attention on both sides. Returns the entry points the
    kernel routes reached."""
    (fwd, bwd), entries = ROUTES[fmt]
    cfg_j = jllama.LlamaConfig.tiny(dtype=jnp.float32, **cfg_kw)
    cfg_t = tllama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    dense = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    pj = jtrain.add_lora(jnn.quantize_params(dense, mode=fmt, block_size=64, min_size=1024),
                         jax.random.PRNGKey(2), rank=8, dtype=jnp.float32)
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
    bj = {"inputs": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    bt = {"inputs": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}

    def loss_fn(ad):
        logits, _ = jllama.forward(jtrain.merge_adapters(pj, ad), bj["inputs"], cfg_j,
                                   use_kernel=False, use_flash=use_flash, interpret=use_flash)
        return jtrain.causal_lm_loss(logits, bj["targets"])

    aj = jtrain.extract_adapters(pj)
    tx = joptim.adam8bit(LR)
    sj = tx.init(aj)
    # JAX's step: make_qlora_train_step's, which takes no flash option; with
    # flash, its body (value_and_grad, update, apply) over loss_fn
    loss_and_grad = jax.jit(jax.value_and_grad(loss_fn)) if use_flash else \
        jax.value_and_grad(loss_fn)
    jstep = None if use_flash else jax.jit(jtrain.make_qlora_train_step(cfg_j, tx,
                                                                         use_kernel=False))
    ports = {}
    for route in (False, None):
        pt = interop.from_jax_params(pj)
        opt = Adam8bit(tnn.lora_parameters(pt), lr=LR, use_kernel=route)
        ports[route] = (pt, opt, ttrain.make_qlora_train_step(cfg_t, opt, use_kernel=route,
                                                              use_flash=use_flash))
    lib = _Recording()
    per_forward = 7 * cfg_t.n_layers + 1
    losses = []
    for step in range(1, 4):
        lj, gj = loss_and_grad(aj)
        for route, (pt, opt, tstep) in ports.items():  # JAX's adapters and state into the port
            for ad_t, ad_j, st_j in zip(ttrain.extract_adapters(pt), aj, sj.qstate):
                for name in ("wq", "wv"):
                    for ab in ("a", "b"):
                        t = ad_t[name][ab]
                        with torch.no_grad():
                            t.copy_(torch.from_numpy(np.array(ad_j[name][ab])))
                        if step > 1:
                            for k, q in zip(STATE_KEYS, st_j[name][ab]):
                                opt.state[t][k].copy_(torch.from_numpy(np.array(q)))
        if use_flash:
            updates, sj = tx.update(gj, sj, aj)
            aj = optax.apply_updates(aj, updates)
        else:
            aj, sj, lj = jstep(aj, sj, pj, bj)
        losses.append(float(lj))
        for route, (pt, opt, tstep) in ports.items():
            if route is None:
                with torch_fakes.kernel_routes(), mock.patch.object(_build, "library",
                                                                    lambda: lib):
                    lt = tstep(pt, bt).item()
                    launches = dict(_build.launches)
                expected = dict.fromkeys(launches, 0)
                expected.update({fwd: per_forward, bwd: per_forward - 3, "adam8bit_update": 1})
                if use_flash:
                    expected.update(dict.fromkeys(FLASH_KERNELS, cfg_t.n_layers))
                assert launches == expected
            else:
                lt = tstep(pt, bt).item()
            np.testing.assert_allclose(lt, float(lj), rtol=STEP_REL)
            for ad_t, ad_j in zip(ttrain.extract_adapters(pt), gj):
                for name in ("wq", "wv"):
                    if step == 1:
                        assert torch.count_nonzero(ad_t[name]["a"].grad) == 0
                    rel = _rel_l2(ad_t[name]["b"].grad.numpy(), ad_j[name]["b"])
                    assert rel < STEP_REL, (route, step, name, rel)
    assert entries <= lib.entries and not {e for e in lib.entries if "bf16" in e}
    assert losses[2] < losses[0]
    return lib.entries


@pytest.mark.parametrize("fmt", list(ROUTES))
def test_f32_qlora_step_matches_jax(fmt):
    """Three steps of JAX's ``make_qlora_train_step(use_kernel=False)`` and
    of the port's, plain and through the kernel routes, on one batch: an f32
    base in ``fmt`` with f32 rank-8 adapters on wq and wv and 8-bit Adam.
    The port starts each step from JAX's adapters and state; losses and
    lora_b gradients within 1e-4, lora_a gradients zero at step 1 (B starts
    at zero), the loss falling. The kernel route reaches only the f32 entry
    points, 15 forward and 12 transposed launches a step (layer 0's wq, wk
    and wv read the frozen embedding) and one ``adam8bit_update``."""
    entries = _steps_against_jax(fmt, CFG_KW, use_flash=False)
    assert not {e for e in entries if "flash" in e}


@pytest.mark.parametrize("fmt", list(ROUTES))
def test_f32_qlora_flash_step_matches_jax(fmt):
    """The same three steps through flash attention, as the JAX package's
    ``finetune --dtype float32 --seq-len 1024`` runs on its chip: JAX's
    loss and gradients through ``llama.forward(use_flash=True)`` with its
    Pallas flash kernels in interpret mode (forward and the dQ and dK/dV
    backward), the port's through ``use_flash=True``, plain and through the
    fake library's f32 flash entry points. Head dim 32 (the least the
    kernels take) at rep 8, as TinyLlama-1.1B's 32 / 4 heads. The same
    rules: losses and lora_b gradients within 1e-4; ``n_layers`` launches a
    step of each flash kernel, f32 entry points only."""
    entries = _steps_against_jax(fmt, FLASH_CFG_KW, use_flash=True)
    assert FLASH_ENTRIES <= entries


def test_f32_qlora_flash_step_at_head_dim_100_matches_jax():
    """The flash steps above on a tiny Llama of OpenLLaMA-3B's head dim
    (dim 200, 2 heads, 2 layers; nf4): JAX's Pallas flash kernels, whose
    blocks span the whole head dim, against the port's plain flash and its
    fake f32 flash entry points, under the same rules (losses and lora_b
    gradients within 1e-4, 2 launches a step of each flash kernel)."""
    assert tllama.LlamaConfig.tiny(**FLASH_HD100_KW).head_dim == 100
    entries = _steps_against_jax("nf4", FLASH_HD100_KW, use_flash=True)
    assert FLASH_ENTRIES <= entries


# tiny Llamas at Gemma-2B's head dim, 256 (one KV head: its MQA), which the
# kernels run in their 256-column width, and at 38, off a multiple of 4,
# which the wrapper pads to 40 with zero columns (RoPE rotates column
# pairs, so a Llama's head dim is even: the flash tests hold 37)
FLASH_HD_KW = {256: dict(dim=512, n_layers=2, n_heads=2, n_kv_heads=1, hidden_dim=512),
               38: dict(dim=76, n_layers=2, n_heads=2, n_kv_heads=1, hidden_dim=256)}


@pytest.mark.parametrize("hd", list(FLASH_HD_KW))
def test_f32_qlora_flash_step_at_head_dims_256_and_38_match_jax(hd):
    """The flash steps above at hd 256 and 38 (nf4): JAX's Pallas flash
    kernels against the port's plain flash and its fake f32 flash entry
    points (those of the 256-column width at 256), under the same rules."""
    assert tllama.LlamaConfig.tiny(**FLASH_HD_KW[hd]).head_dim == hd
    entries = _steps_against_jax("nf4", FLASH_HD_KW[hd], use_flash=True)
    assert {e + ("_w256" if hd == 256 else "") for e in FLASH_ENTRIES} <= entries
