"""GPT-2 at its own f32 through the f32 routes of matmul_4bit and
matmul_8bit, against the JAX package's quantized GPT-2.

The JAX package makes a tiny GPT-2 in f32 and quantizes it (nf4a, int8);
``interop.from_jax_params`` hands the same numbers to the port, whose
forward and greedy decode take the kernel routes on the CPU:
``torch_fakes.FakeKernels`` stands in for the compiled library and runs each
entry point's plain arithmetic on the tensors behind its pointers, so the
wrappers' f32 entry points (``qt_matmul_4bit_f32``, ``qt_matmul_8bit_f32``),
pointer arithmetic and launch counts run here. Tokens come from numpy; JAX
runs its plain routes (``use_kernel=False``). Tolerances: f32 logits within
1e-5 of max |JAX| (the frameworks' f32 rounding and summation order, as
``tests/test_torch_gpt2.py`` states); greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import torch_fakes
from quanta_tpu import nn as jnn
from quanta_tpu.models import gpt2 as jgpt2
from quanta_tpu_torch import interop
from quanta_tpu_torch.models import gpt2 as tgpt2
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import matmul as tmm

JCFG = jgpt2.GPT2Config.tiny(max_seq_len=96)
TCFG = tgpt2.GPT2Config.tiny(max_seq_len=96)
REL = 1e-5
# format -> the kernel its linears launch and the f32 entry point it reaches
ROUTES = {"nf4a": ("matmul_4bit", "qt_matmul_4bit_f32"),
          "int8": ("matmul_8bit", "qt_matmul_8bit_f32")}


@pytest.fixture(scope="module")
def jquant():
    jparams = jgpt2.init_params(jax.random.PRNGKey(3), JCFG)
    return {fmt: jnn.quantize_params(jparams, mode=fmt, block_size=64, min_size=1024)
            for fmt in ROUTES}


class _Recording(torch_fakes.FakeKernels):
    """FakeKernels that records the entry points the wrappers reach."""

    def __init__(self):
        self.entries = []

    def __getattr__(self, name):
        fn = super().__getattr__(name)
        self.entries.append(name)
        return fn


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape, dtype=np.int32)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("shape", [(2, 9), (3, 20)], ids=["M18", "M60"])
@pytest.mark.parametrize("fmt", list(ROUTES))
def test_f32_forward_takes_the_f32_route_and_matches_jax(jquant, fmt, shape):
    """One forward of the tiny f32 GPT-2: every quantized linear reaches the
    f32 entry point, 4 launches a layer (the tied head is dense), logits
    within 1e-5 of JAX's quantized forward. M = 18 and 60 lie on either
    side of the kernels' decode/prefill switch at M = 32."""
    kernel, entry = ROUTES[fmt]
    tq = interop.from_jax_params(jquant[fmt])
    toks = _tokens(shape, seed=sum(shape))
    want, _ = jgpt2.forward(jquant[fmt], jnp.asarray(toks), JCFG, use_kernel=False)
    lib = _Recording()
    with torch_fakes.kernel_routes(), mock.patch.object(_build, "library", lambda: lib):
        got, _ = tgpt2.forward(tq, torch.from_numpy(toks), TCFG)
        launches = dict(_build.launches)
    assert got.dtype == torch.float32
    assert set(lib.entries) == {entry}
    assert launches[kernel] == 4 * TCFG.n_layers
    assert sum(launches.values()) == launches[kernel]
    _close(got.numpy(), want)


@pytest.mark.parametrize("fmt", list(ROUTES))
def test_f32_greedy_decode_takes_the_f32_route_and_matches_jax(jquant, fmt):
    """Greedy decode: the prefill and every step through the f32 entry point
    (new tokens x 4 x n_layers launches), tokens equal to JAX's."""
    kernel, entry = ROUTES[fmt]
    tq = interop.from_jax_params(jquant[fmt])
    toks, new = _tokens((2, 7), seed=11), 6
    want = np.asarray(jgpt2.greedy_decode(jquant[fmt], jnp.asarray(toks), JCFG,
                                          max_new_tokens=new, use_kernel=False))
    lib = _Recording()
    with torch_fakes.kernel_routes(), mock.patch.object(_build, "library", lambda: lib):
        got = tgpt2.greedy_decode(tq, torch.from_numpy(toks), TCFG, max_new_tokens=new)
        launches = dict(_build.launches)
    assert set(lib.entries) == {entry}
    assert launches[kernel] == new * 4 * TCFG.n_layers
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("report", [tmm.matmul_4bit_design, tmm.matmul_8bit_design,
                                    tmm.matmul_4bit_t_design, tmm.matmul_8bit_t_design])
def test_design_report_refuses_other_dtypes(report):
    """The report names bf16 and f32 designs only, and says so before it
    reaches the library."""
    with pytest.raises(TypeError, match="bf16 or f32"):
        report(8, 128, 1024, dtype=torch.float16)
