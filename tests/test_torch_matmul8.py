"""Port parity: the 8-bit matmul pair against quanta_tpu's Pallas kernels.

On the CPU the port's ``matmul_8bit`` / ``matmul_8bit_t`` run their plain
versions (the CUDA kernels against those: tests/test_torch_cuda.py); the
JAX side runs ``matmul_8bit`` / ``matmul_8bit_t`` in interpret mode and
``jax.grad`` through ``matmul_quantized``. Inputs come from numpy seeds.
K = 300 and N = 100 are ragged: the quantizer pads them to 1024 and 128.

Tolerances:
  - f32, every format: 1e-5 of max|JAX| (the same f32 products, summed in
    another order);
  - nf8: the TPU kernel evaluates tanh(2(2c/255 - 1))/tanh 2 in f32, the
    port reads the codebook table (the same function in float64, rounded
    to f32, which the JAX package's own XLA path uses too): 202 of the 256
    levels differ in the last f32 bit (2.4e-7 at most). In f32 that stays
    inside the 1e-5 above; in bf16 it can move a weight's bf16 rounding by
    one bf16 ulp, so each product may differ by 2^-8 of |x w|: the bound is
    2^-8 (|x| @ |W|) element by element, plus the 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import core as jcore
from quanta_tpu.ops import matmul as jmm
from quanta_tpu_torch import core as tcore
from quanta_tpu_torch.ops import matmul as tmm

EIGHT_BIT = ["int8", "nf8", "fp8", "int8a"]
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _weights(fmt, k=300, n=100, seed=1):
    w = _rand((k, n), seed)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=64)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=64)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    return jq, tq


def _pair(a, dtype):
    """The same values for both frameworks: jax (in dtype) and torch."""
    aj = jnp.asarray(a).astype(dtype)
    at = torch.from_numpy(np.asarray(aj.astype(jnp.float32)).copy())
    return aj, at.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _tolerance(fmt, dtype, ref, a_abs, w_abs):
    tol = 1e-5 * np.abs(ref).max()
    if fmt == "nf8" and dtype == jnp.bfloat16:
        tol = tol + BF16_ULP * (a_abs @ w_abs)
    return tol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", EIGHT_BIT)
def test_matmul_8bit_matches_jax_kernel(fmt, dtype):
    jq, tq = _weights(fmt)
    xj, xt = _pair(_rand((7, 300), 2), dtype)
    ref = np.asarray(jmm.matmul_8bit(xj, jq.codes, jq.scale, codebook=jq.codebook, block=64,
                                     interpret=True, out_dtype=jnp.float32))
    out = tmm.matmul_8bit(xt, tq.codes, tq.scale, codebook=tq.codebook, block=64,
                          out_dtype=torch.float32).numpy()
    assert out.shape == ref.shape == (7, 128)
    w_abs = np.abs(tmm._dequant_8bit(tq.codes, tq.scale, tq.codebook, 64, torch.float32).numpy())
    x_abs = np.abs(np.pad(xt.float().numpy(), ((0, 0), (0, 1024 - 300))))
    assert (np.abs(out - ref) <= _tolerance(fmt, dtype, ref, x_abs, w_abs)).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", EIGHT_BIT)
def test_matmul_8bit_t_matches_jax_kernel(fmt, dtype):
    jq, tq = _weights(fmt)
    gj, gt = _pair(_rand((9, 100), 3), dtype)  # logical N: both pad it to 128
    ref = np.asarray(jmm.matmul_8bit_t(gj, jq.codes, jq.scale, codebook=jq.codebook, block=64,
                                       interpret=True, out_dtype=jnp.float32))
    out = tmm.matmul_8bit_t(gt, tq.codes, tq.scale, codebook=tq.codebook, block=64,
                            out_dtype=torch.float32).numpy()
    assert out.shape == ref.shape == (9, 1024)
    w_abs = np.abs(tmm._dequant_8bit(tq.codes, tq.scale, tq.codebook, 64, torch.float32).numpy())
    g_abs = np.abs(np.pad(gt.float().numpy(), ((0, 0), (0, 28))))
    assert (np.abs(out - ref) <= _tolerance(fmt, dtype, ref, g_abs, w_abs.T)).all()


@pytest.mark.parametrize("fmt", EIGHT_BIT)
def test_matmul_quantized_8bit_grad_matches_jax(fmt):
    """The forward and ``jax.grad`` through ``matmul_quantized`` (the
    transposed kernel, plus int8a's zero-point terms outside it) against
    the port's autograd Function, f32."""
    jq, tq = _weights(fmt)
    x = _rand((2, 5, 300), 4)
    c = _rand((2, 5, 100), 5)

    def jloss(xx):
        y = jmm.matmul_quantized(xx, jq, interpret=True)
        return (y * jnp.asarray(c)).sum(), y

    (_, yj), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    yt = tmm.matmul_quantized(xt, tq)
    (yt * torch.from_numpy(c)).sum().backward()
    assert yt.shape == (2, 5, 100) and xt.grad.shape == x.shape
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(yj)).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())


def test_level_tables_signedness_and_fp8_indices():
    """int8 and int8a differ only in the signedness of their codes: byte
    0xC8 is -56 for int8 and 200 for int8a. fp8 codes index the sorted e4m3
    table (duplicate +-0 and +-448/448), not e4m3 bit patterns."""
    lv_i8 = tmm._levels8_np(None, torch.int8)
    lv_u8 = tmm._levels8_np(None, torch.uint8)
    assert (lv_i8[0xC8], lv_u8[0xC8], lv_i8[127], lv_i8[128]) == (-56.0, 200.0, 127.0, -128.0)
    fp8 = tmm._levels8_np("fp8", torch.uint8)
    assert np.all(np.diff(fp8) >= 0) and (fp8[0], fp8[-1]) == (-1.0, 1.0)
    assert (fp8 == 0.0).sum() == 2 and (np.abs(fp8) == 1.0).sum() == 4
    with pytest.raises(ValueError, match="not 8-bit"):
        tmm._levels8_np("nf4", torch.uint8)
    # the plain version reads int8a's unsigned codes as 0..255
    codes = torch.full((64, 128), 200, dtype=torch.uint8)
    out = tmm.matmul_8bit(torch.ones((1, 64)), codes, torch.ones((1, 128)))
    assert torch.equal(out, torch.full((1, 128), 64 * 200.0))
