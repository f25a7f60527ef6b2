"""Port parity: LLM.int8 (ops/int8mm.py), blockwise quantize
(ops/quantize.py) and the interop of their weights, against quanta_tpu.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_ops_matmul.py does.
Inputs are made with numpy from a seed and handed to both.

Tolerances: codes, scales, outlier sets and every integer product are
bit-exact. ``matmul_int8`` outputs agree within 1e-6 of max|out| for f32
x: the only difference is the f32 summation order of the outlier GEMM,
which torch and XLA take in different orders.

Two XLA rewrites on the CPU show against the interpreted Pallas kernels,
and the tests state and bound exactly them:
  - XLA contracts the fused epilogue ``acc*rs*cs + y_out`` into an FMA;
    the port rounds the product before the add (as its CUDA kernel does,
    with ``__fmul_rn``/``__fadd_rn``). The plain-variant kernel has no add
    and agrees bit for bit; the fused one within one rounding of the
    product and one of the sum.
  - XLA turns the jitted ``absmax / 127`` of ``quantize_blockwise`` into a
    product with the reciprocal, so an int8_sym scale may differ by one
    ulp; its block's codes may then differ by one step. Blocks whose
    scales agree have identical codes, and codebook formats (no division
    there) are bit-exact.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import calib as jcalib
from quanta_tpu import nn as jnn
from quanta_tpu.nn import lora as jlora
from quanta_tpu.ops import int8mm as jint8
from quanta_tpu.ops import quantize as jquant
from quanta_tpu_torch import interop
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch.ops import int4c as tint4c
from quanta_tpu_torch.ops import int8mm as tint8
from quanta_tpu_torch.ops import quantize as tquant

REL = 1e-6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _with_outliers(x, cols, mag=20.0):
    """Activations whose columns ``cols`` are systematic outliers."""
    x = x.copy()
    x[..., cols] *= mag
    return x


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _assert_same_weight(tq, jq):
    assert isinstance(tq, tint8.Int8Weight)
    assert tq.shape == tuple(jq.shape) and tq.threshold == jq.threshold
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy().view(np.uint32),
                                  np.asarray(jq.scale).view(np.uint32))
    np.testing.assert_array_equal(tq.outlier_idx.numpy(), np.asarray(jq.outlier_idx))
    np.testing.assert_array_equal(tq.w_outlier.float().numpy(),
                                  np.asarray(jq.w_outlier.astype(jnp.float32)))
    assert tq.codes.dtype == torch.int8 and tq.outlier_idx.dtype == torch.int32
    assert tq.w_outlier.dtype == torch.bfloat16


# ------------------------------------------------------ quantize_int8_weight


@pytest.mark.parametrize("k,n,calib", [(256, 128, False), (200, 100, False),
                                       (300, 72, True), (2048, 64, False)])
def test_quantize_int8_weight_bit_exact(k, n, calib):
    w = _rand((k, n), k + n)
    w[5] = 0.0  # an all-zero row
    colmax = np.abs(_rand((k,), 7)) if calib else None
    jq = jint8.quantize_int8_weight(jnp.asarray(w), threshold=5.0,
                                    calib_colmax=None if colmax is None else jnp.asarray(colmax))
    tq = tint8.quantize_int8_weight(torch.from_numpy(w), threshold=5.0,
                                    calib_colmax=None if colmax is None else torch.from_numpy(colmax))
    _assert_same_weight(tq, jq)


def test_quantize_int8_weight_ties_toward_lower_index():
    """Tied statistics: lax.top_k keeps the lower indices; so must the port
    (torch.topk promises no order)."""
    k, n = 96, 64
    w = _rand((k, n), 3)
    colmax = np.ones((k,), np.float32)
    colmax[[4, 50, 90]] = 2.0  # three clear winners, the rest tied
    jq = jint8.quantize_int8_weight(jnp.asarray(w), outlier_capacity=40,
                                    calib_colmax=jnp.asarray(colmax))
    tq = tint8.quantize_int8_weight(torch.from_numpy(w), outlier_capacity=40,
                                    calib_colmax=torch.from_numpy(colmax))
    _assert_same_weight(tq, jq)
    tied = [i for i in range(k) if i not in (4, 50, 90)]
    assert tq.outlier_idx.tolist() == sorted([4, 50, 90] + tied[:37])
    # the same with weight rows that tie on max |w|
    wt = np.zeros((k, n), np.float32)
    wt[:, 0] = 1.0
    wt[[7, 70], 1] = 3.0
    _assert_same_weight(tint8.quantize_int8_weight(torch.from_numpy(wt)),
                        jint8.quantize_int8_weight(jnp.asarray(wt)))


# ---------------------------------------------------------------- matmul_int8


CASES = [((7, 200), 100), ((2, 5, 256), 130), ((33, 300), 72)]


@pytest.mark.parametrize("xshape,n", CASES)
def test_matmul_int8_matches_jax_both_routes(xshape, n):
    k = xshape[-1]
    x = _with_outliers(_rand(xshape, 1), [3, k // 2])
    w = _rand((k, n), 2, scale=0.1)
    jq = jint8.quantize_int8_weight(jnp.asarray(w))
    tq = tint8.quantize_int8_weight(torch.from_numpy(w))
    ref_kernel = jint8.matmul_int8(jnp.asarray(x), jq, use_kernel=True, interpret=True)
    ref_xla = jint8.matmul_int8(jnp.asarray(x), jq, use_kernel=False)
    xt = torch.from_numpy(x)
    fused = tint8.matmul_int8(xt, tq, fused=True)  # the fused route, plain kernel
    oracle = tint8.matmul_int8(xt, tq)  # CPU default: the plain route
    assert fused.shape == oracle.shape == (*xshape[:-1], n)
    for out in (fused, oracle):
        _close(out.numpy(), ref_kernel)
        _close(out.numpy(), ref_xla)
    # both port routes take the same exact integer sum in the same order
    assert torch.equal(fused, oracle)


def test_matmul_int8_bf16_activations_match_jax():
    x = _with_outliers(_rand((9, 256), 4), [10])
    w = _rand((256, 128), 5, scale=0.1)
    jq = jint8.quantize_int8_weight(jnp.asarray(w))
    tq = tint8.quantize_int8_weight(torch.from_numpy(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    ref = jint8.matmul_int8(xb, jq, use_kernel=True, interpret=True, out_dtype=jnp.float32)
    out = tint8.matmul_int8(xt, tq, out_dtype=torch.float32)
    _close(out.numpy(), ref)
    out_bf16 = tint8.matmul_int8(xt, tq)
    assert out_bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("m,k,n", [(5, 256, 128), (40, 384, 256)])
def test_kernel_plain_versions_bit_exact_vs_pallas(m, k, n):
    """The plain versions of both kernels against the Pallas kernels on the
    same operands (y_out handed to both): exact integer sums, the same f32
    multiply (and add) order."""
    rng = np.random.default_rng(m)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)
    rs = (np.abs(_rand((m,), 1)) + 0.01).astype(np.float32)
    cs = (np.abs(_rand((n,), 2)) * 0.01).astype(np.float32)
    x = _rand((m, k), 3) * 50.0
    y_out = _rand((m, n), 4)
    xq = np.clip(np.round(x / rs[:, None]), -127, 127).astype(np.int8)
    j_f = jint8.matmul_int8_fused(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(rs),
                                  jnp.asarray(cs), jnp.asarray(y_out), interpret=True)
    j_k = jint8.matmul_int8_kernel(jnp.asarray(xq), jnp.asarray(codes), jnp.asarray(rs),
                                   jnp.asarray(cs), interpret=True)
    t = [torch.from_numpy(a) for a in (x, codes, rs, cs, y_out, xq)]
    t_f = tint8.matmul_int8_fused(t[0], t[1], t[2], t[3], t[4])
    t_k = tint8.matmul_int8_kernel(t[5], t[1], t[2], t[3])
    np.testing.assert_array_equal(t_k.numpy(), np.asarray(j_k))
    # the port's fused epilogue is the plain-variant product, rounded, + y_out
    np.testing.assert_array_equal(t_f.numpy(), t_k.numpy() + y_out)
    # XLA's FMA skips the product's rounding: one product ulp + one sum ulp
    bound = np.spacing(np.abs(t_k.numpy())) + np.spacing(np.abs(t_f.numpy()))
    assert (np.abs(t_f.numpy() - np.asarray(j_f)) <= bound).all()
    # the prologue's quantize is the same as the host-side one
    assert torch.equal(tint8.quantize_rows(t[0], t[2]), t[5])


def test_int8_wrappers_refuse_kernel_on_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        tint8.matmul_int8_kernel(torch.zeros((2, 128), dtype=torch.int8),
                                 torch.zeros((128, 128), dtype=torch.int8),
                                 torch.ones(2), torch.ones(128), use_kernel=True)


def test_outlier_coverage_matches_jax():
    x = _with_outliers(_rand((6, 256), 8), [2, 9, 100, 200], mag=30.0)
    w = _rand((256, 64), 9)
    colmax = np.abs(x).max(axis=0)
    jq = jint8.quantize_int8_weight(jnp.asarray(w), outlier_capacity=32,
                                    calib_colmax=jnp.asarray(colmax))
    tq = tint8.quantize_int8_weight(torch.from_numpy(w), outlier_capacity=32,
                                    calib_colmax=torch.from_numpy(colmax))
    for q_x in (x, _rand((6, 256), 10)):
        ref = float(jint8.outlier_coverage(jnp.asarray(q_x), jq))
        got = float(tint8.outlier_coverage(torch.from_numpy(q_x), tq))
        assert got == ref


# ------------------------------------------------------- nn: linear and co.


def test_linear_and_quantize_params_llm_int8_match_jax():
    params = {"a": {"w": _rand((256, 192), 11, 0.1)}, "emb": _rand((64, 256), 12),
              "b": [_rand((192, 130), 13, 0.1)]}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jq = jnn.quantize_params(jp, mode="llm_int8", min_size=1024, threshold=4.0)
    tq = tnn.quantize_params(jax.tree_util.tree_map(torch.from_numpy, params),
                             mode="llm_int8", min_size=1024, threshold=4.0)
    assert isinstance(tq["emb"], torch.Tensor)  # embeddings stay dense
    _assert_same_weight(tq["a"]["w"], jq["a"]["w"])
    _assert_same_weight(tq["b"][0], jq["b"][0])
    x = _with_outliers(_rand((2, 3, 256), 14), [1, 7])
    bias = _rand((192,), 15)
    ref = jnn.linear(jnp.asarray(x), jq["a"]["w"], jnp.asarray(bias),
                     use_kernel=True, interpret=True)
    out = tnn.linear(torch.from_numpy(x), tq["a"]["w"], torch.from_numpy(bias))
    _close(out.numpy(), ref)
    # dequantize_params: outlier rows back in bf16, the rest codes * scale
    jd = jnn.dequantize_params(jq)
    td = tnn.dequantize_params(tq)
    for path in (("a", "w"), ("b", 0)):
        jl, tl = jd[path[0]][path[1]], td[path[0]][path[1]]
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_interop_converts_int8_weight():
    w = _rand((200, 100), 16)
    jq = jint8.quantize_int8_weight(jnp.asarray(w), threshold=3.5)
    tq = interop.from_jax_params({"w": jq})["w"]
    assert not isinstance(tq, tint4c.Int4cWeight)
    _assert_same_weight(tq, jq)
    x = _with_outliers(_rand((4, 200), 17), [0])
    _close(tint8.matmul_int8(torch.from_numpy(x), tq).numpy(),
           jint8.matmul_int8(jnp.asarray(x), jq, use_kernel=False))


def test_interop_refuses_unknown_leaves():
    base = jint8.quantize_int8_weight(jnp.asarray(_rand((64, 64), 18)))
    tap = jcalib.TapWeight(w=jnp.asarray(_rand((64, 64), 19)), name="w")
    with pytest.raises(TypeError, match="TapWeight"):
        interop.from_jax_params({"ok": base, "layer": {"w": tap}})
    # a LoRAWeight over an LLM.int8 base converts (its adapters trainable)
    lw = jlora.init_lora(base, jax.random.PRNGKey(0), rank=4)
    tl = interop.from_jax_params({"layer": {"w": lw}})["layer"]["w"]
    assert type(tl).__name__ == "LoRAWeight" and isinstance(tl.base, tint8.Int8Weight)
    assert tl.lora_a.requires_grad and tl.alpha == lw.alpha
    with pytest.raises(TypeError, match="object"):
        interop.from_jax_params([object()])


def test_linear8bitlt_matches_jax_module():
    x = _with_outliers(_rand((5, 128), 20), [3, 64])
    mod_j = jnn.Linear8bitLt(features=96)
    variables = mod_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])
    bias = _rand((96,), 21)
    mod_t = tnn.Linear8bitLt(128, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod_t.weight.copy_(torch.from_numpy(kernel))
        mod_t.bias.copy_(torch.from_numpy(bias))
    jv = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    _close(mod_t(torch.from_numpy(x)).detach().numpy(), mod_j.apply(jv, jnp.asarray(x)),
           rel=1e-5)
    mod_t.quantize_()
    assert "weight" not in dict(mod_t.named_parameters())
    jqv = jnn.quantize_params(jv, mode="llm_int8", min_size=0)
    _assert_same_weight(mod_t.weight, jqv["params"]["kernel"])
    ref = jnn.linear(jnp.asarray(x), jqv["params"]["kernel"], jnp.asarray(bias),
                     use_kernel=True, interpret=True)
    _close(mod_t(torch.from_numpy(x)).detach().numpy(), ref)
    assert isinstance(mod_j, fnn.Module)


# ---------------------------------------------------------- quantize_blockwise


def assert_same_blocks(tc, ts, jc, js, *, exact):
    """Codes and scales equal; with ``exact=False`` (int8_sym against XLA's
    reciprocal) a scale may be one ulp off, and only its block's codes may
    then move, by one step."""
    ts_bits = ts.numpy().reshape(-1).view(np.int32).astype(np.int64)
    js_bits = np.asarray(js).reshape(-1).view(np.int32).astype(np.int64)
    tc, jc = tc.numpy().astype(np.int32), np.asarray(jc).astype(np.int32)
    assert tc.shape == jc.shape
    ulps = np.abs(ts_bits - js_bits)
    assert ulps.max() <= (0 if exact else 1), ulps.max()
    same = ulps == 0
    np.testing.assert_array_equal(tc[same], jc[same])
    assert np.abs(tc - jc).max(initial=0) <= 1


@pytest.mark.parametrize("fmt", ["int8_sym", "nf4", "nf4a", "fp4"])
@pytest.mark.parametrize("n,block", [(64 * 40, 64), (1000, 64), (517, 32)])
def test_quantize_blockwise_matches_jax(fmt, n, block):
    x = _rand((n,), n + block, scale=3.0)
    x[:block] = 0.0  # an all-zero block: scale 1, codes of zero
    x[block] = 1e-13  # a block whose absmax is below the 1e-12 guard
    x[block + 1:2 * block] = 0.0
    jc, js = jquant.quantize_blockwise(jnp.asarray(x), fmt=fmt, block=block, interpret=True)
    tc, ts = tquant.quantize_blockwise(torch.from_numpy(x), fmt=fmt, block=block)
    nb = -(-n // block)
    assert tc.shape == (nb, block) and ts.shape == (nb, 1)
    assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
    assert_same_blocks(tc, ts, jc, js, exact=fmt != "int8_sym")
    if fmt != "int8_sym":
        np.testing.assert_array_equal(
            tquant.dequantize_blockwise(tc, ts, fmt=fmt).numpy(),
            np.asarray(jquant.dequantize_blockwise(jc, js, fmt=fmt)))


def test_quantize_blockwise_bf16_input_and_midpoint_ties():
    """bf16 input goes through f32 exactly; a value on a midpoint takes the
    lower level (strict compare), in both packages."""
    from quanta_tpu_torch.core import codebooks

    mids = codebooks.get_midpoints_np("nf4")
    x = np.concatenate([[1.0], mids, -mids[::-1]]).astype(np.float32)
    x = np.pad(x, (0, 64 - x.size))
    jc, js = jquant.quantize_blockwise(jnp.asarray(x), fmt="nf4", block=64, interpret=True)
    tc, ts = tquant.quantize_blockwise(torch.from_numpy(x), fmt="nf4", block=64)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc[0, 1:16].tolist() == list(range(15))
    xb = jnp.asarray(_rand((4, 8, 64), 22)).astype(jnp.bfloat16)
    jc, js = jquant.quantize_blockwise(xb, fmt="int8_sym", block=64, interpret=True)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    tc, ts = tquant.quantize_blockwise(xt, fmt="int8_sym", block=64)
    assert_same_blocks(tc, ts, jc, js, exact=False)
