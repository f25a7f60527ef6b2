"""Port parity: quanta_tpu_torch.ops / nn against quanta_tpu's.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_ops_matmul.py does.
Inputs are made with numpy from a seed and handed to both. The CUDA
kernels against their plain versions: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import core as jcore
from quanta_tpu import nn as jnn
from quanta_tpu.ops import int4c as jint4c
from quanta_tpu.ops import matmul as jmm
from quanta_tpu_torch import calib as tcalib
from quanta_tpu_torch import core as tcore
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch.ops import int4c as tint4c
from quanta_tpu_torch.ops import matmul as tmm

FOUR_BIT = ["nf4a", "nf4", "int4", "fp4", "int4a"]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- matmul_4bit


@pytest.mark.parametrize("fmt", FOUR_BIT)
@pytest.mark.parametrize("xshape,n", [((7, 200), 100), ((2, 5, 256), 128), ((48, 256), 192)])
def test_matmul_quantized_matches_jax_kernel(fmt, xshape, n):
    x = _rand(xshape, 0)
    w = _rand((xshape[-1], n), 1)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=64)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=64)
    ref = np.asarray(jmm.matmul_quantized(jnp.asarray(x), jq, interpret=True))
    out = tmm.matmul_quantized(torch.from_numpy(x), tq)
    assert out.shape == ref.shape == (*xshape[:-1], n)
    # f32 both sides; only the summation order differs
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_matmul_4bit_bf16_activations_match_jax():
    x = _rand((16, 256), 2)
    w = _rand((256, 128), 3)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt="nf4a")
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt="nf4a")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jmm.matmul_4bit(xb, jq.codes, jq.scale, codebook="nf4a",
                                     interpret=True, out_dtype=jnp.float32))
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = tmm.matmul_4bit(xt, tq.codes, tq.scale, codebook="nf4a", out_dtype=torch.float32)
    # same bf16 operands, exact products, f32 sums in another order
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_matmul_8bit_layout_plain_path():
    x = _rand((5, 128), 4)
    w = _rand((128, 64), 5)
    for fmt in ("int8", "nf8", "int8a"):
        tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt)
        ref = x @ tcore.dequantize_matmul_weight(tq).numpy()
        out = tmm.matmul_quantized(torch.from_numpy(x), tq)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_use_kernel_true_on_cpu_raises():
    x = torch.zeros((2, 128))
    tq = tcore.quantize_matmul_weight(torch.ones((128, 128)), fmt="nf4a")
    with pytest.raises(ValueError, match="CUDA"):
        tmm.matmul_quantized(x, tq, use_kernel=True)
    qw = tint4c.quantize_int4c_weight(torch.ones((128, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        tint4c.matmul_int4c(x, qw, use_kernel=True)


# ------------------------------------------------------------------- int4c


@pytest.mark.parametrize("k,n", [(256, 128), (300, 100)])
def test_quantize_int4c_weight_bit_exact(k, n):
    w = _rand((k, n), 6)
    jw = jint4c.quantize_int4c_weight(jnp.asarray(w))
    tw = tint4c.quantize_int4c_weight(torch.from_numpy(w))
    assert tw.shape == jw.shape
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_allclose(tint4c.dequantize_int4c(tw).numpy(),
                               np.asarray(jint4c.dequantize_int4c(jw)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("xshape,k,n", [((7, 300), 300, 100), ((2, 3, 512), 512, 256)])
def test_matmul_int4c_matches_jax_kernel(xshape, k, n):
    x = _rand(xshape, 7)
    w = _rand((k, n), 8)
    jw = jint4c.quantize_int4c_weight(jnp.asarray(w))
    tw = tint4c.quantize_int4c_weight(torch.from_numpy(w))
    ref = np.asarray(jint4c.matmul_int4c(jnp.asarray(x), jw, use_kernel=True, interpret=True))
    out = tint4c.matmul_int4c(torch.from_numpy(x), tw)
    assert out.shape == ref.shape == (*xshape[:-1], n)
    # exact int32 sums and the same two f32 multiplies on both sides
    np.testing.assert_array_equal(out.numpy(), ref)


def test_int4c_reference_checks_exactness_bound():
    with pytest.raises(ValueError, match="exact"):
        tint4c.matmul_int4c_reference(torch.zeros((1, 16640), dtype=torch.int8),
                                      torch.zeros((8320, 128), dtype=torch.uint8),
                                      torch.ones(1), torch.ones(128))


# ---------------------------------------------------------------- nn layer


def test_linear_dispatch_and_unported_leaves():
    x = _rand((3, 128), 9)
    w = _rand((128, 4096 // 128), 10)
    b = _rand((32,), 11)
    out = tnn.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), x @ w + b, rtol=1e-5, atol=1e-5)

    # a TapWeight is ported: under calib.taping, linear records its input's
    # statistics and then runs the wrapped weight; outside it, it only runs
    tap = tcalib.TapWeight(w=torch.from_numpy(w), name="layers/0/wq")
    with tcalib.taping() as buf:
        out = tnn.linear(torch.from_numpy(x), tap, torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), x @ w + b, rtol=1e-5, atol=1e-5)
    rec = buf["layers/0/wq"]
    assert (rec["amin"].item(), rec["amax"].item()) == (x.min(), x.max())
    np.testing.assert_array_equal(rec["colmax"].numpy(), np.abs(x).max(axis=0))
    tnn.linear(torch.from_numpy(x), tap)
    assert buf == {"layers/0/wq": rec}
    # a LoRAWeight is ported: linear runs its base plus the adapter
    lw = tnn.init_lora(torch.from_numpy(w), torch.Generator().manual_seed(0), rank=4,
                       dtype=torch.float32)
    with torch.no_grad():
        lw.lora_b.fill_(0.5)
    expect = x @ w + b + (x @ lw.lora_a.detach().numpy()) @ lw.lora_b.detach().numpy() * 4.0
    out = tnn.linear(torch.from_numpy(x), lw, torch.from_numpy(b))
    np.testing.assert_allclose(out.detach().numpy(), expect, rtol=1e-4, atol=1e-4)
    # llm_int8 is ported: the leaf is an Int8Weight and linear takes it
    q = tnn.quantize_linear_weight(torch.from_numpy(w), mode="llm_int8")
    assert type(q).__name__ == "Int8Weight"
    assert tnn.linear(torch.from_numpy(x), q).shape == (3, 32)


@pytest.mark.parametrize("mode", ["nf4a", "int4c"])
def test_quantize_params_matches_jax(mode):
    tree = {"tok_emb": _rand((64, 128), 12), "norm": _rand((128,), 13),
            "layers": [{"wq": _rand((128, 128), 14), "small": _rand((8, 8), 15)}]}
    jt = jnn.quantize_params({"tok_emb": jnp.asarray(tree["tok_emb"]),
                              "norm": jnp.asarray(tree["norm"]),
                              "layers": [{k: jnp.asarray(v) for k, v in tree["layers"][0].items()}]},
                             mode=mode, min_size=1024)
    tt = tnn.quantize_params({"tok_emb": torch.from_numpy(tree["tok_emb"]),
                              "norm": torch.from_numpy(tree["norm"]),
                              "layers": [{k: torch.from_numpy(v) for k, v in tree["layers"][0].items()}]},
                             mode=mode, min_size=1024)
    assert isinstance(tt["tok_emb"], torch.Tensor) and isinstance(tt["layers"][0]["small"], torch.Tensor)
    jq, tq = jt["layers"][0]["wq"], tt["layers"][0]["wq"]
    assert type(tq).__name__ == type(jq).__name__
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    dense = tnn.dequantize_params(tt)["layers"][0]["wq"]
    jdense = jnn.dequantize_params(jt)["layers"][0]["wq"]
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-6, atol=1e-6)


def test_linear4bit_module():
    g = torch.Generator().manual_seed(0)
    mod = tnn.Linear4bit(128, 64, compute_dtype=torch.float32, quant_type="nf4a", generator=g)
    x = torch.from_numpy(_rand((4, 128), 16))
    dense = mod(x).detach()
    np.testing.assert_allclose(dense.numpy(), (x @ mod.weight + mod.bias).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    mod.quantize_()
    assert isinstance(mod.weight, tcore.QuantizedTensor)
    assert "weight" not in dict(mod.named_parameters())
    rel = (mod(x).detach() - dense).norm() / dense.norm()
    assert rel < 0.2  # nf4a weight error, block 64
