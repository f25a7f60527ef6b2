"""The port's CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where jax is not
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: ``matmul_4bit`` kernel and plain version multiply the same
bf16 weights and differ only in f32 summation order, so they agree within
2 bf16 ulps of max|plain|; ``matmul_int4c`` sums exactly and must agree
bit for bit.
"""

import pytest
import torch

from quanta_tpu_torch import core as tcore
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import int4c as tint4c
from quanta_tpu_torch.ops import matmul as tmm
from quanta_tpu_torch.models import llama as tllama

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
