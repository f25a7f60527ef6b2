"""The port's benches against the JAX package's, on the CPU: their tables,
configurations and arithmetic (the timings need the card).

  - ``kernel_bench``: the shape and format table, and every cell's
    roofline against ``quanta_tpu.profiling.matmul_roofline`` with the
    H100's published rates substituted; a reading above 105% of the
    roofline raises;
  - ``model_config("llama2-13b")`` (train bench, model-scale bench) equal
    to JAX's ``LlamaConfig.llama2_13b()`` at the reference benches'
    ``max_seq_len``; ``init_quantized_params`` layouts at the 13B shapes on
    the meta device against JAX's ``eval_shape``;
  - one ``engine_sweep`` cell on a tiny model: its admissions per window;
  - the CLI's ``bench``: the JAX CLI's choices and default, and
    ``bench kernels`` on the CPU exits as the other CUDA benches do;
  - ``logits_gate``: the reordered sums, the limit, and the per-linear
    spread of a tiny model (every route the plain one on the CPU).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from quanta_tpu import cli as jcli
from quanta_tpu import nn as jnn
from quanta_tpu import profiling as jprof
from quanta_tpu.models import llama as jllama
from quanta_tpu_torch import cli as tcli
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch import profiling as tprof
from quanta_tpu_torch.benchmarks import (engine_sweep, kernel_bench, logits_gate,
                                         model_scale_bench, train_bench)
from quanta_tpu_torch.models import llama as tllama

# the H100's published rates in the JAX package's DeviceSpec (vpu_gops
# unused by the matmul roofline)
JAX_H100 = jprof.DeviceSpec("H100", tprof.H100.hbm_gbps, tprof.H100.bf16_tflops,
                            tprof.H100.int8_tops, 0.0)
CFG_FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
              "norm_eps", "rope_theta", "tie_embeddings")


def test_kernel_bench_table():
    """The JAX bench's shapes (TinyLlama's four projections) and M; its
    formats, the llm_int8 routes (kernel, plain) and int4c, plus the
    unfused llm_int8 route (``matmul_int8``, #7), each on its kernel."""
    assert [s[1:] for s in kernel_bench.SHAPES] == [(2048, 2048), (2048, 5632), (5632, 2048),
                                                    (2048, 32000)]
    assert kernel_bench.MS == (8, 128)
    # Llama-2-13B's (K, N), and one rank's at tp = 2 (row-parallel per chunk)
    c = jllama.LlamaConfig.llama2_13b()
    assert [s[1:] for s in kernel_bench.SHAPE_SETS["llama2-13b"]] == [
        (c.dim, c.dim), (c.dim, c.hidden_dim), (c.hidden_dim, c.dim), (c.dim, c.vocab_size)]
    assert [s[1:] for s in kernel_bench.SHAPE_SETS["llama2-13b-tp2"]] == [
        (c.dim, c.dim // 2), (c.dim, c.hidden_dim // 2), (c.dim // 2, c.dim // 2),
        (c.hidden_dim // 2, c.dim // 2), (c.dim, c.vocab_size // 2)]
    kernels = {c: v[2] for c, v in kernel_bench.CELLS.items()}
    assert kernels == {"dense bf16": None, "nf4a": "matmul_4bit", "nf4": "matmul_4bit",
                       "int4": "matmul_4bit", "int8": "matmul_8bit",
                       "llm_int8": "matmul_int8_fused", "llm_int8 unfused": "matmul_int8",
                       "llm_int8 plain": None, "int4c": "matmul_int4c"}


@pytest.mark.parametrize("cell", list(kernel_bench.CELLS))
def test_kernel_bench_roofline_matches_jax(cell):
    """The JAX bench's roofline per cell: dense 16 bits; the 4- and 8-bit
    matmul layouts with block-64 scales; LLM.int8 8 bits and int4c 4 bits
    without block scales."""
    bits = {"dense bf16": 16, "int8": 8, "llm_int8": 8, "llm_int8 unfused": 8,
            "llm_int8 plain": 8}.get(cell, 4)
    block = 64 if cell in ("nf4a", "nf4", "int4", "int8") else 0
    for m in kernel_bench.MS:
        for _, k, n in kernel_bench.SHAPES:
            got = kernel_bench.roofline(cell, m, k, n)
            want = jprof.matmul_roofline(m, k, n, weight_bits=bits, block_size=block,
                                         device=JAX_H100)
            assert (got.flops, got.bytes) == (want.flops, want.bytes)
            assert got.t_roofline_s == pytest.approx(want.t_roofline_s, rel=1e-12)
            assert got.t_memory_s == pytest.approx(want.t_hbm_s, rel=1e-12)
            assert got.t_compute_s == pytest.approx(want.t_mxu_s, rel=1e-12)


def test_kernel_bench_refuses_readings_past_the_roofline():
    k, n = 2048, 5632
    floor_us = kernel_bench.roofline("nf4a", 8, k, n).t_roofline_s * 1e6
    row = kernel_bench.cell_row("nf4a", 8, k, n, 4 * floor_us, 8 * floor_us)
    assert row["pct_roofline"] == pytest.approx(25.0) and row["speedup_vs_dense"] == 2.0
    assert row["bound_by"] == "bytes" and row["kernel"] == "matmul_4bit"
    kernel_bench.cell_row("nf4a", 8, k, n, floor_us / 1.04, floor_us)  # 104%: kept
    with pytest.raises(RuntimeError, match="measurement fault"):
        kernel_bench.cell_row("nf4a", 8, k, n, floor_us / 1.06, floor_us)


@pytest.mark.parametrize("name", ["llama2-7b", "llama2-13b"])
def test_model_configs_match_jax(name):
    """The port's 7B and 13B against JAX's presets, at the reference
    benches' ``max_seq_len`` (model scale 512; train 7B 1024, 13B 512)."""
    want = {"llama2-7b": jllama.LlamaConfig.llama2_7b,
            "llama2-13b": jllama.LlamaConfig.llama2_13b}[name]()
    for cfg, seq in ((model_scale_bench.model_config(name), 512),
                     (train_bench.model_config(name), {"llama2-7b": 1024}.get(name, 512))):
        assert {f: getattr(cfg, f) for f in CFG_FIELDS} == {f: getattr(want, f)
                                                            for f in CFG_FIELDS}
        assert cfg.max_seq_len == seq and cfg.dtype == torch.bfloat16


def test_train_bench_13b_rows():
    assert ("llama2-13b nf4", "llama2-13b", 1, 512, None, 1, 3) in train_bench.LONG_ROWS
    assert [r[0] for r in train_bench.BF16_BASE_ROWS] == ["llama2-7b bf16-base",
                                                          "llama2-13b bf16-base"]
    assert [r[2:4] for r in train_bench.BF16_BASE_ROWS] == [(2, 512), (1, 512)]


@pytest.mark.parametrize("fmt", ["nf4a", "nf4", "int8"])
def test_init_quantized_params_13b_layouts_match_jax(fmt):
    """Llama-2-13B drawn on the meta device: every leaf's layout (codes and
    scale shapes and dtypes, metadata) equals JAX's at the same shapes."""
    tcfg = model_scale_bench.model_config("llama2-13b")
    jcfg = jllama.LlamaConfig.llama2_13b()
    got = tnn.init_quantized_params(None, tcfg, mode=fmt, device="meta")
    want = jax.eval_shape(lambda key: jnn.init_quantized_params(key, jcfg, mode=fmt),
                          jax.random.PRNGKey(0))
    assert got["tok_emb"].shape == want["tok_emb"].shape
    pairs = [(got["lm_head"], want["lm_head"])] + [
        (lt[name], lj[name]) for lt, lj in zip(got["layers"], want["layers"])
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    assert len(pairs) == 7 * 40 + 1
    for t, j in pairs:
        assert tuple(t.codes.shape) == j.codes.shape and tuple(t.scale.shape) == j.scale.shape
        assert str(t.codes.dtype).replace("torch.", "") == str(j.codes.dtype)
        assert (t.bits, t.scheme, t.codebook, tuple(t.shape), t.block_size, t.packed) == (
            j.bits, j.scheme, j.codebook, tuple(j.shape), j.block_size, j.packed)
    # w_down's K = 13824 pads to 14336 (16 x 64 tiles), its N stays 5120
    assert tuple(got["layers"][0]["w_down"].scale.shape) == (14336 // 64, 5120)


def test_engine_sweep_cell_counts_admissions_per_window():
    """One sweep cell on a tiny f32 model on the CPU: every request is
    admitted once (no preemption at this pool), the admissions that rode
    each window add up, and no window admits more than the slots."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, max_seq_len=512)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    row = engine_sweep.cell(params, cfg, fmt="f32", n_requests=10, rate=1000.0, max_new=6,
                            multi_step=4, pipeline_depth=2)
    assert row["admissions"] == 10 and row["preemptions"] == 0
    assert row["requests_finished"] == 10 and row["all_finished"]
    assert 1 <= row["admits_per_window_max"] <= 8
    assert row["windows_admitting"] >= 2  # 10 requests, 8 slots: a second round
    assert row["admits_per_window_mean"] * row["windows"] == pytest.approx(10)
    assert row["tok_s"] > 0 and "device_tok_s" not in row


def test_cli_bench_matches_jax_cli():
    def bench_action(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return next(a for a in sub.choices["bench"]._actions if a.dest == "kind")

    t, j = bench_action(tcli.build_parser()), bench_action(jcli.build_parser())
    assert list(t.choices) == list(j.choices) and t.default == j.default == "kernels"
    assert tcli._BENCHES["headline"] == tcli._BENCHES["decode"]
    with pytest.raises(SystemExit, match="kernel_bench measures a CUDA device"):
        tcli.main(["bench", "kernels"])
    with pytest.raises(SystemExit, match="kernel_bench measures a CUDA device"):
        tcli.main(["bench"])


def test_port_benches_write_no_docs():
    """The JAX benches write docs/*.md by default; the port's write
    markdown only to an ``--out`` path their caller gives."""
    root = pathlib.Path(__file__).resolve().parents[1] / "quanta_tpu_torch" / "benchmarks"
    for path in sorted(root.glob("*.py")):
        assert not re.search(r"[\"']docs[\"'/]", path.read_text()), path.name


def test_bench_modules_need_a_card():
    for mod in (model_scale_bench, engine_sweep, logits_gate):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(SystemExit, match="measures a CUDA device"):
            mod.main([])


@pytest.mark.parametrize("gemm", sorted(logits_gate.ROUTES))
def test_logits_gate_routes_multiply(gemm):
    """Each route beside the plain one is a @ w up to the rounding of its
    own order (and, for the bf16 GEMM, its bf16 output)."""
    g = torch.Generator().manual_seed(len(gemm))
    a = torch.randn((5, 203), generator=g).to(torch.bfloat16)
    w = torch.randn((203, 7), generator=g).to(torch.bfloat16).float()
    ref = a.double() @ w.double()
    out = logits_gate.ROUTES[gemm](a, w)
    assert out.dtype == torch.float32 and out.shape == (5, 7)
    tol = (2.0 ** -7 if gemm == "bf16_gemm" else 1e-5) * ref.abs().max().item()
    assert (out.double() - ref).abs().max().item() <= tol


def test_logits_gate_rule_and_spread():
    assert logits_gate.tolerance(0.0) == logits_gate.REL_L2 == 3e-2
    assert logits_gate.tolerance(0.1) == pytest.approx(1.5 * 0.1 + 2e-3)
    cfg = tllama.LlamaConfig.tiny(dtype=torch.bfloat16)
    params = tnn.init_quantized_params(torch.Generator().manual_seed(0), cfg, mode="int8")
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, row = logits_gate.prefill_logits_vs_plain(tllama, params, prompt, cfg, "tiny")
    assert logits.shape == (2, 16, cfg.vocab_size) and row["tol"] == 3e-2
    rows = logits_gate.linear_spread(tllama, params, prompt, cfg)
    assert [(r["k"], r["n"]) for r in rows[:2]] == [(cfg.dim, cfg.n_heads * cfg.head_dim),
                                                   (cfg.dim, cfg.n_kv_heads * cfg.head_dim)]
    assert len(rows) == 7 * cfg.n_layers + 1
    # on the CPU the kernel route is the plain one
    assert all(r["kernel_rel_l2"] == 0.0 for r in rows)
