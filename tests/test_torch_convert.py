"""Port parity: utils.convert, the single-tensor formats, the
QuantizationState registry and core.tensor_ops against quanta_tpu's; and
the smaller pieces of the library (serve.sampling.sample,
metrics.device_memory_gb, profiling, the accuracy bench's nf4->nf4a row).

Inputs come from numpy seeds; a JAX QuantizedTensor reaches the port
through ``interop.from_jax_params``. Tolerances:
  - codes, scales, zero points, remapped codes and file bytes: bit for bit
    (both sides run the same f32 operations in the same order);
  - ``quantized_matmul``: bit for bit where the float product sums exactly
    (integer grids); elsewhere XLA and torch sum in other orders, so an
    output can move by one code step where it sits on a rounding boundary
    (codes within 1, at most 1% of them);
  - ``.npz`` files: the same arrays and metadata (zip entries carry the
    time they were written, so the bytes differ).
"""

import dataclasses
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import core as jcore
from quanta_tpu.state import config as jconfig
from quanta_tpu.state import registry as jregistry
from quanta_tpu.utils import convert as jconvert
from quanta_tpu.utils import serialization as jser
from quanta_tpu_torch import core as tcore
from quanta_tpu_torch import interop, profiling
from quanta_tpu_torch.benchmarks import accuracy_bench
from quanta_tpu_torch.metrics import device_memory_gb
from quanta_tpu_torch.serve.sampling import SamplingParams, _sample_batch, sample
from quanta_tpu_torch.state import QuantizationState
from quanta_tpu_torch.state import config as tconfig
from quanta_tpu_torch.utils import convert as tconvert
from quanta_tpu_torch.utils import serialization as tser


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same(tq, jq):
    """A port QuantizedTensor equals a JAX one: arrays bit for bit, metadata."""
    assert (tq.bits, tq.scheme, tq.codebook, tq.shape, tq.block_size, tq.packed) == (
        jq.bits, jq.scheme, jq.codebook, tuple(jq.shape), jq.block_size, jq.packed)
    assert tser.dtype_name(tq.dtype) == str(jnp.dtype(jq.dtype))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    assert tq.codes.numpy().dtype == np.asarray(jq.codes).dtype
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert (tq.zero_point is None) == (jq.zero_point is None)
    if jq.zero_point is not None:
        np.testing.assert_array_equal(tq.zero_point.numpy(), np.asarray(jq.zero_point))


# the source layouts of a 4-bit tensor, and 8-bit ones
SOURCES = {
    "split_k_nf4": lambda x: jcore.quantize_matmul_weight(x, fmt="nf4", block_size=64),
    "flat_packed_nf4": lambda x: jcore.quantize(x, bits=4, scheme="codebook", codebook="nf4",
                                                block_size=64, pack=True),
    "unpacked_nf4": lambda x: jcore.quantize(x, bits=4, scheme="codebook", codebook="nf4",
                                             block_size=64),
    "symmetric_int4_packed": lambda x: jcore.quantize(x, bits=4, block_size=32, pack=True),
    "symmetric_int8": lambda x: jcore.quantize(x, bits=8, block_size=64),
    "affine_int8": lambda x: jcore.quantize(x, bits=8, scheme="affine", block_size=128),
    "nf8": lambda x: jcore.quantize(x, bits=8, scheme="codebook", codebook="nf8",
                                    block_size=64),
}


@pytest.fixture(scope="module")
def sources():
    x = jnp.asarray(_x((96, 200), seed=3))
    return {name: make(x) for name, make in SOURCES.items()}


CONVERSIONS = {
    "to_4bit": lambda m, q: m.convert_8bit_to_4bit(q),
    "to_8bit": lambda m, q: m.convert_4bit_to_8bit(q),
    "to_8bit_affine_block0": lambda m, q: m.convert_4bit_to_8bit(q, scheme="affine",
                                                                  block_size=0),
    "to_fp4_unpacked": lambda m, q: m.convert_precision(q, bits=4, scheme="codebook",
                                                        codebook="fp4", pack=False),
    "reblock_32": lambda m, q: m.convert_precision(q, block_size=32),
    "same": lambda m, q: m.convert_precision(q),
}


@pytest.mark.parametrize("conv", sorted(CONVERSIONS))
@pytest.mark.parametrize("src", sorted(SOURCES))
def test_convert_precision_bit_exact(sources, src, conv):
    jq = sources[src]
    _same(CONVERSIONS[conv](tconvert, interop.from_jax_params(jq)),
          CONVERSIONS[conv](jconvert, jq))


@pytest.mark.parametrize("target", sorted(jconvert.HARDWARE_TARGETS))
def test_hardware_targets_bit_exact(sources, target):
    assert tconfig.QuantConfig.to_dict(tconvert.HARDWARE_TARGETS[target]) == \
        jconfig.QuantConfig.to_dict(jconvert.HARDWARE_TARGETS[target])
    for src in ("split_k_nf4", "symmetric_int8"):
        jq = sources[src]
        _same(tconvert.optimize_for_target_hardware(interop.from_jax_params(jq), target),
              jconvert.optimize_for_target_hardware(jq, target))
    with pytest.raises(ValueError, match="unknown target"):
        tconvert.optimize_for_target_hardware(interop.from_jax_params(jq), "tpu-v9")


# nf4 -> int4 maps code 0 to 1: remapping an unpacked tensor's zero high
# nibble would corrupt every code
@pytest.mark.parametrize("pair", [("nf4", "nf4a"), ("nf4a", "nf4"), ("nf4", "int4"),
                                  ("fp4", "nf4a")])
@pytest.mark.parametrize("src", ["split_k_nf4", "flat_packed_nf4", "unpacked_nf4"])
def test_transcode_codebook_bit_exact(sources, src, pair):
    source, target = pair
    x = jnp.asarray(_x((96, 200), seed=4))
    jq = SOURCES[src](x)
    if source != "nf4":  # the same layout in the other source codebook
        jq = dataclasses.replace(jq, codebook=source)
    tq = tconvert.transcode_codebook(interop.from_jax_params(jq), target)
    _same(tq, jconvert.transcode_codebook(jq, target))
    if src == "unpacked_nf4":
        assert int(tq.codes.max()) < 16  # the high nibble stays 0


def test_transcode_refuses_what_it_cannot_map(sources):
    tq = interop.from_jax_params(sources["symmetric_int8"])
    with pytest.raises(ValueError, match="codebook-format"):
        tconvert.transcode_codebook(tq)
    with pytest.raises(ValueError, match="sizes differ"):
        tconvert.transcode_codebook(interop.from_jax_params(sources["nf8"]), "nf4a")
    with pytest.raises(ValueError, match="unknown codebook"):
        tconvert.transcode_codebook(interop.from_jax_params(sources["unpacked_nf4"]), "nf3")


def test_transcode_params_bit_exact():
    from quanta_tpu import nn as jnn
    from quanta_tpu.nn import init_lora

    x = _x((128, 256), seed=5)
    jtree = {"a": jcore.quantize_matmul_weight(jnp.asarray(x), fmt="nf4"),
             "b": [jcore.quantize_matmul_weight(jnp.asarray(x), fmt="nf4a"),
                   jnp.asarray(x[:4])],
             "c": init_lora(jnn.quantize_linear_weight(jnp.asarray(x), mode="nf4"),
                            jax.random.PRNGKey(0), rank=2)}
    jout = jconvert.transcode_params(jtree)
    tout = tconvert.transcode_params(interop.from_jax_params(jtree))
    _same(tout["a"], jout["a"])
    _same(tout["b"][0], jout["b"][0])
    assert tout["a"].codebook == tout["b"][0].codebook == tout["c"].base.codebook == "nf4a"
    _same(tout["c"].base, jout["c"].base)
    np.testing.assert_array_equal(tout["b"][1].numpy(), x[:4])


# ------------------------------------------------------ single-tensor files


@pytest.mark.parametrize("src", sorted(SOURCES))
def test_qtn_bytes_and_cross_loads(sources, src, tmp_path):
    jq = sources[src]
    tq = interop.from_jax_params(jq)
    jser.save_qtn(jq, str(tmp_path / "j.qtn"))
    tser.save_qtn(tq, str(tmp_path / "t.qtn"))
    assert (tmp_path / "j.qtn").read_bytes() == (tmp_path / "t.qtn").read_bytes()
    _same(tser.load_qtn(str(tmp_path / "j.qtn")), jq)
    _same(interop.from_jax_params(jser.load_qtn(str(tmp_path / "t.qtn"))), jq)


@pytest.mark.parametrize("src", sorted(SOURCES))
def test_npz_cross_loads(sources, src, tmp_path):
    jq = sources[src]
    jser.save_npz(jq, str(tmp_path / "j.npz"))
    tser.save_npz(interop.from_jax_params(jq), str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    _same(tser.load_npz(str(tmp_path / "j.npz")), jq)
    _same(interop.from_jax_params(jser.load_npz(str(tmp_path / "t.npz"))), jq)


def test_quantized_tensor_dispatch_by_extension(sources, tmp_path):
    jq = sources["split_k_nf4"]
    tq = interop.from_jax_params(jq)
    for ext in ("qtn", "npz"):
        path = str(tmp_path / f"t.{ext}")
        tser.save_quantized_tensor(tq, path)
        _same(tser.load_quantized_tensor(path), jq)
        _same(interop.from_jax_params(jser.load_quantized_tensor(path)), jq)
    with pytest.raises(ValueError, match="unsupported extension"):
        tser.save_quantized_tensor(tq, str(tmp_path / "t.bin"))
    with pytest.raises(ValueError, match="unsupported extension"):
        tser.load_quantized_tensor(str(tmp_path / "t.bin"))
    (tmp_path / "bad.qtn").write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(ValueError, match="not a .qtn file"):
        tser.load_qtn(str(tmp_path / "bad.qtn"))


# ----------------------------------------------------------------- registry


def _registries():
    """The same registry, built in each package."""
    states = []
    for cfg_mod, make in ((jconfig, jregistry.QuantizationState),
                          (tconfig, QuantizationState)):
        tree = cfg_mod.ConfigTree(cfg_mod.QuantConfig(bits=8, block_size=64))
        tree.config_layer(r"attn/.*", bits=4, scheme="codebook", codebook="nf4", pack=True)
        tree.config_tensor("mlp/w", calibration="percentile")
        tree.config_layer(r"ffn/.*", calibration="entropy", scheme="affine")
        st = make(tree)
        st.set_layer_params("attn", heads=4, note="grouped")
        states.append(st)
    return states


@pytest.mark.parametrize("name", ["attn/wq", "mlp/w", "ffn/up", "other"])
def test_registry_quantize_bit_exact(name):
    jst, tst = _registries()
    x = _x((64, 96), seed=len(name))
    jq = jst.quantize(name, jnp.asarray(x))
    tq = tst.quantize(name, torch.from_numpy(x))
    _same(tq, jq)
    assert tst.get_tensor_params(name) == jst.get_tensor_params(name)
    np.testing.assert_array_equal(tst.dequantize(name).numpy(), np.asarray(jst.dequantize(name)))


def test_registry_snapshot_cross_loads(tmp_path):
    jst, tst = _registries()
    for i, name in enumerate(["attn/wq", "mlp/w", "ffn/up"]):
        x = _x((64, 96), seed=i)
        jst.quantize(name, jnp.asarray(x))
        tst.quantize(name, torch.from_numpy(x))
    assert tst.summary_json() == jst.summary_json()
    assert tst.names() == jst.names() and "mlp/w" in tst and "nope" not in tst
    tst.save_json(str(tmp_path / "t.json"))
    jst.save_json(str(tmp_path / "j.json"))
    back_j = jregistry.QuantizationState.load_json(str(tmp_path / "t.json"))
    back_t = QuantizationState.load_json(str(tmp_path / "j.json"))
    assert back_t.config.to_json() == back_j.config.to_json() == jst.config.to_json()
    assert back_t.get_layer_params("attn") == back_j.get_layer_params("attn") == {
        "heads": 4, "note": "grouped"}
    # one registered tensor through a file each way
    tst.save_tensor("attn/wq", str(tmp_path / "wq.qtn"))
    back_j.load_tensor("attn/wq", str(tmp_path / "wq.qtn"))
    _same(interop.from_jax_params(back_j.get("attn/wq")), jst.get("attn/wq"))
    jst.save_tensor("mlp/w", str(tmp_path / "w.npz"))
    _same(back_t.load_tensor("mlp/w", str(tmp_path / "w.npz")), jst.get("mlp/w"))
    assert back_t.names() == ["mlp/w"]


# -------------------------------------------------------------- tensor ops


OPERANDS = {
    "symmetric8": dict(bits=8, block_size=64),
    "symmetric4_packed": dict(bits=4, block_size=32, pack=True),
    "affine8": dict(bits=8, scheme="affine", block_size=64),
    "nf4": dict(bits=4, scheme="codebook", codebook="nf4", block_size=64),
    "fp8": dict(bits=8, scheme="codebook", codebook="fp8", block_size=64),
}


@pytest.mark.parametrize("kw", sorted(OPERANDS))
def test_quantized_add_mul_bit_exact(kw):
    a, b = _x((48, 64), seed=1), _x((48, 64), seed=2)
    ja = jcore.quantize(jnp.asarray(a), **OPERANDS[kw])
    ta = interop.from_jax_params(ja)
    for op in ("quantized_add", "quantized_mul"):
        # quantized with a plain array, either side, and with another qtensor
        _same(getattr(tcore, op)(ta, torch.from_numpy(b)), getattr(jcore, op)(ja, jnp.asarray(b)))
        _same(getattr(tcore, op)(torch.from_numpy(b), ta), getattr(jcore, op)(jnp.asarray(b), ja))
        _same(getattr(tcore, op)(ta, ta), getattr(jcore, op)(ja, ja))
    with pytest.raises(TypeError, match="QuantizedTensor"):
        tcore.quantized_add(torch.from_numpy(a), torch.from_numpy(b))


def test_quantized_matmul_exact_on_an_integer_grid():
    """Integers up to 127 in blocks whose absmax is 127: scale 1, the
    dequantized values and every partial sum exact in f32, so the product
    and its codes are bit for bit in any summation order."""
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, (32, 64)).astype(np.float32)
    b = rng.integers(-3, 4, (64, 48)).astype(np.float32)
    a[:, 0] = 127.0
    ja = jcore.quantize(jnp.asarray(a), bits=8, block_size=64)
    assert (np.asarray(ja.scale) == 1.0).all()
    _same(tcore.quantized_matmul(interop.from_jax_params(ja), torch.from_numpy(b)),
          jcore.quantized_matmul(ja, jnp.asarray(b)))


@pytest.mark.parametrize("kw", ["symmetric8", "nf4", "affine8"])
def test_quantized_matmul_random(kw):
    a, b = _x((32, 64), seed=3), _x((64, 48), seed=4)
    ja = jcore.quantize(jnp.asarray(a), **OPERANDS[kw])
    jout = jcore.quantized_matmul(ja, jnp.asarray(b))
    tout = tcore.quantized_matmul(interop.from_jax_params(ja), torch.from_numpy(b))
    diff = np.abs(tout.codes.numpy().astype(int) - np.asarray(jout.codes).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    np.testing.assert_allclose(tout.scale.numpy(), np.asarray(jout.scale), rtol=1e-5)


@pytest.mark.parametrize("kw", ["symmetric8", "nf4", "fp8", "affine8", "symmetric4_packed"])
def test_quantized_relu_bit_exact(kw):
    x = _x((48, 64), seed=6)
    jq = jcore.quantize(jnp.asarray(x), **OPERANDS[kw])
    tq = tcore.quantized_relu(interop.from_jax_params(jq))
    _same(tq, jcore.quantized_relu(jq))
    if kw in ("symmetric8", "nf4"):  # on the codes: the same scales, max(x, 0) exactly
        deq = interop.from_jax_params(jq).dequantize()
        np.testing.assert_array_equal(tq.dequantize().numpy(), torch.clamp(deq, min=0).numpy())


def test_quantized_relu_4bit_symmetric_unpacked():
    """4-bit symmetric codes are stored offset by 8: ReLU clamps them at 8.
    The JAX package clamps at 0, which leaves them as they are (a fault of
    the reference, ROADMAP); the port's result is ReLU's."""
    x = _x((48, 64), seed=8)
    jq = jcore.quantize(jnp.asarray(x), bits=4, block_size=32)
    tq = interop.from_jax_params(jq)
    out = tcore.quantized_relu(tq)
    np.testing.assert_array_equal(out.dequantize().numpy(),
                                  torch.clamp(tq.dequantize(), min=0).numpy())
    np.testing.assert_array_equal(np.asarray(jcore.quantized_relu(jq).codes),
                                  np.asarray(jq.codes))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(jq.scale))


# ----------------------------------------------------------- smaller pieces


def test_sample_greedy_rows_match_argmax():
    logits = torch.from_numpy(_x((6, 300), seed=9))
    gen = torch.Generator().manual_seed(0)
    want = logits.argmax(dim=-1).to(torch.int32)
    for params in (SamplingParams(), SamplingParams(temperature=0.0, top_k=5),
                   SamplingParams(temperature=0.8, top_k=1)):
        assert torch.equal(sample(logits, gen, params), want)
    # a temperature draws as _sample_batch does from the same generator state
    params = SamplingParams(temperature=1.0, top_k=20)
    got = sample(logits, torch.Generator().manual_seed(4), params)
    ref = _sample_batch(logits, torch.Generator().manual_seed(4), torch.ones(6), top_k=20)
    assert torch.equal(got, ref)
    top20 = torch.topk(logits, 20, dim=-1).indices
    assert all(int(t) in top20[i].tolist() for i, t in enumerate(got))


def test_device_memory_gb_on_the_cpu():
    assert device_memory_gb("cpu") == 0.0
    assert isinstance(device_memory_gb(), float)


def test_matmul_roofline_on_the_h100_row():
    h100 = profiling.H100
    assert profiling.device_spec(h100) is h100 and profiling.device_spec("cpu").name == "cpu"
    # a decode step's nf4a (2048, 5632) at M=8: bytes-bound
    r = profiling.matmul_roofline(8, 2048, 5632, weight_bits=4, block_size=64, device=h100)
    n_bytes = 8 * 2048 * 2 + 2048 * 5632 // 2 + 32 * 5632 * 4 + 8 * 5632 * 2
    assert (r.flops, r.bytes) == (2 * 8 * 2048 * 5632, n_bytes)
    assert r.t_memory_s > r.t_compute_s and r.t_roofline_s == pytest.approx(n_bytes / 3.35e12)
    # a QLoRA forward's (2048, 5632) at M=2048 in bf16: operations-bound, at 989 TFLOP/s
    r = profiling.matmul_roofline(2048, 2048, 5632, device=h100)
    assert r.t_compute_s > r.t_memory_s
    assert r.t_roofline_s == pytest.approx(2 * 2048 * 2048 * 5632 / 989e12)
    assert (h100.int8_tops, h100.f32_tflops) == (1979.0, 67.0)
    assert r.pct(2 * r.t_roofline_s) == pytest.approx(50.0)
    from quanta_tpu_torch.models.llama import LlamaConfig

    step = profiling.decode_step_roofline(LlamaConfig.tinyllama_1b(), weight_bits=4,
                                          block_size=64, device=h100)
    assert step.t_memory_s > step.t_compute_s and 1e-4 < step.t_roofline_s < 1e-3


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())


def test_measure_has_no_cpu_path():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: measure times it")
    with pytest.raises(RuntimeError, match="no CUDA device|there is none"):
        profiling.measure(lambda: None)


def test_accuracy_bench_prints_the_transcoded_row(monkeypatch):
    # the smallest size at which the linears reach quantize_params' min_size;
    # W8A8 keeps its minmax row only (the entropy search is seconds of numpy
    # per tensor, and the W8A8 rows are not this test's subject)
    monkeypatch.setattr(accuracy_bench, "W8A8", ("minmax",))
    result, variants, _, _ = accuracy_bench.run(steps=2, dim=64, layers=1, seq=32, batch=2,
                                                eval_bytes=1000, device="cpu")
    rows = {r["format"]: r for r in result["rows"]}
    row = rows["nf4->nf4a"]
    assert row["gate"] == 0.5 and np.isfinite(row["ppl"]) and "left_out" not in result
    w = variants["nf4->nf4a"]["layers"][0]["w_up"]
    assert w.codebook == "nf4a" and torch.equal(w.scale, variants["nf4"]["layers"][0]["w_up"].scale)
    table = accuracy_bench.markdown(result["rows"], result)
    assert "| nf4->nf4a |" in table and "Left out" not in table
    json.dumps(result)


def test_accuracy_bench_names_its_corpus(monkeypatch, tmp_path):
    """The JSON result and the markdown table carry the corpus's tag (the
    hash that also names the cached checkpoint) and the train split's size
    in bytes, so that perplexity rows from two corpora are told apart; a
    second run reads the checkpoint from the cache (no final loss) and
    writes its table all the same. The variants are cut to the unquantized
    model: the formats are not this test's subject."""
    monkeypatch.setattr(accuracy_bench, "build_variants",
                        lambda params, cfg, ids, device: {"bf16": params})
    train_ids, _ = accuracy_bench.corpus_ids(1000)
    tag = hashlib.sha256(train_ids.tobytes()).hexdigest()[:12]
    kw = dict(steps=2, dim=64, layers=1, seq=32, batch=2, eval_bytes=1000, device="cpu",
              cache_dir=str(tmp_path))
    first, *_ = accuracy_bench.run(**kw)
    cached, *_ = accuracy_bench.run(**kw)
    assert first["final_loss"] is not None and cached["final_loss"] is None
    assert [p.name for p in tmp_path.iterdir()] == [f"accbench_d64_l1_s32_b2_t2_{tag}.npz"]
    for result in (first, cached):
        assert result["corpus_tag"] == tag and result["train_bytes"] == len(train_ids) > 0
        table = accuracy_bench.markdown(result["rows"], result)
        assert f"({len(train_ids)} train bytes, tag {tag})" in table
        assert json.loads(json.dumps(result))["corpus_tag"] == tag
