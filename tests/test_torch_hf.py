"""Port parity: models.hf (HF checkpoint interchange and its own
safetensors codec) against quanta_tpu.models.hf, transformers and the
safetensors library.

Tiny checkpoints are built by transformers from a config and saved with
``save_pretrained`` (nothing is downloaded). Tolerances:
  - tensors loaded by the port and by the JAX package, written and read
    back, or passed through the codec: bit for bit;
  - the port's logits against transformers' forward: rtol 1e-3, atol 2e-3,
    the JAX package's own import tests' tolerance (two f32 forwards that
    sum in other orders);
  - the port's logits against the port's own, through an exported and
    re-imported checkpoint: 1e-5.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from quanta_tpu.models import hf as jhf  # noqa: E402
from quanta_tpu_torch import nn as tnn  # noqa: E402
from quanta_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from quanta_tpu_torch.models import hf as thf  # noqa: E402
from quanta_tpu_torch.models import llama as tllama  # noqa: E402

TOL = dict(rtol=1e-3, atol=2e-3)


@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf_llama")
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path), model


@pytest.fixture(scope="module")
def gpt2_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf_gpt2")
    cfg = transformers.GPT2Config(vocab_size=160, n_embd=48, n_layer=2, n_head=4,
                                  n_positions=64, attn_pdrop=0.0, embd_pdrop=0.0,
                                  resid_pdrop=0.0)
    torch.manual_seed(1)
    model = transformers.GPT2LMHeadModel(cfg).eval()
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path), model


def _flat(tree, prefix=""):
    """{path: tensor or array} of a dense tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_trees_equal(ttree, jtree):
    t, j = _flat(ttree), _flat(jtree)
    assert sorted(t) == sorted(j)
    for k in t:
        a, b = t[k], np.asarray(j[k])
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name, k
        np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32), err_msg=k)


def _hf_logits(model, toks):
    with torch.no_grad():
        return model(torch.from_numpy(toks).long()).logits.numpy()


# ------------------------------------------------------------------ import


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_llama_equals_jax(llama_ckpt, dtype):
    path, _ = llama_ckpt
    tparams, tcfg = thf.load_llama(path, dtype=getattr(torch, dtype))
    jparams, jcfg = jhf.load_llama(path, dtype=jnp.dtype(dtype))
    _assert_trees_equal(tparams, jparams)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim",
              "norm_eps", "rope_theta", "max_seq_len", "tie_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.dtype == getattr(torch, dtype)
    assert all(t.is_contiguous() for t in _flat(tparams).values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_gpt2_equals_jax(gpt2_ckpt, dtype):
    path, _ = gpt2_ckpt
    tparams, tcfg = thf.load_gpt2(path, dtype=getattr(torch, dtype))
    jparams, jcfg = jhf.load_gpt2(path, dtype=jnp.dtype(dtype))
    _assert_trees_equal(tparams, jparams)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "max_seq_len", "norm_eps"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_llama_import_matches_transformers(llama_ckpt):
    path, hf_model = llama_ckpt
    params, cfg = thf.load_llama(path, dtype=torch.float32)
    toks = np.array([[1, 5, 9, 42, 100, 7], [3, 3, 8, 19, 64, 2]], np.int32)
    ref = _hf_logits(hf_model, toks)
    ours, _ = tllama.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    # prefill 5 then decode 1 through the KV cache
    cache = tllama.init_cache(cfg, 2, max_len=8)
    _, cache = tllama.forward(params, torch.from_numpy(toks[:, :5]), cfg, cache=cache)
    last, _ = tllama.forward(params, torch.from_numpy(toks[:, 5:6]), cfg, cache=cache)
    np.testing.assert_allclose(last[:, 0].numpy(), ref[:, 5], **TOL)


def test_gpt2_import_matches_transformers(gpt2_ckpt):
    path, hf_model = gpt2_ckpt
    params, cfg = thf.load_gpt2(path)
    assert cfg.n_layers == 2 and cfg.dim == 48 and cfg.dtype == torch.float32
    toks = np.array([[2, 17, 40, 99, 150, 11], [0, 1, 2, 3, 4, 5]], np.int32)
    ref = _hf_logits(hf_model, toks)
    ours, _ = tgpt2.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    cache = tgpt2.init_cache(cfg, 2, max_len=8)
    _, cache = tgpt2.forward(params, torch.from_numpy(toks[:, :4]), cfg, cache=cache)
    for i in (4, 5):
        step, cache = tgpt2.forward(params, torch.from_numpy(toks[:, i:i + 1]), cfg, cache=cache)
        np.testing.assert_allclose(step[:, 0].numpy(), ref[:, i], **TOL)


def test_unused_tensors_are_reported(gpt2_ckpt, tmp_path, capsys):
    path, _ = gpt2_ckpt
    tensors = thf.read_safetensors_dir(path)
    tensors["transformer.extra.weight"] = torch.ones(3)
    thf.write_safetensors(tensors, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(pathlib.Path(path, "config.json").read_text())
    thf.load_gpt2(str(tmp_path))
    assert "1 unused checkpoint tensors: ['transformer.extra.weight']" in capsys.readouterr().err
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        thf.read_safetensors_dir(str(tmp_path / "empty"))


# ------------------------------------------------------------------ export


def test_llama_export_loads_in_jax_and_transformers(tmp_path):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    out = str(tmp_path / "export")
    thf.save_llama(params, cfg, out)
    jparams, _ = jhf.load_llama(out, dtype=jnp.float32)
    _assert_trees_equal(params, jparams)
    back, cfg2 = thf.load_llama(out, dtype=torch.float32)
    assert cfg2 == cfg
    _assert_trees_equal(back, jparams)
    hf_model = transformers.LlamaForCausalLM.from_pretrained(out).eval()
    toks = np.array([[1, 5, 9, 42, 100, 7]], np.int32)
    ours, _ = tllama.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(ours.numpy(), _hf_logits(hf_model, toks), **TOL)


def test_gpt2_export_loads_in_jax_and_transformers(tmp_path):
    cfg = tgpt2.GPT2Config(vocab_size=160, dim=48, n_layers=2, n_heads=4, max_seq_len=64)
    params = tgpt2.init_params(torch.Generator().manual_seed(2), cfg)
    out = str(tmp_path / "export_gpt2")
    thf.save_gpt2(params, cfg, out)
    jparams, _ = jhf.load_gpt2(out, dtype=jnp.float32)
    _assert_trees_equal(params, jparams)
    back, cfg2 = thf.load_gpt2(out)
    assert cfg2 == cfg
    _assert_trees_equal(back, jparams)
    hf_model = transformers.GPT2LMHeadModel.from_pretrained(out).eval()
    toks = np.array([[3, 7, 31, 90]], np.int32)
    ours, _ = tgpt2.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(ours.numpy(), _hf_logits(hf_model, toks), **TOL)


def _lora_tree(params, seed):
    """Every wq (Llama) or attn_qkv (GPT-2) wrapped in a LoRAWeight with
    nonzero adapters: a trained-LoRA stand-in."""
    g = torch.Generator().manual_seed(seed)
    for lp in params["layers"]:
        key, sub = ("wq", None) if "wq" in lp else ("attn_qkv", "w")
        node = lp if sub is None else lp[key]
        name = key if sub is None else sub
        lw = tnn.init_lora(node[name], g, rank=2, dtype=torch.float32)
        lw.lora_b = (torch.randn(lw.lora_b.shape, generator=g) * 0.02).requires_grad_()
        node[name] = lw
    return params


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
@pytest.mark.parametrize("fmt", ["nf4", "llm_int8"])
def test_quantized_lora_export(tmp_path, arch, fmt):
    """A quantized tree with LoRA adapters exports as merged dense f32
    weights: the JAX package reads the file, and transformers' logits
    track the port's forward of those dense weights; for nf4 also of the
    quantized tree through the plain routes (LLM.int8 quantizes
    activations too, so its forward is not the dense one's)."""
    if arch == "llama":
        cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
        mod, save, hf_cls = tllama, thf.save_llama, transformers.LlamaForCausalLM
    else:
        cfg = tgpt2.GPT2Config(vocab_size=160, dim=64, n_layers=2, n_heads=4, max_seq_len=64)
        mod, save, hf_cls = tgpt2, thf.save_gpt2, transformers.GPT2LMHeadModel
    params = mod.init_params(torch.Generator().manual_seed(3), cfg)
    qparams = _lora_tree(tnn.quantize_params(params, mode=fmt, min_size=0), seed=4)
    out = str(tmp_path / "export_q")
    save(qparams, cfg, out)
    dense = thf._materialize(qparams)
    jload = jhf.load_llama if arch == "llama" else jhf.load_gpt2
    _assert_trees_equal(dense, jload(out, dtype=jnp.float32)[0])
    toks = np.array([[2, 4, 8, 16, 32]], np.int32)
    ref = _hf_logits(hf_cls.from_pretrained(out).eval(), toks)
    with torch.no_grad():
        routes = [dense] + ([qparams] if fmt == "nf4" else [])
        for tree in routes:
            ours, _ = mod.forward(tree, torch.from_numpy(toks), cfg, use_kernel=False)
            np.testing.assert_allclose(ours.numpy(), ref, **TOL)


# -------------------------------------------------------- safetensors codec


def _codec_tensors():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 5, 7), generator=g)
    return {
        "f32": x, "f16": x.to(torch.float16), "bf16": x.to(torch.bfloat16),
        "scalar": torch.tensor(2.5),
        "i8": torch.randint(-128, 128, (9, 4), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (13,), generator=g, dtype=torch.uint8),
        "i32": torch.randint(-2**31, 2**31 - 1, (4, 4), generator=g, dtype=torch.int32),
        "i64": torch.randint(-2**62, 2**62, (6,), generator=g, dtype=torch.int64),
        "empty": torch.zeros((0, 3)),
        "strided": x[:, 1:4].transpose(0, 2),  # not contiguous
    }


def _assert_equal_tensors(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_codec_writes_what_safetensors_reads(tmp_path):
    tensors = _codec_tensors()
    path = str(tmp_path / "port.safetensors")
    thf.write_safetensors(tensors, path)
    _assert_equal_tensors(safetensors_torch.load_file(path), tensors)
    assert int.from_bytes(open(path, "rb").read(8), "little") % 8 == 0


def test_codec_reads_what_safetensors_writes(tmp_path):
    tensors = {k: v.contiguous() for k, v in _codec_tensors().items()}
    path = str(tmp_path / "lib.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    _assert_equal_tensors(thf.read_safetensors(path), tensors)
    # and the numpy flavour the JAX package writes (F32 only)
    from safetensors.numpy import save_file

    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(5, np.float32)}
    save_file(arrays, str(tmp_path / "np.safetensors"))
    got = thf.read_safetensors(str(tmp_path / "np.safetensors"))
    for k, a in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), a)


def test_codec_refuses_a_dtype_it_does_not_know(tmp_path):
    with pytest.raises(TypeError, match="no tag"):
        thf.write_safetensors({"c": torch.zeros(2, dtype=torch.float64)},
                              str(tmp_path / "c.safetensors"))
    safetensors_torch.save_file({"b": torch.ones(3, dtype=torch.bool)},
                                str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="dtype BOOL"):
        thf.read_safetensors(str(tmp_path / "b.safetensors"))


def test_port_imports_neither_safetensors_nor_transformers():
    """Static check over the port and chip_smoke.py: the card machine has
    neither package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    pat = re.compile(r"^\s*(import|from)\s+(safetensors|transformers)\b", re.M)
    files = sorted((root / "quanta_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert root / "quanta_tpu_torch" / "models" / "hf.py" in files
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders, offenders
