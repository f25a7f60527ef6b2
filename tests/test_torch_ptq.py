"""Port parity: the post-training-quantization workflow against quanta_tpu's.

``state.config``, ``calib``, ``ptq``, ``eval``, ``utils.serialization`` and
the CLI, at a tiny Llama in f32 (in bf16 the two frameworks round at
different places). The JAX package makes the parameters from a seed;
``interop.from_jax_params`` hands the same numbers to the port; tokens
come from numpy.

Tolerances:
  - activation min / max / per-feature absmax: 1e-5 relative (the two
    frameworks' forwards differ in f32 rounding, ~1e-6 here);
  - histograms: the same total count; a sample whose activation differs in
    the last bits, or sits at a bin edge that moved with the range's last
    bits, can land in a neighbouring bin: at most 0.1% of the samples move
    (11 of 49,152 measured), on average by at most two bins (the running
    count of moved samples is non-zero at no more than twice as many bins
    as samples moved);
  - ranges reduced from the same statistics, codes, scales, zero points,
    activation ranges and checkpoint arrays: bit for bit;
  - ranges reduced from the port's own statistics: within one histogram bin;
  - perplexity: 1e-5 relative (eval), 1e-4 through the CLI, which prints it
    rounded to 4 decimals.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import calib as jcalib
from quanta_tpu import cli as jcli
from quanta_tpu import core as jcore
from quanta_tpu import eval as jeval
from quanta_tpu import nn as jnn
from quanta_tpu import ptq as jptq
from quanta_tpu.models import llama as jllama
from quanta_tpu.ops import int4c as jint4c
from quanta_tpu.ops import int8mm as jint8
from quanta_tpu.state import config as jconfig
from quanta_tpu.utils import serialization as jser
from quanta_tpu_torch import calib as tcalib
from quanta_tpu_torch import cli as tcli
from quanta_tpu_torch import eval as teval
from quanta_tpu_torch import interop
from quanta_tpu_torch import ptq as tptq
from quanta_tpu_torch.benchmarks import corpus as tcorpus
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.nn.lora import LoRAWeight
from quanta_tpu_torch.ops.int4c import Int4cWeight
from quanta_tpu_torch.ops.int8mm import Int8Weight
from quanta_tpu_torch.state import config as tconfig
from quanta_tpu_torch.utils import serialization as tser

JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)
METHODS = ("minmax", "percentile", "entropy")


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, JCFG.vocab_size, (2, 32), dtype=np.int32) for _ in range(3)]


@pytest.fixture(scope="module")
def stats(jparams, batches):
    """(JAX stats, the port's stats) of the same model on the same batches."""
    js = jcalib.collect_stats(lambda p, b: jllama.forward(p, b, JCFG, use_kernel=False)[0],
                              jparams, [jnp.asarray(b) for b in batches])
    ts = tcalib.collect_stats(lambda p, b: tllama.forward(p, b, TCFG)[0],
                              interop.from_jax_params(jparams),
                              [torch.from_numpy(b) for b in batches])
    return js, ts


def _as_port_stats(js):
    return {n: tcalib.ActivationStats(amin=s.amin, amax=s.amax, colmax=s.colmax, hist=s.hist)
            for n, s in js.items()}


def _rule_tree(mod):
    """int8 by default; nf8 on layer 0, fp8 on the head, W8A8 int8a with
    entropy calibration on w_down, and a dotted rule that matches nothing."""
    return (mod.ConfigTree(mod.QuantConfig.from_mode("int8"))
            .config_layer(r"layers/0/", scheme="codebook", codebook="nf8")
            .config_layer(r"lm_head", scheme="codebook", codebook="fp8")
            .config_layer(r"w_down", scheme="affine", weights_only=False,
                          calibration="entropy")
            .config_layer(r"layers\.0\.", bits=4)
            .config_tensor("layers/1/wo", block_size=128))


# ------------------------------------------------------------ state.config


def test_config_tree_json_and_resolve_match_jax():
    jt, tt = _rule_tree(jconfig), _rule_tree(tconfig)
    assert tt.to_json() == jt.to_json()
    names = [f"layers/{i}/{w}" for i in (0, 1) for w in ("wq", "wo", "w_down")] + ["lm_head"]
    jc, tc = {}, {}
    for n in names:
        assert tt.resolve(n, counts=tc).to_dict() == jt.resolve(n, counts=jc).to_dict()
    assert tc == jc and 3 not in tc  # the dotted rule matched nothing
    back = tconfig.ConfigTree.from_json(jt.to_json())
    assert back.to_json() == jt.to_json()
    for mode in ("int8", "int4", "nf4", "nf4a", "fp4", "nf8", "fp8", "int8a", "int4a",
                 "llm_int8", "int4c"):
        assert (tconfig.QuantConfig.from_mode(mode).to_dict()
                == jconfig.QuantConfig.from_mode(mode).to_dict())
    for bad in (dict(bits=3), dict(scheme="x"), dict(pack=True), dict(percentile=(5, 1))):
        with pytest.raises(ValueError):
            tconfig.QuantConfig(**bad)
    with pytest.raises(ValueError, match="unknown QuantConfig fields"):
        tconfig.ConfigTree().config_layer("wq", nbits=4)


# ------------------------------------------------------------------ calib


def test_collect_stats_matches_jax(stats):
    js, ts = stats
    assert sorted(ts) == sorted(js) and len(ts) == 2 * 7 + 1
    for name, j in js.items():
        t = ts[name]
        np.testing.assert_allclose([t.amin, t.amax], [j.amin, j.amax], rtol=1e-5)
        np.testing.assert_allclose(t.colmax, j.colmax, rtol=1e-5,
                                   atol=1e-5 * np.abs(j.colmax).max())
        assert t.hist.dtype == np.int64 and t.hist.sum() == j.hist.sum() > 0
        moved = np.abs(t.hist - j.hist).sum() // 2
        assert moved <= 1e-3 * j.hist.sum(), (name, moved)
        assert np.count_nonzero(np.cumsum(t.hist - j.hist)) <= 2 * moved, name


def test_reduce_range_bit_equal_on_jax_stats(stats):
    js, ts = stats
    for name, j in js.items():
        t = _as_port_stats(js)[name]
        # the entropy sweep costs ~1 s a call: two inputs of different shapes
        for method in METHODS if name in ("layers/0/wq", "layers/1/w_down") else METHODS[:2]:
            assert tcalib.reduce_range(t, method) == jcalib.reduce_range(j, method)
            # from the port's own statistics: within one histogram bin
            width = (j.amax - j.amin) / tcalib._NBINS
            np.testing.assert_allclose(tcalib.reduce_range(ts[name], method),
                                       jcalib.reduce_range(j, method), rtol=0, atol=width)
    w = np.random.default_rng(3).standard_normal((64, 96)).astype(np.float32)
    for method in METHODS:
        assert (tcalib.weight_clip_range(torch.from_numpy(w), method)
                == jcalib.weight_clip_range(jnp.asarray(w), method))


def test_fake_quant_bit_exact():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((16, 64)) * 3).astype(np.float32)
    for lo, hi, bits in ((-2.5, 3.1, 8), (0.4, 2.0, 8), (-1.0, -0.2, 4)):
        ref = np.asarray(jcalib.fake_quant(jnp.asarray(x), jnp.float32(lo), jnp.float32(hi),
                                           bits))
        out = tcalib.fake_quant(torch.from_numpy(x), torch.tensor(lo), torch.tensor(hi), bits)
        np.testing.assert_array_equal(out.numpy(), ref)


# -------------------------------------------------------------------- ptq


def test_quantize_model_matches_jax(jparams, stats, batches):
    js, _ = stats
    with pytest.warns(UserWarning, match="matched zero"):
        jq = jptq.quantize_model(jparams, _rule_tree(jconfig), stats=js)
    tp = interop.from_jax_params(jparams)
    with pytest.warns(UserWarning, match="matched zero"):
        tq = tptq.quantize_model(tp, _rule_tree(tconfig), stats=_as_port_stats(js))
    kinds = {}
    for name in ("wq", "wo", "w_down"):
        for i in (0, 1):
            j, t = jq["layers"][i][name], tq["layers"][i][name]
            if name == "w_down":
                assert type(t).__name__ == type(j).__name__ == "ActQuantWeight"
                assert (t.lo.item(), t.hi.item(), t.bits) == (float(j.lo), float(j.hi), j.bits)
                j, t = j.w, t.w
            kinds[(i, name)] = (t.scheme, t.codebook, t.codes.dtype, t.block_size)
            np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
            if j.zero_point is not None:
                np.testing.assert_array_equal(t.zero_point.numpy(), np.asarray(j.zero_point))
    assert kinds[(0, "wq")] == ("codebook", "nf8", torch.uint8, 64)
    assert kinds[(1, "wo")] == ("symmetric", None, torch.int8, 128)
    assert kinds[(1, "w_down")] == ("affine", None, torch.uint8, 64)
    assert tq["lm_head"].codebook == "fp8" and isinstance(tq["tok_emb"], torch.Tensor)
    # the JAX tree runs in the port (interop converts ActQuantWeight)
    toks = batches[0]
    ref = np.asarray(jllama.forward(jq, jnp.asarray(toks), JCFG, use_kernel=False)[0])
    out = tllama.forward(interop.from_jax_params(jq), torch.from_numpy(toks), TCFG)[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the port's own calibration: activation ranges within one histogram bin
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tq2 = tptq.quantize_model(tp, _rule_tree(tconfig),
                                  forward=lambda p, b: tllama.forward(p, b, TCFG)[0],
                                  calib_batches=[torch.from_numpy(b) for b in batches])
    for i in (0, 1):
        j, t = jq["layers"][i]["w_down"], tq2["layers"][i]["w_down"]
        width = (js[f"layers/{i}/w_down"].amax - js[f"layers/{i}/w_down"].amin) / 2048
        np.testing.assert_allclose([t.lo.item(), t.hi.item()], [float(j.lo), float(j.hi)],
                                   rtol=0, atol=width)
    with pytest.raises(ValueError, match="matched zero"):
        tptq.quantize_model(tp, tconfig.ConfigTree().config_layer(r"layers\.0\.", bits=4),
                            strict_rules=True)
    with pytest.raises(ValueError, match="needs activation stats"):
        tptq.quantize_model(tp, tconfig.ConfigTree(tconfig.QuantConfig(weights_only=False)))


# ------------------------------------------------------------------- eval


def test_perplexity_and_ppl_table_match_jax(jparams):
    tokens = np.random.default_rng(6).integers(0, JCFG.vocab_size, 700, dtype=np.int32)
    jvariants = {"bf16": jparams, "int8": jnn.quantize_params(jparams, mode="int8",
                                                               min_size=1024)}
    tvariants = {k: interop.from_jax_params(v) for k, v in jvariants.items()}
    jt = jeval.ppl_table(jvariants, tokens, JCFG, seq_len=64, batch=4)
    tt = teval.ppl_table(tvariants, tokens, TCFG, seq_len=64, batch=4)
    for name in jt:
        np.testing.assert_allclose(tt[name]["ppl"], jt[name]["ppl"], rtol=1e-5)
    np.testing.assert_allclose(tt["int8"]["delta"], jt["int8"]["delta"],
                               atol=1e-5 * jt["int8"]["ppl"])
    assert teval.perplexity(tvariants["bf16"], tokens, TCFG, seq_len=64, batch=3) == \
        pytest.approx(tt["bf16"]["ppl"], rel=1e-5)  # batching does not matter
    w, m = teval._window(tokens[:10], 4)
    jw, jm = jeval._window(tokens[:10], 4)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(m, jm)
    assert teval.ByteTokenizer().decode(teval.ByteTokenizer().encode("héllo")) == "héllo"


# ------------------------------------------------------------ checkpoints


def _jax_tree():
    rng = np.random.default_rng(7)
    w = jnp.asarray(rng.standard_normal((256, 128)).astype(np.float32))
    lora = jnn.init_lora(jcore.quantize_matmul_weight(w, fmt="nf4"), jax.random.PRNGKey(1),
                         rank=4, in_features=256, out_features=128)
    lora = lora.__class__(base=lora.base, lora_a=lora.lora_a,
                          lora_b=lora.lora_a.T.astype(jnp.bfloat16), alpha=lora.alpha)
    return {
        "emb": w.astype(jnp.bfloat16),
        "int8a": jcore.quantize_matmul_weight(w, fmt="int8a"),
        "llm": jint8.quantize_int8_weight(w),
        "i4c": jint4c.quantize_int4c_weight(w),
        "lora": lora,
        "aq": jcalib.ActQuantWeight(w=jcore.quantize_matmul_weight(w, fmt="int8"),
                                    lo=jnp.float32(-1.5), hi=jnp.float32(2.25), bits=8),
        "seq": [w[:2], (w[:1, :3], jnp.arange(4, dtype=jnp.int32))],
        "empty": {}, "none": [],
    }


def _arrays(tree, prefix=""):
    """{path: numpy array} of every array a tree holds (weight fields too)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _arrays(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _arrays(sub, f"{prefix}/{i}").items()}
    if hasattr(tree, "__dataclass_fields__"):
        return {k: v for f in tree.__dataclass_fields__
                for k, v in _arrays(getattr(tree, f), f"{prefix}.{f}").items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return {prefix: (t.float() if t.dtype == torch.bfloat16 else t).numpy()}
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return {prefix: np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16
                                   else tree)}
    return {}


def test_checkpoints_cross_load(tmp_path):
    jtree = _jax_tree()
    jser.save_checkpoint(jtree, str(tmp_path / "j.npz"))
    ttree = tser.load_checkpoint(str(tmp_path / "j.npz"))
    assert isinstance(ttree["int8a"], QuantizedTensor) and isinstance(ttree["llm"], Int8Weight)
    assert isinstance(ttree["i4c"], Int4cWeight) and isinstance(ttree["lora"], LoRAWeight)
    assert isinstance(ttree["aq"], tcalib.ActQuantWeight) and ttree["aq"].bits == 8
    assert ttree["emb"].dtype == torch.bfloat16 and ttree["lora"].lora_b.dtype == torch.bfloat16
    assert ttree["lora"].lora_a.requires_grad and ttree["int8a"].dtype == torch.float32
    assert isinstance(ttree["seq"][1], tuple) and ttree["empty"] == {} and ttree["none"] == []
    ja = _arrays(jtree)
    ta = _arrays(ttree)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # the port's save -> the JAX package's load
    tser.save_checkpoint(ttree, str(tmp_path / "t.npz"))
    back = jser.load_checkpoint(str(tmp_path / "t.npz"))
    assert type(back["aq"]).__name__ == "ActQuantWeight" and back["emb"].dtype == jnp.bfloat16
    assert back["int8a"].dtype == jnp.float32 and isinstance(back["seq"][1], tuple)
    ba = _arrays(back)
    assert sorted(ba) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(ba[k], ja[k], err_msg=k)
    with pytest.raises(TypeError, match="unsupported type"):
        tser.save_checkpoint({"x": object()}, str(tmp_path / "bad.npz"))


# -------------------------------------------------------------------- CLI


def _stdout_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_round_trip_and_jax_checkpoint(tmp_path, capsys):
    text = tmp_path / "corpus.txt"
    text.write_text(tcorpus.build_corpus()[:6000])
    cfg_file = tmp_path / "rules.json"
    cfg_file.write_text(_rule_tree(tconfig).to_json())
    common = ["--cpu", "--toy", "tiny", "--dtype", "float32"]
    ck = str(tmp_path / "q")
    tcli.main(["quantize", *common, "--config", str(cfg_file), "--calib-text", str(text),
               "--out", ck])
    tree = tser.load_checkpoint(ck + ".npz")
    assert type(tree["layers"][1]["w_down"]).__name__ == "ActQuantWeight"
    assert tree["layers"][0]["wq"].codebook == "nf8"
    tcli.main(["eval", "--cpu", "--ckpt", ck + ".npz", "--text", str(text)])
    assert np.isfinite(_stdout_json(capsys)["perplexity"])
    tcli.main(["generate", "--cpu", "--ckpt", ck + ".npz", "--prompt", "hello",
               "--max-new-tokens", "4"])
    capsys.readouterr()
    tcli.main(["finetune", *common, "--fmt", "nf8", "--steps", "2", "--text", str(text),
               "--seq-len", "32", "--out", str(tmp_path / "ad")])
    adapters = tser.load_checkpoint(str(tmp_path / "ad.npz"))
    assert len(adapters) == TCFG.n_layers and adapters[0]["wq"]["a"].dtype == torch.bfloat16
    # a checkpoint the JAX CLI wrote: the port's eval gives the JAX CLI's perplexity
    jck = str(tmp_path / "jq")
    jcli.main(["quantize", *common, "--config", str(cfg_file), "--calib-text", str(text),
               "--out", jck])
    capsys.readouterr()
    jcli.main(["eval", "--cpu", "--ckpt", jck + ".npz", "--text", str(text)])
    ref = _stdout_json(capsys)
    tcli.main(["eval", "--cpu", "--ckpt", jck + ".npz", "--text", str(text)])
    out = _stdout_json(capsys)
    assert out["tokens"] == ref["tokens"]
    np.testing.assert_allclose(out["perplexity"], ref["perplexity"], rtol=1e-4)
    # convert, on a .qtn the JAX package wrote: the JAX CLI's file, byte for byte
    src = str(tmp_path / "w.qtn")
    w = np.random.default_rng(3).standard_normal((256, 128)).astype(np.float32)
    jser.save_qtn(jcore.quantize_matmul_weight(jnp.asarray(w), fmt="nf4"), src)
    for argv in (["--bits", "8", "--fmt", "int8"], ["--bits", "4", "--fmt", "nf4a", "--transcode"]):
        outs = [str(tmp_path / f"{side}.qtn") for side in ("j", "t")]
        for cli, out in zip((jcli, tcli), outs):
            cli.main(["convert", src, *argv, "--out", out, "--cpu"])
        assert open(outs[0], "rb").read() == open(outs[1], "rb").read(), argv
    # quantize --model, on HF directories (Llama, GPT-2): the JAX CLI's checkpoint
    from quanta_tpu_torch.models import gpt2 as tgpt2
    from quanta_tpu_torch.models import hf as thf

    gen = torch.Generator().manual_seed(4)
    gcfg = tgpt2.GPT2Config.tiny()
    for name, save, params, cfg in (
            ("llama", thf.save_llama, tllama.init_params(gen, TCFG), TCFG),
            ("gpt2", thf.save_gpt2, tgpt2.init_params(gen, gcfg), gcfg)):
        model = str(tmp_path / f"hf_{name}")
        save(params, cfg, model)
        cks = [str(tmp_path / f"{side}_{name}.npz") for side in ("j", "t")]
        for cli, out in zip((jcli, tcli), cks):
            cli.main(["quantize", "--cpu", "--model", model, "--fmt", "nf4a", "--out", out])
        got, want = _arrays(tser.load_checkpoint(cks[1])), _arrays(jser.load_checkpoint(cks[0]))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
        configs = [json.load(open(ck + ".config.json")) for ck in cks]
        assert configs[0] == configs[1] and configs[1]["__arch__"] == name
    with pytest.raises(SystemExit, match="kernel_bench measures a CUDA device"):
        tcli.main(["bench", "kernels"])
