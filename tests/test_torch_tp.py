"""Port parity for manual tensor parallelism: quanta_tpu_torch.parallel
against quanta_tpu.parallel.tp.

Shards (``quantize_tp``, ``from_global``) are held byte for byte against
JAX's, the dequantized oracle bit for bit. The TP forward, cached forward
and greedy decode run in real ranks: processes joined over gloo on the
CPU (``parallel.spawn_local``), whose bodies (tests/torch_tp_worker.py)
import torch only; the JAX side runs here, in the pytest process, on the
same numpy inputs: ``llama.forward(..., use_kernel=False)`` over the
``dequantize_tp`` oracle at JAX's own tolerance (rtol = atol = 2e-4), and
``greedy_decode`` token for token. JAX's ``shard_map`` tests are not run.
The config is JAX's tests/test_tp.py CFG (dim 256, 2 layers, 8/4 heads,
hidden 512, vocab 512, f32).
"""

import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu.core import codecs as jcodecs
from quanta_tpu.models import llama as jllama
from quanta_tpu.parallel import sharding as jsharding
from quanta_tpu.parallel import tp as jtp
from quanta_tpu.utils import serialization as jser
from quanta_tpu_torch import interop
from quanta_tpu_torch.core import codecs as tcodecs
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.nn import linear
from quanta_tpu_torch.parallel import (check_divisibility, from_global, initialize, make_mesh,
                                       spawn_local, tp)
from quanta_tpu_torch.utils import serialization as tser

import torch_tp_worker

CFG = jllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
                         hidden_dim=512, max_seq_len=64, dtype=jnp.float32)
TCFG = dict(vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=512,
            max_seq_len=64)
FORMATS = ("nf4", "nf4a", "int8")
NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
TOL = dict(rtol=2e-4, atol=2e-4)  # JAX's own, tests/test_tp.py
SPAWN_TIMEOUT = 120.0  # seconds a spawned run of ranks may take


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_shards_equal(t_sq, j_sq, msg=""):
    assert (t_sq.tp, t_sq.fmt, t_sq.bits, t_sq.block_size, t_sq.axis, tuple(t_sq.shape)) == (
        j_sq.tp, j_sq.fmt, j_sq.bits, j_sq.block_size, j_sq.axis, tuple(j_sq.shape)), msg
    np.testing.assert_array_equal(t_sq.codes.numpy(), np.asarray(j_sq.codes), err_msg=msg)
    np.testing.assert_array_equal(t_sq.scale.numpy(), np.asarray(j_sq.scale), err_msg=msg)


def _oracle(j_tp, params):
    """JAX's dense single-device tree over the shards' dequantized values."""
    oracle = {"tok_emb": params["tok_emb"], "norm_f": params["norm_f"],
              "lm_head": jtp.dequantize_tp(j_tp["lm_head"]).astype(jnp.float32), "layers": []}
    for lp in j_tp["layers"]:
        ol = {"attn_norm": lp["attn_norm"], "ffn_norm": lp["ffn_norm"]}
        for name in NAMES:
            ol[name] = jtp.dequantize_tp(lp[name]).astype(jnp.float32)
        oracle["layers"].append(ol)
    return oracle


def _numpy_tree(tree):
    """The port's tp tree as numpy, for the worker ranks."""
    if isinstance(tree, tp.ShardedQuant):
        return {"codes": tree.codes.numpy(), "scale": tree.scale.numpy(), "tp": tree.tp,
                "fmt": tree.fmt, "bits": tree.bits, "block_size": tree.block_size,
                "axis": tree.axis, "shape": tuple(tree.shape),
                "dtype": str(tree.dtype).replace("torch.", "")}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


# ------------------------------------------------------------------ shards


@pytest.mark.parametrize("tp_width", [2, 4])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_tp_matches_jax(fmt, tp_width):
    w = _w((512, 256), 2)
    for axis in (0, 1):
        got = tp.quantize_tp(torch.from_numpy(w), tp_width, axis=axis, fmt=fmt)
        want = jtp.quantize_tp(jnp.asarray(w), tp_width, axis=axis, fmt=fmt)
        _assert_shards_equal(got, want, f"axis={axis}")


def test_quantize_tp_round_trip():
    """JAX's round-trip test: per-shard quantization error within 5% of
    the global quantization's."""
    w = torch.from_numpy(_w((512, 256), 2))
    qt = tcodecs.quantize_matmul_weight(w, fmt="nf4", block_size=64)
    err_g = (tcodecs.dequantize_matmul_weight(qt) - w).abs().mean().item()
    for axis in (0, 1):
        sq = tp.quantize_tp(w, 4, axis=axis, fmt="nf4")
        assert sq.codes.shape[0] == 4
        deq = tp.dequantize_tp(sq)
        assert deq.shape == w.shape
        assert (deq - w).abs().mean().item() <= err_g * 1.05


@pytest.mark.parametrize("tp_width", [2, 4])
@pytest.mark.parametrize("fmt", FORMATS)
def test_from_global_matches_jax(fmt, tp_width):
    """Resharding a global checkpoint re-pairs codes without requantizing:
    the shards are JAX's byte for byte, the dequantized weight the global
    one's bit for bit."""
    w = _w((512, 256), 3)
    jqt = jcodecs.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=64)
    tqt = tcodecs.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=64)
    want = tcodecs.dequantize_matmul_weight(tqt).numpy()
    for axis in (0, 1):
        got = from_global(tqt, tp_width, axis=axis)
        _assert_shards_equal(got, jtp.from_global(jqt, tp_width, axis=axis), f"axis={axis}")
        np.testing.assert_array_equal(tp.dequantize_tp(got).numpy(), want, err_msg=f"{axis}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_tp_matches_jax(fmt):
    w = _w((512, 256), 4)
    for axis in (0, 1):
        got = tp.dequantize_tp(tp.quantize_tp(torch.from_numpy(w), 2, axis=axis, fmt=fmt))
        want = jtp.dequantize_tp(jtp.quantize_tp(jnp.asarray(w), 2, axis=axis, fmt=fmt))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.float32))


def test_checkpoint_reshard_across_tp_widths(tmp_path):
    """One global split_k checkpoint serves every TP width: JAX saves an
    nf4 w_down, the port loads it and reshards it to tp = 2 and 4, shards
    equal to JAX's reshards of its own tensor, values to the global ones."""
    params = jllama.init_params(jax.random.PRNGKey(0), CFG)
    qt = jcodecs.quantize_matmul_weight(params["layers"][0]["w_down"], fmt="nf4")
    path = os.path.join(tmp_path, "w.qtn")
    jser.save_quantized_tensor(qt, path)
    tqt = tser.load_quantized_tensor(path)
    want = np.asarray(jcodecs.dequantize_matmul_weight(qt))
    for width in (2, 4):
        got = from_global(tqt, width, axis=0)
        _assert_shards_equal(got, jtp.from_global(qt, width, axis=0), f"tp={width}")
        np.testing.assert_array_equal(tp.dequantize_tp(got).numpy(), want)


def test_row_parallel_chunk_width_guard():
    """N = 128: two chunks would be 64 wide, under the kernels' 128-column
    tile; the guard narrows to one chunk (JAX's
    test_row_parallel_chunk_width_guard). The ranks' partial products sum
    to JAX's reference ``x @ dequantize_tp(sq)``."""
    w, x = _w((256, 128), 0), _w((4, 256), 1)
    sq = tp.quantize_tp(torch.from_numpy(w), 2, axis=0, fmt="nf4a")
    _assert_shards_equal(sq, jtp.quantize_tp(jnp.asarray(w), 2, axis=0, fmt="nf4a"))
    want = np.asarray(jnp.asarray(x) @ jtp.dequantize_tp(
        jtp.quantize_tp(jnp.asarray(w), 2, axis=0, fmt="nf4a")).astype(jnp.float32))
    total = 0
    for r in range(2):
        chunks = sq.shard(r, n_chunks=2)
        assert len(chunks) == 1 and chunks[0].codes.is_contiguous()
        total = total + linear(torch.from_numpy(x[:, r * 128:(r + 1) * 128]), chunks[0])
    np.testing.assert_allclose(total.numpy(), want, rtol=1e-4, atol=1e-4)
    # at N = 256 the two chunks are 128 wide each, and N = 384 keeps 3 of 3
    assert len(tp.quantize_tp(torch.from_numpy(_w((256, 256), 2)), 2, axis=0).shard(0, 2)) == 2
    assert tp._chunk_count(384, 3) == 3 and tp._chunk_count(384, 2) == 1


def test_check_divisibility_matches_jax():
    for cfg in (CFG, jllama.LlamaConfig(vocab_size=64, dim=96, n_layers=1, n_heads=3,
                                        n_kv_heads=3, hidden_dim=200)):
        tcfg = tllama.LlamaConfig(**{k: getattr(cfg, k) for k in TCFG})
        for width in (2, 4):
            try:
                jsharding.check_divisibility(cfg, width)
                want = None
            except ValueError as e:
                want = str(e)
            if want is None:
                check_divisibility(tcfg, width)
            else:
                with pytest.raises(ValueError, match=re.escape(want)):
                    check_divisibility(tcfg, width)


def test_one_process_needs_no_join(monkeypatch):
    """Without a torchrun environment ``initialize`` joins nothing, and a
    1 x 1 mesh has no collective to run."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() == 1 and initialize(num_processes=1) == 1
    mesh = make_mesh(1, 1)
    t = torch.ones(3)
    assert mesh.all_reduce(t, "model").wait() is t and mesh.all_gather(t, "data", 0) is t
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2)


def test_mesh_collectives_on_four_ranks():
    """A 2 x 2 mesh: each axis's all-reduce sums its two ranks (bf16 and
    f32 in flight together) and its all-gather joins them in rank order."""
    res = spawn_local(torch_tp_worker.mesh_collectives, 4, 2, 2, "cpu", timeout=SPAWN_TIMEOUT)
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for rank, out in enumerate(res):
        d, m = divmod(rank, 2)
        for axis, peers in (("data", [m, 2 + m]), ("model", [2 * d, 2 * d + 1])):
            want = sum(base + 10 * r for r in peers)
            np.testing.assert_array_equal(out[axis]["sum_f32"], want)
            np.testing.assert_array_equal(out[axis]["sum_bf16"], want)
            np.testing.assert_array_equal(out[axis]["gather"],
                                          np.concatenate([base + 10 * r for r in peers], 1))


def test_workers_never_import_jax():
    """The rank bodies import torch only (the port itself: test_torch_core)."""
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+quanta_tpu\b|"
                     r"from\s+quanta_tpu(\.|\s))", re.M)
    here = pathlib.Path(__file__).resolve().parent
    for name in ("torch_tp_worker.py", "torch_fakes.py"):
        assert not pat.search((here / name).read_text()), name


# ------------------------------------------------- the forward in real ranks


@pytest.fixture(scope="module")
def model():
    """The JAX tree, the port's tp trees (tp = 2) held shard for shard
    against JAX's, the oracles' logits, teacher tokens and greedy tokens."""
    params = jllama.init_params(jax.random.PRNGKey(0), CFG)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, CFG.vocab_size),
                      np.int32)
    tparams = interop.from_jax_params(params)
    tcfg = tllama.LlamaConfig(**TCFG, dtype=torch.float32)
    trees, want = {}, {}
    for fmt in ("nf4", "int8"):
        j_tp = jtp.tp_llama_params(params, CFG, 2, fmt=fmt, block_size=64)
        t_tp = tp.tp_llama_params(tparams, tcfg, 2, fmt=fmt, block_size=64)
        for name in ("lm_head",):
            _assert_shards_equal(t_tp[name], j_tp[name], name)
        for lj, lt in zip(j_tp["layers"], t_tp["layers"]):
            for name in NAMES:
                _assert_shards_equal(lt[name], lj[name], f"{fmt} {name}")
        trees[fmt] = _numpy_tree(t_tp)
        oracle = _oracle(j_tp, params)
        want[fmt] = {"forward": np.asarray(jllama.forward(oracle, toks, CFG,
                                                          use_kernel=False)[0])}
        if fmt == "nf4":
            cache = jllama.init_cache(CFG, 4, max_len=32)
            lo, cache = jllama.forward(oracle, toks[:, :12], CFG, cache=cache)
            steps, teacher = [np.asarray(lo)], []
            for _ in range(2):
                nxt = jnp.argmax(lo[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
                teacher.append(np.asarray(nxt))
                lo, cache = jllama.forward(oracle, nxt, CFG, cache=cache)
                steps.append(np.asarray(lo))
            want[fmt]["cached"] = steps
            want[fmt]["greedy"] = np.asarray(jllama.greedy_decode(oracle, toks[:, :12], CFG,
                                                                  max_new_tokens=6))
    w, x = _w((256, 256), 5), _w((4, 256), 6)
    row_sq = tp.quantize_tp(torch.from_numpy(w), 2, axis=0, fmt="nf4a")
    want["row"] = np.asarray(jnp.asarray(x) @ jtp.dequantize_tp(
        jtp.quantize_tp(jnp.asarray(w), 2, axis=0, fmt="nf4a")).astype(jnp.float32))
    case = dict(cfg=TCFG, tokens=toks, trees=trees, teacher=teacher)
    return case, want, {"sq": _numpy_tree(row_sq), "x": x}


@pytest.fixture(scope="module")
def two_ranks(model):
    """One run of 2 ranks on a 1 x 2 mesh: every entry point, both
    formats, the fake kernels' launches, a row-parallel linear."""
    case, want, row = model
    case = dict(case, data=1, model=2, cached=("nf4",), greedy=("nf4",),
                fake=("nf4", "int8"), row=row)
    res = spawn_local(torch_tp_worker.run_case, 2, case, timeout=SPAWN_TIMEOUT)
    return res, want


@pytest.fixture(scope="module")
def four_ranks(model):
    """One run of 4 ranks on a 2 x 2 mesh (batch split over 'data')."""
    case, want, _ = model
    case = dict(case, data=2, model=2, trees={"nf4": case["trees"]["nf4"]}, cached=("nf4",),
                greedy=("nf4",))
    res = spawn_local(torch_tp_worker.run_case, 4, case, timeout=SPAWN_TIMEOUT)
    return res, want


@pytest.mark.parametrize("fmt", ["nf4", "int8"])
def test_tp_forward_two_ranks(two_ranks, fmt):
    res, want = two_ranks
    assert torch_tp_worker.all_ranks_agree([r[fmt]["forward"] for r in res])
    np.testing.assert_allclose(res[0][fmt]["forward"], want[fmt]["forward"], **TOL)


def test_tp_forward_cached_two_ranks(two_ranks):
    """Cached prefill and two teacher-forced decode steps (JAX's test
    allows 3e-4 absolute on the steps)."""
    res, want = two_ranks
    got = res[0]["nf4"]["cached"]
    assert len(got) == 3 and torch_tp_worker.all_ranks_agree([r["nf4"]["cached"] for r in res])
    np.testing.assert_allclose(got[0], want["nf4"]["cached"][0], **TOL)
    for g, w in zip(got[1:], want["nf4"]["cached"][1:]):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=3e-4)


def test_tp_greedy_decode_two_ranks(two_ranks):
    res, want = two_ranks
    for r in res:
        np.testing.assert_array_equal(r["nf4"]["greedy"], want["nf4"]["greedy"])


@pytest.mark.parametrize("fmt,kernel", [("nf4", "matmul_4bit"), ("int8", "matmul_8bit")])
def test_tp_kernel_launches_two_ranks(two_ranks, fmt, kernel):
    """Through the fake kernels each rank launches its format's kernel on
    its local shards: 5 column-split linears and 2 row-split ones in 2
    chunks each per layer, and the vocab-split head."""
    res, _ = two_ranks
    for r in res:
        assert r[fmt]["launches"] == {kernel: (5 + 2 * 2) * CFG.n_layers + 1}


def test_tp_row_parallel_two_ranks(two_ranks):
    res, want = two_ranks
    for r in res:
        assert r["row"]["n_chunks"] == 2
        np.testing.assert_allclose(r["row"]["y"], want["row"], rtol=1e-4, atol=1e-4)


def test_tp_forward_four_ranks(four_ranks):
    res, want = four_ranks
    assert torch_tp_worker.all_ranks_agree([r["nf4"]["forward"] for r in res])
    np.testing.assert_allclose(res[0]["nf4"]["forward"], want["nf4"]["forward"], **TOL)


def test_tp_forward_cached_four_ranks(four_ranks):
    res, want = four_ranks
    got = res[3]["nf4"]["cached"]
    np.testing.assert_allclose(got[0], want["nf4"]["cached"][0], **TOL)
    for g, w in zip(got[1:], want["nf4"]["cached"][1:]):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=3e-4)


def test_tp_greedy_decode_four_ranks(four_ranks):
    res, want = four_ranks
    for r in res:
        np.testing.assert_array_equal(r["nf4"]["greedy"], want["nf4"]["greedy"])
