"""Port parity for the spec-sharded executor: ``parallel.spmd`` over
``shard_params`` trees, in real ranks, against quanta_tpu.parallel's
GSPMD runs.

One job of 8 ranks (processes joined over gloo on the CPU,
``parallel.spawn_local``) holds JAX's own meshes side by side: the flat
2 x 4 ('data', 'model') mesh of tests/test_parallel.py and the simulated
2 hosts x (data 2 x model 2) host mesh. The rank bodies
(tests/torch_spmd_worker.py) import torch only; the JAX side runs here,
on the same numpy inputs, on its 8 virtual CPU devices. The cases mirror
tests/test_parallel.py: dense and nf4 forward, cached decode, FSDP
forward, FSDP QLoRA, the host mesh, DCN QLoRA, llm_int8 and int4c.
Logits are held at rtol = atol = 2e-4, step-1 losses at rtol 1e-4, the
host mesh's loss against the flat mesh's at rtol 1e-5 (JAX's own), and
the activation-quantizing formats by JAX's ``_assert_quant_close`` rule.
The config is tests/test_parallel.py's CFG (dim 256, 2 layers, 8/4
heads, hidden 512, vocab 512, f32).
"""

import pathlib
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

from quanta_tpu import nn as jnn
from quanta_tpu import optim as joptim
from quanta_tpu import train as jtrain
from quanta_tpu.models import llama as jllama
from quanta_tpu.parallel import distributed as jdist
from quanta_tpu.parallel import sharding as jsharding
from quanta_tpu_torch import interop
from quanta_tpu_torch.parallel import spawn_local

import torch_spmd_worker

CFG = jllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
                         hidden_dim=512, max_seq_len=64, dtype=jnp.float32)
TCFG = dict(vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=512,
            max_seq_len=64)
TOL = dict(rtol=2e-4, atol=2e-4)
SPAWN_TIMEOUT = 120.0  # seconds a spawned run of ranks may take


def _assert_quant_close(out, ref):
    """JAX's rule (tests/test_parallel.py) for activation-quantizing
    formats: a reordered f32 sum can flip one int8 activation code, so
    bound the step size and the fraction of logits that move."""
    d = np.abs(np.asarray(out) - np.asarray(ref))
    scale = float(np.abs(np.asarray(ref)).max())
    assert d.max() < 0.05 * max(scale, 1.0), d.max()
    frac = float((d > 1e-3 * max(scale, 1.0)).mean())
    assert frac < 0.05, f"{frac:.3%} of logits moved"


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trees and JAX's sharded runs on its meshes."""
    params = jllama.init_params(jax.random.PRNGKey(0), CFG)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, CFG.vocab_size),
                      np.int32)
    trees = {"dense": params}
    for fmt in ("nf4", "llm_int8", "int4c"):
        trees[fmt] = jnn.quantize_params(params, mode=fmt, block_size=64, min_size=1024)
    # adapters with a nonzero B, so that A's gradient is nonzero too
    trees["lora"] = _with_b(jtrain.add_lora(trees["nf4"], jax.random.PRNGKey(2), rank=4,
                                            dtype=jnp.float32), jax.random.PRNGKey(3))
    trees["lora_h"] = _with_b(jtrain.add_lora(trees["nf4"], jax.random.PRNGKey(1), rank=4,
                                              dtype=jnp.float32), jax.random.PRNGKey(4))
    mesh = jsharding.make_mesh(data=2, model=4)
    hmesh = jdist.make_host_mesh(data=2, model=2, dcn=2)
    toks_s = jax.device_put(toks, NamedSharding(mesh, JP("data", None)))
    fwd = jax.jit(lambda p, t: jllama.forward(p, t, CFG))
    want = {}
    for name in ("dense", "nf4", "llm_int8", "int4c"):
        want[name] = np.asarray(fwd(jsharding.shard_params(trees[name], mesh, cfg=CFG), toks_s)[0])
    fsdp = jsharding.shard_params(trees["nf4"], mesh,
                                  specs=jsharding.fsdp_param_specs(CFG, trees["nf4"]))
    want["fsdp"] = np.asarray(fwd(fsdp, toks_s)[0])

    dense = jsharding.shard_params(params, mesh, cfg=CFG)
    cache = jllama.init_cache(CFG, 4, max_len=32)
    cache = {k: jax.device_put(v, NamedSharding(mesh, jsharding.cache_specs(CFG)[k]))
             for k, v in cache.items()}
    cfwd = jax.jit(lambda p, t, c: jllama.forward(p, t, CFG, cache=c))
    lg, cache = cfwd(dense, toks[:, :8], cache)
    lg1, _ = cfwd(dense, toks[:, 8:9], cache)
    want["cached"] = [np.asarray(lg), np.asarray(lg1)]
    want["greedy"] = np.asarray(jllama.greedy_decode(params, toks[:, :8], CFG, max_new_tokens=6))

    hosted = jdist.shard_params_host(trees["nf4"], hmesh, cfg=CFG)
    htoks = jax.device_put(toks, NamedSharding(hmesh, jdist.host_batch_spec()))
    want["host"] = np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, CFG, use_kernel=False))(
        hosted, htoks)[0])
    hcache = jllama.init_cache(CFG, 4, max_len=32)
    hcache = {k: jax.device_put(v, NamedSharding(hmesh, jdist.host_cache_specs(CFG)[k]))
              for k, v in hcache.items()}
    lg, hcache = cfwd(hosted, htoks, hcache)
    lg1, _ = cfwd(hosted, htoks[:, :1], hcache)
    want["host_cached"] = [np.asarray(lg), np.asarray(lg1)]
    want["host_greedy"] = np.asarray(jllama.greedy_decode(trees["nf4"], toks[:, :8], CFG,
                                                          max_new_tokens=4))

    # tests/test_parallel.py::test_fsdp_qlora_train_step, on the same
    # adapters, with next-token targets of random tokens
    sharded = jsharding.shard_params(trees["lora"], mesh,
                                     specs=jsharding.fsdp_param_specs(CFG, trees["lora"]))
    adapters = jtrain.extract_adapters(sharded)
    tx = joptim.adam8bit(1e-3)
    rolled = {"inputs": jnp.asarray(toks), "targets": jnp.roll(jnp.asarray(toks), -1, axis=1)}
    batch = {k: jax.device_put(v, toks_s.sharding) for k, v in rolled.items()}
    step = jax.jit(jtrain.make_qlora_train_step(CFG, tx))
    a1, o1, loss1 = step(adapters, tx.init(adapters), sharded, batch)
    _, _, loss2 = step(a1, o1, sharded, batch)
    want["fsdp_qlora"] = [float(loss1), float(loss2)]
    want["fsdp_qlora_grads"] = _np(jax.jit(jax.grad(_adapter_loss))(
        jtrain.extract_adapters(trees["lora"]), trees["lora"], batch))
    want["fsdp_qlora_adapters"] = _np(a1)
    # the DCN case, unsharded: the step-1 loss, gradients and adapters
    adapters = jtrain.extract_adapters(trees["lora_h"])
    (loss, grads), a1 = jax.jit(jax.value_and_grad(_adapter_loss))(
        adapters, trees["lora_h"], rolled), step(adapters, tx.init(adapters), trees["lora_h"],
                                                 rolled)[0]
    want["dcn_loss"], want["dcn_grads"], want["dcn_adapters"] = float(loss), _np(grads), _np(a1)
    # every array of the dense tree trainable: its gradients
    want["dense_loss"], want["dense_grads"] = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.causal_lm_loss(jllama.forward(p, b["inputs"], CFG)[0],
                                           b["targets"])))(params, rolled)
    want["dense_grads"] = _np(want["dense_grads"])
    return toks, trees, want


def _with_b(tree, key):
    """``tree`` with every adapter's B drawn from N(0, 0.05^2)."""
    ads = jtrain.extract_adapters(tree)
    keys = iter(jax.random.split(key, sum(len(ad) for ad in ads)))
    return jtrain.merge_adapters(tree, [
        {n: {"a": ab["a"], "b": 0.05 * jax.random.normal(next(keys), ab["b"].shape, ab["b"].dtype)}
         for n, ab in ad.items()} for ad in ads])


def _adapter_loss(adapters, params, batch):
    """jtrain.make_qlora_train_step's loss of the adapters."""
    logits, _ = jllama.forward(jtrain.merge_adapters(params, adapters), batch["inputs"], CFG)
    return jtrain.causal_lm_loss(logits, batch["targets"])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """One job of 8 ranks running every case (torch_spmd_worker.run)."""
    toks, trees, want = jax_side
    case = dict(cfg=TCFG, tokens=toks, flat=(2, 4), host=(2, 2, 2),
                trees={k: torch_spmd_worker.to_numpy(interop.from_jax_params(v))
                       for k, v in trees.items()})
    path = tmp_path_factory.mktemp("spmd") / "case.pkl"
    with open(path, "wb") as f:
        pickle.dump(case, f)
    return spawn_local(torch_spmd_worker.run, 8, str(path), timeout=SPAWN_TIMEOUT), want


def _same_on_every_rank(res, key):
    """Rank 0's result for ``key``, checked equal on every rank (an array
    or a list of them)."""
    first = res[0][key]
    for r in res[1:]:
        got = r[key] if isinstance(first, list) else [r[key]]
        for a, b in zip(got, first if isinstance(first, list) else [first], strict=True):
            np.testing.assert_array_equal(a, b)
    return first


@pytest.mark.parametrize("name", ["dense", "nf4"])
def test_sharded_forward_matches_jax(ranks, name):
    """Megatron specs on the 2 x 4 mesh: column-split linears on the
    rank's columns, row-split ones gathered, the batch over 'data'."""
    res, want = ranks
    np.testing.assert_allclose(_same_on_every_rank(res, name), want[name], **TOL)


def test_fsdp_forward_matches_jax(ranks):
    res, want = ranks
    np.testing.assert_allclose(_same_on_every_rank(res, "fsdp"), want["fsdp"], **TOL)


def test_sharded_cache_decode_matches_jax(ranks):
    """The cache split as cache_specs splits it (rows on 'data', KV heads
    on 'model'): a prefill of 8 and one decode step."""
    res, want = ranks
    got = _same_on_every_rank(res, "cached")
    for g, w in zip(got, want["cached"]):
        np.testing.assert_allclose(g, w, **TOL)


def test_sharded_greedy_decode_matches_jax(ranks):
    res, want = ranks
    for r in res:
        np.testing.assert_array_equal(r["greedy"], want["greedy"])


def test_host_mesh_forward_matches_jax(ranks):
    """The simulated 2 hosts x (data 2 x model 2): weights replicated over
    'dcn', the batch over ('dcn', 'data')."""
    res, want = ranks
    np.testing.assert_allclose(_same_on_every_rank(res, "host"), want["host"], **TOL)


def test_host_mesh_cache_decode_matches_jax(ranks):
    res, want = ranks
    got = _same_on_every_rank(res, "host_cached")
    for g, w in zip(got, want["host_cached"]):
        np.testing.assert_allclose(g, w, **TOL)
    for r in res:
        np.testing.assert_array_equal(r["host_greedy"], want["host_greedy"])


@pytest.mark.parametrize("specs", ["fsdp_qlora", "qlora"])
def test_qlora_step_matches_jax(ranks, specs):
    """QLoRA over the FSDP specs and over the Megatron specs: the step-1
    loss is JAX's FSDP step's (the same function of the same adapters and
    batch), within rtol 1e-4 on every rank, and it falls at step 2."""
    res, want = ranks
    for r in res:
        l1, l2 = r[specs]["losses"]
        np.testing.assert_allclose(l1, want["fsdp_qlora"][0], rtol=1e-4)
        assert l2 < l1, (l1, l2)


def _assert_trees_close(got, want, path=""):
    """Two trees of arrays (dicts and lists) leaf by leaf: within rtol
    1e-4, and an absolute 1e-4 of the leaf's largest value (an entry near
    zero holds a sum of terms that cancel)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=path)


@pytest.mark.parametrize("case,ref", [("fsdp_qlora", "fsdp_qlora"), ("qlora", "fsdp_qlora"),
                                      ("dcn_qlora", "dcn"), ("flat_qlora", "dcn")])
def test_qlora_grads_and_update_match_jax(ranks, case, ref):
    """Step 1 over the FSDP and Megatron specs on 2 x 4, the host mesh
    (2 x 2 x 2, the sum over ('dcn', 'data')) and the flat mesh: every
    adapter's gradient, gathered from the ranks' slices, is jax.grad's of
    the same loss, and the adapters after the step are JAX's step's."""
    res, want = ranks
    for r in res:
        _assert_trees_close(r[case]["grads"], want[f"{ref}_grads"])
        _assert_trees_close(r[case]["adapters"], want[f"{ref}_adapters"])


@pytest.mark.parametrize("case", ["dense_fsdp", "dense_megatron"])
def test_dense_weights_train_over_the_mesh(ranks, case):
    """A tree whose every array is trainable (train.make_train_step with a
    mesh), under the FSDP and the Megatron specs: the loss and every
    array's gradient, gathered, are jax.grad's. A weight gathered at use
    passes its gradient back to the rank's slice."""
    res, want = ranks
    for r in res:
        np.testing.assert_allclose(r[case]["loss"], float(want["dense_loss"]), rtol=1e-5)
        _assert_trees_close(r[case]["grads"], want["dense_grads"])


def test_zero3_rank_holds_one_gathered_leaf(ranks):
    """Through a whole FSDP QLoRA step (forward and backward), a rank's
    gathered weights alive at once never exceed the largest one leaf
    (under one layer's), while it gathers every layer: each weight is
    gathered at use and dropped after its linear."""
    res, _ = ranks
    for r in res:
        q = r["fsdp_qlora"]
        assert q["gathered_peak"] <= q["largest_leaf"] < min(q["layer_bytes"]) * 2
        assert q["gathered_peak"] < min(q["layer_bytes"])
        assert q["gathered_total"] >= sum(q["layer_bytes"])


def test_host_mesh_qlora_dcn_grad_sum(ranks, jax_side):
    """One QLoRA step over the host mesh (the gradient sum spans ('dcn',
    'data')) gives the flat mesh's loss within rtol 1e-5, and JAX's."""
    res, want = ranks
    for r in res:
        (lh,), (lf,) = r["dcn_qlora"]["losses"], r["flat_qlora"]["losses"]
        np.testing.assert_allclose(lh, lf, rtol=1e-5)
        np.testing.assert_allclose(lh, want["dcn_loss"], rtol=1e-4)


@pytest.mark.parametrize("name", ["llm_int8", "int4c"])
def test_activation_quantizing_formats_sharded(ranks, name):
    """Int8Weight and Int4cWeight leaves on the N-only splits of their
    specs: JAX's _assert_quant_close against JAX's GSPMD run."""
    res, want = ranks
    _assert_quant_close(_same_on_every_rank(res, name), want[name])


def test_autograd_collectives_two_ranks():
    """The gather Function's forward and backward, and a linear gathered
    at use, on two ranks (tests/test_torch_cuda.py runs the same on the
    card)."""
    torch_spmd_worker.check_gather_grads(spawn_local(torch_spmd_worker.gather_grads, 2, "cpu",
                                                     timeout=SPAWN_TIMEOUT))


BENCH_CFG = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512,
                 max_seq_len=64)


@pytest.fixture(scope="module")
def bench_legs():
    """chip_smoke's phase 29 (benchmarks.spmd_bench) at a tiny size on the
    CPU, the kernel wrappers into the fake kernels: the FSDP leg on 2
    ranks, the host-mesh leg on 4 (its llm_int8 forward left out: the
    fakes have no int8 kernel)."""
    from quanta_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**BENCH_CFG)
    fsdp = spawn_local(torch_spmd_worker.bench_leg, 2, "fsdp",
                       dict(cfg=cfg, batch=2, seq=16, steps=3), timeout=SPAWN_TIMEOUT)
    host = spawn_local(torch_spmd_worker.bench_leg, 4, "host",
                       dict(cfg=cfg, batch=4, prompt_len=16, new=3, int8_layers=0),
                       timeout=SPAWN_TIMEOUT)
    return fsdp, host


def test_spmd_bench_fsdp_leg(bench_legs):
    """Both ranks pass the leg's checks (raised inside otherwise); the
    launches per step are as designed and the single card is held."""
    fsdp, _ = bench_legs
    per_fwd = 7 * BENCH_CFG["n_layers"] + 1
    for row in fsdp:
        assert row["launches_per_step"] == [{"matmul_4bit": per_fwd, "matmul_4bit_t": per_fwd - 3,
                                             "adam8bit_update": 1}] * 3
        assert row["losses"][2] < row["losses"][0]
    assert fsdp[0]["step1_loss_rel"] <= 1e-2
    rel = fsdp[0]["lora_b_grad_rel_l2"]
    # a rank's arithmetic is the single card's taken a row at a time
    assert max(rel["vs_per_rank"]) <= 2e-3
    assert all(r <= t for r, t in zip(rel["vs_plain"], fsdp[0]["lora_b_grad_tols"]))


def test_spmd_bench_host_leg(bench_legs):
    _, host = bench_legs
    for row in host:
        assert row["prefill_logits_rel_l2"] <= row["tol"]
        assert row["qlora_losses"]["host"] == pytest.approx(row["qlora_losses"]["flat"], rel=1e-5)
    assert [r["coords"]["dcn"] for r in host] == [0, 0, 1, 1]
    # rank 0's gradients: A and B of wq and wv, both meshes
    rel, tols = host[0]["qlora_grad_rel_l2"], host[0]["qlora_grad_tols"]
    assert len(tols) == 4 * BENCH_CFG["n_layers"] and rel["host_vs_flat"] == [0.0] * len(tols)
    for mesh in ("host", "flat"):
        assert all(r <= t for r, t in zip(rel[mesh]["vs_plain"], tols))


def test_sharded_step_on_one_rank_is_the_plain_step():
    """On a 1 x 1 mesh the sharded QLoRA step is the single-process step:
    the same losses, masked and not, over two steps (no collective runs)."""
    import torch

    from quanta_tpu_torch import nn as tnn
    from quanta_tpu_torch import train as ttrain
    from quanta_tpu_torch.models import llama as tllama
    from quanta_tpu_torch.optim import Adam8bit
    from quanta_tpu_torch.parallel import make_mesh, shard_params

    cfg = tllama.LlamaConfig(**TCFG, dtype=torch.float32)
    base = tnn.quantize_params(tllama.init_params(torch.Generator().manual_seed(0), cfg),
                               mode="nf4", min_size=1024)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 17)))
    mask = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (2, 16)))
    mesh = make_mesh(1, 1)
    for batch in ({"inputs": toks[:, :-1], "targets": toks[:, 1:]},
                  {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}):
        losses = []
        for sharded in (False, True):
            params = ttrain.add_lora(base, torch.Generator().manual_seed(2), rank=4,
                                     dtype=torch.float32)
            if sharded:
                params = shard_params(params, mesh, cfg=cfg)
            opt = Adam8bit(tnn.lora_parameters(params), lr=1e-2)
            step = ttrain.make_qlora_train_step(cfg, opt, mesh=mesh if sharded else None)
            losses.append([step(params, batch).item() for _ in range(2)])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
        assert losses[0][1] < losses[0][0]


def test_spmd_worker_never_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+quanta_tpu\b|"
                     r"from\s+quanta_tpu(\.|\s))", re.M)
    here = pathlib.Path(__file__).resolve().parent
    assert not pat.search((here / "torch_spmd_worker.py").read_text())
