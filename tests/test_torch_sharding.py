"""Port parity for the spec trees and the sharded trees: quanta_tpu_torch.
parallel against quanta_tpu.parallel, in this process, no ranks.

JAX runs on its 8 virtual CPU devices (tests/conftest.py). The port's
``Mesh`` of each rank is built here from the mesh's shape and the rank's
coordinates (slicing needs no process group), and every rank's
``shard_params`` / ``shard_params_host`` arrays are held byte for byte
against the ``addressable_shards`` of the JAX device at those coordinates,
codes and scales alike. Spec trees and expanded specs are compared as
tuples. The config is tests/test_parallel.py's CFG (dim 256, 2 layers,
8/4 heads, hidden 512, vocab 512, f32).
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quanta_tpu.parallel as jparallel
from quanta_tpu import nn as jnn
from quanta_tpu import train as jtrain
from quanta_tpu.models import llama as jllama
from quanta_tpu.parallel import distributed as jdist
from quanta_tpu.parallel import sharding as jsharding
from quanta_tpu_torch import interop
from quanta_tpu_torch import parallel as tparallel
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.parallel import Mesh, Shard

CFG = jllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
                         hidden_dim=512, max_seq_len=64, dtype=jnp.float32)
FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "hidden_dim", "max_seq_len")
FORMATS = ("dense", "nf4", "nf4a", "llm_int8", "int4c", "lora")


def _tcfg(cfg):
    return tllama.LlamaConfig(**{k: getattr(cfg, k) for k in FIELDS}, dtype=torch.float32)


def _assert_specs_equal(t, j, path="specs"):
    """Two spec trees: the same dicts and lists, each port spec a tuple
    equal to JAX's PartitionSpec as a tuple; weight leaves field by field."""
    if isinstance(t, dict):
        assert set(t) == set(j), path
        for k in t:
            _assert_specs_equal(t[k], j[k], f"{path}/{k}")
    elif isinstance(t, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_specs_equal(a, b, f"{path}/{i}")
    elif isinstance(t, tparallel.PartitionSpec):
        assert tuple(t) == tuple(j), f"{path}: {t} vs {j}"
    elif t is None:
        assert j is None, path
    else:  # a weight leaf of specs
        for f in ("codes", "scale", "zero_point", "outlier_idx", "w_outlier", "base", "lora_a",
                  "lora_b"):
            if hasattr(t, f):
                _assert_specs_equal(getattr(t, f), getattr(j, f), f"{path}.{f}")


@pytest.fixture(scope="module")
def trees():
    """Each format's JAX tree and the port's conversion of it."""
    params = jllama.init_params(jax.random.PRNGKey(0), CFG)
    out = {"dense": params}
    for fmt in ("nf4", "nf4a", "llm_int8", "int4c"):
        out[fmt] = jnn.quantize_params(params, mode=fmt, block_size=64, min_size=1024)
    out["lora"] = jtrain.add_lora(out["nf4"], jax.random.PRNGKey(2), rank=4, dtype=jnp.float32)
    return {fmt: (j, interop.from_jax_params(j)) for fmt, j in out.items()}


# --------------------------------------------------------------- spec trees


def test_llama_and_cache_specs_match_jax(trees):
    tcfg = _tcfg(CFG)
    _assert_specs_equal(tparallel.llama_param_specs(tcfg), jsharding.llama_param_specs(CFG))
    _, tparams = trees["nf4"]
    jparams, _ = trees["nf4"]
    _assert_specs_equal(tparallel.llama_param_specs(tcfg, tparams),
                        jsharding.llama_param_specs(CFG, jparams))
    no_head = {k: v for k, v in jparams.items() if k != "lm_head"}
    _assert_specs_equal(tparallel.llama_param_specs(tcfg, {"layers": tparams["layers"]}),
                        jsharding.llama_param_specs(CFG, no_head))
    _assert_specs_equal(tparallel.cache_specs(tcfg), jsharding.cache_specs(CFG))


@pytest.mark.parametrize("tp", [True, False])
def test_fsdp_specs_match_jax(trees, tp):
    jparams, tparams = trees["nf4"]
    tcfg = _tcfg(CFG)
    _assert_specs_equal(tparallel.fsdp_param_specs(tcfg, tp=tp),
                        jsharding.fsdp_param_specs(CFG, tp=tp))
    _assert_specs_equal(tparallel.fsdp_param_specs(tcfg, tparams, tp=tp),
                        jsharding.fsdp_param_specs(CFG, jparams, tp=tp))
    _assert_specs_equal(tparallel.host_fsdp_param_specs(tcfg, tparams, tp=tp),
                        jdist.host_fsdp_param_specs(CFG, jparams, tp=tp))


def test_host_specs_match_jax(trees):
    jparams, tparams = trees["nf4"]
    tcfg = _tcfg(CFG)
    _assert_specs_equal(tparallel.host_llama_param_specs(tcfg, tparams),
                        jdist.host_llama_param_specs(CFG, jparams))
    _assert_specs_equal(tparallel.host_cache_specs(tcfg), jdist.host_cache_specs(CFG))
    assert tuple(tparallel.host_batch_spec()) == tuple(jdist.host_batch_spec())
    # the retag maps 'data' to the batch axes, as JAX's does
    retag = tparallel.distributed._retag(tparallel.P("data", "model"))
    assert tuple(retag) == tuple(jdist._retag(jax.sharding.PartitionSpec("data", "model")))


@pytest.mark.parametrize("fmt", FORMATS)
def test_expand_specs_match_jax(trees, fmt):
    jparams, tparams = trees[fmt]
    tcfg = _tcfg(CFG)
    for tspecs, jspecs in (
            (tparallel.llama_param_specs(tcfg, tparams), jsharding.llama_param_specs(CFG, jparams)),
            (tparallel.fsdp_param_specs(tcfg, tparams), jsharding.fsdp_param_specs(CFG, jparams))):
        _assert_specs_equal(tparallel.expand_specs(tparams, tspecs),
                            jsharding.expand_specs(jparams, jspecs))


# ---------------------------------------------------------- sharded arrays


def _rank_meshes(jmesh):
    """(the port's in-process Mesh, the JAX device) of every mesh position."""
    names = jmesh.axis_names
    shape = dict(zip(names, jmesh.devices.shape))
    for pos in itertools.product(*(range(n) for n in jmesh.devices.shape)):
        yield Mesh(shape=shape, coords=dict(zip(names, pos))), jmesh.devices[pos]


def _assert_local_equal(t, j, device, path="params"):
    """Every Shard of the port's tree equals, byte for byte, the JAX
    array's shard on ``device``; returns the number of arrays held."""
    if isinstance(t, dict):
        return sum(_assert_local_equal(t[k], j[k], device, f"{path}/{k}") for k in t)
    if isinstance(t, list):
        return sum(_assert_local_equal(a, b, device, f"{path}/{i}")
                   for i, (a, b) in enumerate(zip(t, j)))
    if isinstance(t, Shard):
        (want,) = [s.data for s in j.addressable_shards if s.device == device]
        want = np.asarray(want)
        got = t.local.detach()
        assert tuple(t.shape) == tuple(j.shape), path
        assert tuple(got.shape) == want.shape, f"{path}: {tuple(got.shape)} vs {want.shape}"
        if got.dtype == torch.bfloat16:
            got, want = got.float(), want.astype(np.float32)
        assert got.numpy().tobytes() == want.tobytes(), path
        return 1
    if t is None:
        return 0
    return sum(_assert_local_equal(getattr(t, f), getattr(j, f), device, f"{path}.{f}")
               for f in ("codes", "scale", "zero_point", "outlier_idx", "w_outlier", "base",
                         "lora_a", "lora_b") if hasattr(t, f))


@pytest.mark.parametrize("fmt", FORMATS)
def test_shard_params_byte_equal_jax(trees, fmt):
    """The 2 x 4 mesh, under the Megatron specs and the FSDP specs: every
    rank's arrays are the JAX device's addressable shard."""
    jparams, tparams = trees[fmt]
    jmesh = jsharding.make_mesh(data=2, model=4)
    tcfg = _tcfg(CFG)
    for which in ("llama", "fsdp"):
        if which == "llama":
            jsh = jsharding.shard_params(jparams, jmesh, cfg=CFG)
            tspecs = None
        else:
            jsh = jsharding.shard_params(jparams, jmesh,
                                         specs=jsharding.fsdp_param_specs(CFG, jparams))
            tspecs = tparallel.fsdp_param_specs(tcfg, tparams)
        for mesh, device in _rank_meshes(jmesh):
            local = tparallel.shard_params(tparams, mesh, specs=tspecs, cfg=tcfg)
            assert _assert_local_equal(local, jsh, device, f"{fmt} {which}") > 0


@pytest.mark.parametrize("fmt", ["dense", "nf4", "llm_int8", "lora"])
def test_shard_params_host_byte_equal_jax(trees, fmt):
    """The simulated 2 hosts x (data 2 x model 2): host specs (weights
    replicated over 'dcn') and the host FSDP specs; and the host cache."""
    jparams, tparams = trees[fmt]
    jmesh = jdist.make_host_mesh(data=2, model=2, dcn=2)
    tcfg = _tcfg(CFG)
    jsh = jdist.shard_params_host(jparams, jmesh, cfg=CFG)
    jfsdp = jdist.shard_params_host(jparams, jmesh,
                                    specs=jdist.host_fsdp_param_specs(CFG, jparams))
    jcache = jllama.init_cache(CFG, 4, max_len=16)
    jcache = {k: v + jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) for k, v in jcache.items()}
    tcache = interop.from_jax_params(jcache)
    jcache_sh = {k: jax.device_put(v, jax.sharding.NamedSharding(
        jmesh, jdist.host_cache_specs(CFG)[k])) for k, v in jcache.items()}
    for mesh, device in _rank_meshes(jmesh):
        local = tparallel.shard_params_host(tparams, mesh, cfg=tcfg)
        assert _assert_local_equal(local, jsh, device, fmt) > 0
        local = tparallel.shard_params_host(
            tparams, mesh, specs=tparallel.host_fsdp_param_specs(tcfg, tparams))
        assert _assert_local_equal(local, jfsdp, device, f"{fmt} fsdp") > 0
        cache = tparallel.shard_cache(tcache, mesh, tcfg, specs=tparallel.host_cache_specs(tcfg))
        assert _assert_local_equal(cache, jcache_sh, device, "cache") == 3


def test_shard_cache_byte_equal_jax():
    jmesh = jsharding.make_mesh(data=2, model=4)
    jcache = jllama.init_cache(CFG, 4, max_len=16)
    jcache = {k: v + jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) for k, v in jcache.items()}
    jsh = {k: jax.device_put(v, jax.sharding.NamedSharding(jmesh, jsharding.cache_specs(CFG)[k]))
           for k, v in jcache.items()}
    tcache = interop.from_jax_params(jcache)
    for mesh, device in _rank_meshes(jmesh):
        cache = tparallel.shard_cache(tcache, mesh, _tcfg(CFG))
        assert _assert_local_equal(cache, jsh, device, "cache") == 3
        made = tparallel.spmd.init_cache(_tcfg(CFG), 4, 16, mesh=mesh)
        assert all(made[k].local.shape == cache[k].local.shape for k in cache)


def test_shards_own_their_memory(trees):
    """A sliced frozen array is copied out (the global tree can go); a
    replicated one is kept as it is; an adapter becomes the rank's own
    leaf tensor that requires a gradient."""
    _, tparams = trees["lora"]
    mesh = Mesh(shape={"data": 2, "model": 4}, coords={"data": 1, "model": 3})
    local = tparallel.shard_params(tparams, mesh, specs=tparallel.fsdp_param_specs(
        _tcfg(CFG), tparams))
    wq, gwq = local["layers"][0]["wq"], tparams["layers"][0]["wq"]
    assert wq.base.codes.local.is_contiguous()
    assert wq.base.codes.local.untyped_storage().nbytes() * 8 == gwq.base.codes.numel()
    assert local["norm_f"].local is tparams["norm_f"]
    for name in ("lora_a", "lora_b"):
        t = getattr(wq, name).local
        assert t.is_leaf and t.requires_grad
        assert t.untyped_storage().data_ptr() != getattr(gwq, name).untyped_storage().data_ptr()
    from quanta_tpu_torch import nn as tnn
    assert [t.shape for t in tnn.lora_parameters(local)][:2] == [(128, 4), (4, 64)]


# ------------------------------------------------------------ the checks


def test_check_fsdp_divisibility_matches_jax():
    cfgs = (CFG, jllama.LlamaConfig(vocab_size=64, dim=96, n_layers=1, n_heads=3, n_kv_heads=3,
                                    hidden_dim=200), jllama.LlamaConfig.tiny())
    raised = 0
    for cfg, data, tp in itertools.product(cfgs, (1, 2, 3, 4), (1, 2, 4, 64)):
        try:
            jsharding.check_fsdp_divisibility(cfg, data, tp=tp)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            tparallel.check_fsdp_divisibility(_tcfg(cfg), data, tp=tp)
        else:
            raised += 1
            with pytest.raises(ValueError, match=f"^{re.escape(want)}$"):
                tparallel.check_fsdp_divisibility(_tcfg(cfg), data, tp=tp)
    assert raised > 10
    tparallel.check_fsdp_divisibility(tllama.LlamaConfig.llama2_7b(), 2)  # phase 29's


def test_process_batch_slice_one_rank(monkeypatch):
    for var in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = Mesh(shape={"dcn": 2, "data": 2, "model": 2}, coords={"dcn": 0, "data": 0, "model": 0})
    assert tparallel.process_batch_slice(8, mesh) == slice(0, 8)
    assert tparallel.make_host_mesh().shape == {"dcn": 1, "data": 1, "model": 1}
    # under torchrun on the second of two hosts of 4 ranks each
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("GROUP_RANK", "1")
    assert tparallel.process_batch_slice(8, mesh) == slice(4, 8)


def test_mesh_axes_and_indices():
    """Axis tuples act as one axis, the first name outermost; a tuple out
    of the mesh's order is refused; a mesh built in-process has no groups."""
    mesh = Mesh(shape={"dcn": 2, "data": 3, "model": 2}, coords={"dcn": 1, "data": 2, "model": 0})
    assert mesh.size(("dcn", "data")) == 6 and mesh.index(("dcn", "data")) == 5
    assert mesh.index("model") == 0 and mesh.size(()) == 1
    with pytest.raises(ValueError, match="order"):
        mesh.index(("data", "dcn"))
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("data")
    assert tparallel.spmd.batch_axes(mesh) == ("dcn", "data")
    rows = tparallel.spmd.batch_rows(torch.arange(12), mesh)
    assert rows.tolist() == [10, 11]


def test_exports_every_jax_name():
    missing = [n for n in jparallel.__all__ if not hasattr(tparallel, n)]
    assert not missing, missing
