"""Rank bodies for tests/test_torch_spmd.py: each runs in a process of its
own (``parallel.spawn_local``), imports torch and the port only, never
jax, and returns numpy arrays for the test to hold against the JAX
package in its own process."""

import dataclasses
import pickle

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch import train
from quanta_tpu_torch.models.llama import LlamaConfig
from quanta_tpu_torch.nn.lora import LoRAWeight
from quanta_tpu_torch.optim import Adam8bit
from quanta_tpu_torch.benchmarks import spmd_bench
from quanta_tpu_torch.parallel import (P, fsdp_param_specs, host_cache_specs, make_host_mesh,
                                       make_mesh, shard_params, shard_params_host, spmd)
from quanta_tpu_torch.parallel.sharding import map_arrays


@dataclasses.dataclass
class BF16:
    """A bf16 array in transit (numpy has no bf16): its bits as int16."""

    bits: np.ndarray


def to_numpy(tree):
    """A port tree with every tensor as numpy (weight leaves keep their
    types)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return BF16(t.view(torch.int16).numpy()) if t.dtype == torch.bfloat16 else t.numpy()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: to_numpy(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)
                                            if f.name not in ("shape", "dtype")})
    return tree


def to_torch(tree):
    """The inverse of :func:`to_numpy`; a LoRAWeight's adapters require a
    gradient."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    if isinstance(tree, BF16):
        return torch.from_numpy(tree.bits).view(torch.bfloat16)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, LoRAWeight):
        return dataclasses.replace(tree, base=to_torch(tree.base),
                                   lora_a=to_torch(tree.lora_a).requires_grad_(),
                                   lora_b=to_torch(tree.lora_b).requires_grad_())
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: to_torch(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)
                                            if f.name not in ("shape", "dtype")})
    return tree


def _global(x, mesh, grad=False) -> np.ndarray:
    # a copy: the optimizer steps a replicated local tensor in place
    return spmd.unshard(x, mesh, grad).numpy().copy()


def _adapters(sharded, mesh, grad=False) -> list:
    """Every adapter (or its gradient) of a sharded tree, global, as
    ``train.extract_adapters`` lays them out."""
    return [{n: {"a": _global(ab["a"], mesh, grad), "b": _global(ab["b"], mesh, grad)}
             for n, ab in ad.items()} for ad in train.extract_adapters(sharded)]


def _qlora(tree, mesh, cfg, batch, steps, specs=None, host=False):
    """``steps`` QLoRA steps over ``tree`` sharded on ``mesh``: the global
    losses, and after step 1 the adapters' gradients and the adapters
    (global), the gathered-weight bytes (peak alive, total) and the
    largest leaf's gathered size."""
    if host:
        sharded = shard_params_host(tree, mesh, cfg=cfg, specs=specs)
    else:
        sharded = shard_params(tree, mesh, specs=specs, cfg=cfg)
    opt = Adam8bit(qnn.lora_parameters(sharded), lr=1e-3)
    step = train.make_qlora_train_step(cfg, opt, mesh=mesh)
    losses = []
    for i in range(steps):
        spmd.reset_gathered(mesh)
        losses.append(step(sharded, batch).item())
        if i == 0:
            gathered = spmd.gathered_bytes(mesh)
            grads, stepped = _adapters(sharded, mesh, grad=True), _adapters(sharded, mesh)
    layers = [spmd_bench.layer_leaves(lp) for lp in sharded["layers"]]
    return {"losses": losses, "grads": grads, "adapters": stepped,
            "gathered_peak": gathered["peak"],
            "gathered_total": gathered["total"],
            "largest_leaf": max(spmd_bench.gathered_size(x)
                                for x in spmd_bench.weight_leaves(sharded)),
            "layer_bytes": [sum(spmd_bench.gathered_size(x) for x in ly) for ly in layers]}


def run(rank, path):
    """Every case on one job of ranks, the flat ('data', 'model') mesh and
    the host ('dcn', 'data', 'model') mesh built side by side; the case
    (config, tokens, numpy trees) is read from the pickle at ``path``
    (passing megabytes through the spawn pipe costs seconds a rank).
    Returns, by case, the global logits (gathered over the batch axes),
    tokens or losses."""
    torch.set_num_threads(1)  # ranks share the host's cores: no oversubscription
    with open(path, "rb") as f:
        case = pickle.load(f)
    d, m = case["flat"]
    flat = make_mesh(d, m)
    host = make_host_mesh(*case["host"][1:], dcn=case["host"][0])
    cfg = LlamaConfig(**case["cfg"], dtype=torch.float32)
    toks = torch.from_numpy(case["tokens"])
    trees = {k: to_torch(v) for k, v in case["trees"].items()}

    def logits(sharded, mesh, tokens=toks, cache=None):
        lg, cache = spmd.forward(sharded, tokens, cfg, mesh, cache)
        return spmd.gather_rows(lg, mesh).numpy(), cache

    out = {}
    with torch.no_grad():
        for name, fmt, specs in (("dense", "dense", None), ("nf4", "nf4", None),
                                 ("fsdp", "nf4", fsdp_param_specs(cfg, trees["nf4"])),
                                 ("llm_int8", "llm_int8", None), ("int4c", "int4c", None)):
            out[name] = logits(shard_params(trees[fmt], flat, specs=specs, cfg=cfg), flat)[0]

        dense = shard_params(trees["dense"], flat, cfg=cfg)
        cache = spmd.init_cache(cfg, toks.shape[0], 32, mesh=flat)
        lg, cache = logits(dense, flat, toks[:, :8], cache)
        lg1, _ = logits(dense, flat, toks[:, 8:9], cache)
        out["cached"] = [lg, lg1]
        out["greedy"] = spmd.greedy_decode(dense, toks[:, :8], cfg, flat, 6).numpy()

        hosted = shard_params_host(trees["nf4"], host, cfg=cfg)
        out["host"] = logits(hosted, host)[0]
        cache = spmd.init_cache(cfg, toks.shape[0], 32, mesh=host, specs=host_cache_specs(cfg))
        lg, cache = logits(hosted, host, toks, cache)
        lg1, _ = logits(hosted, host, toks[:, :1], cache)
        out["host_cached"] = [lg, lg1]
        out["host_greedy"] = spmd.greedy_decode(hosted, toks[:, :8], cfg, host, 4,
                                                cache_spec=host_cache_specs(cfg)).numpy()

    rolled = {"inputs": toks, "targets": torch.roll(toks, -1, dims=1)}
    out["fsdp_qlora"] = _qlora(trees["lora"], flat, cfg, rolled, 2,
                               specs=fsdp_param_specs(cfg, trees["lora"]))
    out["qlora"] = _qlora(trees["lora"], flat, cfg, rolled, 2)
    out["dcn_qlora"] = _qlora(trees["lora_h"], host, cfg, rolled, 1, host=True)
    out["flat_qlora"] = _qlora(trees["lora_h"], flat, cfg, rolled, 1)
    for name, specs in (("dense_fsdp", fsdp_param_specs(cfg, trees["dense"])),
                        ("dense_megatron", None)):
        out[name] = _dense_grads(trees["dense"], flat, cfg, rolled, specs)
    return out


def _dense_grads(tree, mesh, cfg, batch, specs):
    """One step of ``train.make_train_step`` over a dense tree whose every
    array is trainable, sharded on ``mesh`` under ``specs``: the global
    loss and every array's gradient, global (the tree's layout)."""
    sharded = shard_params(map_arrays(lambda t, _: t.clone().requires_grad_(), tree), mesh,
                           specs=specs, cfg=cfg)
    held = []
    map_arrays(lambda x, _: held.append(x.local), sharded)
    step = train.make_train_step(cfg, torch.optim.SGD(held, lr=0.0), mesh=mesh)
    loss = step(sharded, batch).item()
    return {"loss": loss, "grads": map_arrays(lambda x, _: _global(x, mesh, grad=True), sharded)}


def gather_grads(rank, device):
    """The executor's autograd collectives on tensors on ``device`` over
    two ranks ("cuda": both on the one card, over gloo): a gather over
    'data' (backward: the sum over the ranks, the rank's slice), one over
    'model' (backward: the rank's slice), and a linear over an nf4 weight
    split along K on 'data', gathered at use (forward and dx). Returns
    numpy arrays: the gathered values and the gradients."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    out = {}
    for axis, mesh in (("data", make_mesh(2, 1)), ("model", make_mesh(1, 2))):
        t = (torch.arange(6, dtype=torch.float32, device=dev).reshape(3, 2) + 10 * rank)
        t.requires_grad_()
        y = spmd._Gather.apply(t, mesh, (axis,), 0)
        w = torch.arange(12, dtype=torch.float32, device=dev).reshape(6, 2) * (rank + 1)
        (y * w).sum().backward()
        out[axis] = {"y": y.detach().cpu().numpy(), "grad": t.grad.cpu().numpy()}
    mesh = make_mesh(2, 1)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((256, 256), generator=gen)
    qt = qnn.quantize_params({"w": w}, mode="nf4", min_size=1)["w"]
    qt = dataclasses.replace(qt, codes=qt.codes.to(dev), scale=qt.scale.to(dev))
    local = shard_params({"w": qt}, mesh, specs={"w": P("data", None)})["w"]
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(1 + rank)).to(dev)
    x.requires_grad_()
    spmd.reset_gathered(mesh)
    y = spmd._base_linear(x, local, mesh, False, None)
    (y * y).sum().backward()
    out["linear"] = {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
                     "x": x.detach().cpu().numpy(), "gathered": spmd.gathered_bytes(mesh),
                     "local_codes": tuple(local.codes.local.shape)}
    return out


def bench_leg(rank, leg, kwargs):
    """One rank of a ``benchmarks.spmd_bench`` leg on the CPU, every
    kernel wrapper on its kernel route into the fake kernels (so the
    launch counts run as on the card)."""
    from torch_fakes import kernel_routes

    torch.set_num_threads(1)
    with kernel_routes():
        return spmd_bench.rank_leg(rank, leg, dict(kwargs, device="cpu"))


def check_gather_grads(res):
    """Hold what :func:`gather_grads` returned, rank by rank: the gathers'
    values and gradients exactly, the gathered linear's output and dx
    against the unsharded ``nn.linear`` of the same weight on the CPU
    (the plain route)."""
    base = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r for r in range(2)]
    w = [np.arange(12, dtype=np.float32).reshape(6, 2) * (r + 1) for r in range(2)]
    wq = torch.randn((256, 256), generator=torch.Generator().manual_seed(0))
    qt = qnn.quantize_params({"w": wq}, mode="nf4", min_size=1)["w"]
    for rank, out in enumerate(res):
        for axis in ("data", "model"):
            np.testing.assert_array_equal(out[axis]["y"], np.concatenate(base))
        # over 'data': the sum of both ranks' gradients, the rank's rows
        np.testing.assert_array_equal(out["data"]["grad"], (w[0] + w[1])[3 * rank:3 * rank + 3])
        # over 'model': the rank's own gradient, its rows
        np.testing.assert_array_equal(out["model"]["grad"], w[rank][3 * rank:3 * rank + 3])
        lin = out["linear"]
        assert lin["local_codes"] == (256, 256)  # half of the (512, 256) packed rows
        assert lin["gathered"]["alive"] == 0 and lin["gathered"]["total"] > 0
        x = torch.from_numpy(lin["x"]).requires_grad_()
        y = qnn.linear(x, qt)
        (y * y).sum().backward()
        # f32 sums in another order on the card: within 1e-5 of the largest value
        for got, want in ((lin["y"], y.detach().numpy()), (lin["dx"], x.grad.numpy())):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
