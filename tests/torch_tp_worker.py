"""Rank bodies for tests/test_torch_tp.py: each runs in a process of its
own (``parallel.spawn_local``), imports torch and the port only, never
jax, and returns numpy arrays for the test to hold against the JAX
package in its own process."""

import numpy as np
import torch

from quanta_tpu_torch.models.llama import LlamaConfig
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.parallel import make_mesh, tp
from torch_fakes import kernel_routes


def _tensors(tree):
    """numpy arrays -> tensors; a dict with ``codes`` -> ShardedQuant."""
    if isinstance(tree, dict) and "codes" in tree:
        meta = {k: v for k, v in tree.items() if k not in ("codes", "scale")}
        meta["dtype"] = getattr(torch, meta["dtype"])
        return tp.ShardedQuant(codes=torch.from_numpy(tree["codes"]),
                               scale=torch.from_numpy(tree["scale"]), **meta)
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(tree)


def run_case(rank, case):
    """The TP entry points on this rank's shard of ``case["trees"]`` (one
    per format). Returns, by format: the scoring forward's logits; for
    ``cached`` ones, the cached prefill's and each teacher-forced step's;
    for ``greedy`` ones, the tokens; the kernel launches of one forward
    through the fake kernels; and for a ``row`` case one row-parallel
    linear on the rank's K slice."""
    torch.set_num_threads(1)  # ranks share the host's cores: no oversubscription
    mesh = make_mesh(case["data"], case["model"])
    cfg = LlamaConfig(**case["cfg"], dtype=torch.float32)
    toks = torch.from_numpy(case["tokens"])
    out = {}
    for fmt, tree in case["trees"].items():
        local = tp.tp_local_params(_tensors(tree), mesh)
        res = {"forward": tp.tp_llama_forward(local, toks, cfg, mesh).numpy()}
        if fmt in case.get("cached", ()):
            cache = tp.tp_init_cache(cfg, toks.shape[0], max_len=32, mesh=mesh)
            lt, cache = tp.tp_llama_forward_cached(local, toks[:, :12], cfg, mesh, cache)
            steps = [lt.numpy()]
            for nxt in case["teacher"]:
                lt, cache = tp.tp_llama_forward_cached(local, torch.from_numpy(nxt), cfg, mesh,
                                                       cache)
                steps.append(lt.numpy())
            res["cached"] = steps
        if fmt in case.get("greedy", ()):
            res["greedy"] = tp.tp_greedy_decode(local, toks[:, :12], cfg, mesh,
                                                max_new_tokens=6).numpy()
        if fmt in case.get("fake", ()):
            with kernel_routes():
                tp.tp_llama_forward(local, toks, cfg, mesh)
                res["launches"] = {k: v for k, v in _build.launches.items() if v}
        out[fmt] = res
    if "row" in case:
        sq, x = _tensors(case["row"]["sq"]), torch.from_numpy(case["row"]["x"])
        k_loc = sq.local_shape()[0]
        chunks = sq.shard(mesh.coords["model"], n_chunks=2)
        x_loc = x[:, mesh.coords["model"] * k_loc:(mesh.coords["model"] + 1) * k_loc]
        out["row"] = {"n_chunks": len(chunks),
                      "y": tp._row_parallel(x_loc, chunks, mesh, None).numpy()}
    return out


def mesh_collectives(rank, data, model, device):
    """The mesh's collectives on tensors on ``device`` ("cuda": the card
    every rank shares, over gloo): each axis's async all-reduce in bf16
    and f32 (two in flight at once, as the row-parallel chunks are) and
    its all-gather along dim 1. Returns the results as numpy arrays."""
    torch.set_num_threads(1)
    mesh = make_mesh(data, model)
    dev = torch.device(device)
    out = {}
    for axis in ("data", "model"):
        base = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * rank
        pending = [mesh.all_reduce(base.to(dt, copy=True), axis)
                   for dt in (torch.bfloat16, torch.float32)]
        sums = [p.wait() for p in pending]
        gathered = mesh.all_gather(base, axis, dim=1)
        assert all(t.device == base.device for t in (*sums, gathered))
        out[axis] = {"sum_bf16": sums[0].float().cpu().numpy(), "sum_f32": sums[1].cpu().numpy(),
                     "gather": gathered.cpu().numpy()}
    return out


def all_ranks_agree(results) -> bool:
    """Every rank returned the same arrays (the gathered outputs)."""
    def flat(r):
        if isinstance(r, dict):
            return [x for k in sorted(r) for x in flat(r[k])]
        if isinstance(r, list):
            return [x for v in r for x in flat(v)]
        return [r]
    first = flat(results[0])
    return all(len(flat(r)) == len(first) and all(
        np.array_equal(a, b) for a, b in zip(flat(r), first)) for r in results[1:])
