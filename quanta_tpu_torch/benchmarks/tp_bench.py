"""Manual tensor parallelism on one host, held against the single-card
model: Llama-2-13B split over the 'model' ranks (``parallel.tp``).

Every rank draws the global quantized tree from one seed with
``nn.init_quantized_params`` and keeps only its shards
(``tp.tp_local_params``, leaf by leaf through ``from_global``: codes
re-paired, never re-quantized); no dense tree ever exists. Rank 0 first
runs the single-card model on that global tree (``llama.forward`` and
``greedy_decode``, through the kernels) and holds its prefill logits
against the plain route (``use_kernel=False``) by ``logits_gate``'s rule:
3e-2 rel-L2, or 1.5 times the floor + 2e-3 where that is higher, the
floor being the plain route's distance from itself summed in another
order. Then every rank:

  - the TP prefill (batch 8 x prompt 128, ``tp_llama_forward``): rank 0's
    logits against the checked single-card ones under the same limit;
    the launches of each kernel in
    that forward, which must be (5 column-split linears + 2 row-split ones
    x their chunks) x n_layers + 1 of the shards' kernel (``matmul_4bit``
    for nf4a, ``matmul_8bit`` for int8) and nothing else;
  - ``tp_greedy_decode`` for ``new`` tokens, the ranks' agreement checked
    inside it; rank 0 reports the share of tokens equal to the single-card
    greedy tokens (random weights: near-ties flip);
  - host-clock ms of the TP prefill and of the decode.

A rank that fails raises, and with it the run. Two ranks sharing one card
talk over gloo (NCCL takes one rank a device): such a run shows that the
shards compute what the single-card model computes, not how fast TP runs.

    torchrun --nproc_per_node 2 -m quanta_tpu_torch.benchmarks.tp_bench \\
        [--model 13b] [--fmt nf4a] [--layers N] [--new 32]

Rank 0 prints one JSON line. ``chip_smoke.py`` runs :func:`rank_main`
through ``parallel.spawn_local``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import logits_gate
from quanta_tpu_torch.benchmarks.train_bench import _nbytes
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.parallel import check_divisibility, initialize, make_mesh, tp

KERNEL = {"nf4a": "matmul_4bit", "int8": "matmul_8bit"}
CONFIGS = {"7b": llama.LlamaConfig.llama2_7b, "13b": llama.LlamaConfig.llama2_13b}


def per_forward(n_layers: int, n_chunks: int) -> int:
    """Kernel launches of one TP forward on one rank: five column-split
    linears and two row-split ones in ``n_chunks`` chunks a layer, and the
    vocab-split head."""
    return (5 + 2 * n_chunks) * n_layers + 1


@torch.no_grad()
def rank_main(rank: int, model: str = "13b", fmt: str = "nf4a", layers=None, batch: int = 8,
              prompt_len: int = 128, new: int = 32, seed: int = 0) -> dict:
    """One rank's run on a 1 x world mesh (``distributed.initialize``
    already joined, and chose this rank's card). Returns its
    measurements; raises on a failed check."""
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mesh = make_mesh(data=1, model=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = CONFIGS[model]()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    check_divisibility(cfg, world)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = qnn.init_quantized_params(gen, cfg, mode=fmt, block_size=64, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)).to(dev)
    row = {"rank": rank, "world": world, "model": model, "fmt": fmt, "n_layers": cfg.n_layers,
           "dim": cfg.dim, "hidden_dim": cfg.hidden_dim, "batch": batch,
           "prompt_len": prompt_len, "new_tokens": new}
    if rank == 0:
        ref, single = logits_gate.prefill_logits_vs_plain(
            llama, params, prompt, cfg, f"tp_bench {model} {fmt} single card")
        ref_tokens = llama.greedy_decode(params, prompt, cfg, max_new_tokens=new)
        row["single_card"] = single
    local = tp.tp_local_params(params, mesh)
    del params
    torch.cuda.empty_cache()
    row["local_weights_gib"] = _nbytes(local) / 2**30
    row["n_chunks"] = len(local["layers"][0]["wo"])

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = tp.tp_llama_forward(local, prompt, cfg, mesh)
    torch.cuda.synchronize()
    row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in _build.launches.items() if v}
    want = {KERNEL[fmt]: per_forward(cfg.n_layers, row["n_chunks"])}
    row["launches_per_forward"] = counts
    if counts != want:
        raise RuntimeError(f"tp_bench rank {rank}: launches {counts}, expected {want}")
    if not torch.isfinite(logits).all().item():
        raise RuntimeError(f"tp_bench rank {rank}: non-finite TP logits")

    _build.reset_launches()
    t0 = time.perf_counter()
    tokens = tp.tp_greedy_decode(local, prompt, cfg, mesh, max_new_tokens=new)
    torch.cuda.synchronize()
    row["decode_s"] = time.perf_counter() - t0
    row["decode_launches"] = dict(_build.launches)
    if _build.launches[KERNEL[fmt]] != new * per_forward(cfg.n_layers, row["n_chunks"]):
        raise RuntimeError(f"tp_bench rank {rank}: {row['decode_launches']} in the decode")
    if rank == 0:
        rel, tol = logits_gate.rel_l2(logits, ref), single["tol"]
        row.update(prefill_logits_rel_l2=rel, tol=tol,
                   token_agreement_vs_single_card=(tokens[:, prompt_len:] == ref_tokens[
                       :, prompt_len:]).float().mean().item())
        if rel > tol:
            raise RuntimeError(f"tp_bench: TP prefill logits rel-L2 {rel} > {tol} "
                               f"(floor {single['reordered_plain_rel_l2']})")
    return row


def rank_legs(rank: int, legs) -> list:
    """:func:`rank_main` once per leg (a dict of its keyword arguments),
    in one process: ``chip_smoke.py``'s 13B nf4a leg and int8 leg."""
    return [rank_main(rank, **leg) for leg in legs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="13b", choices=sorted(CONFIGS))
    ap.add_argument("--fmt", default="nf4a", choices=sorted(KERNEL))
    ap.add_argument("--layers", type=int, help="cut the depth to this many layers")
    ap.add_argument("--new", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_bench measures a CUDA device and found none")
    initialize()
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    row = rank_main(rank, args.model, args.fmt, args.layers, new=args.new)
    if rank == 0:
        print(json.dumps({"device": torch.cuda.get_device_name(0), "tp": row}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
