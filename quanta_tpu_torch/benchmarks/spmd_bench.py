"""The spec-sharded paths on one host, held against the single card
(``parallel.spmd`` over ``parallel.shard_params`` trees).

Two legs, each a function one rank runs (``distributed.initialize``
already joined and chose its card):

  - :func:`fsdp_rank`: FSDP (ZeRO-3) QLoRA over a frozen NF4 base,
    Llama-2-7B at full width and depth, a ``data`` x 1 mesh under
    ``fsdp_param_specs(tp=False)``, rank-8 bf16 LoRA on wq/wv, 8-bit Adam,
    the global batch of ``train_bench``'s ``llama2-7b nf4`` row (2 x 512).
    Rank 0 first runs the single-card step on the same rows and seed
    through each of ``ROUTES``: the kernels, the plain route, and two
    other valid orders of the plain route's sums (each reduction in two
    f32 halves; cuBLAS's bf16 GEMM). Every rank then takes ``steps``
    steps: its losses (the global one), launches per step (7 x n_layers +
    1 ``matmul_4bit``, 3 fewer ``matmul_4bit_t``, one ``adam8bit_update``
    per 128 of the rank's adapter leaves, nothing else), host-clock step
    ms, resident and step-peak GiB, its weight bytes beside the single
    card's and the gathered-weight bytes (peak alive, total a step). Rank
    0 holds the step-1 loss against the single card within 1e-2, and each
    step-1 ``lora_b`` gradient (:func:`_grad_rule`) against the plain
    route by ``logits_gate``'s floor rule, the floor the larger distance
    of the two other orders from it, and against the single card's
    kernels taking a rank's rows at a time within the rule's absolute
    term alone (a rank runs that very arithmetic).
  - :func:`host_rank`: config 5's layout at Llama-2-13B's width, the host
    mesh dcn 2 x data 1 x model 2 (hosts simulated on one machine) under
    ``host_llama_param_specs``, NF4 base: each rank's prefill logits
    against the single card's rows by ``logits_gate``'s rule, with 7 x
    n_layers + 1 ``matmul_4bit`` launches; a cached greedy decode, the
    'model' ranks agreeing; one QLoRA step (adapters with a nonzero B,
    :func:`with_b`) on the host mesh whose loss matches a flat data 2 x
    model 2 mesh's, and whose A and B gradients equal the flat mesh's and
    meet the floor rule against the single card's plain route and its
    kernels taking a rank's rows at a time, as both meshes' do; and an
    llm_int8 forward at
    ``int8_layers`` layers through ``matmul_int8_fused`` against the
    single card by JAX's ``_assert_quant_close`` rule.

A rank that fails a check raises, and with it the run. Ranks sharing one
card talk over gloo: such a run shows that the sharded paths compute what
the single card computes, not how fast they would run on cards of their
own.

    torchrun --nproc_per_node 2 -m quanta_tpu_torch.benchmarks.spmd_bench fsdp
    torchrun --nproc_per_node 4 -m quanta_tpu_torch.benchmarks.spmd_bench host [--layers N]

Rank 0 prints one JSON line. ``chip_smoke.py`` runs the legs through
``parallel.spawn_local``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import time

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch import train
from quanta_tpu_torch.benchmarks import logits_gate
from quanta_tpu_torch.benchmarks.train_bench import _nbytes, make_batch, model_config, with_lora
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.optim import Adam8bit
from quanta_tpu_torch.parallel import (check_fsdp_divisibility, fsdp_param_specs,
                                       host_cache_specs, make_host_mesh, make_mesh, shard_params,
                                       shard_params_host, spmd)

LR = 1e-3  # chip_smoke's QLoRA rate (the reference's own step test)
GIB = 2 ** 30


def _world() -> int:
    return torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1


def _device(device) -> torch.device:
    """The rank's card unless the caller names a device."""
    return torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allocated(dev) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _release(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


class _Checks:
    """A leg's checks: every failure is kept, and :meth:`done` raises them
    all at once, with the row's numbers."""

    def __init__(self, tag: str):
        self.tag, self.failed = tag, []

    def __call__(self, cond: bool, msg: str) -> None:
        if not cond:
            self.failed.append(msg)

    def done(self, row: dict) -> dict:
        if self.failed:
            raise RuntimeError(f"{self.tag}: " + "; ".join(self.failed) + "\n" +
                               json.dumps(row, default=str))
        return row


def _adapter_grads(params, mesh=None, parts: str = "ab") -> dict:
    """Every adapter's gradient in f32, global, by name ("layer 0 wq B"):
    the ``parts`` of each, wq then wv a layer. A sharded tree's are
    gathered from the ranks' slices, so every rank of ``mesh`` calls."""
    out = {}
    for i, lp in enumerate(params["layers"]):
        for n in ("wq", "wv"):
            for part in parts:
                x = getattr(lp[n], f"lora_{part}")
                g = spmd.unshard(x, mesh, grad=True) if mesh is not None else x.grad
                out[f"layer {i} {n} {part.upper()}"] = g.float()
    return out


def _fresh(params) -> dict:
    """The tree with new adapter leaves (copies of its own)."""
    ads = [{k: {ab: t.detach().clone().requires_grad_() for ab, t in v.items()}
            for k, v in ad.items()} for ad in train.extract_adapters(params)]
    return train.merge_adapters(params, ads)


def with_b(params: dict, seed: int = 2, std: float = 1e-2) -> dict:
    """The tree with every adapter's B drawn from N(0, std^2) (LoRA starts
    B at zero, where A's gradient is zero: a nonzero B puts A's gradient,
    and the sums over 'model' that feed it, under the checks)."""
    gen = torch.Generator(device=params["tok_emb"].device).manual_seed(seed)
    ads = [{k: {"a": v["a"], "b": (torch.randn(v["b"].shape, generator=gen, device=v["b"].device)
                                   * std).to(v["b"].dtype).requires_grad_()}
            for k, v in ad.items()} for ad in train.extract_adapters(params)]
    return train.merge_adapters(params, ads)


def _halves_rounded(a, w):
    """a @ w with the reduction in two f32 halves, each rounded to a's
    dtype before they are added: the arithmetic of a sum over two 'model'
    ranks of their bf16 partial results."""
    h = w.shape[0] // 2
    return ((a[:, :h].float() @ w[:h]).to(a.dtype).float()
            + (a[:, h:].float() @ w[h:]).to(a.dtype).float())


# the single card's routes: the kernels; the plain route; and other valid
# orders of the plain route's sums, whose distance from it is the floor
# bf16 rounding sets: each reduction in two f32 halves, cuBLAS's bf16 GEMM
# of the same dequantized weights, and (where 'model' splits a reduction)
# the two halves each rounded to bf16
ROUTES = {"kernels": (None, None), "plain": (False, None),
          "reordered": (False, logits_gate._split_sum), "bf16_gemm": (False, logits_gate._bf16_gemm),
          "halves_rounded": (False, _halves_rounded)}
# the floors of each leg's gradient rule: FSDP splits no reduction; the
# host mesh's 'model' ranks sum their bf16 partials of every dx
FSDP_FLOORS = ("reordered", "bf16_gemm")
HOST_FLOORS = ("reordered", "bf16_gemm", "halves_rounded")


def _single_card(init, cfg, data, dev, rows: int, parts: str, floors: tuple) -> dict:
    """Step 1 on the single card through the kernels, the plain route and
    the ``floors`` of ``ROUTES``: loss, adapter gradients (``parts``), ms
    and step-peak GiB above the resident tree; and the kernels' gradients
    taken ``rows`` rows at a time (``per_rank``: a rank's M), summed over
    the row groups."""
    out = {}
    for route in ("kernels", "plain", *floors):
        use_kernel, gemm = ROUTES[route]
        params = _fresh(init)
        opt = Adam8bit(qnn.lora_parameters(params), lr=LR, use_kernel=use_kernel)
        step = train.make_qlora_train_step(cfg, opt, use_kernel=use_kernel)
        _sync(dev)
        resident = _allocated(dev)
        _reset_peak(dev)
        t0 = time.perf_counter()
        if gemm is not None:
            with logits_gate.reordered_plain(gemm):
                loss = step(params, data).item()
        else:
            loss = step(params, data).item()
        _sync(dev)
        out[route] = {"loss": loss, "grads": _adapter_grads(params, parts=parts),
                      "ms": (time.perf_counter() - t0) * 1e3, "resident_gib": resident / GIB,
                      "peak_gib": (_peak(dev) - resident) / GIB}
        del params, opt, step
    params = _fresh(init)
    groups = data["inputs"].shape[0] // rows
    for r in range(0, data["inputs"].shape[0], rows):
        logits, _ = llama.forward(params, data["inputs"][r:r + rows], cfg)
        (train.causal_lm_loss(logits, data["targets"][r:r + rows]) / groups).backward()
    out["per_rank"] = {"grads": _adapter_grads(params, parts=parts)}
    return out


def _grad_rule(grads: dict, single: dict, floors: tuple) -> tuple:
    """The gradients of a mesh against the single card's: rel-L2 to its
    kernels taken a rank's rows at a time, and to its plain route; each
    tensor's limit is ``logits_gate``'s floor rule, the floor the largest
    distance of the ``floors`` routes from the plain route. Returns
    (rel-L2s by comparison, limits)."""
    plain = single["plain"]["grads"]

    def rel(a, b):
        return [logits_gate.rel_l2(a[k], b[k]) for k in plain]
    out = {"vs_per_rank": rel(grads, single["per_rank"]["grads"]), "vs_plain": rel(grads, plain),
           "kernels_vs_plain": rel(single["kernels"]["grads"], plain),
           **{f"{r}_vs_plain": rel(single[r]["grads"], plain) for r in floors}}
    tols = [logits_gate.FLOOR_X * max(f) + logits_gate.FLOOR_ABS
            for f in zip(*(out[f"{r}_vs_plain"] for r in floors))]
    return out, tols


def fsdp_rank(rank: int, cfg, batch: int = 2, seq: int = 512, steps: int = 3, seed: int = 0,
              device=None) -> dict:
    """One rank of FSDP QLoRA on a ``world`` x 1 mesh, the model ``cfg``.
    Returns its measurements; raises on a failed check."""
    check = _Checks(f"spmd_bench fsdp rank {rank}")
    world = _world()
    mesh = make_mesh(data=world, model=1)
    dev = _device(device)
    check_fsdp_divisibility(cfg, world)
    base = qnn.init_quantized_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                     mode="nf4", block_size=64, device=dev)
    init = with_lora(base)
    data = make_batch(cfg, batch, seq, dev)
    single_bytes = _nbytes(init)
    row = {"rank": rank, "world": world, "dim": cfg.dim, "n_layers": cfg.n_layers,
           "batch": batch, "seq": seq, "specs": "fsdp_param_specs(tp=False)",
           "single_card_weights_gib": single_bytes / GIB}
    if rank == 0:
        single = _single_card(init, cfg, data, dev, batch // world, "b", FSDP_FLOORS)
        row["single_card"] = {r: {k: v for k, v in s.items() if k != "grads"}
                              for r, s in single.items()}
    sharded = shard_params(init, mesh, specs=fsdp_param_specs(cfg, init, tp=False))
    del base, init
    _release(dev)
    _sync(dev)
    resident = _allocated(dev)
    row["rank_weights_gib"] = _nbytes(sharded) / GIB
    row["resident_gib"] = resident / GIB
    opt = Adam8bit(qnn.lora_parameters(sharded), lr=LR)
    step = train.make_qlora_train_step(cfg, opt, mesh=mesh)
    n_leaves = len(list(qnn.lora_parameters(sharded)))
    per_fwd = 7 * cfg.n_layers + 1
    want = {"matmul_4bit": per_fwd, "matmul_4bit_t": per_fwd - 3,
            "adam8bit_update": -(-n_leaves // _build.library().qt_adam8bit_table_leaves())}
    losses, launches, ms, peaks, gathered = [], [], [], [], []
    for i in range(steps):
        _sync(dev)
        _reset_peak(dev)
        _build.reset_launches()
        spmd.reset_gathered(mesh)
        t0 = time.perf_counter()
        losses.append(step(sharded, data).item())
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_nonzero(_build.launches))
        peaks.append((_peak(dev) - resident) / GIB)
        gathered.append(spmd.gathered_bytes(mesh))
        if i == 0:
            grads = _adapter_grads(sharded, mesh, "b")
    largest = max(gathered_size(x) for x in weight_leaves(sharded))
    row.update(losses=losses, launches_per_step=launches, step_ms=ms, step_peak_gib=peaks,
               gathered_gib_per_step=[g["total"] / GIB for g in gathered],
               gathered_peak_gib=max(g["peak"] for g in gathered) / GIB,
               largest_leaf_gib=largest / GIB, adapter_leaves=n_leaves)
    for i, c in enumerate(launches):
        check(c == want, f"step {i + 1}: launches {c}, expected {want}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"losses {losses} (must fall)")
    check(max(g["peak"] for g in gathered) <= largest,
          f"{row['gathered_peak_gib']} GiB of gathered weights alive at once, above one "
          f"leaf's {largest / GIB}")
    check(_nbytes(sharded) <= single_bytes / world + largest,
          f"{row['rank_weights_gib']} GiB of weights, above 1/{world} of the single card's "
          f"{single_bytes / GIB} plus one leaf")
    if rank == 0:
        ref = single["kernels"]
        loss_rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
        rel, tols = _grad_rule(grads, single, FSDP_FLOORS)
        row.update(step1_loss_rel=loss_rel, loss_tol=1e-2, lora_b_grad_rel_l2=rel,
                   lora_b_grad_tols=tols)
        check(loss_rel <= 1e-2, f"step-1 loss {losses[0]} vs single card {ref['loss']}")
        for name, p, tol, r in zip(grads, rel["vs_plain"], tols, rel["vs_per_rank"]):
            check(p <= tol, f"{name} gradient rel-L2 {p} from the plain route > {tol}")
            # a rank's arithmetic is the single card's a row at a time:
            # the floor rule with a zero floor
            check(r <= logits_gate.FLOOR_ABS, f"{name} gradient rel-L2 {r} from the single "
                                              "card's taken a row at a time")
    return check.done(row)


def layer_leaves(lp: dict) -> list:
    """The weight leaves of one layer (a LoRAWeight's base)."""
    return [getattr(v, "base", v) for k, v in lp.items() if k.startswith("w")]


def weight_leaves(tree: dict) -> list:
    """The weight leaves of a Llama tree: the embedding, the head, every
    layer's."""
    head = [tree["lm_head"]] if "lm_head" in tree else []
    return [tree["tok_emb"], *head, *(x for lp in tree["layers"] for x in layer_leaves(lp))]


def gathered_size(leaf) -> int:
    """A sharded weight leaf's bytes once gathered (its global arrays)."""
    shards = [leaf] if hasattr(leaf, "local") else [
        getattr(leaf, f.name) for f in dataclasses.fields(leaf)
        if hasattr(getattr(leaf, f.name), "local")]
    return sum(s.local.element_size() * math.prod(s.shape) for s in shards)


def quant_close(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """JAX's ``_assert_quant_close`` rule (``tests/test_parallel.py``) for
    activation-quantizing formats, where a reordered f32 sum can flip one
    int8 activation code: the largest difference under 5% of max|ref|
    (at least 1) and under 5% of the logits off by more than 1e-3 of it.
    Returns the numbers and ``ok``."""
    d = (out.float() - ref.float()).abs()
    scale = max(ref.float().abs().max().item(), 1.0)
    res = {"max_abs_diff": d.max().item(), "scale": scale,
           "frac_moved": (d > 1e-3 * scale).float().mean().item()}
    res["ok"] = res["max_abs_diff"] < 0.05 * scale and res["frac_moved"] < 0.05
    return res


def host_rank(rank: int, cfg, batch: int = 4, prompt_len: int = 128, new: int = 4,
              int8_layers: int = 2, seed: int = 0, device=None) -> dict:
    """One rank of the host mesh (dcn 2 x data 1 x model 2, 4 ranks) and of
    the flat data 2 x model 2 mesh beside it, the model ``cfg``
    (``int8_layers=0`` leaves the llm_int8 forward out). Returns its
    measurements; raises on a failed check."""
    check = _Checks(f"spmd_bench host rank {rank}")
    host = make_host_mesh(data=1, model=2, dcn=2)
    flat = make_mesh(data=2, model=2)
    dev = _device(device)
    base = qnn.init_quantized_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                     mode="nf4", block_size=64, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)).to(dev)
    row = {"rank": rank, "mesh": host.shape, "coords": host.coords, "dim": cfg.dim,
           "n_layers": cfg.n_layers, "batch": batch, "prompt_len": prompt_len,
           "new_tokens": new, "specs": "host_llama_param_specs"}
    ref, single = logits_gate.prefill_logits_vs_plain(llama, base, prompt, cfg,
                                                       "spmd_bench host single card")
    ref_tokens = llama.greedy_decode(base, prompt, cfg, max_new_tokens=new)
    hosted = shard_params_host(base, host, cfg=cfg)
    per_fwd = 7 * cfg.n_layers + 1

    _sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = spmd.forward(hosted, prompt, cfg, host)
    _sync(dev)
    row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    launches = {"prefill": _nonzero(_build.launches)}
    check(launches["prefill"] == {"matmul_4bit": per_fwd},
          f"prefill launches {launches['prefill']}, expected {per_fwd} matmul_4bit")
    rel = logits_gate.rel_l2(logits, spmd.batch_rows(ref, host))
    row.update(prefill_logits_rel_l2=rel, tol=single["tol"], single_card=single)
    check(rel <= single["tol"], f"prefill logits rel-L2 {rel} > {single['tol']}")

    _build.reset_launches()
    t0 = time.perf_counter()
    tokens = spmd.greedy_decode(hosted, prompt, cfg, host, new, cache_spec=host_cache_specs(cfg))
    _sync(dev)
    row["decode_s"] = time.perf_counter() - t0
    launches["decode"] = _nonzero(_build.launches)
    check(launches["decode"] == {"matmul_4bit": new * per_fwd},
          f"decode launches {launches['decode']}")
    row["token_agreement_vs_single_card"] = (
        tokens[:, prompt_len:] == ref_tokens[:, prompt_len:]).float().mean().item()
    del hosted  # the QLoRA trees below are sharded anew, with adapters

    init = with_b(with_lora(base))
    del base
    data = make_batch(cfg, batch, prompt_len, dev)
    if rank == 0:
        card = _single_card(init, cfg, data, dev, batch // host.size(spmd.batch_axes(host)), "ab",
                            HOST_FLOORS)
    n_leaves = 4 * cfg.n_layers  # A and B of wq and wv a layer, replicated or cut
    want = {"matmul_4bit": per_fwd, "matmul_4bit_t": per_fwd - 3,
            "adam8bit_update": -(-n_leaves // _build.library().qt_adam8bit_table_leaves())}
    losses, grads = {}, {}
    for name, mesh in (("host", host), ("flat", flat)):
        tree = (shard_params_host(init, mesh, cfg=cfg) if name == "host"
                else shard_params(init, mesh, cfg=cfg))
        opt = Adam8bit(qnn.lora_parameters(tree), lr=LR)
        step = train.make_qlora_train_step(cfg, opt, mesh=mesh)
        _sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        losses[name] = step(tree, data).item()
        _sync(dev)
        row[f"{name}_step_ms"] = (time.perf_counter() - t0) * 1e3
        launches[f"{name}_step"] = _nonzero(_build.launches)
        check(launches[f"{name}_step"] == want,
              f"{name}-mesh QLoRA launches {launches[f'{name}_step']}, expected {want}")
        grads[name] = _adapter_grads(tree, mesh)
        del tree, opt, step
    row["qlora_losses"] = losses
    check(math.isfinite(losses["host"]) and abs(losses["host"] - losses["flat"]) <= (
        1e-5 * abs(losses["flat"])), f"host-mesh QLoRA loss {losses['host']} vs the flat "
                                     f"mesh's {losses['flat']}")
    if rank == 0:
        # the sum over ('dcn', 'data') is the flat mesh's over 'data'; both
        # meshes' gradients (A's through the sums over 'model') against
        # the single card by the floor rule
        rel, tols = {}, None
        for name in ("host", "flat"):
            rel[name], tols = _grad_rule(grads[name], card, HOST_FLOORS)
        rel["host_vs_flat"] = [logits_gate.rel_l2(grads["host"][k], grads["flat"][k])
                               for k in grads["host"]]
        row.update(qlora_grad_rel_l2=rel, qlora_grad_tols=tols,
                   qlora_single_card={r: {k: v for k, v in x.items() if k != "grads"}
                                      for r, x in card.items()})
        for i, key in enumerate(grads["host"]):
            check(rel["host_vs_flat"][i] <= logits_gate.FLOOR_ABS,
                  f"{key} gradient: host mesh {rel['host_vs_flat'][i]} from the flat mesh")
            for name in ("host", "flat"):
                for vs in ("vs_plain", "vs_per_rank"):
                    r = rel[name][vs][i]
                    check(r <= tols[i], f"{key} gradient: {name} mesh rel-L2 {r} {vs} > {tols[i]}")
    del init
    _release(dev)
    row["launches"] = launches
    if not int8_layers:
        return check.done(row)

    cfg8 = dataclasses.replace(cfg, n_layers=int8_layers)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(seed), cfg8, device=dev)
    int8 = qnn.quantize_params(dense, mode="llm_int8")
    del dense
    with torch.no_grad():
        ref8, _ = llama.forward(int8, prompt, cfg8)
        hosted8 = shard_params_host(int8, host, cfg=cfg8)
        _build.reset_launches()
        logits8, _ = spmd.forward(hosted8, prompt, cfg8, host)
        _sync(dev)
    launches["int8_prefill"] = _nonzero(_build.launches)
    check(launches["int8_prefill"] == {"matmul_int8_fused": 7 * int8_layers + 1},
          f"llm_int8 launches {launches['int8_prefill']}")
    row["int8"] = {"n_layers": int8_layers,
                   **quant_close(logits8, spmd.batch_rows(ref8, host))}
    check(row["int8"]["ok"], f"llm_int8 logits off the single card's: {row['int8']}")
    return check.done(row)


LEGS = {"fsdp": fsdp_rank, "host": host_rank}


def rank_leg(rank: int, leg: str, kwargs: dict) -> dict:
    """``LEGS[leg](rank, **kwargs)``: the entry ``parallel.spawn_local``
    runs (``chip_smoke.py``'s phase 29)."""
    return LEGS[leg](rank, **kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("leg", choices=sorted(LEGS))
    ap.add_argument("--layers", type=int, help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmd_bench measures a CUDA device and found none")
    from quanta_tpu_torch.parallel import initialize

    initialize()
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    cfg = model_config("llama2-7b" if args.leg == "fsdp" else "llama2-13b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    row = LEGS[args.leg](rank, cfg)
    if rank == 0:
        print(json.dumps({"device": torch.cuda.get_device_name(0), args.leg: row}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
