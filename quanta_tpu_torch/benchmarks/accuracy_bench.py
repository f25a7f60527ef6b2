"""Accuracy benchmark: perplexity delta of every weight format vs the
unquantized model.

Port of ``quanta_tpu/benchmarks/accuracy_bench.py``, with the same protocol
and defaults: pretrain a byte-level Llama (dim 512, 8 layers, 8 heads, GQA
4:1, hidden 1536, f32) for 3000 steps of batch 32 x seq 256 on the
deterministic local corpus (``benchmarks/corpus.py``) with
``train.make_train_step`` and ``optim.Adam8bit`` (lr 3e-4); quantize its
weights into every serving format (int8, nf8, llm_int8, nf4a, nf4, int4,
fp4, int4c, blocks of 64), the nf4 tree transcoded to nf4a
(``utils.transcode_params``: the imported-QLoRA path, gated as 4-bit)
and W8A8 (int8 weights and 8-bit
fake-quantized activations, calibrated by minmax, percentile and entropy
on 8 held-in batches); measure held-out perplexity on the first 200,000
bytes of the eval split with ``eval.ppl_table``. Gates: delta <= 0.1 at
8-bit, <= 0.5 at 4-bit.

The quantized rows run through the kernels on a CUDA device
(``use_kernel=None``): the model is f32, so its int8, nf8 and W8A8 rows
reach ``matmul_8bit``'s f32 entry point.

The pretrained model is cached under ``~/.cache/quanta_tpu_torch``, keyed
by its hyperparameters and a hash of the corpus (``--no-cache``: neither
read nor written). The bench prints one JSON line; ``--out PATH`` also
writes the table as markdown there. Both carry that hash
(``corpus_tag``) and the train split's size in bytes (``train_bytes``),
so rows from two corpora are told apart. Exit code 1 when a gate fails.

    python -m quanta_tpu_torch.benchmarks.accuracy_bench [--steps 3000] [--cpu]

Runs on the CUDA device; ``--cpu`` asks for the CPU (at a cut ``--steps``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from quanta_tpu_torch import calib, ptq, train
from quanta_tpu_torch import eval as qeval
from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import corpus as corpus_mod
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.optim import Adam8bit
from quanta_tpu_torch.state.config import ConfigTree, QuantConfig
from quanta_tpu_torch.utils import serialization, transcode_params

FORMATS = ("int8", "nf8", "llm_int8", "nf4a", "nf4", "int4", "fp4", "int4c")
W8A8 = ("minmax", "percentile", "entropy")
GATE = {"int8": 0.1, "nf8": 0.1, "llm_int8": 0.1,
        "nf4a": 0.5, "nf4": 0.5, "int4": 0.5, "fp4": 0.5, "int4c": 0.5, "nf4->nf4a": 0.5,
        "w8a8-minmax": 0.1, "w8a8-percentile": 0.1, "w8a8-entropy": 0.1}
LR = 3e-4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def model_config(dim: int = 512, layers: int = 8, seq: int = 256) -> llama.LlamaConfig:
    return llama.LlamaConfig(vocab_size=256, dim=dim, n_layers=layers, n_heads=8,
                             n_kv_heads=2,  # 4:1 GQA, the TinyLlama geometry class
                             hidden_dim=dim * 3, max_seq_len=seq, dtype=torch.float32)


def make_batches(ids: np.ndarray, batch: int, seq_len: int, steps: int, device, seed=0):
    rng = np.random.default_rng(seed)
    n = len(ids) - seq_len - 1
    for _ in range(steps):
        starts = rng.integers(0, n, size=batch)
        windows = torch.from_numpy(np.stack([ids[s: s + seq_len + 1] for s in starts]))
        windows = windows.to(device=device, dtype=torch.int64)
        yield {"inputs": windows[:, :-1], "targets": windows[:, 1:]}


def corpus_ids(eval_bytes: int = 200_000):
    tok = qeval.ByteTokenizer()
    train_text, eval_text = corpus_mod.train_eval_split(corpus_mod.build_corpus())
    return tok.encode(train_text), tok.encode(eval_text)[:eval_bytes]


def pretrain(cfg, train_ids, *, steps: int, batch: int, device, log_every: int = 200):
    """Every parameter trained with 8-bit Adam; returns (params, final loss)."""
    params = llama.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                               device=device)
    leaves = train.dense_parameters(params)
    step = train.make_train_step(cfg, Adam8bit(leaves, lr=LR))
    t0, loss = time.perf_counter(), None
    for i, b in enumerate(make_batches(train_ids, batch, cfg.max_seq_len, steps, device)):
        loss = step(params, b)
        if i % log_every == 0:
            log(f"step {i:5d} loss {loss.item():.3f} ({time.perf_counter() - t0:.0f}s)")
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return params, loss.item()


def build_variants(params, cfg, train_ids, device) -> dict:
    """The unquantized model, every weight format, nf4 transcoded to nf4a
    and the W8A8 rows."""
    variants = {"bf16": params}  # the JAX bench's name for the unquantized row
    for fmt in FORMATS:
        variants[fmt] = qnn.quantize_params(params, mode=fmt, block_size=64, min_size=4096)
    variants["nf4->nf4a"] = transcode_params(variants["nf4"])
    batches = list(make_batches(train_ids, 8, cfg.max_seq_len, 8, device, seed=123))
    stats = calib.collect_stats(lambda p, b: llama.forward(p, b["inputs"], cfg)[0], params,
                                batches)
    for method in W8A8:
        variants[f"w8a8-{method}"] = ptq.quantize_model(
            params, ConfigTree(QuantConfig(bits=8, scheme="symmetric", weights_only=False,
                                           calibration=method)), stats=stats)
    return variants


def gate_rows(table: dict) -> tuple[list, int]:
    rows, n_fail = [], 0
    for name, r in table.items():
        g = GATE.get(name)
        ok = None if g is None else r["delta"] <= g
        n_fail += ok is False
        rows.append({"format": name, "ppl": r["ppl"], "delta": r["delta"], "gate": g,
                     "pass": ok})
    return rows, n_fail


def markdown(rows, result) -> str:
    loss = result["final_loss"]  # None where the checkpoint came from the cache
    loss = "from the cache" if loss is None else f"final loss {loss:.4f}"
    lines = ["# Accuracy: held-out perplexity per weight format (quanta_tpu_torch)", "",
             f"Byte-level Llama (dim={result['dim']}, layers={result['layers']}) pretrained "
             f"{result['steps']} steps ({loss}) on the local "
             f"corpus ({result['train_bytes']} train bytes, tag {result['corpus_tag']}); "
             "device: " + result["device"] + ".", "",
             "| format | ppl | delta vs unquantized | gate | pass |", "|---|---|---|---|---|"]
    for r in rows:
        ok = "" if r["pass"] is None else ("yes" if r["pass"] else "**NO**")
        gate = "-" if r["gate"] is None else r["gate"]
        lines.append(f"| {r['format']} | {r['ppl']:.4f} | {r['delta']:+.4f} | {gate} | {ok} |")
    return "\n".join(lines + [""])


def run(*, steps: int = 3000, dim: int = 512, layers: int = 8, seq: int = 256,
        batch: int = 32, eval_bytes: int = 200_000, cache_dir: str | None = None,
        device=None):
    """The whole protocol. Returns (result, variants, eval_ids, cfg):
    ``result`` is the JSON-able summary."""
    device = torch.device(device or "cuda")
    train_ids, eval_ids = corpus_ids(eval_bytes)
    log(f"corpus: {len(train_ids)} train / {len(eval_ids)} eval bytes")
    cfg = model_config(dim, layers, seq)
    tag = hashlib.sha256(train_ids.tobytes()).hexdigest()[:12]
    cache_path = None if cache_dir is None else os.path.join(
        cache_dir, f"accbench_d{dim}_l{layers}_s{seq}_b{batch}_t{steps}_{tag}.npz")
    t0 = time.perf_counter()
    if cache_path is not None and os.path.exists(cache_path):
        log(f"loading cached pretrained checkpoint {cache_path}")
        params, final_loss = serialization.load_checkpoint(cache_path, device=device), None
    else:
        params, final_loss = pretrain(cfg, train_ids, steps=steps, batch=batch, device=device)
        log(f"trained {steps} steps, final loss {final_loss:.4f}")
        if cache_path is not None:
            os.makedirs(cache_dir, exist_ok=True)
            serialization.save_checkpoint(params, cache_path)
    train_s = time.perf_counter() - t0
    variants = build_variants(params, cfg, train_ids, device)
    t1 = time.perf_counter()
    table = qeval.ppl_table(variants, eval_ids, cfg, seq_len=seq, batch=batch)
    rows, n_fail = gate_rows(table)
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "corpus_tag": tag, "train_bytes": len(train_ids),
              "dim": dim, "layers": layers, "seq": seq, "batch": batch, "steps": steps,
              "final_loss": final_loss, "train_s": train_s,
              "eval_s": time.perf_counter() - t1, "eval_tokens": len(eval_ids),
              "rows": rows, "gate_failures": n_fail}
    return result, variants, eval_ids, cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-bytes", type=int, default=200_000)
    ap.add_argument("--out", help="also write the table as markdown to this path")
    ap.add_argument("--cache-dir", default=os.path.join(os.path.expanduser("~"), ".cache",
                                                        "quanta_tpu_torch"))
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("accuracy_bench: no CUDA device; pass --cpu to run on the CPU")
    result, *_ = run(steps=args.steps, dim=args.dim, layers=args.layers, seq=args.seq,
                     batch=args.batch, eval_bytes=args.eval_bytes,
                     cache_dir=None if args.no_cache else args.cache_dir,
                     device="cpu" if args.cpu else "cuda")
    for r in result["rows"]:
        log(f"{r['format']:16s} ppl {r['ppl']:8.4f}  delta {r['delta']:+.4f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(markdown(result["rows"], result))
    print(json.dumps(result))
    if result["gate_failures"]:
        log("GATE FAILURES present")
        sys.exit(1)


if __name__ == "__main__":
    main()
