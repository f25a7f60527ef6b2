"""Llama-2-7B and Llama-2-13B decoded and served on one CUDA device (port
of ``quanta_tpu/benchmarks/model_scale_bench.py:30-155``).

Both models at full width and depth, ``max_seq_len`` 512, their linears
drawn directly in a quantized format by ``nn.init_quantized_params``
(seed 0; nf4a by default, any matmul-layout format without a zero point),
so the dense tree never exists. Speed depends on shapes and formats, not
on weight values, so random codes measure the real serving rate.

Per model:
  - ``weights_gib``: the parameter tree's bytes on the device;
  - decode tok/s at batch 8, prompt 128, cache 512
    (``decode_bench.bench_decode``, the median of 3 windows of 32 steps),
    prefill tok/s (``decode_bench.bench_prefill``), every window beside
    them;
  - the device's idle share and device ms of a decode step
    (``decode_bench.profile_decode``), which tell host from device;
  - the ``Engine`` trace: ``n_requests`` requests (32; prompts of 16-250
    tokens, numpy seed 0) all submitted at once, 48 new tokens each, 8
    slots, page 16, prefill buckets (64, 256), ``multi_step`` 8, the
    int8 KV pool (``kv_quant``): tok/s, TTFT p50/p99, windows,
    preemptions.

    python -m quanta_tpu_torch.benchmarks.model_scale_bench [--model 7b 13b]
        [--fmt nf4a] [--requests 32] [--out table.md]

prints one JSON line a model; markdown goes only to ``--out``. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import decode_bench
from quanta_tpu_torch.benchmarks.train_bench import _nbytes
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.serve import Engine, Request

MAX_SEQ = 512  # the KV budget: 8 slots x 512 tokens
BATCH, PROMPT, CACHE = 8, 128, 512
MAX_PROMPT, MAX_NEW = 250, 48


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def model_config(name: str) -> llama.LlamaConfig:
    """Llama-2-7B or -13B at full width and depth, ``max_seq_len`` 512."""
    base = {"llama2-7b": llama.LlamaConfig.llama2_7b,
            "llama2-13b": llama.LlamaConfig.llama2_13b}[name]()
    return dataclasses.replace(base, max_seq_len=MAX_SEQ)


def init_model(cfg, fmt: str = "nf4a") -> dict:
    """The model's tree on the CUDA device, codes drawn from seed 0."""
    dev = torch.device("cuda")
    return qnn.init_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, mode=fmt,
                                     block_size=64, device=dev)


def serve_trace(params, cfg, *, n_requests: int = 32, kv_quant: bool = True,
                seed: int = 0) -> dict:
    """The closed ``Engine`` trace: every request submitted at once."""
    eng = Engine(params, cfg, n_slots=8, page_size=16, prefill_buckets=(64, 256),
                 multi_step=8, kv_quant=kv_quant)
    eng.warm_widths((MAX_PROMPT + MAX_NEW + 8) // 16 + 1, max_prompt_len=MAX_PROMPT)
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, max_new_tokens=MAX_NEW,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(16, MAX_PROMPT + 1))).astype(np.int32))
            for i in range(n_requests)]
    done = eng.run(reqs)
    torch.cuda.synchronize()
    m = eng.metrics()
    m.update(n_requests=n_requests, kv_quant=kv_quant,
             all_finished=len(done) == n_requests and all(len(r.output) == MAX_NEW
                                                         for r in done))
    return m


def run_model(name: str, fmt: str = "nf4a", *, serve: bool = True, n_requests: int = 32,
              params=None) -> dict:
    """One row: the model's weights, decode, prefill, idle share and serve
    trace (``params``: a tree already drawn, else one from seed 0)."""
    cfg = model_config(name)
    t0 = time.perf_counter()
    if params is None:
        params = init_model(cfg, fmt)
    torch.cuda.synchronize()
    row = {"model": name, "fmt": fmt, "n_layers": cfg.n_layers, "max_seq_len": cfg.max_seq_len,
           "weights_gib": _nbytes(params) / 2**30, "init_s": time.perf_counter() - t0,
           "batch": BATCH, "prefill_len": PROMPT, "cache_len": CACHE}
    steps = decode_bench.bench_decode(params, cfg, batch=BATCH, prefill_len=PROMPT,
                                      cache_len=CACHE)
    prefills = decode_bench.bench_prefill(params, cfg, batch=BATCH, prefill_len=PROMPT)
    t_step, t_prefill = statistics.median(steps), statistics.median(prefills)
    prof = decode_bench.profile_decode(params, cfg, batch=BATCH, prefill_len=PROMPT,
                                       cache_len=CACHE)
    busy = prof["device_busy_ms"]
    row.update(decode_tok_s=BATCH / t_step, prefill_tok_s=BATCH * PROMPT / t_prefill,
               step_ms_windows=[t * 1e3 for t in steps],
               prefill_ms_windows=[t * 1e3 for t in prefills], **prof,
               idle_share=None if busy is None else 1.0 - busy / (t_step * 1e3))
    log(f"{name} {fmt}: {row['weights_gib']:.2f} GiB, decode {row['decode_tok_s']:.1f} tok/s, "
        f"prefill {row['prefill_tok_s']:.1f} tok/s, idle {row['idle_share']}")
    if serve:
        row["serve"] = serve_trace(params, cfg, n_requests=n_requests)
        log(f"{name} {fmt}: serve {row['serve']['throughput_tok_s']} tok/s, ttft p99 "
            f"{row['serve'].get('ttft_p99_ms')} ms")
    return row


def markdown(rows, device: str) -> str:
    lines = ["# Model scale: Llama-2 on one CUDA device", "",
             f"Device: {device}; random codes from `nn.init_quantized_params`, batch 8, prompt "
             "128, cache 512; serve: closed trace, prompts 16-250, 48 new tokens, 8 slots, "
             "multi_step 8, int8 KV.", "",
             "| model | weights GiB | decode tok/s | prefill tok/s | idle share | serve tok/s |"
             " TTFT p99 ms |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        s = r.get("serve", {})
        lines.append(f"| {r['model']} ({r['fmt']}) | {r['weights_gib']:.2f} | "
                     f"{r['decode_tok_s']:.1f} | {r['prefill_tok_s']:.1f} | {r['idle_share']} | "
                     f"{s.get('throughput_tok_s', '-')} | {s.get('ttft_p99_ms', '-')} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", nargs="+", default=["7b", "13b"], choices=["7b", "13b"])
    ap.add_argument("--fmt", default="nf4a")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--no-serve", action="store_true")
    ap.add_argument("--out", help="also write the markdown table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("model_scale_bench measures a CUDA device and found none")
    rows = []
    for m in args.model:
        rows.append(run_model(f"llama2-{m}", args.fmt, serve=not args.no_serve,
                              n_requests=args.requests))
        print(json.dumps({"device": torch.cuda.get_device_name(0), "model_scale": rows[-1]}),
              flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write(markdown(rows, torch.cuda.get_device_name(0)))
        log("wrote " + args.out)


if __name__ == "__main__":
    main()
