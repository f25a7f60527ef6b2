"""Serving-engine benchmark: continuous batching under a Poisson trace.

Port of ``quanta_tpu/benchmarks/serve_bench.py``. It measures the
``Engine`` end to end (admission, prefill, paged-KV windows, sampling,
readback and scheduling), not a bare decode loop.

Trace: seeded Poisson arrivals at ``rate`` req/s, prompt lengths uniform in
[16, 250], ``max_new`` output tokens each (``make_trace``: the same seed
gives the same trace as the JAX package's). Requests are submitted when
their arrival time passes, while the engine is stepped in a tight loop
(open-loop load, like a frontend).

    python -m quanta_tpu_torch.benchmarks.serve_bench --fmt nf4a int4c llm_int8 \\
        --kv-quant --requests 16 --rate 24 --max-new 48 --multi-step 8

prints one JSON line. ``run_one`` and ``window_profile`` are importable
(``chip_smoke.py`` calls both). Needs a CUDA device for ``main``;
``run_one`` runs wherever the parameters live.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from quanta_tpu_torch.serve import Engine, Request, kvcache

PREFILL_BUCKETS = (64, 256)
MAX_PROMPT = 250


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_trace(n_requests: int, rate: float, max_prompt: int, max_new: int,
               vocab: int, seed: int = 0):
    """Poisson arrival times + random prompts (deterministic by seed)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        plen = int(rng.integers(16, max_prompt + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        trace.append((float(arrivals[i]), prompt))
    return trace


def make_engine(params, cfg, *, n_slots=8, use_kernel=None, kv_quant=False, multi_step=1,
                pipeline_depth=2, recorder=None) -> Engine:
    """The engine of the serving rows: page 16, prefill buckets (64, 256)."""
    return Engine(params, cfg, n_slots=n_slots, page_size=16, prefill_buckets=PREFILL_BUCKETS,
                  use_kernel=use_kernel, kv_quant=kv_quant, multi_step=multi_step,
                  pipeline_depth=pipeline_depth, recorder=recorder)


def run_one(params, cfg, *, fmt_name: str, n_requests: int = 24, rate: float = 16.0,
            max_new: int = 64, n_slots: int = 8, use_kernel=None, kv_quant: bool = False,
            multi_step: int = 1, pipeline_depth: int = 2, seed: int = 0, recorder=None,
            on_step=None):
    """Serve one Poisson trace; returns the engine's metrics dict.
    ``on_step(engine)``, if given, runs after every ``step()``."""
    eng = make_engine(params, cfg, n_slots=n_slots, use_kernel=use_kernel, kv_quant=kv_quant,
                      multi_step=multi_step, pipeline_depth=pipeline_depth, recorder=recorder)
    trace = make_trace(n_requests, rate, max_prompt=MAX_PROMPT, max_new=max_new,
                       vocab=cfg.vocab_size, seed=seed)
    # run every prefill bucket and decode width the trace can reach first,
    # so the timed trace measures serving and not first-call costs
    max_need = (MAX_PROMPT + max_new + eng.multi_step) // eng.page_size + 1
    eng.warm_widths(max_need, max_prompt_len=MAX_PROMPT)

    t0 = time.perf_counter()
    next_uid = 0
    while next_uid < len(trace) or eng._draining:
        now = time.perf_counter() - t0
        while next_uid < len(trace) and trace[next_uid][0] <= now:
            _, prompt = trace[next_uid]
            eng.submit(Request(uid=next_uid, prompt=prompt, max_new_tokens=max_new))
            next_uid += 1
        eng.step()
        if on_step is not None:
            on_step(eng)
        if eng.idle and next_uid < len(trace):
            # nothing seated or in flight: sleep until the next arrival
            time.sleep(max(0.0, trace[next_uid][0] - (time.perf_counter() - t0)))
    eng._t_serve = time.perf_counter() - t0

    m = eng.metrics()
    m["fmt"] = fmt_name
    m["multi_step"] = multi_step
    m["kv_pool_mib"] = round(kvcache.pool_bytes(eng.pool) / 2**20, 1)
    m["n_requests"] = n_requests
    m["offered_rate_req_s"] = rate
    m["all_finished"] = len(eng.finished) == n_requests and all(
        len(r.output) == max_new for r in eng.finished)
    log(f"{fmt_name:9s} serve: {m['throughput_tok_s']:8.1f} tok/s | "
        f"ttft p50 {m.get('ttft_p50_ms', 0):7.1f} ms | p99 {m.get('ttft_p99_ms', 0):7.1f} ms | "
        f"windows {m['decode_steps']} | preempt {m['preemptions']}")
    return m


@torch.no_grad()
def window_profile(params, cfg, *, n_slots=8, use_kernel=None, kv_quant=False, multi_step=8,
                   prompt_len=128, windows=3, seed=0) -> dict:
    """Wall time and device-busy time of one steady decode window, every
    slot seated. ``window_ms`` is host-clock time per ``step()`` over
    ``windows`` steps ending in a synchronize; ``device_busy_ms`` sums the
    device's kernel time per window from ``torch.profiler`` (which slows
    the host, so it is taken over a separate run of the same length).
    ``idle_share`` = 1 - busy / window; None when the profiler recorded no
    device work."""
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine(params, cfg, n_slots=n_slots, use_kernel=use_kernel, kv_quant=kv_quant,
                      multi_step=multi_step)
    rng = np.random.default_rng(seed)
    max_new = multi_step * (2 * windows + 6)
    for i in range(n_slots):
        eng.submit(Request(uid=i, max_new_tokens=max_new,
                           prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)))
    for _ in range(3):  # admit everyone and fill the pipeline
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(windows):
        eng.step()
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3 / windows
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(windows):
            eng.step()
        torch.cuda.synchronize()
    busy_us, n_kernels = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            n_kernels += 1
    busy = busy_us / 1e3 / windows if n_kernels else None
    return {"window_ms": window_ms, "tokens_per_window": n_slots * multi_step,
            "device_busy_ms": busy, "device_ops_per_window": n_kernels / windows,
            "idle_share": None if busy is None else 1.0 - busy / window_ms}


def main():
    from quanta_tpu_torch import nn as qnn
    from quanta_tpu_torch.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", nargs="+", default=["nf4a", "int4c", "llm_int8"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=24.0)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--multi-step", type=int, default=8)
    ap.add_argument("--kv-quant", action="store_true",
                    help="add an int8-KV-cache row for every format")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_bench measures a CUDA device and found none")
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.tinyllama_1b()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rows = []
    for fmt in args.fmt:
        params = dense if fmt == "bf16" else qnn.quantize_params(dense, mode=fmt, block_size=64)
        for kv in (False, True) if args.kv_quant else (False,):
            rows.append(run_one(params, cfg, fmt_name=fmt + ("+kv8" if kv else ""),
                                n_requests=args.requests, rate=args.rate,
                                max_new=args.max_new, n_slots=args.slots,
                                multi_step=args.multi_step, kv_quant=kv))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "serve": rows}))


if __name__ == "__main__":
    main()
