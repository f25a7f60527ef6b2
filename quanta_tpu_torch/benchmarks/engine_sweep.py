"""The ``Engine``'s transport sweep: ``multi_step`` x ``pipeline_depth``
(port of ``quanta_tpu/benchmarks/engine_sweep.py:44-170``).

The sustained trace (``serve_bench.run_one``: 64 Poisson requests at 40
req/s, an offered rate far above what 8 slots serve, 48 new tokens each)
runs over ``multi_step`` in {8, 16, 32} x ``pipeline_depth`` in {2, 3,
4}, or, with ``--slots``, over slot counts at the first of each. Each
cell reports tok/s, TTFT p50/p99, windows, and the admissions that rode
each window (the engine admits into every free slot each step:
``max_admits_per_step=None``), beside the device's own window rate at
that ``multi_step``: the tokens of one steady window over its device-busy
time (``serve_bench.window_profile``), the ceiling with no host in the
loop. The JAX bench reads that rate from ``engine_gap_bench``'s in-jit
slope; the port's ``engine_gap_bench`` splits the gap between the two
rates into its terms.

``--fmt llm_int8`` is the trace where the reference collapsed (236.9
tok/s, TTFT p99 11.0 s on a TPU v5e).

    python -m quanta_tpu_torch.benchmarks.engine_sweep [--fmt nf4a] [--requests 64]
        [--rate 40] [--layers N] [--slots 4 8 16]

TinyLlama-1.1B, random weights from seed 0; ``--layers`` cuts the depth.
Prints one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks.serve_bench import run_one, window_profile
from quanta_tpu_torch.models import llama


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_window_rate(params, cfg, multi_step: int, *, n_slots: int = 8,
                       kv_quant: bool = False) -> dict:
    """Tokens/s of steady decode windows on the device alone (one window's
    tokens over its device-busy ms), and the profile it comes from."""
    prof = window_profile(params, cfg, n_slots=n_slots, multi_step=multi_step,
                          kv_quant=kv_quant)
    busy = prof["device_busy_ms"]
    return {**prof, "device_tok_s": None if not busy else prof["tokens_per_window"] / busy * 1e3}


def cell(params, cfg, *, fmt: str, n_requests: int, rate: float, max_new: int,
         multi_step: int, pipeline_depth: int, n_slots: int = 8, kv_quant: bool = False,
         device_rate=None) -> dict:
    """One cell: the trace's metrics and the admissions per window."""
    admits, last = [], [0, 0]  # admissions of each step that dispatched a window

    def on_step(eng):
        if eng._steps > last[1]:
            admits.append(eng._admissions - last[0])
        last[:] = [eng._admissions, eng._steps]

    m = run_one(params, cfg, fmt_name=f"{fmt} k={multi_step} pd={pipeline_depth} s={n_slots}",
                n_requests=n_requests, rate=rate, max_new=max_new, n_slots=n_slots,
                multi_step=multi_step, pipeline_depth=pipeline_depth, kv_quant=kv_quant,
                on_step=on_step)
    row = {"multi_step": multi_step, "pipeline_depth": pipeline_depth, "n_slots": n_slots,
           "tok_s": m["throughput_tok_s"], "ttft_p50_ms": m.get("ttft_p50_ms"),
           "ttft_p99_ms": m.get("ttft_p99_ms"), "windows": m["decode_steps"],
           "admissions": m["admissions"], "preemptions": m["preemptions"],
           "requests_finished": m["requests_finished"], "all_finished": m["all_finished"],
           "admits_per_window_max": max(admits, default=0),
           "admits_per_window_mean": statistics.fmean(admits) if admits else 0.0,
           "windows_admitting": sum(a > 0 for a in admits)}
    if device_rate:
        row["device_tok_s"] = device_rate
        row["pct_of_device"] = 100.0 * row["tok_s"] / device_rate
    return row


def sweep(params, cfg, *, fmt: str, n_requests: int = 64, rate: float = 40.0,
          max_new: int = 48, multi_steps=(8, 16, 32), depths=(2, 3, 4), slots=None,
          kv_quant: bool = False) -> dict:
    """The grid (or the slot sweep), each ``multi_step`` first warmed by a
    throwaway 8-request trace, each with its device window rate."""
    kw = dict(fmt=fmt, n_requests=n_requests, rate=rate, max_new=max_new, kv_quant=kv_quant)
    rows = []
    if slots:
        ms, pd = multi_steps[0], depths[0]
        for ns in slots:
            dev = device_window_rate(params, cfg, ms, n_slots=ns, kv_quant=kv_quant)
            run_one(params, cfg, fmt_name="warm", n_requests=8, rate=rate, max_new=max_new,
                    n_slots=ns, multi_step=ms, pipeline_depth=pd, kv_quant=kv_quant)
            rows.append(cell(params, cfg, multi_step=ms, pipeline_depth=pd, n_slots=ns,
                             device_rate=dev["device_tok_s"], **kw))
        return {"slots_sweep": rows}
    for ms in multi_steps:
        dev = device_window_rate(params, cfg, ms, kv_quant=kv_quant)
        log(f"device window rate k={ms}: {dev['device_tok_s']} tok/s")
        run_one(params, cfg, fmt_name="warm", n_requests=8, rate=rate, max_new=max_new,
                multi_step=ms, pipeline_depth=depths[0], kv_quant=kv_quant)
        for pd in depths:
            rows.append(cell(params, cfg, multi_step=ms, pipeline_depth=pd,
                             device_rate=dev["device_tok_s"], **kw))
    best = max(rows, key=lambda r: r["tok_s"])
    return {"engine_sweep": rows, "best": best}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fmt", default="nf4a")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--multi-step", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--pipeline-depth", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--slots", type=int, nargs="+",
                    help="sweep n_slots instead, at the first multi_step and pipeline_depth")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--layers", type=int, help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("engine_sweep measures a CUDA device and found none")
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.tinyllama_1b()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params = dense if args.fmt == "bf16" else qnn.quantize_params(dense, mode=args.fmt,
                                                                  block_size=64)
    del dense
    out = sweep(params, cfg, fmt=args.fmt, n_requests=args.requests, rate=args.rate,
                max_new=args.max_new, multi_steps=args.multi_step, depths=args.pipeline_depth,
                slots=args.slots, kv_quant=args.kv_quant)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "fmt": args.fmt,
                      "n_layers": cfg.n_layers, "requests": args.requests, "rate": args.rate,
                      "max_new": args.max_new, "kv_quant": args.kv_quant, **out}))


if __name__ == "__main__":
    main()
