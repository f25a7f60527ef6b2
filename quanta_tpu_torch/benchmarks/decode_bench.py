"""Decode / prefill / TTFT of the Llama decoder on one CUDA device.

Port of ``quanta_tpu/benchmarks/decode_bench.py:64-150``: the
TinyLlama-1.1B geometry with random weights from a seed, its linear
weights in bf16 (the control), nf4a, nf4 or int4c, batch 8, a 128-token
prefill and KV-cached greedy decode with a 512-slot cache.

Timing: ``torch.cuda.Event`` pairs around windows of many steps; the
metrics come from the median window. The events
sit on the stream, so their interval covers the device's work and every
gap in which the device waited for the host to issue the next operation;
with a Python loop of a few thousand small launches per step, that host
time is part of what a user waits for. ``profile_decode`` splits one step
into device-busy time and the rest.

    python -m quanta_tpu_torch.benchmarks.decode_bench   # one JSON line

Needs a CUDA device; without one it raises.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.models import llama

FORMATS = ("bf16", "nf4a", "nf4", "int4c")


def _require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("decode_bench measures a CUDA device and found none")
    return torch.device("cuda")


def _prefilled(params, cfg, batch, prefill_len, cache_len, use_kernel):
    dev = _require_cuda()
    cache = llama.init_cache(cfg, batch, max_len=cache_len, device=dev)
    toks = torch.zeros((batch, prefill_len), dtype=torch.int32, device=dev)
    logits, cache = llama.forward(params, toks, cfg, cache=cache, use_kernel=use_kernel)
    return logits[:, -1:].argmax(dim=-1).to(torch.int32), cache


@torch.no_grad()
def bench_decode(params, cfg, *, batch=8, prefill_len=128, cache_len=512,
                 steps=32, windows=3, warmup=4, use_kernel=None) -> list[float]:
    """Seconds per decode step (one new token for each of ``batch`` rows),
    one value per window of ``steps`` consecutive steps on one cache."""
    if prefill_len + warmup + windows * steps > cache_len:
        raise ValueError("cache_len too small for the steps asked")
    tok, cache = _prefilled(params, cfg, batch, prefill_len, cache_len, use_kernel)
    for _ in range(warmup):
        lg, cache = llama.forward(params, tok, cfg, cache=cache, use_kernel=use_kernel)
        tok = lg[:, -1:].argmax(dim=-1).to(torch.int32)
    out = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            lg, cache = llama.forward(params, tok, cfg, cache=cache, use_kernel=use_kernel)
            tok = lg[:, -1:].argmax(dim=-1).to(torch.int32)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3 / steps)
    return out


@torch.no_grad()
def bench_prefill(params, cfg, *, batch=8, prefill_len=128, reps=4, windows=3,
                  warmup=2, use_kernel=None) -> list[float]:
    """Seconds per prefill (fresh cache, ``batch`` x ``prefill_len`` tokens
    to first-token logits), one value per window of ``reps`` prefills."""
    for _ in range(warmup):
        _prefilled(params, cfg, batch, prefill_len, prefill_len + 8, use_kernel)
    out = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _prefilled(params, cfg, batch, prefill_len, prefill_len + 8, use_kernel)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3 / reps)
    return out


@torch.no_grad()
def profile_decode(params, cfg, *, batch=8, prefill_len=128, cache_len=512,
                   steps=8, use_kernel=None) -> dict:
    """Device-busy time and device operations per decode step, from
    ``torch.profiler`` (which slows the host, so the step time it sees,
    ``step_ms_profiled``, is longer than an unprofiled one).
    ``device_busy_ms`` is None when the profiler recorded no device work."""
    from torch.profiler import ProfilerActivity, profile

    tok, cache = _prefilled(params, cfg, batch, prefill_len, cache_len, use_kernel)
    lg, cache = llama.forward(params, tok, cfg, cache=cache, use_kernel=use_kernel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = llama.forward(params, tok, cfg, cache=cache, use_kernel=use_kernel)
            tok = lg[:, -1:].argmax(dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, n_kernels = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            n_kernels += 1
    return {"step_ms_profiled": wall * 1e3 / steps,
            "device_busy_ms": busy_us / 1e3 / steps if n_kernels else None,
            "device_ops_per_step": n_kernels / steps}


def quantized(dense, fmt: str, block_size: int = 64):
    return dense if fmt == "bf16" else qnn.quantize_params(dense, mode=fmt,
                                                           block_size=block_size)


def measure(params, cfg, *, batch=8, prefill_len=128) -> dict:
    """The end-to-end metrics from the median window, every window's time
    beside them to show the spread, and the device's idle share of a
    median decode step (device-busy time from ``profile_decode``)."""
    steps = bench_decode(params, cfg, batch=batch, prefill_len=prefill_len)
    prefills = bench_prefill(params, cfg, batch=batch, prefill_len=prefill_len)
    t_step, t_prefill = statistics.median(steps), statistics.median(prefills)
    prof = profile_decode(params, cfg, batch=batch, prefill_len=prefill_len)
    busy = prof["device_busy_ms"]
    return {
        "decode_tok_s": batch / t_step,
        "prefill_tok_s": batch * prefill_len / t_prefill,
        "ttft_ms": (t_prefill + t_step) * 1e3,
        "step_ms_windows": [t * 1e3 for t in steps],
        "prefill_ms_windows": [t * 1e3 for t in prefills],
        **prof,
        "idle_share": None if busy is None else 1.0 - busy / (t_step * 1e3),
    }


def main():
    dev = _require_cuda()
    cfg = llama.LlamaConfig.tinyllama_1b()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    results = {fmt: measure(quantized(dense, fmt), cfg) for fmt in FORMATS}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "batch": 8,
                      "prefill_len": 128, "cache_len": 512, "results": results}))


if __name__ == "__main__":
    main()
