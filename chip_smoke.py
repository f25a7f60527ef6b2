#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA device and check it.

    python3 chip_smoke.py

Phases, each printing one JSON object per line; any failed check raises
and the script exits non-zero (nothing is caught):

  1. the card (``nvidia-smi`` name and power limit, printed raw as well);
  2. the build of ``quanta_tpu_torch/csrc/*.cu`` with nvcc (seconds, .so);
  3. each CUDA kernel against its plain PyTorch version at the main path's
     shapes, M in {8, 1024}: ``matmul_4bit`` (nf4a, nf4) within 2 bf16
     ulps of max|plain|, ``matmul_int4c`` bit for bit; kernel and plain
     times from CUDA events, weights rotated through more than the 50 MB
     L2 so decode shapes stream from device memory as they do in a model;
  4. the LLM.int8 kernels (``matmul_int8_fused``, ``matmul_int8``) at the
     five TinyLlama (K, N) for M in {8, 256} (a decode step of 8 slots,
     the largest prefill bucket), f32 x, the quantizer's outlier set, and
     ``quantize_blockwise`` at the int8 KV writes of the serve path (a
     prefill of 256 tokens, a window of 8 steps for 8 slots, every layer
     in one call; and one layer's window), all bit for bit against their
     plain versions, timed as in phase 3;
  5. the decode path at the full TinyLlama-1.1B geometry (22 layers, random
     bf16 weights from seed 0) in bf16, nf4a, nf4 and int4c: greedy decode
     of 8 prompts of 128 tokens for 32 new tokens, with the launch counts of
     each kernel reset just before and read just after; then prefill
     logits and tokens of the kernel path against ``use_kernel=False``;
  6. llm_int8 greedy decode of the full model through the fused route and
     through the plain-variant route (``fused=False``, reached as the
     reference's own A/B reaches it, ``quanta_tpu/benchmarks/
     llmint8_model_ab.py``: by changing ``matmul_int8``'s default under
     ``nn.linear``); tokens identical, each route's launches counted;
  7. the serve path at the full TinyLlama-1.1B width and depth: (a) a
     closed trace of 8 requests (llm_int8 weights, int8 KV cache, 8
     slots, multi_step 8, greedy), all submitted before ``Engine.run``,
     through the kernels and through ``use_kernel=False``: tokens
     identical request by request, launch counts as the design implies;
     (b) timed Poisson rows (``serve_bench.run_one``: 16 requests at 24
     req/s, 48 new tokens, 8 slots, multi_step 8) for nf4a, int4c,
     llm_int8 and llm_int8 + int8 KV, each with the device-idle share of
     one steady decode window;
  8. decode tok/s, prefill tok/s and TTFT at batch 8 / prompt 128 /
     cache 512 for every format, and the device-busy share of a step.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.
There is no CPU path: without a CUDA device the script fails.
"""

import functools
import importlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import decode_bench, serve_bench
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.metrics import MetricsRecorder
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build, int4c, int8mm, matmul, quantize
from quanta_tpu_torch.serve import Engine, Request

# the module: the package attribute ``quanta_tpu_torch.nn.linear`` is the function
linear_mod = importlib.import_module("quanta_tpu_torch.nn.linear")

# (K, N) of the TinyLlama-1.1B linears and their count in one forward
SHAPES = {(2048, 2048): 2 * 22, (2048, 256): 2 * 22, (2048, 5632): 2 * 22,
          (5632, 2048): 22, (2048, 32000): 1}
PER_FORWARD = 7 * 22 + 1  # quantized linears in one TinyLlama forward
L2_BYTES = 50 * 2**20
SLEEP_CYCLES = 10**8  # ~50 ms of SM clock
BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
NF4_REL_L2 = 3e-2
# int8 KV writes of the serve path (L, tokens.., nkv, hd), block = hd = 64:
# a prefill of 256 tokens, a window of 8 steps x 8 slots (every layer in
# one call, as the runner writes it), and one layer's window
KV_WRITES = {"prefill_256": (22, 256, 4, 64), "window_8x8": (22, 8, 8, 4, 64),
             "window_8x8_layer": (8, 8, 4, 64)}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters):
    """Mean device time of one call: CUDA events around ``iters`` calls,
    after warm-up. ``fn(i)`` takes the call index. The device first spins
    for ~50 ms, while the host queues every call, so the events time the
    calls back to back and not the host's Python between them (a wrapper
    costs ~20-30 µs of host time, more than a small kernel runs)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_past_l2(*tensors):
    """Enough clones of the weight tensors to exceed the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = min(1024, max(1, math.ceil(2 * L2_BYTES / nbytes)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def kernel_checks(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, per_step = [], {"matmul_4bit": [0.0, 0.0], "matmul_int4c": [0.0, 0.0]}
    max_err = {"matmul_4bit": 0.0, "matmul_int4c": 0.0}
    for (k, n), count in SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qts = {fmt: codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
               for fmt in ("nf4a", "nf4")}
        qw = int4c.quantize_int4c_weight(w)
        for m in (8, 1024):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            iters = 50 if m == 8 else 10
            for fmt, qt in qts.items():
                def run(use_kernel, ws):
                    return lambda i: matmul.matmul_4bit(
                        x, *ws[i % len(ws)], codebook=fmt, block=64, use_kernel=use_kernel)
                out = run(True, [(qt.codes, qt.scale)])(0)
                ref = run(False, [(qt.codes, qt.scale)])(0)
                err = (out.float() - ref.float()).abs().max().item()
                tol = 2 * BF16_ULP * ref.float().abs().max().item()
                check(torch.isfinite(out).all().item(), f"matmul_4bit {fmt} non-finite")
                check(err <= tol, f"matmul_4bit {fmt} M={m} K={k} N={n}: err {err} > {tol}")
                ws = copies_past_l2(qt.codes, qt.scale)
                ms, plain_ms = time_ms(run(True, ws), iters), time_ms(run(False, ws), iters)
                max_err["matmul_4bit"] = max(max_err["matmul_4bit"], err)
                if m == 8 and fmt == "nf4a":
                    per_step["matmul_4bit"][0] += count * ms
                    per_step["matmul_4bit"][1] += count * plain_ms
                rows.append(dict(kernel="matmul_4bit", fmt=fmt, M=m, K=k, N=n, max_abs_err=err,
                                 tol=tol, us=ms * 1e3, plain_us=plain_ms * 1e3))
                emit(kernel_check=rows[-1])
            # int4c: the kernel on the activations the wrapper quantizes
            x2 = x.float()
            rs = torch.clamp(x2.abs().amax(dim=1) / 127.0, min=1e-12)
            xq = torch.clamp(torch.round(x2 / rs[:, None]), -127, 127).to(torch.int8)

            def run_c(use_kernel, ws):
                return lambda i: int4c.matmul_int4c_kernel(
                    xq, ws[i % len(ws)][0], rs, ws[i % len(ws)][1], use_kernel=use_kernel)
            out = run_c(True, [(qw.codes, qw.scale)])(0)
            ref = run_c(False, [(qw.codes, qw.scale)])(0)
            err = (out - ref).abs().max().item()
            check(torch.equal(out, ref), f"matmul_int4c M={m} K={k} N={n} not bit-exact: {err}")
            ws = copies_past_l2(qw.codes, qw.scale)
            ms, plain_ms = time_ms(run_c(True, ws), iters), time_ms(run_c(False, ws), iters)
            if m == 8:
                per_step["matmul_int4c"][0] += count * ms
                per_step["matmul_int4c"][1] += count * plain_ms
            rows.append(dict(kernel="matmul_int4c", fmt="int4c", M=m, K=k, N=n,
                             max_abs_err=err, tol=0.0, us=ms * 1e3, plain_us=plain_ms * 1e3))
            emit(kernel_check=rows[-1])
    return per_step, max_err


def main_path(dev, cfg, dense):
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 128), dtype=np.int32)).to(dev)
    per_forward = 7 * cfg.n_layers + 1
    kernel_of = {"nf4a": "matmul_4bit", "nf4": "matmul_4bit", "int4c": "matmul_int4c"}
    launches = dict.fromkeys(_build.launches, 0)
    results = {}
    for fmt in decode_bench.FORMATS:
        params = decode_bench.quantized(dense, fmt)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = llama.greedy_decode(params, prompt, cfg, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        check(out.shape == (8, 160) and torch.equal(out[:, :128], prompt), f"{fmt}: bad output")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{fmt}: token out of range")
        expected = {k: 0 for k in launches}
        if fmt in kernel_of:
            expected[kernel_of[fmt]] = 32 * per_forward
        check(counts == expected, f"{fmt}: launches {counts}, expected {expected}")
        for k, v in counts.items():
            launches[k] += v
        row = {"fmt": fmt, "greedy_s": wall, "launches": counts}
        if fmt in kernel_of:
            with torch.no_grad():
                lk, _ = llama.forward(params, prompt, cfg)
                lp, _ = llama.forward(params, prompt, cfg, use_kernel=False)
            check(torch.isfinite(lk).all().item(), f"{fmt}: non-finite logits")
            rel = ((lk - lp).norm() / lp.norm()).item()
            plain = llama.greedy_decode(params, prompt, cfg, max_new_tokens=32, use_kernel=False)
            agree = (plain[:, 128:] == out[:, 128:]).float().mean().item()
            if fmt == "int4c":
                check(torch.equal(lk, lp), f"int4c prefill logits differ (rel-L2 {rel})")
                check(torch.equal(plain, out), "int4c greedy tokens differ from the plain path")
            else:
                check(rel <= NF4_REL_L2, f"{fmt}: prefill logits rel-L2 {rel} > {NF4_REL_L2}")
            row.update(prefill_logits_rel_l2=rel, tol=0.0 if fmt == "int4c" else NF4_REL_L2,
                       token_agreement_vs_plain=agree)
        else:
            with torch.no_grad():
                lk, _ = llama.forward(params, prompt, cfg)
            check(torch.isfinite(lk).all().item(), "bf16: non-finite logits")
        emit(main_path=row)
        results[fmt] = params
    return results, launches


def int8_kernel_checks(dev):
    """matmul_int8_fused and matmul_int8 against their plain versions at
    the serve shapes, bit for bit; times from CUDA events."""
    gen = torch.Generator(device=dev).manual_seed(2)
    per_step = {"matmul_int8_fused": [0.0, 0.0], "matmul_int8": [0.0, 0.0]}
    max_err = {"matmul_int8_fused": 0.0, "matmul_int8": 0.0}
    for (k, n), count in SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qw = int8mm.quantize_int8_weight(w)
        for m in (8, 256):
            x = torch.randn((m, k), generator=gen, device=dev)
            x[:, qw.outlier_idx[:4].long()] *= 20.0  # systematic outlier features
            # the operands matmul_int8 hands the kernels
            y_out = x.index_select(1, qw.outlier_idx) @ qw.w_outlier.float()
            xa = x.abs()
            xa[:, qw.outlier_idx] = 0.0
            rs = torch.clamp(xa.amax(dim=1) / 127.0, min=1e-12)
            xq = int8mm.quantize_rows(x, rs)
            runs = {
                "matmul_int8_fused": lambda uk, ws: lambda i: int8mm.matmul_int8_fused(
                    x, ws[i % len(ws)][0], rs, ws[i % len(ws)][1], y_out, use_kernel=uk),
                "matmul_int8": lambda uk, ws: lambda i: int8mm.matmul_int8_kernel(
                    xq, ws[i % len(ws)][0], rs, ws[i % len(ws)][1], use_kernel=uk),
            }
            iters = 50 if m == 8 else 10
            for name, run in runs.items():
                out = run(True, [(qw.codes, qw.scale)])(0)
                ref = run(False, [(qw.codes, qw.scale)])(0)
                err = (out - ref).abs().max().item()
                check(torch.isfinite(out).all().item(), f"{name} non-finite")
                check(torch.equal(out, ref), f"{name} M={m} K={k} N={n} not bit-exact: {err}")
                max_err[name] = max(max_err[name], err)
                ws = copies_past_l2(qw.codes, qw.scale)
                ms, plain_ms = time_ms(run(True, ws), iters), time_ms(run(False, ws), iters)
                if m == 8:
                    per_step[name][0] += count * ms
                    per_step[name][1] += count * plain_ms
                emit(kernel_check=dict(kernel=name, fmt="llm_int8", M=m, K=k, N=n,
                                       max_abs_err=err, tol=0.0, us=ms * 1e3,
                                       plain_us=plain_ms * 1e3))
    return per_step, max_err


def quantize_checks(dev):
    """quantize_blockwise (int8_sym, block 64) at the int8 KV writes,
    bit for bit; µs per call with inputs rotated past the L2."""
    gen = torch.Generator(device=dev).manual_seed(3)
    times, max_err = {}, 0.0
    for name, shape in KV_WRITES.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)
        x[0, 0] = 0.0  # zero vectors: scale 1, codes 0
        out = quantize.quantize_blockwise(x, fmt="int8_sym", block=64, use_kernel=True)
        ref = quantize.quantize_blockwise(x, fmt="int8_sym", block=64, use_kernel=False)
        err = max((out[0].int() - ref[0].int()).abs().max().item(),
                  (out[1] - ref[1]).abs().max().item())
        check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
              f"quantize_blockwise {name} not bit-exact: {err}")
        max_err = max(max_err, err)
        xs = copies_past_l2(x)

        def run(uk):
            return lambda i: quantize.quantize_blockwise(xs[i % len(xs)][0], fmt="int8_sym",
                                                         block=64, use_kernel=uk)
        ms, plain_ms = time_ms(run(True), 100), time_ms(run(False), 100)
        times[name] = (ms, plain_ms)
        emit(kernel_check=dict(kernel="quantize_blockwise", fmt="int8_sym", shape=list(shape),
                               max_abs_err=err, tol=0.0, us=ms * 1e3, plain_us=plain_ms * 1e3))
    # the codebook branch, which the serve path does not take
    x = torch.randn((4096 * 64,), generator=gen, device=dev)
    for fmt in ("nf4", "nf4a", "fp4"):
        out = quantize.quantize_blockwise(x, fmt=fmt, block=64, use_kernel=True)
        ref = quantize.quantize_blockwise(x, fmt=fmt, block=64, use_kernel=False)
        check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
              f"quantize_blockwise {fmt} not bit-exact")
    return times, max_err


def int8_decode_routes(dev, cfg, params):
    """llm_int8 greedy decode through the fused route (the default) and
    through the plain-variant route. Returns the launches of each."""
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 128), dtype=np.int32)).to(dev)
    outs, launches = {}, {}
    unfused = functools.partial(int8mm.matmul_int8, fused=False)
    for route, kernel in (("fused", "matmul_int8_fused"), ("plain_variant", "matmul_int8")):
        with mock.patch.object(linear_mod, "matmul_int8",
                               int8mm.matmul_int8 if route == "fused" else unfused):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            outs[route] = llama.greedy_decode(params, prompt, cfg, max_new_tokens=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(_build.launches)
        expected = {k: 0 for k in counts}
        expected[kernel] = 16 * PER_FORWARD
        check(counts == expected, f"llm_int8 {route}: launches {counts}, expected {expected}")
        launches[kernel] = counts[kernel]
        emit(int8_route=dict(route=route, greedy_s=wall, launches=counts))
    check(torch.equal(outs["fused"], outs["plain_variant"]),
          "llm_int8 greedy tokens differ between the fused and plain-variant routes")
    plain = llama.greedy_decode(params, prompt, cfg, max_new_tokens=16, use_kernel=False)
    check(torch.equal(plain, outs["fused"]), "llm_int8 greedy tokens differ from the plain path")
    return launches


def serve_closed_trace(dev, cfg, params):
    """8 requests, all submitted before Engine.run, so the schedule does
    not depend on speed: every request is admitted in the first step
    (8 slots; the default pool holds them all), takes its first token from
    its prefill and 15 more from two 8-step windows (the last one's
    overshoot trimmed). The design thus implies 8 prefills and 2 windows:
    matmul_int8_fused launches 155 x (8 + 2 x 8) forwards, and
    quantize_blockwise 2 (K and V) x (8 prefill writes + 2 window writes)."""
    trace = serve_bench.make_trace(8, 24.0, serve_bench.MAX_PROMPT, 16, cfg.vocab_size, seed=0)
    outs, kernel_counts = {}, None
    for use_kernel in (None, False):
        eng = Engine(params, cfg, n_slots=8, page_size=16,
                     prefill_buckets=serve_bench.PREFILL_BUCKETS, kv_quant=True,
                     multi_step=8, use_kernel=use_kernel)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16) for i, (_, p) in enumerate(trace)]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        m = eng.metrics()
        outs[use_kernel] = {r.uid: r.output for r in done}
        check(len(done) == 8 and all(len(r.output) == 16 for r in done),
              "closed trace: every request must finish with 16 tokens")
        check(all(0 <= t < cfg.vocab_size for r in done for t in r.output),
              "closed trace: token out of range")
        check((m["admissions"], m["decode_steps"], m["preemptions"]) == (8, 2, 0),
              f"closed trace: schedule {m['admissions']} admissions, {m['decode_steps']} "
              f"windows, {m['preemptions']} preemptions; the design implies 8, 2, 0")
        expected = {k: 0 for k in counts}
        if use_kernel is None:
            expected["matmul_int8_fused"] = PER_FORWARD * (8 + 2 * 8)
            expected["quantize_blockwise"] = 2 * (8 + 2)
            kernel_counts = counts
        check(counts == expected, f"closed trace use_kernel={use_kernel}: launches {counts}, "
                                  f"expected {expected}")
        emit(serve_closed=dict(use_kernel=use_kernel, seconds=wall, launches=counts,
                               prompt_lens=[len(p) for _, p in trace], **m))
    for uid, toks in outs[None].items():
        check(toks == outs[False][uid], f"closed trace: request {uid}'s tokens through the "
                                        "kernels differ from the plain path's")
    return kernel_counts


def serve_rows(cfg, params_by_fmt):
    """The timed Poisson rows and one steady window's idle share each."""
    for fmt, kv in (("nf4a", False), ("int4c", False), ("llm_int8", False),
                    ("llm_int8", True)):
        name = fmt + ("+kv8" if kv else "")
        rec = MetricsRecorder()
        torch.cuda.synchronize()
        _build.reset_launches()
        m = serve_bench.run_one(params_by_fmt[fmt], cfg, fmt_name=name, n_requests=16,
                                rate=24.0, max_new=48, n_slots=8, multi_step=8, kv_quant=kv,
                                recorder=rec)
        torch.cuda.synchronize()
        m["launches"] = dict(_build.launches)
        check(m["requests_finished"] == 16 and m["output_tokens"] == 16 * 48,
              f"serve row {name}: {m['requests_finished']} finished, "
              f"{m['output_tokens']} tokens")
        m["window"] = serve_bench.window_profile(params_by_fmt[fmt], cfg, kv_quant=kv,
                                                 multi_step=8)
        emit(serve_row={k: m[k] for k in (
            "fmt", "throughput_tok_s", "ttft_p50_ms", "ttft_p99_ms", "decode_steps",
            "preemptions", "kv_pool_mib", "serve_seconds", "output_tokens", "admissions",
            "window_upload_p50_s", "window_upload_p99_s", "launches", "window")})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's kernels need a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    # f32 references in full f32; the plain int4c product is exact only so
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(build={"seconds": time.perf_counter() - t0, "so": _build.build_info["so"],
                "cached": _build.build_info["cached"], "ptxas": ptxas})

    per_step, max_err = kernel_checks(dev)
    int8_step, int8_err = int8_kernel_checks(dev)
    per_step.update(int8_step)
    max_err.update(int8_err)
    q_times, max_err["quantize_blockwise"] = quantize_checks(dev)

    cfg = llama.LlamaConfig.tinyllama_1b()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params, launches = main_path(dev, cfg, dense)
    params["llm_int8"] = qnn.quantize_params(dense, mode="llm_int8")
    launches.update(int8_decode_routes(dev, cfg, params["llm_int8"]))
    serve_counts = serve_closed_trace(dev, cfg, params["llm_int8"])
    launches["matmul_int8_fused"] = serve_counts["matmul_int8_fused"]
    launches["quantize_blockwise"] = serve_counts["quantize_blockwise"]
    serve_rows(cfg, params)

    for fmt, p in params.items():
        r = decode_bench.measure(p, cfg)
        emit(bench={"fmt": fmt, "batch": 8, "prefill_len": 128, "cache_len": 512, **r})
    emit(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    at = "one decode step's calls at M=8 (nf4a for matmul_4bit), ms"
    q_ms, q_plain_ms = q_times["window_8x8"]
    emit(kernels=[
        {"name": "matmul_4bit", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/matmul_4bit.cu",
         "replaces": "quanta_tpu/ops/matmul.py:204", "launches": launches["matmul_4bit"],
         "max_abs_err": max_err["matmul_4bit"], "ms": per_step["matmul_4bit"][0],
         "plain_ms": per_step["matmul_4bit"][1], "at": at},
        {"name": "matmul_int4c", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/int4c.cu",
         "replaces": "quanta_tpu/ops/int4c.py:116", "launches": launches["matmul_int4c"],
         "max_abs_err": max_err["matmul_int4c"], "ms": per_step["matmul_int4c"][0],
         "plain_ms": per_step["matmul_int4c"][1], "at": at},
        {"name": "matmul_int8_fused", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/int8mm.cu",
         "replaces": "quanta_tpu/ops/int8mm.py:167",
         "launches": launches["matmul_int8_fused"], "max_abs_err": max_err["matmul_int8_fused"],
         "ms": per_step["matmul_int8_fused"][0], "plain_ms": per_step["matmul_int8_fused"][1],
         "at": at},
        {"name": "matmul_int8", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/int8mm.cu",
         "replaces": "quanta_tpu/ops/int8mm.py:235", "launches": launches["matmul_int8"],
         "max_abs_err": max_err["matmul_int8"], "ms": per_step["matmul_int8"][0],
         "plain_ms": per_step["matmul_int8"][1], "at": at},
        {"name": "quantize_blockwise", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/quantize.cu",
         "replaces": "quanta_tpu/ops/quantize.py:65",
         "launches": launches["quantize_blockwise"],
         "max_abs_err": max_err["quantize_blockwise"], "ms": q_ms,
         "plain_ms": q_plain_ms,
         "at": "one call at a window's KV write (22 x 8 x 8 x 4 x 64 bf16), ms"},
    ])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
