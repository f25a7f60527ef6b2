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
     cache 512 for every format, and the device-busy share of a step;
  9. QLoRA training at the full TinyLlama-1.1B width and depth: (a)
     ``matmul_4bit_t`` against its plain version at the five (K, N) with
     M = 2048 (batch 4 x seq 512), bf16 gradients, nf4 and nf4a, plus one
     f32 shape, within 2 bf16 ulps of max|plain| (f32: 1e-5); (b)
     ``adam8bit_update`` bit for bit over 5 chained steps at the adapter
     leaf sizes (64 and 8 blocks) and one full-parameter leaf (45,056
     blocks), one block all zero; (c) 3 QLoRA steps (nf4 base, rank-8 bf16
     LoRA on wq and wv, 8-bit Adam at lr 1e-3, one fixed batch) through
     the kernels and 3 through ``use_kernel=False`` from the same
     adapters, and one step through plain versions that sum in another
     order (the floor bf16 rounding sets): step-1 loss within 1e-2
     relative, step-1 lora_b gradients tensor by tensor within 1.5 times
     that tensor's own floor plus 2e-3 rel-L2 (``GRAD_FLOOR_X`` says why),
     lora_a gradients zero, the step-3
     loss below step 1's on both routes, and per kernel-route step 155
     ``matmul_4bit``, 152 ``matmul_4bit_t`` (layer 0's wq, wk and wv read
     the frozen embedding and need no dx) and 88 ``adam8bit_update`` (one
     per adapter tensor); (d) the timed ``train_bench`` rows, nf4, nf4a
     and the bf16-base control, and the 8-bit Adam bytes.

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
from quanta_tpu_torch import train
from quanta_tpu_torch.benchmarks import decode_bench, serve_bench, train_bench
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.metrics import MetricsRecorder
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build, adam8bit, int4c, int8mm, matmul, quantize
from quanta_tpu_torch.optim import Adam8bit
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
# QLoRA training: batch x seq rows per linear; the (K, N) of the linears
# whose input needs a gradient and their count in one backward (all but
# layer 0's wq, wk and wv, which read the frozen embedding)
TRAIN_BATCH, TRAIN_SEQ = 4, 512
M_TRAIN = TRAIN_BATCH * TRAIN_SEQ
T_SHAPES = {(2048, 2048): 2 * 22 - 1, (2048, 256): 2 * 22 - 2, (2048, 5632): 2 * 22,
            (5632, 2048): 22, (2048, 32000): 1}
PER_BACKWARD = sum(T_SHAPES.values())  # 152
# adapter leaves per step by blocks of 256: A of wq and wv and B of wq
# (2048 x 8 or 8 x 2048: 64 blocks), B of wv (8 x 256: 8 blocks)
ADAM_LEAVES = {64: 3 * 22, 8: 22}
ADAM_BLOCKS = {"adapter_64": 64, "adapter_8": 8, "w_up_2048x5632": 2048 * 5632 // 256}
TRAIN_LR = 1e-3  # the reference's own QLoRA step test (tests/test_parallel.py:99)
# step-1 lora_b gradients, kernel route against plain, rel-L2 per tensor,
# each held to the floor that the plain route summed in another order
# (``reordered_plain``) sets for that same tensor in the same run: at most
# GRAD_FLOOR_X times it plus GRAD_FLOOR_ABS. The floor runs from ~0.009
# (deep wv) to ~0.03 (wq, whose gradient passes the softmax backward, where
# near-flat attention over random weights amplifies 1-ulp differences in
# dx), so one global bound would be loose on the quiet tensors.
GRAD_FLOOR_X, GRAD_FLOOR_ABS = 1.5, 2e-3


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


def transposed_checks(dev):
    """matmul_4bit_t at the backward's shapes (M = 2048), bf16 g in nf4 and
    nf4a within 2 bf16 ulps of max|plain|, and one f32 shape; µs per call
    with the weights rotated past the L2. Returns one backward's calls
    (nf4) in ms, kernel and plain, and the largest error."""
    gen = torch.Generator(device=dev).manual_seed(4)
    per_step, max_err = [0.0, 0.0], 0.0
    cases = [(k, n, fmt, torch.bfloat16) for (k, n) in T_SHAPES for fmt in ("nf4", "nf4a")]
    cases.append((2048, 5632, "nf4", torch.float32))
    for k, n, fmt, dtype in cases:
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
        g = torch.randn((M_TRAIN, n), generator=gen, device=dev).to(dtype)

        def run(use_kernel, ws):
            return lambda i: matmul.matmul_4bit_t(g, *ws[i % len(ws)], codebook=fmt, block=64,
                                                  use_kernel=use_kernel)
        out = run(True, [(qt.codes, qt.scale)])(0)
        ref = run(False, [(qt.codes, qt.scale)])(0)
        err = (out.float() - ref.float()).abs().max().item()
        rel = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
        tol = rel * ref.float().abs().max().item()
        check(out.shape == (M_TRAIN, qt.codes.shape[0] * 2) and torch.isfinite(out).all().item(),
              f"matmul_4bit_t {fmt} K={k} N={n}: bad output")
        check(err <= tol, f"matmul_4bit_t {fmt} {dtype} K={k} N={n}: err {err} > {tol}")
        ws = copies_past_l2(qt.codes, qt.scale)
        ms, plain_ms = time_ms(run(True, ws), 10), time_ms(run(False, ws), 10)
        max_err = max(max_err, err)
        if fmt == "nf4" and dtype == torch.bfloat16:
            per_step[0] += T_SHAPES[(k, n)] * ms
            per_step[1] += T_SHAPES[(k, n)] * plain_ms
        emit(kernel_check=dict(kernel="matmul_4bit_t", fmt=fmt, dtype=str(dtype), M=M_TRAIN,
                               K=k, N=n, max_abs_err=err, tol=tol, us=ms * 1e3,
                               plain_us=plain_ms * 1e3,
                               tflops=2 * M_TRAIN * k * n / (ms * 1e-3) / 1e12))
    return per_step, max_err


def adam_checks(dev):
    """adam8bit_update over 5 chained steps, kernel and plain version each
    feeding itself from the same zero state and gradients, one block all
    zero: bit for bit. µs per call at each leaf size, inputs rotated past
    the L2. Returns one step's 88 adapter calls in ms, kernel and plain,
    and the largest difference over all five outputs, sizes and steps."""
    gen = torch.Generator(device=dev).manual_seed(5)
    lr = torch.tensor(TRAIN_LR, device=dev)  # on the device, as the optimizer passes it
    times, max_err = {}, 0.0
    for name, nb in ADAM_BLOCKS.items():
        leaf_err = 0.0
        state = {uk: [torch.zeros((nb, 256), dtype=torch.int8, device=dev),
                      torch.full((nb, 1), 1e-12, device=dev),
                      torch.zeros((nb, 256), dtype=torch.uint8, device=dev),
                      torch.full((nb, 1), 1e-12, device=dev)] for uk in (True, False)}
        for step in range(1, 6):
            g = torch.randn((nb, 256), generator=gen, device=dev) * 1e-3
            g[0] = 0.0
            count = torch.tensor(float(step), device=dev)
            bc1, bc2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
            outs = {uk: adam8bit.adam8bit_update(g, *state[uk], lr, bc1, bc2, use_kernel=uk)
                    for uk in (True, False)}
            same = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(outs[True], outs[False]))
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(outs[True], outs[False]))
            leaf_err = max(leaf_err, err)
            check(same, f"adam8bit_update {name} step {step} not bit-exact: err {err}")
            check(torch.count_nonzero(outs[True][0][0]).item() == 0,
                  f"adam8bit_update {name}: the all-zero block moved")
            state = {uk: list(outs[uk][1:]) for uk in (True, False)}
        xs = copies_past_l2(g, *state[True])

        def run(uk):
            return lambda i: adam8bit.adam8bit_update(*xs[i % len(xs)], lr, bc1, bc2,
                                                      use_kernel=uk)
        ms, plain_ms = time_ms(run(True), 100), time_ms(run(False), 100)
        times[nb] = (ms, plain_ms)
        max_err = max(max_err, leaf_err)
        emit(kernel_check=dict(kernel="adam8bit_update", leaf=name, blocks=nb, steps=5,
                               max_abs_err=leaf_err, tol=0.0, us=ms * 1e3,
                               plain_us=plain_ms * 1e3))
    per_step = [sum(n * times[nb][i] for nb, n in ADAM_LEAVES.items()) for i in (0, 1)]
    return per_step, max_err


def reordered_plain():
    """Patches that make the plain versions of matmul_4bit and
    matmul_4bit_t sum in another order (the reduction split in two
    halves, each an f32 GEMM, the halves added in f32): the spread
    between the plain route and this one is the floor that bf16 rounding
    sets for any two valid orders."""
    def fwd(x, codes, scales, *, codebook="nf4a", block=64, out_dtype=None):
        x = matmul._pad_k(x, 2 * codes.shape[0])
        w = matmul._dequant_4bit(codes, scales, codebook, block, x.dtype).float()
        h = w.shape[0] // 2
        out = x[:, :h].float() @ w[:h] + x[:, h:].float() @ w[h:]
        return out.to(out_dtype or x.dtype)

    def bwd(g, codes, scales, *, codebook="nf4a", block=64, out_dtype=None):
        g = matmul._pad_n(g, codes.shape[1])
        w = matmul._dequant_4bit(codes, scales, codebook, block, g.dtype).float()
        h = w.shape[1] // 2
        out = g[:, :h].float() @ w[:, :h].T + g[:, h:].float() @ w[:, h:].T
        return out.to(out_dtype or g.dtype)

    return (mock.patch.object(matmul, "matmul_4bit_reference", fwd),
            mock.patch.object(matmul, "matmul_4bit_t_reference", bwd))


def _adapter_grads(adapters):
    """(A, B) gradients in f32 of every adapter, layer by layer, wq then wv."""
    return [(ad[n]["a"].grad.float(), ad[n]["b"].grad.float())
            for ad in adapters for n in ("wq", "wv")]


def qlora_path(dev, cfg, base):
    """3 QLoRA steps through the kernels and 3 through the plain versions,
    from the same adapters on one fixed batch, launches counted per step;
    then one step through the reordered plain versions (the noise floor).
    Returns the kernel route's launches."""
    data = train_bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    init = train_bench.with_lora(base)
    per_forward = 7 * cfg.n_layers + 1
    runs = {}
    for route in (None, False, "reordered"):
        adapters = [{k: {ab: t.detach().clone().requires_grad_() for ab, t in v.items()}
                     for k, v in ad.items()} for ad in train.extract_adapters(init)]
        params = train.merge_adapters(init, adapters)
        use_kernel = None if route is None else False
        opt = Adam8bit(qnn.lora_parameters(params), lr=TRAIN_LR, use_kernel=use_kernel)
        step = train.make_qlora_train_step(cfg, opt, use_kernel=use_kernel)
        if route == "reordered":
            fwd_patch, bwd_patch = reordered_plain()
            with fwd_patch, bwd_patch:
                runs[route] = ([step(params, data).item()], _adapter_grads(adapters))
            continue
        losses, counts, seconds = [], [], []
        for i in range(3):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            losses.append(step(params, data).item())
            seconds.append(time.perf_counter() - t0)
            counts.append(dict(_build.launches))
            if i == 0:
                grads = _adapter_grads(adapters)
        expected = dict.fromkeys(_build.launches, 0)
        if route is None:
            expected.update(matmul_4bit=per_forward, matmul_4bit_t=PER_BACKWARD,
                            adam8bit_update=4 * cfg.n_layers)
        for i, c in enumerate(counts):
            check(c == expected, f"qlora route {route} step {i + 1}: launches {c}, "
                                 f"expected {expected}")
        check(all(math.isfinite(v) for v in losses), f"qlora route {route}: losses {losses}")
        check(losses[2] < losses[0], f"qlora route {route}: loss did not fall: {losses}")
        runs[route] = (losses, grads)
        if route is None:
            kernel_launches = {k: sum(c[k] for c in counts) for k in expected}
        emit(qlora_path=dict(route="kernels" if route is None else "plain", lr=TRAIN_LR,
                             losses=losses, step_seconds=seconds, launches_per_step=counts[0]))
    (lk, gk), (lp, gp), (lr_, gr) = runs[None], runs[False], runs["reordered"]
    loss_rel = abs(lk[0] - lp[0]) / abs(lp[0])
    check(loss_rel <= 1e-2, f"qlora step-1 loss {lk[0]} vs plain {lp[0]}")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    b_rel, floor = [], []
    for (ak, bk), (ap, bp), (_, br) in zip(gk, gp, gr):
        check(torch.count_nonzero(ak).item() == 0 and torch.count_nonzero(ap).item() == 0,
              "qlora: lora_a gradients must be zero at step 1 (B starts at zero)")
        b_rel.append(rel(bk, bp))
        floor.append(rel(br, bp))
    tols = [GRAD_FLOOR_X * f + GRAD_FLOOR_ABS for f in floor]
    emit(qlora_check=dict(step1_loss_rel=loss_rel, tol=1e-2, lora_b_grad_rel_l2_max=max(b_rel),
                          lora_b_grad_rel_l2=b_rel, grad_tols=tols,
                          reordered_plain_loss_rel=abs(lr_[0] - lp[0]) / abs(lp[0]),
                          reordered_plain_rel_l2_max=max(floor), reordered_plain_rel_l2=floor))
    for i, (b, tol) in enumerate(zip(b_rel, tols)):
        check(b <= tol, f"qlora layer {i // 2} {('wq', 'wv')[i % 2]} lora_b gradient "
                        f"rel-L2 {b} > {tol} ({GRAD_FLOOR_X} x its floor + {GRAD_FLOOR_ABS})")
    return kernel_launches


def train_rows(cfg, bases):
    for name, fmt in train_bench.ROWS:
        row = train_bench.bench_qlora(bases[fmt], cfg)
        check(math.isfinite(row["loss_step1"]), f"train row {name}: loss {row['loss_step1']}")
        emit(train_row={"name": name, "fmt": fmt, **row})
    emit(adam_bytes=train_bench.adam_bytes(cfg))


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

    t_step, max_err["matmul_4bit_t"] = transposed_checks(dev)
    adam_step, max_err["adam8bit_update"] = adam_checks(dev)
    train_launches = qlora_path(dev, cfg, params["nf4"])
    launches["matmul_4bit"] += train_launches["matmul_4bit"]
    train_rows(cfg, {"nf4": params["nf4"], "nf4a": params["nf4a"], "bf16": dense})

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
        {"name": "matmul_4bit_t", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/matmul_4bit_t.cu",
         "replaces": "quanta_tpu/ops/matmul.py:423",
         "launches": train_launches["matmul_4bit_t"], "max_abs_err": max_err["matmul_4bit_t"],
         "ms": t_step[0], "plain_ms": t_step[1],
         "at": "one QLoRA backward's 152 calls at M=2048, bf16 g, nf4, ms"},
        {"name": "adam8bit_update", "route": "cuda",
         "source": "quanta_tpu_torch/csrc/adam8bit.cu",
         "replaces": "quanta_tpu/ops/adam8bit.py:72",
         "launches": train_launches["adam8bit_update"],
         "max_abs_err": max_err["adam8bit_update"],
         "ms": adam_step[0], "plain_ms": adam_step[1],
         "at": "one QLoRA step's 88 adapter calls (66 of 64 blocks, 22 of 8), ms"},
    ])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
