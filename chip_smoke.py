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
  4. the main path at the full TinyLlama-1.1B geometry (22 layers, random
     bf16 weights from seed 0) in bf16, nf4a, nf4 and int4c: greedy decode
     of 8 prompts of 128 tokens for 32 new tokens, with the launch counts of
     each kernel reset just before and read just after; then prefill
     logits and tokens of the kernel path against ``use_kernel=False``;
  5. decode tok/s, prefill tok/s and TTFT at batch 8 / prompt 128 /
     cache 512, and the device-busy share of a decode step.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.
There is no CPU path: without a CUDA device the script fails.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from quanta_tpu_torch.benchmarks import decode_bench
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build, int4c, matmul

# (K, N) of the TinyLlama-1.1B linears and their count in one forward
SHAPES = {(2048, 2048): 2 * 22, (2048, 256): 2 * 22, (2048, 5632): 2 * 22,
          (5632, 2048): 22, (2048, 32000): 1}
L2_BYTES = 50 * 2**20
BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
NF4_REL_L2 = 3e-2


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters):
    """Mean device time of one call: CUDA events around ``iters`` calls,
    after warm-up. ``fn(i)`` takes the call index."""
    for i in range(3):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    launches = {"matmul_4bit": 0, "matmul_int4c": 0}
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

    cfg = llama.LlamaConfig.tinyllama_1b()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params, launches = main_path(dev, cfg, dense)

    for fmt, p in params.items():
        r = decode_bench.measure(p, cfg)
        emit(bench={"fmt": fmt, "batch": 8, "prefill_len": 128, "cache_len": 512, **r})
    emit(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    at = "one decode step's calls at M=8 (nf4a for matmul_4bit), ms"
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
    ])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
