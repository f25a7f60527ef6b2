"""Time QLoRA train steps of two checkouts of this repository, in turns.

    python -m quanta_tpu_torch.benchmarks.train_ab DIR_A DIR_B [--rounds 2] [--decode nf4a] [--kernels]
        [--serve llm_int8] [--optim] [--closed] [--gemma-f32] [--no-train]

One subprocess a run, in the order A, B, B, A (two rounds), each started in
its checkout's root, so that it imports that checkout's ``quanta_tpu_torch``,
builds that checkout's kernels and measures with that checkout's own
``train_bench.bench_qlora``. The rows (TinyLlama-1.1B and Llama-2-7B, random
weights from seed 0):

- ``tinyllama int8`` and ``tinyllama nf4``: b4 x s512 on an int8 or nf4
  base (``nn.quantize_params``), the ``matmul_8bit`` or ``matmul_4bit``
  pair and the einsum attention;
- ``tinyllama nf4 s1024`` and ``llama2-7b nf4 s1024``: ``train_bench.LONG_ROWS``'
  flash rows (nf4 bases from ``nn.init_quantized_params``).

One JSON line a run: ``{"dir": ..., "run": i, "rows": [...]}``. With
``--decode FMT`` the same order then runs ``decode_bench.measure`` (greedy
decode of the full TinyLlama-1.1B, batch 8, prompt 128, cache 512) on FMT
weights in each checkout: one line ``{"dir": ..., "run": i, "decode":
{...}}`` a run. With ``--kernels`` it first times, in the same order and
through each checkout's own wrappers, ``matmul_4bit_t`` (nf4, bf16 g) at
the TinyLlama-1.1B backward's (K, N) for M = 2048 and Llama-2-7B's for M =
1024, and ``matmul_int4c``, ``matmul_int8_fused`` and ``matmul_int8`` (the
quantizer's codes and outlier set, the operands ``matmul_int8`` hands them)
at the TinyLlama (K, N) for M in {8, 32, 1024} (µs a call, weights rotated
past the 50 MB L2; plus a QLoRA backward's 152 ``matmul_4bit_t`` calls, a
decode step's 155 ``matmul_int4c`` calls and, for each LLM.int8 kernel, a
decode step's 155 calls at M = 8 and a prefill forward's at M = 1024, in
ms): one line ``{"dir": ..., "run": i, "kernels": {...}}`` a run. With
``--serve FMT`` it last runs ``chip_smoke.py``'s timed serve row on FMT
weights (``serve_bench.run_one`` at 11 of 22 layers: 16 Poisson requests
at 24 req/s, 48 new tokens, 8 slots, multi_step 8, and one steady
window's profile): one line ``{"dir": ..., "run": i, "serve": {...}}`` a
run. With ``--optim`` it times the optimizer of the ``tinyllama nf4`` row
(b4 x s512, 8-bit Adam over the 88 adapter leaves): ``opt.step()``'s host
ms between two ``torch.cuda.synchronize()`` calls, over 10 steps after 2
(and, of that, the ms until ``opt.step()`` returns), the same for 10 calls
back to back after the last step (the host's core kept busy, no device
wait before each), its ``adam8bit_update`` launches, and the device
operations and device ms of one profiled ``opt.step()``: one line ``{"dir": ..., "run": i,
"optim": {...}}`` a run. With ``--closed`` it runs ``chip_smoke.py``'s
closed serve trace through the kernels (full TinyLlama-1.1B, llm_int8
weights, int8 KV, 8 requests all submitted at once, 8 slots, multi_step
8), once to warm up and once counted: launches by kernel, windows,
admissions, seconds: one line ``{"dir": ..., "run": i, "closed":
{...}}`` a run. With ``--gemma-f32`` it runs ``chip_smoke.py``'s phase 35
(e) row: QLoRA on an f32 base of Gemma-2B's geometry (``chip_smoke.GEMMA_2B``
in f32, all 18 layers, random weights from seed 0, nf4) at b2 x s1024
through the flash kernels, ``train_bench.bench_qlora``'s row: one line
``{"dir": ..., "run": i, "gemma_f32": {...}}`` a run. ``--no-train``
leaves the train rows out. Comparing two versions holds only within one
call, on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROWS = ("tinyllama nf4 s1024", "llama2-7b nf4 s1024")

CHILD = """
import json, torch
from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import train_bench
from quanta_tpu_torch.models import llama
dev = torch.device("cuda")
cfg = llama.LlamaConfig.tinyllama_1b()
dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
rows = []
for fmt in ("int8", "nf4"):
    base = qnn.quantize_params(dense, mode=fmt)
    rows.append({"name": f"tinyllama {fmt}", **train_bench.bench_qlora(base, cfg)})
    del base
del dense
for name, model, batch, seq, use_flash, warmup, steps in train_bench.LONG_ROWS:
    if name not in %r:
        continue
    torch.cuda.empty_cache()
    cfg = train_bench.model_config(model)
    base = qnn.init_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg,
                                     mode="nf4", device=dev)
    rows.append({"name": name, **train_bench.bench_qlora(base, cfg, batch=batch, seq=seq,
                                                         use_flash=use_flash, warmup=warmup,
                                                         steps=steps)})
    del base
print(json.dumps(rows))
"""


DECODE_CHILD = """
import json, torch
from quanta_tpu_torch.benchmarks import decode_bench
from quanta_tpu_torch.models import llama
dev = torch.device("cuda")
cfg = llama.LlamaConfig.tinyllama_1b()
dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
print(json.dumps(decode_bench.measure(decode_bench.quantized(dense, %r), cfg)))
"""


SERVE_CHILD = """
import dataclasses, json, torch
from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import serve_bench
from quanta_tpu_torch.models import llama
dev = torch.device("cuda")
cfg = llama.LlamaConfig.tinyllama_1b()
dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
params = qnn.quantize_params(dense, mode=%r)
del dense
cfg = dataclasses.replace(cfg, n_layers=11)
params = {**params, "layers": params["layers"][:11]}
m = serve_bench.run_one(params, cfg, fmt_name=%r, n_requests=16, rate=24.0, max_new=48,
                        n_slots=8, multi_step=8)
m["window"] = serve_bench.window_profile(params, cfg, multi_step=8)
print(json.dumps({k: m[k] for k in ("throughput_tok_s", "ttft_p50_ms", "ttft_p99_ms",
                                    "serve_seconds", "window")}))
"""


OPTIM_CHILD = """
import json, statistics, time, torch
from torch.profiler import ProfilerActivity, profile
from quanta_tpu_torch import nn as qnn, train
from quanta_tpu_torch.benchmarks import train_bench
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.optim import Adam8bit
dev = torch.device("cuda")
cfg = llama.LlamaConfig.tinyllama_1b()
dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
base = qnn.quantize_params(dense, mode="nf4")
del dense
params = train_bench.with_lora(base)
opt = Adam8bit(qnn.lora_parameters(params), lr=1e-4)
data = train_bench.make_batch(cfg, 4, 512, dev)
host_ms, enqueue_ms, launches, prof = [], [], [], {}
optimizer_step = opt.step
def timed_step():
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    if prof.get("on"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            optimizer_step()
            torch.cuda.synchronize()
        ev = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        prof.update(device_ops=len(ev), device_ms=sum(e.time_range.elapsed_us() for e in ev) / 1e3)
        return
    optimizer_step()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    host_ms.append((time.perf_counter() - t0) * 1e3)
    enqueue_ms.append((t1 - t0) * 1e3)
    launches.append(_build.launches["adam8bit_update"])
opt.step = timed_step
step = train.make_qlora_train_step(cfg, opt)
for _ in range(12):
    step(params, data)
steps = len(host_ms)
for _ in range(10):  # back to back, the gradients of the last step, no device wait before
    timed_step()
back_to_back = host_ms[steps:]
del host_ms[steps:], enqueue_ms[steps:]
for _ in range(2):  # the first profile of a process pays the tracer's start-up
    prof["on"] = True
    step(params, data)
print(json.dumps({"opt_step_host_ms": statistics.median(host_ms[2:]),
                  "opt_step_host_ms_all": host_ms[2:],
                  "opt_step_enqueue_ms": statistics.median(enqueue_ms[2:]),
                  "opt_step_back_to_back_ms": statistics.median(back_to_back),
                  "adam8bit_update_launches": launches[-1],
                  "opt_step_device_ops": prof["device_ops"],
                  "opt_step_device_ms": prof["device_ms"]}))
"""


CLOSED_CHILD = """
import json, time, torch
from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import serve_bench
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.serve import Engine, Request
dev = torch.device("cuda")
cfg = llama.LlamaConfig.tinyllama_1b()
dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
params = qnn.quantize_params(dense, mode="llm_int8")
del dense
trace = serve_bench.make_trace(8, 24.0, serve_bench.MAX_PROMPT, 16, cfg.vocab_size, seed=0)
for run in range(2):
    eng = Engine(params, cfg, n_slots=8, page_size=16,
                 prefill_buckets=serve_bench.PREFILL_BUCKETS, kv_quant=True, multi_step=8)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16) for i, (_, p) in enumerate(trace)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
m = eng.metrics()
print(json.dumps({"launches": {k: v for k, v in _build.launches.items() if v},
                  "windows": m["decode_steps"], "admissions": m["admissions"],
                  "seconds": seconds, "tokens": sum(len(r.output) for r in done)}))
"""


KERNEL_CHILD = """
import json, math, torch
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.ops import int4c, int8mm, matmul
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device=dev).manual_seed(0)
def time_us(fn, iters):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**8)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters * 1e3
def copies(*ts):
    n = sum(t.numel() * t.element_size() for t in ts)
    return [tuple(t.clone() for t in ts) for _ in range(min(64, max(1, math.ceil(2 * 50 * 2**20 / n))))]
t_shapes = {(2048, 2048): 43, (2048, 256): 42, (2048, 5632): 44, (5632, 2048): 22, (2048, 32000): 1}
shapes = {(2048, 2048): 44, (2048, 256): 44, (2048, 5632): 44, (5632, 2048): 22, (2048, 32000): 1}
res = {"matmul_4bit_t": {}, "matmul_int4c": {}, "backward_ms": 0.0, "decode_step_ms": 0.0}
for (k, n), m in [(s, 2048) for s in t_shapes] + [((4096, 4096), 1024), ((4096, 11008), 1024),
                                                    ((11008, 4096), 1024)]:
    w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
    qt = codecs.quantize_matmul_weight(w, fmt="nf4", block_size=64)
    g = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
    ws = copies(qt.codes, qt.scale)
    us = time_us(lambda i: matmul.matmul_4bit_t(g, *ws[i % len(ws)], codebook="nf4"), 10)
    res["matmul_4bit_t"][f"M{m}_{k}x{n}"] = us
    res["backward_ms"] += t_shapes.get((k, n), 0) * us / 1e3 if m == 2048 else 0.0
for (k, n), count in shapes.items():
    qw = int4c.quantize_int4c_weight((torch.randn((k, n), generator=gen, device=dev)
                                      / math.sqrt(k)).to(torch.bfloat16))
    ws = copies(qw.codes, qw.scale)
    for m in (8, 32, 1024):
        x = torch.randn((m, k), generator=gen, device=dev)
        rs = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
        xq = torch.clamp(torch.round(x / rs[:, None]), -127, 127).to(torch.int8)
        us = time_us(lambda i: int4c.matmul_int4c_kernel(xq, ws[i % len(ws)][0], rs,
                                                         ws[i % len(ws)][1]),
                     50 if m <= 32 else 10)
        res["matmul_int4c"][f"M{m}_{k}x{n}"] = us
        res["decode_step_ms"] += count * us / 1e3 if m == 8 else 0.0
for name in ("matmul_int8_fused", "matmul_int8"):
    res[name] = {}
    res[name + "_decode_step_ms"] = res[name + "_prefill_forward_ms"] = 0.0
for (k, n), count in shapes.items():
    qw = int8mm.quantize_int8_weight((torch.randn((k, n), generator=gen, device=dev)
                                      / math.sqrt(k)).to(torch.bfloat16))
    ws = copies(qw.codes, qw.scale)
    for m in (8, 32, 1024):
        x = torch.randn((m, k), generator=gen, device=dev)
        x[:, qw.outlier_idx[:4].long()] *= 20.0
        y_out = x.index_select(1, qw.outlier_idx) @ qw.w_outlier.float()
        xa = x.abs()
        xa[:, qw.outlier_idx] = 0.0
        rs = torch.clamp(xa.amax(dim=1) / 127.0, min=1e-12)
        xq = int8mm.quantize_rows(x, rs)
        calls = {"matmul_int8_fused": lambda c, s: int8mm.matmul_int8_fused(x, c, rs, s, y_out),
                 "matmul_int8": lambda c, s: int8mm.matmul_int8_kernel(xq, c, rs, s)}
        for name, call in calls.items():
            us = time_us(lambda i: call(*ws[i % len(ws)]), 50 if m <= 32 else 10)
            res[name][f"M{m}_{k}x{n}"] = us
            step = {8: "_decode_step_ms", 1024: "_prefill_forward_ms"}.get(m)
            if step:
                res[name + step] += count * us / 1e3
print(json.dumps(res))
"""


GEMMA_F32_CHILD = """
import dataclasses, json, torch
from chip_smoke import GEMMA_2B
from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.benchmarks import train_bench
from quanta_tpu_torch.models import llama
dev = torch.device("cuda")
cfg = dataclasses.replace(llama.LlamaConfig(**GEMMA_2B), dtype=torch.float32)
dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
base = qnn.quantize_params(dense, mode="nf4")
del dense
torch.cuda.empty_cache()
print(json.dumps(train_bench.bench_qlora(base, cfg, batch=2, seq=1024)))
"""


def run_one(root: str, script: str) -> list[dict] | dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"train_ab: run in {root} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--rounds", type=int, default=2, help="A, B, B, A per two rounds")
    ap.add_argument("--decode", metavar="FMT", help="then decode_bench on FMT weights")
    ap.add_argument("--kernels", action="store_true",
                    help="first time matmul_4bit_t, matmul_int4c and the LLM.int8 pair "
                         "in each checkout")
    ap.add_argument("--serve", metavar="FMT", help="last the timed serve row on FMT weights")
    ap.add_argument("--optim", action="store_true",
                    help="then time opt.step() of the tinyllama nf4 row")
    ap.add_argument("--closed", action="store_true",
                    help="then count the closed serve trace's launches")
    ap.add_argument("--gemma-f32", action="store_true",
                    help="then the QLoRA row on an f32 base of Gemma-2B's geometry")
    ap.add_argument("--no-train", action="store_true", help="leave the train rows out")
    args = ap.parse_args(argv)
    order = [args.dir_a, args.dir_b]
    jobs = [("kernels", KERNEL_CHILD)] if args.kernels else []
    if not args.no_train:
        jobs.append(("rows", CHILD % (ROWS,)))
    if args.decode:
        jobs.append(("decode", DECODE_CHILD % args.decode))
    if args.optim:
        jobs.append(("optim", OPTIM_CHILD))
    if args.closed:
        jobs.append(("closed", CLOSED_CHILD))
    if args.gemma_f32:
        jobs.append(("gemma_f32", GEMMA_F32_CHILD))
    if args.serve:
        jobs.append(("serve", SERVE_CHILD % (args.serve, args.serve)))
    for key, script in jobs:
        for i in range(args.rounds):
            for root in (order if i % 2 == 0 else order[::-1]):
                res = run_one(os.path.abspath(root), script)
                print(json.dumps({"dir": root, "run": i, key: res}), flush=True)


if __name__ == "__main__":
    main()
