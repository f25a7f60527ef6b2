"""Time QLoRA train steps of two checkouts of this repository, in turns.

    python -m quanta_tpu_torch.benchmarks.train_ab DIR_A DIR_B [--rounds 2] [--decode nf4a]

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
{...}}`` a run. Comparing two versions holds only within one call, on one
card.
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
    args = ap.parse_args(argv)
    order = [args.dir_a, args.dir_b]
    jobs = [("rows", CHILD % (ROWS,))]
    if args.decode:
        jobs.append(("decode", DECODE_CHILD % args.decode))
    for key, script in jobs:
        for i in range(args.rounds):
            for root in (order if i % 2 == 0 else order[::-1]):
                res = run_one(os.path.abspath(root), script)
                print(json.dumps({"dir": root, "run": i, key: res}), flush=True)


if __name__ == "__main__":
    main()
