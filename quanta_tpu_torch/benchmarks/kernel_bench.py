"""Per-kernel microbenchmark: the quantized matmul kernels against dense
bf16 (port of ``quanta_tpu/benchmarks/kernel_bench.py:102-245``).

Cells, at TinyLlama-1.1B's four projection shapes (2048 x 2048, 2048 x
5632, 5632 x 2048, 2048 x 32000; ``--shapes`` picks Llama-2-13B's, or
the local shapes of its tensor-parallel shards at tp = 2, the
row-parallel ones per output chunk) and M in {8, 128}, bf16 x:

  - dense bf16: cuBLAS ``torch.matmul``, the control;
  - nf4a, nf4, int4 through ``matmul_4bit`` (#1), int8 through
    ``matmul_8bit`` (#3), each by ``ops.matmul.matmul_quantized``, blocks
    of 64;
  - llm_int8 (``ops.int8mm.matmul_int8``) through its fused kernel
    (#6), through its unfused route (x quantized beforehand, then
    ``matmul_int8``, #7) and through its plain route;
  - int4c (``ops.int4c.matmul_int4c``, #2).

Timing (not the TPU's scan-slope protocol): CUDA events around calls
queued while the device spins (:func:`time_ms`), the weights rotated
through copies that together exceed the 50 MB L2 (:func:`copies_past_l2`),
so each call streams its weight from device memory as a layer of a model
does. ``chip_smoke.py`` times its kernels with the same two helpers.

Each cell gives µs per call, its speedup over dense bf16 and its share of
``profiling.matmul_roofline`` on the H100 row (the JAX bench's formula:
activations, the packed weight, its block scales and the output over the
memory rate; 2MKN over the bf16 peak). A reading above 105% of that
roofline is a measurement fault and raises.

    python -m quanta_tpu_torch.benchmarks.kernel_bench [--m 8 128] [--out table.md]
        [--shapes tinyllama llama2-13b llama2-13b-tp2]

prints one JSON line a cell; markdown goes only to ``--out``. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import torch

from quanta_tpu_torch import profiling
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.ops import int4c, int8mm, matmul

SHAPES = (("qkv/o proj", 2048, 2048), ("gate/up", 2048, 5632), ("down", 5632, 2048),
          ("lm_head", 2048, 32000))
SHAPE_SETS = {
    "tinyllama": SHAPES,
    "llama2-13b": (("qkv/o proj", 5120, 5120), ("gate/up", 5120, 13824),
                   ("down", 13824, 5120), ("lm_head", 5120, 32000)),
    # one rank's shards at tp = 2: column-split N halves; row-split K
    # halves, each output chunk 2560 wide (``parallel.tp``'s two chunks)
    "llama2-13b-tp2": (("qkv shard", 5120, 2560), ("gate/up shard", 5120, 6912),
                       ("o chunk", 2560, 2560), ("down chunk", 6912, 2560),
                       ("lm_head shard", 5120, 16000)),
}
MS = (8, 128)
BLOCK = 64
ROOFLINE_LIMIT_PCT = 105.0
# cell -> (format, route, kernel it launches, weight bits, block scales)
CELLS = {
    "dense bf16": ("bf16", None, None, 16, False),
    "nf4a": ("nf4a", None, "matmul_4bit", 4, True),
    "nf4": ("nf4", None, "matmul_4bit", 4, True),
    "int4": ("int4", None, "matmul_4bit", 4, True),
    "int8": ("int8", None, "matmul_8bit", 8, True),
    "llm_int8": ("llm_int8", "fused", "matmul_int8_fused", 8, False),
    "llm_int8 unfused": ("llm_int8", "unfused", "matmul_int8", 8, False),
    "llm_int8 plain": ("llm_int8", "plain", None, 8, False),
    "int4c": ("int4c", None, "matmul_int4c", 4, False),
}
L2_BYTES = 50 * 2**20
SLEEP_CYCLES = 10**8  # ~50 ms of SM clock


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


def roofline(cell: str, m: int, k: int, n: int) -> profiling.Roofline:
    """The cell's roofline on the H100 row."""
    _, _, _, bits, blockwise = CELLS[cell]
    return profiling.matmul_roofline(m, k, n, weight_bits=bits,
                                     block_size=BLOCK if blockwise else 0, device=profiling.H100)


def _caller(cell: str, x: torch.Tensor, w: torch.Tensor):
    """``fn(i)`` for ``time_ms``: the cell's call on weight copy ``i``."""
    fmt, route, _, _, _ = CELLS[cell]
    if fmt == "bf16":
        ws = copies_past_l2(w.to(torch.bfloat16))
        return lambda i: x @ ws[i % len(ws)][0]
    if fmt == "llm_int8":
        qw = int8mm.quantize_int8_weight(w)
        ws = copies_past_l2(qw.codes)
        kw = {"fused": dict(fused=True), "unfused": dict(fused=False),
              "plain": dict(use_kernel=False)}[route]
        return lambda i: int8mm.matmul_int8(x, dataclasses.replace(qw, codes=ws[i % len(ws)][0]),
                                            **kw)
    if fmt == "int4c":
        qw = int4c.quantize_int4c_weight(w)
        ws = copies_past_l2(qw.codes)
        return lambda i: int4c.matmul_int4c(x, dataclasses.replace(qw, codes=ws[i % len(ws)][0]))
    qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=BLOCK)
    ws = copies_past_l2(qt.codes, qt.scale)
    return lambda i: matmul.matmul_quantized(
        x, dataclasses.replace(qt, codes=ws[i % len(ws)][0], scale=ws[i % len(ws)][1]))


def cell_row(cell: str, m: int, k: int, n: int, us: float, dense_us: float,
             shape: str = "") -> dict:
    """A cell's row from its µs per call and dense bf16's at the same
    shape; raises when the reading exceeds ``ROOFLINE_LIMIT_PCT`` of the
    roofline (the physics says it cannot: the timing is at fault)."""
    rl = roofline(cell, m, k, n)
    pct = rl.pct(us * 1e-6)
    if pct > ROOFLINE_LIMIT_PCT:
        raise RuntimeError(f"kernel_bench: {cell} at M={m} K={k} N={n} reads {pct:.1f}% of its "
                           f"roofline ({us:.3f} µs against {rl.t_roofline_s * 1e6:.3f}): a "
                           "measurement fault")
    return {"M": m, "K": k, "N": n, "shape": shape, "cell": cell, "kernel": CELLS[cell][2],
            "us": us, "speedup_vs_dense": dense_us / us, "pct_roofline": pct,
            "roofline_us": rl.t_roofline_s * 1e6,
            "bound_by": "bytes" if rl.t_memory_s >= rl.t_compute_s else "operations"}


@torch.no_grad()
def run(ms=MS, shapes=SHAPES, cells=tuple(CELLS), seed: int = 0) -> list[dict]:
    """One row a cell (:func:`cell_row`), dense bf16 timed first at each
    shape."""
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench measures a CUDA device and found none")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for m in ms:
        for label, k, n in shapes:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            dense_us = time_ms(_caller("dense bf16", x, w), 50 if m <= 16 else 20) * 1e3
            for cell in cells:
                us = dense_us if cell == "dense bf16" else time_ms(
                    _caller(cell, x, w), 50 if m <= 16 else 20) * 1e3
                rows.append(cell_row(cell, m, k, n, us, dense_us, label))
    return rows


def markdown(rows: list[dict], device: str) -> str:
    cells = list(dict.fromkeys(r["cell"] for r in rows))
    lines = ["# Kernel microbenchmark: quantized matmuls against dense bf16", "",
             f"Device: {device}; CUDA events, weights rotated past the L2; each cell "
             "µs per call (speedup over dense bf16, % of the H100 roofline).", ""]
    for m in dict.fromkeys(r["M"] for r in rows):
        lines += [f"## M = {m}", "", "| K x N | " + " | ".join(cells) + " |",
                  "|---|" + "---|" * len(cells)]
        for label, k, n in dict.fromkeys((r["shape"], r["K"], r["N"]) for r in rows
                                         if r["M"] == m):
            by = {r["cell"]: r for r in rows if (r["M"], r["K"], r["N"]) == (m, k, n)}
            lines.append(f"| {label} {k}x{n} | " + " | ".join(
                f"{by[c]['us']:.1f} µs ({by[c]['speedup_vs_dense']:.2f}x, "
                f"{by[c]['pct_roofline']:.0f}%)" for c in cells) + " |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=list(MS))
    ap.add_argument("--shapes", nargs="+", default=["tinyllama"], choices=list(SHAPE_SETS))
    ap.add_argument("--out", help="also write the markdown table here")
    args = ap.parse_args(argv)
    rows = run(ms=args.m, shapes=[s for name in args.shapes for s in SHAPE_SETS[name]])
    for r in rows:
        print(json.dumps({"kernel_bench": r}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(markdown(rows, torch.cuda.get_device_name(0)))
        print(f"wrote {args.out}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
