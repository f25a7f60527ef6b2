"""Time the bf16 ``flash_fwd``, ``matmul_8bit``, ``matmul_4bit``,
``matmul_8bit_t`` and ``matmul_4bit_t`` kernels, ``matmul_int4c`` and the
LLM.int8 pair across shapes.

    python -m quanta_tpu_torch.benchmarks.kernel_sweep [--what flash mm8 mm4 mm8t mm4t i4c i8] [--ms 8 32]

To try a design choice of ``csrc/flash_fwd.cu``, ``csrc/matmul_8bit.cu``,
``csrc/matmul_4bit.cu``, ``csrc/matmul_8bit_t.cu``, ``csrc/matmul_4bit_t.cu``,
``csrc/int4c.cu`` or ``csrc/int8mm.cu`` (warpgroups, ring stages, the
decode/prefill split, the tile widths), edit its constant, which rebuilds
the library, and run this again. One JSON object per line:

- ``flash``: the forward (``save_lse=True``, the training call) at
  TinyLlama-1.1B's (B=2, S=T=1024, 32/4 heads, hd 64) and Llama-2-7B's
  (B=1, S=T=1024, 32 heads, hd 128) shapes, beside SDPA's forward on the
  same inputs;
- ``mm8``: ``matmul_8bit`` (int8 codes, bf16 x) at the five TinyLlama
  (K, N) for M in {8, 16, 32, 64, 256, 1024, 2048}, with the design each
  takes;
- ``mm4``: ``matmul_4bit`` (nf4a codes, bf16 x) at the same shapes and M,
  with the design each takes (the decode/prefill crossover, the ring
  depths);
- ``mm8t``: ``matmul_8bit_t`` (int8 codes, bf16 g) at the five TinyLlama
  (K, N) for M in {256, 1024, 2048} (the tile widths);
- ``mm4t``: ``matmul_4bit_t`` (nf4 codes, bf16 g) at the five TinyLlama
  (K, N) and Llama-2-7B's three for M in {256, 1024, 2048}, with the
  design each takes (the tile widths, the ring depth);
- ``i4c``: ``matmul_int4c`` (the quantizer's codes and the wrapper's int8
  activations) at the five TinyLlama (K, N) for M in {8, 16, 32, 64, 256,
  1024, 2048}, with the design each takes (the decode/prefill crossover,
  the ring depths);
- ``i8``: ``matmul_int8_fused`` and ``matmul_int8`` (the quantizer's codes
  and outlier set, the operands ``matmul_int8`` hands them) at the same
  shapes and M, with the design each takes (the decode/prefill crossover,
  the ring depths, the decode column width).

``--ms`` keeps only the M named (of the matmul rows).

Weights are rotated past the 50 MB L2 as ``chip_smoke.py`` times them.
Times are CUDA events around back-to-back calls while the device first
spins, so the host's Python between calls is not timed. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess

import torch

from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.ops import attention, int4c, int8mm, matmul

FLASH_SHAPES = {"tinyllama_s1024": (2, 1024, 32, 4, 64), "llama2_7b_s1024": (1, 1024, 32, 32, 128)}
MM8_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
MM8_MS = (8, 16, 32, 64, 256, 1024, 2048)
MM4T_SHAPES = MM8_SHAPES + [(4096, 4096), (4096, 11008), (11008, 4096)]
L2_BYTES = 50 * 2**20


def time_ms(fn, iters):
    """Mean device ms of one call of ``fn(i)`` over ``iters`` calls."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**8)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def emit(**obj):
    print(json.dumps(obj), flush=True)


def flash_rows(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True,
                             enable_gqa=True)
    for name, (b, s, nh, nkv, hd) in FLASH_SHAPES.items():
        q = torch.randn((b, s, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        ref, _ = attention.flash_forward_reference(q, k, v, pos, pos + s)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        with torch.no_grad():
            sdpa_ms = time_ms(lambda i: sdpa(qt, kt, vt), 50)
        out, _ = attention.flash_forward(q, k, v, pos, pos + s, save_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(lambda i: attention.flash_forward(q, k, v, pos, pos + s, save_lse=True), 50)
        emit(sweep="flash_fwd", shape=name, ms=ms, sdpa_ms=sdpa_ms, max_abs_err=err,
             design=attention.flash_fwd_design(b, s, nh, hd))


def mm8_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in MM8_SHAPES:
        qt, ws = _weights(gen, dev, k, n, "int8")
        for m in pick(MM8_MS):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            ref = matmul.matmul_8bit(x, qt.codes, qt.scale, codebook=None, use_kernel=False)
            out = matmul.matmul_8bit(x, qt.codes, qt.scale, codebook=None)
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda i: matmul.matmul_8bit(x, *ws[i % len(ws)], codebook=None),
                         50 if m <= 64 else 10)
            tol = 2 * 2.0 ** -7 * ref.float().abs().max().item()
            emit(sweep="matmul_8bit", M=m, K=k, N=n, us=ms * 1e3,
                 tflops=2 * m * k * n / (ms * 1e-3) / 1e12, max_abs_err=err, tol=tol,
                 ok=err <= tol, design=matmul.matmul_8bit_design(m, n, k))


def _weights(gen, dev, k, n, fmt):
    w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
    qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
    copies = max(1, min(64, math.ceil(2 * L2_BYTES / (qt.codes.numel() + 4 * qt.scale.numel()))))
    return qt, [(qt.codes.clone(), qt.scale.clone()) for _ in range(copies)]


def mm4_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in MM8_SHAPES:
        qt, ws = _weights(gen, dev, k, n, "nf4a")
        for m in pick(MM8_MS):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            ref = matmul.matmul_4bit(x, qt.codes, qt.scale, codebook="nf4a", use_kernel=False)
            out = matmul.matmul_4bit(x, qt.codes, qt.scale, codebook="nf4a")
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda i: matmul.matmul_4bit(x, *ws[i % len(ws)], codebook="nf4a"),
                         50 if m <= 64 else 10)
            tol = 2 * 2.0 ** -7 * ref.float().abs().max().item()
            emit(sweep="matmul_4bit", M=m, K=k, N=n, us=ms * 1e3,
                 tflops=2 * m * k * n / (ms * 1e-3) / 1e12, max_abs_err=err, tol=tol,
                 ok=err <= tol, design=matmul.matmul_4bit_design(m, n, k))


def mm8t_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in MM8_SHAPES:
        qt, ws = _weights(gen, dev, k, n, "int8")
        for m in pick((256, 1024, 2048)):
            g = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
            ref = matmul.matmul_8bit_t(g, qt.codes, qt.scale, codebook=None, use_kernel=False)
            out = matmul.matmul_8bit_t(g, qt.codes, qt.scale, codebook=None)
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda i: matmul.matmul_8bit_t(g, *ws[i % len(ws)], codebook=None), 10)
            tol = 2 * 2.0 ** -7 * ref.float().abs().max().item()
            emit(sweep="matmul_8bit_t", M=m, K=k, N=n, us=ms * 1e3,
                 tflops=2 * m * k * n / (ms * 1e-3) / 1e12, max_abs_err=err, tol=tol,
                 ok=err <= tol)


def mm4t_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in MM4T_SHAPES:
        qt, ws = _weights(gen, dev, k, n, "nf4")
        for m in pick((256, 1024, 2048)):
            g = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
            ref = matmul.matmul_4bit_t(g, qt.codes, qt.scale, codebook="nf4", use_kernel=False)
            out = matmul.matmul_4bit_t(g, qt.codes, qt.scale, codebook="nf4")
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda i: matmul.matmul_4bit_t(g, *ws[i % len(ws)], codebook="nf4"), 10)
            tol = 2 * 2.0 ** -7 * ref.float().abs().max().item()
            emit(sweep="matmul_4bit_t", M=m, K=k, N=n, us=ms * 1e3,
                 tflops=2 * m * k * n / (ms * 1e-3) / 1e12, max_abs_err=err, tol=tol,
                 ok=err <= tol, design=matmul.matmul_4bit_t_design(m, n, k))


def i4c_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in MM8_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qw = int4c.quantize_int4c_weight(w)
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / (qw.codes.numel() + 4 * n))))
        ws = [(qw.codes.clone(), qw.scale.clone()) for _ in range(copies)]
        for m in pick(MM8_MS):
            x = torch.randn((m, k), generator=gen, device=dev)
            rs = torch.clamp(x.abs().amax(dim=1) / 127.0, min=1e-12)
            xq = torch.clamp(torch.round(x / rs[:, None]), -127, 127).to(torch.int8)
            out = int4c.matmul_int4c_kernel(xq, qw.codes, rs, qw.scale)
            exact = torch.equal(out, int4c.matmul_int4c_kernel(xq, qw.codes, rs, qw.scale,
                                                               use_kernel=False))
            ms = time_ms(lambda i: int4c.matmul_int4c_kernel(xq, ws[i % len(ws)][0], rs,
                                                             ws[i % len(ws)][1]),
                         50 if m <= 64 else 10)
            emit(sweep="matmul_int4c", M=m, K=k, N=n, us=ms * 1e3,
                 tops=2 * m * k * n / (ms * 1e-3) / 1e12, ok=exact,
                 design=int4c.matmul_int4c_design(m, n, k))


def i8_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, n in MM8_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qw = int8mm.quantize_int8_weight(w)
        copies = max(1, min(64, math.ceil(2 * L2_BYTES / (qw.codes.numel() + 4 * n))))
        ws = [(qw.codes.clone(), qw.scale.clone()) for _ in range(copies)]
        for m in pick(MM8_MS):
            x = torch.randn((m, k), generator=gen, device=dev)
            x[:, qw.outlier_idx[:4].long()] *= 20.0
            y_out = x.index_select(1, qw.outlier_idx) @ qw.w_outlier.float()
            xa = x.abs()
            xa[:, qw.outlier_idx] = 0.0
            rs = torch.clamp(xa.amax(dim=1) / 127.0, min=1e-12)
            xq = int8mm.quantize_rows(x, rs)
            calls = {
                "matmul_int8_fused": lambda c, s, uk=None: int8mm.matmul_int8_fused(
                    x, c, rs, s, y_out, use_kernel=uk),
                "matmul_int8": lambda c, s, uk=None: int8mm.matmul_int8_kernel(
                    xq, c, rs, s, use_kernel=uk),
            }
            for name, call in calls.items():
                exact = torch.equal(call(qw.codes, qw.scale),
                                    call(qw.codes, qw.scale, uk=False))
                ms = time_ms(lambda i: call(*ws[i % len(ws)]), 50 if m <= 64 else 10)
                emit(sweep=name, M=m, K=k, N=n, us=ms * 1e3,
                     tops=2 * m * k * n / (ms * 1e-3) / 1e12, ok=exact,
                     design=int8mm.matmul_int8_design(m, n, k,
                                                      fused=name == "matmul_int8_fused"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", nargs="+",
                    choices=("flash", "mm8", "mm4", "mm8t", "mm4t", "i4c", "i8"),
                    default=["flash", "mm8", "mm4", "mm8t", "mm4t", "i4c", "i8"])
    ap.add_argument("--ms", nargs="+", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
    if "flash" in args.what:
        flash_rows(dev)
    def pick(default):
        return [m for m in default if args.ms is None or m in args.ms]
    if "mm8" in args.what:
        mm8_rows(dev, pick)
    if "mm4" in args.what:
        mm4_rows(dev, pick)
    if "mm8t" in args.what:
        mm8t_rows(dev, pick)
    if "mm4t" in args.what:
        mm4t_rows(dev, pick)
    if "i4c" in args.what:
        i4c_rows(dev, pick)
    if "i8" in args.what:
        i8_rows(dev, pick)


if __name__ == "__main__":
    main()
