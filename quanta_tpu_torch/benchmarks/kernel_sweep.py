"""Time the three flash kernels (bf16 or f32), the bf16 ``matmul_8bit``,
``matmul_4bit``, ``matmul_8bit_t`` and ``matmul_4bit_t`` kernels,
``matmul_int4c``, the LLM.int8 pair and the f32 routes of
``matmul_4bit``, ``matmul_8bit``, ``matmul_4bit_t`` and ``matmul_8bit_t``
across shapes.

    python -m quanta_tpu_torch.benchmarks.kernel_sweep
        [--what flash mm8 mm4 mm8t mm4t i4c i8 f32] [--ms 8 32] [--dtype float32]

To try a design choice of ``csrc/flash_fwd.cu``, ``csrc/matmul_8bit.cu``,
``csrc/matmul_4bit.cu``, ``csrc/matmul_8bit_t.cu``, ``csrc/matmul_4bit_t.cu``,
``csrc/int4c.cu`` or ``csrc/int8mm.cu`` (warpgroups, ring stages, the
decode/prefill split, the tile widths), edit its constant, which rebuilds
the library, and run this again. One JSON object per line:

- ``flash``: the forward (``save_lse=True``, the training call), the dQ
  and the dK/dV kernels on ``--dtype`` operands (bf16 by default) at
  TinyLlama-1.1B's (B=2, S=T=1024, 32/4 heads, hd 64) and Llama-2-7B's
  (B=1, S=T=1024, 32 heads, hd 128) shapes, TinyLlama's at hd 32 (the
  three compiled widths) and OpenLLaMA-3B's (B=2, S=T=1024, 32 heads, hd
  100, run padded to 128; and the same shape at hd 128, what the padding
  is read against), Gemma-2B's geometry's (B=2, S=T=1024, 8 heads to 1 KV
  head, hd 256) and the same shape at hd 160, 192 and 132 (each run padded
  to 256: what a width of 192 would save; 132 in bf16 after the wrapper's
  zero columns to 136, the TMA rows), and head dims off a multiple of 4
  beside the multiple of 8 the wrapper pads them to (37 and 40 at
  TinyLlama's shape, 98 and 104 at OpenLLaMA-3B's); a shape whose head dim
  a checkout's kernels refuse is skipped; with their largest error
  against the plain versions, beside SDPA's forward and backward on the
  same inputs and the backend it takes (in f32, where that is math, also
  the efficient backend on K and V expanded to the query heads, where it
  takes the head dim). It calls
  nothing newer than the flash wrappers either, so ``--what flash --dtype
  float32`` run as a file times another checkout's f32 kernels the same
  way;
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
  the ring depths, the decode column width);
- ``f32``: ``matmul_4bit`` (nf4a) and ``matmul_8bit`` (int8) on f32 x
  through ``matmul_quantized``, beside their plain versions and cuBLAS's
  f32 GEMM on the dequantized weight (``library_us``): at GPT-2 small's
  four (K, N) for M in {8, 1024} and at the accuracy proxy's four for M =
  8192 (the split-K FMA decode, the FMA GEMM's tile, ring and K split);
  then ``matmul_4bit_t`` (nf4a) and ``matmul_8bit_t`` (int8) on f32 g the
  same way (``sweep`` "f32_t"), at GPT-2's four (K, N) for M = 1024, the
  proxy's for M = 8192 and TinyLlama-1.1B's five for M = 2048 (the 3xTF32
  dx tile). It calls nothing newer than ``matmul_quantized``,
  ``matmul_4bit_t`` and ``matmul_8bit_t``, so the same file times another
  checkout's kernels with that checkout first on ``PYTHONPATH`` (``python
  quanta_tpu_torch/benchmarks/kernel_sweep.py --what f32``).

``--ms`` keeps only the M named (of the matmul rows).

Weights are rotated past the 50 MB L2 as ``chip_smoke.py`` times them.
Times are CUDA events around back-to-back calls while the device first
spins, so the host's Python between calls is not timed. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import inspect
import json
import math
import subprocess

import torch

from quanta_tpu_torch.benchmarks.kernel_bench import L2_BYTES, copies_past_l2, time_ms
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.ops import attention, int4c, int8mm, matmul

FLASH_SHAPES = {"tinyllama_s1024": (2, 1024, 32, 4, 64), "llama2_7b_s1024": (1, 1024, 32, 32, 128),
                "tinyllama_hd32_s1024": (2, 1024, 32, 4, 32),
                "openllama_3b_s1024": (2, 1024, 32, 32, 100),
                "openllama_3b_hd128_s1024": (2, 1024, 32, 32, 128),
                "gemma_2b_s1024": (2, 1024, 8, 1, 256),
                "gemma_2b_hd160_s1024": (2, 1024, 8, 1, 160),
                "gemma_2b_hd192_s1024": (2, 1024, 8, 1, 192),
                "gemma_2b_hd132_s1024": (2, 1024, 8, 1, 132),
                "tinyllama_hd37_s1024": (2, 1024, 32, 4, 37),
                "tinyllama_hd40_s1024": (2, 1024, 32, 4, 40),
                "openllama_3b_hd98_s1024": (2, 1024, 32, 32, 98),
                "openllama_3b_hd104_s1024": (2, 1024, 32, 32, 104)}
MM8_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
MM8_MS = (8, 16, 32, 64, 256, 1024, 2048)
MM4T_SHAPES = MM8_SHAPES + [(4096, 4096), (4096, 11008), (11008, 4096)]
# the f32 rows' (K, N) and M: GPT-2 small's linears, the accuracy proxy's
GPT2_KN = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
PROXY_KN = ((512, 512), (512, 128), (512, 1536), (1536, 512))
F32_CASES = [(kn, (8, 1024)) for kn in GPT2_KN] + [(kn, (8192,)) for kn in PROXY_KN]
# the f32 dx rows': GPT-2's at M = 1024, the proxy's at M = 8192,
# TinyLlama-1.1B's QLoRA backward's at M = 2048
F32_T_CASES = ([(kn, 1024) for kn in GPT2_KN] + [(kn, 8192) for kn in PROXY_KN]
               + [(kn, 2048) for kn in MM8_SHAPES])


def emit(**obj):
    print(json.dumps(obj), flush=True)


def sdpa_times(q, k, v, do, iters=20):
    """SDPA (``is_causal``, ``enable_gqa``) on the flash operands, copied to
    its (B, heads, S, hd) layout outside the timing: ms of its forward, its
    backward (dq, dk and dv in one call) and both, and the backend it takes
    (the first of flash, efficient, cuDNN and math that accepts the
    operands). Where that is math, also the efficient backend's forward and
    backward on K and V expanded to the query heads, the expansion outside
    the timing."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)

    def backend(*args, **kw):
        for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(b), torch.no_grad():
                    sdpa(*args, **kw)
            except RuntimeError:  # this backend refuses the operands
                continue
            return b
        raise RuntimeError("sdpa_times: no SDPA backend takes the operands")

    def times(qt, kt, vt, **kw):
        qr, kr, vr = (x.detach().requires_grad_() for x in (qt, kt, vt))
        o = sdpa(qr, kr, vr, **kw)
        with torch.no_grad():
            fwd = time_ms(lambda i: sdpa(qt, kt, vt, **kw), iters)
        bwd = time_ms(lambda i: torch.autograd.grad(o, (qr, kr, vr), dot, retain_graph=True),
                      iters)
        both = time_ms(lambda i: torch.autograd.grad(sdpa(qr, kr, vr, **kw), (qr, kr, vr), dot),
                       iters)
        return fwd, bwd, both

    taken = backend(qt, kt, vt, enable_gqa=True)
    fwd, bwd, both = times(qt, kt, vt, enable_gqa=True)
    out = {"sdpa_backend": taken.name, "sdpa_fwd_ms": fwd, "sdpa_bwd_ms": bwd,
           "sdpa_fwd_bwd_ms": both}
    if taken == SDPBackend.MATH:
        rep = q.shape[2] // k.shape[2]
        ke, ve = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                fwd, bwd, both = times(qt, ke, ve)
        except RuntimeError:  # it refuses this head dim too (f32 at hd 37)
            return out
        out.update(sdpa_efficient_fwd_ms=fwd, sdpa_efficient_bwd_ms=bwd,
                   sdpa_efficient_fwd_bwd_ms=both)
    return out


def flash_rows(dev, dtype):
    """The three flash kernels on ``dtype`` operands at FLASH_SHAPES: ms a
    call, the largest error against the plain versions over max|plain|,
    beside SDPA (``sdpa_times``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (b, s, nh, nkv, hd) in FLASH_SHAPES.items():
        q, do = (torch.randn((b, s, nh, hd), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, s, nkv, hd), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        try:
            attention.flash_forward(q, k, v, pos, pos + s)
        except ValueError:  # a head dim this checkout's kernels refuse
            continue
        ref, lse = attention.flash_forward_reference(q, k, v, pos, pos + s)
        delta = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, lse, delta, pos, pos + s)
        got = {"fwd": attention.flash_forward(q, k, v, pos, pos + s)[:1],
               "dq": (attention.flash_bwd_dq(*bwd),), "dkv": attention.flash_bwd_dkv(*bwd)}
        want = {"fwd": (ref,), "dq": (attention.flash_bwd_dq_reference(*bwd),),
                "dkv": attention.flash_bwd_dkv_reference(*bwd)}
        rel_err = {n: max((x.float() - y.float()).abs().max().item() / y.float().abs().max().item()
                          for x, y in zip(got[n], want[n])) for n in got}
        row = dict(sweep="flash", dtype=str(dtype), shape=name, rel_err=rel_err,
                   fwd_ms=time_ms(lambda i: attention.flash_forward(q, k, v, pos, pos + s,
                                                                    save_lse=True), 20),
                   dq_ms=time_ms(lambda i: attention.flash_bwd_dq(*bwd), 20),
                   dkv_ms=time_ms(lambda i: attention.flash_bwd_dkv(*bwd), 20),
                   **sdpa_times(q, k, v, do))
        if "dtype" in inspect.signature(attention.flash_fwd_design).parameters:
            row["fwd_design"] = attention.flash_fwd_design(b, s, nh, hd, dtype=dtype)
        elif dtype == torch.bfloat16:
            row["fwd_design"] = attention.flash_fwd_design(b, s, nh, hd)
        if "dtype" in inspect.signature(attention.flash_bwd_design).parameters:
            row["bwd_design"] = {n: attention.flash_bwd_design(n, b, s, s, nh, nkv, hd,
                                                               dtype=dtype)
                                 for n in ("flash_bwd_dq", "flash_bwd_dkv")}
        emit(**row)


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


def dequantized_f32(qt):
    """The f32 (K_pad, N_pad) weight the plain versions multiply: what
    cuBLAS's f32 GEMM, an f32 row's library time, reads."""
    deq = matmul._dequant_4bit if qt.packed == "split_k" else matmul._dequant_8bit
    return deq(qt.codes, qt.scale, qt.codebook, qt.block_size, torch.float32)


def f32_rows(dev, pick):
    gen = torch.Generator(device=dev).manual_seed(0)
    for (k, n), ms in F32_CASES:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        for fmt in ("nf4a", "int8"):
            qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
            qts = [dataclasses.replace(qt, codes=c, scale=sc)
                   for c, sc in copies_past_l2(qt.codes, qt.scale)]
            wd = copies_past_l2(dequantized_f32(qt))
            for m in pick(ms):
                x = torch.randn((m, k), generator=gen, device=dev)
                out = matmul.matmul_quantized(x, qt)
                ref = matmul.matmul_quantized(x, qt, use_kernel=False)
                err = (out - ref).abs().max().item()
                tol = 1e-5 * ref.abs().max().item()
                iters = 50 if m <= 64 else 10
                ms_ = time_ms(lambda i: matmul.matmul_quantized(x, qts[i % len(qts)]), iters)
                plain = time_ms(lambda i: matmul.matmul_quantized(x, qts[i % len(qts)],
                                                                  use_kernel=False), iters)
                xp = matmul._pad_k(x, wd[0][0].shape[0])
                lib = time_ms(lambda i: xp @ wd[i % len(wd)][0], iters)
                emit(sweep="f32", fmt=fmt, M=m, K=k, N=n, us=ms_ * 1e3, plain_us=plain * 1e3,
                     library_us=lib * 1e3, tflops=2 * m * k * n / (ms_ * 1e-3) / 1e12,
                     max_abs_err=err, tol=tol, ok=err <= tol,
                     same=torch.equal(out, matmul.matmul_quantized(x, qt)))
    for (k, n), m in F32_T_CASES:
        if not pick((m,)):
            continue
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        g = torch.randn((m, n), generator=gen, device=dev)
        for fmt, fn in (("nf4a", matmul.matmul_4bit_t), ("int8", matmul.matmul_8bit_t)):
            qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
            out, row = f32_t_row(g, qt, fn, 10)
            emit(sweep="f32_t", kernel=fn.__name__, fmt=fmt, M=m, K=k, N=n, K_pad=out.shape[1],
                 tflops=2 * m * k * n / (row["us"] * 1e-6) / 1e12,
                 ok=row["max_abs_err"] <= row["tol"], **row)


def f32_t_row(g, qt, fn, iters):
    """``fn`` (matmul_4bit_t or matmul_8bit_t) on f32 g and ``qt``'s codes
    against its plain version: (out, row) with the largest error, 1e-5 of
    max|plain|, whether a second call gives the same bits, and µs per call
    of the kernel, the plain version and cuBLAS's f32 GEMM on the
    dequantized weight, the weights rotated past the L2."""
    ws = copies_past_l2(qt.codes, qt.scale)
    wd = copies_past_l2(dequantized_f32(qt))

    def run(use_kernel, ws):
        return lambda i: fn(g, *ws[i % len(ws)], codebook=qt.codebook, block=qt.block_size,
                            use_kernel=use_kernel)
    out = run(None, [(qt.codes, qt.scale)])(0)
    ref = run(False, [(qt.codes, qt.scale)])(0)
    gp = matmul._pad_n(g, wd[0][0].shape[1])
    return out, dict(max_abs_err=(out - ref).abs().max().item(),
                     tol=1e-5 * ref.abs().max().item(),
                     same=torch.equal(out, run(None, [(qt.codes, qt.scale)])(0)),
                     us=time_ms(run(None, ws), iters) * 1e3,
                     plain_us=time_ms(run(False, ws), iters) * 1e3,
                     library_us=time_ms(lambda i: gp @ wd[i % len(wd)][0].T, iters) * 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", nargs="+",
                    choices=("flash", "mm8", "mm4", "mm8t", "mm4t", "i4c", "i8", "f32"),
                    default=["flash", "mm8", "mm4", "mm8t", "mm4t", "i4c", "i8", "f32"])
    ap.add_argument("--ms", nargs="+", type=int, default=None)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the flash rows' operands")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
    if "flash" in args.what:
        flash_rows(dev, getattr(torch, args.dtype))
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
    if "f32" in args.what:
        f32_rows(dev, pick)


if __name__ == "__main__":
    main()
