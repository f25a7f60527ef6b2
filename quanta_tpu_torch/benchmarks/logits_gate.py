"""The rule that holds prefill logits through the kernels against the
plain route (``use_kernel=False``), shared by ``chip_smoke.py`` and
``tp_bench``.

The kernels sum in another order than the plain route, so two valid
results differ by bf16 rounding. :func:`reordered_plain` runs the plain
route summing in yet another order (each reduction split in two halves);
its distance from the plain route is the floor that rounding alone sets
for these weights and inputs. Logits pass at ``REL_L2`` rel-L2, or at
``FLOOR_X`` times that floor plus ``FLOOR_ABS`` where the floor is higher.

``python -m quanta_tpu_torch.benchmarks.logits_gate`` shows, on a card,
where a model's distance comes from: the logits and every quantized
linear through the kernels, the plain route, the reordered plain route
and cuBLAS's bf16 GEMM of the same dequantized weights (:func:`main`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import statistics
from unittest import mock

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.ops import matmul

REL_L2 = 3e-2
FLOOR_X, FLOOR_ABS = 1.5, 2e-3


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def tolerance(floor: float) -> float:
    """The rel-L2 limit for logits whose reordered-plain floor is ``floor``."""
    return max(REL_L2, FLOOR_X * floor + FLOOR_ABS)


def _split_sum(a, w):
    """a @ w with the reduction split in two halves, each an f32 GEMM, the
    halves added in f32."""
    h = w.shape[0] // 2
    return a[:, :h].float() @ w[:h] + a[:, h:].float() @ w[h:]


def _bf16_gemm(a, w):
    """a @ w as one GEMM in a's dtype (bf16 on a card: cuBLAS on tensor
    cores, accumulating in f32 as the kernels do), returned in f32."""
    return (a @ w.to(a.dtype)).float()


@contextlib.contextmanager
def reordered_plain(gemm=_split_sum):
    """The plain versions of the 4-bit and 8-bit matmuls and their
    transposes, multiplying the same dequantized weights through ``gemm``
    (the rule's floor: ``_split_sum``, which sums in another order): the
    spread between the plain route and this one is the floor that bf16
    rounding sets for any two valid orders."""
    dequant = {4: (matmul._dequant_4bit, lambda codes: 2 * codes.shape[0]),
               8: (matmul._dequant_8bit, lambda codes: codes.shape[0])}

    def fwd(bits):
        deq, k_of = dequant[bits]

        def f(x, codes, scales, *, codebook, block=64, out_dtype=None):
            x = matmul._pad_k(x, k_of(codes))
            return gemm(x, deq(codes, scales, codebook, block, x.dtype).float()).to(
                out_dtype or x.dtype)
        return f

    def bwd(bits):
        deq, _ = dequant[bits]

        def f(g, codes, scales, *, codebook, block=64, out_dtype=None):
            g = matmul._pad_n(g, codes.shape[1])
            return gemm(g, deq(codes, scales, codebook, block, g.dtype).float().T).to(
                out_dtype or g.dtype)
        return f

    with mock.patch.object(matmul, "matmul_4bit_reference", fwd(4)), \
            mock.patch.object(matmul, "matmul_4bit_t_reference", bwd(4)), \
            mock.patch.object(matmul, "matmul_8bit_reference", fwd(8)), \
            mock.patch.object(matmul, "matmul_8bit_t_reference", bwd(8)):
        yield


@torch.no_grad()
def prefill_routes(fwd_mod, params, prompt, cfg):
    """Prefill logits of ``fwd_mod.forward`` through the kernels, the plain
    route and the reordered plain route."""
    lk, _ = fwd_mod.forward(params, prompt, cfg)
    lp, _ = fwd_mod.forward(params, prompt, cfg, use_kernel=False)
    with reordered_plain():
        lr, _ = fwd_mod.forward(params, prompt, cfg, use_kernel=False)
    return lk, lp, lr


def prefill_logits_vs_plain(fwd_mod, params, prompt, cfg, tag: str):
    """``fwd_mod.forward`` through the kernels against ``use_kernel=False``
    under the rule. Returns (the kernel route's logits, a dict of the
    rel-L2, its limit and the floor); raises when they disagree."""
    lk, lp, lr = prefill_routes(fwd_mod, params, prompt, cfg)
    if not torch.isfinite(lk).all().item():
        raise RuntimeError(f"{tag}: non-finite logits")
    rel, floor = rel_l2(lk, lp), rel_l2(lr, lp)
    tol = tolerance(floor)
    if rel > tol:
        raise RuntimeError(f"{tag}: prefill logits rel-L2 {rel} > {tol} (floor {floor})")
    return lk, dict(prefill_logits_rel_l2=rel, tol=tol, reordered_plain_rel_l2=floor)


# the routes the diagnostic sets beside the plain one
ROUTES = {"reordered": _split_sum, "bf16_gemm": _bf16_gemm}


@torch.no_grad()
def linear_spread(fwd_mod, params, prompt, cfg) -> list:
    """Where the logits' distance from the plain route comes from: every
    quantized linear of one kernel-route forward, re-run on the input it
    saw through the kernel, the plain route and each of ``ROUTES``.
    Returns, call by call, (K, N), the kernel's and each route's rel-L2
    from the plain route, and the largest difference of each in bf16 ulps
    of max|plain|."""
    linear_mod = importlib.import_module("quanta_tpu_torch.nn.linear")
    seen, inner = [], linear_mod.matmul_quantized

    def record(x, qt, **kw):
        seen.append((x, qt))
        return inner(x, qt, **kw)

    with mock.patch.object(linear_mod, "matmul_quantized", record):
        fwd_mod.forward(params, prompt, cfg)
    rows = []
    for x, qt in seen:
        yp = matmul.matmul_quantized(x, qt, use_kernel=False)
        ulp = 2.0 ** -7 * yp.float().abs().max().item()
        ys = {"kernel": matmul.matmul_quantized(x, qt)}
        for name, gemm in ROUTES.items():
            with reordered_plain(gemm):
                ys[name] = matmul.matmul_quantized(x, qt, use_kernel=False)
        row = dict(k=qt.shape[0], n=qt.shape[1])
        for name, y in ys.items():
            row[f"{name}_rel_l2"] = rel_l2(y, yp)
            row[f"{name}_max_ulps"] = (y.float() - yp.float()).abs().max().item() / ulp
        rows.append(row)
    return rows


def main(argv=None):
    """Print, per depth, the prefill logits' rel-L2 from the plain route
    through the kernels, the reordered plain route and the bf16 GEMM (and
    the kernels' from the reordered route; nothing is checked), and the
    per-linear spread of one forward, for a Llama-2 model drawn from seed
    0 as ``tp_bench`` draws it. Needs a CUDA device.

        python -m quanta_tpu_torch.benchmarks.logits_gate [--model 13b]
            [--fmt int8] [--layers 1 2 4]
    """
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--model", default="13b", choices=("7b", "13b"))
    ap.add_argument("--fmt", default="int8")
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("logits_gate measures a CUDA device and found none")
    dev = torch.device("cuda")
    base = {"7b": llama.LlamaConfig.llama2_7b, "13b": llama.LlamaConfig.llama2_13b}[args.model]()
    for n_layers in args.layers:
        cfg = dataclasses.replace(base, n_layers=n_layers)
        params = qnn.init_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg,
                                           mode=args.fmt, block_size=64, device=dev)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (args.batch, args.prompt), dtype=np.int32)).to(dev)
        lk, lp, lr = prefill_routes(llama, params, prompt, cfg)
        floor = rel_l2(lr, lp)
        row = dict(prefill_logits_rel_l2=rel_l2(lk, lp), tol=tolerance(floor),
                   reordered_plain_rel_l2=floor)
        with reordered_plain(_bf16_gemm):
            row["bf16_gemm_plain_rel_l2"] = rel_l2(
                llama.forward(params, prompt, cfg, use_kernel=False)[0], lp)
        spread = linear_spread(llama, params, prompt, cfg)
        summary = {key: (min(r[key] for r in spread), statistics.median(r[key] for r in spread),
                         max(r[key] for r in spread)) for key in spread[0] if key not in ("k", "n")}
        print(json.dumps({"model": args.model, "fmt": args.fmt, "n_layers": n_layers, **row,
                          "kernel_vs_reordered_rel_l2": rel_l2(lk, lr),
                          "linears": len(spread), "linear_spread_min_median_max": summary,
                          "linear_spread": spread}), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
