"""QLoRA training steps on one CUDA device.

Port of the rows of ``quanta_tpu/benchmarks/train_bench.py``
(``bench_qlora`` and ``bench_adam_bytes``, :97-261, the rows at :278-303):
``ROWS``, the TinyLlama-1.1B geometry with random weights from seed 0, its
linears (``lm_head`` included) as nf4 or nf4a blocks of 64, or dense bf16
(the control), at batch 4 x seq 512; ``LONG_ROWS``, nf4 bases drawn by
``nn.init_quantized_params`` (seed 0): TinyLlama-1.1B at batch 2 x seq
1024 (through the flash kernels, and through the einsum attention as the
control that shows what flash does to step memory) and Llama-2-7B (the
north star, ``max_seq_len`` 1024) at batch 2 x seq 512 and batch 1 x seq
1024. Every row: rank-8 bf16 LoRA on ``wq`` and ``wv`` (alpha 16, seed 1);
blockwise 8-bit Adam at lr 1e-4; random tokens (numpy seed 0), next-token
cross-entropy.

Each row reports:
  - ``step_ms``: the median of CUDA-event times around each of ``steps``
    steps after ``warmup`` steps (the first of them gives ``loss_step1``);
    the events sit on the stream, so host gaps inside a step count;
  - ``tok_s``: batch x seq / step;
  - ``resident_gib``: weights, adapters, optimizer state and batch,
    counted from the tensors; ``step_peak_gib``: the peak allocation of a
    step above what was allocated before it (activations, gradients,
    temporaries): the port's counterpart of the reference's XLA temps;
  - ``device_busy_share``: device-busy time of one profiled step
    (``torch.profiler``) over that step's wall time.

``adam_bytes`` gives the 8-bit Adam bytes per parameter for the adapters
(allocated) and for every parameter of the tree (counted from shapes),
against fp32 Adam's 8. The 13B rows are not ported.

    python -m quanta_tpu_torch.benchmarks.train_bench   # one JSON line

Needs a CUDA device; without one it raises.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import time

import numpy as np
import torch

from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch import train
from quanta_tpu_torch.benchmarks.decode_bench import _require_cuda, quantized
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.optim import Adam8bit, state_nbytes
from quanta_tpu_torch.optim.adam8bit import BLOCK

ROWS = (("tinyllama nf4", "nf4"), ("tinyllama nf4a", "nf4a"), ("tinyllama bf16-base", "bf16"))
# name, model, batch, seq, use_flash (None: the kernels, as S >= 1024), and
# warm-up and timed steps (the reference's L0, L1)
LONG_ROWS = (
    ("tinyllama nf4 s1024", "tinyllama", 2, 1024, None, 2, 5),
    ("tinyllama nf4 s1024 einsum", "tinyllama", 2, 1024, False, 2, 5),
    ("llama2-7b nf4", "llama2-7b", 2, 512, None, 1, 3),
    ("llama2-7b nf4 s1024", "llama2-7b", 1, 1024, None, 1, 3),
)
FP32_ADAM_BYTES = 8  # m and v in f32
TOP_OPS = 8


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, qnn.LoRAWeight):
        yield from _leaves([tree.base, tree.lora_a, tree.lora_b])
    elif hasattr(tree, "__dataclass_fields__"):  # QuantizedTensor and the like
        yield from _leaves([getattr(tree, f) for f in tree.__dataclass_fields__])
    elif isinstance(tree, torch.Tensor):
        yield tree


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def make_batch(cfg, batch: int, seq: int, device, seed: int = 0) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(batch, seq + 1))
    toks = torch.from_numpy(toks.astype(np.int64)).to(device)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def with_lora(base: dict, rank: int = 8, seed: int = 1, device=None) -> dict:
    """The base tree with bf16 LoRA on wq and wv (base tensors shared)."""
    dev = device or base["tok_emb"].device
    return train.add_lora(base, torch.Generator(device=dev).manual_seed(seed), rank=rank,
                          dtype=torch.bfloat16, device=dev)


def profile_step(step, params, batch) -> dict:
    """Device-busy ms and device operations of one step, from
    ``torch.profiler``, their share of the profiled step's wall time (the
    profiler slows the step, so the share is taken against the step it
    saw; None when it recorded no device work), and the device ms of the
    ``TOP_OPS`` device operations that took the most, by name. The second
    of two profiled steps is the one reported."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profile of a process pays the tracer's start-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    n_ops = 0
    for e in prof.events():
        # device operations only: a user annotation (the optimizer's
        # ``Optimizer.step`` range) spans the kernels it encloses
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            n_ops += 1
    busy = sum(by_name.values()) / 1e3 if n_ops else None
    return {"step_ms_profiled": wall_ms, "device_busy_ms": busy, "device_ops_per_step": n_ops,
            "device_busy_share": None if busy is None else busy / wall_ms,
            "top_device_ms": {k: v / 1e3 for k, v in by_name.most_common(TOP_OPS)}}


def model_config(model: str) -> llama.LlamaConfig:
    """The configuration of a ``LONG_ROWS`` model: the 7B with the
    reference's ``max_seq_len=1024`` (``train_bench.py:293-297``)."""
    if model == "tinyllama":
        return llama.LlamaConfig.tinyllama_1b()
    if model == "llama2-7b":
        return dataclasses.replace(llama.LlamaConfig.llama2_7b(), max_seq_len=1024)
    raise ValueError(f"unknown model {model!r}")


def bench_qlora(base: dict, cfg, *, batch: int = 4, seq: int = 512, rank: int = 8,
                lr: float = 1e-4, warmup: int = 2, steps: int = 5, use_flash=None) -> dict:
    """One row: QLoRA steps over ``base`` (a quantized or dense tree);
    ``use_flash`` goes to ``llama.forward``."""
    dev = _require_cuda()
    params = with_lora(base, rank=rank)
    opt = Adam8bit(qnn.lora_parameters(params), lr=lr)
    step = train.make_qlora_train_step(cfg, opt, use_flash=use_flash)
    data = make_batch(cfg, batch, seq, dev)
    torch.cuda.synchronize()
    start_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss1 = step(params, data).item()
    for _ in range(warmup - 1):
        step(params, data)
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, data)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_peak = torch.cuda.max_memory_allocated() - start_alloc
    prof = profile_step(step, params, data)
    step_ms = statistics.median(times)
    return {
        "batch": batch, "seq": seq, "rank": rank, "lr": lr, "use_flash": use_flash,
        "loss_step1": loss1,
        "step_ms": step_ms, "step_ms_all": times,
        "tok_s": batch * seq / (step_ms / 1e3),
        "weights_gib": _nbytes(base) / 2**30,
        "resident_gib": (_nbytes(params) + state_nbytes(opt) + _nbytes(data)) / 2**30,
        "step_peak_gib": step_peak / 2**30,
        "adapter_params_m": sum(t.numel() for t in qnn.lora_parameters(params)) / 1e6,
        **prof,
    }


def adam_bytes(cfg, rank: int = 8) -> dict:
    """8-bit Adam state bytes per parameter: the adapters' state allocated
    (after one step), every parameter of the tree counted from shapes."""
    dev = _require_cuda()
    base = llama.init_params(None, cfg, device="meta")
    adapters = list(qnn.lora_parameters(with_lora(base, rank=rank, device=dev)))
    opt = Adam8bit(adapters, lr=1e-4)
    for a in adapters:
        a.grad = torch.zeros_like(a)
    opt.step()
    n_ad = sum(a.numel() for a in adapters)
    n_full = sum(t.numel() for t in _leaves(base))
    full8 = sum(math.ceil(t.numel() / BLOCK) * (2 * BLOCK + 2 * 4) for t in _leaves(base))
    return {
        "adapters": {"params_m": n_ad / 1e6,
                     "adam8bit_bytes_per_param": state_nbytes(opt) / n_ad,
                     "fp32_adam_bytes_per_param": FP32_ADAM_BYTES},
        "full_model": {"params_m": n_full / 1e6,
                       "adam8bit_gib": full8 / 2**30,
                       "adam8bit_bytes_per_param": full8 / n_full,
                       "fp32_adam_gib": FP32_ADAM_BYTES * n_full / 2**30,
                       "fp32_adam_bytes_per_param": FP32_ADAM_BYTES},
    }


def long_rows() -> list[dict]:
    """The ``LONG_ROWS``, one base per model, freed before the next."""
    dev = _require_cuda()
    rows, bases = [], {}
    for name, model, batch, seq, use_flash, warmup, steps in LONG_ROWS:
        cfg = model_config(model)
        if model not in bases:
            bases.clear()
            torch.cuda.empty_cache()
            bases[model] = qnn.init_quantized_params(torch.Generator(device=dev).manual_seed(0),
                                                     cfg, mode="nf4", device=dev)
        rows.append({"name": name, "model": model, "fmt": "nf4",
                     **bench_qlora(bases[model], cfg, batch=batch, seq=seq, use_flash=use_flash,
                                   warmup=warmup, steps=steps)})
    return rows


def main():
    dev = _require_cuda()
    cfg = llama.LlamaConfig.tinyllama_1b()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rows = [{"name": name, "fmt": fmt, **bench_qlora(quantized(dense, fmt), cfg)}
            for name, fmt in ROWS]
    del dense
    rows += long_rows()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "train": rows,
                      "adam_bytes": adam_bytes(cfg)}))


if __name__ == "__main__":
    main()
