#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA device and check it.

    python3 chip_smoke.py

Phases, each printing one JSON object per line; any failed check raises
and the script exits non-zero (nothing is caught):

  1. the card (``nvidia-smi`` name and power limit, printed raw as well);
  2. the build of ``quanta_tpu_torch/csrc/*.cu`` with nvcc (seconds, .so);
  3. each CUDA kernel against its plain PyTorch version at the main path's
     shapes: ``matmul_4bit`` at M in {8, 16, 32, 64, 256, 2048} (both
     sides of its decode/prefill split; 2048 is a QLoRA forward) and at a
     ragged M = 77, N = 200, in nf4a, nf4, int4 and fp4, within 2 bf16
     ulps of max|plain|, its output bit-identical over two calls, with its
     design (``matmul_4bit_design``) on each row; ``matmul_int4c`` at M in
     {8, 32, 1024} (both sides of its decode/prefill split) bit for bit,
     with its design (``matmul_int4c_design``) on each row; kernel times
     from CUDA events, weights rotated through more than the 50 MB L2 so
     decode shapes stream from device memory as they do in a model, and
     for a decode step (nf4a, M = 8) and a QLoRA forward (nf4, M = 2048)
     the plain version's and a dense control's (cuBLAS ``torch.matmul`` of
     the dequantized bf16 weight); for ``matmul_int4c`` above M = 16 a
     dense control's (``torch._int_mm`` of the int8 activations and the
     unpacked int8 weight, row- or column-major, whichever is faster: no
     scales, no packing);
  4. the LLM.int8 kernels (``matmul_int8_fused``, ``matmul_int8``) at the
     five TinyLlama (K, N) for M in {8, 32, 256, 1024} (a decode step of 8
     slots, the top of their decode design, the largest prefill bucket,
     decode_bench's prefill), f32 x, the quantizer's outlier set, and at a
     ragged M = 300, K = 203, N = 77, bit-identical over two calls, with
     their design (``matmul_int8_design``) on each row and, above M = 16,
     a dense control's time (``torch._int_mm``, as for int4c); and
     ``quantize_blockwise`` at the int8 KV writes of the serve path (a
     prefill of 256 tokens, a window of 8 steps for 8 slots, every layer
     in one call; and one layer's window), all bit for bit against their
     plain versions, timed as in phase 3; then the fused K+V write into
     the int8 pool (``kvcache.write_rows``, one launch) at the prefill and
     window shapes against ``quantize_kv`` plus ``index_put``, equal
     outside the null page 0 (whose rows repeat), timed;
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
  7. the serve path at the full TinyLlama-1.1B width: (a) at full depth, a
     closed trace of 8 requests (llm_int8 weights, int8 KV cache, 8
     slots, multi_step 8, greedy), all submitted before ``Engine.run``,
     through the kernels and through ``use_kernel=False``: tokens
     identical request by request, launch counts as the design implies;
     (b) at ``TIMED_DEPTH`` layers, timed Poisson rows (``serve_bench.run_one``: 16 requests at 24
     req/s, 48 new tokens, 8 slots, multi_step 8) for nf4a, int4c,
     llm_int8 and llm_int8 + int8 KV, each with the device-idle share of
     one steady decode window;
  8. decode tok/s, prefill tok/s and TTFT at batch 8 / prompt 128 /
     cache 512 for every format at ``TIMED_DEPTH`` layers, and the
     device-busy share of a step;
  9. QLoRA training at the full TinyLlama-1.1B width and depth: (a)
     ``matmul_4bit_t`` against its plain version at the five (K, N) with
     M = 2048 (batch 4 x seq 512) and Llama-2-7B's three with M = 1024
     (batch 1 x seq 1024), bf16 gradients, nf4 and nf4a, plus one f32
     shape, within 2 bf16 ulps of max|plain| (f32: 1e-5), the bf16
     outputs bit-identical over two calls, with its design
     (``matmul_4bit_t_design``) on each row, and for the nf4 TinyLlama
     rows the plain version's and a dense control's time (cuBLAS
     ``g @ W_deq^T`` of the dequantized bf16 weight); (b)
     ``adam8bit_update``: the optimizer's multi-leaf step over one QLoRA
     step's 88 bf16 adapter leaves (one launch) bit for bit against its
     plain version over 5 chained steps, with and without decay, timed;
     the one-leaf op bit for bit at the adapter leaf sizes (64 and 8
     blocks) and one full-parameter leaf (45,056 blocks), one block all
     zero; (c) 3 QLoRA steps (nf4 base, rank-8 bf16
     LoRA on wq and wv, 8-bit Adam at lr 1e-3, one fixed batch) through
     the kernels and 3 through ``use_kernel=False`` from the same
     adapters, and one step through plain versions that sum in another
     order (the floor bf16 rounding sets): step-1 loss within 1e-2
     relative, step-1 lora_b gradients tensor by tensor within 1.5 times
     that tensor's own floor plus 2e-3 rel-L2 (``GRAD_FLOOR_X`` says why),
     lora_a gradients zero, the step-3
     loss below step 1's on both routes, and per kernel-route step 155
     ``matmul_4bit``, 152 ``matmul_4bit_t`` (layer 0's wq, wk and wv read
     the frozen embedding and need no dx) and 1 ``adam8bit_update`` (one
     launch over every adapter tensor); (d) the timed ``train_bench`` rows, nf4, nf4a
     and the bf16-base control, and the 8-bit Adam bytes;
 10. the flash-attention kernels (``flash_fwd``, ``flash_bwd_dq``,
     ``flash_bwd_dkv``) against their plain versions on the same inputs at
     TinyLlama-1.1B's training shape (B=2, S=T=1024, GQA rep 8, hd 64),
     Llama-2-7B's (B=1, MHA, hd 128), a cached prefill (1024 queries
     into 1152 slots at q_start 0 and 64, and a row whose kv_len is 0),
     phase 12's prefill (1024 queries into 1040 slots) and phase 13's
     S = T = 2048, in bf16 and the cached prefill also in f32: bf16
     output within 2 bf16 ulps of
     max|plain| and rel-L2 1e-2, lse within 1e-4, gradients within rel-L2
     2e-2 (f32: 1e-5 and 1e-4 of max|plain|), dead rows zero with lse
     1e30, and dq, dk, dv bit-identical over two calls; at the S = T
     shapes the times of the kernels, their plain versions and SDPA
     (forward; backward; both); then one ``flash_bwd_design`` and one
     ``flash_fwd_design`` line per head_dim (the bf16 kernels' grid,
     cluster size or warpgroups, blocks resident per SM, registers and
     shared bytes, from ``cudaFuncGetAttributes``);
 11. QLoRA at batch 2 x seq 1024 (nf4 base, as phase 9): 3 steps through
     the flash kernels and 3 through the einsum attention from the same
     adapters, and one step with the einsum attention in f32 (the floor
     bf16 rounding of the attention sets): step-1 loss within 1e-2,
     lora_b gradients within phase 9's floor rule, the loss falling on
     both routes, and per flash step 155 / 152 / 1 launches beside 22
     each of the three flash kernels (none on the einsum route);
 12. greedy decode (nf4a, B=2) from a 1024-token prompt into 1040 cache
     slots: prefill logits flash against einsum (within 1e-2 rel-L2, or
     1.5 times the floor of the f32-attention route plus 2e-3 where bf16
     rounding alone sets it above that), 22 ``flash_fwd`` launches in the
     prefill and none in the decode steps;
 13. ``decode_bench.long_prefill`` (dense bf16, B=2) at S in {256, 512,
     1024, 2048}, flash against einsum (the crossover; 2048 is the
     reference's row), and ``train_bench``'s seq-1024 and Llama-2-7B rows
     (bases from ``nn.init_quantized_params``), the TinyLlama s1024 row
     also through the einsum attention;
 14. the 8-bit kernels (``matmul_8bit``, ``matmul_8bit_t``) against their
     plain versions at the five TinyLlama (K, N), M in {8, 2048}, in int8,
     nf8, fp8 and int8a with bf16 operands (within 2 bf16 ulps of
     max|plain|) and at one shape in f32 (within 1e-5 of it, TF32 off);
     ``matmul_8bit`` also at M in {64, 256, 1024} on two shapes (both
     sides of its decode/prefill split) and at a ragged M = 77, N = 200,
     ``matmul_8bit_t`` also at M in {64, 256} on those two shapes, both at
     a ragged M = 77, N = 200, their bf16 outputs bit-identical over two
     calls, with ``matmul_8bit``'s design (``matmul_8bit_design``) on each
     row;
     kernel times for every format, and for int8 the plain versions' and
     a dense control's (cuBLAS ``torch.matmul`` of the dequantized bf16
     weight: no single PyTorch call dequantizes blockwise 8-bit codes
     inside a GEMM), weights rotated past the L2 as in phase 3;
 15. post-training quantization at the full TinyLlama-1.1B geometry
     (``ptq.quantize_model`` with an int8 default, nf8 on ``layers/0/``, fp8
     on ``lm_head`` and W8A8 int8a with entropy calibration on ``w_down``,
     calibrated on 8 corpus batches), and int8, nf8, fp8 and int8a trees
     from ``nn.quantize_params``: for each, greedy decode (8 prompts of 128
     tokens, 32 new) with 155 ``matmul_8bit`` launches a forward and no
     4-bit one, prefill logits against ``use_kernel=False`` within phase
     5's rel-L2 (or, where the plain route summed in another order sets a
     higher floor, as the W8A8 fake-quant does, phase 9's floor rule),
     and the perplexity of 32,768 held-out corpus tokens
     through the kernels within 1e-2 relative of the plain route's;
 16. QLoRA on int8 and nf8 bases under phase 9's rules (step-1 loss,
     lora_b gradients within 1.5 times their floor plus 2e-3, the loss
     falling; 155 ``matmul_8bit``, 152 ``matmul_8bit_t`` and 1
     ``adam8bit_update`` a step), then ``train_bench.bench_qlora`` on both
     bases;
 17. the CLI, in subprocesses from a temporary directory: ``quantize
     --toy tinyllama --fmt int8 --calib-text`` a corpus file, ``eval
     --ckpt``, ``generate --ckpt``, ``finetune --toy tinyllama --fmt nf8
     --steps 3``, each exiting 0;
 18. ``benchmarks.accuracy_bench`` at its model size with pretraining cut
     to ``ACC_STEPS`` and no cache: the unquantized model learned (final
     loss below 2.5), the int8 and nf8 perplexities through the kernels
     within 1e-4 relative of ``use_kernel=False`` on the same trees, and
     the gates of the 8-bit rows (int8, nf8, llm_int8, w8a8-*) hold at
     <= 0.1; the other rows are printed;
 19. GPT-2 small's kernels: ``matmul_4bit`` (nf4a, bf16 x at M in {8,
     1024}, f32 x at M = 8) and ``matmul_int8_fused`` (f32 x at M in {8,
     256}) against their plain versions at GPT-2's four (K, N) (768 x
     2304, 768 x 768, 768 x 3072, 3072 x 768) under phase 3's and phase
     4's rules (2 bf16 ulps of max|plain|, f32 1e-5 of it; LLM.int8 bit for
     bit), the bf16 and int8 outputs bit-identical over two calls, the
     design per row, timed as in phase 3, and one GPT-2 decode step's 48
     calls (M = 8) with their bound;
 20. HF checkpoints through the port's own safetensors codec: GPT-2 small
     (12 layers, 768 wide, vocab 50257, 1024 positions, random f32 weights
     from seed 0) and a TinyLlama-1.1B-width Llama of 2 layers (bf16
     weights, f32 on disk) saved with ``models.hf.save_gpt2`` /
     ``save_llama`` into a temporary directory and loaded back onto the
     card, every tensor bit-identical;
 21. that 2-layer Llama quantized to exact nf4 and transcoded to nf4a on
     the card (``utils.transcode_params``; codes equal to the transcode of
     a host copy), then greedy decode of 8 prompts of 128 tokens for 16 new
     ones through ``matmul_4bit`` (16 x 15 launches), prefill logits within
     phase 5's rel-L2 of ``use_kernel=False``;
 22. GPT-2 served: phase 7a's closed trace through ``Engine(arch="gpt2")``
     on the loaded f32 weights quantized to llm_int8, int8 KV, 8 slots,
     multi_step 8: tokens identical request by request through the kernels
     and through ``use_kernel=False``, 48 ``matmul_int8_fused`` launches a
     forward (4 a layer; the tied head is dense) and one
     ``quantize_blockwise`` a prefill and a window;
 23. GPT-2 in bf16 (``load_gpt2(dtype=bfloat16)``) quantized to nf4a:
     greedy decode of 8 prompts of 128 tokens for 32 new ones through
     ``matmul_4bit``'s bf16 designs (32 x 48 launches), prefill logits
     against ``use_kernel=False`` within phase 5's rel-L2, or phase 15's
     floor rule where bf16 reordering sets a higher floor;
 24. ``benchmarks.kernel_bench`` at M = 8 and 128: one line a cell (dense
     bf16, nf4a/nf4/int4 through ``matmul_4bit``, int8 through
     ``matmul_8bit``, llm_int8 through ``matmul_int8_fused``,
     ``matmul_int8`` and its plain route, int4c), each with its speedup
     over dense bf16 and its share of the H100 roofline, none above 105%;
 25. Llama-2-7B and Llama-2-13B at full width and depth (``max_seq_len``
     512), nf4a codes drawn by ``nn.init_quantized_params``: one prefill
     forward (batch 8 x 128 tokens) with 7 x n_layers + 1 ``matmul_4bit``
     launches and nothing else, its logits against ``use_kernel=False``
     by phase 15's rule; then ``model_scale_bench.run_model``: decode and
     prefill tok/s, the idle share and device ms of a decode step, and
     the Engine trace (``MODEL_SCALE_REQUESTS`` requests, int8 KV pool),
     every request finishing, only ``matmul_4bit`` and the int8 KV writes
     launched;
 26. ``train_bench``'s ``llama2-13b nf4`` row (batch 1 x seq 512): per
     step 7 x 40 + 1 ``matmul_4bit``, 278 ``matmul_4bit_t`` and two
     ``adam8bit_update`` launches (160 adapter leaves, 128 a launch), the
     loss finite;
 27. tensor parallelism: ``TP_RANKS`` ranks sharing the card over gloo
     (``parallel.spawn_local`` running ``benchmarks.tp_bench``), each
     drawing the global Llama-2-13B nf4a tree from one seed and keeping
     only its shards (``from_global``): rank 0's prefill logits (batch 8
     x 128) against the single-card forward by phase 15's rule, (5 + 2 x
     2) x 40 + 1 ``matmul_4bit`` launches per rank per forward,
     ``tp_greedy_decode`` for 32 tokens with every rank agreeing (and the
     share equal to the single-card greedy tokens); then the same at 13B
     width, 2 layers, int8 shards through ``matmul_8bit``. A failing rank
     fails the phase;
 28. one ``engine_sweep`` cell: the llm_int8 64-request trace (rate 40,
     48 new tokens, int8 KV, ``multi_step`` 8, ``pipeline_depth`` 2) at
     ``TIMED_DEPTH`` layers: tok/s, TTFT p50/p99, admissions per window,
     beside the device's window rate, every request admitted.

Then the seconds each phase took, the redesigned kernels' earlier times
as PERF.md records them (``earlier_times``, beside this run's), the
kernels line (every kernel's launches on the main path, error,
times, bound from the bytes and operations of the timed work, and
library time where one PyTorch call computes the same function) and,
last, ``{"ok": true, "device": {...}}``.
There is no CPU path: without a CUDA device the script fails.
"""

import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from quanta_tpu_torch import eval as qeval
from quanta_tpu_torch import nn as qnn
from quanta_tpu_torch import profiling, ptq, train
from quanta_tpu_torch.benchmarks import (accuracy_bench, decode_bench, engine_sweep, kernel_bench,
                                         logits_gate, model_scale_bench, serve_bench, tp_bench,
                                         train_bench)
from quanta_tpu_torch.benchmarks.kernel_bench import L2_BYTES, copies_past_l2, time_ms
from quanta_tpu_torch.benchmarks.logits_gate import rel_l2, reordered_plain
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.metrics import MetricsRecorder
from quanta_tpu_torch.models import gpt2, hf, llama
from quanta_tpu_torch.ops import _build, adam8bit, attention, int4c, int8mm, matmul, quantize
from quanta_tpu_torch.optim import Adam8bit
from quanta_tpu_torch.parallel import spawn_local
from quanta_tpu_torch.serve import Engine, Request, kvcache
from quanta_tpu_torch.state.config import ConfigTree, QuantConfig
from quanta_tpu_torch.utils import transcode_codebook, transcode_params

# the module: the package attribute ``quanta_tpu_torch.nn.linear`` is the function
linear_mod = importlib.import_module("quanta_tpu_torch.nn.linear")

# (K, N) of the TinyLlama-1.1B linears and their count in one forward
SHAPES = {(2048, 2048): 2 * 22, (2048, 256): 2 * 22, (2048, 5632): 2 * 22,
          (5632, 2048): 22, (2048, 32000): 1}
PER_FORWARD = 7 * 22 + 1  # quantized linears in one TinyLlama forward
BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
NF4_REL_L2 = logits_gate.REL_L2
# int8 KV writes of the serve path (L, tokens.., nkv, hd), block = hd = 64:
# a prefill of 256 tokens, a window of 8 steps x 8 slots (every layer in
# one call, as the runner writes it), and one layer's window
KV_WRITES = {"prefill_256": (22, 256, 4, 64), "window_8x8": (22, 8, 8, 4, 64),
             "window_8x8_layer": (8, 8, 4, 64)}
# the fused K+V writes into an int8 pool of KV_PAGES pages of 16 (the
# closed trace's default pool), prefill and window, every layer at once
KV_PAGES = 1 + 8 * 16
# QLoRA training: batch x seq rows per linear; the (K, N) of the linears
# whose input needs a gradient and their count in one backward (all but
# layer 0's wq, wk and wv, which read the frozen embedding)
TRAIN_BATCH, TRAIN_SEQ = 4, 512
M_TRAIN = TRAIN_BATCH * TRAIN_SEQ
T_SHAPES = {(2048, 2048): 2 * 22 - 1, (2048, 256): 2 * 22 - 2, (2048, 5632): 2 * 22,
            (5632, 2048): 22, (2048, 32000): 1}
PER_BACKWARD = sum(T_SHAPES.values())  # 152
# Llama-2-7B's (K, N) and its QLoRA backward's M (batch 1 x seq 1024)
T_SHAPES_7B, M_TRAIN_7B = ((4096, 4096), (4096, 11008), (11008, 4096)), 1024
# Llama-2-13B's (K, N) with the head, and its QLoRA row's M (b1 x s512,
# phase 26)
T_SHAPES_13B, M_TRAIN_13B = ((5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000)), 512
# the adapter leaves of one QLoRA step: A of wq and wv (2048 x 8) and B of
# wq (8 x 2048), 64 blocks of 256 each, and B of wv (8 x 256, 8 blocks),
# per layer; the one-leaf op's sizes (an adapter's and a full-parameter
# leaf's blocks)
ADAM_SHAPES = [(2048, 8), (8, 2048), (2048, 8), (8, 256)] * 22
ADAM_BLOCKS = {"adapter_64": 64, "adapter_8": 8, "w_up_2048x5632": 2048 * 5632 // 256}
ADAM_WD = 1e-2  # the multi-leaf check also runs AdamW's decay (QLoRA's default is 0)
TRAIN_LR = 1e-3  # the reference's own QLoRA step test (tests/test_parallel.py:99)
# step-1 lora_b gradients, kernel route against plain, rel-L2 per tensor,
# each held to the floor that the plain route summed in another order
# (``reordered_plain``) sets for that same tensor in the same run: at most
# GRAD_FLOOR_X times it plus GRAD_FLOOR_ABS. The floor runs from ~0.009
# (deep wv) to ~0.03 (wq, whose gradient passes the softmax backward, where
# near-flat attention over random weights amplifies 1-ulp differences in
# dx), so one global bound would be loose on the quiet tensors.
GRAD_FLOOR_X, GRAD_FLOOR_ABS = logits_gate.FLOOR_X, logits_gate.FLOOR_ABS
# flash attention: TinyLlama-1.1B's training shape (GQA, rep 8, hd 64),
# Llama-2-7B's (MHA, hd 128), a cached prefill of 1024 tokens into 1152
# slots at q_start 0 and 64 beside a row whose kv_len is 0, the long-prompt
# decode's prefill (1024 tokens into its 1040-slot cache: a ragged last key
# tile) and long_prefill's reference row (S = T = 2048):
# (B, Sq, T, nh, nkv, hd, q_start, kv_len); each in bf16, the prefill in f32 too
FLASH_SHAPES = {
    "tinyllama_s1024": (2, 1024, 1024, 32, 4, 64, [0, 0], [1024, 1024]),
    "llama2_7b_s1024": (1, 1024, 1024, 32, 32, 128, [0], [1024]),
    "cached_prefill": (3, 1024, 1152, 32, 4, 64, [0, 64, 0], [1024, 1088, 0]),
    "prompt_prefill": (2, 1024, 1040, 32, 4, 64, [0, 0], [1024, 1024]),
    "long_prefill_s2048": (2, 2048, 2048, 32, 4, 64, [0, 0], [2048, 2048]),
}
FLASH_CASES = [(name, torch.bfloat16) for name in FLASH_SHAPES] + [("cached_prefill",
                                                                     torch.float32)]
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the times of the redesigned kernels before their Hopper redesigns, as
# PERF.md's kernel table records them: the first port's flash kernels at
# TinyLlama's shape (wmma through shared memory, no cp.async); its
# matmul_8bit and matmul_4bit (64x64 wmma tiles, no split-K, no pipeline)
# a decode step's 155 calls at M=8 (int8, nf4a); its matmul_8bit_t and
# matmul_4bit_t a QLoRA backward's 152 calls at M=2048 (int8, nf4); its
# matmul_int4c, matmul_int8_fused and matmul_int8 (64x64 wmma s8 tiles, no
# split-K, no pipeline) a decode step's 155 calls at M=8; its
# adam8bit_update (one 256-thread block per quantization block, one launch
# per leaf) a QLoRA step's 88 adapter leaves; and per call (µs) at the
# shapes named (quantize_blockwise: one warp per vector, the window's K).
# Printed on a line of their own, apart from the kernels line's measured
# times.
EARLIER_MS = {"flash_bwd_dq": 0.2697, "flash_bwd_dkv": 0.7539, "flash_fwd": 0.1999,
              "matmul_8bit": 23.588, "matmul_4bit": 20.954, "matmul_8bit_t": 79.827,
              "matmul_4bit_t": 67.866, "matmul_int4c": 10.977, "matmul_int8_fused": 8.832,
              "matmul_int8": 5.251, "adam8bit_update": 0.484}
EARLIER_US = {
    "matmul_8bit": {"M8_2048x5632": 120.4, "M8_5632x2048": 361.4, "M2048_2048x5632": 784.4},
    "matmul_4bit": {"M8_2048x5632": 105.3},
    "matmul_8bit_t": {"M2048_2048x5632": 894.2},
    "matmul_4bit_t": {"M2048_2048x5632": 798.5},
    "matmul_int4c": {"M8_2048x5632": 58.6},
    "matmul_int8_fused": {"M8_2048x5632": 65.5},
    "matmul_int8": {"M8_2048x5632": 29.0},
    "quantize_blockwise": {"window_8x8": 4.1},
}
LONG_BATCH, LONG_SEQ = 2, 1024  # QLoRA through flash: the reference's s1024 row
PROMPT_LEN, PROMPT_NEW = 1024, 16  # greedy decode with a long prompt
CROSSOVER_SEQS = (256, 512, 1024, 2048)  # long_prefill's S; 2048 is the reference's row
# 8-bit weights: the four formats, the f32 shape of the kernel checks,
# the PTQ path's calibration batches (of 256 corpus tokens) and perplexity
# stream, and the accuracy bench's pretraining steps here (the bench's own
# default, 3000, is the run PERF.md records). The W8A8 entropy row swings
# with the step count, because the KL clip it picks does: its delta
# measured 0.188, 0.014, 0.831, -0.005 and 0.034 at 600, 900, 1200, 1500
# and 3000 steps (PERF.md); 900 is the shortest count measured to pass.
EIGHT_BIT = ("int8", "nf8", "fp8", "int8a")
# the timed serve rows (phase 7b) and decode bench (phase 8) run the first
# TIMED_DEPTH of the 22 layers: timing rows only, whose host-bound loops
# took 420 s of a 785 s run at full depth (PERF.md); phases 5, 6 and 7a
# check the same paths at full depth
TIMED_DEPTH = 11
F32_SHAPE = (2048, 5632, M_TRAIN)
# matmul_8bit's middle M, on either side of its decode/prefill split (16
# and 32 take the decode kernels of 16 and 32 rows), at the attention and
# w_down shapes; and a ragged case (M and N off the tiles)
MM8_MID_MS, MM8_MID_SHAPES = (16, 32, 64, 256, 1024), ((2048, 2048), (5632, 2048))
MM8_RAGGED = (2048, 200, 77)
MM8T_MID_MS = (64, 256)  # matmul_8bit_t: one and two of its 128-row tiles
# matmul_4bit: the 16-entry codebooks of the path; M from decode (8 slots)
# across its decode/prefill split to a QLoRA forward (batch 4 x seq 512);
# a ragged case (M and N off the tiles)
FOUR_BIT = ("nf4a", "nf4", "int4", "fp4")
MM4_MS = (8, 16, 32, 64, 256, M_TRAIN)
MM4_RAGGED = (2048, 200, 77)
# phase 25's models' (K, N) (q/k/v/o, gate/up, down, the head), in nf4a,
# at the decode M, the serve trace's prefill buckets, phase 26's M and the
# prefill check's M: the split-K decode and wgmma prefill designs at K
# 4096, 5120, 11008 and 13824 (K_pad 11264 and 14336) and N up to 32000
MODEL_MM4 = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
             (5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000))
MODEL_MM4_MS = (8, 64, 256, 512, 1024)
# matmul_int4c: decode (8 slots), the top of its decode design, and
# decode_bench's and serve's prefill (batch 8 x 128 tokens)
I4C_MS = (8, 32, 1024)
# LLM.int8: decode (8 slots), the top of its decode design, the largest
# serve prefill bucket and decode_bench's prefill (batch 8 x 128 tokens);
# and a ragged case (K, N, M): K and N off the tiles, M off the prefill tile
I8_MS = (8, 32, 256, 1024)
I8_RAGGED = (203, 77, 300)
CALIB_BATCHES, CALIB_SEQ = 8, 256
PPL_TOKENS, PPL_SEQ, PPL_BATCH = 32768, 256, 8
PTQ_PPL_REL = 1e-2
ACC_STEPS = 900
ACC_PPL_REL = 1e-4
ACC_GATED = ("int8", "nf8", "llm_int8", "w8a8-minmax", "w8a8-percentile", "w8a8-entropy")
# GPT-2 small: the (K, N) of its four linears and their count in one
# forward (the tied head is dense); the kernel checks' M (nf4a in bf16
# and f32, LLM.int8 on f32 x); the decode prompts and new tokens
GPT2_SHAPES = {(768, 2304): 12, (768, 768): 12, (768, 3072): 12, (3072, 768): 12}
GPT2_MM4 = ((torch.bfloat16, (8, 1024)), (torch.float32, (8,)))
GPT2_I8_MS = (8, 256)
GPT2_PROMPT, GPT2_NEW, CONVERT_NEW = 128, 32, 16
# model scale (phase 25): the models, the Engine trace's requests here (the
# bench's own default is 32), the prompts of the prefill check
MODEL_SCALE = ("llama2-7b", "llama2-13b")
MODEL_SCALE_REQUESTS = 16
# tensor parallelism (phase 27): two ranks sharing the card over gloo; the
# 13B nf4a leg at full width and depth and the int8 leg at 2 layers
TP_RANKS = 2
TP_LEGS = (dict(model="13b", fmt="nf4a", new=32), dict(model="13b", fmt="int8", layers=2, new=8))
TP_TIMEOUT_S = 600
# the llm_int8 64-request trace (phase 28): one engine_sweep cell
SWEEP_CELL = dict(fmt="llm_int8", n_requests=64, rate=40.0, max_new=48, multi_step=8,
                  pipeline_depth=2, kv_quant=True)


# the H100 SXM's published rates (profiling.H100): device memory, and
# dense peaks by operand type
HBM_BYTES_S = profiling.H100.hbm_gbps * 1e9
PEAK_OPS_S = {"bf16": profiling.H100.bf16_tflops * 1e12,
              "int8": profiling.H100.int8_tops * 1e12, "f32": profiling.H100.f32_tflops * 1e12}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def add_work(work, name, n_bytes, ops, count=1):
    """Accumulate one kernel's bytes moved (each input read once, each
    output written once) and operations, ``count`` calls of them."""
    w = work.setdefault(name, [0.0, 0.0])
    w[0] += count * n_bytes
    w[1] += count * ops


def bound(work, kind):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of its bytes over the memory rate and its operations
    over the peak rate of their type."""
    t_bytes = work[0] / HBM_BYTES_S * 1e3
    t_ops = work[1] / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_checks(dev, work):
    """matmul_4bit against its plain version at the five TinyLlama (K, N)
    for M in ``MM4_MS`` (both sides of its decode/prefill split) and at
    ``MM4_RAGGED``, every 16-entry codebook, and at Llama-2-7B's and
    -13B's (K, N) for M in ``MODEL_MM4_MS`` in nf4a, within 2 bf16 ulps of
    max|plain|, bit-identical over two calls, its design per row (split-K
    decode up to M = 32, wgmma prefill above); and
    matmul_int4c bit for bit at M in ``I4C_MS``, its design per row. µs
    per call with the weights rotated past the L2. Returns ms of one
    decode step's calls (M=8; nf4a for matmul_4bit) as [kernel, plain],
    for matmul_4bit also the dense control (cuBLAS ``torch.matmul`` of the
    dequantized bf16 weights) and the same three for one QLoRA forward's
    calls (M=2048, nf4), for matmul_int4c the same three for one prefill
    forward's calls (M=1024; dense: ``torch._int_mm`` of the int8
    activations and the unpacked int8 weight); the µs that ``EARLIER_US``
    names; the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(1)
    per_step = {"matmul_4bit": [0.0] * 3, "matmul_int4c": [0.0, 0.0],
                "matmul_4bit_qlora_forward": [0.0] * 3, "matmul_int4c_prefill": [0.0] * 3}
    max_err = {"matmul_4bit": 0.0, "matmul_int4c": 0.0}
    per_call = {"matmul_4bit": {}, "matmul_int4c": {}}
    cases = ([(k, n, m, FOUR_BIT) for (k, n) in SHAPES for m in MM4_MS]
             + [(*MM4_RAGGED, FOUR_BIT)]
             + [(k, n, m, ("nf4a",)) for (k, n) in MODEL_MM4 for m in MODEL_MM4_MS])
    for k, n, m, fmts in cases:
        count = SHAPES.get((k, n), 0)
        n_codes = -(-n // 128) * 128  # the quantizer pads N to 128; a ragged case cuts it back
        w = (torch.randn((k, n_codes), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        iters = 50 if m <= 64 else 10
        design = matmul.matmul_4bit_design(m, n, -(-k // 1024) * 1024)  # K_pad: 16 blocks of 64
        check(design["design"] == ("decode" if m <= 32 else "prefill"),
              f"matmul_4bit M={m} K={k} N={n}: design {design}")
        for fmt in fmts:
            qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
            codes, scales = qt.codes[:, :n].contiguous(), qt.scale[:, :n].contiguous()

            def run(use_kernel, ws, fmt=fmt):
                return lambda i: matmul.matmul_4bit(
                    x, *ws[i % len(ws)], codebook=fmt, block=64, use_kernel=use_kernel)
            out = run(True, [(codes, scales)])(0)
            ref = run(False, [(codes, scales)])(0)
            err = (out.float() - ref.float()).abs().max().item()
            tol = 2 * BF16_ULP * ref.float().abs().max().item()
            check(out.shape == ref.shape and torch.isfinite(out).all().item(),
                  f"matmul_4bit {fmt} M={m} K={k} N={n}: bad output")
            check(err <= tol, f"matmul_4bit {fmt} M={m} K={k} N={n}: err {err} > {tol}")
            same = torch.equal(out, run(True, [(codes, scales)])(0))
            check(same, f"matmul_4bit {fmt} M={m} K={k} N={n}: two calls differ")
            max_err["matmul_4bit"] = max(max_err["matmul_4bit"], err)
            ws = copies_past_l2(codes, scales)
            row = dict(kernel="matmul_4bit", fmt=fmt, M=m, K=k, N=n, max_abs_err=err, tol=tol,
                       us=time_ms(run(True, ws), iters) * 1e3, bit_identical_over_two_calls=same,
                       design=design)
            acc = {(8, "nf4a"): per_step["matmul_4bit"],
                   (M_TRAIN, "nf4"): per_step["matmul_4bit_qlora_forward"]}.get((m, fmt))
            if acc is not None and count:
                # the rows past k (the quantizer's K padding) meet zero-padded x
                wd = matmul._dequant_4bit(qt.codes, qt.scale, fmt, 64, torch.bfloat16)[:k]
                dense = [d for (d,) in copies_past_l2(wd)]
                row["plain_us"] = time_ms(run(False, ws), iters) * 1e3
                row["dense_us"] = time_ms(lambda i: x @ dense[i % len(dense)], iters) * 1e3
                for j, key in enumerate(("us", "plain_us", "dense_us")):
                    acc[j] += count * row[key] / 1e3
                if m == 8:
                    add_work(work, "matmul_4bit", nbytes(x, qt.codes, qt.scale, out),
                             2 * m * k * n, count)
            if fmt == "nf4a" and f"M{m}_{k}x{n}" in EARLIER_US["matmul_4bit"]:
                per_call["matmul_4bit"][f"M{m}_{k}x{n}"] = row["us"]
            if m >= 256:
                row["tflops"] = 2 * m * k * n / (row["us"] * 1e-6) / 1e12
            emit(kernel_check=row)
    for (k, n), count in SHAPES.items():
        # int4c: the kernel on the activations the wrapper quantizes
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qw = int4c.quantize_int4c_weight(w)
        # the unpacked int8 weight of the dense control (torch._int_mm), row-
        # major and column-major: the faster of the two is the control
        w8 = int4c._unpack_values(qw.codes).to(torch.int8)
        for m in I4C_MS:
            x2 = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16).float()
            iters = 50 if m <= 32 else 10
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
            row = dict(kernel="matmul_int4c", fmt="int4c", M=m, K=k, N=n, max_abs_err=err,
                       tol=0.0, us=ms * 1e3, plain_us=plain_ms * 1e3,
                       tops=2 * m * k * n / (ms * 1e-3) / 1e12,
                       design=int4c.matmul_int4c_design(m, n, k))
            if m > 16:  # torch._int_mm takes M > 16 only
                for layout in ("row", "col"):
                    dense = [d.T.contiguous().T if layout == "col" else d
                             for (d,) in copies_past_l2(w8)]
                    us = time_ms(lambda i: torch._int_mm(xq, dense[i % len(dense)]), iters) * 1e3
                    if us < row.get("dense_us", math.inf):
                        row.update(dense_us=us, dense_layout=layout)
            if m == 8:
                per_step["matmul_int4c"][0] += count * ms
                per_step["matmul_int4c"][1] += count * plain_ms
                add_work(work, "matmul_int4c", nbytes(xq, qw.codes, rs, qw.scale, out),
                         2 * m * k * n, count)
            if m == 1024:
                for j, key in enumerate(("us", "plain_us", "dense_us")):
                    per_step["matmul_int4c_prefill"][j] += count * row[key] / 1e3
            if f"M{m}_{k}x{n}" in EARLIER_US["matmul_int4c"]:
                per_call["matmul_int4c"][f"M{m}_{k}x{n}"] = row["us"]
            emit(kernel_check=row)
    return per_step, per_call, max_err


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


def int8_kernel_checks(dev, work):
    """matmul_int8_fused and matmul_int8 against their plain versions at
    the five TinyLlama (K, N) for M in ``I8_MS`` (both sides of their
    decode/prefill split), f32 x with the quantizer's outlier set, and at
    ``I8_RAGGED`` on random codes, bit for bit, bit-identical over two
    calls, the design per row; µs per call with the weights rotated past
    the L2, above M = 16 beside a dense control (``torch._int_mm`` of the
    int8 activations and the codes, row- or column-major, whichever is
    faster: no scales, no outliers). Returns ms of one decode step's calls
    (M=8) as [kernel, plain] and, under ``<kernel>_prefill``, of one
    prefill forward's calls (M=1024) as [kernel, plain, dense]; the µs that
    ``EARLIER_US`` names; the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(2)
    names = ("matmul_int8_fused", "matmul_int8")
    per_step = {name: [0.0, 0.0] for name in names}
    per_step.update({f"{name}_prefill": [0.0] * 3 for name in names})
    max_err = dict.fromkeys(names, 0.0)
    per_call = {name: {} for name in names}
    k_r, n_r, m_r = I8_RAGGED
    for (k, n), ms in [*((shape, I8_MS) for shape in SHAPES), ((k_r, n_r), (m_r,))]:
        count = SHAPES.get((k, n), 0)
        if count:
            w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
            qw = int8mm.quantize_int8_weight(w)
            codes, cs = qw.codes, qw.scale
        else:  # K and N off the tiles: random codes and scales
            codes = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
            cs = torch.rand(n, generator=gen, device=dev) * 0.01
        ws = copies_past_l2(codes, cs)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=dev)
            if count:
                x[:, qw.outlier_idx[:4].long()] *= 20.0  # systematic outlier features
                # the operands matmul_int8 hands the kernels
                y_out = x.index_select(1, qw.outlier_idx) @ qw.w_outlier.float()
                xa = x.abs()
                xa[:, qw.outlier_idx] = 0.0
                rs = torch.clamp(xa.amax(dim=1) / 127.0, min=1e-12)
            else:
                x *= 30.0
                rs = torch.rand(m, generator=gen, device=dev) + 0.05
                y_out = torch.randn((m, n), generator=gen, device=dev)
            xq = int8mm.quantize_rows(x, rs)
            runs = {
                "matmul_int8_fused": lambda uk, ws: lambda i: int8mm.matmul_int8_fused(
                    x, ws[i % len(ws)][0], rs, ws[i % len(ws)][1], y_out, use_kernel=uk),
                "matmul_int8": lambda uk, ws: lambda i: int8mm.matmul_int8_kernel(
                    xq, ws[i % len(ws)][0], rs, ws[i % len(ws)][1], use_kernel=uk),
            }
            operands = {"matmul_int8_fused": (x, codes, rs, cs, y_out),
                        "matmul_int8": (xq, codes, rs, cs)}
            iters = 50 if m <= 32 else 10
            dense = {}
            if m > 16 and count:  # torch._int_mm takes M > 16 and K, N multiples of 8
                for layout in ("row", "col"):
                    ds = [d.T.contiguous().T if layout == "col" else d for (d, _) in ws]
                    us = time_ms(lambda i: torch._int_mm(xq, ds[i % len(ds)]), iters) * 1e3
                    if us < dense.get("dense_us", math.inf):
                        dense.update(dense_us=us, dense_layout=layout)
            for name, run in runs.items():
                out = run(True, [(codes, cs)])(0)
                ref = run(False, [(codes, cs)])(0)
                err = (out - ref).abs().max().item()
                check(torch.isfinite(out).all().item(), f"{name} non-finite")
                check(torch.equal(out, ref), f"{name} M={m} K={k} N={n} not bit-exact: {err}")
                same = torch.equal(out, run(True, [(codes, cs)])(0))
                check(same, f"{name} M={m} K={k} N={n}: two calls differ")
                max_err[name] = max(max_err[name], err)
                ms_, plain_ms = time_ms(run(True, ws), iters), time_ms(run(False, ws), iters)
                row = dict(kernel=name, fmt="llm_int8", M=m, K=k, N=n, max_abs_err=err, tol=0.0,
                           us=ms_ * 1e3, plain_us=plain_ms * 1e3,
                           tops=2 * m * k * n / (ms_ * 1e-3) / 1e12,
                           bit_identical_over_two_calls=same, **dense,
                           design=int8mm.matmul_int8_design(m, n, k,
                                                            fused=name == "matmul_int8_fused"))
                if m == 8 and count:
                    per_step[name][0] += count * ms_
                    per_step[name][1] += count * plain_ms
                    add_work(work, name, nbytes(*operands[name], out), 2 * m * k * n, count)
                if m == 1024 and count:
                    for j, key in enumerate(("us", "plain_us", "dense_us")):
                        per_step[f"{name}_prefill"][j] += count * row[key] / 1e3
                if f"M{m}_{k}x{n}" in EARLIER_US[name]:
                    per_call[name][f"M{m}_{k}x{n}"] = row["us"]
                emit(kernel_check=row)
    return per_step, per_call, max_err


def _kv_rows(gen, dev, n_rows):
    """Destination rows in a KV_PAGES-page pool of 16: unique, except that
    every 7th repeats a row of the null page 0, as bucket padding and
    inactive slots do."""
    perm = torch.randperm((KV_PAGES - 1) * 16, generator=gen, device=dev)[:n_rows] + 16
    return torch.where(torch.arange(n_rows, device=dev) % 7 == 6, perm % 16, perm)


def quantize_checks(dev, work):
    """quantize_blockwise (int8_sym, block 64) at the int8 KV writes, bit
    for bit, µs per call; then the fused K+V write into the int8 pool
    (``serve.kvcache.write_rows``) at the prefill and window shapes
    against quantize_kv plus index_put, equal outside the null page 0
    (whose rows repeat; attention never reads it), µs per call, inputs
    rotated past the L2, beside the unfused route (two calls of the op and
    four index_put scatters). Returns the window write's (kernel, plain) ms,
    the op's µs at the window's K and the largest difference."""
    gen = torch.Generator(device=dev).manual_seed(3)
    op_us, max_err = {}, 0.0
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
        ms = time_ms(lambda i: quantize.quantize_blockwise(xs[i % len(xs)][0], fmt="int8_sym",
                                                           block=64), 100)
        op_us[name] = ms * 1e3
        emit(kernel_check=dict(kernel="quantize_blockwise", fmt="int8_sym", shape=list(shape),
                               max_abs_err=err, tol=0.0, us=ms * 1e3))
    # the codebook branch, which the serve path does not take
    x = torch.randn((4096 * 64,), generator=gen, device=dev)
    for fmt in ("nf4", "nf4a", "fp4"):
        out = quantize.quantize_blockwise(x, fmt=fmt, block=64, use_kernel=True)
        ref = quantize.quantize_blockwise(x, fmt=fmt, block=64, use_kernel=False)
        check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
              f"quantize_blockwise {fmt} not bit-exact")

    cfg = llama.LlamaConfig.tinyllama_1b()
    write_ms = {}
    for name in ("prefill_256", "window_8x8"):
        shape = KV_WRITES[name]
        n_rows = math.prod(shape[1:-2])
        k, v = ((torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)
                .reshape(cfg.n_layers, n_rows, *shape[-2:]) for _ in range(2))
        k[:, 3, 1] = 0.0
        v[:, 5] = 0.0
        rows = _kv_rows(gen, dev, n_rows)
        pools = {uk: kvcache.init_pool(cfg, KV_PAGES, 16, kv_quant=True, device=dev)
                 for uk in (True, False)}
        for uk, pool in pools.items():
            kvcache.write_rows(pool, rows, k, v, use_kernel=uk)
        err = max((pools[True][t][:, 1:].float() - pools[False][t][:, 1:].float())
                  .abs().max().item() for t in pools[True])
        check(all(torch.equal(pools[True][t][:, 1:], pools[False][t][:, 1:])
                  for t in pools[True]),
              f"kv write {name}: the pool outside page 0 differs from quantize_kv + index_put "
              f"by {err}")
        max_err = max(max_err, err)
        sets = copies_past_l2(k, v)

        def run(uk):
            return lambda i: kvcache.write_rows(pools[uk], rows, *sets[i % len(sets)],
                                                use_kernel=uk)

        def unfused(i):  # the route before the fused write: two op calls, four scatters
            flat = {t: x.view(cfg.n_layers, KV_PAGES * 16, *x.shape[3:])
                    for t, x in pools[True].items()}
            for t, x in zip(("k", "v"), sets[i % len(sets)]):
                codes, scale = kvcache.quantize_kv(x)
                flat[t][:, rows] = codes
                flat[f"{t}_scale"][:, rows] = scale
        write_ms[name] = (time_ms(run(True), 100), time_ms(run(False), 20))
        unfused_us = time_ms(unfused, 50) * 1e3
        if name == "window_8x8":
            n_vec = 2 * k.numel() // 64
            add_work(work, "quantize_blockwise", nbytes(k, v, rows) + n_vec * (64 + 4),
                     3 * 2 * k.numel())
        emit(kernel_check=dict(kernel="quantize_blockwise", write="kv_int8_pool", kv=name,
                               shape=list(k.shape), pool_pages=KV_PAGES, max_abs_err=err,
                               tol=0.0, us=write_ms[name][0] * 1e3,
                               plain_us=write_ms[name][1] * 1e3, unfused_us=unfused_us))
    return write_ms["window_8x8"], op_us["window_8x8"], max_err


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


def serve_closed_trace(dev, cfg, params, arch="llama", per_forward=PER_FORWARD):
    """8 requests, all submitted before Engine.run, so the schedule does
    not depend on speed: every request is admitted in the first step
    (8 slots; the default pool holds them all), takes its first token from
    its prefill and 15 more from two 8-step windows (the last one's
    overshoot trimmed). The design thus implies 8 prefills and 2 windows:
    matmul_int8_fused launches ``per_forward`` (155 for TinyLlama, 48 for
    GPT-2) x (8 + 2 x 8) forwards, and quantize_blockwise one (K and V
    together) x (8 prefill writes + 2 window writes)."""
    trace = serve_bench.make_trace(8, 24.0, serve_bench.MAX_PROMPT, 16, cfg.vocab_size, seed=0)
    outs, kernel_counts = {}, None
    for use_kernel in (None, False):
        eng = Engine(params, cfg, n_slots=8, page_size=16,
                     prefill_buckets=serve_bench.PREFILL_BUCKETS, kv_quant=True,
                     multi_step=8, use_kernel=use_kernel, arch=arch)
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
            expected["matmul_int8_fused"] = per_forward * (8 + 2 * 8)
            expected["quantize_blockwise"] = 8 + 2
            kernel_counts = counts
        check(counts == expected, f"{arch} closed trace use_kernel={use_kernel}: launches "
                                  f"{counts}, expected {expected}")
        emit(serve_closed=dict(arch=arch, n_layers=cfg.n_layers, use_kernel=use_kernel,
                               seconds=wall, launches=counts,
                               prompt_lens=[len(p) for _, p in trace], **m))
    for uid, toks in outs[None].items():
        check(toks == outs[False][uid], f"{arch} closed trace: request {uid}'s tokens through "
                                        "the kernels differ from the plain path's")
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
        emit(serve_row={"n_layers": cfg.n_layers, **{k: m[k] for k in (
            "fmt", "throughput_tok_s", "ttft_p50_ms", "ttft_p99_ms", "decode_steps",
            "preemptions", "kv_pool_mib", "serve_seconds", "output_tokens", "admissions",
            "window_upload_p50_s", "window_upload_p99_s", "launches", "window")}})


def transposed_checks(dev, work):
    """matmul_4bit_t at the backward's shapes (TinyLlama's at M = 2048,
    Llama-2-7B's at M = 1024, Llama-2-13B's at M = 512), bf16 g in nf4 and
    nf4a within 2 bf16 ulps of max|plain| and bit-identical over two calls,
    its design per row, and one f32 shape; µs per call with the weights
    rotated past the L2.
    Returns one TinyLlama backward's calls (nf4) in ms, [kernel, plain,
    dense] (dense: cuBLAS ``g @ W_deq^T`` of the dequantized bf16 weight),
    the µs that ``EARLIER_US`` names, and the largest error."""
    gen = torch.Generator(device=dev).manual_seed(4)
    per_step, per_call, max_err = [0.0] * 3, {}, 0.0
    cases = [(k, n, m, fmt, torch.bfloat16)
             for (k, n), m in ([(s, M_TRAIN) for s in T_SHAPES] + [(s, M_TRAIN_7B)
                                                                   for s in T_SHAPES_7B]
                               + [(s, M_TRAIN_13B) for s in T_SHAPES_13B])
             for fmt in ("nf4", "nf4a")]
    cases.append((*F32_SHAPE[:2], M_TRAIN, "nf4", torch.float32))
    for k, n, m, fmt, dtype in cases:
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
        g = torch.randn((m, n), generator=gen, device=dev).to(dtype)

        def run(use_kernel, ws):
            return lambda i: matmul.matmul_4bit_t(g, *ws[i % len(ws)], codebook=fmt, block=64,
                                                  use_kernel=use_kernel)
        out = run(True, [(qt.codes, qt.scale)])(0)
        ref = run(False, [(qt.codes, qt.scale)])(0)
        err = (out.float() - ref.float()).abs().max().item()
        rel = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
        tol = rel * ref.float().abs().max().item()
        check(out.shape == (m, qt.codes.shape[0] * 2) and torch.isfinite(out).all().item(),
              f"matmul_4bit_t {fmt} K={k} N={n}: bad output")
        check(err <= tol, f"matmul_4bit_t {fmt} {dtype} M={m} K={k} N={n}: err {err} > {tol}")
        ws = copies_past_l2(qt.codes, qt.scale)
        ms = time_ms(run(True, ws), 10)
        max_err = max(max_err, err)
        row = dict(kernel="matmul_4bit_t", fmt=fmt, dtype=str(dtype), M=m, K=k, N=n,
                   max_abs_err=err, tol=tol, us=ms * 1e3,
                   tflops=2 * m * k * n / (ms * 1e-3) / 1e12)
        if dtype == torch.bfloat16:
            same = torch.equal(out, run(True, [(qt.codes, qt.scale)])(0))
            check(same, f"matmul_4bit_t {fmt} M={m} K={k} N={n}: two calls differ")
            row.update(bit_identical_over_two_calls=same,
                       design=matmul.matmul_4bit_t_design(m, n, k))
        if fmt == "nf4" and (m, dtype) == (M_TRAIN, torch.bfloat16):
            wd = matmul._dequant_4bit(qt.codes, qt.scale, fmt, 64, torch.bfloat16)[:k]
            dense = [d.T.contiguous() for (d,) in copies_past_l2(wd)]
            row["plain_us"] = time_ms(run(False, ws), 10) * 1e3
            row["dense_us"] = time_ms(lambda i: g @ dense[i % len(dense)], 10) * 1e3
            for j, key in enumerate(("us", "plain_us", "dense_us")):
                per_step[j] += T_SHAPES[(k, n)] * row[key] / 1e3
            add_work(work, "matmul_4bit_t", nbytes(g, qt.codes, qt.scale, out),
                     2 * m * k * n, T_SHAPES[(k, n)])
            if f"M{m}_{k}x{n}" in EARLIER_US["matmul_4bit_t"]:
                per_call[f"M{m}_{k}x{n}"] = row["us"]
        emit(kernel_check=row)
    return per_step, per_call, max_err


def _adam_state(nb, dev):
    return {"m_codes": torch.zeros((nb, 256), dtype=torch.int8, device=dev),
            "m_scale": torch.full((nb, 1), 1e-12, device=dev),
            "v_codes": torch.zeros((nb, 256), dtype=torch.uint8, device=dev),
            "v_scale": torch.full((nb, 1), 1e-12, device=dev)}


def adam_checks(dev, work):
    """The optimizer's multi-leaf step over one QLoRA step's 88 bf16
    adapter leaves (``ADAM_SHAPES``), one launch, against its plain version
    over 5 chained steps, each route feeding itself, with and without
    decay: every p and state tensor bit for bit (one leaf's first gradient
    block all zero); ms per step, inputs rotated past the L2. Then the
    one-leaf op (``adam8bit_update``) bit for bit over 5 steps at
    ``ADAM_BLOCKS``. Returns the step's ms (kernel, plain) and the largest
    difference."""
    gen = torch.Generator(device=dev).manual_seed(5)
    lr = torch.tensor(TRAIN_LR, device=dev)  # on the device, as the optimizer passes it
    max_err = 0.0

    def leaves(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        params = [(torch.randn(s, generator=g, device=dev) * 0.02).to(torch.bfloat16)
                  for s in ADAM_SHAPES]
        return params, [_adam_state(-(-p.numel() // 256), dev) for p in params]

    for wd in (0.0, ADAM_WD):
        runs = {uk: leaves(0) for uk in (True, False)}
        for step in range(1, 6):
            grads = [(torch.randn(s, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
                     for s in ADAM_SHAPES]
            grads[0].view(-1)[:256] = 0.0
            count = torch.tensor(float(step), device=dev)
            scalars = torch.stack([lr, 1.0 - 0.9 ** count, 1.0 - 0.999 ** count])
            for uk, (params, states) in runs.items():
                adam8bit.adam8bit_step(params, grads, states, scalars, lr=TRAIN_LR,
                                       weight_decay=wd, use_kernel=uk)
            pairs = list(zip(runs[True][0], runs[False][0])) + [
                (sa[k], sb[k]) for sa, sb in zip(runs[True][1], runs[False][1])
                for k in adam8bit.STATE_KEYS]
            err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
            max_err = max(max_err, err)
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"adam8bit_step wd {wd} step {step} not bit-exact: err {err}")
        emit(kernel_check=dict(kernel="adam8bit_update", step="multi_leaf", leaves=len(ADAM_SHAPES),
                               dtype="bf16", weight_decay=wd, steps=5, max_abs_err=max_err,
                               tol=0.0))
    # (params, states, grads) sets, together more than the L2
    set_bytes = 2 * nbytes(*runs[True][0]) + nbytes(*(t for st in runs[True][1]
                                                      for t in st.values()))
    sets = [(*leaves(i), [g.clone() for g in grads])
            for i in range(math.ceil(2 * L2_BYTES / set_bytes))]

    # the kernel through a LeafTable per set, as the optimizer keeps one
    tables = [adam8bit.LeafTable(p, st) for p, st, _ in sets]
    ms = time_ms(lambda i: tables[i % len(sets)].step(sets[i % len(sets)][2], scalars,
                                                       lr=TRAIN_LR), 50)
    plain_ms = time_ms(lambda i: adam8bit.adam8bit_step_reference(
        sets[i % len(sets)][0], sets[i % len(sets)][2], sets[i % len(sets)][1], scalars,
        lr=TRAIN_LR), 5)
    params, states, grads = sets[0]
    state_bytes = nbytes(*(t for st in states for t in st.values()))
    add_work(work, "adam8bit_update", nbytes(*grads) + 2 * nbytes(*params) + 2 * state_bytes,
             20 * sum(p.numel() for p in params))
    emit(kernel_check=dict(kernel="adam8bit_update", step="multi_leaf", leaves=len(ADAM_SHAPES),
                           ms=ms, plain_ms=plain_ms, sets=len(sets)))

    for name, nb in ADAM_BLOCKS.items():
        state = {uk: list(_adam_state(nb, dev).values()) for uk in (True, False)}
        leaf_err = 0.0
        for step in range(1, 6):
            g = torch.randn((nb, 256), generator=gen, device=dev) * 1e-3
            g[0] = 0.0
            count = torch.tensor(float(step), device=dev)
            bc1, bc2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
            outs = {uk: adam8bit.adam8bit_update(g, *state[uk], lr, bc1, bc2, use_kernel=uk)
                    for uk in (True, False)}
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(outs[True], outs[False]))
            leaf_err = max(leaf_err, err)
            check(all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(outs[True], outs[False])),
                  f"adam8bit_update {name} step {step} not bit-exact: err {err}")
            check(torch.count_nonzero(outs[True][0][0]).item() == 0,
                  f"adam8bit_update {name}: the all-zero block moved")
            state = {uk: list(outs[uk][1:]) for uk in (True, False)}
        max_err = max(max_err, leaf_err)
        emit(kernel_check=dict(kernel="adam8bit_update", leaf=name, blocks=nb, steps=5,
                               max_abs_err=leaf_err, tol=0.0))
    return (ms, plain_ms), max_err


def _adapter_grads(adapters):
    """(A, B) gradients in f32 of every adapter, layer by layer, wq then wv."""
    return [(ad[n]["a"].grad.float(), ad[n]["b"].grad.float())
            for ad in adapters for n in ("wq", "wv")]


def qlora_path(dev, cfg, base, fmt="nf4", kernels=("matmul_4bit", "matmul_4bit_t")):
    """3 QLoRA steps through the kernels and 3 through the plain versions,
    from the same adapters on one fixed batch, launches counted per step;
    then one step through the reordered plain versions (the noise floor).
    ``kernels``: the forward and transposed kernels of the base's layout.
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
            with reordered_plain():
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
            expected.update({kernels[0]: per_forward, kernels[1]: PER_BACKWARD,
                             "adam8bit_update": 1})
        for i, c in enumerate(counts):
            check(c == expected, f"qlora {fmt} route {route} step {i + 1}: launches {c}, "
                                 f"expected {expected}")
        check(all(math.isfinite(v) for v in losses), f"qlora {fmt} route {route}: {losses}")
        check(losses[2] < losses[0], f"qlora {fmt} route {route}: loss did not fall: {losses}")
        runs[route] = (losses, grads)
        if route is None:
            kernel_launches = {k: sum(c[k] for c in counts) for k in expected}
        emit(qlora_path=dict(base=fmt, route="kernels" if route is None else "plain", lr=TRAIN_LR,
                             losses=losses, step_seconds=seconds, launches_per_step=counts[0]))
    (lk, gk), (lp, gp), (lr_, gr) = runs[None], runs[False], runs["reordered"]
    loss_rel = abs(lk[0] - lp[0]) / abs(lp[0])
    check(loss_rel <= 1e-2, f"qlora {fmt} step-1 loss {lk[0]} vs plain {lp[0]}")

    b_rel, floor = [], []
    for (ak, bk), (ap, bp), (_, br) in zip(gk, gp, gr):
        check(torch.count_nonzero(ak).item() == 0 and torch.count_nonzero(ap).item() == 0,
              "qlora: lora_a gradients must be zero at step 1 (B starts at zero)")
        b_rel.append(rel_l2(bk, bp))
        floor.append(rel_l2(br, bp))
    tols = [GRAD_FLOOR_X * f + GRAD_FLOOR_ABS for f in floor]
    emit(qlora_check=dict(base=fmt, step1_loss_rel=loss_rel, tol=1e-2, lora_b_grad_rel_l2_max=max(b_rel),
                          lora_b_grad_rel_l2=b_rel, grad_tols=tols,
                          reordered_plain_loss_rel=abs(lr_[0] - lp[0]) / abs(lp[0]),
                          reordered_plain_rel_l2_max=max(floor), reordered_plain_rel_l2=floor))
    for i, (b, tol) in enumerate(zip(b_rel, tols)):
        check(b <= tol, f"qlora {fmt} layer {i // 2} {('wq', 'wv')[i % 2]} lora_b gradient "
                        f"rel-L2 {b} > {tol} ({GRAD_FLOOR_X} x its floor + {GRAD_FLOOR_ABS})")
    return kernel_launches


def live_pairs(q_start, kv_len, sq, t, causal=True):
    """(query, key) pairs the masks leave live, summed over the batch rows."""
    total = 0
    for qs, kl in zip(q_start, kv_len):
        horizon = np.full(sq, min(kl, t))
        if causal:
            horizon = np.minimum(horizon, qs + np.arange(sq) + 1)
        total += int(np.maximum(horizon, 0).sum())
    return total


def flash_checks(dev, work):
    """The three flash kernels against their plain versions on the same
    inputs (the backward ones on the plain forward's lse and D), dead rows
    included; at the S = T shapes, times of the kernels, their plain
    versions and SDPA (forward; backward alone, dq, dk and dv in one call;
    both). Returns the times at TinyLlama's shape and the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(6)
    times, max_err = {}, dict.fromkeys(FLASH_KERNELS, 0.0)
    for name, dtype in FLASH_CASES:
        b, sq, t, nh, nkv, hd, q_start, kv_len = FLASH_SHAPES[name]
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for shape in
                       ((b, sq, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd), (b, sq, nh, hd)))
        qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        out, lse = attention.flash_forward(q, k, v, qs, kl, save_lse=True, use_kernel=True)
        ref, ref_lse = attention.flash_forward_reference(q, k, v, qs, kl)
        delta = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, ref_lse, delta, qs, kl)
        dq = attention.flash_bwd_dq(*bwd, use_kernel=True)
        dk, dv = attention.flash_bwd_dkv(*bwd, use_kernel=True)
        again = (attention.flash_bwd_dq(*bwd, use_kernel=True),
                 *attention.flash_bwd_dkv(*bwd, use_kernel=True))
        check(all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
              f"flash backward {name} {dtype}: two calls differ")
        refs = {"dq": attention.flash_bwd_dq_reference(*bwd)}
        refs["dk"], refs["dv"] = attention.flash_bwd_dkv_reference(*bwd)
        grads = {"dq": dq, "dk": dk, "dv": dv}
        live = kl > 0
        check(all(torch.isfinite(x).all().item() for x in (out, lse, dq, dk, dv)),
              f"flash {name} {dtype}: non-finite output")
        check(bool((lse[~live] == attention.DEAD_LSE).all()) and not out[~live].any()
              and not any(g[~live].any() for g in grads.values()),
              f"flash {name}: dead rows must give zeros, lse 1e30 and zero gradients")
        big = ref.float().abs().max().item()
        out_err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse[live] - ref_lse[live]).abs().max().item()
        grad_err = {n: (g - refs[n]).abs().max().item() for n, g in grads.items()}
        grad_rel = {n: rel_l2(g, refs[n]) for n, g in grads.items()}
        if dtype == torch.bfloat16:
            out_tol, grad_tol = 2 * BF16_ULP * big, {n: 2e-2 for n in grads}
            check(rel_l2(out, ref) <= 1e-2, f"flash_fwd {name}: rel-L2 {rel_l2(out, ref)}")
            for n in grads:
                check(grad_rel[n] <= 2e-2, f"flash {n} {name}: rel-L2 {grad_rel[n]} > 2e-2")
        else:
            out_tol = 1e-5 * big
            grad_tol = {n: 1e-4 * r.abs().max().item() for n, r in refs.items()}
            for n in grads:
                check(grad_err[n] <= grad_tol[n], f"flash {n} {name} f32: err {grad_err[n]} "
                                                  f"> {grad_tol[n]}")
        check(out_err <= out_tol, f"flash_fwd {name} {dtype}: err {out_err} > {out_tol}")
        check(lse_err <= 1e-4, f"flash_fwd {name} {dtype}: lse err {lse_err} > 1e-4")
        max_err["flash_fwd"] = max(max_err["flash_fwd"], out_err)
        max_err["flash_bwd_dq"] = max(max_err["flash_bwd_dq"], grad_err["dq"])
        max_err["flash_bwd_dkv"] = max(max_err["flash_bwd_dkv"], grad_err["dk"], grad_err["dv"])
        row = dict(kernel="flash", case=name, dtype=str(dtype), shape=[b, sq, t, nh, nkv, hd],
                   q_start=q_start, kv_len=kv_len, out_max_abs_err=out_err,
                   out_tol=out_tol, out_rel_l2=rel_l2(out, ref), lse_max_abs_err=lse_err,
                   lse_tol=1e-4, grad_max_abs_err=grad_err, grad_rel_l2=grad_rel,
                   grad_tol=grad_tol if dtype == torch.float32 else "rel-L2 2e-2",
                   dead_rows=int((~live).sum()), bwd_bit_identical_over_two_calls=True)
        if sq == t and dtype == torch.bfloat16:
            row.update(flash_times(q, k, v, do, qs, kl, ref_lse, delta))
            times[name] = row
            if name == "tinyllama_s1024":
                pairs = nh * live_pairs(q_start, kv_len, sq, t)
                add_work(work, "flash_fwd", nbytes(q, k, v, out, lse), 4 * hd * pairs)
                add_work(work, "flash_bwd_dq", nbytes(q, k, v, do, lse, delta, dq), 6 * hd * pairs)
                add_work(work, "flash_bwd_dkv", nbytes(q, k, v, do, lse, delta, dk, dv),
                         8 * hd * pairs)
        emit(kernel_check=row)
    for hd, shape in ((32, "tinyllama_s1024"), (64, "tinyllama_s1024"),
                      (128, "llama2_7b_s1024")):
        b, sq, t, nh, nkv = FLASH_SHAPES[shape][:5]
        emit(flash_bwd_design=dict(head_dim=hd, shape=[b, sq, t, nh, nkv, hd], **{
            name: attention.flash_bwd_design(name, b, sq, t, nh, nkv, hd)
            for name in ("flash_bwd_dq", "flash_bwd_dkv")}))
        emit(flash_fwd_design=dict(head_dim=hd, shape=[b, sq, t, nh, nkv, hd],
                                   **attention.flash_fwd_design(b, sq, nh, hd)))
    return times["tinyllama_s1024"], max_err


def flash_times(q, k, v, do, qs, kl, lse, delta):
    """ms per call: each kernel, its plain version, and SDPA on the same
    inputs in its (B, heads, S, hd) layout (copied outside the timing)."""
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True,
                             enable_gqa=True)
    bwd = (q, k, v, do, lse, delta, qs, kl)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qr, kr, vr = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = sdpa(qr, kr, vr)
    ms = {}
    for route, uk, iters in (("ms", True, 20), ("plain_ms", False, 3)):
        ms[f"flash_fwd_{route}"] = time_ms(lambda i: attention.flash_forward(
            q, k, v, qs, kl, save_lse=True, use_kernel=uk), iters)
        ms[f"flash_bwd_dq_{route}"] = time_ms(lambda i: attention.flash_bwd_dq(
            *bwd, use_kernel=uk), iters)
        ms[f"flash_bwd_dkv_{route}"] = time_ms(lambda i: attention.flash_bwd_dkv(
            *bwd, use_kernel=uk), iters)
    with torch.no_grad():
        ms["sdpa_fwd_ms"] = time_ms(lambda i: sdpa(qt, kt, vt), 20)
    ms["sdpa_bwd_ms"] = time_ms(lambda i: torch.autograd.grad(o, (qr, kr, vr), dot,
                                                              retain_graph=True), 20)
    ms["sdpa_fwd_bwd_ms"] = time_ms(lambda i: torch.autograd.grad(sdpa(qr, kr, vr),
                                                                  (qr, kr, vr), dot), 20)
    return ms


def f32_attention(q, k, v, *args):
    """The einsum attention in f32 throughout (the einsum route rounds its
    scores and probabilities to bf16): another valid rounding of the same
    function, whose spread from the einsum route is the floor that the
    flash route is held to."""
    return EINSUM_ATTENTION(q.float(), k.float(), v.float(), *args).to(q.dtype)


EINSUM_ATTENTION = llama._attention  # before f32_attention patches it in


def qlora_flash_path(dev, cfg, base):
    """3 QLoRA steps at batch 2 x seq 1024 through the flash kernels and 3
    through the einsum attention, from the same adapters; every other
    kernel the same. Then one einsum step in f32 attention (the floor).
    Returns the flash route's launches."""
    data = train_bench.make_batch(cfg, LONG_BATCH, LONG_SEQ, dev)
    init = train_bench.with_lora(base)
    per_forward = 7 * cfg.n_layers + 1
    runs = {}
    for route in ("flash", "einsum", "f32_attention"):
        adapters = [{k: {ab: t.detach().clone().requires_grad_() for ab, t in v.items()}
                     for k, v in ad.items()} for ad in train.extract_adapters(init)]
        params = train.merge_adapters(init, adapters)
        opt = Adam8bit(qnn.lora_parameters(params), lr=TRAIN_LR)
        step = train.make_qlora_train_step(cfg, opt, use_flash=route == "flash")
        if route == "f32_attention":
            with mock.patch.object(llama, "_attention", f32_attention):
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
        expected.update(matmul_4bit=per_forward, matmul_4bit_t=PER_BACKWARD,
                        adam8bit_update=1)
        if route == "flash":
            expected.update(dict.fromkeys(FLASH_KERNELS, cfg.n_layers))
        for i, c in enumerate(counts):
            check(c == expected, f"qlora s1024 {route} step {i + 1}: launches {c}, "
                                 f"expected {expected}")
        check(all(math.isfinite(x) for x in losses), f"qlora s1024 {route}: losses {losses}")
        check(losses[2] < losses[0], f"qlora s1024 {route}: loss did not fall: {losses}")
        runs[route] = (losses, grads)
        if route == "flash":
            flash_launches = {k: sum(c[k] for c in counts) for k in expected}
        emit(qlora_s1024=dict(route=route, batch=LONG_BATCH, seq=LONG_SEQ, losses=losses,
                              step_seconds=seconds, launches_per_step=counts[0]))
    (lf, gf), (le, ge), (l32, g32) = runs["flash"], runs["einsum"], runs["f32_attention"]
    loss_rel = abs(lf[0] - le[0]) / abs(le[0])
    check(loss_rel <= 1e-2, f"qlora s1024 step-1 loss {lf[0]} vs einsum {le[0]}")
    b_rel = [rel_l2(bf, be) for (_, bf), (_, be) in zip(gf, ge)]
    floor = [rel_l2(b32, be) for (_, b32), (_, be) in zip(g32, ge)]
    tols = [GRAD_FLOOR_X * f + GRAD_FLOOR_ABS for f in floor]
    emit(qlora_s1024_check=dict(step1_loss_rel=loss_rel, tol=1e-2,
                                lora_b_grad_rel_l2_max=max(b_rel), lora_b_grad_rel_l2=b_rel,
                                grad_tols=tols, f32_attention_loss_rel=abs(l32[0] - le[0]) / abs(le[0]),
                                f32_attention_rel_l2_max=max(floor), f32_attention_rel_l2=floor))
    for i, (b, tol) in enumerate(zip(b_rel, tols)):
        check(b <= tol, f"qlora s1024 layer {i // 2} {('wq', 'wv')[i % 2]} lora_b gradient "
                        f"rel-L2 {b} > {tol} ({GRAD_FLOOR_X} x its floor + {GRAD_FLOOR_ABS})")
    return flash_launches


def long_prompt_decode(dev, cfg, params):
    """Greedy decode (B=2, nf4a) from a 1024-token prompt: its prefill into a
    cache of 1040 slots takes the flash kernel (q_start 0, kv_len 1024 of
    1040), the decode steps the einsum attention. Prefill logits flash vs
    einsum; launches of the prefill and of the whole decode. Returns the
    decode's launches."""
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT_LEN), dtype=np.int32)).to(dev)
    logits, prefill_launches = {}, {}
    with torch.no_grad():
        for route in ("flash", "einsum", "f32_attention"):
            cache = llama.init_cache(cfg, 2, max_len=PROMPT_LEN + PROMPT_NEW, device=dev)
            torch.cuda.synchronize()
            _build.reset_launches()
            with mock.patch.object(llama, "_attention", f32_attention
                                   if route == "f32_attention" else EINSUM_ATTENTION):
                logits[route], _ = llama.forward(params, prompt, cfg, cache=cache,
                                                 use_flash=route == "flash")
            torch.cuda.synchronize()
            prefill_launches[route] = _build.launches["flash_fwd"]
    check(prefill_launches == {"flash": cfg.n_layers, "einsum": 0, "f32_attention": 0},
          f"long prefill flash launches {prefill_launches}")
    check(torch.isfinite(logits["flash"]).all().item(), "long prefill: non-finite logits")
    rel = rel_l2(logits["flash"], logits["einsum"])
    # the floor: the einsum route against itself in f32 attention; the
    # 1e-2 limit holds unless that floor, from bf16 rounding alone, is
    # above it (PERF.md)
    floor = rel_l2(logits["f32_attention"], logits["einsum"])
    tol = max(1e-2, GRAD_FLOOR_X * floor + GRAD_FLOOR_ABS)
    agree = (logits["flash"].argmax(-1) == logits["einsum"].argmax(-1)).float().mean().item()
    check(rel <= tol, f"long prefill logits flash vs einsum rel-L2 {rel} > {tol}")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = llama.greedy_decode(params, prompt, cfg, max_new_tokens=PROMPT_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    expected = dict.fromkeys(counts, 0)
    expected.update(flash_fwd=cfg.n_layers, matmul_4bit=PROMPT_NEW * (7 * cfg.n_layers + 1))
    check(counts == expected, f"long-prompt decode: launches {counts}, expected {expected}")
    check(out.shape == (2, PROMPT_LEN + PROMPT_NEW) and torch.equal(out[:, :PROMPT_LEN], prompt)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), "long-prompt decode: bad output")
    emit(long_prompt_decode=dict(batch=2, prompt=PROMPT_LEN, new_tokens=PROMPT_NEW,
                                 cache_len=PROMPT_LEN + PROMPT_NEW, greedy_s=wall,
                                 prefill_logits_rel_l2_flash_vs_einsum=rel, tol=tol,
                                 f32_attention_rel_l2_vs_einsum=floor,
                                 flash_vs_f32_attention_rel_l2=rel_l2(logits["flash"],
                                                                      logits["f32_attention"]),
                                 prefill_argmax_agreement=agree,
                                 prefill_flash_launches=prefill_launches["flash"],
                                 decode_launches=counts))
    return counts


def long_rows(cfg, dense):
    """long_prefill (dense bf16, B=2) at each S of the crossover, the
    reference's row at 2048; then train_bench's seq-1024 and 7B rows."""
    for seq in CROSSOVER_SEQS:
        torch.cuda.synchronize()
        _build.reset_launches()
        row = decode_bench.long_prefill(dense, cfg, seq=seq)
        torch.cuda.synchronize()
        # the flash route's warm-up and timed forwards, one launch a layer each
        check(_build.launches["flash_fwd"] == 4 * cfg.n_layers,
              f"long_prefill S={seq}: {_build.launches['flash_fwd']} flash launches")
        emit(long_prefill=row)
    for row in train_bench.long_rows([r for r in train_bench.LONG_ROWS
                                      if r[1] != "llama2-13b"]):
        check(math.isfinite(row["loss_step1"]), f"train row {row['name']}: {row['loss_step1']}")
        emit(train_row=row)


def train_rows(cfg, bases):
    for name, fmt in train_bench.ROWS:
        row = train_bench.bench_qlora(bases[fmt], cfg)
        check(math.isfinite(row["loss_step1"]), f"train row {name}: loss {row['loss_step1']}")
        emit(train_row={"name": name, "fmt": fmt, **row})
    emit(adam_bytes=train_bench.adam_bytes(cfg))


def eight_bit_checks(dev, work):
    """matmul_8bit and matmul_8bit_t against their plain versions at the
    five TinyLlama (K, N), M in {8, 2048}, every 8-bit format (matmul_8bit
    also at Llama-2-13B's (K, N), M in {8, 1024}, in int8: phase 27's
    single-card reference of its int8 leg), bf16
    operands within 2 bf16 ulps of max|plain|, and at ``F32_SHAPE`` in f32
    within 1e-5 of it; matmul_8bit also at ``MM8_MID_MS`` on two of the
    shapes (both sides of its decode/prefill split), matmul_8bit_t at
    ``MM8T_MID_MS`` on them, and both at ``MM8_RAGGED``; the bf16 outputs
    bit-identical over two calls, matmul_8bit's design per shape.
    µs per call with the weights rotated past the L2, for int8 also the
    plain versions' and the dense control's (cuBLAS ``torch.matmul`` of the
    dequantized bf16 weight). Returns ms of the calls of one decode step
    (matmul_8bit, M=8) and of one QLoRA step's forward (matmul_8bit,
    M=2048) and backward (matmul_8bit_t, M=2048), int8, as [kernel, plain,
    dense]; µs of the int8 calls that ``EARLIER_US`` names, by kernel; and
    the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(7)
    step = {("matmul_8bit", 8): [0.0] * 3, ("matmul_8bit", M_TRAIN): [0.0] * 3,
            ("matmul_8bit_t", M_TRAIN): [0.0] * 3}
    count = {"matmul_8bit": SHAPES, "matmul_8bit_t": T_SHAPES}
    max_err = {"matmul_8bit": 0.0, "matmul_8bit_t": 0.0}
    per_call = {"matmul_8bit": {}, "matmul_8bit_t": {}}
    cases = [(k, n, m, torch.bfloat16) for (k, n) in SHAPES for m in (8, M_TRAIN)]
    cases += [(k, n, m, torch.bfloat16) for (k, n) in MM8_MID_SHAPES for m in MM8_MID_MS]
    cases += [(*MM8_RAGGED, torch.bfloat16), (*F32_SHAPE, torch.float32)]
    cases = [(*c, EIGHT_BIT) for c in cases]
    cases += [(k, n, m, torch.bfloat16, ("int8",)) for (k, n) in MODEL_MM4[4:] for m in (8, 1024)]
    for k, n, m, dtype, fmts in cases:
        n_codes = -(-n // 128) * 128  # the quantizer pads N to 128; a ragged case cuts it back
        w = (torch.randn((k, n_codes), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        g = torch.randn((m, n), generator=gen, device=dev).to(dtype)
        design = matmul.matmul_8bit_design(m, n, k) if dtype == torch.bfloat16 else None
        for fmt in fmts:
            qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
            codes, scales = qt.codes[:, :n].contiguous(), qt.scale[:, :n].contiguous()
            for name, fn, a in (("matmul_8bit", matmul.matmul_8bit, x),
                                ("matmul_8bit_t", matmul.matmul_8bit_t, g)):
                if name == "matmul_8bit_t" and m not in (M_TRAIN, *MM8T_MID_MS, MM8_RAGGED[2]):
                    continue  # the backward runs at the training M

                def run(use_kernel, ws, fn=fn, a=a, cb=qt.codebook):
                    return lambda i: fn(a, *ws[i % len(ws)], codebook=cb, block=64,
                                        use_kernel=use_kernel)
                out = run(True, [(codes, scales)])(0)
                ref = run(False, [(codes, scales)])(0)
                err = (out.float() - ref.float()).abs().max().item()
                rel = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5
                tol = rel * ref.float().abs().max().item()
                check(out.shape == ref.shape and torch.isfinite(out).all().item(),
                      f"{name} {fmt} {dtype} M={m} K={k} N={n}: bad output")
                check(err <= tol, f"{name} {fmt} {dtype} M={m} K={k} N={n}: err {err} > {tol}")
                max_err[name] = max(max_err[name], err)
                ws = copies_past_l2(codes, scales)
                iters = 50 if m <= 64 else 10
                row = dict(kernel=name, fmt=fmt, dtype=str(dtype), M=m, K=k, N=n,
                           max_abs_err=err, tol=tol, us=time_ms(run(True, ws), iters) * 1e3)
                if dtype == torch.bfloat16:
                    same = torch.equal(out, run(True, [(codes, scales)])(0))
                    check(same, f"{name} {fmt} M={m} K={k} N={n}: two calls differ")
                    row.update(bit_identical_over_two_calls=same)
                    if name == "matmul_8bit":
                        row.update(design=design)
                    if fmt == "int8" and f"M{m}_{k}x{n}" in EARLIER_US[name]:
                        per_call[name][f"M{m}_{k}x{n}"] = row["us"]
                if (fmt == "int8" and dtype == torch.bfloat16 and (name, m) in step
                        and (k, n) in count[name]):
                    wd = matmul._dequant_8bit(qt.codes, qt.scale, None, 64, torch.bfloat16)[:k]
                    dense = [d.T.contiguous() if name == "matmul_8bit_t" else d
                             for (d,) in copies_past_l2(wd)]
                    row["plain_us"] = time_ms(run(False, ws), iters) * 1e3
                    row["dense_us"] = time_ms(lambda i: a @ dense[i % len(dense)], iters) * 1e3
                    n_calls = count[name][(k, n)]
                    acc = step[(name, m)]
                    for j, key in enumerate(("us", "plain_us", "dense_us")):
                        acc[j] += n_calls * row[key] / 1e3
                    if m == 8 or name == "matmul_8bit_t":
                        add_work(work, name, nbytes(a, qt.codes, qt.scale, out),
                                 2 * m * k * n, n_calls)
                if m >= 256:
                    row["tflops"] = 2 * m * k * n / (row["us"] * 1e-6) / 1e12
                emit(kernel_check=row)
    return step, per_call, max_err


def _ptq_tree():
    """int8 by default; nf8 on layer 0, fp8 on the head, and W8A8 on every
    w_down: int8a weights, activations fake-quantized over the entropy
    range."""
    return (ConfigTree(QuantConfig.from_mode("int8"))
            .config_layer("layers/0/", scheme="codebook", codebook="nf8")
            .config_layer("lm_head", scheme="codebook", codebook="fp8")
            .config_layer("w_down", scheme="affine", weights_only=False, calibration="entropy"))


def ptq_path(dev, cfg, dense, train_ids, eval_ids):
    """PTQ with calibration at the full geometry, then greedy decode, prefill
    logits and perplexity of that tree and of the int8, nf8, fp8 and int8a
    trees, each through the kernels and through ``use_kernel=False``.
    Returns the decode runs' launches and the trees (int8 and nf8 feed the
    QLoRA phase)."""
    calib = [torch.from_numpy(train_ids[i * CALIB_SEQ:(i + 1) * CALIB_SEQ][None].astype(np.int64))
             .to(dev) for i in range(CALIB_BATCHES)]
    t0 = time.perf_counter()
    trees = {"ptq_mixed": ptq.quantize_model(
        dense, _ptq_tree(), forward=lambda p, b: llama.forward(p, b, cfg)[0],
        calib_batches=calib, strict_rules=True)}
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    mixed = trees["ptq_mixed"]
    check(mixed["layers"][0]["wq"].codebook == "nf8" and mixed["lm_head"].codebook == "fp8"
          and mixed["layers"][1]["wq"].codes.dtype == torch.int8
          and all(type(lp["w_down"]).__name__ == "ActQuantWeight"
                  and lp["w_down"].w.scheme == "affine" for lp in mixed["layers"]),
          "ptq: the tree does not hold the formats its rules ask for")
    ranges = [(lp["w_down"].lo.item(), lp["w_down"].hi.item()) for lp in mixed["layers"]]
    for fmt in EIGHT_BIT:
        trees[fmt] = qnn.quantize_params(dense, mode=fmt)
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 128), dtype=np.int32)).to(dev)
    tokens = eval_ids[:PPL_TOKENS + 1]
    n_windows = -(-(len(tokens) - 1) // PPL_SEQ)
    n_batches = -(-n_windows // PPL_BATCH)
    per_forward = 7 * cfg.n_layers + 1
    launches = dict.fromkeys(_build.launches, 0)
    for name, params in trees.items():
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = llama.greedy_decode(params, prompt, cfg, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        expected = dict.fromkeys(counts, 0)
        expected["matmul_8bit"] = 32 * per_forward
        check(counts == expected, f"ptq {name} decode: launches {counts}, expected {expected}")
        check(out.shape == (8, 160) and torch.equal(out[:, :128], prompt)
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"ptq {name}: bad output")
        for k, v in counts.items():
            launches[k] += v
        with torch.no_grad():
            lk, _ = llama.forward(params, prompt, cfg)
            lp, _ = llama.forward(params, prompt, cfg, use_kernel=False)
            with reordered_plain():
                lr, _ = llama.forward(params, prompt, cfg, use_kernel=False)
        check(torch.isfinite(lk).all().item(), f"ptq {name}: non-finite logits")
        rel = rel_l2(lk, lp)
        # phase 5's limit, unless the plain route summed in another order
        # sets a higher floor: the W8A8 fake-quant rounds an activation
        # that moved by one bf16 ulp to the neighbouring level
        floor = rel_l2(lr, lp)
        tol = logits_gate.tolerance(floor)
        check(rel <= tol, f"ptq {name}: prefill logits rel-L2 {rel} > {tol} (floor {floor})")
        _build.reset_launches()
        t0 = time.perf_counter()
        ppl_k = qeval.perplexity(params, tokens, cfg, seq_len=PPL_SEQ, batch=PPL_BATCH)
        ppl_s = time.perf_counter() - t0
        ppl_launches = _build.launches["matmul_8bit"]
        check(ppl_launches == n_batches * per_forward,
              f"ptq {name} perplexity: {ppl_launches} matmul_8bit launches, expected "
              f"{n_batches * per_forward}")
        ppl_p = qeval.perplexity(params, tokens, cfg, seq_len=PPL_SEQ, batch=PPL_BATCH,
                                 use_kernel=False)
        ppl_rel = abs(ppl_k - ppl_p) / ppl_p
        check(math.isfinite(ppl_k) and ppl_rel <= PTQ_PPL_REL,
              f"ptq {name}: perplexity {ppl_k} vs plain {ppl_p} (rel {ppl_rel})")
        row = dict(tree=name, greedy_s=wall, launches=counts, prefill_logits_rel_l2=rel,
                   tol=tol, reordered_plain_rel_l2=floor, perplexity=ppl_k, perplexity_plain=ppl_p,
                   perplexity_rel=ppl_rel, ppl_tol=PTQ_PPL_REL, ppl_tokens=len(tokens) - 1,
                   ppl_seconds=ppl_s, ppl_launches=ppl_launches)
        if name == "ptq_mixed":
            row.update(quantize_model_s=ptq_s, w_down_ranges=ranges)
        emit(ptq_path=row)
    return launches, trees


def qlora_8bit(dev, cfg, trees):
    """Phase 9's QLoRA checks on the int8 and nf8 bases, then their timed
    ``train_bench`` rows. Returns the kernel routes' launches."""
    launches = {}
    for fmt in ("int8", "nf8"):
        got = qlora_path(dev, cfg, trees[fmt], fmt=fmt, kernels=("matmul_8bit", "matmul_8bit_t"))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    for fmt in ("int8", "nf8"):
        row = train_bench.bench_qlora(trees[fmt], cfg)
        check(math.isfinite(row["loss_step1"]), f"train row {fmt}: loss {row['loss_step1']}")
        emit(train_row={"name": f"tinyllama {fmt}", "fmt": fmt, **row})
    return launches


def cli_round_trip(text: str):
    """The CLI on the TinyLlama geometry, one subprocess per command, in a
    temporary directory that is removed at the end. Returns seconds per
    command."""
    root = os.path.dirname(os.path.abspath(__file__))
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "w") as f:
            f.write(text)
        ckpt = os.path.join(tmp, "tinyllama_int8")
        commands = {
            "quantize": ["quantize", "--toy", "tinyllama", "--fmt", "int8", "--calib-text",
                         corpus, "--out", ckpt],
            "eval": ["eval", "--ckpt", ckpt + ".npz", "--text", corpus],
            "generate": ["generate", "--ckpt", ckpt + ".npz", "--prompt",
                         "The quantized model says", "--max-new-tokens", "16"],
            "finetune": ["finetune", "--toy", "tinyllama", "--fmt", "nf8", "--steps", "3",
                         "--text", corpus, "--out", os.path.join(tmp, "adapters")],
        }
        for name, argv in commands.items():
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "quanta_tpu_torch", *argv], cwd=root,
                                  capture_output=True, text=True, timeout=600)
            seconds[name] = time.perf_counter() - t0
            check(proc.returncode == 0, f"cli {name}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
            emit(cli=dict(command=name, rc=proc.returncode, seconds=seconds[name],
                          stdout=proc.stdout.strip()[-300:],
                          stderr_tail=proc.stderr.strip().splitlines()[-3:]))
            if name == "eval":
                ppl = json.loads(proc.stdout.strip().splitlines()[-1])["perplexity"]
                check(math.isfinite(ppl) and ppl > 1.0, f"cli eval: perplexity {ppl}")
        check(os.path.exists(os.path.join(tmp, "adapters.npz")), "cli finetune: no adapters")
    return seconds


def accuracy_phase(dev):
    """accuracy_bench at its model size, pretraining cut to ACC_STEPS, no
    cache; the gates of the 8-bit rows, and the int8 and nf8 perplexities
    through the kernels against use_kernel=False on the same trees."""
    _build.reset_launches()
    result, variants, eval_ids, acfg = accuracy_bench.run(steps=ACC_STEPS, device=dev)
    eight_launches = _build.launches["matmul_8bit"]
    rows = {r["format"]: r for r in result["rows"]}
    check(result["final_loss"] < 2.5, f"accuracy: final loss {result['final_loss']} >= 2.5")
    plain = {}
    for fmt in ("int8", "nf8"):
        plain[fmt] = qeval.perplexity(variants[fmt], eval_ids, acfg, seq_len=result["seq"],
                                      batch=result["batch"], use_kernel=False)
    kernel_vs_plain = {f: abs(rows[f]["ppl"] - p) / p for f, p in plain.items()}
    emit(accuracy=dict(result, plain_ppl=plain, kernel_vs_plain_rel=kernel_vs_plain,
                       tol=ACC_PPL_REL, matmul_8bit_launches=eight_launches))
    for f, rel in kernel_vs_plain.items():
        check(rel <= ACC_PPL_REL, f"accuracy {f}: kernel ppl {rows[f]['ppl']} vs plain "
                                  f"{plain[f]} (rel {rel} > {ACC_PPL_REL})")
    check(eight_launches > 0, "accuracy: the 8-bit rows launched no matmul_8bit")
    for name in ACC_GATED:
        check(rows[name]["pass"], f"accuracy gate {name}: delta {rows[name]['delta']} > "
                                  f"{rows[name]['gate']}")


def gpt2_kernel_checks(dev):
    """matmul_4bit (nf4a) and matmul_int8_fused against their plain
    versions at GPT-2 small's four (K, N), the M of ``GPT2_MM4`` and
    ``GPT2_I8_MS``, under phase 3's and 4's rules, the design per row, µs
    per call with the weights rotated past the L2. Returns one GPT-2
    decode step's calls (M = 8; bf16 x for matmul_4bit) as {kernel:
    [kernel ms, plain ms, bound ms, bound by]} and the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(4)
    work = {}
    step = {"matmul_4bit": [0.0, 0.0], "matmul_int8_fused": [0.0, 0.0]}
    max_err = {"matmul_4bit": 0.0, "matmul_int8_fused": 0.0}
    for (k, n), count in GPT2_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        for dtype, ms in GPT2_MM4:
            qt = codecs.quantize_matmul_weight(w.to(dtype), fmt="nf4a", block_size=64)
            qts = [dataclasses.replace(qt, codes=c, scale=sc)
                   for c, sc in copies_past_l2(qt.codes, qt.scale)]
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)

                def run(use_kernel, qs, x=x):
                    return lambda i: matmul.matmul_quantized(x, qs[i % len(qs)],
                                                             use_kernel=use_kernel)
                out, ref = run(None, [qt])(0), run(False, [qt])(0)
                err = (out.float() - ref.float()).abs().max().item()
                tol = (2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5) * \
                    ref.float().abs().max().item()
                name = f"gpt2 matmul_4bit nf4a {dtype} M={m} K={k} N={n}"
                check(out.shape == ref.shape == (m, n) and torch.isfinite(out).all().item(),
                      f"{name}: bad output")
                check(err <= tol, f"{name}: err {err} > {tol}")
                same = torch.equal(out, run(None, [qt])(0))
                check(same or dtype == torch.float32, f"{name}: two calls differ")
                max_err["matmul_4bit"] = max(max_err["matmul_4bit"], err)
                iters = 50 if m <= 64 else 10
                row = dict(kernel="matmul_4bit", model="gpt2", fmt="nf4a",
                           dtype=str(dtype).removeprefix("torch."), M=m, K=k, N=n,
                           K_pad=2 * qt.codes.shape[0], max_abs_err=err, tol=tol,
                           us=time_ms(run(None, qts), iters) * 1e3,
                           plain_us=time_ms(run(False, qts), iters) * 1e3,
                           bit_identical_over_two_calls=same,
                           design=(matmul.matmul_4bit_design(m, n, 2 * qt.codes.shape[0])
                                   if dtype == torch.bfloat16 else "f32 FMA"))
                if m == 8 and dtype == torch.bfloat16:
                    step["matmul_4bit"][0] += count * row["us"] / 1e3
                    step["matmul_4bit"][1] += count * row["plain_us"] / 1e3
                    add_work(work, "matmul_4bit", nbytes(x, qt.codes, qt.scale, out),
                             2 * m * k * n, count)
                emit(kernel_check=row)
        qw = int8mm.quantize_int8_weight(w)
        ws = copies_past_l2(qw.codes, qw.scale)
        for m in GPT2_I8_MS:
            x = torch.randn((m, k), generator=gen, device=dev)
            x[:, qw.outlier_idx[:4].long()] *= 20.0  # systematic outlier features
            y_out = x.index_select(1, qw.outlier_idx) @ qw.w_outlier.float()
            xa = x.abs()
            xa[:, qw.outlier_idx] = 0.0
            rs = torch.clamp(xa.amax(dim=1) / 127.0, min=1e-12)

            def run_i8(use_kernel, ws, x=x, rs=rs, y_out=y_out):
                return lambda i: int8mm.matmul_int8_fused(
                    x, ws[i % len(ws)][0], rs, ws[i % len(ws)][1], y_out, use_kernel=use_kernel)
            out = run_i8(None, [(qw.codes, qw.scale)])(0)
            ref = run_i8(False, [(qw.codes, qw.scale)])(0)
            err = (out - ref).abs().max().item()
            name = f"gpt2 matmul_int8_fused M={m} K={k} N={n}"
            check(torch.isfinite(out).all().item(), f"{name}: non-finite")
            check(torch.equal(out, ref), f"{name}: not bit-exact: {err}")
            same = torch.equal(out, run_i8(None, [(qw.codes, qw.scale)])(0))
            check(same, f"{name}: two calls differ")
            max_err["matmul_int8_fused"] = max(max_err["matmul_int8_fused"], err)
            iters = 50 if m <= 32 else 10
            ms_, plain_ms = time_ms(run_i8(None, ws), iters), time_ms(run_i8(False, ws), iters)
            emit(kernel_check=dict(kernel="matmul_int8_fused", model="gpt2", fmt="llm_int8", M=m,
                                   K=k, N=n, max_abs_err=err, tol=0.0, us=ms_ * 1e3,
                                   plain_us=plain_ms * 1e3, bit_identical_over_two_calls=same,
                                   design=int8mm.matmul_int8_design(m, n, k, fused=True)))
            if m == 8:
                step["matmul_int8_fused"][0] += count * ms_
                step["matmul_int8_fused"][1] += count * plain_ms
                add_work(work, "matmul_int8_fused", nbytes(x, qw.codes, rs, qw.scale, y_out, out),
                         2 * m * k * n, count)
    for name, kind in (("matmul_4bit", "bf16"), ("matmul_int8_fused", "int8")):
        step[name] += list(bound(work[name], kind))
    emit(gpt2_decode_step_kernels={
        "note": "one GPT-2 small decode step's 48 calls at M=8 (nf4a bf16 x; llm_int8 f32 x) "
                "as [kernel ms, plain ms, bound ms, bound by]", **step})
    return step, max_err


def _tensors(tree):
    """Every tensor of a dense tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def hf_round_trips(dev):
    """GPT-2 small (f32) and a 2-layer TinyLlama-width Llama (bf16) saved in
    the HF layout through the port's safetensors codec and loaded back
    onto the card, every tensor bit-identical. Returns {name: (params,
    cfg)} of the loaded trees, GPT-2 also in bf16 (``gpt2_small_bf16``)."""
    models = {"gpt2_small": (gpt2, gpt2.GPT2Config.small(), hf.save_gpt2, hf.load_gpt2),
              "tinyllama_2_layers": (llama, dataclasses.replace(llama.LlamaConfig.tinyllama_1b(),
                                                                n_layers=2),
                                     hf.save_llama, hf.load_llama)}
    loaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (mod, cfg, save, load) in models.items():
            params = mod.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
            path = os.path.join(tmp, name)
            t0 = time.perf_counter()
            save(params, cfg, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back, back_cfg = load(path, dtype=cfg.dtype, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            check(back_cfg == cfg, f"hf {name}: config {back_cfg} != {cfg}")
            want, got = _tensors(params), _tensors(back)
            check(len(got) == len(want) and all(
                g.dtype == w.dtype and g.device == w.device and torch.equal(g, w)
                for g, w in zip(got, want)), f"hf {name}: a tensor differs after the round trip")
            emit(hf_round_trip=dict(model=name, tensors=len(got), n_layers=cfg.n_layers,
                                    dtype=str(cfg.dtype).removeprefix("torch."),
                                    bytes_on_disk=os.path.getsize(
                                        os.path.join(path, "model.safetensors")),
                                    save_s=save_s, load_s=load_s, bit_identical=True))
            loaded[name] = (back, back_cfg)
            if name == "gpt2_small":
                loaded["gpt2_small_bf16"] = load(path, dtype=torch.bfloat16, device=dev)
            del params
    return loaded


def _decode_with_launches(fwd_mod, params, prompt, cfg, new, kernel, per_forward, tag):
    """Greedy decode with the launch counts reset just before and read just
    after; checks the tokens' shape and range and that only ``kernel``
    ran, ``new x per_forward`` times. Returns (tokens, counts, seconds)."""
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fwd_mod.greedy_decode(params, prompt, cfg, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    s = prompt.shape[1]
    check(out.shape == (prompt.shape[0], s + new) and torch.equal(out[:, :s], prompt)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{tag}: bad output")
    expected = dict.fromkeys(counts, 0)
    expected[kernel] = new * per_forward
    check(counts == expected, f"{tag}: launches {counts}, expected {expected}")
    return out, counts, wall


def _prefill_logits_vs_plain(fwd_mod, params, prompt, cfg, tag):
    """Prefill logits through the kernels against ``use_kernel=False``:
    phase 5's rel-L2, or 1.5 times the floor that the plain route summed
    in another order sets (+2e-3) where that floor is higher (phase 15;
    ``logits_gate``)."""
    return logits_gate.prefill_logits_vs_plain(fwd_mod, params, prompt, cfg, tag)[1]


def transcode_decode(dev, params, cfg):
    """The loaded Llama quantized to exact nf4 and transcoded to nf4a on the
    card, then greedy decode through matmul_4bit. Returns its launches."""
    nf4 = qnn.quantize_params(params, mode="nf4")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nf4a = transcode_params(nf4)
    torch.cuda.synchronize()
    transcode_s = time.perf_counter() - t0
    pairs = [(a, b) for a, b in zip(_tensors(nf4), _tensors(nf4a)) if hasattr(a, "codebook")]
    check(len(pairs) == 7 * cfg.n_layers + 1 and all(
        b.codebook == "nf4a" and b.scale is a.scale and b.codes.device == a.codes.device
        and torch.equal(b.codes.cpu(), transcode_codebook(dataclasses.replace(
            a, codes=a.codes.cpu())).codes) for a, b in pairs),
          "transcode: a leaf is not the nf4a transcode of its nf4 codes")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, GPT2_PROMPT), dtype=np.int32)).to(dev)
    _, counts, wall = _decode_with_launches(llama, nf4a, prompt, cfg, CONVERT_NEW, "matmul_4bit",
                                            7 * cfg.n_layers + 1, "transcoded nf4a decode")
    emit(transcode_decode=dict(n_layers=cfg.n_layers, leaves=len(pairs), transcode_s=transcode_s,
                               greedy_s=wall, launches=counts,
                               **_prefill_logits_vs_plain(llama, nf4a, prompt, cfg,
                                                          "transcoded nf4a")))
    return counts


def gpt2_nf4a_decode(dev, params, cfg):
    """GPT-2 small in bf16 quantized to nf4a: greedy decode through
    matmul_4bit's bf16 designs, prefill logits against the plain route.
    Returns its launches."""
    qparams = qnn.quantize_params(params, mode="nf4a")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, GPT2_PROMPT), dtype=np.int32)).to(dev)
    out, counts, wall = _decode_with_launches(gpt2, qparams, prompt, cfg, GPT2_NEW, "matmul_4bit",
                                              4 * cfg.n_layers, "gpt2 nf4a decode")
    plain = gpt2.greedy_decode(qparams, prompt, cfg, max_new_tokens=GPT2_NEW, use_kernel=False)
    agree = (plain[:, GPT2_PROMPT:] == out[:, GPT2_PROMPT:]).float().mean().item()
    emit(gpt2_decode=dict(fmt="nf4a", dtype="bfloat16", n_layers=cfg.n_layers, greedy_s=wall,
                          launches=counts, token_agreement_vs_plain=agree,
                          **_prefill_logits_vs_plain(gpt2, qparams, prompt, cfg,
                                                     "gpt2 nf4a")))
    return counts


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def kernel_bench_phase():
    """benchmarks.kernel_bench at M = 8 and 128: one line a cell (its own
    check: no reading above 105% of its roofline)."""
    rows = kernel_bench.run()
    for r in rows:
        emit(kernel_bench=r)
    check(len(rows) == len(kernel_bench.MS) * len(kernel_bench.SHAPES) * len(kernel_bench.CELLS),
          f"kernel bench: {len(rows)} cells")


def model_scale(dev):
    """Llama-2-7B and -13B in nf4a at full width and depth: one prefill
    forward's launches (7 x n_layers + 1 of matmul_4bit and nothing else)
    and its logits against the plain route (phase 15's rule), then
    ``model_scale_bench.run_model``: decode, prefill, idle share and the
    Engine trace (``MODEL_SCALE_REQUESTS`` requests, int8 KV). Returns the
    launches of every run."""
    launches = dict.fromkeys(_build.launches, 0)
    for name in MODEL_SCALE:
        cfg = model_scale_bench.model_config(name)
        params = model_scale_bench.init_model(cfg, "nf4a")
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, 128), dtype=np.int32)).to(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        with torch.no_grad():
            llama.forward(params, prompt, cfg)
        torch.cuda.synchronize()
        counts = _nonzero(_build.launches)
        check(counts == {"matmul_4bit": 7 * cfg.n_layers + 1},
              f"{name} prefill: launches {counts}, expected {7 * cfg.n_layers + 1} matmul_4bit")
        per_forward = counts["matmul_4bit"]
        logits = _prefill_logits_vs_plain(llama, params, prompt, cfg, f"{name} nf4a")
        torch.cuda.synchronize()
        _build.reset_launches()
        row = model_scale_bench.run_model(name, "nf4a", n_requests=MODEL_SCALE_REQUESTS,
                                          params=params)
        torch.cuda.synchronize()
        counts = _nonzero(_build.launches)
        check(set(counts) == {"matmul_4bit", "quantize_blockwise"},
              f"{name}: launches {counts}: matmul_4bit and the int8 KV writes only")
        check(row["serve"]["all_finished"] and math.isfinite(row["decode_tok_s"]),
              f"{name}: the serve trace did not finish every request")
        counts["matmul_4bit"] += per_forward
        for k, v in counts.items():
            launches[k] += v
        emit(model_scale={**row, "launches": counts, "per_forward_matmul_4bit": per_forward,
                          **logits})
        del params
        torch.cuda.empty_cache()
    return launches


def qlora_13b():
    """train_bench's ``llama2-13b nf4`` row (b1 x s512), its launches as
    designed: per step 7 x 40 + 1 matmul_4bit, 3 fewer matmul_4bit_t (layer
    0's wq, wk, wv read the frozen embedding) and one adam8bit_update per
    ``qt_adam8bit_table_leaves()`` of the 160 adapter leaves (A and B of wq
    and wv a layer), over the row's steps (step 1, warm-up, timed and 2
    profiled)."""
    rows = [r for r in train_bench.LONG_ROWS if r[1] == "llama2-13b"]
    torch.cuda.synchronize()
    _build.reset_launches()
    (row,) = train_bench.long_rows(rows)
    torch.cuda.synchronize()
    counts = _nonzero(_build.launches)
    cfg = train_bench.model_config("llama2-13b")
    _, _, _, _, _, warmup, steps = rows[0]
    n = 1 + (warmup - 1) + steps + 2
    per_fwd = 7 * cfg.n_layers + 1
    adam_launches = -(-4 * cfg.n_layers // _build.library().qt_adam8bit_table_leaves())
    expected = {"matmul_4bit": n * per_fwd, "matmul_4bit_t": n * (per_fwd - 3),
                "adam8bit_update": n * adam_launches}
    check(counts == expected, f"13B QLoRA: launches {counts}, expected {expected}")
    check(math.isfinite(row["loss_step1"]), f"13B QLoRA: loss {row['loss_step1']}")
    emit(train_row={**row, "launches": counts})
    return counts


def tensor_parallel():
    """``TP_RANKS`` ranks on the card over gloo (``parallel.spawn_local``
    running ``tp_bench.rank_legs``): each leg's checks run in the ranks
    (prefill logits against the single-card forward, launches per forward
    as designed, greedy tokens agreeing across ranks), and a failing rank
    fails the phase. Returns the launches of every rank's TP runs."""
    torch.cuda.empty_cache()
    res = spawn_local(tp_bench.rank_legs, TP_RANKS, TP_LEGS, timeout=TP_TIMEOUT_S)
    launches = dict.fromkeys(_build.launches, 0)
    for i, leg in enumerate(TP_LEGS):
        rows = [r[i] for r in res]
        for r in rows:
            for counts in (r["launches_per_forward"], r["decode_launches"]):
                for k, v in counts.items():
                    launches[k] += v
        emit(tensor_parallel={"leg": leg, "ranks": rows})
    return launches


def sweep_cell(dev):
    """One engine_sweep cell: the llm_int8 64-request trace at TIMED_DEPTH
    layers (``SWEEP_CELL``), beside the device's own window rate; every
    request finishes. Returns its launches."""
    cfg = dataclasses.replace(llama.LlamaConfig.tinyllama_1b(), n_layers=TIMED_DEPTH)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params = qnn.quantize_params(dense, mode=SWEEP_CELL["fmt"])
    del dense
    rate = engine_sweep.device_window_rate(params, cfg, SWEEP_CELL["multi_step"],
                                           kv_quant=SWEEP_CELL["kv_quant"])
    torch.cuda.synchronize()
    _build.reset_launches()
    row = engine_sweep.cell(params, cfg, device_rate=rate["device_tok_s"], **SWEEP_CELL)
    torch.cuda.synchronize()
    counts = _nonzero(_build.launches)
    check(set(counts) == {"matmul_int8_fused", "quantize_blockwise"},
          f"llm_int8 64-request trace: launches {counts}")
    check(row["all_finished"] and row["admissions"] >= SWEEP_CELL["n_requests"]
          and row["tok_s"] > 0,
          f"llm_int8 64-request trace: not every request finished with "
          f"{SWEEP_CELL['max_new']} tokens: {row}")
    emit(engine_sweep_cell={**SWEEP_CELL, "n_layers": cfg.n_layers, **row,
                            "window_profile": rate, "launches": counts})
    return counts


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

    phase_s = {}

    @contextlib.contextmanager
    def timed(name):
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t
        emit(phase_done={name: phase_s[name]})

    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(build={"seconds": time.perf_counter() - t0, "so": _build.build_info["so"],
                "cached": _build.build_info["cached"], "ptxas": ptxas})

    work = {}
    with timed("3-4 kernel checks"):
        per_step, mm4_per_call, max_err = kernel_checks(dev, work)
        int8_step, int8_per_call, int8_err = int8_kernel_checks(dev, work)
        per_step.update(int8_step)
        max_err.update(int8_err)
        q_ms, q_op_us, max_err["quantize_blockwise"] = quantize_checks(dev, work)

    cfg = llama.LlamaConfig.tinyllama_1b()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    with timed("5 decode path"):
        params, launches = main_path(dev, cfg, dense)
    with timed("6-7 llm_int8 and serve"):
        params["llm_int8"] = qnn.quantize_params(dense, mode="llm_int8")
        launches.update(int8_decode_routes(dev, cfg, params["llm_int8"]))
        serve_counts = serve_closed_trace(dev, cfg, params["llm_int8"])
        launches["matmul_int8_fused"] += serve_counts["matmul_int8_fused"]
        launches["quantize_blockwise"] = serve_counts["quantize_blockwise"]
        cut_cfg = dataclasses.replace(cfg, n_layers=TIMED_DEPTH)
        cut = {fmt: {**p, "layers": p["layers"][:TIMED_DEPTH]} for fmt, p in params.items()}
        serve_rows(cut_cfg, cut)

    with timed("8 decode bench"):
        for fmt, p in cut.items():
            r = decode_bench.measure(p, cut_cfg)
            emit(bench={"fmt": fmt, "batch": 8, "prefill_len": 128, "cache_len": 512,
                        "n_layers": TIMED_DEPTH, **r})
        emit(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    with timed("9 qlora nf4"):
        t_step, t_per_call, max_err["matmul_4bit_t"] = transposed_checks(dev, work)
        adam_step, max_err["adam8bit_update"] = adam_checks(dev, work)
        train_launches = qlora_path(dev, cfg, params["nf4"])
        launches["matmul_4bit"] += train_launches["matmul_4bit"]
        train_rows(cfg, {"nf4": params["nf4"], "nf4a": params["nf4a"], "bf16": dense})

    with timed("10-13 flash"):
        flash_ms, flash_err = flash_checks(dev, work)
        max_err.update(flash_err)
        flash_launches = qlora_flash_path(dev, cfg, params["nf4"])
        decode_launches = long_prompt_decode(dev, cfg, params["nf4a"])
        for k in ("matmul_4bit", "matmul_4bit_t", "adam8bit_update"):
            train_launches[k] += flash_launches[k]
        launches["matmul_4bit"] += decode_launches["matmul_4bit"]
        for k in FLASH_KERNELS:
            launches[k] = flash_launches[k] + decode_launches[k]
        long_rows(cfg, dense)

    with timed("14 8-bit kernel checks"):
        eight_step, eight_per_call, eight_err = eight_bit_checks(dev, work)
        max_err.update(eight_err)
    train_ids, eval_ids = accuracy_bench.corpus_ids()
    with timed("15 ptq path"):
        ptq_launches, trees = ptq_path(dev, cfg, dense, train_ids, eval_ids)
    with timed("16 qlora 8-bit"):
        q8_launches = qlora_8bit(dev, cfg, trees)
    launches["matmul_8bit"] = ptq_launches["matmul_8bit"] + q8_launches["matmul_8bit"]
    launches["matmul_8bit_t"] = q8_launches["matmul_8bit_t"]
    train_launches["adam8bit_update"] += q8_launches["adam8bit_update"]
    del trees, params, dense
    torch.cuda.empty_cache()
    with timed("17 cli"):
        cli_round_trip(qeval.ByteTokenizer().decode(eval_ids[:40_000]))
    with timed("18 accuracy bench"):
        accuracy_phase(dev)

    with timed("19 gpt2 kernel checks"):
        gpt2_step, gpt2_err = gpt2_kernel_checks(dev)
        for name, err in gpt2_err.items():
            max_err[name] = max(max_err[name], err)
    with timed("20 hf round trips"):
        loaded = hf_round_trips(dev)
    with timed("21 convert on the card"):
        launches["matmul_4bit"] += transcode_decode(
            dev, *loaded.pop("tinyllama_2_layers"))["matmul_4bit"]
    with timed("22 gpt2 serve"):
        gparams, gcfg = loaded.pop("gpt2_small")
        gpt2_counts = serve_closed_trace(dev, gcfg, qnn.quantize_params(gparams, mode="llm_int8"),
                                         arch="gpt2", per_forward=4 * gcfg.n_layers)
        for k in ("matmul_int8_fused", "quantize_blockwise"):
            launches[k] += gpt2_counts[k]
    with timed("23 gpt2 nf4a decode"):
        launches["matmul_4bit"] += gpt2_nf4a_decode(dev, *loaded.pop("gpt2_small_bf16"))[
            "matmul_4bit"]
    del loaded, gparams
    torch.cuda.empty_cache()

    with timed("24 kernel bench"):
        kernel_bench_phase()
    with timed("25 model scale"):
        for k, v in model_scale(dev).items():
            launches[k] += v
    with timed("26 qlora 13b"):
        q13 = qlora_13b()
        launches["matmul_4bit"] += q13.pop("matmul_4bit")
        for k, v in q13.items():
            train_launches[k] += v
    with timed("27 tensor parallel"):
        for k, v in tensor_parallel().items():
            launches[k] += v
    with timed("28 llm_int8 64 requests"):
        for k, v in sweep_cell(dev).items():
            launches[k] += v
    emit(phase_seconds=phase_s)

    def entry(name, source, replaces, n_launches, ms, plain_ms, kind, at, library_ms=None,
              **extra):
        bound_ms, bound_by = bound(work[name], kind)
        return {"name": name, "route": "cuda", "source": f"quanta_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches, "max_abs_err": max_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "at": at, **extra}

    at = "one decode step's calls at M=8 (nf4a for matmul_4bit), ms"
    gpt2_at = ("gpt2_step_ms: one GPT-2 small decode step's 48 calls at M=8 as [kernel, plain, "
               "bound, bound by]")
    i8_prefill = ("one prefill forward's 155 calls at M=1024 as [kernel, plain, dense], dense: "
                  "torch._int_mm of the int8 activations and the codes, which takes M > 16 only)")
    flash_at = ("one call at TinyLlama-1.1B's QLoRA shape (B=2, S=T=1024, 32 heads, 4 KV "
                "heads, hd 64, bf16), ms; library: ")
    sdpa = "SDPA (is_causal, enable_gqa) "
    bwd_pair_ms = flash_ms["flash_bwd_dq_ms"] + flash_ms["flash_bwd_dkv_ms"]
    measured = {name: flash_ms[f"{name}_ms"] for name in FLASH_KERNELS}
    measured["matmul_8bit"] = eight_step[("matmul_8bit", 8)][0]
    measured["matmul_4bit"] = per_step["matmul_4bit"][0]
    measured["matmul_8bit_t"] = eight_step[("matmul_8bit_t", M_TRAIN)][0]
    measured["matmul_4bit_t"] = t_step[0]
    measured["matmul_int4c"] = per_step["matmul_int4c"][0]
    for name in ("matmul_int8_fused", "matmul_int8"):
        measured[name] = per_step[name][0]
    measured["adam8bit_update"] = adam_step[0]
    emit(earlier_times=dict(
        note="PERF.md's times of the designs before the Hopper redesigns, at the same work, "
             "not measured in this run", **{f"{name}_ms": ms for name, ms in EARLIER_MS.items()},
        per_call_us=EARLIER_US, measured_ms=measured,
        measured_per_call_us={**mm4_per_call, **eight_per_call, **int8_per_call,
                              "matmul_4bit_t": t_per_call,
                              "quantize_blockwise": {"window_8x8": q_op_us}}))
    emit(kernels=[
        entry("matmul_4bit", "matmul_4bit.cu", "quanta_tpu/ops/matmul.py:204",
              launches["matmul_4bit"], *per_step["matmul_4bit"][:2], "bf16",
              at + "; library: none, no PyTorch call dequantizes blockwise 4-bit codes inside "
              "a GEMM (dense_control_ms: cuBLAS torch.matmul of the dequantized bf16 weights; "
              "qlora_forward_ms: one QLoRA forward's 155 calls at M=2048, nf4, as [kernel, "
              "plain, dense]; " + gpt2_at + ", nf4a, bf16 x)",
              dense_control_ms=per_step["matmul_4bit"][2],
              qlora_forward_ms=per_step["matmul_4bit_qlora_forward"],
              gpt2_step_ms=gpt2_step["matmul_4bit"]),
        entry("matmul_int4c", "int4c.cu", "quanta_tpu/ops/int4c.py:116",
              launches["matmul_int4c"], *per_step["matmul_int4c"], "int8",
              at + "; library: none, no PyTorch call unpacks 4-bit codes or applies row and "
              "column scales (prefill_forward_ms: one prefill forward's 155 calls at M=1024 as "
              "[kernel, plain, dense], dense: torch._int_mm of the int8 activations and the "
              "unpacked int8 weight, which takes M > 16 only)",
              prefill_forward_ms=per_step["matmul_int4c_prefill"]),
        entry("matmul_int8_fused", "int8mm.cu", "quanta_tpu/ops/int8mm.py:167",
              launches["matmul_int8_fused"], *per_step["matmul_int8_fused"], "int8",
              at + "; library: none, no PyTorch call quantizes rows of f32 x, applies row and "
              "column scales or adds the outlier partial (" + gpt2_at + ", f32 x; "
              "prefill_forward_ms: " + i8_prefill,
              prefill_forward_ms=per_step["matmul_int8_fused_prefill"],
              gpt2_step_ms=gpt2_step["matmul_int8_fused"]),
        entry("matmul_int8", "int8mm.cu", "quanta_tpu/ops/int8mm.py:235",
              launches["matmul_int8"], *per_step["matmul_int8"], "int8",
              at + "; library: none, torch._int_mm takes no row or column scales "
              "(prefill_forward_ms: " + i8_prefill,
              prefill_forward_ms=per_step["matmul_int8_prefill"]),
        entry("quantize_blockwise", "quantize.cu", "quanta_tpu/ops/quantize.py:65",
              launches["quantize_blockwise"], *q_ms, "f32",
              "one window's K+V write into the int8 pool (K and V 22 x 8 x 8 x 4 x 64 bf16, "
              "one launch; plain: quantize_kv and index_put), ms; library: none, no PyTorch "
              "call turns blockwise absmax into codes (op_us: the op quantize_blockwise alone "
              "on the window's K)", op_us=q_op_us),
        entry("matmul_4bit_t", "matmul_4bit_t.cu", "quanta_tpu/ops/matmul.py:423",
              train_launches["matmul_4bit_t"], *t_step[:2], "bf16",
              "one QLoRA backward's 152 calls at M=2048, bf16 g, nf4, ms; library: none "
              "(dense_control_ms: cuBLAS g @ W_deq^T of the dequantized bf16 weights)",
              dense_control_ms=t_step[2]),
        entry("adam8bit_update", "adam8bit.cu", "quanta_tpu/ops/adam8bit.py:72",
              train_launches["adam8bit_update"], *adam_step, "f32",
              "one QLoRA step's optimizer over its 88 bf16 adapter leaves (66 of 64 blocks, "
              "22 of 8) in one launch, parameters updated in place, ms; library: none, "
              "torch's Adam keeps f32 state"),
        entry("flash_fwd", "flash_fwd.cu", "quanta_tpu/ops/attention.py:189",
              launches["flash_fwd"], flash_ms["flash_fwd_ms"], flash_ms["flash_fwd_plain_ms"],
              "bf16", flash_at + sdpa + "forward", flash_ms["sdpa_fwd_ms"]),
        entry("flash_bwd_dq", "flash_bwd.cu", "quanta_tpu/ops/attention.py:465",
              launches["flash_bwd_dq"], flash_ms["flash_bwd_dq_ms"],
              flash_ms["flash_bwd_dq_plain_ms"], "bf16",
              flash_at + "none: no call computes dq alone (SDPA's backward stands on "
              "flash_bwd_dkv's line)"),
        entry("flash_bwd_dkv", "flash_bwd.cu", "quanta_tpu/ops/attention.py:494",
              launches["flash_bwd_dkv"], flash_ms["flash_bwd_dkv_ms"],
              flash_ms["flash_bwd_dkv_plain_ms"], "bf16",
              flash_at + sdpa + "backward, dq, dk and dv in one call: compare it with this "
              f"kernel's ms plus flash_bwd_dq's, {bwd_pair_ms}", flash_ms["sdpa_bwd_ms"]),
        entry("matmul_8bit", "matmul_8bit.cu", "quanta_tpu/ops/matmul.py:306",
              launches["matmul_8bit"], *eight_step[("matmul_8bit", 8)][:2], "bf16",
              "one decode step's 155 calls at M=8, int8, bf16 x, ms; library: none, no "
              "PyTorch call dequantizes blockwise 8-bit codes inside a GEMM (dense_control_ms: "
              "cuBLAS torch.matmul of the dequantized bf16 weights)",
              dense_control_ms=eight_step[("matmul_8bit", 8)][2],
              qlora_forward_ms=eight_step[("matmul_8bit", M_TRAIN)]),
        entry("matmul_8bit_t", "matmul_8bit_t.cu", "quanta_tpu/ops/matmul.py:529",
              launches["matmul_8bit_t"], *eight_step[("matmul_8bit_t", M_TRAIN)][:2], "bf16",
              "one QLoRA backward's 152 calls at M=2048, int8, bf16 g, ms; library: none "
              "(dense_control_ms as for matmul_8bit)",
              dense_control_ms=eight_step[("matmul_8bit_t", M_TRAIN)][2]),
    ])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
