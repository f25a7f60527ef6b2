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
     plain versions, timed as in phase 3, and the op at block 100; then
     the fused K+V write into the int8 pool (``kvcache.write_rows``, one
     launch) at the prefill and window shapes against ``quantize_kv`` plus
     ``index_put``, equal outside the null page 0 (whose rows repeat),
     timed, and the same at OpenLLaMA-3B's head dim, 100 (26 layers, 32
     KV heads), with its bound;
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
     phase 12's prefill (1024 queries into 1040 slots), phase 13's
     S = T = 2048, OpenLLaMA-3B's training shape (B=2, S=T=1024, 32
     heads, hd 100, which the kernels run padded to 128 columns), Gemma-2B's
     geometry's (B=2, S=T=1024, 8 heads to 1 KV head, hd 256: the
     warp-specialised 256-column forward and dK/dV) and three small ones
     at hd 160 and 132 (run in 256 columns; 132 padded by the wrapper to
     136 in bf16 first) and 37 (padded by the wrapper to 40, run in 64),
     in bf16, and all but phases 12's and 13's also in f32: bf16 output
     within 2 bf16 ulps of max|plain| and rel-L2 1e-2, lse within 1e-4,
     gradients within rel-L2 2e-2 (f32: 1e-5 and 1e-4 of max|plain|), dead
     rows zero with lse 1e30, and out, dq, dk, dv bit-identical over two
     calls; at the S = T
     shapes the times of the kernels, their plain versions and SDPA
     (forward; backward; both; the backend it takes, and in f32, where
     that is math, the efficient backend on K and V expanded to the query
     heads), every row with its bound (at hd 100 also the bound of the 128
     columns the kernels multiply), the f32 rows also with the bound of
     their three TF32 products; then per head_dim (32, 64, 128, 100,
     256, 160, 192, 132: ``FLASH_DESIGN_HDS``) one
     ``flash_bwd_design`` line for each dtype (grid, cluster size,
     warpgroups, threads, blocks resident per SM, registers and shared
     bytes, from ``cudaFuncGetAttributes``; the design: "wgmma_ws" for
     the warp-specialised ones) and one ``flash_fwd_design`` line (the f32
     grids of all three at TinyLlama's shape at least two blocks an SM);
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
     loss below 2.5), the int8, nf8, nf4a and int4 perplexities through
     the kernels (the f32 routes of ``matmul_8bit`` and ``matmul_4bit``)
     within 1e-4 relative of ``use_kernel=False`` on the same trees, and
     the gates of the 8-bit rows (int8, nf8, llm_int8, w8a8-*) hold at
     <= 0.1; the other rows are printed; then the f32 routes of
     ``matmul_4bit`` (nf4a) and ``matmul_8bit`` (int8) at the proxy's four
     (K, N) (512 x 512, 512 x 128, 512 x 1536, 1536 x 512) and M = 32 x
     256 on the trees' own weights, 1e-5 of max|plain|, bit-identical over
     two calls, and the f32 ``matmul_4bit_t`` and ``matmul_8bit_t`` (the
     3xTF32 dx tile) there under the same rule, each timed with its plain
     version, cuBLAS's f32 GEMM on the dequantized weight (the library
     time) and its bound (the dx rows also the bound of their three TF32
     products, which they are read against), the dx rows with their
     design (``matmul_4bit_t_design`` / ``matmul_8bit_t_design``);
 19. GPT-2 small's kernels: ``matmul_4bit`` (nf4a, bf16 and f32 x at M in
     {8, 1024}), ``matmul_8bit`` (int8 and nf8, f32 x at M in {8, 1024})
     and ``matmul_int8_fused`` (f32 x at M in {8, 256}) against their plain
     versions at GPT-2's four (K, N) (768 x 2304, 768 x 768, 768 x 3072,
     3072 x 768) under phase 3's and phase 4's rules (2 bf16 ulps of
     max|plain|, f32 1e-5 of it; LLM.int8 bit for bit), every output
     bit-identical over two calls, the design per row (f32: split-K FMA
     decode up to M = 32, the FMA GEMM above), timed as in phase 3 with
     the plain version and the bound, one GPT-2 decode step's 48 calls (M
     = 8) of each route with their bound, the f32 rows slower than their
     plain version on a line of their own; and the f32 ``matmul_4bit_t``
     and ``matmul_8bit_t`` at M = 1024, checked and timed as in phase 18;
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
     floor rule where bf16 reordering sets a higher floor; then GPT-2 at
     its own f32 (phase 20's loaded tree) quantized to nf4a and to int8:
     the same decode through the f32 routes of ``matmul_4bit`` and
     ``matmul_8bit`` (32 x 48 launches each), prefill logits within 1e-4
     rel-L2 of ``use_kernel=False``;
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
     beside the device's window rate, every request admitted;
 29. the spec-sharded paths (``parallel.spmd`` over ``shard_params``
     trees, ``benchmarks.spmd_bench``), ranks sharing the card over gloo
     through ``parallel.spawn_local``: (a) FSDP QLoRA, Llama-2-7B at full
     width and depth on a data 2 x model 1 mesh under
     ``fsdp_param_specs(tp=False)``, nf4 base, bf16 rank-8 LoRA on wq/wv,
     8-bit Adam, global batch 2 x 512, 3 steps: the step-1 loss within
     1e-2 of the single card's on the same rows and seed, each step-1
     ``lora_b`` gradient within phase 9's floor rule of the single
     card's (the floor also the single card's kernels taking the rows one
     at a time, a rank's M) and within 2e-3 of that row-at-a-time
     gradient, the loss falling by step 3, per rank per step 7 x 32 + 1
     ``matmul_4bit``, 222 ``matmul_4bit_t`` and one ``adam8bit_update``,
     each rank's weights at most half the single card's plus one leaf and
     its gathered weights alive at once at most one leaf; (b) config 5's
     host mesh (dcn 2 x data 1 x model 2, 4 ranks), Llama-2-13B at full
     width and depth, under ``host_llama_param_specs``:
     each rank's prefill logits against the single card's rows by phase
     15's rule, a cached greedy decode with the 'model' ranks agreeing,
     one QLoRA step whose loss equals a flat data 2 x model 2 mesh's
     within 1e-5, and an llm_int8 forward at 2 layers through
     ``matmul_int8_fused`` against the single card by the JAX package's
     ``_assert_quant_close`` rule. A failing rank fails the phase;
 30. GPT-2 small trained in full (12 x 768, vocab 50257, f32, random
     weights from seed 0) through ``train.make_train_step(forward=
     gpt2.forward)``, every one of its 148 leaves (124,439,808 elements)
     stepped by ``Adam8bit`` at the accuracy bench's lr on a fixed batch of
     8 x 1024 tokens: one backward's gradients, cloned, leave parameters
     and 8-bit state bit for bit equal through ``adam8bit_update`` (two
     launches, 128 leaves a launch) and its plain version, and the state
     equal and the parameters within 2 f32 ulps through the optimizer's
     plain route; then 5 steps through the kernels and 5 through
     ``use_kernel=False`` from the same init, losses within rel 1e-4, the
     first within 0.5 of ln 50257, the loss falling, 2 ``adam8bit_update``
     launches a step and nothing else; the step's ms, device-busy share
     and peak memory, and ``adam8bit_update``'s ms a step at this work
     against its bound;
 31. ``benchmarks.engine_gap_bench`` (nf4a, 8 slots, k 8) at
     ``GAP_DEPTH`` layers: the contiguous and paged windows' device
     time, the host loop's window at readback depths 0, 1 and 2 and the
     link's round trip, every term finite and above 0, the synchronous
     host window at least the device's and the round trip below it,
     beside ``serve_bench.window_profile``'s Engine window at that depth;
 32. QLoRA on an f32 base, the JAX package's ``finetune --toy tinyllama
     --dtype float32``: TinyLlama-1.1B at full width and depth in f32
     (random weights from seed 0) quantized to nf4 and to int8, rank-8 f32
     LoRA on wq and wv, 8-bit Adam, batch 4 x seq 512 (einsum attention):
     phase 9's 3 + 3 + 1 steps, the step-1 loss within 1e-4 relative and
     each lora_b gradient within 1e-4 rel-L2 of ``use_kernel=False``
     (``F32_QLORA_REL``: f32 reorderings only; the reordered floor printed
     beside), the loss falling, per step 155 ``matmul_4bit`` (or
     ``matmul_8bit``) through its f32 FMA GEMM, 152 ``matmul_4bit_t`` (or
     ``matmul_8bit_t``) through the 3xTF32 dx tile and 1
     ``adam8bit_update``, nothing else; ``train_bench.bench_qlora`` on each
     base (step ms, tok/s, busy share, step-peak GiB, top device ops, the
     forward and dx kernels' share of the device time); the f32
     ``matmul_4bit`` (nf4) and ``matmul_8bit`` (int8) at the forward's five
     (K, N), M = 2048, on each tree's own leaves, within 1e-5 of
     max|plain|, the same bits on a second call, the design checked; then
     the f32 ``matmul_4bit_t`` and ``matmul_8bit_t`` at TinyLlama's five
     (K, N), M = 2048, as in phase 18;
 33. QLoRA on that f32 base at batch 2 x seq 1024 through flash, the JAX
     package's ``finetune --toy tinyllama --dtype float32 --seq-len
     1024``: nf4, phase 32's 3 + 3 + 1 steps and limits (the plain route's
     attention the plain flash), per step 155 ``matmul_4bit``, 152
     ``matmul_4bit_t``, 22 each of ``flash_fwd``, ``flash_bwd_dq`` and
     ``flash_bwd_dkv`` (their f32 routes: the backward's three TF32
     products for each f32 one) and 1 ``adam8bit_update``, nothing else;
     then ``train_bench.bench_qlora``'s row (step ms, busy share,
     step-peak GiB) with the share of the device time of #1, #4 and each
     flash kernel;
 34. OpenLLaMA-3B v2 (``OPENLLAMA_3B``, from its published config: 3200
     wide, 26 layers, 32 heads, head dim 100, 8640 hidden, vocab 32000) at
     full width and depth, random weights from seed 0: ``matmul_4bit``
     (nf4a, M 8 and 2048) and ``matmul_4bit_t`` (nf4, M 2048) against
     their plain versions at its four (K, N) (K pads to 4096 and 9216, N
     to 8704; N 3200 is 25 tiles of 128), with their designs; (a) a b1 x
     S 2048 prefill with ``use_flash=None``: 26 ``flash_fwd`` launches,
     logits against the einsum route by phase 12's rule, tok/s; (b)
     greedy decode of 16 tokens after a 2032-token prompt (ending at its
     2048 positions): 26 ``flash_fwd`` and 16 x 183 ``matmul_4bit``
     launches, decode tok/s; (c) the Engine with the int8 KV pool over 8
     requests (prompts 128-512, 48 new, 8 slots, multi_step 8), all
     finishing, one ``quantize_blockwise`` a prefill and a window, tok/s
     and TTFT; (d) phase 9's QLoRA path at b2 x s1024 on an nf4 base with
     ``use_flash=None`` (flash by ``attention.kernel_takes``): per
     kernel-route step 183 ``matmul_4bit``, 180 ``matmul_4bit_t``, 26 of
     each flash kernel and one ``adam8bit_update``, phase 9's rules, the
     loss falling; then ``train_bench``'s row (step ms, busy share,
     step-peak GiB).
 35. Gemma-2B's geometry (``GEMMA_2B``, from google/gemma-2b's published
     config: 2048 wide, 18 layers, 8 heads to 1 KV head, head dim 256,
     16384 hidden, vocab 256000, tied embeddings) in the repo's Llama
     block (not Gemma's: no GeGLU, (1 + w) RMSNorm or embedding scale) at
     full width and depth, random weights from seed 0: first the int8 KV
     write at hd 256 with one KV head (the grouped layout at hd = 8 << 5)
     against quantize_kv plus index_put, prefill and window, then phase
     34's parts: #1 and #4 at its four quantized (K, N) (the tied head
     stays bf16); (a) the b1 x S 2048 prefill, 18 ``flash_fwd`` launches
     at hd 256, rep 8; (b) the decode, 18 ``flash_fwd`` and 16 x 126
     ``matmul_4bit``; (c) the Engine with the int8 KV pool; (d) QLoRA at
     b2 x s1024, per kernel-route step 126 ``matmul_4bit``, 123
     ``matmul_4bit_t``, 18 of each flash kernel and one ``adam8bit_update``,
     phase 9's rules; then ``train_bench``'s row; (e) after those, their
     memory freed, phase 33's protocol on an f32 base of the same
     geometry (nf4, all 18 layers) at b2 x s1024 through the f32 flash
     kernels at 256 columns: per kernel-route step 126 ``matmul_4bit``,
     123 ``matmul_4bit_t``, 18 of each flash kernel and one
     ``adam8bit_update``, the f32 limits, the loss falling; then
     ``train_bench``'s row with the kernels' shares of its device time.

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
import statistics
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
from quanta_tpu_torch.benchmarks import (accuracy_bench, decode_bench, engine_gap_bench,
                                         engine_sweep, kernel_bench, logits_gate,
                                         model_scale_bench, serve_bench, spmd_bench, tp_bench,
                                         train_bench)
from quanta_tpu_torch.benchmarks.kernel_bench import L2_BYTES, copies_past_l2, time_ms
from quanta_tpu_torch.benchmarks.kernel_sweep import dequantized_f32, f32_t_row, sdpa_times
from quanta_tpu_torch.benchmarks.logits_gate import rel_l2, reordered_plain
from quanta_tpu_torch.core import codecs
from quanta_tpu_torch.core.qtensor import QuantizedTensor
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
# the int8 KV writes at OpenLLaMA-3B's head dim, 100, off the kernel's
# 8-lane groups: a prefill of 256 tokens and a window of 8 steps for 8
# slots, every layer in one call (phase 34's serve path)
KV_WRITES_HD100 = {"prefill_256_hd100": (26, 256, 32, 100), "window_8x8_hd100": (26, 8, 8, 32, 100)}
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
# phase 29's backward shapes, in nf4: the 13B host mesh's at its M (2 x 128
# rows a rank; the column-local q/k/v, gate/up and head at model 2, wo and
# w_down gathered whole), and the 7B FSDP leg's (head too) at a rank's M
T_SHAPES_SPMD = ([(s, 256) for s in ((5120, 2560), (5120, 6912), (5120, 16000), (5120, 5120),
                                     (13824, 5120))]
                 + [(s, 512) for s in T_SHAPES_7B + ((4096, 32000),)])
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
# tile) and long_prefill's reference row (S = T = 2048), OpenLLaMA-3B's and
# Gemma-2B's QLoRA shapes, and three small ones at head dims off the
# compiled widths (160 and 132, run in 256 columns: 132, 4 mod 8, after the
# wrapper's zero columns to 136 in bf16, whose 256-column kernels load by
# TMA; 37, off a multiple of 4, which the wrapper pads to 40 and runs in
# 64): (B, Sq, T, nh, nkv, hd, q_start, kv_len); each in bf16; in f32 too
# the prefill, the training shapes (the f32 QLoRA of phase 33 runs the
# first) and the small ones
FLASH_SHAPES = {
    "tinyllama_s1024": (2, 1024, 1024, 32, 4, 64, [0, 0], [1024, 1024]),
    "llama2_7b_s1024": (1, 1024, 1024, 32, 32, 128, [0], [1024]),
    "cached_prefill": (3, 1024, 1152, 32, 4, 64, [0, 64, 0], [1024, 1088, 0]),
    "prompt_prefill": (2, 1024, 1040, 32, 4, 64, [0, 0], [1024, 1024]),
    "long_prefill_s2048": (2, 2048, 2048, 32, 4, 64, [0, 0], [2048, 2048]),
    # OpenLLaMA-3B's QLoRA shape (phase 34): hd 100, run padded to 128
    "openllama_3b_s1024": (2, 1024, 1024, 32, 32, 100, [0, 0], [1024, 1024]),
    # Gemma-2B's geometry's QLoRA shape (phase 35): hd 256, 8 query heads to one KV head
    "gemma_2b_s1024": (2, 1024, 1024, 8, 1, 256, [0, 0], [1024, 1024]),
    "hd160_small": (2, 300, 330, 8, 2, 160, [0, 30], [300, 330]),
    "hd132_small": (2, 300, 330, 8, 2, 132, [0, 30], [300, 330]),
    "hd37_small": (3, 200, 230, 8, 1, 37, [0, 30, 0], [200, 230, 0]),
}
FLASH_CASES = [(name, torch.bfloat16) for name in FLASH_SHAPES] + [
    (name, torch.float32) for name in ("tinyllama_s1024", "llama2_7b_s1024", "cached_prefill",
                                       "openllama_3b_s1024", "gemma_2b_s1024", "hd160_small",
                                       "hd132_small", "hd37_small")]
# the head dims, and their shapes, whose kernels' launch designs are printed
# (flash_fwd_design / flash_bwd_design lines)
FLASH_DESIGN_HDS = ((32, "tinyllama_s1024"), (64, "tinyllama_s1024"), (128, "llama2_7b_s1024"),
                    (100, "openllama_3b_s1024"), (256, "gemma_2b_s1024"),
                    (160, "gemma_2b_s1024"), (192, "gemma_2b_s1024"), (132, "gemma_2b_s1024"))
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
# shapes named (quantize_blockwise: one warp per vector, the window's K);
# the bf16 flash forward and dK/dV at 256 columns before their
# warp-specialised redesign (the cp.async kernels; dK/dV two blocks of 128
# columns each) at Gemma-2B's geometry's QLoRA shape (*_hd256); the f32 dQ
# and dK/dV there before their split redesign (one block of 16 own rows
# and all 256 columns, each raw tile loaded before its products;
# *_f32_hd256). Printed on a line of their own, apart from the kernels
# line's measured times.
EARLIER_MS = {"flash_bwd_dq": 0.2697, "flash_bwd_dkv": 0.7539, "flash_fwd": 0.1999,
              "flash_fwd_hd256": 0.0609, "flash_bwd_dkv_hd256": 0.2026,
              "flash_bwd_dq_f32_hd256": 0.4929, "flash_bwd_dkv_f32_hd256": 0.6940,
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
    # the first port's f32 FMA kernels of #4 (nf4a) and #5 (int8) before
    # their 3xTF32 redesign, at GPT-2's (K, N), M = 1024, the proxy's, M =
    # 8192, and TinyLlama-1.1B's, M = 2048 (PERF.md, PR 18's run-B table,
    # its "[first port]" column)
    "matmul_4bit_t_f32": {"M1024_768x2304": 246.0, "M1024_768x768": 84.8,
                          "M1024_768x3072": 327.8, "M1024_3072x768": 197.5,
                          "M8192_512x512": 315.4, "M8192_512x128": 89.2,
                          "M8192_512x1536": 921.0, "M8192_1536x512": 577.9,
                          "M2048_2048x2048": 611.8, "M2048_2048x256": 80.2,
                          "M2048_2048x5632": 1659.6, "M2048_5632x2048": 1702.1,
                          "M2048_2048x32000": 9364.0},
    "matmul_8bit_t_f32": {"M1024_768x2304": 256.8, "M1024_768x768": 88.5,
                          "M1024_768x3072": 340.9, "M1024_3072x768": 209.2,
                          "M8192_512x512": 321.9, "M8192_512x128": 86.4,
                          "M8192_512x1536": 953.4, "M8192_1536x512": 598.6,
                          "M2048_2048x2048": 640.7, "M2048_2048x256": 83.7,
                          "M2048_2048x5632": 1741.9, "M2048_5632x2048": 1783.9,
                          "M2048_2048x32000": 9889.4},
}
# the first port's f32 flash kernels (CUDA-core FMAs, before their 3xTF32
# redesigns), ms a call on the f32 rows' inputs at the S = T shapes
# (PERF.md's kernel table and f32 flash table: the backward's, kernel_sweep
# --what flash --dtype float32 on the package before its redesign, the mean
# of two runs; the forward's, this script's f32 rows before its redesign)
EARLIER_F32_MS = {"flash_bwd_dq": {"tinyllama_s1024": 1.1383, "llama2_7b_s1024": 1.1879},
                  "flash_bwd_dkv": {"tinyllama_s1024": 2.4608, "llama2_7b_s1024": 1.5401},
                  "flash_fwd": {"tinyllama_s1024": 0.730, "llama2_7b_s1024": 0.935}}
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
# the timed serve rows (phase 7b), decode bench (phase 8) and phase 28's
# trace run the first TIMED_DEPTH of the 22 layers: timing rows only, whose
# host-bound loops took 420 s of a 785 s run at full depth, at 11 layers
# phases 8 and 28 took 53 and 76 s of a 1118 s run, and at 6 they took 30
# and 40 s of a 1065 s run on a slow host (PERF.md); phases 5, 6 and 7a
# check the same paths at full depth
TIMED_DEPTH = 4
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
# phase 29's (K, N) and M, in nf4: the 13B host mesh's column-local (K, N)
# at model 2 (q/k/v, gate/up, the head) and its gathered wo and w_down, at
# its decode M (2 rows a rank), its prefill and QLoRA M (2 x 128) and 512;
# the 7B FSDP leg's at a rank's M (1 x 512)
SPMD_MM4 = ([(kn, (2, 256, 512)) for kn in ((5120, 2560), (5120, 6912), (5120, 16000),
                                             (5120, 5120), (13824, 5120))]
            + [(kn, (512,)) for kn in MODEL_MM4[:4]])
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
# the f32 proxy's rows held to ACC_PPL_REL through the kernels (#3's and #1's
# f32 routes), and its linears' (K, N): q and o, k and v, gate and up, down
ACC_KERNEL_VS_PLAIN = ("int8", "nf8", "nf4a", "int4")
ACC_SHAPES = ((512, 512), (512, 128), (512, 1536), (1536, 512))
# GPT-2 small: the (K, N) of its four linears and their count in one
# forward (the tied head is dense); the kernel checks' M (matmul_4bit nf4a
# in bf16 and f32, matmul_8bit in f32 in its formats, LLM.int8 on f32 x,
# the f32 backward kernels); the decode prompts and new tokens
GPT2_SHAPES = {(768, 2304): 12, (768, 768): 12, (768, 3072): 12, (3072, 768): 12}
GPT2_MM4 = ((torch.bfloat16, (8, 1024)), (torch.float32, (8, 1024)))
GPT2_MM8, GPT2_MM8_MS = ("int8", "nf8"), (8, 1024)
GPT2_I8_MS = (8, 256)
GPT2_T_F32_M = 1024
# phase 23's f32 trees and the kernel each launches; their prefill logits
# against the plain route (f32 products, f32 sums in another order)
GPT2_F32_FMTS = (("nf4a", "matmul_4bit"), ("int8", "matmul_8bit"))
F32_LOGITS_REL = 1e-4
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
# the spec-sharded paths (phase 29): ranks sharing the card over gloo; the
# FSDP leg at Llama-2-7B's full width and depth, the host-mesh leg at
# Llama-2-13B's (its llm_int8 forward at 2 layers)
SPMD_FSDP = dict(batch=2, seq=512, steps=3)
SPMD_HOST = dict(batch=4, prompt_len=128, new=4, int8_layers=2)
SPMD_TIMEOUT_S = 600
# phase 30: GPT-2 small trained in full, b 8 x s 1024, at the accuracy
# bench's lr (quanta_tpu_torch/benchmarks/accuracy_bench.py)
GPT2_TRAIN = dict(batch=8, seq=1024, steps=5, lr=accuracy_bench.LR, seed=0)
GPT2_LEAVES = 4 + 12 * 12  # wte, wpe, ln_f.{w,b}; 12 layers of six {w, b} pairs
GPT2_ELEMENTS = 124_439_808
# the optimizer's plain route divides by bc1 in another order than the
# kernel: parameters within 2 f32 ulps of |p| + lr
GPT2_REORDER_REL = 2.0 ** -22
# phase 32: QLoRA on an f32 TinyLlama-1.1B base (the JAX package's
# ``finetune --toy tinyllama --dtype float32``) in nf4 and int8, and the
# kernels each base launches; its step-1 loss and lora_b gradients against
# the plain route within F32_QLORA_REL (f32 products, f32 sums in another
# order, as F32_LOGITS_REL)
F32_QLORA = (("nf4", ("matmul_4bit", "matmul_4bit_t")),
             ("int8", ("matmul_8bit", "matmul_8bit_t")))
F32_QLORA_REL = 1e-4
# the f32 QLoRA steps' kernels (phases 33, 35 (e)) by a part of their names
# in a profile: #1's f32 forward, #4's f32 dx, the f32 flash kernels
F32_SHARE_KEYS = {"matmul_4bit": "mmf_", "matmul_4bit_t": "mmt_tf32x3",
                  "flash_fwd": "flash_fwd_f32", "flash_bwd_dq": "flash_bwd_dq_f32",
                  "flash_bwd_dkv": "flash_bwd_dkv_f32"}
# phase 34: OpenLLaMA-3B v2 (openlm-research/open_llama_3b_v2, a
# LlamaForCausalLM; its config.json: hidden_size 3200, intermediate_size
# 8640, num_hidden_layers 26, num_attention_heads 32, num_key_value_heads
# 32, vocab_size 32000, max_position_embeddings 2048, rms_norm_eps 1e-6,
# untied embeddings): head dim 100, which the flash kernels run padded to
# 128 columns and the int8 KV write one warp a vector; at full width and
# depth, random weights from seed 0. (a) a b1 x S 2048 prefill, use_flash
# None; (b) greedy decode of OL_NEW tokens after a prompt of 2048 - OL_NEW
# (the model's 2048 positions); (c) the Engine over OL_SERVE's requests
# with the int8 KV pool; (d) QLoRA at b2 x s1024
OPENLLAMA_3B = dict(vocab_size=32000, dim=3200, n_layers=26, n_heads=32, n_kv_heads=32,
                    hidden_dim=8640, norm_eps=1e-6, max_seq_len=2048)
OL_PREFILL, OL_NEW, OL_BATCH, OL_SEQ = 2048, 16, 2, 1024
OL_SERVE = dict(n_requests=8, min_prompt=128, max_prompt=512, max_new=48, n_slots=8,
                multi_step=8, buckets=(128, 256, 512))
# its linears' (K, N): #1 and #4 meet K_pad 4096 and 9216, N_pad 8704, and
# N 3200's 25 tiles of 128 there
OL_SHAPES = ((3200, 3200), (3200, 8640), (8640, 3200), (3200, 32000))
# phase 35: Gemma-2B's geometry (google/gemma-2b's config.json:
# hidden_size 2048, num_attention_heads 8, num_key_value_heads 1 (MQA),
# head_dim 256 = 2048 / 8, intermediate_size 16384, num_hidden_layers 18,
# vocab_size 256000, max_position_embeddings 8192, rms_norm_eps 1e-6,
# rope_theta 10000, tied embeddings) run in the repo's Llama block: neither
# package runs Gemma's own block (GeGLU, the (1 + w) RMSNorm, the sqrt(d)
# embedding scale), so this is Gemma-2B's geometry, not Gemma-2B. Its
# attention is Gemma-2B's: hd 256 (the flash kernels' 256-column width)
# with one KV head (the int8 KV write's grouped layout at hd = 8 << 5).
# Full width and all 18 layers, random weights from seed 0, bf16; phase
# 34's four parts at its sizes (OL_PREFILL, OL_NEW, OL_BATCH x OL_SEQ,
# OL_SERVE). The tied head is the bf16 embedding, which stays unquantized:
# 7 quantized linears a layer and none after them.
GEMMA_2B = dict(vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
                hidden_dim=16384, norm_eps=1e-6, max_seq_len=8192, tie_embeddings=True)
GM_SHAPES = ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
# its int8 KV writes, every layer in one call: a prefill of 256 tokens and a
# window of 8 steps for 8 slots
KV_WRITES_HD256 = {"prefill_256_hd256": (18, 256, 1, 256), "window_8x8_hd256": (18, 8, 8, 1, 256)}
# phase 31's depth: at 11 layers the phase took 72.7 s on an
# H100 80GB HBM3 at 700 W, at 8 59.7 s on a slow host, most of it the host
# issuing profiled and timed windows
GAP_DEPTH = 6


# the H100 SXM's published rates (profiling.H100): device memory, and
# dense peaks by operand type
HBM_BYTES_S = profiling.H100.hbm_gbps * 1e9
PEAK_OPS_S = {"bf16": profiling.H100.bf16_tflops * 1e12,
              "int8": profiling.H100.int8_tops * 1e12, "f32": profiling.H100.f32_tflops * 1e12,
              "tf32": profiling.H100.tf32_tflops * 1e12}


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
    -13B's (K, N) for M in ``MODEL_MM4_MS`` in nf4a, and at phase 29's
    (K, N) and M (``SPMD_MM4``) in nf4, within 2 bf16 ulps of
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
             + [(k, n, m, ("nf4a",)) for (k, n) in MODEL_MM4 for m in MODEL_MM4_MS]
             + [(k, n, m, ("nf4",)) for (k, n), ms in SPMD_MM4 for m in ms])
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
    four index_put scatters); the same at OpenLLaMA-3B's head dim, 100
    (``KV_WRITES_HD100``: one warp a vector, off the 8-lane groups), and
    the op at block 100. Returns the window write's (kernel, plain) ms,
    the op's µs at the window's K, the hd-100 rows by name and the largest
    difference."""
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
    # the op at block 100: one warp a block, lanes striding
    x = (torch.randn(KV_WRITES_HD100["prefill_256_hd100"], generator=gen, device=dev) * 2).to(
        torch.bfloat16)
    x[0, 0] = 0.0
    out = quantize.quantize_blockwise(x, fmt="int8_sym", block=100, use_kernel=True)
    ref = quantize.quantize_blockwise(x, fmt="int8_sym", block=100, use_kernel=False)
    check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
          "quantize_blockwise block 100 not bit-exact")
    op_us["prefill_256_hd100"] = time_ms(lambda i: quantize.quantize_blockwise(
        x, fmt="int8_sym", block=100), 100) * 1e3
    emit(kernel_check=dict(kernel="quantize_blockwise", fmt="int8_sym", block=100,
                           shape=list(x.shape), max_abs_err=0.0, tol=0.0,
                           us=op_us["prefill_256_hd100"]))
    # the codebook branch, which the serve path does not take
    x = torch.randn((4096 * 64,), generator=gen, device=dev)
    for fmt in ("nf4", "nf4a", "fp4"):
        out = quantize.quantize_blockwise(x, fmt=fmt, block=64, use_kernel=True)
        ref = quantize.quantize_blockwise(x, fmt=fmt, block=64, use_kernel=False)
        check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
              f"quantize_blockwise {fmt} not bit-exact")

    write_ms, hd100 = {}, {}
    tiny, ol = llama.LlamaConfig.tinyllama_1b(), llama.LlamaConfig(**OPENLLAMA_3B)
    for name, shape, cfg in [(n, KV_WRITES[n], tiny) for n in ("prefill_256", "window_8x8")] + \
            [(n, sh, ol) for n, sh in KV_WRITES_HD100.items()]:
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
        hd = shape[-1]
        n_vec = 2 * k.numel() // hd
        w = (nbytes(k, v, rows) + n_vec * (hd + 4), 3 * 2 * k.numel())
        if name == "window_8x8":
            add_work(work, "quantize_blockwise", *w)
        row = dict(kernel="quantize_blockwise", write="kv_int8_pool", kv=name,
                   shape=list(k.shape), pool_pages=KV_PAGES, max_abs_err=err, tol=0.0,
                   us=write_ms[name][0] * 1e3, plain_us=write_ms[name][1] * 1e3,
                   unfused_us=unfused_us)
        if name in KV_WRITES_HD100:
            row["bound_us"], row["bound_by"] = _bound_us(*w, "f32")
            hd100[name] = row
        emit(kernel_check=row)
    return write_ms["window_8x8"], op_us["window_8x8"], hd100, max_err


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
    Llama-2-7B's at M = 1024, Llama-2-13B's at M = 512) in nf4 and nf4a,
    and at phase 29's (``T_SHAPES_SPMD``) in nf4, bf16 g within 2 bf16
    ulps of max|plain| and bit-identical over two calls,
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
    cases += [(k, n, m, "nf4", torch.bfloat16) for (k, n), m in T_SHAPES_SPMD]
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


def qlora_path(dev, cfg, base, fmt="nf4", kernels=("matmul_4bit", "matmul_4bit_t"),
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, use_flash=None):
    """3 QLoRA steps through the kernels and 3 through the plain versions,
    from the same adapters on one fixed batch, launches counted per step;
    then one step through the reordered plain versions (the noise floor).
    ``kernels``: the forward and transposed kernels of the base's layout;
    ``use_flash`` goes to ``llama.forward`` (with True, or None at seq >=
    ``llama.FLASH_MIN_SEQ`` where the kernels take the head dim,
    ``n_layers`` of each flash kernel a kernel-route step). The step-1 loss within 1e-2
    relative of the plain route and each lora_b gradient within the floor
    rule; on an f32 base (``cfg.dtype``, f32 adapters) both within
    ``F32_QLORA_REL``, the floor printed beside. Returns the kernel route's
    launches."""
    f32_rel = F32_QLORA_REL if cfg.dtype == torch.float32 else None
    data = train_bench.make_batch(cfg, batch, seq, dev)
    init = train_bench.with_lora(base)
    per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)  # a tied head is bf16
    per_backward = per_forward - 3  # layer 0's wq, wk and wv need no dx
    flash = use_flash if use_flash is not None else (
        seq >= llama.FLASH_MIN_SEQ and attention.kernel_takes(cfg.head_dim, cfg.dtype))
    runs = {}
    for route in (None, False, "reordered"):
        adapters = [{k: {ab: t.detach().clone().requires_grad_() for ab, t in v.items()}
                     for k, v in ad.items()} for ad in train.extract_adapters(init)]
        params = train.merge_adapters(init, adapters)
        use_kernel = None if route is None else False
        opt = Adam8bit(qnn.lora_parameters(params), lr=TRAIN_LR, use_kernel=use_kernel)
        step = train.make_qlora_train_step(cfg, opt, use_kernel=use_kernel, use_flash=use_flash)
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
            expected.update({kernels[0]: per_forward, kernels[1]: per_backward,
                             "adam8bit_update": 1})
            if flash:
                expected.update(dict.fromkeys(FLASH_KERNELS, cfg.n_layers))
        for i, c in enumerate(counts):
            check(c == expected, f"qlora {fmt} route {route} step {i + 1}: launches {c}, "
                                 f"expected {expected}")
        check(all(math.isfinite(v) for v in losses), f"qlora {fmt} route {route}: {losses}")
        check(losses[2] < losses[0], f"qlora {fmt} route {route}: loss did not fall: {losses}")
        runs[route] = (losses, grads)
        if route is None:
            kernel_launches = {k: sum(c[k] for c in counts) for k in expected}
        emit(qlora_path=dict(base=fmt, route="kernels" if route is None else "plain", lr=TRAIN_LR,
                             batch=batch, seq=seq, use_flash=use_flash, losses=losses,
                             step_seconds=seconds, launches_per_step=counts[0]))
    (lk, gk), (lp, gp), (lr_, gr) = runs[None], runs[False], runs["reordered"]
    loss_rel, loss_tol = abs(lk[0] - lp[0]) / abs(lp[0]), f32_rel or 1e-2
    check(loss_rel <= loss_tol, f"qlora {fmt} step-1 loss {lk[0]} vs plain {lp[0]}")

    b_rel, floor = [], []
    for (ak, bk), (ap, bp), (_, br) in zip(gk, gp, gr):
        check(torch.count_nonzero(ak).item() == 0 and torch.count_nonzero(ap).item() == 0,
              "qlora: lora_a gradients must be zero at step 1 (B starts at zero)")
        b_rel.append(rel_l2(bk, bp))
        floor.append(rel_l2(br, bp))
    tols = [f32_rel or GRAD_FLOOR_X * f + GRAD_FLOOR_ABS for f in floor]
    emit(qlora_check=dict(base=fmt, step1_loss_rel=loss_rel, tol=loss_tol,
                          lora_b_grad_rel_l2_max=max(b_rel), lora_b_grad_rel_l2=b_rel, grad_tols=tols,
                          reordered_plain_loss_rel=abs(lr_[0] - lp[0]) / abs(lp[0]),
                          reordered_plain_rel_l2_max=max(floor), reordered_plain_rel_l2=floor))
    rule = "f32" if f32_rel else f"{GRAD_FLOOR_X} x its floor + {GRAD_FLOOR_ABS}"
    for i, (b, tol) in enumerate(zip(b_rel, tols)):
        check(b <= tol, f"qlora {fmt} layer {i // 2} {('wq', 'wv')[i % 2]} lora_b gradient "
                        f"rel-L2 {b} > {tol} ({rule})")
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
    both), the f32 rows with their bounds (CUDA cores, and the three TF32
    products each f32 one runs as), at a head dim off the compiled widths
    (OpenLLaMA-3B's 100, run in 128 columns) also the bound of the work
    those padded columns do; the f32 grids at TinyLlama's shape at least
    two blocks an SM. Returns the bf16 rows by shape (those of the S = T
    shapes timed), the f32 rows by shape and the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(6)
    times, f32_times, max_err = {}, {}, dict.fromkeys(FLASH_KERNELS, 0.0)
    for name, dtype in FLASH_CASES:
        b, sq, t, nh, nkv, hd, q_start, kv_len = FLASH_SHAPES[name]
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for shape in
                       ((b, sq, nh, hd), (b, t, nkv, hd), (b, t, nkv, hd), (b, sq, nh, hd)))
        qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        out, lse = attention.flash_forward(q, k, v, qs, kl, save_lse=True, use_kernel=True)
        check(torch.equal(out, attention.flash_forward(q, k, v, qs, kl, use_kernel=True)[0]),
              f"flash forward {name} {dtype}: two calls differ")
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
                   dead_rows=int((~live).sum()), bit_identical_over_two_calls=True)
        if sq == t:
            row.update(flash_times(q, k, v, do, qs, kl, ref_lse, delta))
            pairs = nh * live_pairs(q_start, kv_len, sq, t)
            hdp = attention.padded_head_dim(hd)

            def work_of(width):
                return {"flash_fwd": (nbytes(q, k, v, out, lse), 4 * width * pairs),
                        "flash_bwd_dq": (nbytes(q, k, v, do, lse, delta, dq), 6 * width * pairs),
                        "flash_bwd_dkv": (nbytes(q, k, v, do, lse, delta, dk, dv),
                                          8 * width * pairs)}
            row_work = work_of(hd)
            row["padded_head_dim"] = hdp
            for kname, w in row_work.items():
                if dtype == torch.bfloat16:
                    row[f"{kname}_bound_ms"], row[f"{kname}_bound_by"] = bound(w, "bf16")
                else:
                    # f32: bound on the CUDA cores, and by the three TF32
                    # products that each f32 product of the kernels runs as
                    row[f"{kname}_bound_ms"], row[f"{kname}_bound_by"] = bound(w, "f32")
                    row[f"{kname}_tf32x3_bound_ms"] = bound((w[0], 3 * w[1]), "tf32")[0]
                if hdp != hd:  # the work of the zero columns the kernels multiply too
                    wp = work_of(hdp)[kname]
                    row[f"{kname}_bound_ms_padded"] = bound(
                        wp, "bf16" if dtype == torch.bfloat16 else "f32")[0]
                    if dtype == torch.float32:
                        row[f"{kname}_tf32x3_bound_ms_padded"] = bound(
                            (wp[0], 3 * wp[1]), "tf32")[0]
            if dtype == torch.bfloat16:
                times[name] = row
                if name == "tinyllama_s1024":
                    for kname, (n_bytes, ops) in row_work.items():
                        add_work(work, kname, n_bytes, ops)
            else:
                f32_times[name] = row
        emit(kernel_check=row)
    for hd, shape in FLASH_DESIGN_HDS:
        b, sq, t, nh, nkv = FLASH_SHAPES[shape][:5]
        for dtype in (torch.bfloat16, torch.float32):
            design = {name: attention.flash_bwd_design(name, b, sq, t, nh, nkv, hd, dtype=dtype)
                      for name in ("flash_bwd_dq", "flash_bwd_dkv")}
            fwd = attention.flash_fwd_design(b, sq, nh, hd, dtype=dtype)
            if dtype == torch.float32 and (hd, shape) == (64, "tinyllama_s1024"):
                for name, d in {**design, "flash_fwd": fwd}.items():
                    check(d["grid_x"] * d["grid_y"] * d["grid_z"] >= 2 * d["sms"],
                          f"{name} f32 at {shape}: a grid under two blocks an SM: {d}")
            emit(flash_bwd_design=dict(head_dim=hd, dtype=str(dtype),
                                       shape=[b, sq, t, nh, nkv, hd], **design))
            emit(flash_fwd_design=dict(head_dim=hd, dtype=str(dtype),
                                       shape=[b, sq, t, nh, nkv, hd], **fwd))
    return times, f32_times, max_err


def flash_times(q, k, v, do, qs, kl, lse, delta):
    """ms per call: each kernel, its plain version, and SDPA on the same
    inputs (``kernel_sweep.sdpa_times``: forward, backward and both, the
    backend it takes and, where that is math, the efficient backend on K
    and V expanded to the query heads)."""
    bwd = (q, k, v, do, lse, delta, qs, kl)
    ms = {}
    for route, uk, iters in (("ms", True, 20), ("plain_ms", False, 3)):
        ms[f"flash_fwd_{route}"] = time_ms(lambda i: attention.flash_forward(
            q, k, v, qs, kl, save_lse=True, use_kernel=uk), iters)
        ms[f"flash_bwd_dq_{route}"] = time_ms(lambda i: attention.flash_bwd_dq(
            *bwd, use_kernel=uk), iters)
        ms[f"flash_bwd_dkv_{route}"] = time_ms(lambda i: attention.flash_bwd_dkv(
            *bwd, use_kernel=uk), iters)
    return {**ms, **sdpa_times(q, k, v, do)}


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
    and matmul_8bit's f32 ones bit-identical over two calls, matmul_8bit's
    design per shape.
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
        design = matmul.matmul_8bit_design(m, n, k, dtype=dtype)
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
                if dtype == torch.bfloat16 or name == "matmul_8bit":
                    same = torch.equal(out, run(True, [(codes, scales)])(0))
                    check(same, f"{name} {fmt} {dtype} M={m} K={k} N={n}: two calls differ")
                    row.update(bit_identical_over_two_calls=same)
                    if name == "matmul_8bit":
                        row.update(design=design)
                if dtype == torch.bfloat16:
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


def _first_leaves(tree, shapes):
    """The first QuantizedTensor of each logical (K, N) in ``shapes``."""
    found = {}
    for leaf in _tensors(tree):
        if isinstance(leaf, QuantizedTensor) and tuple(leaf.shape) in shapes:
            found.setdefault(tuple(leaf.shape), leaf)
    check(set(found) == set(shapes), f"linears {sorted(found)}, expected {sorted(shapes)}")
    return found


def accuracy_phase(dev):
    """accuracy_bench at its model size, pretraining cut to ACC_STEPS, no
    cache; the gates of the 8-bit rows, and the perplexities of
    ``ACC_KERNEL_VS_PLAIN`` through the kernels against use_kernel=False on
    the same trees; the f32 routes of matmul_4bit (nf4a) and matmul_8bit
    (int8) at the proxy's four (K, N) and M = batch x seq on the trees' own
    weights, and the f32 matmul_4bit_t and matmul_8bit_t there. Returns the
    proxy's f32 times as {kernel: {"M{m}_{k}x{n}": [kernel µs, plain µs,
    bound µs, library µs]}} (the transposed kernels' as
    ``_transposed_f32_rows`` gives them)."""
    _build.reset_launches()
    result, variants, eval_ids, acfg = accuracy_bench.run(steps=ACC_STEPS, device=dev)
    eight_launches = _build.launches["matmul_8bit"]
    four_launches = _build.launches["matmul_4bit"]
    rows = {r["format"]: r for r in result["rows"]}
    check(result["final_loss"] < 2.5, f"accuracy: final loss {result['final_loss']} >= 2.5")
    plain = {}
    for fmt in ACC_KERNEL_VS_PLAIN:
        plain[fmt] = qeval.perplexity(variants[fmt], eval_ids, acfg, seq_len=result["seq"],
                                      batch=result["batch"], use_kernel=False)
    kernel_vs_plain = {f: abs(rows[f]["ppl"] - p) / p for f, p in plain.items()}
    emit(accuracy=dict(result, plain_ppl=plain, kernel_vs_plain_rel=kernel_vs_plain,
                       tol=ACC_PPL_REL, matmul_8bit_launches=eight_launches,
                       matmul_4bit_launches=four_launches))
    for f, rel in kernel_vs_plain.items():
        check(rel <= ACC_PPL_REL, f"accuracy {f}: kernel ppl {rows[f]['ppl']} vs plain "
                                  f"{plain[f]} (rel {rel} > {ACC_PPL_REL})")
    check(eight_launches > 0, "accuracy: the 8-bit rows launched no matmul_8bit")
    check(four_launches > 0, "accuracy: the 4-bit rows launched no matmul_4bit")
    for name in ACC_GATED:
        check(rows[name]["pass"], f"accuracy gate {name}: delta {rows[name]['delta']} > "
                                  f"{rows[name]['gate']}")
    m = result["batch"] * result["seq"]
    gen = torch.Generator(device=dev).manual_seed(18)
    times = {}
    for kernel, fmt in (("matmul_4bit", "nf4a"), ("matmul_8bit", "int8")):
        times[kernel] = {}
        for (k, n), qt in _first_leaves(variants[fmt], ACC_SHAPES).items():
            x = torch.randn((m, k), generator=gen, device=dev)
            _, row = _quantized_check(f"accuracy {kernel} {fmt} f32 M={m} K={k} N={n}", x, qt,
                                      torch.float32, 10)
            emit(kernel_check=dict(kernel=kernel, model="accuracy_proxy", fmt=fmt, **row))
            times[kernel][f"M{m}_{k}x{n}"] = [row["us"], row["plain_us"], row["bound_us"],
                                             row["library_us"]]
    times.update(_transposed_f32_rows(gen, dev, ACC_SHAPES, m, "accuracy_proxy"))
    return times


def _bound_us(n_bytes, ops, kind):
    """``bound`` of one call, in µs."""
    bound_ms, bound_by = bound([n_bytes, ops], kind)
    return bound_ms * 1e3, bound_by


def _quantized_check(name, x, qt, dtype, iters):
    """matmul_quantized (bf16 or f32 x) against its plain version: within 2
    bf16 ulps of max|plain| (f32: 1e-5 of it), the same bits on a second
    call. Returns (out, row) with µs per call, its plain version's and the
    bound, the weights rotated past the L2."""
    qts = [dataclasses.replace(qt, codes=c, scale=sc)
           for c, sc in copies_past_l2(qt.codes, qt.scale)]

    def run(use_kernel, qs):
        return lambda i: matmul.matmul_quantized(x, qs[i % len(qs)], use_kernel=use_kernel)
    out, ref = run(None, [qt])(0), run(False, [qt])(0)
    m, (k, n) = x.shape[0], qt.shape
    err = (out.float() - ref.float()).abs().max().item()
    tol = (2 * BF16_ULP if dtype == torch.bfloat16 else 1e-5) * ref.float().abs().max().item()
    check(out.shape == ref.shape == (m, n) and torch.isfinite(out).all().item(),
          f"{name}: bad output")
    check(err <= tol, f"{name}: err {err} > {tol}")
    same = torch.equal(out, run(None, [qt])(0))
    check(same, f"{name}: two calls differ")
    bound_us, bound_by = _bound_us(nbytes(x, qt.codes, qt.scale, out), 2 * m * k * n,
                                   "bf16" if dtype == torch.bfloat16 else "f32")
    row = dict(M=m, K=k, N=n, dtype=str(dtype).removeprefix("torch."), max_abs_err=err, tol=tol,
               us=time_ms(run(None, qts), iters) * 1e3,
               plain_us=time_ms(run(False, qts), iters) * 1e3, bound_us=bound_us,
               bound_by=bound_by, bit_identical_over_two_calls=same)
    if dtype == torch.float32:
        ws = copies_past_l2(dequantized_f32(qt))
        xp = matmul._pad_k(x, ws[0][0].shape[0])
        row["library_us"] = time_ms(lambda i: xp @ ws[i % len(ws)][0], iters) * 1e3
    return out, row



def _checked_design(report, m, n, k_pad, dtype):
    """The design report of the route x of ``dtype`` takes, checked against
    its split at M = 32."""
    design = report(m, n, k_pad, dtype=dtype)
    names = ("decode", "prefill") if dtype == torch.bfloat16 else ("fma_decode", "fma_prefill")
    check(design["design"] == names[m > 32], f"M={m} K_pad={k_pad} N={n}: design {design}")
    return design


def _transposed_f32_rows(gen, dev, shapes, m, tag):
    """The f32 routes of matmul_4bit_t (nf4a) and matmul_8bit_t (int8), the
    3xTF32 wgmma design, against their plain versions at ``shapes`` (K, N)
    and M: within 1e-5 of max|plain|, the same bits on a second call, µs per
    call with the weights rotated past the L2, beside the plain version's,
    cuBLAS's f32 GEMM on the dequantized weight (the library time), the f32
    bound (the CUDA cores' 67 TFLOP/s) and the design's own (its three TF32
    products at 495 TFLOP/s, or its bytes), which the row is read against.
    Returns {kernel: {"M{m}_{k}x{n}": {"us", "plain_us", "library_us",
    "bound_us", "tf32x3_bound_us"}}}."""
    times = {"matmul_4bit_t": {}, "matmul_8bit_t": {}}
    for k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        g = torch.randn((m, n), generator=gen, device=dev)
        for name, fn, fmt, report in (
                ("matmul_4bit_t", matmul.matmul_4bit_t, "nf4a", matmul.matmul_4bit_t_design),
                ("matmul_8bit_t", matmul.matmul_8bit_t, "int8", matmul.matmul_8bit_t_design)):
            qt = codecs.quantize_matmul_weight(w, fmt=fmt, block_size=64)
            out, r = f32_t_row(g, qt, fn, 3)
            err, tol, same = r["max_abs_err"], r["tol"], r["same"]
            tag_ = f"{tag} {name} f32 M={m} K={k} N={n}"
            check(torch.isfinite(out).all().item() and err <= tol, f"{tag_}: err {err} > {tol}")
            check(same, f"{tag_}: two calls differ")
            k_pad = out.shape[1]
            design = report(m, qt.codes.shape[1], k_pad, dtype=torch.float32)
            check(design["design"] == "wgmma_3xtf32", f"{tag_}: design {design}")
            n_bytes, ops = nbytes(g, qt.codes, qt.scale, out), 2 * m * k * n
            bound_us, bound_by = _bound_us(n_bytes, ops, "f32")
            x3_us, x3_by = _bound_us(n_bytes, 3 * ops, "tf32")
            row = dict(kernel=name, model=tag, fmt=fmt, dtype="float32", M=m, K=k, N=n,
                       K_pad=k_pad, max_abs_err=err, tol=tol, bit_identical_over_two_calls=same,
                       us=r["us"], plain_us=r["plain_us"], library_us=r["library_us"],
                       bound_us=bound_us, bound_by=bound_by, tf32x3_bound_us=x3_us,
                       tf32x3_bound_by=x3_by, read_against="tf32x3_bound_us", design=design)
            times[name][f"M{m}_{k}x{n}"] = {key: row[key] for key in (
                "us", "plain_us", "library_us", "bound_us", "tf32x3_bound_us")}
            emit(kernel_check=row)
    return times


def gpt2_kernel_checks(dev):
    """At GPT-2 small's four (K, N): matmul_4bit (nf4a) at the M of
    ``GPT2_MM4`` (bf16 and f32 x), matmul_8bit (f32 x) in ``GPT2_MM8``'s
    formats and M, and matmul_int8_fused at ``GPT2_I8_MS``, against their
    plain versions under phase 3's and 4's rules, every route the same bits
    on a second call, the design per row, µs per call (and the plain
    version's, and the bound) with the weights rotated past the L2; the f32
    routes of matmul_4bit_t and matmul_8bit_t checked and timed at M = 1024.
    Returns one GPT-2 decode step's calls (M = 8: matmul_4bit in bf16 and in
    f32, matmul_8bit in f32, int8) as {name: [kernel ms, plain ms, bound ms,
    bound by]} (the f32 ones then the library ms), the largest errors and
    the f32 backward times."""
    gen = torch.Generator(device=dev).manual_seed(4)
    work = {}
    step = {k: [0.0, 0.0] for k in ("matmul_4bit", "matmul_4bit_f32", "matmul_8bit_f32",
                                    "matmul_int8_fused")}
    max_err = {"matmul_4bit": 0.0, "matmul_8bit": 0.0, "matmul_int8_fused": 0.0}
    library = {"matmul_4bit_f32": 0.0, "matmul_8bit_f32": 0.0}
    slower = []
    for (k, n), count in GPT2_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        cases = [("matmul_4bit", "nf4a", dtype, ms) for dtype, ms in GPT2_MM4]
        cases += [("matmul_8bit", fmt, torch.float32, GPT2_MM8_MS) for fmt in GPT2_MM8]
        for kernel, fmt, dtype, ms in cases:
            qt = codecs.quantize_matmul_weight(w.to(dtype), fmt=fmt, block_size=64)
            k_pad = qt.codes.shape[0] * (2 if kernel == "matmul_4bit" else 1)
            report = matmul.matmul_4bit_design if kernel == "matmul_4bit" else \
                matmul.matmul_8bit_design
            for m in ms:
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                out, row = _quantized_check(f"gpt2 {kernel} {fmt} {dtype} M={m} K={k} N={n}",
                                            x, qt, dtype, 50 if m <= 64 else 10)
                max_err[kernel] = max(max_err[kernel], row["max_abs_err"])
                row = dict(kernel=kernel, model="gpt2", fmt=fmt, K_pad=k_pad, **row,
                           design=_checked_design(report, m, n, k_pad, dtype))
                key = kernel + ("_f32" if dtype == torch.float32 else "")
                if m == 8 and fmt in ("nf4a", "int8"):
                    step[key][0] += count * row["us"] / 1e3
                    step[key][1] += count * row["plain_us"] / 1e3
                    if dtype == torch.float32:
                        library[key] += count * row["library_us"] / 1e3
                    add_work(work, key, nbytes(x, qt.codes, qt.scale, out), 2 * m * k * n,
                             count)
                if dtype == torch.float32 and row["us"] >= row["plain_us"]:
                    slower.append(f"{kernel} {fmt} M={m} K={k} N={n}")
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
    for name, kind in (("matmul_4bit", "bf16"), ("matmul_4bit_f32", "f32"),
                       ("matmul_8bit_f32", "f32"), ("matmul_int8_fused", "int8")):
        step[name] += list(bound(work[name], kind))
    for name, ms in library.items():
        step[name].append(ms)
    emit(gpt2_decode_step_kernels={
        "note": "one GPT-2 small decode step's 48 calls at M=8 as [kernel ms, plain ms, bound ms, "
                "bound by] (the f32 rows then cuBLAS's f32 GEMM on the dequantized weights, ms): "
                "matmul_4bit nf4a bf16 x and f32 x, matmul_8bit int8 f32 x, llm_int8 f32 x",
        **step})
    emit(gpt2_f32_slower_than_plain=slower)
    t_f32 = _transposed_f32_rows(gen, dev, GPT2_SHAPES, GPT2_T_F32_M, "gpt2")
    return step, max_err, t_f32


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


def gpt2_f32_decode(dev, params, cfg):
    """GPT-2 small at its own f32 quantized to each of ``GPT2_F32_FMTS``:
    greedy decode through the f32 route of matmul_4bit or matmul_8bit (4
    launches a layer a token), prefill logits within ``F32_LOGITS_REL``
    rel-L2 of use_kernel=False. Returns the launches by kernel."""
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, GPT2_PROMPT), dtype=np.int32)).to(dev)
    total = {}
    for fmt, kernel in GPT2_F32_FMTS:
        qparams = qnn.quantize_params(params, mode=fmt)
        out, counts, wall = _decode_with_launches(gpt2, qparams, prompt, cfg, GPT2_NEW, kernel,
                                                  4 * cfg.n_layers, f"gpt2 {fmt} f32 decode")
        plain = gpt2.greedy_decode(qparams, prompt, cfg, max_new_tokens=GPT2_NEW,
                                   use_kernel=False)
        agree = (plain[:, GPT2_PROMPT:] == out[:, GPT2_PROMPT:]).float().mean().item()
        lk, _ = gpt2.forward(qparams, prompt, cfg)
        lp, _ = gpt2.forward(qparams, prompt, cfg, use_kernel=False)
        rel = rel_l2(lk, lp)
        emit(gpt2_decode=dict(fmt=fmt, dtype="float32", n_layers=cfg.n_layers, greedy_s=wall,
                              launches=counts, token_agreement_vs_plain=agree,
                              prefill_logits_rel_l2=rel, tol=F32_LOGITS_REL))
        check(torch.isfinite(lk).all().item() and rel <= F32_LOGITS_REL,
              f"gpt2 {fmt} f32: prefill logits rel-L2 {rel} > {F32_LOGITS_REL}")
        total[kernel] = total.get(kernel, 0) + counts[kernel]
        del qparams
    return total


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


def spec_sharded():
    """Phase 29: ``spmd_bench``'s two legs, each one spawn of ranks on the
    card over gloo (``parallel.spawn_local``); the checks run in the ranks
    and a failing rank fails the phase. Returns the launches of every
    rank's sharded runs (not those of the single-card references)."""
    torch.cuda.empty_cache()
    launches = dict.fromkeys(_build.launches, 0)
    fsdp_cfg = train_bench.model_config("llama2-7b")
    host_cfg = train_bench.model_config("llama2-13b")
    legs = (("fsdp", 2, dict(cfg=fsdp_cfg, **SPMD_FSDP)),
            ("host", 4, dict(cfg=host_cfg, **SPMD_HOST)))
    for leg, n, kwargs in legs:
        t0 = time.perf_counter()
        rows = spawn_local(spmd_bench.rank_leg, n, leg, kwargs, timeout=SPMD_TIMEOUT_S)
        for r in rows:
            runs = r["launches_per_step"] if leg == "fsdp" else r["launches"].values()
            for counts in runs:
                for k, v in counts.items():
                    launches[k] += v
        emit(spec_sharded={"leg": leg, "ranks": n, "seconds": time.perf_counter() - t0,
                           "rows": rows})
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


def gpt2_full_train(dev):
    """Phase 30: full-parameter training of GPT-2 small (``GPT2_TRAIN``)
    through ``train.make_train_step(forward=gpt2.forward)``, every one of
    its 148 f32 leaves stepped by ``Adam8bit``. (a) One backward's
    gradients, cloned, fed to the optimizer's kernel route (two launches of
    ``adam8bit_update``: 128 leaves a launch), to its plain version
    (``adam8bit_step_reference``) and to the optimizer's plain route
    (``Adam8bit(use_kernel=False)``, the JAX package's XLA route): the
    kernel and its plain version leave parameters and state bit for bit
    equal; the plain route leaves the state equal and the parameters
    within ``GPT2_REORDER_REL`` (it divides by bc1 in another order). (b)
    The main path: 5 steps through the kernels, the launch counts reset
    just before them and read just after, 2 ``adam8bit_update`` a step and
    nothing else; then 5 steps through the plain route from the same
    init: losses within rel 1e-4 (the embedding's backward sums with
    atomics, so no two backward passes are bitwise alike), the first near
    ln(vocab), the loss falling. (c) The step's ms (median of steps 2-5),
    a profiled step's device-busy share, the step's peak memory, and the
    optimizer's kernel ms a step against its bound. Returns the launches
    of (b) and #12's row at this work."""
    torch.cuda.empty_cache()
    cfg = gpt2.GPT2Config.small()
    t = GPT2_TRAIN
    lr = t["lr"]
    toks = np.random.default_rng(t["seed"]).integers(0, cfg.vocab_size,
                                                    size=(t["batch"], t["seq"] + 1))
    toks = torch.from_numpy(toks).to(dev)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    def model():
        params = gpt2.init_params(torch.Generator(device=dev).manual_seed(t["seed"]), cfg,
                                  device=dev)
        return params, train.dense_parameters(params)

    def loss_of(params):
        logits, _ = gpt2.forward(params, batch["inputs"], cfg)
        return train.causal_lm_loss(logits, batch["targets"])

    # (a) the optimizer's routes on one backward's gradients
    params, leaves = model()
    n_elems = sum(p.numel() for p in leaves)
    check(len(leaves) == GPT2_LEAVES and n_elems == GPT2_ELEMENTS,
          f"gpt2 small: {len(leaves)} leaves, {n_elems} elements")
    loss_of(params).backward()
    grads = [p.grad.clone() for p in leaves]
    init = [p.detach().clone() for p in leaves]
    opt = Adam8bit(leaves, lr=lr)
    _build.reset_launches()
    opt.step()
    torch.cuda.synchronize()
    check(_nonzero(_build.launches) == {"adam8bit_update": 2},
          f"gpt2 optimizer step: launches {_nonzero(_build.launches)}")
    ref = [p.clone() for p in init]
    ref_states = [Adam8bit._init_state(p) for p in ref]
    adam8bit.adam8bit_step_reference(ref, grads, ref_states,
                                     Adam8bit._scalars(lr, 0.9, 0.999, 1, dev), lr=lr)
    pairs = list(zip((p.detach() for p in leaves), ref)) + [
        (opt.state[p][k], st[k]) for p, st in zip(leaves, ref_states)
        for k in adam8bit.STATE_KEYS]
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    check(all(torch.equal(a, b) for a, b in pairs),
          f"gpt2 optimizer step: kernel and plain version differ by {err}")
    xla = [p.clone().requires_grad_() for p in init]
    for p, g in zip(xla, grads):
        p.grad = g
    opt_xla = Adam8bit(xla, lr=lr, use_kernel=False)
    opt_xla.step()
    state_equal = all(torch.equal(opt.state[p][k], opt_xla.state[q][k])
                      for p, q in zip(leaves, xla) for k in adam8bit.STATE_KEYS)
    diffs = [((a.detach() - b.detach()).abs(), b.detach().abs()) for a, b in zip(xla, leaves)]
    xla_abs = max(d.max().item() for d, _ in diffs)
    xla_err = max((d / (GPT2_REORDER_REL * (b + lr))).max().item() for d, b in diffs)
    del diffs
    check(state_equal and xla_err <= 1.0,
          f"gpt2 optimizer step: the plain route's state equal {state_equal}, parameters "
          f"{xla_abs} apart ({xla_err} of the limit)")
    emit(kernel_check=dict(kernel="adam8bit_update", step="gpt2_small_full", leaves=len(leaves),
                           elements=n_elems, max_abs_err=err, tol=0.0,
                           plain_route_state_equal=state_equal, plain_route_max_abs=xla_abs,
                           plain_route_rel=GPT2_REORDER_REL))

    # #12 at this work: the step's 148 leaves, the gradients of (a)
    table = adam8bit.LeafTable(leaves, [opt.state[p] for p in leaves])
    scalars = Adam8bit._scalars(lr, 0.9, 0.999, 2, dev)
    adam_ms = time_ms(lambda i: table.step(grads, scalars, lr=lr), 20)
    adam_plain_ms = time_ms(lambda i: adam8bit.adam8bit_step_reference(
        ref, grads, ref_states, scalars, lr=lr), 3)
    state_bytes = nbytes(*(opt.state[p][k] for p in leaves for k in adam8bit.STATE_KEYS))
    adam_work = [nbytes(*grads) + 2 * nbytes(*leaves) + 2 * state_bytes, 20 * n_elems]
    adam_bound = bound(adam_work, "f32")
    del opt, opt_xla, xla, ref, ref_states, grads, init, table, params, leaves
    torch.cuda.empty_cache()

    # (b) the main path through the kernels, then the plain route
    runs = {}
    for route in (None, False):
        params, leaves = model()
        opt = Adam8bit(leaves, lr=lr, use_kernel=route)
        step = train.make_train_step(cfg, opt, forward=gpt2.forward)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        _build.reset_launches()
        losses, ms = [], []
        for _ in range(t["steps"]):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            loss = step(params, batch)
            end.record()
            end.synchronize()
            losses.append(loss.item())
            ms.append(start.elapsed_time(end))
        counts = _nonzero(_build.launches)
        runs[route] = dict(losses=losses, step_ms_all=ms, launches=counts,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           resident_gib=base_gib)
        if route is None:
            runs[route]["profile"] = train_bench.profile_step(step, params, batch)
        del params, leaves, opt, step
        torch.cuda.empty_cache()
    kern, plain = runs[None], runs[False]
    check(kern["launches"] == {"adam8bit_update": 2 * t["steps"]},
          f"gpt2 full training: launches {kern['launches']}")
    check(plain["launches"] == {}, f"gpt2 plain route launched {plain['launches']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(kern["losses"], plain["losses"])]
    check(max(rel) <= 1e-4, f"gpt2 full training: loss curves {rel} apart")
    check(abs(kern["losses"][0] - math.log(cfg.vocab_size)) < 0.5
          and kern["losses"][-1] < kern["losses"][0] and plain["losses"][-1] < plain["losses"][0],
          f"gpt2 full training: losses {kern['losses']} / {plain['losses']}")
    prof = kern.pop("profile")
    step_ms = statistics.median(kern["step_ms_all"][1:])
    row = {"model": "gpt2-small", "n_layers": cfg.n_layers, "dim": cfg.dim,
           "vocab": cfg.vocab_size, "dtype": "float32",
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "batch": t["batch"], "seq": t["seq"], "lr": lr, "leaves": GPT2_LEAVES,
           "elements": n_elems, "step_ms": step_ms,
           "tok_s": t["batch"] * t["seq"] / (step_ms / 1e3),
           "device_busy_share": prof["device_busy_share"], "device_busy_ms": prof["device_busy_ms"],
           "step_ms_profiled": prof["step_ms_profiled"], "top_device_ms": prof["top_device_ms"],
           "loss_rel_diff": rel, "kernel": kern, "plain": plain,
           "adam8bit_update": {"ms": adam_ms, "plain_ms": adam_plain_ms,
                               "bound_ms": adam_bound[0], "bound_by": adam_bound[1],
                               "launches_per_step": 2}}
    emit(gpt2_full_train=row)
    return kern["launches"], row["adam8bit_update"]


def qlora_f32(dev):
    """Phase 32: QLoRA on an f32 TinyLlama-1.1B base at full width and depth
    (random weights from seed 0), quantized to nf4 and to int8: phase 9's
    path (3 steps through the kernels, 3 plain, 1 reordered) with f32
    rank-8 adapters under the f32 limits of ``F32_QLORA_REL``, 155
    forward-kernel, 152 transposed-kernel and 1 ``adam8bit_update`` launches
    a step, then ``train_bench``'s row on each base; the forward kernels'
    f32 route (matmul_4bit on the nf4 tree, matmul_8bit on the int8 tree)
    at each of the forward's five (K, N), M = 2048, on the trees' own
    leaves, as phase 18 holds it at the proxy's; then the f32 transposed
    kernels at TinyLlama's five (K, N), M = 2048. The CLI's adapters are
    bf16 (``train.add_lora``'s default); in f32 every difference between
    the routes is an f32 reordering, the one the 1e-4 limits hold (a bf16
    adapter would round the routes' gradients apart). Returns the kernel
    routes' launches, the forward rows' times as {kernel: {"M{m}_{k}x{n}":
    [kernel µs, plain µs, bound µs, library µs]}} and the transposed rows'
    as ``_transposed_f32_rows`` gives them."""
    cfg = dataclasses.replace(llama.LlamaConfig.tinyllama_1b(), dtype=torch.float32)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    trees = {fmt: qnn.quantize_params(dense, mode=fmt) for fmt, _ in F32_QLORA}
    del dense
    launches = {}
    for fmt, kernels in F32_QLORA:
        got = qlora_path(dev, cfg, trees[fmt], fmt=f"{fmt} f32-base", kernels=kernels)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        row = train_bench.bench_qlora(trees[fmt], cfg)
        check(math.isfinite(row["loss_step1"]), f"train row {fmt} f32: loss {row['loss_step1']}")
        # the forward kernels' (mmf_*) and the dx kernel's share of the
        # profiled step's device time, as far as they stand among its top ops
        top, busy = row["top_device_ms"], row["device_busy_ms"]
        shares = {k: sum(ms for name, ms in top.items() if key in name) / busy if busy else None
                  for k, key in (("fma_forward", "mmf_"), ("tf32x3_dx", "mmt_tf32x3"))}
        emit(train_row={"name": f"tinyllama {fmt} f32-base", "fmt": fmt, "dtype": "float32",
                        "kernel_share_of_device_ms": shares, **row})
    gen = torch.Generator(device=dev).manual_seed(32)
    forward = {}
    for fmt, (kernel, _) in F32_QLORA:
        forward[kernel] = {}
        report = matmul.matmul_4bit_design if kernel == "matmul_4bit" else \
            matmul.matmul_8bit_design
        for (k, n), qt in _first_leaves(trees[fmt], SHAPES).items():
            x = torch.randn((M_TRAIN, k), generator=gen, device=dev)
            _, row = _quantized_check(f"tinyllama {kernel} {fmt} f32 M={M_TRAIN} K={k} N={n}", x,
                                      qt, torch.float32, 10)
            k_pad = qt.codes.shape[0] * (2 if kernel == "matmul_4bit" else 1)
            emit(kernel_check=dict(kernel=kernel, model="tinyllama", fmt=fmt, K_pad=k_pad, **row,
                                   design=_checked_design(report, M_TRAIN, n, k_pad,
                                                          torch.float32)))
            forward[kernel][f"M{M_TRAIN}_{k}x{n}"] = [row["us"], row["plain_us"], row["bound_us"],
                                                      row["library_us"]]
    del trees
    torch.cuda.empty_cache()
    return launches, forward, _transposed_f32_rows(gen, dev, T_SHAPES, M_TRAIN, "tinyllama")


def qlora_f32_flash(dev):
    """Phase 33: phase 32's f32 TinyLlama-1.1B base (full width and depth,
    random weights from seed 0) in nf4 at batch 2 x seq 1024, through the
    flash kernels, as the JAX package's ``finetune --toy tinyllama --dtype
    float32 --seq-len 1024`` runs on its chip: phase 9's 3 + 3 + 1 steps
    under the f32 limits of ``F32_QLORA_REL`` (the plain route's attention
    is the plain flash), the loss falling, per kernel-route step 155
    ``matmul_4bit``, 152 ``matmul_4bit_t``, 22 each of ``flash_fwd``,
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` (all f32 routes) and one
    ``adam8bit_update``; then ``train_bench.bench_qlora``'s row (step ms,
    busy share, step-peak GiB) with the share of the profiled step's device
    time of #1's f32 forward, #4's f32 dx and each flash kernel. Returns the
    kernel route's launches."""
    cfg = dataclasses.replace(llama.LlamaConfig.tinyllama_1b(), dtype=torch.float32)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tree = qnn.quantize_params(dense, mode="nf4")
    del dense
    launches = qlora_path(dev, cfg, tree, fmt="nf4 f32-base s1024 flash", batch=LONG_BATCH,
                          seq=LONG_SEQ, use_flash=True)
    row = train_bench.bench_qlora(tree, cfg, batch=LONG_BATCH, seq=LONG_SEQ)
    check(math.isfinite(row["loss_step1"]), f"train row nf4 f32 s1024: {row['loss_step1']}")
    row = {"name": "tinyllama nf4 f32-base s1024 flash", "fmt": "nf4", "dtype": "float32",
           "kernel_share_of_device_ms": f32_kernel_shares(row), **row}
    emit(train_row=row)
    del tree
    torch.cuda.empty_cache()
    return launches


def f32_kernel_shares(row):
    """The share of a ``train_bench`` row's profiled step's device time of
    each kernel of an f32 QLoRA step through flash, as far as it stands
    among the step's top ops (``F32_SHARE_KEYS``: the f32 routes' kernel
    names)."""
    top, busy = row["top_device_ms"], row["device_busy_ms"]
    return {k: sum(ms for name, ms in top.items() if key in name) / busy if busy else None
            for k, key in F32_SHARE_KEYS.items()}


def openllama_3b(dev):
    """Phase 34: OpenLLaMA-3B v2 (``OPENLLAMA_3B``, head dim 100) at full
    width and depth, random weights from seed 0, through the entry points a
    user calls (:func:`full_width_model`; #1 and #4 at its four (K, N),
    where K pads to 4096 and 9216 and N to 8704, and N 3200 runs 25 tiles of
    128)."""
    cfg = llama.LlamaConfig(**OPENLLAMA_3B)
    check(cfg.head_dim == 100 and attention.padded_head_dim(cfg.head_dim) == 128
          and attention.kernel_takes(cfg.head_dim, cfg.dtype), f"openllama-3b: {cfg}")
    return full_width_model(dev, cfg, "openllama-3b", OL_SHAPES, seed=34)


def gemma_2b_geometry(dev):
    """Phase 35: Gemma-2B's geometry (``GEMMA_2B``: hd 256, 8 query heads to
    one KV head, tied embeddings) in the repo's Llama block at full width
    and all 18 layers, random weights from seed 0 (:func:`full_width_model`;
    its prefill, decode and QLoRA run the 256-column flash kernels). First
    the int8 KV write at its hd 256 with one KV head (``KV_WRITES_HD256``:
    ``quantize.cu``'s grouped layout at hd = 8 << 5) against quantize_kv
    plus index_put, equal outside page 0, µs a call."""
    cfg = llama.LlamaConfig(**GEMMA_2B)
    check(cfg.head_dim == 256 and attention.padded_head_dim(cfg.head_dim) == 256
          and attention.kernel_takes(cfg.head_dim, cfg.dtype), f"gemma-2b geometry: {cfg}")
    gen = torch.Generator(device=dev).manual_seed(37)
    kv_rows = {}
    for name, shape in KV_WRITES_HD256.items():
        n_rows = math.prod(shape[1:-2])
        k, v = ((torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)
                .reshape(cfg.n_layers, n_rows, *shape[-2:]) for _ in range(2))
        k[:, 3] = 0.0
        rows = _kv_rows(gen, dev, n_rows)
        pools = {uk: kvcache.init_pool(cfg, KV_PAGES, 16, kv_quant=True, device=dev)
                 for uk in (True, False)}
        _build.reset_launches()
        for uk, pool in pools.items():
            kvcache.write_rows(pool, rows, k, v, use_kernel=uk)
        torch.cuda.synchronize()
        check(_build.launches["quantize_blockwise"] == 1, f"kv write {name}: one launch")
        check(all(torch.equal(pools[True][t][:, 1:], pools[False][t][:, 1:])
                  for t in pools[True]),
              f"kv write {name}: the pool outside page 0 differs from quantize_kv + index_put")
        us = time_ms(lambda i: kvcache.write_rows(pools[True], rows, k, v), 50) * 1e3
        kv_rows[name] = dict(kernel="quantize_blockwise", write="kv_int8_pool", kv=name,
                             shape=list(k.shape), max_abs_err=0.0, tol=0.0, us=us)
        emit(kernel_check=kv_rows[name])
    launches, rows = full_width_model(dev, cfg, "gemma-2b-geometry", GM_SHAPES, seed=36)
    rows["kv_write"] = kv_rows
    got, rows["train_f32"] = gemma_2b_f32_qlora(dev)
    for name, c in got.items():
        launches[name] = launches.get(name, 0) + c
    return launches, rows


def gemma_2b_f32_qlora(dev):
    """Phase 35 (e): QLoRA on an f32 base of Gemma-2B's geometry
    (``GEMMA_2B`` in f32, all 18 layers, random weights from seed 0,
    quantized to nf4) at b2 x s1024 through the flash kernels, phase 33's
    protocol: phase 9's 3 + 3 + 1 steps under the f32 limits of
    ``F32_QLORA_REL``, the loss falling, per kernel-route step 126
    ``matmul_4bit``, 123 ``matmul_4bit_t``, 18 each of ``flash_fwd``,
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` (their f32 routes at 256
    columns) and one ``adam8bit_update``; then ``train_bench.bench_qlora``'s
    row (step ms, busy share, step-peak GiB) with the kernels' shares of the
    profiled step's device time under phase 33's names. Returns the kernel
    route's launches and the row."""
    cfg = dataclasses.replace(llama.LlamaConfig(**GEMMA_2B), dtype=torch.float32)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    tree = qnn.quantize_params(dense, mode="nf4")
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = qlora_path(dev, cfg, tree, fmt="nf4 gemma-2b-geometry f32-base s1024 flash",
                          batch=OL_BATCH, seq=OL_SEQ, use_flash=True)
    row = train_bench.bench_qlora(tree, cfg, batch=OL_BATCH, seq=OL_SEQ)
    check(math.isfinite(row["loss_step1"]), f"train row gemma-2b f32: {row['loss_step1']}")
    row = {"name": "gemma-2b-geometry nf4 f32-base s1024 flash", "fmt": "nf4",
           "dtype": "float32", "kernel_share_of_device_ms": f32_kernel_shares(row), **row}
    emit(train_row=row)
    del tree
    torch.cuda.empty_cache()
    return launches, row


def full_width_model(dev, cfg, label, shapes, seed):
    """A model configuration at full width and depth, random weights from
    seed 0, through the entry points a user calls. First #1 (nf4a; M 8 and
    2048) and #4 (nf4; M 2048) against their plain versions at its
    quantized linears' (K, N) ``shapes``. Then, nf4a: (a) a b1 x
    S 2048 prefill with ``use_flash=None``, ``n_layers`` ``flash_fwd``
    launches, its logits against the einsum route by phase 12's rule, the
    prefill timed; (b) greedy decode of ``OL_NEW`` tokens after a prompt of
    2048 - ``OL_NEW`` (ending at the model's 2048 positions): one prefill
    through flash and ``OL_NEW`` forwards' ``matmul_4bit``, decode tok/s
    from the decode's time less its prefill's; (c) the Engine with the
    int8 KV pool over ``OL_SERVE``'s requests, all submitted at once, every
    request finishing, one ``quantize_blockwise`` (the KV write at hd 100)
    a prefill and a window, tok/s and TTFT. Then nf4: (d) phase 9's QLoRA
    path at b2 x s1024 with ``use_flash=None`` (flash by the kernels' rule),
    ``n_layers`` of each flash kernel a step, phase 9's rules; and
    ``train_bench``'s row (step ms, busy share, step-peak GiB). ``label``
    names it in messages and its lines (``label``, dashes as underscores,
    then ``_prefill``, ``_decode``, ``_serve``); ``seed`` and ``seed`` + 1
    draw its inputs. Returns the launches and the timed rows."""
    tag = label.replace("-", "_")
    per_forward = 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    t0 = time.perf_counter()
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    trees = {fmt: qnn.quantize_params(dense, mode=fmt) for fmt in ("nf4a", "nf4")}
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows = {"setup_s": time.perf_counter() - t0}
    launches = dict.fromkeys(_build.launches, 0)

    gen = torch.Generator(device=dev).manual_seed(seed)
    for (k, n), qt in _first_leaves(trees["nf4a"], shapes).items():
        k_pad = 2 * qt.codes.shape[0]
        for m in (8, OL_BATCH * OL_SEQ):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            _, row = _quantized_check(f"{label} matmul_4bit M={m} K={k} N={n}", x, qt,
                                      torch.bfloat16, 10)
            emit(kernel_check=dict(kernel="matmul_4bit", model=label, fmt="nf4a",
                                   K_pad=k_pad, N_pad=qt.codes.shape[1], **row,
                                   design=_checked_design(matmul.matmul_4bit_design, m,
                                                          qt.codes.shape[1], k_pad,
                                                          torch.bfloat16)))
    for (k, n), qt in _first_leaves(trees["nf4"], shapes).items():
        g = torch.randn((OL_BATCH * OL_SEQ, qt.codes.shape[1]), generator=gen,
                        device=dev).to(torch.bfloat16)
        out = matmul.matmul_4bit_t(g, qt.codes, qt.scale, codebook=qt.codebook)
        ref = matmul.matmul_4bit_t(g, qt.codes, qt.scale, codebook=qt.codebook, use_kernel=False)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2 * BF16_ULP * ref.float().abs().max().item()
        check(out.shape == ref.shape and err <= tol,
              f"{label} matmul_4bit_t K={k} N={n}: err {err} > {tol}")
        emit(kernel_check=dict(kernel="matmul_4bit_t", model=label, fmt="nf4", K=k, N=n,
                               K_pad=2 * qt.codes.shape[0], N_pad=qt.codes.shape[1],
                               M=g.shape[0], max_abs_err=err, tol=tol,
                               design=matmul.matmul_4bit_t_design(g.shape[0], qt.codes.shape[1],
                                                                  2 * qt.codes.shape[0])))

    # (a) the prefill: use_flash=None takes flash at the config's head dim;
    # against the einsum route, the floor the f32 attention sets
    params = trees["nf4a"]
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, OL_PREFILL), dtype=np.int32)).to(dev)
    logits, flash_n = {}, {}
    with torch.no_grad():
        for route in ("flash", "einsum", "f32_attention"):
            cache = llama.init_cache(cfg, 1, max_len=OL_PREFILL, device=dev)
            torch.cuda.synchronize()
            _build.reset_launches()
            with mock.patch.object(llama, "_attention", f32_attention
                                   if route == "f32_attention" else EINSUM_ATTENTION):
                logits[route], _ = llama.forward(params, prompt, cfg, cache=cache,
                                                 use_flash=None if route == "flash" else False)
            torch.cuda.synchronize()
            flash_n[route] = _build.launches["flash_fwd"]
            if route == "flash":
                for name, c in _build.launches.items():
                    launches[name] += c
        check(flash_n == {"flash": cfg.n_layers, "einsum": 0, "f32_attention": 0},
              f"{label} prefill flash launches {flash_n}")
        check(torch.isfinite(logits["flash"]).all().item(), f"{label}: non-finite logits")
        rel = rel_l2(logits["flash"], logits["einsum"])
        floor = rel_l2(logits["f32_attention"], logits["einsum"])
        tol = max(1e-2, GRAD_FLOOR_X * floor + GRAD_FLOOR_ABS)
        check(rel <= tol, f"{label} prefill logits flash vs einsum rel-L2 {rel} > {tol}")
        agree = (logits["flash"].argmax(-1) == logits["einsum"].argmax(-1)).float().mean().item()
        del logits
        prefill_s = []
        for _ in range(3):
            cache = llama.init_cache(cfg, 1, max_len=OL_PREFILL, device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            llama.forward(params, prompt, cfg, cache=cache)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
        del cache
    rows["prefill"] = dict(batch=1, seq=OL_PREFILL, rel_l2_flash_vs_einsum=rel, tol=tol,
                           f32_attention_rel_l2_vs_einsum=floor, argmax_agreement=agree,
                           flash_launches=flash_n["flash"], seconds=prefill_s,
                           tok_s=OL_PREFILL / statistics.median(prefill_s))
    emit(**{f"{tag}_prefill": rows["prefill"]})

    # (b) greedy decode after a prompt of OL_PREFILL - OL_NEW tokens
    short = prompt[:, :OL_PREFILL - OL_NEW]
    walls = {}
    for new in (1, OL_NEW):  # the prefill alone, then with the decode steps
        llama.greedy_decode(params, short, cfg, max_new_tokens=new)  # warm
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = llama.greedy_decode(params, short, cfg, max_new_tokens=new)
        torch.cuda.synchronize()
        walls[new] = time.perf_counter() - t
        counts = dict(_build.launches)
    expected = dict.fromkeys(counts, 0)
    expected.update(flash_fwd=cfg.n_layers, matmul_4bit=OL_NEW * per_forward)
    check(counts == expected, f"{label} decode: launches {counts}, expected {expected}")
    check(out.shape == (1, OL_PREFILL) and torch.equal(out[:, :OL_PREFILL - OL_NEW], short)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{label} decode: output")
    for name, c in counts.items():
        launches[name] += c
    rows["decode"] = dict(batch=1, prompt=OL_PREFILL - OL_NEW, new_tokens=OL_NEW,
                          wall_s=walls[OL_NEW], prefill_s=walls[1],
                          decode_tok_s=(OL_NEW - 1) / (walls[OL_NEW] - walls[1]),
                          launches=counts)
    emit(**{f"{tag}_decode": rows["decode"]})

    # (c) the Engine, int8 KV pool at the config's head dim
    sv = OL_SERVE
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(sv["min_prompt"],
                                                               sv["max_prompt"] + 1)),
                            dtype=np.int32) for _ in range(sv["n_requests"])]
    eng = Engine(params, cfg, n_slots=sv["n_slots"], page_size=16, prefill_buckets=sv["buckets"],
                 kv_quant=True, multi_step=sv["multi_step"])
    eng.warm_widths((sv["max_prompt"] + sv["max_new"] + sv["multi_step"]) // 16 + 1,
                    max_prompt_len=sv["max_prompt"])
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    done = eng.run([Request(uid=i, prompt=pr, max_new_tokens=sv["max_new"])
                    for i, pr in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _nonzero(_build.launches)
    m = eng.metrics()
    check(len(done) == sv["n_requests"] and all(len(r.output) == sv["max_new"] for r in done)
          and all(0 <= tok < cfg.vocab_size for r in done for tok in r.output),
          f"{label} serve: every request must finish in range")
    check(set(counts) == {"matmul_4bit", "quantize_blockwise"}
          and counts["quantize_blockwise"] == m["admissions"] + m["decode_steps"],
          f"{label} serve: launches {counts}, admissions {m['admissions']}, windows "
          f"{m['decode_steps']}")
    for name, c in counts.items():
        launches[name] += c
    rows["serve"] = dict(n_layers=cfg.n_layers, prompt_lens=[len(pr) for pr in prompts],
                         max_new=sv["max_new"], n_slots=sv["n_slots"],
                         multi_step=sv["multi_step"], seconds=wall,
                         launches=counts, **{k: m[k] for k in (
                             "throughput_tok_s", "admissions", "decode_steps", "preemptions",
                             "ttft_p50_ms", "ttft_p99_ms")},
                         kv_pool_mib=kvcache.pool_bytes(eng.pool) / 2**20)
    emit(**{f"{tag}_serve": rows["serve"]})
    del eng, params, trees["nf4a"]
    torch.cuda.empty_cache()

    # (d) QLoRA through flash by the kernels' rule, then the timed row
    got = qlora_path(dev, cfg, trees["nf4"], fmt=f"nf4 {label} s1024", batch=OL_BATCH,
                     seq=OL_SEQ, use_flash=None)
    for name, c in got.items():
        launches[name] = launches.get(name, 0) + c
    row = train_bench.bench_qlora(trees["nf4"], cfg, batch=OL_BATCH, seq=OL_SEQ)
    check(math.isfinite(row["loss_step1"]), f"train row {label}: {row['loss_step1']}")
    top, busy = row["top_device_ms"], row["device_busy_ms"]
    keys = {"matmul_4bit": "mm4_", "matmul_4bit_t": "mm4t", "flash_fwd": "flash_fwd",
            "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv"}
    shares = {k: sum(ms for name, ms in top.items() if key in name) / busy if busy else None
              for k, key in keys.items()}
    rows["train"] = {"name": f"{label} nf4 s1024", "fmt": "nf4",
                     "kernel_share_of_device_ms": shares, **row}
    emit(train_row=rows["train"])
    del trees
    torch.cuda.empty_cache()
    return launches, rows


def engine_gap(dev):
    """Phase 31: ``benchmarks.engine_gap_bench`` (nf4a, 8 slots, k 8) at
    TinyLlama-1.1B's width and ``GAP_DEPTH`` layers, beside
    ``serve_bench.window_profile``'s window at the same depth (the
    Engine's own window; the Engine's bookkeeping is what it takes beyond
    the host loop at depth 2). Every term finite and above 0, the
    synchronous host window at least the device's, the link's round trip
    below it; only ``matmul_4bit`` launched. Returns its launches."""
    cfg = dataclasses.replace(llama.LlamaConfig.tinyllama_1b(), n_layers=GAP_DEPTH)
    dense = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    params = qnn.quantize_params(dense, mode="nf4a", block_size=64)
    del dense
    torch.cuda.synchronize()
    _build.reset_launches()
    r = engine_gap_bench.run(params, cfg, fmt="nf4a")
    torch.cuda.synchronize()
    counts = _nonzero(_build.launches)
    check(set(counts) == {"matmul_4bit"}, f"engine gap: launches {counts}")
    terms = {k: v for k, v in r.items() if k.endswith("_ms") and not k.endswith("cost_ms")}
    check(all(math.isfinite(v) and v > 0 for v in terms.values()),
          f"engine gap: a term is not finite and positive: {terms}")
    check(r["paged_window_host_d0_ms"] >= r["paged_window_dev_w16_ms"],
          f"engine gap: the host window is shorter than the device's: {r}")
    check(r["link_rtt_ms"] < r["paged_window_host_d0_ms"],
          f"engine gap: the link's round trip exceeds a window: {r}")
    prof = serve_bench.window_profile(params, cfg, multi_step=r["k"], n_slots=r["n_slots"])
    emit(engine_gap={"n_layers": cfg.n_layers, **r, "engine_window_ms": prof["window_ms"],
                     "engine_device_busy_ms": prof["device_busy_ms"],
                     "engine_bookkeeping_ms": prof["window_ms"] - r["paged_window_host_d2_ms"],
                     "launches": counts})
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
        q_ms, q_op_us, q_hd100, max_err["quantize_blockwise"] = quantize_checks(dev, work)

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
        flash_rows, flash_f32, flash_err = flash_checks(dev, work)
        flash_ms = flash_rows["tinyllama_s1024"]
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
        acc_f32 = accuracy_phase(dev)

    with timed("19 gpt2 kernel checks"):
        gpt2_step, gpt2_err, gpt2_t_f32 = gpt2_kernel_checks(dev)
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
        for k, v in gpt2_f32_decode(dev, gparams, gcfg).items():
            launches[k] += v
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
    with timed("29 spec-sharded paths"):
        for k, v in spec_sharded().items():
            (train_launches if k in ("matmul_4bit_t", "adam8bit_update") else launches)[k] += v
    with timed("30 gpt2 full training"):
        gpt2_counts, gpt2_adam = gpt2_full_train(dev)
        train_launches["adam8bit_update"] += gpt2_counts["adam8bit_update"]
    with timed("31 engine gap"):
        for k, v in engine_gap(dev).items():
            launches[k] += v
    with timed("32 qlora f32 base"):
        q32, tl_f32_fwd, tl_f32 = qlora_f32(dev)
        for k, v in q32.items():
            (train_launches if k in ("matmul_4bit_t", "adam8bit_update") else launches)[k] += v
    with timed("33 qlora f32 base s1024 flash"):
        for k, v in qlora_f32_flash(dev).items():
            (train_launches if k in ("matmul_4bit_t", "adam8bit_update") else launches)[k] += v
    with timed("34 openllama-3b hd 100"):
        ol_launches, ol_rows = openllama_3b(dev)
        for k, v in ol_launches.items():
            (train_launches if k in ("matmul_4bit_t", "adam8bit_update") else launches)[k] += v
        emit(openllama_3b={k: v for k, v in ol_rows.items() if k != "train"})
    with timed("35 gemma-2b geometry hd 256"):
        gm_launches, gm_rows = gemma_2b_geometry(dev)
        for k, v in gm_launches.items():
            (train_launches if k in ("matmul_4bit_t", "adam8bit_update") else launches)[k] += v
        emit(gemma_2b_geometry={k: v for k, v in gm_rows.items()
                                if k not in ("train", "train_f32")})
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
    f32_at = ("gpt2_f32_step_ms: one GPT-2 small decode step's 48 calls at M=8 on f32 x through "
              "the f32 route as [kernel, plain, bound, bound by, library: cuBLAS's f32 GEMM on "
              "the dequantized weights]; f32_accuracy_proxy_us: the f32 route at the accuracy "
              "proxy's (K, N), M=8192, as [kernel, plain, bound, library] µs a call; "
              "f32_tinyllama_us: the same at TinyLlama-1.1B's five (K, N), M=2048, on the f32 "
              "QLoRA base's own leaves (nf4 for matmul_4bit)")
    f32_t_at = ("f32_us: the f32 route, the 3xTF32 wgmma design, µs a call at GPT-2's (K, N), "
                "M=1024, the accuracy proxy's, M=8192, and TinyLlama-1.1B's, M=2048, with its "
                "plain version, cuBLAS's f32 GEMM on the dequantized weight (library), the f32 "
                "bound and the bound of its three TF32 products, which it is read against")
    i8_prefill = ("one prefill forward's 155 calls at M=1024 as [kernel, plain, dense], dense: "
                  "torch._int_mm of the int8 activations and the codes, which takes M > 16 only)")
    flash_at = ("one call at TinyLlama-1.1B's QLoRA shape (B=2, S=T=1024, 32 heads, 4 KV "
                "heads, hd 64, bf16), ms; library: ")
    sdpa = "SDPA (is_causal, enable_gqa) "
    bwd_pair_ms = flash_ms["flash_bwd_dq_ms"] + flash_ms["flash_bwd_dkv_ms"]
    f32_flash_at = ("; f32: the f32 route at the S = T shapes (TinyLlama-1.1B's, Llama-2-7B's, "
                    "OpenLLaMA-3B's, Gemma-2B's geometry's), "
                    "ms a call with its plain version, its f32 bound (CUDA cores), the bound "
                    "of three TF32 products for each f32 one (tf32x3_bound_ms) and SDPA's f32 "
                    "time (library_ms; the backend it takes named, and where that is math, the "
                    "efficient backend on K and V expanded to the query heads)")

    def f32_flash(name, library_key):
        return {shape: {"ms": row[f"{name}_ms"], "plain_ms": row[f"{name}_plain_ms"],
                        "bound_ms": row[f"{name}_bound_ms"], "bound_by": row[f"{name}_bound_by"],
                        "tf32x3_bound_ms": row[f"{name}_tf32x3_bound_ms"],
                        "library_ms": row[library_key] if library_key else None,
                        "sdpa_backend": row["sdpa_backend"],
                        **{k: v for k, v in row.items() if k.startswith("sdpa_efficient")},
                        **{k.removeprefix(name + "_"): v for k, v in row.items()
                           if k.startswith(name + "_") and k.endswith("_padded")}}
                for shape, row in flash_f32.items()}
    hd100_at = ("hd100: the same at OpenLLaMA-3B's QLoRA shape (B=2, S=T=1024, 32 heads, MHA, "
                "hd 100, run in 128 columns), bf16, ms, with the bound of the real hd and of the "
                "128 columns (bound_ms_padded) and the kernel's registers and spill bytes a thread; its "
                "f32 row under f32")
    hd256_at = ("hd256: the same at Gemma-2B's geometry's QLoRA shape (B=2, S=T=1024, 8 "
                "heads, 1 KV head, hd 256, the 256-column kernels; flash_fwd and flash_bwd_dkv "
                "warp-specialised, design wgmma_ws), bf16, ms, with the kernel's design, "
                "registers, spill bytes a thread and threads a block; its f32 row under f32")

    def flash_row_at(shape, name, library_key):
        row = flash_rows[shape]
        b, sq, t, nh, nkv, hd = FLASH_SHAPES[shape][:6]
        design = (attention.flash_fwd_design(b, sq, nh, hd) if name == "flash_fwd"
                  else attention.flash_bwd_design(name, b, sq, t, nh, nkv, hd))
        return {"ms": row[f"{name}_ms"], "plain_ms": row[f"{name}_plain_ms"],
                "bound_ms": row[f"{name}_bound_ms"], "bound_by": row[f"{name}_bound_by"],
                **({"bound_ms_padded": row[f"{name}_bound_ms_padded"]}
                   if f"{name}_bound_ms_padded" in row else {}),
                "library_ms": row[library_key] if library_key else None,
                "sdpa_backend": row["sdpa_backend"],
                **{k: design[k] for k in ("design", "registers", "spill_bytes", "threads")}}
    measured = {name: flash_ms[f"{name}_ms"] for name in FLASH_KERNELS}
    measured["matmul_8bit"] = eight_step[("matmul_8bit", 8)][0]
    measured["matmul_4bit"] = per_step["matmul_4bit"][0]
    measured["matmul_8bit_t"] = eight_step[("matmul_8bit_t", M_TRAIN)][0]
    measured["matmul_4bit_t"] = t_step[0]
    measured["matmul_int4c"] = per_step["matmul_int4c"][0]
    for name in ("matmul_int8_fused", "matmul_int8"):
        measured[name] = per_step[name][0]
    measured["adam8bit_update"] = adam_step[0]
    for name in ("flash_fwd", "flash_bwd_dkv"):
        measured[f"{name}_hd256"] = flash_rows["gemma_2b_s1024"][f"{name}_ms"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        measured[f"{name}_f32_hd256"] = flash_f32["gemma_2b_s1024"][f"{name}_ms"]
    emit(earlier_times=dict(
        note="PERF.md's times of the designs before the Hopper redesigns, at the same work, "
             "not measured in this run", **{f"{name}_ms": ms for name, ms in EARLIER_MS.items()},
        per_call_us=EARLIER_US, f32_ms=EARLIER_F32_MS, measured_ms=measured,
        measured_per_call_us={**mm4_per_call, **eight_per_call, **int8_per_call,
                              "matmul_4bit_t": t_per_call,
                              "quantize_blockwise": {"window_8x8": q_op_us}},
        measured_f32_ms={name: {shape: row[f"{name}_ms"] for shape, row in flash_f32.items()}
                         for name in EARLIER_F32_MS}))
    emit(kernels=[
        entry("matmul_4bit", "matmul_4bit.cu", "quanta_tpu/ops/matmul.py:204",
              launches["matmul_4bit"], *per_step["matmul_4bit"][:2], "bf16",
              at + "; library: none, no PyTorch call dequantizes blockwise 4-bit codes inside "
              "a GEMM (dense_control_ms: cuBLAS torch.matmul of the dequantized bf16 weights; "
              "qlora_forward_ms: one QLoRA forward's 155 calls at M=2048, nf4, as [kernel, "
              "plain, dense]; " + gpt2_at + ", nf4a, bf16 x; " + f32_at + ", nf4a)",
              dense_control_ms=per_step["matmul_4bit"][2],
              qlora_forward_ms=per_step["matmul_4bit_qlora_forward"],
              gpt2_step_ms=gpt2_step["matmul_4bit"],
              gpt2_f32_step_ms=gpt2_step["matmul_4bit_f32"],
              f32_accuracy_proxy_us=acc_f32["matmul_4bit"],
              f32_tinyllama_us=tl_f32_fwd["matmul_4bit"]),
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
              "on the window's K; hd100: the K+V writes at OpenLLaMA-3B's head dim, 100, off "
              "the 8-lane groups, µs, prefill of 256 tokens and window of 8 x 8, 26 layers)",
              op_us=q_op_us, hd100=q_hd100),
        entry("matmul_4bit_t", "matmul_4bit_t.cu", "quanta_tpu/ops/matmul.py:423",
              train_launches["matmul_4bit_t"], *t_step[:2], "bf16",
              "one QLoRA backward's 152 calls at M=2048, bf16 g, nf4, ms; library: none "
              "(dense_control_ms: cuBLAS g @ W_deq^T of the dequantized bf16 weights; "
              + f32_t_at + ", nf4a)",
              dense_control_ms=t_step[2],
              f32_us={"gpt2": gpt2_t_f32["matmul_4bit_t"],
                      "accuracy_proxy": acc_f32["matmul_4bit_t"],
                      "tinyllama": tl_f32["matmul_4bit_t"]}),
        entry("adam8bit_update", "adam8bit.cu", "quanta_tpu/ops/adam8bit.py:72",
              train_launches["adam8bit_update"], *adam_step, "f32",
              "one QLoRA step's optimizer over its 88 bf16 adapter leaves (66 of 64 blocks, "
              "22 of 8) in one launch, parameters updated in place, ms; library: none, "
              "torch's Adam keeps f32 state (gpt2_full_step: GPT-2 small's full-parameter step "
              "over its 148 f32 leaves, 124,439,808 elements, two launches)",
              gpt2_full_step=gpt2_adam),
        entry("flash_fwd", "flash_fwd.cu", "quanta_tpu/ops/attention.py:189",
              launches["flash_fwd"], flash_ms["flash_fwd_ms"], flash_ms["flash_fwd_plain_ms"],
              "bf16", flash_at + sdpa + "forward" + f32_flash_at + "; " + hd100_at + "; "
              + hd256_at, flash_ms["sdpa_fwd_ms"], f32=f32_flash("flash_fwd", "sdpa_fwd_ms"),
              hd100=flash_row_at("openllama_3b_s1024", "flash_fwd", "sdpa_fwd_ms"),
              hd256=flash_row_at("gemma_2b_s1024", "flash_fwd", "sdpa_fwd_ms")),
        entry("flash_bwd_dq", "flash_bwd.cu", "quanta_tpu/ops/attention.py:465",
              launches["flash_bwd_dq"], flash_ms["flash_bwd_dq_ms"],
              flash_ms["flash_bwd_dq_plain_ms"], "bf16",
              flash_at + "none: no call computes dq alone (SDPA's backward stands on "
              "flash_bwd_dkv's line)" + f32_flash_at + "; " + hd100_at + "; " + hd256_at,
              f32=f32_flash("flash_bwd_dq", None),
              hd100=flash_row_at("openllama_3b_s1024", "flash_bwd_dq", None),
              hd256=flash_row_at("gemma_2b_s1024", "flash_bwd_dq", None)),
        entry("flash_bwd_dkv", "flash_bwd.cu", "quanta_tpu/ops/attention.py:494",
              launches["flash_bwd_dkv"], flash_ms["flash_bwd_dkv_ms"],
              flash_ms["flash_bwd_dkv_plain_ms"], "bf16",
              flash_at + sdpa + "backward, dq, dk and dv in one call: compare it with this "
              f"kernel's ms plus flash_bwd_dq's, {bwd_pair_ms}" + f32_flash_at + "; " + hd100_at
              + "; " + hd256_at, flash_ms["sdpa_bwd_ms"],
              f32=f32_flash("flash_bwd_dkv", "sdpa_bwd_ms"),
              hd100=flash_row_at("openllama_3b_s1024", "flash_bwd_dkv", "sdpa_bwd_ms"),
              hd256=flash_row_at("gemma_2b_s1024", "flash_bwd_dkv", "sdpa_bwd_ms")),
        entry("matmul_8bit", "matmul_8bit.cu", "quanta_tpu/ops/matmul.py:306",
              launches["matmul_8bit"], *eight_step[("matmul_8bit", 8)][:2], "bf16",
              "one decode step's 155 calls at M=8, int8, bf16 x, ms; library: none, no "
              "PyTorch call dequantizes blockwise 8-bit codes inside a GEMM (dense_control_ms: "
              "cuBLAS torch.matmul of the dequantized bf16 weights; " + f32_at + ", int8)",
              dense_control_ms=eight_step[("matmul_8bit", 8)][2],
              qlora_forward_ms=eight_step[("matmul_8bit", M_TRAIN)],
              gpt2_f32_step_ms=gpt2_step["matmul_8bit_f32"],
              f32_accuracy_proxy_us=acc_f32["matmul_8bit"],
              f32_tinyllama_us=tl_f32_fwd["matmul_8bit"]),
        entry("matmul_8bit_t", "matmul_8bit_t.cu", "quanta_tpu/ops/matmul.py:529",
              launches["matmul_8bit_t"], *eight_step[("matmul_8bit_t", M_TRAIN)][:2], "bf16",
              "one QLoRA backward's 152 calls at M=2048, int8, bf16 g, ms; library: none "
              "(dense_control_ms as for matmul_8bit; f32_us as for matmul_4bit_t, int8)",
              dense_control_ms=eight_step[("matmul_8bit_t", M_TRAIN)][2],
              f32_us={"gpt2": gpt2_t_f32["matmul_8bit_t"],
                      "accuracy_proxy": acc_f32["matmul_8bit_t"],
                      "tinyllama": tl_f32["matmul_8bit_t"]}),
    ])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
