"""quanta_tpu_torch — the PyTorch and CUDA port of quanta_tpu.

Mirrors the JAX package's module layout and public names, so each module's
counterpart is found by path (``quanta_tpu/X.py`` -> ``quanta_tpu_torch/X.py``).
The JAX package stays the reference: the port's tests feed both the same
numpy inputs. This package imports torch and numpy and never jax.

Layers (bottom-up):
  core      plain-torch quant math (reference path)
  ops       hand-written CUDA kernels (csrc/) + plain-torch versions
  nn        ``linear`` dispatch over weight leaves, ``quantize_params``, LoRA
  optim     blockwise 8-bit Adam(W)
  models    Llama and GPT-2 decoders, KV-cached greedy decode, HF checkpoint
            interchange (its own safetensors codec)
  train     QLoRA fine-tuning steps (frozen 4-bit or 8-bit base, LoRA, 8-bit Adam)
  serve     continuous-batching engine over a paged (optionally int8) KV cache
  state     QuantConfig / ConfigTree: three-tier quantization configuration;
            the QuantizationState registry
  calib     activation statistics, range reduction, activation fake-quant
  ptq       whole-model post-training quantization under a ConfigTree
  eval      perplexity over a token stream
  utils     .qtn / .npz tensors and tree checkpoints in the JAX package's
            formats; precision conversion and codebook transcoding
  cli       ``python -m quanta_tpu_torch`` (quantize / eval / generate / ...)
  metrics   counters, gauges and timers the engine records into
  profiling the H100's published rates, rooflines, CUDA-event timing, traces
  interop   JAX parameter trees -> torch parameter trees (duck-typed)
"""

import logging

from quanta_tpu_torch.core import QuantizedTensor, dequantize, quantize

__version__ = "0.1.0"

logging.getLogger(__name__).addHandler(logging.NullHandler())

__all__ = ["QuantizedTensor", "quantize", "dequantize", "__version__"]
