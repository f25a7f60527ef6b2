"""QLoRA fine-tuning: frozen quantized base + LoRA adapters + 8-bit Adam.

Port of ``quanta_tpu/train.py``. The base model's linears are
``QuantizedTensor`` leaves (nf4 for the reference's north-star row) that
the forward runs through ``matmul_4bit`` and the backward through
``matmul_4bit_t``, never dequantized to device memory; the adapters are
the only tensors that require a gradient, and ``optim.Adam8bit`` keeps
their state in 8 bits.

In PyTorch the adapters are the ``LoRAWeight`` leaves' own tensors, so a
step updates the parameter tree in place: ``extract_adapters`` returns
those tensors and ``merge_adapters`` puts (possibly other) tensors back.
A step is ``step(params, batch) -> loss``: zero the gradients, forward,
``loss.backward()``, ``optimizer.step()``. The gradients of the step stay
on the adapters until the next one.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Iterable, Optional

import torch

from quanta_tpu_torch.models import llama
from quanta_tpu_torch.nn.lora import LoRAWeight, init_lora

DEFAULT_TARGETS = ("wq", "wv")


def add_lora(
    params: dict,
    generator: torch.Generator,
    *,
    targets: Iterable[str] = DEFAULT_TARGETS,
    rank: int = 8,
    alpha: float = 16.0,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> dict:
    """Wrap the target projections of a llama parameter tree with LoRA."""
    params = dict(params)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in targets:
            base = lp[name]
            in_features, out_features = base.shape
            lp[name] = init_lora(base, generator, rank=rank, alpha=alpha,
                                 in_features=in_features, out_features=out_features,
                                 dtype=dtype, device=device)
        layers.append(lp)
    params["layers"] = layers
    return params


def extract_adapters(params: dict) -> list:
    """The trainable tensors: [{name: {"a": A, "b": B}} per layer]."""
    return [{name: {"a": leaf.lora_a, "b": leaf.lora_b}
             for name, leaf in lp.items() if isinstance(leaf, LoRAWeight)}
            for lp in params["layers"]]


def merge_adapters(params: dict, adapters: list) -> dict:
    """Rebuild the parameter tree with these adapter tensors swapped in."""
    params = dict(params)
    layers = []
    for lp, ad in zip(params["layers"], adapters):
        lp = dict(lp)
        for name, ab in ad.items():
            lp[name] = dataclasses.replace(lp[name], lora_a=ab["a"], lora_b=ab["b"])
        layers.append(lp)
    params["layers"] = layers
    return params


def causal_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32. logits (B,S,V) vs targets (B,S)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = torch.ones_like(ll) if mask is None else mask.to(torch.float32)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(cfg, optimizer: torch.optim.Optimizer, *,
                    use_kernel: Optional[bool] = None, use_flash: Optional[bool] = None):
    """A training step of the Llama forward over whatever tensors
    ``optimizer`` holds. ``use_kernel`` and ``use_flash`` go to
    ``llama.forward`` (``use_flash=None``: the flash kernels from
    ``llama.FLASH_MIN_SEQ`` tokens on CUDA).

    Returns ``step(params, batch) -> loss`` (a 0-dim tensor, left on the
    device); batch is ``{"inputs": (B,S) int, "targets": (B,S) int,
    "mask": optional}``.
    """
    fwd = partial(llama.forward, cfg=cfg, use_kernel=use_kernel, use_flash=use_flash)

    def step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        logits, _ = fwd(params, batch["inputs"])
        loss = causal_lm_loss(logits, batch["targets"], batch.get("mask"))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_qlora_train_step(cfg: llama.LlamaConfig, optimizer: torch.optim.Optimizer, *,
                          use_kernel: Optional[bool] = None, use_flash: Optional[bool] = None):
    """The QLoRA step: the Llama forward over a tree whose only tensors
    that require a gradient are the adapters ``optimizer`` holds
    (``Adam8bit(nn.lora_parameters(params))``)."""
    return make_train_step(cfg, optimizer, use_kernel=use_kernel, use_flash=use_flash)
