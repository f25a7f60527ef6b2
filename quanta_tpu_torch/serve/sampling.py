"""Token sampling for the serving engine.

Port of ``quanta_tpu/serve/sampling.py``: greedy (temperature == 0),
temperature sampling, and top-k truncation. ``temperature`` may differ per
row; ``top_k`` is engine-wide, or per row under a cap ``max_top_k``.

PyTorch idiom: random draws take an explicit ``torch.Generator`` on the
logits' device (JAX takes a key). The draw is the Gumbel-max trick, as
``jax.random.categorical``'s, with exponential noise from the generator:
argmax(logits / T - log E), E ~ Exp(1). It cannot reproduce
``jax.random``'s bits, so tests compare distributions; greedy rows are
exact (argmax keeps the first maximum, as ``jnp.argmax`` does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no truncation


def _sample_batch(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,
    top_k: int = 0,
    *,
    top_ks: Optional[torch.Tensor] = None,
    max_top_k: int = 0,
) -> torch.Tensor:
    """logits (B, V) f32, temperature (B,) f32 -> (B,) int32 tokens.

    Truncation: a shared ``top_k``, or per-row ``top_ks`` (B,) bounded by
    ``max_top_k`` (rows with top_ks == 0 are not truncated): one top-k of
    width ``max_top_k``, each row's threshold taken at its own k-1.
    """
    if top_ks is not None and max_top_k > 0:
        vals = torch.topk(logits, max_top_k, dim=-1).values  # (B, maxk) descending
        idx = torch.clamp(top_ks.long() - 1, 0, max_top_k - 1)
        kth = vals.gather(1, idx[:, None])
        logits = logits.masked_fill((top_ks[:, None] > 0) & (logits < kth), float("-inf"))
    elif top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    greedy = logits.argmax(dim=-1).to(torch.int32)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    noise = torch.empty_like(logits).exponential_(generator=generator)
    drawn = (logits / temp - noise.log()).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0, drawn, greedy)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           params: SamplingParams) -> torch.Tensor:
    """Sample one token per row of ``logits`` (B, V) under one shared
    ``SamplingParams``."""
    temps = torch.full((logits.shape[0],), params.temperature, dtype=torch.float32,
                       device=logits.device)
    return _sample_batch(logits, generator, temps, top_k=params.top_k)
