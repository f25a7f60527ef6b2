"""Optimizers (port of quanta_tpu/optim)."""

from quanta_tpu_torch.optim.adam8bit import Adam8bit, AdamW8bit, state_nbytes

__all__ = ["Adam8bit", "AdamW8bit", "state_nbytes"]
