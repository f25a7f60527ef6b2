"""Model zoo: decoders whose projections accept quantized leaves."""

from quanta_tpu_torch.models import llama
from quanta_tpu_torch.models.llama import LlamaConfig

__all__ = ["llama", "LlamaConfig"]
