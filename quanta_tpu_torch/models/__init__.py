"""Model zoo: decoders whose projections accept quantized leaves."""

from quanta_tpu_torch.models import gpt2, hf, llama
from quanta_tpu_torch.models.gpt2 import GPT2Config
from quanta_tpu_torch.models.llama import LlamaConfig

__all__ = ["llama", "gpt2", "hf", "LlamaConfig", "GPT2Config"]
