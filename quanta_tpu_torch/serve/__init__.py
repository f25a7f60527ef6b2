"""Serving engine: continuous batching over a paged KV cache.

Port of ``quanta_tpu/serve``: ``serve/engine.py`` is the scheduler,
``serve/kvcache.py`` the page pool, ``serve/runner.py`` the prefill and
decode programs, ``serve/sampling.py`` the samplers.
"""

from quanta_tpu_torch.serve.engine import Engine, Request
from quanta_tpu_torch.serve.kvcache import PageAllocator, init_pool
from quanta_tpu_torch.serve.sampling import SamplingParams

__all__ = ["Engine", "Request", "SamplingParams", "PageAllocator", "init_pool"]
