"""Persistence (port of quanta_tpu/utils; the tree checkpoint only: the
single-tensor formats and ``convert.py`` are ROADMAP Queue 1 items)."""

from quanta_tpu_torch.utils.serialization import checkpoint_nbytes, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_nbytes"]
