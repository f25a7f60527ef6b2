"""Ranks, the ('data', 'model') mesh and manual tensor parallelism (port of
``quanta_tpu/parallel``, its serving part).

Ported: ``initialize`` (``distributed.py``), ``make_mesh`` and
``check_divisibility`` (``sharding.py``) and the whole of ``tp.py``. The
host mesh and its specs, the GSPMD spec trees and the FSDP specs are not.
"""

from quanta_tpu_torch.parallel.distributed import initialize, spawn_local
from quanta_tpu_torch.parallel.sharding import Mesh, check_divisibility, make_mesh
from quanta_tpu_torch.parallel.tp import (
    ShardedQuant,
    dequantize_tp,
    from_global,
    quantize_tp,
    tp_greedy_decode,
    tp_init_cache,
    tp_llama_forward,
    tp_llama_forward_cached,
    tp_llama_params,
    tp_local_params,
)

__all__ = [
    "initialize",
    "spawn_local",
    "Mesh",
    "make_mesh",
    "check_divisibility",
    "ShardedQuant",
    "quantize_tp",
    "from_global",
    "dequantize_tp",
    "tp_llama_params",
    "tp_local_params",
    "tp_llama_forward",
    "tp_init_cache",
    "tp_llama_forward_cached",
    "tp_greedy_decode",
]
