"""Ranks, meshes, spec-sharded trees and tensor parallelism (port of
``quanta_tpu/parallel``).

``distributed``: joining ranks (``initialize``, ``spawn_local``) and the
multi-host ('dcn', 'data', 'model') mesh with its specs. ``sharding``:
the ('data', 'model') mesh, the quantization-aware spec trees (Megatron
TP, FSDP) and ``shard_params``, which keeps each rank's slices.
``spmd``: the executor that runs the Llama forward, the cached forward
and the QLoRA step over such a sharded tree, the counterpart of the
collectives XLA's partitioner inserts. ``tp``: manual tensor parallelism
over locally packed shards.
"""

from quanta_tpu_torch.parallel.distributed import (
    host_batch_spec,
    host_cache_specs,
    host_fsdp_param_specs,
    host_llama_param_specs,
    initialize,
    make_host_mesh,
    process_batch_slice,
    shard_params_host,
    spawn_local,
)
from quanta_tpu_torch.parallel.sharding import (
    Mesh,
    P,
    PartitionSpec,
    Shard,
    cache_specs,
    check_divisibility,
    check_fsdp_divisibility,
    expand_specs,
    fsdp_param_specs,
    llama_param_specs,
    make_mesh,
    shard_cache,
    shard_params,
)
from quanta_tpu_torch.parallel import spmd
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
    "make_host_mesh",
    "host_llama_param_specs",
    "host_fsdp_param_specs",
    "host_cache_specs",
    "host_batch_spec",
    "shard_params_host",
    "process_batch_slice",
    "Mesh",
    "P",
    "PartitionSpec",
    "Shard",
    "make_mesh",
    "llama_param_specs",
    "fsdp_param_specs",
    "cache_specs",
    "expand_specs",
    "shard_params",
    "shard_cache",
    "check_divisibility",
    "check_fsdp_divisibility",
    "spmd",
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
