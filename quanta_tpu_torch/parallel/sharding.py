"""The ('data', 'model') mesh of ranks and its collectives (port of
``quanta_tpu/parallel/sharding.py:60-72`` and ``:264-280``).

In JAX a mesh lays devices out on named axes and ``shard_map`` runs one
program over all of them. Here every rank is a process of its own
(``distributed.initialize``), and :class:`Mesh` tells a rank where it
sits: the axis sizes, its coordinates, and one process group per axis
through which its collectives go. Rank ``r`` sits at ``(r // model, r %
model)``, as ``make_mesh`` reshapes JAX's device list.

The port's own mesh rather than ``torch.distributed.DeviceMesh``:
``DeviceMesh`` picks each rank's card from ``LOCAL_RANK``, so two
``torchrun`` ranks on a one-card machine ask for a second card that is not
there. Collectives take CUDA tensors as they are under either backend:
torch 2.11's gloo takes the async ``all_reduce`` (f32 and bf16) and
``all_gather`` on CUDA tensors from two ranks sharing one H100
(``test_gloo_collectives_take_cuda_tensors`` in tests/test_torch_cuda.py).

The GSPMD spec trees (``llama_param_specs``, ``expand_specs``,
``shard_params``, ``shard_cache``) and the FSDP specs are not ported here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


class _Done:
    """A collective with nothing to do: ``wait()`` returns its tensor."""

    def __init__(self, t: torch.Tensor):
        self._t = t

    def wait(self) -> torch.Tensor:
        return self._t


class _Pending:
    """An all-reduce in flight: ``wait()`` waits for it and returns the
    reduced tensor."""

    def __init__(self, work, t: torch.Tensor):
        self._work, self._t = work, t

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._t


@dataclasses.dataclass
class Mesh:
    """This rank's place on a ('data', 'model') mesh of ranks."""

    shape: dict  # axis -> size, as JAX's ``mesh.shape``
    coords: dict  # axis -> this rank's index along it
    groups: dict  # axis -> process group (None for an axis of size 1)

    def all_reduce(self, t: torch.Tensor, axis: str):
        """Start summing ``t`` over ``axis``; returns a handle whose
        ``wait()`` gives the sum (into ``t`` itself)."""
        group = self.groups[axis]
        if group is None:
            return _Done(t)
        return _Pending(dist.all_reduce(t, group=group, async_op=True), t)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The axis's ranks' ``t`` concatenated along ``dim``, in rank
        order (JAX's ``all_gather(..., tiled=True)``)."""
        group = self.groups[axis]
        if group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Build this rank's ('data', 'model') mesh; data * model must be the
    world size (1 without ``distributed.initialize``). Every rank must
    call it, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = {"data": rank // model, "model": rank % model}
    groups = {"data": None, "model": None}
    # every rank creates every group, in one order; a rank keeps its own
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks) if model > 1 else None
        if d == coords["data"]:
            groups["model"] = g
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks) if data > 1 else None
        if m == coords["model"]:
            groups["data"] = g
    return Mesh(shape={"data": data, "model": model}, coords=coords, groups=groups)


def check_divisibility(cfg, tp: int, block_size: int = 64) -> None:
    """Validate that quantized sharding divides evenly (fail fast)."""
    hd = cfg.head_dim
    problems = []
    if (cfg.n_heads * hd) % tp:
        problems.append(f"q heads ({cfg.n_heads}) x hd not divisible by tp={tp}")
    if (cfg.n_kv_heads * hd) % tp:
        problems.append(f"kv dim not divisible by tp={tp}")
    if cfg.hidden_dim % tp:
        problems.append(f"hidden_dim {cfg.hidden_dim} % tp")
    for k_dim in (cfg.dim, cfg.hidden_dim):
        if (k_dim // 2) % tp or (k_dim // block_size) % tp:
            problems.append(
                f"row-shard of K={k_dim}: packed rows or scale blocks not divisible by tp={tp}"
            )
    if problems:
        raise ValueError("; ".join(problems))
