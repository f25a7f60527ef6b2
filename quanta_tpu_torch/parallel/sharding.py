"""The mesh of ranks, its collectives, and quantization-aware spec trees
(port of ``quanta_tpu/parallel/sharding.py``).

In JAX a mesh lays devices out on named axes and one program runs over
all of them. Here every rank is a process of its own
(``distributed.initialize``), and :class:`Mesh` tells a rank where it
sits: the axis sizes, its coordinates, and the process groups through
which its collectives go (one per axis, and one for the batch axes
``('dcn', 'data')`` together where a mesh has both). Ranks are laid out
row-major over the axes, as ``make_mesh`` reshapes JAX's device list:
rank ``r`` of a ('data', 'model') mesh sits at ``(r // model, r %
model)``.

The port's own mesh rather than ``torch.distributed.DeviceMesh``:
``DeviceMesh`` picks each rank's card from ``LOCAL_RANK``, so two
``torchrun`` ranks on a one-card machine ask for a second card that is not
there. Collectives take CUDA tensors as they are under either backend:
torch 2.11's gloo takes the async ``all_reduce`` (f32 and bf16) and
``all_gather`` on CUDA tensors from ranks sharing one H100
(``test_gloo_collectives_take_cuda_tensors`` in tests/test_torch_cuda.py).

Spec trees. :class:`PartitionSpec` (``P``) plays the role of JAX's: one
entry per array dimension, an axis name, a tuple of axis names or
``None``. The rules for a logical (K, N) weight with spec ``P(a, b)``
(:func:`expand_specs`, as JAX's ``_expand_leaf_spec``):

  - dense kernel (K, N)            -> P(a, b)
  - QuantizedTensor codes, scale and zero point -> P(a, b) (split_k codes
    shard their packed rows; scale blocks live along K)
  - Int8Weight: codes P(a, b), scale (N,) P(b), outlier_idx replicated,
    w_outlier P(None, b)
  - Int4cWeight: codes P(None, b), scale P(b) (nibble pairs span K)
  - LoRAWeight: base as above; lora_a P(a, None); lora_b P(None, b)

:func:`shard_params` keeps, on each rank, only its slice of every array,
as the mesh's shape and the rank's coordinates place it (the slice JAX's
``NamedSharding`` gives the device at those coordinates), each array in a
:class:`Shard` that records its local tensor, its expanded spec and the
global shape. Slicing needs no process group. The collectives that XLA's
partitioner inserts for these specs are ``parallel.spmd``'s.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist

from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.nn.lora import LoRAWeight
from quanta_tpu_torch.ops.int4c import Int4cWeight
from quanta_tpu_torch.ops.int8mm import Int8Weight

# the axes whose ranks hold different rows of a batch, outermost first
BATCH_AXES = ("dcn", "data")


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array: each entry an axis name, a
    tuple of axis names (the first the outermost) or ``None``
    (replicated); missing trailing entries are ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axes_of(entry) -> tuple:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


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
    """This rank's place on a mesh of ranks. An axis argument is an axis
    name or a tuple of them in the mesh's order (a tuple acts as one axis,
    its first name the outermost)."""

    shape: dict  # axis -> size, as JAX's ``mesh.shape``
    coords: dict  # axis -> this rank's index along it
    groups: dict = dataclasses.field(default_factory=dict)  # axis or axis tuple -> group
    # weight bytes ``parallel.spmd`` gathered at use: alive, peak, total
    gathered: dict = dataclasses.field(
        default_factory=lambda: {"alive": 0, "peak": 0, "total": 0})

    def _axes(self, axes) -> tuple:
        names = axes_of(axes)
        order = [a for a in self.shape if a in names]
        if list(names) != order:
            raise ValueError(f"axes {names} are not mesh axes in the mesh's order {tuple(self.shape)}")
        return names

    def size(self, axes) -> int:
        """Ranks along ``axes`` (their product)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over them)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of ``axes``; None where they hold one rank."""
        names = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if not names:
            return None
        key = names[0] if len(names) == 1 else names
        if key not in self.groups:
            raise RuntimeError(f"this mesh has no process group over {names}")
        return self.groups[key]

    def all_reduce(self, t: torch.Tensor, axes):
        """Start summing ``t`` over ``axes``; returns a handle whose
        ``wait()`` gives the sum (into ``t`` itself)."""
        group = self.group(axes)
        if group is None:
            return _Done(t)
        return _Pending(dist.all_reduce(t, group=group, async_op=True), t)

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axes`` concatenated along ``dim`` in
        their order (JAX's ``all_gather(..., tiled=True)``)."""
        group = self.group(axes)
        if group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size(axes))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)


def _mesh(shape: dict) -> Mesh:
    """This rank's mesh of ``shape`` (axis -> size, outermost first): its
    coordinates and a group for every axis and for the batch axes
    together. Every rank creates every group, in one order, and keeps its
    own."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = math.prod(shape.values())
    if n != world:
        dims = " x ".join(str(v) for v in shape.values())
        raise ValueError(f"a {dims} mesh needs {n} ranks, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    names = tuple(shape)
    every = [dict(zip(names, pos)) for pos in itertools.product(*(range(v) for v in shape.values()))]
    coords = every[rank]  # rank r is the r-th position, row-major
    batch = tuple(a for a in BATCH_AXES if shape.get(a, 1) > 1)
    keys = [a for a in names if shape[a] > 1] + ([batch] if len(batch) > 1 else [])
    groups = {}
    for key in keys:
        outside = [a for a in names if a not in axes_of(key)]
        for fixed in itertools.product(*(range(shape[a]) for a in outside)):
            members = [r for r, c in enumerate(every)
                       if all(c[a] == v for a, v in zip(outside, fixed))]
            g = dist.new_group(members)
            if rank in members:
                groups[key] = g
    return Mesh(shape=dict(shape), coords=coords, groups=groups)


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Build this rank's ('data', 'model') mesh; data * model must be the
    world size (1 without ``distributed.initialize``). Every rank must
    call it, in the same order as its other group creations."""
    return _mesh({"data": data, "model": model})


# ------------------------------------------------------- logical param specs


def llama_param_specs(cfg, params: Optional[dict] = None) -> dict:
    """PartitionSpec tree matching ``models.llama.init_params``.

    Megatron mapping: wq/wk/wv/w_gate/w_up column-sharded on 'model'
    (heads / ffn-hidden live on the output axis), wo/w_down row-sharded
    (their input axis is the sharded one), norms and embeddings replicated,
    lm_head column-sharded over vocab.
    """
    return _layer_specs(cfg, params, col=P(None, "model"), row=P("model", None), emb=P())


def fsdp_param_specs(cfg, params: Optional[dict] = None, tp: bool = True) -> dict:
    """ZeRO-3/FSDP-style weight specs (the QLoRA memory row).

    Every 2-D weight is additionally sharded along the 'data' axis on the
    dimension tensor parallelism leaves unsharded, so each rank holds
    1/(data*model) of the weights; ``parallel.spmd`` gathers each at use.
    With ``tp=False`` the 'model' factor is dropped and weights shard on
    'data' only (pure FSDP).

    For QuantizedTensor leaves the codes and their block scales shard with
    the same spec (scales live along K in blocks). Call
    :func:`check_fsdp_divisibility` first.
    """
    mdl = "model" if tp else None
    return _layer_specs(cfg, params, col=P("data", mdl), row=P(mdl, "data"), emb=P("data", None))


def _layer_specs(cfg, params, *, col, row, emb) -> dict:
    rep = P()
    layer = {"attn_norm": rep, "wq": col, "wk": col, "wv": col, "wo": row, "ffn_norm": rep,
             "w_gate": col, "w_up": col, "w_down": row}
    n_layers = cfg.n_layers if params is None else len(params["layers"])
    specs = {"tok_emb": emb, "norm_f": rep, "layers": [dict(layer) for _ in range(n_layers)]}
    if params is None or "lm_head" in params:
        specs["lm_head"] = col
    return specs


def check_fsdp_divisibility(cfg, data: int, tp: int = 1, block_size: int = 64) -> None:
    """Validate FSDP sharding of packed codes + scale blocks divides evenly."""
    if tp > 1:
        check_divisibility(cfg, tp, block_size)
    problems = []
    for k_dim, what in ((cfg.dim, "dim"), (cfg.hidden_dim, "hidden_dim")):
        if (k_dim // 2) % data or (k_dim // block_size) % data:
            problems.append(
                f"data-shard of K={k_dim} ({what}): packed rows or scale "
                f"blocks not divisible by data={data}"
            )
    out_dims = (cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim,
                cfg.hidden_dim, cfg.dim)
    for n_dim in out_dims:
        if (n_dim // max(tp, 1)) % data:
            problems.append(f"data-shard of N={n_dim}/tp={tp} not divisible "
                            f"by data={data}")
    if problems:
        raise ValueError("; ".join(problems))


def cache_specs(cfg) -> dict:
    """KV cache (L, B, T, n_kv, hd): batch on 'data', kv heads on 'model'."""
    kv = P(None, "data", None, "model", None)
    return {"k": kv, "v": kv, "pos": P("data")}


# ----------------------------------------------- spec expansion per leaf type


def _two(spec) -> tuple:
    """(a, b) of a logical 2-D spec, missing entries None."""
    return tuple(spec + (None, None))[:2] if spec else (None, None)


def _expand_leaf_spec(leaf, spec):
    """Map a logical 2-D weight spec onto the arrays inside a weight leaf."""
    if isinstance(leaf, QuantizedTensor):
        return dataclasses.replace(leaf, codes=spec, scale=spec,
                                   zero_point=None if leaf.zero_point is None else spec)
    if isinstance(leaf, Int8Weight):
        _, b = _two(spec)
        return dataclasses.replace(leaf, codes=spec, scale=P(b), outlier_idx=P(),
                                   w_outlier=P(None, b))
    if isinstance(leaf, Int4cWeight):
        # codes pack two K-rows per byte: K-sharding would split nibble
        # pairs, so only the N axis shards; scales follow their columns
        _, b = _two(spec)
        return dataclasses.replace(leaf, codes=P(None, b), scale=P(b))
    if isinstance(leaf, LoRAWeight):
        a, b = _two(spec)
        return dataclasses.replace(leaf, base=_expand_leaf_spec(leaf.base, spec),
                                   lora_a=P(a, None), lora_b=P(None, b))
    return spec


def expand_specs(params, specs):
    """Expand logical weight specs into per-array PartitionSpecs: the
    params tree with every array replaced by its spec."""
    if isinstance(params, dict):
        return {k: expand_specs(v, specs[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(expand_specs(p, s) for p, s in zip(params, specs, strict=True))
    return _expand_leaf_spec(params, specs)


# ------------------------------------------------------------- local shards


@dataclasses.dataclass
class Shard:
    """One array of a spec-sharded tree as this rank holds it."""

    local: torch.Tensor  # this rank's slice
    spec: PartitionSpec  # the array's expanded spec
    shape: tuple  # the global array's shape

    def __post_init__(self):
        self.shape = tuple(self.shape)


def local_index(shape: tuple, spec, mesh: Mesh) -> tuple:
    """This rank's slice of a global array of ``shape`` under ``spec``:
    one ``slice`` per dimension."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the array's {len(shape)} dims")
    out = []
    for dim, n in enumerate(shape):
        axes = axes_of(spec[dim]) if dim < len(spec) else ()
        ways = mesh.size(axes) if axes else 1
        if n % ways:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {axes} "
                             f"({ways} ranks)")
        step = n // ways
        i = mesh.index(axes) if axes else 0
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def _shard(t: torch.Tensor, spec, mesh: Mesh) -> Shard:
    idx = local_index(tuple(t.shape), spec, mesh)
    local = t
    if t.requires_grad:  # a trainable leaf: the rank's own tensor
        local = t[idx].detach().clone().requires_grad_()
    elif any(s.stop - s.start < n for s, n in zip(idx, t.shape)):
        local = t[idx].clone(memory_format=torch.contiguous_format)  # owns only its slice
    return Shard(local=local, spec=P(*spec), shape=tuple(t.shape))


def map_arrays(fn, tree, specs=None):
    """``fn(array, spec)`` over every tensor of a parameter tree (inside
    weight leaves too), ``specs`` its expanded spec tree (None: every
    spec None); dicts, lists and weight leaves keep their types."""
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v, None if specs is None else specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        ss = [None] * len(tree) if specs is None else specs
        return type(tree)(map_arrays(fn, v, s) for v, s in zip(tree, ss, strict=True))
    if isinstance(tree, (QuantizedTensor, Int8Weight, Int4cWeight, LoRAWeight)):
        fields = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, (torch.Tensor, Shard, QuantizedTensor, Int8Weight, Int4cWeight)):
                fields[f.name] = map_arrays(fn, v, None if specs is None else getattr(specs, f.name))
        return dataclasses.replace(tree, **fields)
    if isinstance(tree, (torch.Tensor, Shard)):
        return fn(tree, specs)
    return tree


def shard_params(params, mesh: Mesh, specs=None, cfg=None):
    """This rank's slices of a parameter tree under quantization-aware
    specs (``llama_param_specs(cfg, params)`` by default): every array
    becomes a :class:`Shard`, codes and their scales cut together. A
    replicated frozen array is kept as it is; a sliced one is copied out
    (owning only its slice); a trainable one (an adapter) is copied into a
    leaf tensor of the rank's own."""
    if specs is None:
        specs = llama_param_specs(cfg, params)
    return map_arrays(lambda t, s: _shard(t, s, mesh), params, expand_specs(params, specs))


def shard_cache(cache, mesh: Mesh, cfg, specs=None):
    """This rank's slice of a KV cache (``cache_specs(cfg)`` by default:
    its batch rows and its KV heads), each array a :class:`Shard`."""
    specs = cache_specs(cfg) if specs is None else specs
    return {k: _shard(v, specs[k], mesh) for k, v in cache.items()}


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
