"""The executor of a spec-sharded parameter tree: the Llama forward, the
cached forward, greedy decoding and the QLoRA step over the
:class:`~quanta_tpu_torch.parallel.sharding.Shard` trees that
``shard_params`` gives.

In JAX, ``shard_params`` only places arrays; the unchanged
``llama.forward`` and train step run under ``jax.jit`` and XLA's SPMD
partitioner inserts the collectives. PyTorch has no partitioner that
reaches the port's kernels, so this module inserts them by rule, each rank
running ``llama.forward`` on its own slices through a mesh's
:class:`~quanta_tpu_torch.models.llama.Layout`:

  - the batch splits over the mesh's batch axes ('data', or ``('dcn',
    'data')`` on the host mesh);
  - a weight split on a batch axis (the ZeRO-3 weight axis) or along K on
    'model' is all-gathered at use, for one linear: its forward and, under
    autograd, its backward, which gathers it again
    (:class:`_GatheredLinear` saves only the shard). Codes are never cut
    along K for a kernel: a K-shard of split_k codes pairs rows that belong
    to other shards (``core/packing.py``);
  - a weight split only along N on 'model' (wq/wk/wv/w_gate/w_up, the
    head) runs as it is, its output the rank's columns: heads stay local
    through attention, and a ``shard_cache`` cache holds the rank's KV
    heads;
  - a 'model'-local activation is all-gathered before a linear that needs
    all of K (wo, w_down) and before the residual; the head's vocab-split
    logits are gathered over 'model'.

Autograd follows the same rules: an all-gather's backward sums its
gradient over the batch axes it gathered over and keeps the rank's own
slice; where a value replicated over 'model' enters 'model'-local work,
:class:`_SumModelGrad` (identity forward) sums its gradient over 'model'
in the backward. A rank's loss is its rows' share of the global mean, the
reported loss the sum over the batch axes; the gradients of the trainable
arrays (adapters, or any weight that requires one) are summed over the
batch axes (:func:`reduce_gradients`), and each rank's optimizer steps its
own slices.

Each mesh counts the weight bytes gathered at use (:func:`gathered_bytes`):
the bytes alive now, their peak and the total since
:func:`reset_gathered`.
"""

from __future__ import annotations

import dataclasses
import weakref
from functools import partial
from typing import Optional

import torch

from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.models import llama
from quanta_tpu_torch.nn.linear import linear
from quanta_tpu_torch.nn.lora import LoRAWeight
from quanta_tpu_torch.ops.matmul import _mmq_backward
from quanta_tpu_torch.parallel.sharding import (BATCH_AXES, Mesh, P, Shard, axes_of, cache_specs,
                                                local_index, map_arrays)

def gathered_bytes(mesh: Mesh) -> dict:
    """Weight bytes all-gathered at use on ``mesh``: alive now, the peak
    alive and the total, since :func:`reset_gathered`."""
    return dict(mesh.gathered)


def reset_gathered(mesh: Mesh) -> None:
    mesh.gathered.update(peak=mesh.gathered["alive"], total=0)


def _release(counts: dict, n: int) -> None:
    counts["alive"] -= n


def _track(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Count a gathered weight array alive until it is freed."""
    counts, n = mesh.gathered, t.numel() * t.element_size()
    counts["alive"] += n
    counts["total"] += n
    counts["peak"] = max(counts["peak"], counts["alive"])
    weakref.finalize(t, _release, counts, n)
    return t


def batch_axes(mesh: Mesh) -> tuple:
    """The mesh's batch axes that hold more than one rank."""
    return tuple(a for a in BATCH_AXES if mesh.shape.get(a, 1) > 1)


def batch_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch (dim 0 split over the batch
    axes)."""
    return t[local_index(tuple(t.shape[:1]), P(batch_axes(mesh) or None), mesh)]


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every rank's rows (no autograd)."""
    axes = batch_axes(mesh)
    return mesh.all_gather(t, axes, 0) if axes else t


def unshard(x, mesh: Mesh, grad: bool = False) -> torch.Tensor:
    """The global array of a :class:`Shard` (its gradient with ``grad``),
    all-gathered from every rank's slice: every rank of the mesh calls.
    A plain tensor is returned as it is."""
    t = _local(x).grad if grad else _local(x).detach()
    for dim, axes in _axes_to_gather(_spec(x), False):
        if mesh.size(axes) > 1:
            t = mesh.all_gather(t.contiguous(), axes, dim)
    return t


# --------------------------------------------------- collectives in autograd


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axes``; the backward sums the
    gradient over the batch axes among them and keeps the rank's slice
    (over 'model' the computation after a gather is replicated, so its
    gradient is already whole on every rank)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        summed = tuple(a for a in axes if a in BATCH_AXES)
        if summed:
            g = mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), summed).wait()
        step = g.shape[dim] // mesh.size(axes)
        return g.narrow(dim, mesh.index(axes) * step, step), None, None, None


class _SumModelGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over 'model' (a
    value replicated over 'model' entering work local to each rank)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, "model").wait(), None


def _sum_model_grad(t, mesh):
    return _SumModelGrad.apply(t, mesh) if mesh.shape.get("model", 1) > 1 else t


def _to_full(t, local: bool, mesh: Mesh):
    """A 'model'-local activation (its last dim the rank's columns) made
    whole on every rank."""
    return _Gather.apply(t, mesh, ("model",), t.ndim - 1) if local else t


def _to_local(t, local: bool, mesh: Mesh):
    """A whole activation cut to the rank's columns of its last dim."""
    if local:
        return t
    tp = mesh.shape["model"]
    if t.shape[-1] % tp:
        raise ValueError(f"{t.shape[-1]} columns do not split over {tp} model ranks")
    step = t.shape[-1] // tp
    return _sum_model_grad(t, mesh).narrow(-1, mesh.coords["model"] * step, step)


# ------------------------------------------------------------ weight leaves


def _spec(x) -> tuple:
    return x.spec if isinstance(x, Shard) else ()


def _local(x):
    return x.local if isinstance(x, Shard) else x


def _axes_to_gather(spec, keep_model: bool):
    """(dim, axes) to all-gather an array of ``spec`` over: every split,
    but 'model' on a dim where ``keep_model``."""
    out = []
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if keep_model:
            axes = tuple(a for a in axes if a != "model")
        if axes:
            out.append((dim, axes))
    return out


def _gather(x, mesh: Mesh, keep_model: bool):
    """An array of a weight leaf, all-gathered as the leaf's use needs and
    counted while alive; a trainable one through autograd (:class:`_Gather`),
    so that its gradient reaches the rank's slice."""
    t = _local(x)
    todo = [(d, a) for d, a in _axes_to_gather(_spec(x), keep_model) if mesh.size(a) > 1]
    for dim, axes in todo:
        t = _Gather.apply(t, mesh, axes, dim) if t.requires_grad else mesh.all_gather(t, axes, dim)
    return _track(t, mesh) if todo else t


def _base_of(leaf):
    return leaf.base if isinstance(leaf, LoRAWeight) else leaf


def _logical(leaf) -> tuple:
    """The (K, N) spec of a weight leaf: its codes', or the dense array's."""
    base = _base_of(leaf)
    spec = _spec(base if isinstance(base, (torch.Tensor, Shard)) else base.codes)
    return tuple(spec + (None, None))[:2]


def _n_pad_and_n(leaf) -> tuple:
    """(N of the stored arrays, logical N) of a weight leaf (global)."""
    base = _base_of(leaf)
    if isinstance(base, (torch.Tensor, Shard)):
        return base.shape[-1], base.shape[-1]
    return base.codes.shape[-1], base.shape[1]


def _column_local(leaf, mesh: Mesh) -> bool:
    """Whether a weight leaf runs on the rank's own N columns as it is:
    split along N on 'model' alone, never along K on it, and with no N
    padding (so the rank's padded columns are its logical ones)."""
    tp = mesh.shape.get("model", 1)
    a, b = _logical(leaf)
    n_pad, n = _n_pad_and_n(leaf)
    return tp > 1 and axes_of(b) == ("model",) and "model" not in axes_of(a) and (
        n_pad == n and n % tp == 0)


def _weight(leaf, mesh: Mesh, local: bool):
    """A frozen weight leaf with tensors: each array gathered over every
    axis it is split on but 'model' along N when ``local`` (then the leaf's
    logical shape is the rank's columns)."""
    if isinstance(leaf, (torch.Tensor, Shard)):
        return _gather(leaf, mesh, local)
    fields = {f.name: _gather(getattr(leaf, f.name), mesh, local)
              for f in dataclasses.fields(leaf)
              if isinstance(getattr(leaf, f.name), (torch.Tensor, Shard))}
    if local:
        k, n = leaf.shape
        fields["shape"] = (k, n // mesh.shape["model"])
    return dataclasses.replace(leaf, **fields)


def _arrays(leaf) -> list:
    return [leaf] if isinstance(leaf, (torch.Tensor, Shard)) else [
        getattr(leaf, f.name) for f in dataclasses.fields(leaf)]


def _gathers(leaf, mesh: Mesh, local: bool) -> bool:
    return any(mesh.size(a) > 1 for x in _arrays(leaf) if isinstance(x, Shard)
               for _, a in _axes_to_gather(x.spec, local))


def _frozen(leaf) -> bool:
    return not any(_local(x).requires_grad for x in _arrays(leaf)
                   if isinstance(x, (torch.Tensor, Shard)))


def _dx(g: torch.Tensor, w, k: int, x_dtype, use_kernel) -> torch.Tensor:
    """dx of ``x @ w`` for a frozen weight: the transposed kernel for a
    QuantizedTensor, g @ w^T for a dense one."""
    g2 = g.reshape(-1, g.shape[-1])
    if isinstance(w, QuantizedTensor):
        dx = _mmq_backward(g2, w, k, x_dtype, use_kernel)
    elif isinstance(w, torch.Tensor):
        dx = (g2 @ w.to(g2.dtype).T).to(x_dtype)
    else:
        raise RuntimeError(f"a {type(w).__name__} base has no backward (its kernel is "
                           "forward-only)")
    return dx.reshape(*g.shape[:-1], k)


class _GatheredLinear(torch.autograd.Function):
    """``x @ W`` for a frozen weight all-gathered at use. The forward
    gathers it, runs the linear and drops it; the backward gathers it
    again for dx. It saves the shard, never the gathered weight, so a
    ZeRO-3 rank holds one gathered linear at a time."""

    @staticmethod
    def forward(ctx, x, base, mesh, local, use_kernel):
        ctx.base, ctx.mesh, ctx.local, ctx.use_kernel = base, mesh, local, use_kernel
        ctx.k, ctx.x_dtype = x.shape[-1], x.dtype
        return linear(x, _weight(base, mesh, local), use_kernel=use_kernel)

    @staticmethod
    def backward(ctx, g):
        w = _weight(ctx.base, ctx.mesh, ctx.local)
        return _dx(g, w, ctx.k, ctx.x_dtype, ctx.use_kernel), None, None, None, None


def _base_linear(x, base, mesh: Mesh, local: bool, use_kernel):
    """``x @ base``: a frozen weight gathered at use through
    :class:`_GatheredLinear` when x needs its gradient; any other weight
    gathered (a trainable one through autograd) and run."""
    if (_gathers(base, mesh, local) and torch.is_grad_enabled() and x.requires_grad
            and _frozen(base)):
        return _GatheredLinear.apply(x, base, mesh, local, use_kernel)
    return linear(x, _weight(base, mesh, local), use_kernel=use_kernel)


def _adapter(x, mesh: Mesh, keep_model: bool):
    """A trainable array gathered at use through autograd."""
    t = _local(x)
    for dim, axes in _axes_to_gather(_spec(x), keep_model):
        if mesh.size(axes) > 1:
            t = _Gather.apply(t, mesh, axes, dim)
    return t


def _sharded_linear(x: torch.Tensor, leaf, mesh: Mesh, use_kernel=None):
    """``x @ W`` for a weight leaf of a sharded tree, x whole on every
    'model' rank. Returns (y, local): ``local`` when y holds the rank's
    columns only (:func:`_column_local`), else y is whole."""
    local = _column_local(leaf, mesh)
    xin = _sum_model_grad(x, mesh) if local else x
    y = _base_linear(xin, _base_of(leaf), mesh, local, use_kernel)
    if isinstance(leaf, LoRAWeight):
        a = _adapter(leaf.lora_a, mesh, False)
        b = _adapter(leaf.lora_b, mesh, local)
        u = x.to(a.dtype) @ a
        if local:
            u = _sum_model_grad(u, mesh)
        y = y + ((u @ b) * (leaf.alpha / a.shape[-1])).to(y.dtype)
    return y, local


# ------------------------------------------------------------------ forward


class _MeshLayout(llama.Layout):
    """``llama.forward``'s :class:`~quanta_tpu_torch.models.llama.Layout`
    on a mesh, by the rules above: dense arrays gathered at use, a
    linear's output the rank's columns where asked (and 'model' splits
    them), whole otherwise."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.tp = mesh, mesh.shape.get("model", 1)

    def array(self, x):
        return _weight(x, self.mesh, False)

    def linear(self, x, w, use_kernel, local=False):
        y, is_local = _sharded_linear(x, w, self.mesh, use_kernel)
        if local and self.tp > 1:
            return _to_local(y, is_local, self.mesh)
        return _to_full(y, is_local, self.mesh)

    def whole(self, x):
        return _to_full(x, self.tp > 1, self.mesh)


def _forward_rows(params, toks, cfg, mesh: Mesh, cache, use_kernel, use_flash):
    """``llama.forward`` on this rank's rows ``toks`` through the mesh's
    layout. The cache (the rank's rows and KV heads, :class:`Shard`
    arrays) is written in place. Returns (logits (b, S, V) f32, new cache
    | None)."""
    tp = mesh.shape.get("model", 1)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads do not split over "
                         f"{tp} model ranks")
    run = partial(llama.forward, cfg=cfg, use_kernel=use_kernel, use_flash=use_flash,
                  layout=_MeshLayout(mesh))
    if cache is None:
        return run(params, toks)
    local = {k: cache[k].local for k in ("k", "v", "pos")}
    if local["k"].shape[1] != toks.shape[0] or local["k"].shape[3] != cfg.n_kv_heads // tp:
        raise ValueError(f"cache of {tuple(local['k'].shape)} for {toks.shape[0]} rows on {tp} "
                         "model ranks")
    logits, new = run(params, toks, cache=local)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "pos": dataclasses.replace(cache["pos"], local=new["pos"])}


def forward(params, tokens: torch.Tensor, cfg, mesh: Mesh, cache: Optional[dict] = None, *,
            use_kernel: Optional[bool] = None, use_flash: Optional[bool] = None):
    """The Llama forward over a sharded tree, run by every rank of the
    mesh. ``tokens``: the global (B, S) batch; the rank runs its rows
    (:func:`batch_rows`). With a cache (:func:`init_cache` or
    ``shard_cache``: the rank's rows and KV heads), the new tokens are
    written into it in place. Returns (the logits of the rank's rows
    (b, S, V) f32, whole over 'model'; the new cache | None)."""
    return _forward_rows(params, batch_rows(tokens, mesh), cfg, mesh, cache, use_kernel,
                         use_flash)


def init_cache(cfg, batch: int, max_len: Optional[int] = None, *, mesh: Mesh, specs=None,
               device=None) -> dict:
    """This rank's slice of ``llama.init_cache(cfg, batch, max_len)``
    under ``specs`` (``cache_specs(cfg)`` by default), made at its local
    size: its rows and its KV heads."""
    max_len = max_len or cfg.max_seq_len
    specs = cache_specs(cfg) if specs is None else specs
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    out = {}
    for name, shape, dtype in (("k", kv, cfg.dtype), ("v", kv, cfg.dtype),
                               ("pos", (batch,), torch.int32)):
        local = tuple(s.stop - s.start for s in local_index(shape, specs[name], mesh))
        out[name] = Shard(local=torch.zeros(local, dtype=dtype, device=device),
                          spec=P(*specs[name]), shape=shape)
    return out


@torch.no_grad()
def greedy_decode(params, prompt: torch.Tensor, cfg, mesh: Mesh, max_new_tokens: int = 32, *,
                  cache_spec=None, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Greedy generation over a sharded tree: one prefill, then one cached
    forward a token, the same tokens as ``llama.greedy_decode``. Every
    'model' rank takes the argmax of the same whole logits; that they
    agree is checked, not trusted. ``cache_spec``: the cache's specs
    (``cache_specs`` by default; ``host_cache_specs`` on the host mesh).
    Returns the global (B, S + max_new_tokens) on every rank."""
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    cache = init_cache(cfg, b, s + max_new_tokens, mesh=mesh, specs=cache_spec,
                       device=prompt.device)
    toks = batch_rows(prompt, mesh)
    logits, cache = _forward_rows(params, toks, cfg, mesh, cache, use_kernel, None)
    tok = logits[:, -1].argmax(dim=-1).to(prompt.dtype)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_rows(params, tok[:, None], cfg, mesh, cache, use_kernel, None)
        tok = logits[:, -1].argmax(dim=-1).to(prompt.dtype)
        out.append(tok)
    new = torch.stack(out, dim=1)
    seen = mesh.all_gather(new, "model", dim=0)
    if not torch.equal(seen, new.repeat(mesh.shape.get("model", 1), 1)):
        raise RuntimeError("spmd.greedy_decode: the model ranks disagree on the greedy tokens")
    return torch.cat([prompt, gather_rows(new, mesh)], dim=1)


# ---------------------------------------------------------------- training


def loss(params, batch: dict, cfg, mesh: Mesh, *, use_kernel=None, use_flash=None):
    """This rank's share of the global next-token loss: its rows' mean
    (``train.causal_lm_loss``) times its share of the global (masked)
    tokens, so the ranks' losses sum to the global mean (the batch axes'
    width divides each rank's mean where the rows are equal)."""
    from quanta_tpu_torch.train import causal_lm_loss  # train imports this module

    logits, _ = forward(params, batch["inputs"], cfg, mesh, use_kernel=use_kernel,
                        use_flash=use_flash)
    targets = batch_rows(batch["targets"], mesh)
    mask = batch.get("mask")
    if mask is None:
        return causal_lm_loss(logits, targets) * (targets.numel() / batch["targets"].numel())
    mask = batch_rows(mask, mesh)
    count = mask.to(torch.float32).sum()
    total = global_loss(count, mesh)
    return causal_lm_loss(logits, targets, mask) * (count / torch.clamp(total, min=1.0))


def _trainable(tree):
    """(tensor, spec) of every array of a tree that requires a gradient."""
    found = []

    def visit(x, _):
        t = _local(x)
        if t.requires_grad:
            found.append((t, _spec(x)))
        return x

    map_arrays(visit, tree)
    return found


def reduce_gradients(params, mesh: Mesh) -> None:
    """Sum every trainable array's gradient over the batch axes it is not
    split on (those it is split on were summed by its gather's backward),
    all in flight at once."""
    axes = batch_axes(mesh)
    pending = []
    for t, spec in _trainable(params):
        split = {a for e in spec for a in axes_of(e)}
        over = tuple(a for a in axes if a not in split)
        if over and t.grad is not None:
            pending.append(mesh.all_reduce(t.grad, over))
    for p in pending:
        p.wait()


def global_loss(local_loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The reported loss: the ranks' shares summed over the batch axes
    (no autograd)."""
    total = local_loss.detach().clone()
    axes = batch_axes(mesh)
    return mesh.all_reduce(total, axes).wait() if axes else total
