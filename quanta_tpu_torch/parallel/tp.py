"""Manual tensor parallelism over locally packed quantized shards (port
of ``quanta_tpu/parallel/tp.py``).

Every rank holds *locally packed* weight shards: the split_k nibble
pairing and the scale blocks of its shard are entirely its own, so the
fused dequant-matmul kernels (``matmul_4bit`` for 4-bit shards,
``matmul_8bit`` for 8-bit ones) run on local data at local shapes, and the
collectives are explicit (Megatron TP over quantized storage):

  - column-parallel (wq/wk/wv/w_gate/w_up, lm_head): weights split along
    N; activations replicated over 'model'; heads stay local through
    attention, and the KV cache holds only the rank's KV heads;
  - row-parallel (wo, w_down): weights split along K; each output chunk's
    partial sum is all-reduced as soon as its matmul is queued, and the
    waits come before the concat, so a chunk's all-reduce can overlap the
    next chunk's matmul;
  - the vocab-split head's logits are gathered over 'model'; the batch is
    split over 'data'.

How it maps onto torch: JAX runs one ``shard_map`` program over the mesh;
here each rank is a process (``parallel.distributed``) that runs these
functions on its own shard, and ``sharding.Mesh`` carries its
collectives. :class:`ShardedQuant` keeps the stacked ``(tp, ...)`` codes
and scales, as JAX does, for the oracle (:func:`dequantize_tp`) and for
resharding; :func:`tp_local_params` (the counterpart of JAX's shard_map
``in_specs``) keeps one rank's shards, each copied out contiguous once by
:meth:`ShardedQuant.shard`, the row-parallel ones already cut into their
chunks. Attention is always the einsum ``llama._attention`` over the local
heads, as JAX's TP path computes it, never flash.

Resharding: :func:`from_global` turns a *global* split_k checkpoint into
local shards for any TP width without touching float values: codes are
re-paired, never re-quantized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from quanta_tpu_torch.core import codecs, packing
from quanta_tpu_torch.core.qtensor import QuantizedTensor
from quanta_tpu_torch.models.llama import _attention, _rope, rms_norm
from quanta_tpu_torch.nn.linear import linear

# Megatron mapping of a Llama layer: 1 = column split (N), 0 = row split (K)
_PLAN = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _chunk_count(n: int, n_chunks: int) -> int:
    """Narrow a row-parallel output's chunk count until every chunk is a
    whole multiple of 128 columns wide (the kernels' N tile) and the
    chunks divide N: e.g. N = 128 runs one chunk, not two of 64."""
    while n_chunks > 1 and (n % n_chunks or (n // n_chunks) % 128):
        n_chunks -= 1
    return n_chunks


@dataclasses.dataclass
class ShardedQuant:
    """A quantized 2-D weight stored as ``tp`` locally packed shards.

    codes: (tp, k2_local, n_local) uint8, each shard an independent
      split_k-packed block (4-bit), or int8/uint8 codes (8-bit, k_local
      rows instead of k2).
    scale: (tp, kb_local, n_local) f32, the shards' own scale blocks.
    axis: 0 = row-parallel (K split), 1 = column-parallel (N split).
    shape: global logical (K, N).
    """

    codes: torch.Tensor
    scale: torch.Tensor
    tp: int = 1
    fmt: str = "nf4"
    bits: int = 4
    block_size: int = 64
    axis: int = 1
    shape: tuple = ()
    dtype: torch.dtype = torch.bfloat16

    def local_shape(self) -> tuple:
        k, n = self.shape
        return (k // self.tp, n) if self.axis == 0 else (k, n // self.tp)

    def local_qt(self, codes2d: torch.Tensor, scale2d: torch.Tensor,
                 shape: Optional[tuple] = None) -> QuantizedTensor:
        """Wrap one shard's local arrays as a standard QuantizedTensor."""
        return QuantizedTensor(
            codes=codes2d, scale=scale2d, zero_point=None, bits=self.bits,
            scheme="symmetric" if self.fmt == "int8" else "codebook",
            codebook=None if self.fmt == "int8" else self.fmt,
            shape=shape or self.local_shape(), dtype=self.dtype,
            block_size=self.block_size, packed="split_k" if self.bits == 4 else "none")

    def shard(self, rank: int, n_chunks: int = 1):
        """Rank ``rank``'s shard, copied out of the stack once (contiguous,
        owning only its own memory). A column split gives its
        QuantizedTensor; a row split gives a tuple of QuantizedTensors, its
        output columns cut into ``n_chunks`` chunks (narrowed by
        ``_chunk_count``), one all-reduce each."""
        codes, scale = self.codes[rank], self.scale[rank]
        if self.axis == 1:
            return self.local_qt(codes.clone(), scale.clone())
        k_loc, n = self.local_shape()
        n_chunks = _chunk_count(n, n_chunks)
        step = n // n_chunks
        return tuple(
            self.local_qt(codes[:, c * step:(c + 1) * step].contiguous(),
                          scale[:, c * step:(c + 1) * step].contiguous(), shape=(k_loc, step))
            for c in range(n_chunks))


def quantize_tp(w: torch.Tensor, tp: int, *, axis: int, fmt: str = "nf4",
                block_size: int = 64) -> ShardedQuant:
    """Quantize a dense (K, N) weight into ``tp`` locally packed shards.

    Supports the fused-kernel QuantizedTensor formats (symmetric /
    codebook). llm_int8 and int4c have global-K structure (calibrated
    outlier rows; nibble pairs with per-column scales) and no local
    re-pairing here; they raise."""
    if fmt in ("llm_int8", "int4c"):
        raise ValueError(f"manual TP does not support fmt={fmt!r}; shard it with GSPMD-style "
                         "specs (not ported)")
    k, n = w.shape
    if w.shape[axis] % tp:
        raise ValueError(f"axis {axis} of {tuple(w.shape)} not divisible by tp={tp}")
    qts = [codecs.quantize_matmul_weight(s, fmt=fmt, block_size=block_size)
           for s in torch.chunk(w, tp, dim=axis)]
    return ShardedQuant(codes=torch.stack([q.codes for q in qts]),
                        scale=torch.stack([q.scale for q in qts]), tp=tp, fmt=fmt,
                        bits=qts[0].bits, block_size=block_size, axis=axis, shape=(k, n),
                        dtype=w.dtype)


def from_global(qt: QuantizedTensor, tp: int, *, axis: int) -> ShardedQuant:
    """Re-shard a *global* matmul-layout QuantizedTensor into ``tp`` local
    shards without requantizing (codes re-paired bit for bit).

    A column split slices codes and scales along N and pads each shard's N
    to 128 (scale 1.0). A row split must re-pair nibbles: global split_k
    couples rows (k, k + K/2), a local shard (k, k + K_loc/2); so unpack,
    slice, re-pad K to 16 x block, re-pack."""
    fmt = qt.codebook or "int8"
    block = qt.block_size
    k, n = qt.shape
    if (axis == 0 and k % tp) or (axis == 1 and n % tp):
        raise ValueError(f"shape {qt.shape} axis {axis} not divisible by {tp}")
    meta = dict(tp=tp, fmt=fmt, bits=qt.bits, block_size=block, axis=axis, shape=(k, n),
                dtype=qt.dtype)

    if axis == 1:
        n_loc = n // tp
        pad = _cdiv(n_loc, 128) * 128 - n_loc
        cs = [F.pad(qt.codes[:, i * n_loc:(i + 1) * n_loc], (0, pad)) for i in range(tp)]
        ss = [F.pad(qt.scale[:, i * n_loc:(i + 1) * n_loc], (0, pad), value=1.0)
              for i in range(tp)]
        # the global K_pad may exceed a shard's need but stays tile-aligned: kept
        return ShardedQuant(codes=torch.stack(cs), scale=torch.stack(ss), **meta)

    k_loc = k // tp
    if k_loc % (2 * block):
        raise ValueError(f"K/tp={k_loc} must be a multiple of 2*block={2 * block}")
    k_pad_loc = _cdiv(k_loc, 16 * block) * 16 * block
    codes_full = packing.unpack_split_k(qt.codes) if qt.bits == 4 else qt.codes
    kb = k_loc // block
    cs, ss = [], []
    for i in range(tp):
        c = F.pad(codes_full[i * k_loc:(i + 1) * k_loc], (0, 0, 0, k_pad_loc - k_loc))
        cs.append(packing.pack_split_k(c) if qt.bits == 4 else c)
        ss.append(F.pad(qt.scale[i * kb:(i + 1) * kb], (0, 0, 0, (k_pad_loc - k_loc) // block),
                        value=1.0))
    return ShardedQuant(codes=torch.stack(cs), scale=torch.stack(ss), **meta)


def dequantize_tp(sq: ShardedQuant) -> torch.Tensor:
    """Materialize the dense global weight (test oracle)."""
    return torch.cat([codecs.dequantize_matmul_weight(sq.local_qt(sq.codes[i], sq.scale[i]))
                      for i in range(sq.tp)], dim=sq.axis)


# ------------------------------------------------------------- tp forward


def _local_linear(x: torch.Tensor, qt: QuantizedTensor, use_kernel) -> torch.Tensor:
    """A column-parallel linear on the rank's own shard: no collective.
    ``nn.linear`` runs ``matmul_quantized`` (the kernel for a CUDA x), whose
    output drops the shard's N padding."""
    return linear(x, qt, use_kernel=use_kernel)


def _row_parallel(x: torch.Tensor, chunks, mesh, use_kernel) -> torch.Tensor:
    """A row-parallel linear: a local partial product per output chunk,
    each all-reduced over 'model' as soon as it is queued; the waits come
    before the concat."""
    pending = [mesh.all_reduce(linear(x, qt, use_kernel=use_kernel), "model") for qt in chunks]
    return torch.cat([p.wait() for p in pending], dim=-1)


def tp_llama_params(params: dict, cfg, tp: int, *, fmt: str = "nf4",
                    block_size: int = 64) -> dict:
    """Quantize a dense Llama parameter tree into locally packed TP shards
    (qkv/gate/up column-split, o/down row-split, lm_head vocab-split)."""
    out = {"tok_emb": params["tok_emb"], "norm_f": params["norm_f"], "layers": []}
    for lp in params["layers"]:
        nl = {"attn_norm": lp["attn_norm"], "ffn_norm": lp["ffn_norm"]}
        for name, axis in _PLAN.items():
            nl[name] = quantize_tp(lp[name], tp, axis=axis, fmt=fmt, block_size=block_size)
        out["layers"].append(nl)
    if "lm_head" in params:
        out["lm_head"] = quantize_tp(params["lm_head"], tp, axis=1, fmt=fmt,
                                     block_size=block_size)
    return out


def tp_local_params(params: dict, mesh, n_chunks: int = 2) -> dict:
    """This rank's Llama tree (the counterpart of JAX's shard_map
    ``in_specs``): every linear replaced by its shard at the rank's 'model'
    index (:meth:`ShardedQuant.shard`; row-parallel ones in ``n_chunks``
    chunks), the embedding and norms kept (replicated). ``params`` is a tp
    tree (``ShardedQuant`` leaves, :func:`tp_llama_params`) or a global
    quantized one (``QuantizedTensor`` leaves), resharded leaf by leaf
    through :func:`from_global`, so a rank never holds another rank's
    shards."""
    tp, rank = mesh.shape["model"], mesh.coords["model"]

    def local(t, name, axis):
        if isinstance(t, QuantizedTensor):
            t = from_global(t, tp, axis=axis)
        if not isinstance(t, ShardedQuant):
            raise TypeError(f"{name}: a {type(t).__name__} has no local shard (quantize it)")
        if t.tp != tp:
            raise ValueError(f"{name}: a tp={t.tp} shard on a mesh of {tp} model ranks")
        return t.shard(rank, n_chunks)

    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    out["layers"] = [{k: local(v, k, _PLAN[k]) if k in _PLAN else v for k, v in lp.items()}
                     for lp in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = local(params["lm_head"], "lm_head", 1)
    return out


def _data_slice(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of a global batch split over 'data'."""
    d, i = mesh.shape["data"], mesh.coords["data"]
    if tokens.shape[0] % d:
        raise ValueError(f"batch {tokens.shape[0]} does not split over {d} data ranks")
    b = tokens.shape[0] // d
    return tokens[i * b:(i + 1) * b]


def _fwd_local(p: dict, toks: torch.Tensor, cfg, mesh, cache: Optional[dict], use_kernel):
    """One rank's forward over its batch rows (JAX's shard_map bodies:
    ``tp_llama_forward``'s ``fwd`` without a cache, ``_fwd_cached_local``
    with one): ``models.llama.forward`` with the local head counts, the
    row-parallel all-reduces and the vocab gather. The cache, the rank's
    own KV heads, is written in place. Returns (logits (b, S, V) f32,
    cache | None)."""
    tp = mesh.shape["model"]
    nh, nkv, hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    b, s = toks.shape
    dev = toks.device
    h = p["tok_emb"][toks].to(cfg.dtype)
    steps = torch.arange(s, device=dev, dtype=torch.int32)
    if cache is not None:
        start = cache["pos"]
        q_pos = start[:, None] + steps[None, :]
        t = cache["k"].shape[2]
        kv_len_mask = torch.arange(t, device=dev)[None, :] < (start[:, None] + s)
        rows, slots = torch.arange(b, device=dev)[:, None], q_pos.long()
    else:
        q_pos = steps[None, :].expand(b, s)
        kv_len_mask = torch.ones((b, s), dtype=torch.bool, device=dev)

    for i, lp in enumerate(p["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = _local_linear(x, lp["wq"], use_kernel).reshape(b, s, nh, hd)
        k = _local_linear(x, lp["wk"], use_kernel).reshape(b, s, nkv, hd)
        v = _local_linear(x, lp["wv"], use_kernel).reshape(b, s, nkv, hd)
        q = _rope(q, q_pos, cfg.rope_theta)
        k = _rope(k, q_pos, cfg.rope_theta)
        if cache is not None:
            k_all, v_all = cache["k"][i], cache["v"][i]
            k_all[rows, slots] = k
            v_all[rows, slots] = v
            attn = _attention(q, k_all, v_all, q_pos, kv_len_mask, cfg)
        else:
            attn = _attention(q, k, v, q_pos, kv_len_mask, cfg)
        h = h + _row_parallel(attn.reshape(b, s, -1), lp["wo"], mesh, use_kernel)
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        gate = _local_linear(x, lp["w_gate"], use_kernel)
        up = _local_linear(x, lp["w_up"], use_kernel)
        act = F.silu(gate.to(torch.float32)).to(up.dtype) * up
        h = h + _row_parallel(act, lp["w_down"], mesh, use_kernel)

    h = rms_norm(h, p["norm_f"], cfg.norm_eps)
    logits_loc = _local_linear(h, p["lm_head"], use_kernel).to(torch.float32)
    logits = mesh.all_gather(logits_loc, "model", dim=2)
    if cache is None:
        return logits, None
    return logits, {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + s}


@torch.no_grad()
def tp_llama_forward(tp_params: dict, tokens: torch.Tensor, cfg, mesh, *,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Causal scoring forward under manual TP, run by every rank on its
    own tree (:func:`tp_local_params`). tokens: the global (B, S) batch,
    split over 'data'. Returns the full logits (B, S, V) f32 on every rank,
    gathered over the vocab-split lm_head and the data ranks."""
    logits, _ = _fwd_local(tp_params, _data_slice(tokens, mesh), cfg, mesh, None, use_kernel)
    return mesh.all_gather(logits, "data", dim=0)


def tp_init_cache(cfg, batch: int, max_len: Optional[int] = None, *, mesh,
                  device=None) -> dict:
    """This rank's KV cache for manual-TP decode: its rows of the global
    ``batch`` and its ``n_kv_heads / tp`` KV heads (JAX's global-shape
    cache as shard_map splits it: batch on 'data', heads on 'model')."""
    max_len = max_len or cfg.max_seq_len
    if batch % mesh.shape["data"]:
        raise ValueError(f"batch {batch} does not split over {mesh.shape['data']} data ranks")
    shape = (cfg.n_layers, batch // mesh.shape["data"], max_len,
             cfg.n_kv_heads // mesh.shape["model"], cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((shape[1],), dtype=torch.int32, device=device)}


@torch.no_grad()
def tp_llama_forward_cached(tp_params: dict, tokens: torch.Tensor, cfg, mesh, cache: dict, *,
                            use_kernel: Optional[bool] = None):
    """One cached forward (prefill when S > 1, decode when S == 1) under
    manual TP, on the rank's cache (:func:`tp_init_cache`), written in
    place. Returns (logits (B, S, V) on every rank, new_cache)."""
    logits, cache = _fwd_local(tp_params, _data_slice(tokens, mesh), cfg, mesh, cache,
                               use_kernel)
    return mesh.all_gather(logits, "data", dim=0), cache


@torch.no_grad()
def tp_greedy_decode(tp_params: dict, prompt: torch.Tensor, cfg, mesh,
                     max_new_tokens: int = 32, *,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Greedy generation under manual TP, a loop in every rank: one
    prefill, then one cached forward a token (none for the last), the
    same tokens as ``models.llama.greedy_decode``. Every model rank takes
    the argmax of the same gathered logits; that they agree is checked
    (one all-gather of the tokens at the end), not trusted. Returns the
    global (B, S + max_new_tokens) on every rank."""
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    toks = _data_slice(prompt, mesh)
    cache = tp_init_cache(cfg, b, max_len=s + max_new_tokens, mesh=mesh, device=prompt.device)
    logits, cache = _fwd_local(tp_params, toks, cfg, mesh, cache, use_kernel)
    tok = logits[:, -1].argmax(dim=-1).to(prompt.dtype)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = _fwd_local(tp_params, tok[:, None], cfg, mesh, cache, use_kernel)
        tok = logits[:, -1].argmax(dim=-1).to(prompt.dtype)
        out.append(tok)
    new = torch.stack(out, dim=1)
    seen = mesh.all_gather(new, "model", dim=0)
    if not torch.equal(seen, new.repeat(mesh.shape["model"], 1)):
        raise RuntimeError("tp_greedy_decode: the model ranks disagree on the greedy tokens")
    return torch.cat([prompt, mesh.all_gather(new, "data", dim=0)], dim=1)
