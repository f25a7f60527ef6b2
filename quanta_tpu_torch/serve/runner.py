"""Model execution for the serving engine: prefill and paged decode.

Port of ``quanta_tpu/serve/runner.py``:

  * ``prefill``: one request, its prompt padded to a length bucket, run
    through the model's contiguous-cache ``forward``; returns the logits at
    the last real prompt token and the per-layer KV, which the engine
    writes into the paged pool.
  * ``decode_step``: one token for every slot, attention reading K/V
    through the page table and writing the new token through it.
  * ``decode_multi_step``: ``n_steps`` decode + sample steps for every
    slot, with the pool gathered once at the start of the window and
    written once at its end (``_attention_pool_side``).

Inactive slots carry position -1: they attend to nothing and write into
the null page 0. PyTorch idiom: the pool is updated IN PLACE (JAX donates
it), ``jit`` and ``lax.scan`` become Python loops, and sampling takes an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from quanta_tpu_torch.models import gpt2, llama
from quanta_tpu_torch.nn.linear import linear
from quanta_tpu_torch.serve import kvcache
from quanta_tpu_torch.serve.sampling import _sample_batch


# ------------------------------------------------------- architecture hooks


@dataclasses.dataclass(frozen=True)
class ServeArch:
    """What the Engine needs from a model family.

    forward/init_cache drive the bucketed prefill; embed / decode_layer /
    final_logits are the per-token pieces that ``decode_multi_step``
    stitches around its paged attention: ``decode_layer(lp, h, q_pos, cfg,
    lin, attend)`` must call ``attend(q, k_tok, v_tok)`` exactly once with
    this token's (B, 1, heads, hd) projections and add its output into h.
    """

    forward: Callable
    init_cache: Callable
    embed: Callable  # (params, tokens (B,), q_pos (B, 1), cfg) -> (B, 1, D)
    decode_layer: Callable
    final_logits: Callable  # (params, h, cfg, lin) -> (B, 1, V)


def _llama_embed(params, tokens, q_pos, cfg):
    return params["tok_emb"][tokens[:, None]].to(cfg.dtype)


def _llama_decode_layer(lp, h, q_pos, cfg, lin, attend):
    b = h.shape[0]
    x = llama.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = lin(x, lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = lin(x, lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v = lin(x, lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    q = llama._rope(q, q_pos, cfg.rope_theta)
    k = llama._rope(k, q_pos, cfg.rope_theta)
    attn = attend(q, k, v)
    h = h + lin(attn.reshape(b, 1, -1), lp["wo"])
    x = llama.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    gate = lin(x, lp["w_gate"])
    up = lin(x, lp["w_up"])
    return h + lin(F.silu(gate.to(torch.float32)).to(up.dtype) * up, lp["w_down"])


def _llama_final(params, h, cfg, lin):
    h = llama.rms_norm(h, params["norm_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return lin(h, params["tok_emb"].T)
    return lin(h, params["lm_head"])


def _gpt2_embed(params, tokens, q_pos, cfg):
    h = params["wte"][tokens[:, None]]
    return (h + params["wpe"][q_pos.long()]).to(cfg.dtype)


def _gpt2_decode_layer(lp, h, q_pos, cfg, lin, attend):
    b = h.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim
    x = gpt2.layer_norm(h, lp["ln_1"], cfg.norm_eps)
    qkv = lin(x, lp["attn_qkv"]["w"], lp["attn_qkv"]["b"])
    q, k, v = (t.reshape(b, 1, nh, hd) for t in qkv.chunk(3, dim=-1))
    attn = attend(q, k, v)
    h = h + lin(attn.reshape(b, 1, -1), lp["attn_out"]["w"], lp["attn_out"]["b"])
    x = gpt2.layer_norm(h, lp["ln_2"], cfg.norm_eps)
    x = gpt2._gelu_new(lin(x, lp["mlp_fc"]["w"], lp["mlp_fc"]["b"]))
    return h + lin(x, lp["mlp_out"]["w"], lp["mlp_out"]["b"])


def _gpt2_final(params, h, cfg, lin):
    h = gpt2.layer_norm(h, params["ln_f"], cfg.norm_eps)
    return lin(h, params["wte"].T)  # tied head


ARCHS = {
    "llama": ServeArch(
        forward=llama.forward,
        init_cache=llama.init_cache,
        embed=_llama_embed,
        decode_layer=_llama_decode_layer,
        final_logits=_llama_final,
    ),
    "gpt2": ServeArch(
        forward=gpt2.forward,
        init_cache=gpt2.init_cache,
        embed=_gpt2_embed,
        decode_layer=_gpt2_decode_layer,
        final_logits=_gpt2_final,
    ),
}


def get_arch(arch: str) -> ServeArch:
    """The ``ServeArch`` of a model family."""
    if arch not in ARCHS:
        raise ValueError(f"unknown serving architecture {arch!r}; have {tuple(ARCHS)}")
    return ARCHS[arch]


def pick_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds largest bucket {buckets[-1]}")


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, length: int, cfg, use_kernel=None,
            arch: str = "llama"):
    """Prefill one request.

    tokens: (1, S_bucket) int32, zero-padded past ``length``.
    Returns (last_logits (V,), k_seq, v_seq) with k/v (L, S_bucket, nkv,
    hd); positions >= length hold garbage KV, which the engine masks.
    """
    a = get_arch(arch)
    cache = a.init_cache(cfg, 1, max_len=tokens.shape[1], device=tokens.device)
    logits, cache = a.forward(params, tokens, cfg, cache=cache, use_kernel=use_kernel)
    return logits[0, length - 1], cache["k"][:, 0], cache["v"][:, 0]


def _attention_masks(positions, page_table, page_size):
    active = positions >= 0
    pos_safe = torch.clamp(positions, min=0)
    # inactive slots read and write the null page 0
    table_safe = torch.where(active[:, None], page_table, torch.zeros_like(page_table))
    kv_iota = torch.arange(page_table.shape[1] * page_size, device=positions.device)
    return active, pos_safe, table_safe, kv_iota


@torch.no_grad()
def decode_step(params, pool: dict, page_table, positions, tokens, cfg, page_size: int,
                use_kernel=None):
    """One decode step for all slots.

    page_table: (n_slots, max_pages) int32 (0 = null page); positions:
    (n_slots,) int32 absolute position of ``tokens`` (negative = an
    inactive slot); tokens: (n_slots,) int32. Writes the new K/V into the
    pool IN PLACE and returns (logits (n_slots, V) f32, pool).
    """
    b = tokens.shape[0]
    active, pos_safe, table_safe, kv_iota = _attention_masks(positions, page_table, page_size)
    lin = partial(linear, use_kernel=use_kernel)
    h = params["tok_emb"][tokens[:, None]].to(cfg.dtype)
    q_positions = pos_safe[:, None]
    kv_len_mask = (kv_iota[None, :] <= pos_safe[:, None]) & active[:, None]
    quantized = kvcache.is_quantized(pool)
    for i, lp in enumerate(params["layers"]):
        def attend(q, k, v, i=i):
            k_tok, v_tok = k[:, 0], v[:, 0]
            if quantized:
                k_tok, k_sc = kvcache.quantize_kv(k_tok, use_kernel=use_kernel)
                v_tok, v_sc = kvcache.quantize_kv(v_tok, use_kernel=use_kernel)
                for key, val in (("k_scale", k_sc), ("v_scale", v_sc)):
                    kvcache.write_token_layer(pool[key], i, table_safe, pos_safe, val, page_size)
            kvcache.write_token_layer(pool["k"], i, table_safe, pos_safe, k_tok, page_size)
            kvcache.write_token_layer(pool["v"], i, table_safe, pos_safe, v_tok, page_size)
            k_all = kvcache.gather_layer(pool["k"][i], table_safe)
            v_all = kvcache.gather_layer(pool["v"][i], table_safe)
            if quantized:
                k_all = kvcache.dequantize_kv(
                    k_all, kvcache.gather_layer(pool["k_scale"][i], table_safe), cfg.dtype)
                v_all = kvcache.dequantize_kv(
                    v_all, kvcache.gather_layer(pool["v_scale"][i], table_safe), cfg.dtype)
            return llama._attention(q, k_all, v_all, q_positions, kv_len_mask, cfg)

        h = _llama_decode_layer(lp, h, q_positions, cfg, lin, attend)
    logits = _llama_final(params, h, cfg, lin)
    return logits[:, 0].to(torch.float32), pool


@torch.no_grad()
def sample_one(logits, generator, temp: float, top_k_req: int, top_k: int = 0,
               max_top_k: int = 0) -> torch.Tensor:
    """Sample ONE token from (V,) logits on the device (the admission
    path's sampler), under the engine's top_k / max_top_k so the first
    token is drawn as in-window tokens are. Returns a 0-dim int32 tensor;
    nothing is read back."""
    dev = logits.device
    temps = torch.full((1,), temp, dtype=torch.float32, device=dev)
    if max_top_k > 0:
        kw = dict(top_ks=torch.full((1,), top_k_req, dtype=torch.int32, device=dev),
                  max_top_k=max_top_k)
    else:
        kw = dict(top_k=top_k)
    return _sample_batch(logits[None], generator, temps, **kw)[0]


def _attention_pool_side(q, k_pool, v_pool, pool_mask, k_side, v_side, side_mask, cfg):
    """GQA attention of one query token over the frozen pool gather plus
    this window's fresh side-buffer tokens.

    q: (B, 1, nh, hd); k_pool/v_pool: (B, T, nkv, hd), gathered once at
    the window start; pool_mask: (B, T) (positions below the window base,
    active slots only); k_side/v_side: (B, k, nkv, hd), the window's own
    tokens, unquantized; side_mask: (k,) (entries written so far).

    The two score blocks are concatenated BEFORE the softmax, as in JAX
    (masked entries contribute exp(-1e30 - max) = 0); only the weighted
    value sum is split into pool and side parts.
    """
    b, _, nh, hd = q.shape
    nkv = k_pool.shape[2]
    qg = q.reshape(b, 1, nkv, nh // nkv, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))

    s_pool = torch.einsum("bsgrd,btgd->bgrst", qg, k_pool).to(torch.float32)
    s_side = torch.einsum("bsgrd,btgd->bgrst", qg, k_side).to(torch.float32)
    s_pool = torch.where(pool_mask[:, None, None, None, :], s_pool * scale, -1e30)
    s_side = torch.where(side_mask[None, None, None, None, :], s_side * scale, -1e30)
    probs = torch.softmax(torch.cat([s_pool, s_side], dim=-1), dim=-1).to(q.dtype)
    t_pool = k_pool.shape[1]
    out = torch.einsum("bgrst,btgd->bsgrd", probs[..., :t_pool], v_pool)
    out = out + torch.einsum("bgrst,btgd->bsgrd", probs[..., t_pool:], v_side)
    return out.reshape(b, 1, nh, hd)


@torch.no_grad()
def decode_multi_step(
    params,
    pool: dict,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    tokens: torch.Tensor,
    generator: Optional[torch.Generator],
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    cfg,
    page_size: int,
    n_steps: int,
    use_kernel=None,
    top_k: int = 0,
    max_top_k: int = 0,
    arch: str = "llama",
):
    """``n_steps`` decode + sample steps for every slot.

    The caller has allocated pages covering positions ``seq_len ..
    seq_len + n_steps - 1`` of every active slot. The pool is touched
    twice per window: one page-table gather of every layer at the start
    (the frozen KV state), and one write of all n_steps fresh tokens at
    the end, IN PLACE. In between, each step attends to the frozen
    gather (dequantized, for an int8 pool) plus the window's own tokens,
    unquantized, from a side buffer. So with an int8 pool the outputs
    depend on ``n_steps`` exactly as in JAX.

    Returns (tokens (n_steps, n_slots) int32, next_positions, pool).
    """
    b = tokens.shape[0]
    a = get_arch(arch)
    active, pos_safe, table_safe, kv_iota = _attention_masks(positions, page_table, page_size)
    lin = partial(linear, use_kernel=use_kernel)
    quantized = kvcache.is_quantized(pool)
    n_layers = len(params["layers"])
    # the pool gather holds positions below the window base; the window's
    # tokens live in the side buffer until the final write
    pool_mask = (kv_iota[None, :] < pos_safe[:, None]) & active[:, None]

    # every layer in one gather (JAX gathers layer by layer; same values)
    k_pool = kvcache.gather_all_layers(pool["k"], table_safe)  # (L, B, T, nkv, hd)
    v_pool = kvcache.gather_all_layers(pool["v"], table_safe)
    if quantized:
        k_pool = kvcache.dequantize_kv(
            k_pool, kvcache.gather_all_layers(pool["k_scale"], table_safe), cfg.dtype)
        v_pool = kvcache.dequantize_kv(
            v_pool, kvcache.gather_all_layers(pool["v_scale"], table_safe), cfg.dtype)

    side_shape = (n_layers, b, n_steps, cfg.n_kv_heads, cfg.head_dim)
    side_k = torch.zeros(side_shape, dtype=cfg.dtype, device=tokens.device)
    side_v = torch.zeros(side_shape, dtype=cfg.dtype, device=tokens.device)
    step_iota = torch.arange(n_steps, device=tokens.device)
    toks = []
    for t in range(n_steps):
        side_mask = step_iota <= t
        q_pos = (pos_safe + t)[:, None]
        h = a.embed(params, tokens, q_pos, cfg)
        for i, lp in enumerate(params["layers"]):
            def attend(q, kk, vv, i=i):
                side_k[i, :, t] = kk[:, 0]  # in place (JAX: dynamic_update_slice)
                side_v[i, :, t] = vv[:, 0]
                return _attention_pool_side(q, k_pool[i], v_pool[i], pool_mask,
                                            side_k[i], side_v[i], side_mask, cfg)

            h = a.decode_layer(lp, h, q_pos, cfg, lin, attend)
        logits = a.final_logits(params, h, cfg, lin)[:, 0].to(torch.float32)
        if max_top_k > 0:
            tokens = _sample_batch(logits, generator, temps, top_ks=top_ks,
                                   max_top_k=max_top_k)
        else:
            tokens = _sample_batch(logits, generator, temps, top_k=top_k)
        toks.append(tokens)

    # one write of the whole window, every layer at once; inactive slots
    # resolve to the always-masked null page 0: their table row is zeros,
    # and where the window is longer than a page their positions can run
    # past the table's width, so the column is clamped (JAX's gather fills
    # such columns and its scatter drops the writes: the null page is never
    # read either way)
    tpos = pos_safe[:, None] + step_iota[None, :].to(pos_safe.dtype)
    cols = torch.div(tpos, page_size, rounding_mode="floor").long()
    page_idx = table_safe.gather(1, cols.clamp_(max=table_safe.shape[1] - 1))
    rows = (page_idx * page_size + tpos % page_size).reshape(-1).long()
    kvcache.write_rows(pool, rows, side_k.reshape(n_layers, -1, *side_shape[3:]),
                       side_v.reshape(n_layers, -1, *side_shape[3:]), use_kernel=use_kernel)

    positions = torch.where(active, positions + n_steps, positions)
    return torch.stack(toks), positions, pool
