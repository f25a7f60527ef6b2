"""Llama-family decoder in PyTorch (port of quanta_tpu/models/llama.py).

Parameters are a plain tree with the same keys as the JAX package's
``init_params``; each projection goes through ``quanta_tpu_torch.nn.linear``,
so any weight leaf may be dense, a ``QuantizedTensor`` or an ``Int4cWeight``.
All linears are (in_features, out_features): ``y = x @ W``.

Differences from the JAX version, in PyTorch idiom:
  - the KV cache is updated in place (JAX returns a new cache);
  - ``greedy_decode`` is a Python loop (JAX uses ``lax.scan``);
  - random init takes an explicit ``torch.Generator`` and ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from quanta_tpu_torch.nn.linear import linear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """CPU-testable config."""
        d = dict(
            vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=256, max_seq_len=128,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def tinyllama_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
            hidden_dim=5632, max_seq_len=2048,
        )

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(
            dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, hidden_dim=13824
        )


def init_params(generator: torch.Generator, cfg: LlamaConfig, device=None) -> dict:
    """Random-init parameter tree (same keys and shapes as the JAX package;
    the numbers differ, since torch and jax draw differently)."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[0]))
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def ones():
        return torch.ones((cfg.dim,), dtype=cfg.dtype, device=device)

    params = {
        "tok_emb": dense((cfg.vocab_size, cfg.dim), scale=0.02),
        "norm_f": ones(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(
            {
                "attn_norm": ones(),
                "wq": dense((cfg.dim, nh * hd)),
                "wk": dense((cfg.dim, nkv * hd)),
                "wv": dense((cfg.dim, nkv * hd)),
                "wo": dense((nh * hd, cfg.dim)),
                "ffn_norm": ones(),
                "w_gate": dense((cfg.dim, cfg.hidden_dim)),
                "w_up": dense((cfg.dim, cfg.hidden_dim)),
                "w_down": dense((cfg.hidden_dim, cfg.dim)),
            }
        )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.dim, cfg.vocab_size), scale=0.02)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               device=None) -> dict:
    """Fixed-capacity KV cache; ``forward`` writes into it in place."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _attention(q, k, v, q_positions, kv_len_mask, cfg):
    """Causal GQA attention with explicit masks (cache-aware).

    q: (B, S, nh, hd); k/v: (B, T, nkv, hd) where T is cache capacity or S.
    kv_len_mask: (B, T) bool — True where the cache slot holds a real token.
    q_positions: (B, S) absolute positions of the query tokens.

    Query heads are grouped by their shared KV head (grouped einsums), so
    K/V are never repeated per query head.
    """
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    rep = nh // nkv
    qg = q.reshape(b, s, nkv, rep, hd)

    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)

    kv_positions = torch.arange(t, device=q.device)
    causal = q_positions[:, :, None] >= kv_positions[None, None, :]  # (B, S, T)
    valid = causal & kv_len_mask[:, None, :]
    scores = scores.masked_fill(~valid[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v)
    return out.reshape(b, s, nh, hd)


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    cache: Optional[dict] = None,
    *,
    use_kernel: Optional[bool] = None,
    use_flash: Optional[bool] = None,
):
    """Run the decoder.

    tokens: (B, S) int. Without a cache: plain causal forward. With a
    cache: tokens are written at each row's ``cache['pos']`` — IN PLACE
    into ``cache['k']``/``cache['v']`` — and the returned cache shares
    those tensors with a new ``pos`` (prefill when S>1, decode when S==1).

    use_flash: the flash-attention kernel is not ported yet (ROADMAP
    Queue 2 item 5); ``True`` raises, and the default ``None`` resolves to
    the einsum attention, as it does off the TPU.

    Returns (logits (B, S, V) f32, new_cache | None).
    """
    if use_flash:
        raise NotImplementedError(
            "flash attention is not ported yet (ROADMAP Queue 2 item 5)")
    b, s = tokens.shape
    dev = tokens.device
    lin = partial(linear, use_kernel=use_kernel)
    h = params["tok_emb"][tokens].to(cfg.dtype)
    steps = torch.arange(s, device=dev, dtype=torch.int32)

    if cache is not None:
        start = cache["pos"]  # (B,)
        q_positions = start[:, None] + steps[None, :]
        t = cache["k"].shape[2]
        kv_len_mask = torch.arange(t, device=dev)[None, :] < (start[:, None] + s)
        rows = torch.arange(b, device=dev)[:, None]
        slots = q_positions.long()  # (B, S) cache slots of the new tokens
    else:
        q_positions = steps[None, :].expand(b, s)
        kv_len_mask = torch.ones((b, s), dtype=torch.bool, device=dev)

    for i, lp in enumerate(params["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = lin(x, lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = lin(x, lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = lin(x, lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = _rope(q, q_positions, cfg.rope_theta)
        k = _rope(k, q_positions, cfg.rope_theta)

        if cache is not None:
            # in place: each row's new k/v land at its own positions
            k_all, v_all = cache["k"][i], cache["v"][i]
            k_all[rows, slots] = k
            v_all[rows, slots] = v
            attn = _attention(q, k_all, v_all, q_positions, kv_len_mask, cfg)
        else:
            attn = _attention(q, k, v, q_positions, kv_len_mask, cfg)

        h = h + lin(attn.reshape(b, s, -1), lp["wo"])
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        gate = lin(x, lp["w_gate"])
        up = lin(x, lp["w_up"])
        h = h + lin(F.silu(gate.to(torch.float32)).to(up.dtype) * up, lp["w_down"])

    h = rms_norm(h, params["norm_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = lin(h, params["tok_emb"].T)
    else:
        logits = lin(h, params["lm_head"])
    logits = logits.to(torch.float32)

    if cache is not None:
        return logits, {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + s}
    return logits, None


@torch.no_grad()
def greedy_decode(
    params: dict,
    prompt: torch.Tensor,
    cfg: LlamaConfig,
    max_new_tokens: int = 32,
    *,
    use_kernel=None,
) -> torch.Tensor:
    """Greedy generation: one prefill, then one cached forward per token.

    Returns (B, S + max_new_tokens): the prompt and the generated tokens,
    the same tokens as the JAX ``greedy_decode``.
    """
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    cache = init_cache(cfg, b, max_len=s + max_new_tokens, device=prompt.device)
    fwd = partial(forward, cfg=cfg, use_kernel=use_kernel)
    logits, cache = fwd(params, prompt, cache=cache)
    tok = logits[:, -1, :].argmax(dim=-1).to(prompt.dtype)
    out = [tok]
    for _ in range(max_new_tokens - 1):  # the last token needs no forward
        logits, cache = fwd(params, tok[:, None], cache=cache)
        tok = logits[:, -1, :].argmax(dim=-1).to(prompt.dtype)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
