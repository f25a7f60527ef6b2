"""GPT-2 decoder in PyTorch (port of quanta_tpu/models/gpt2.py; GPT-2
small, 124M, is north-star config 1).

The second model family beside ``models/llama.py``, on the same rules:
parameters are a plain tree with the JAX package's keys, every projection
goes through ``quanta_tpu_torch.nn.linear`` (so a weight leaf may be dense,
a ``QuantizedTensor``, an ``Int8Weight``, an ``Int4cWeight`` or a
``LoRAWeight``), and every linear is (in, out): HF GPT-2's ``Conv1D``
already stores its weights that way. Attention is ``llama._attention``
with as many KV heads as query heads.

In PyTorch idiom, as the port's Llama: the KV cache is updated in place,
``greedy_decode`` is a Python loop, and random init takes an explicit
``torch.Generator`` and device.

Without a cache the forward runs under autograd, and
``train.make_train_step(cfg, optimizer, forward=gpt2.forward)`` trains
every leaf: ``wte`` takes the gradient of the embedding gather and of the
tied head.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from quanta_tpu_torch.models.llama import _attention
from quanta_tpu_torch.nn.linear import linear

# sqrt(2 / pi) in f32, as the JAX package computes it
_GELU_C = float(np.sqrt(np.float32(2.0 / np.pi)))


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads  # multi-head attention: a KV head per query head

    @property
    def hidden_dim(self) -> int:
        return 4 * self.dim

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        d = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, max_seq_len=64)
        d.update(kw)
        return GPT2Config(**d)

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()  # 124M


def init_params(generator: torch.Generator, cfg: GPT2Config, device=None) -> dict:
    """Random-init parameter tree (the JAX package's keys and shapes; the
    numbers differ, since torch and jax draw differently)."""

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    def ln():
        return {"w": torch.ones((cfg.dim,), dtype=cfg.dtype, device=device), "b": zeros(cfg.dim)}

    def lin(din, dout):
        return {"w": dense((din, dout)), "b": zeros(dout)}

    params = {
        "wte": dense((cfg.vocab_size, cfg.dim)),
        "wpe": dense((cfg.max_seq_len, cfg.dim)),
        "ln_f": ln(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln_1": ln(),
            "attn_qkv": lin(cfg.dim, 3 * cfg.dim),
            "attn_out": lin(cfg.dim, cfg.dim),
            "ln_2": ln(),
            "mlp_fc": lin(cfg.dim, cfg.hidden_dim),
            "mlp_out": lin(cfg.hidden_dim, cfg.dim),
        })
    return params


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * p["w"] + p["b"]  # cast before the affine, as JAX


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU (transformers' 'gelu_new')."""
    x32 = x.to(torch.float32)
    out = 0.5 * x32 * (1.0 + torch.tanh(_GELU_C * (x32 + 0.044715 * x32 ** 3)))
    return out.to(x.dtype)


def init_cache(cfg: GPT2Config, batch: int, max_len: Optional[int] = None,
               device=None) -> dict:
    """Fixed-capacity KV cache; ``forward`` writes into it in place."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def forward(params: dict, tokens: torch.Tensor, cfg: GPT2Config, cache: Optional[dict] = None,
            *, use_kernel: Optional[bool] = None):
    """Run GPT-2; the contract of ``llama.forward``. Without a cache, a
    plain causal forward; with one, the tokens are written at each row's
    ``cache['pos']`` IN PLACE and the returned cache shares those tensors
    with a new ``pos``. Returns (logits (B, S, V) f32, new_cache | None)."""
    b, s = tokens.shape
    dev = tokens.device
    lin = partial(linear, use_kernel=use_kernel)
    nh, hd = cfg.n_heads, cfg.head_dim
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

    h = params["wte"][tokens].to(cfg.dtype)
    h = h + params["wpe"][q_positions.long()].to(cfg.dtype)

    for i, lp in enumerate(params["layers"]):
        x = layer_norm(h, lp["ln_1"], cfg.norm_eps)
        qkv = lin(x, lp["attn_qkv"]["w"], lp["attn_qkv"]["b"])
        q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.chunk(3, dim=-1))
        if cache is not None:
            # in place: each row's new k/v land at its own positions
            k_all, v_all = cache["k"][i], cache["v"][i]
            k_all[rows, slots] = k
            v_all[rows, slots] = v
            attn = _attention(q, k_all, v_all, q_positions, kv_len_mask, cfg)
        else:
            attn = _attention(q, k, v, q_positions, kv_len_mask, cfg)
        h = h + lin(attn.reshape(b, s, -1), lp["attn_out"]["w"], lp["attn_out"]["b"])
        x = layer_norm(h, lp["ln_2"], cfg.norm_eps)
        x = _gelu_new(lin(x, lp["mlp_fc"]["w"], lp["mlp_fc"]["b"]))
        h = h + lin(x, lp["mlp_out"]["w"], lp["mlp_out"]["b"])

    h = layer_norm(h, params["ln_f"], cfg.norm_eps)
    logits = lin(h, params["wte"].T).to(torch.float32)  # tied head

    if cache is not None:
        return logits, {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + s}
    return logits, None


@torch.no_grad()
def greedy_decode(params: dict, prompt: torch.Tensor, cfg: GPT2Config,
                  max_new_tokens: int = 32, *, use_kernel=None) -> torch.Tensor:
    """Greedy generation: one prefill, then one cached forward per token.
    Returns (B, S + max_new_tokens), the tokens of the JAX
    ``greedy_decode``; the serving Engine's oracle for ``arch="gpt2"``."""
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
