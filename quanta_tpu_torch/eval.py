"""Model-level accuracy evaluation: perplexity over a token stream.

Port of ``quanta_tpu/eval.py``: windowed next-token negative
log-likelihood over a flat token stream, batched (the tail window is
masked, not dropped), run eagerly under ``torch.inference_mode()`` on the
device the parameters live on. Each batch's sum stays on the device; the
sums are read back once, at the end.

Tokenization: ``load_tokenizer`` uses a HF ``tokenizer.json`` when the
checkpoint ships one (through the ``tokenizers`` package, imported only
then); ``ByteTokenizer`` (vocab 256) covers offline corpora and
from-scratch models.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from quanta_tpu_torch import calib


class ByteTokenizer:
    """UTF-8 byte tokenizer: vocab of exactly 256, no special tokens."""

    vocab_size = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        return bytes(int(i) & 0xFF for i in np.asarray(ids).ravel()).decode(
            "utf-8", errors="replace")


class HFTokenizer:
    """Thin wrapper over a ``tokenizers.Tokenizer`` file."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str) -> np.ndarray:
        return np.asarray(self._tok.encode(text).ids, dtype=np.int32)

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in np.asarray(ids).ravel()])


def load_tokenizer(model_dir: Optional[str] = None):
    """HF tokenizer from ``model_dir/tokenizer.json`` if present, else bytes."""
    if model_dir:
        p = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(p):
            return HFTokenizer(p)
    return ByteTokenizer()


def _window(tokens: np.ndarray, seq_len: int):
    """Split a flat stream into (n, seq_len+1) windows + a target mask.

    Consecutive non-overlapping windows (stride = seq_len): every token in
    the stream is predicted exactly once, except the very first.
    """
    tokens = np.asarray(tokens, np.int32).ravel()
    n_pred = len(tokens) - 1
    if n_pred < 1:
        raise ValueError("need at least 2 tokens")
    n_win = -(-n_pred // seq_len)
    padded = np.zeros(n_win * seq_len + 1, np.int32)
    padded[: len(tokens)] = tokens
    windows = np.stack(
        [padded[i * seq_len: i * seq_len + seq_len + 1] for i in range(n_win)])
    mask = np.zeros((n_win, seq_len), np.float32)
    mask.ravel()[:n_pred] = 1.0
    return windows, mask


@torch.inference_mode()
def perplexity(
    params,
    tokens,
    cfg,
    *,
    forward: Optional[Callable] = None,
    seq_len: int = 256,
    batch: int = 8,
    use_kernel=None,
) -> float:
    """Perplexity of a causal LM over a flat token stream.

    ``forward(params, tokens, cfg, use_kernel=...) -> (logits, _)``;
    defaults to the Llama forward. Windows are non-overlapping; the ragged
    tail is masked.
    """
    if forward is None:
        from quanta_tpu_torch.models import llama

        forward = llama.forward

    dev = calib.tree_device(params)
    windows, mask = _window(tokens, seq_len)
    n_win = windows.shape[0]
    n_batches = -(-n_win // batch)
    pad = n_batches * batch - n_win
    if pad:
        windows = np.concatenate([windows, np.zeros((pad, seq_len + 1), np.int32)])
        mask = np.concatenate([mask, np.zeros((pad, seq_len), np.float32)])
    windows_t = torch.from_numpy(windows).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)

    sums = []
    for i in range(n_batches):
        win = windows_t[i * batch:(i + 1) * batch]
        msk = mask_t[i * batch:(i + 1) * batch]
        logits, _ = forward(params, win[:, :-1], cfg, use_kernel=use_kernel)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, win[:, 1:, None].long())[..., 0]
        sums.append(torch.stack([-(ll * msk).sum(), msk.sum()]))
    # f32 sums per batch, added up in float64 on the host as the JAX
    # package adds its per-batch floats
    total_nll, total_n = 0.0, 0.0
    for nll, n in torch.stack(sums).cpu().tolist():
        total_nll += nll
        total_n += n
    return float(np.exp(total_nll / max(total_n, 1.0)))


def ppl_table(
    params_by_name: dict,
    tokens,
    cfg,
    *,
    forward: Optional[Callable] = None,
    baseline: str = "bf16",
    **kw,
) -> dict:
    """Perplexity for several parameter variants + delta vs the baseline.

    Returns {name: {"ppl": float, "delta": float}}.
    """
    out = {}
    for name, params in params_by_name.items():
        out[name] = {"ppl": perplexity(params, tokens, cfg, forward=forward, **kw)}
    base = out[baseline]["ppl"]
    for name in out:
        out[name]["delta"] = out[name]["ppl"] - base
    return out
