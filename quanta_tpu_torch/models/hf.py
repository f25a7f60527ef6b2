"""HuggingFace checkpoint interchange (port of quanta_tpu/models/hf.py).

Reads a standard HF model directory (``config.json`` and
``*.safetensors``) into the port's Llama and GPT-2 parameter trees, and
writes those trees back in the HF layout. The safetensors files are read
and written here, by the format's public layout (the huggingface/
safetensors README): an 8-byte little-endian header length, a JSON header
mapping each tensor name to its ``dtype``, ``shape`` and ``data_offsets``
(begin and end in the byte buffer that follows; an optional
``__metadata__`` maps strings to strings), then the raw little-endian
bytes. Neither ``safetensors`` nor ``transformers`` is needed.

Conventions:
  - HF ``nn.Linear`` stores (out_features, in_features); the port's
    linears are y = x @ W with W (in, out), so those transpose on load
    and on save.
  - GPT-2's ``Conv1D`` already stores (in, out): no transpose.
  - HF Llama's RoPE (half-split rotate_half) is ``llama._rope``'s, so q
    and k need no permutation.
  - Export writes f32 and materializes LoRA and quantized trees to dense
    weights first, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Tuple

import torch

# safetensors dtype tag <-> torch dtype (BF16 travels as its int16 bits)
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8}
_ST_TAGS = {dt: tag for tag, dt in _ST_DTYPES.items()}


def read_safetensors(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, on ``device`` (default: the CPU)."""
    tensors: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the port "
                                 f"does not read ({sorted(_ST_DTYPES)})")
            dtype = _ST_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            raw = bytearray(end - begin)  # its own buffer: aligned, writable
            f.seek(base + begin)
            if f.readinto(raw) != len(raw):
                raise ValueError(f"{path}: {name} runs past the end of the file")
            read_as = torch.int16 if dtype == torch.bfloat16 else dtype
            t = torch.frombuffer(raw, dtype=read_as) if raw else torch.empty(0, dtype=read_as)
            tensors[name] = t.view(dtype).reshape(info["shape"]).to(device)
    return tensors


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, contiguous or not) as one .safetensors
    file, in their own dtypes; the header is padded with spaces to a
    multiple of 8 bytes, as the safetensors library pads it."""
    header: Dict[str, dict] = {}
    flat = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _ST_TAGS:
            raise TypeError(f"{name}: safetensors has no tag for {t.dtype}")
        flat[name] = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        nb = flat[name].numel()
        header[name] = {"dtype": _ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nb]}
        offset += nb
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in flat.values():
            f.write(t.numpy())


def read_safetensors_dir(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of every *.safetensors file in an HF model directory."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname), device))
    return tensors


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# ------------------------------------------------------------------- Llama


def load_llama(path: str, dtype=torch.bfloat16, device=None) -> Tuple[dict, "object"]:
    """Load an HF Llama-family checkpoint (LlamaForCausalLM layout).

    Returns (params, LlamaConfig) for ``models.llama.forward`` and
    ``nn.quantize_params``, the tensors on ``device`` (default: the CPU).
    """
    from quanta_tpu_torch.models.llama import LlamaConfig

    hf = _read_config(path)
    cfg = LlamaConfig(
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        hidden_dim=hf["intermediate_size"],
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        max_seq_len=hf.get("max_position_embeddings", 2048),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        dtype=dtype,
    )
    t = read_safetensors_dir(path)

    def lin(name):  # HF Linear (out, in) -> ours (in, out)
        return t.pop(name).to(device=device, dtype=dtype).T.contiguous()

    def vec(name):
        return t.pop(name).to(device=device, dtype=dtype)

    params = {
        "tok_emb": vec("model.embed_tokens.weight"),
        "norm_f": vec("model.norm.weight"),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        params["layers"].append({
            "attn_norm": vec(p + "input_layernorm.weight"),
            "wq": lin(p + "self_attn.q_proj.weight"),
            "wk": lin(p + "self_attn.k_proj.weight"),
            "wv": lin(p + "self_attn.v_proj.weight"),
            "wo": lin(p + "self_attn.o_proj.weight"),
            "ffn_norm": vec(p + "post_attention_layernorm.weight"),
            "w_gate": lin(p + "mlp.gate_proj.weight"),
            "w_up": lin(p + "mlp.up_proj.weight"),
            "w_down": lin(p + "mlp.down_proj.weight"),
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = lin("lm_head.weight")
    else:
        t.pop("lm_head.weight", None)
    _warn_unused(t)
    return params, cfg


# ------------------------------------------------------------------- GPT-2


def load_gpt2(path: str, dtype=torch.float32, device=None) -> Tuple[dict, "object"]:
    """Load an HF GPT-2 checkpoint (GPT2LMHeadModel layout).

    Returns (params, GPT2Config) for ``models.gpt2.forward``, the tensors
    on ``device`` (default: the CPU).
    """
    from quanta_tpu_torch.models.gpt2 import GPT2Config

    hf = _read_config(path)
    cfg = GPT2Config(
        vocab_size=hf["vocab_size"],
        dim=hf["n_embd"],
        n_layers=hf["n_layer"],
        n_heads=hf["n_head"],
        max_seq_len=hf.get("n_positions", 1024),
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        dtype=dtype,
    )
    t = read_safetensors_dir(path)
    pre = "transformer." if any(k.startswith("transformer.") for k in t) else ""

    def arr(name):  # GPT-2 Conv1D already stores (in, out)
        return t.pop(pre + name).to(device=device, dtype=dtype)

    def pair(name):
        return {"w": arr(name + ".weight"), "b": arr(name + ".bias")}

    params = {"wte": arr("wte.weight"), "wpe": arr("wpe.weight"), "ln_f": pair("ln_f"),
              "layers": []}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        params["layers"].append({
            "ln_1": pair(p + "ln_1"),
            "attn_qkv": pair(p + "attn.c_attn"),
            "attn_out": pair(p + "attn.c_proj"),
            "ln_2": pair(p + "ln_2"),
            "mlp_fc": pair(p + "mlp.c_fc"),
            "mlp_out": pair(p + "mlp.c_proj"),
        })
    t.pop("lm_head.weight", None)  # tied to wte
    for k in list(t):  # attn.bias buffers are causal masks, not parameters
        if k.endswith("attn.bias") or k.endswith("attn.masked_bias"):
            t.pop(k)
    _warn_unused(t)
    return params, cfg


# ------------------------------------------------------------------ export


def _materialize(params):
    """A dense tree from any of the port's trees: LoRA adapters merged into
    their (possibly quantized) bases, quantized leaves dequantized."""
    from quanta_tpu_torch.calib import _map_with_path
    from quanta_tpu_torch.nn import dequantize_params
    from quanta_tpu_torch.nn.lora import LoRAWeight, merge_lora

    params = _map_with_path(
        lambda _path, leaf: merge_lora(leaf) if isinstance(leaf, LoRAWeight) else leaf,
        params, is_leaf=lambda x: isinstance(x, LoRAWeight))
    return dequantize_params(params)


def _f32(w) -> torch.Tensor:
    return w.detach().to(device="cpu", dtype=torch.float32)


def save_llama(params, cfg, path: str) -> None:
    """Write a Llama tree in the HF LlamaForCausalLM layout (config.json and
    model.safetensors, f32): the inverse of :func:`load_llama`. Quantized
    and LoRA trees are materialized to dense weights first, so fine-tuned
    and PTQ'd models leave the port and load in transformers."""
    params = _materialize(params)
    os.makedirs(path, exist_ok=True)
    t: Dict[str, torch.Tensor] = {}

    def put_lin(name, w):  # ours (in, out) -> HF Linear (out, in)
        t[name] = _f32(w).T

    def put_vec(name, w):
        t[name] = _f32(w)

    put_vec("model.embed_tokens.weight", params["tok_emb"])
    put_vec("model.norm.weight", params["norm_f"])
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        put_vec(p + "input_layernorm.weight", lp["attn_norm"])
        put_lin(p + "self_attn.q_proj.weight", lp["wq"])
        put_lin(p + "self_attn.k_proj.weight", lp["wk"])
        put_lin(p + "self_attn.v_proj.weight", lp["wv"])
        put_lin(p + "self_attn.o_proj.weight", lp["wo"])
        put_vec(p + "post_attention_layernorm.weight", lp["ffn_norm"])
        put_lin(p + "mlp.gate_proj.weight", lp["w_gate"])
        put_lin(p + "mlp.up_proj.weight", lp["w_up"])
        put_lin(p + "mlp.down_proj.weight", lp["w_down"])
    if not cfg.tie_embeddings:
        put_lin("lm_head.weight", params["lm_head"])
    write_safetensors(t, os.path.join(path, "model.safetensors"))

    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.hidden_dim,
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "hidden_act": "silu",
        "attention_bias": False,
        "torch_dtype": "float32",
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)


def save_gpt2(params, cfg, path: str) -> None:
    """Inverse of :func:`load_gpt2`: the HF GPT2LMHeadModel layout, f32."""
    params = _materialize(params)
    os.makedirs(path, exist_ok=True)
    t: Dict[str, torch.Tensor] = {}

    def put(name, w):  # GPT-2 Conv1D stores (in, out): no transpose
        t["transformer." + name] = _f32(w)

    put("wte.weight", params["wte"])
    put("wpe.weight", params["wpe"])
    put("ln_f.weight", params["ln_f"]["w"])
    put("ln_f.bias", params["ln_f"]["b"])
    for i, lp in enumerate(params["layers"]):
        p = f"h.{i}."
        for ours, theirs in (("ln_1", "ln_1"), ("ln_2", "ln_2"), ("attn_qkv", "attn.c_attn"),
                             ("attn_out", "attn.c_proj"), ("mlp_fc", "mlp.c_fc"),
                             ("mlp_out", "mlp.c_proj")):
            put(p + theirs + ".weight", lp[ours]["w"])
            put(p + theirs + ".bias", lp[ours]["b"])
    t["lm_head.weight"] = _f32(params["wte"])
    write_safetensors(t, os.path.join(path, "model.safetensors"))

    hf_cfg = {
        "architectures": ["GPT2LMHeadModel"],
        "model_type": "gpt2",
        "vocab_size": cfg.vocab_size,
        "n_embd": cfg.dim,
        "n_layer": cfg.n_layers,
        "n_head": cfg.n_heads,
        "n_positions": cfg.max_seq_len,
        "n_ctx": cfg.max_seq_len,
        "layer_norm_epsilon": cfg.norm_eps,
        "attn_pdrop": 0.0,
        "embd_pdrop": 0.0,
        "resid_pdrop": 0.0,
        "torch_dtype": "float32",
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)


def _warn_unused(t: Dict[str, torch.Tensor]) -> None:
    if t:
        print(f"quanta_tpu_torch.models.hf: {len(t)} unused checkpoint tensors: "
              f"{sorted(t)[:8]}{'...' if len(t) > 8 else ''}", file=sys.stderr)
