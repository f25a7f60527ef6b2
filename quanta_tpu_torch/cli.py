"""Command-line interface: quantize / eval / generate / serve / finetune /
bench / convert (port of ``quanta_tpu/cli.py``).

Every subcommand is a thin orchestration over the library layers. The
commands run on the CUDA device; ``--cpu`` asks for the CPU, and without a
CUDA device and without ``--cpu`` a command fails and says so.
Checkpoints are the JAX package's ``.npz`` format (``utils/serialization``)
with the model configuration beside them in ``<ckpt>.config.json``, so a
checkpoint written by either CLI is read by the other. ``--model`` reads
an HF checkpoint directory (Llama or GPT-2, ``models/hf.py``).

``bench`` runs a benchmark module (``headline`` is the decode bench, as
in the JAX CLI; ``kernels``, the default, is the kernel microbench).

Usage:  python -m quanta_tpu_torch <command> --help
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import runpy
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


TOY_PRESETS = {
    # vocab, dim, layers, heads, kv_heads, hidden, max_seq
    "tiny": (512, 256, 2, 8, 4, 512, 256),
    "small": (2048, 512, 4, 8, 8, 1024, 512),
    "tinyllama": (32000, 2048, 22, 32, 4, 5632, 2048),
}


def _device(args):
    import torch

    if getattr(args, "cpu", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("quanta_tpu_torch: no CUDA device found; pass --cpu to run on the CPU")
    return torch.device("cuda")


def _cfg_to_json(cfg, arch: str) -> dict:
    from quanta_tpu_torch.utils.serialization import dtype_name

    d = dataclasses.asdict(cfg)
    d["dtype"] = dtype_name(d["dtype"])
    d["__arch__"] = arch
    return d


def _cfg_from_json(d: dict):
    from quanta_tpu_torch.interop import to_torch_dtype

    d = dict(d)
    arch = d.pop("__arch__", "llama")
    d["dtype"] = to_torch_dtype(d["dtype"])
    if arch == "llama":
        from quanta_tpu_torch.models.llama import LlamaConfig

        return LlamaConfig(**d), arch
    from quanta_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(**d), arch


def load_model(args, device):
    """Resolve --model/--toy/--ckpt into (params, cfg, arch, model_dir)."""
    import torch

    from quanta_tpu_torch.interop import to_torch_dtype

    dtype = to_torch_dtype(args.dtype) if getattr(args, "dtype", None) else None
    if getattr(args, "ckpt", None):
        from quanta_tpu_torch.utils import serialization

        with open(args.ckpt + ".config.json") as f:
            cfg, arch = _cfg_from_json(json.load(f))
        params = serialization.load_checkpoint(args.ckpt, device=device)
        return params, cfg, arch, getattr(args, "model", None)
    if getattr(args, "model", None):
        from quanta_tpu_torch.models import hf

        with open(os.path.join(args.model, "config.json")) as f:
            mt = json.load(f).get("model_type", "llama")
        if mt == "gpt2":
            params, cfg = hf.load_gpt2(args.model, dtype=dtype or torch.float32, device=device)
            return params, cfg, "gpt2", args.model
        params, cfg = hf.load_llama(args.model, dtype=dtype or torch.bfloat16, device=device)
        return params, cfg, "llama", args.model
    # toy preset (random init): demos, smoke runs and the TinyLlama geometry
    from quanta_tpu_torch.models import llama

    v, d, n_layers, h, kv, hid, s = TOY_PRESETS[args.toy]
    cfg = llama.LlamaConfig(vocab_size=v, dim=d, n_layers=n_layers, n_heads=h, n_kv_heads=kv,
                            hidden_dim=hid, max_seq_len=s, dtype=dtype or torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return llama.init_params(gen, cfg, device=device), cfg, "llama", None


def _forward_for(arch: str):
    if arch == "gpt2":
        from quanta_tpu_torch.models import gpt2

        return gpt2.forward
    from quanta_tpu_torch.models import llama

    return llama.forward


def _add_model_args(p, ckpt=True):
    p.add_argument("--model", help="HF checkpoint dir (safetensors)")
    if ckpt:
        p.add_argument("--ckpt", help=".npz checkpoint (from `quantize`)")
    p.add_argument("--toy", choices=sorted(TOY_PRESETS), default="tiny",
                   help="random-init preset when no --model/--ckpt")
    p.add_argument("--dtype", default=None, help="compute dtype (bfloat16/float32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")


def _tokens_from_text(path: str, model_dir):
    import numpy as np

    from quanta_tpu_torch import eval as qeval

    tok = qeval.load_tokenizer(model_dir)
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    return np.asarray(tok.encode(text), np.int32), tok


def _norm_npz(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; normalize up front so
    the name reported (and later opened) is the name written."""
    return path if path.endswith(".npz") else path + ".npz"


def _nbytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_nbytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


# -------------------------------------------------------------- commands


def cmd_quantize(args):
    import torch

    from quanta_tpu_torch import ptq
    from quanta_tpu_torch.state.config import ConfigTree, QuantConfig
    from quanta_tpu_torch.utils import serialization

    dev = _device(args)
    args.out = _norm_npz(args.out)
    params, cfg, arch, model_dir = load_model(args, dev)
    n_bytes_in = _nbytes(params)
    if args.config:
        tree = ConfigTree.load(args.config)
    else:
        tree = ConfigTree(default=QuantConfig.from_mode(args.fmt, block_size=args.block_size))
    calib_kw = {}
    if args.calib_text:
        toks, _ = _tokens_from_text(args.calib_text, model_dir)
        seq = min(256, cfg.max_seq_len)
        n = min(args.calib_batches, max(1, len(toks) // seq))
        batches = [torch.from_numpy(toks[i * seq:(i + 1) * seq][None, :]).to(dev)
                   for i in range(n)]
        fwd = _forward_for(arch)
        calib_kw = dict(forward=lambda p, b: fwd(p, b, cfg)[0], calib_batches=batches)
        log(f"calibrating on {n} x {seq}-token batches from {args.calib_text}")
    qparams = ptq.quantize_model(params, tree, **calib_kw)
    serialization.save_checkpoint(qparams, args.out)
    with open(args.out + ".config.json", "w") as f:
        json.dump(_cfg_to_json(cfg, arch), f, indent=1)
    n_bytes_out = os.path.getsize(args.out)
    log(f"saved {args.out}: {n_bytes_in / 1e6:.1f} MB dense -> "
        f"{n_bytes_out / 1e6:.1f} MB ({n_bytes_in / max(n_bytes_out, 1):.2f}x)")


def cmd_eval(args):
    from quanta_tpu_torch import eval as qeval

    dev = _device(args)
    params, cfg, arch, model_dir = load_model(args, dev)
    tokens, _ = _tokens_from_text(args.text, model_dir)
    ppl = qeval.perplexity(params, tokens, cfg, forward=_forward_for(arch),
                           seq_len=min(args.seq_len, cfg.max_seq_len - 1), batch=args.batch)
    print(json.dumps({"perplexity": round(ppl, 4), "tokens": int(len(tokens))}))


def cmd_generate(args):
    import numpy as np
    import torch

    from quanta_tpu_torch import eval as qeval
    from quanta_tpu_torch.models import llama

    dev = _device(args)
    params, cfg, arch, model_dir = load_model(args, dev)
    if arch != "llama":
        raise SystemExit("generate currently drives the Llama decode loop")
    tok = qeval.load_tokenizer(model_dir)
    ids = torch.from_numpy(np.asarray(tok.encode(args.prompt), np.int32)[None, :]).to(dev)
    t0 = time.perf_counter()
    out = llama.greedy_decode(params, ids, cfg, max_new_tokens=args.max_new_tokens)
    new = out[0, ids.shape[1]:].cpu().numpy()
    dt = time.perf_counter() - t0
    print(tok.decode(new.tolist()))
    log(f"{len(new)} tokens in {dt:.2f}s ({len(new) / dt:.1f} tok/s)")


def cmd_serve(args):
    import numpy as np

    from quanta_tpu_torch import eval as qeval
    from quanta_tpu_torch.serve.engine import Engine, Request

    dev = _device(args)
    params, cfg, arch, model_dir = load_model(args, dev)
    if arch != "llama":
        raise SystemExit("serve currently drives the Llama decode loop")
    tok = qeval.load_tokenizer(model_dir)
    if args.prompts:
        with open(args.prompts) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        prompts = [f"request {i}: the quick brown fox" for i in range(args.n)]
    eng = Engine(params, cfg, n_slots=args.slots, page_size=args.page_size,
                 multi_step=args.multi_step, pipeline_depth=args.pipeline_depth,
                 kv_quant=args.kv_quant)
    reqs = [Request(uid=i, prompt=np.asarray(tok.encode(p), np.int32),
                    max_new_tokens=args.max_new_tokens) for i, p in enumerate(prompts)]
    done = eng.run(reqs)
    ttfts = sorted(1e3 * (r.t_first_token - r.t_arrival) for r in done)
    n_tok = sum(len(r.output) for r in done)
    print(json.dumps({
        "requests": len(done),
        "decode_tokens": n_tok,
        "p50_ttft_ms": round(ttfts[len(ttfts) // 2], 2),
        "p99_ttft_ms": round(ttfts[min(len(ttfts) - 1, int(len(ttfts) * .99))], 2),
        "throughput_tok_s": round(n_tok / max(eng._t_serve, 1e-9), 1),
    }))
    for r in done[: args.show]:
        log(f"[{r.uid}] {tok.decode(r.output)!r}")


def cmd_finetune(args):
    import numpy as np
    import torch

    from quanta_tpu_torch import nn as qnn
    from quanta_tpu_torch import train
    from quanta_tpu_torch.optim import Adam8bit
    from quanta_tpu_torch.utils import serialization

    dev = _device(args)
    args.out = _norm_npz(args.out)
    params, cfg, arch, model_dir = load_model(args, dev)
    if arch != "llama":
        raise SystemExit("finetune currently drives the Llama train step")
    if not getattr(args, "ckpt", None):
        params = qnn.quantize_params(params, mode=args.fmt, block_size=args.block_size)
    params = train.add_lora(params, torch.Generator(device=dev).manual_seed(args.seed + 1),
                            rank=args.rank, device=dev)
    tokens, _ = _tokens_from_text(args.text, model_dir)
    seq = min(args.seq_len, cfg.max_seq_len - 1)
    n_win = max(1, (len(tokens) - 1) // seq)
    wins = np.stack([tokens[i * seq:i * seq + seq + 1] for i in range(n_win)])

    opt = Adam8bit(qnn.lora_parameters(params), lr=args.lr)
    step = train.make_qlora_train_step(cfg, opt)
    rng = np.random.default_rng(args.seed)
    for i in range(args.steps):
        b = torch.from_numpy(wins[rng.integers(0, n_win, size=args.batch)]).to(dev).long()
        loss = step(params, {"inputs": b[:, :-1], "targets": b[:, 1:]})
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            log(f"step {i:4d}  loss {loss.item():.4f}")
    serialization.save_checkpoint(train.extract_adapters(params), args.out)
    log(f"saved LoRA adapters -> {args.out}")


_BENCHES = {"headline": "quanta_tpu_torch.benchmarks.decode_bench",
            "decode": "quanta_tpu_torch.benchmarks.decode_bench",
            "kernels": "quanta_tpu_torch.benchmarks.kernel_bench",
            "accuracy": "quanta_tpu_torch.benchmarks.accuracy_bench",
            "serve": "quanta_tpu_torch.benchmarks.serve_bench"}


def cmd_bench(args):
    mod = _BENCHES[args.kind]
    sys.argv = [mod.rsplit(".", 1)[-1], *(["--cpu"] if args.cpu else [])]
    runpy.run_module(mod, run_name="__main__")


def cmd_convert(args):
    from quanta_tpu_torch.state.config import QuantConfig
    from quanta_tpu_torch.utils import convert, serialization

    qt = serialization.load_quantized_tensor(args.src, device=_device(args))
    if args.transcode:
        # same-bit-width codebook remap (no fp round trip): the imported
        # QLoRA path, exact NF4 -> nf4a
        out = convert.transcode_codebook(qt, target=args.fmt)
    else:
        c = QuantConfig.from_mode(args.fmt, block_size=args.block_size)
        out = convert.convert_precision(qt, bits=c.bits, scheme=c.scheme, codebook=c.codebook,
                                        block_size=args.block_size)
    serialization.save_quantized_tensor(out, args.out)
    log(f"{args.src} ({qt.bits}-bit) -> {args.out} ({out.bits}-bit {args.fmt})")


# ----------------------------------------------------------------- parser


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="quanta_tpu_torch",
                                 description="quantized inference / QLoRA on a CUDA device")
    sub = ap.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize", help="PTQ a model and save a checkpoint")
    _add_model_args(q, ckpt=False)
    q.add_argument("--fmt", default="nf4a",
                   choices=["int8", "int4", "nf4", "nf4a", "nf8", "fp4", "fp8", "llm_int8",
                            "int4c", "int8a", "int4a"])
    q.add_argument("--block-size", type=int, default=64)
    q.add_argument("--config", help="ConfigTree JSON (three-tier rules)")
    q.add_argument("--calib-text", help="text file for activation calibration")
    q.add_argument("--calib-batches", type=int, default=8)
    q.add_argument("--out", required=True)
    q.set_defaults(fn=cmd_quantize)

    e = sub.add_parser("eval", help="perplexity over a text file")
    _add_model_args(e)
    e.add_argument("--text", required=True)
    e.add_argument("--seq-len", type=int, default=256)
    e.add_argument("--batch", type=int, default=8)
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("generate", help="greedy decode from a prompt")
    _add_model_args(g)
    g.add_argument("--prompt", required=True)
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="continuous-batching demo over a trace")
    _add_model_args(s)
    s.add_argument("--prompts", help="file with one prompt per line")
    s.add_argument("-n", type=int, default=16, help="synthetic request count")
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--page-size", type=int, default=16)
    s.add_argument("--multi-step", type=int, default=8,
                   help="decode-window length (tokens per dispatch)")
    s.add_argument("--pipeline-depth", type=int, default=2,
                   help="readbacks in flight behind the window")
    s.add_argument("--kv-quant", action="store_true",
                   help="int8 per-(token,head) quantized KV pool")
    s.add_argument("--max-new-tokens", type=int, default=32)
    s.add_argument("--show", type=int, default=0, help="print first N outputs")
    s.set_defaults(fn=cmd_serve)

    f = sub.add_parser("finetune", help="QLoRA fine-tune on a text file")
    _add_model_args(f)
    f.add_argument("--text", required=True)
    f.add_argument("--fmt", default="nf4a")
    f.add_argument("--block-size", type=int, default=64)
    f.add_argument("--rank", type=int, default=8)
    f.add_argument("--lr", type=float, default=1e-4)
    f.add_argument("--steps", type=int, default=50)
    f.add_argument("--batch", type=int, default=4)
    f.add_argument("--seq-len", type=int, default=128)
    f.add_argument("--out", default="lora_adapters.npz")
    f.set_defaults(fn=cmd_finetune)

    b = sub.add_parser("bench", help="run a benchmark")
    b.add_argument("kind", choices=list(_BENCHES), nargs="?", default="kernels")
    b.add_argument("--cpu", action="store_true", help="run on the CPU (accuracy only)")
    b.set_defaults(fn=cmd_bench)

    c = sub.add_parser("convert", help="precision-convert a .qtn / .npz tensor")
    c.add_argument("src")
    c.add_argument("--bits", type=int, required=True)
    c.add_argument("--fmt", default="nf4")
    c.add_argument("--block-size", type=int, default=64)
    c.add_argument("--transcode", action="store_true",
                   help="same-bit-width codebook remap (no fp round trip), e.g. imported "
                        "exact-NF4 -> nf4a")
    c.add_argument("--out", required=True)
    c.add_argument("--cpu", action="store_true")
    c.set_defaults(fn=cmd_convert)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
