"""Time the f32 flash backward kernels, dQ and dK/dV, at Gemma-2B's
geometry's s1024 shape (B 2, S = T = 1024, 8 query heads to one KV head,
hd 256: the 256-column kernels), with their largest error against the
plain versions over max|plain| and their registers and spill bytes a
thread: one JSON line, tagged with the first argument.

    python quanta_tpu_torch/benchmarks/flash_bwd_variant.py TAG

Run as a file with a checkout, or a copy of the package whose kernel
source was edited, first on ``PYTHONPATH`` to time that copy's kernels
(it calls nothing newer than the flash wrappers and their design report);
compare copies in turns (A, B, B, A) within one call on one card. Needs a
CUDA card.
"""

import json
import sys

import torch

from quanta_tpu_torch.benchmarks.kernel_bench import time_ms
from quanta_tpu_torch.ops import attention


def main(tag: str) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, nh, nkv, hd = 2, 1024, 8, 1, 256
    q, do = (torch.randn((b, s, nh, hd), generator=gen, device=dev) for _ in range(2))
    k, v = (torch.randn((b, s, nkv, hd), generator=gen, device=dev) for _ in range(2))
    pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    ref, lse = attention.flash_forward_reference(q, k, v, pos, pos + s)
    delta = (do * ref).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, pos, pos + s)
    got = (attention.flash_bwd_dq(*bwd), *attention.flash_bwd_dkv(*bwd))
    want = (attention.flash_bwd_dq_reference(*bwd), *attention.flash_bwd_dkv_reference(*bwd))
    err = {n: ((x - y).abs().max() / y.abs().max()).item()
           for n, x, y in zip(("dq", "dk", "dv"), got, want)}
    design = {n: attention.flash_bwd_design(n, b, s, s, nh, nkv, hd, dtype=torch.float32)
              for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    print(json.dumps(dict(var=tag, rel_err=err,
                          dq_ms=time_ms(lambda i: attention.flash_bwd_dq(*bwd), 30),
                          dkv_ms=time_ms(lambda i: attention.flash_bwd_dkv(*bwd), 30),
                          regs={n: (d["registers"], d["spill_bytes"]) for n, d in design.items()})),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "?")
