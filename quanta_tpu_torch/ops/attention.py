"""Causal GQA flash attention, forward and backward: CUDA kernel wrappers
and their plain versions.

Port of ``quanta_tpu/ops/attention.py``. The kernels are
``csrc/flash_fwd.cu`` (the Pallas ``_flash_kernel``) and
``csrc/flash_bwd.cu`` and, their f32 route, ``csrc/flash_bwd_f32.cu``
(``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``); each source
says what bounds it on the H100
and how it is laid out. The bf16 kernels are built for Hopper (warpgroup
products with the scores kept in registers, cp.async tile rings;
``csrc/sm90.cuh``): the forward's blocks share each staged K/V tile
between two 64-row query tiles, the backward splits dK/dV over
thread-block clusters. At 256 columns (head dims 129-256) the bf16 forward
and dK/dV kernels are warp-specialised (``csrc/ws_sm90.cuh``): a producer
warpgroup streams the tiles by TMA through mbarrier rings to two consumer
warpgroups. The f32 kernels run each f32 product as three TF32
warpgroup products (``csrc/flash_tf32x3.cuh``); the f32 forward keeps p
in registers, as the bf16 one does. At 256 columns the f32 dQ and dK/dV
kernels split hd over the two blocks of a cluster, which sum their S and
dP partials through distributed shared memory. Every kernel, in either route, is
deterministic: two calls give the same bits. :func:`flash_fwd_design` and :func:`flash_bwd_design`
report how they launch.

Layouts are the JAX package's: q ``(B, Sq, nh, hd)``, k and v ``(B, T,
nkv, hd)`` with ``nh % nkv == 0`` (query head h reads KV head ``h // (nh /
nkv)``), ``q_start`` and ``kv_len`` ``(B,)`` int. Query row i of batch row
b sits at position ``q_start[b] + i`` and attends the keys j with ``j <
kv_len[b]`` (clamped to T) and, when causal, ``j <= q_start[b] + i``. A row
with no such key gives zeros, where the einsum attention of
``models/llama.py`` would average V uniformly. The logsumexp is ``(B, nh,
Sq)`` f32, 1e30 on those rows, so the backward's ``exp(s - lse)`` is 0
there. The TPU kernels' tile sizes, interpret mode and 8-lane statistics
layout are not ported.

Dispatch: ``use_kernel=None`` means the kernels for CUDA tensors and the
plain versions for CPU ones; ``True`` on a CPU tensor raises; ``False``
runs the plain versions anywhere. A CUDA tensor never falls back to the
plain versions on its own. The kernels take bf16 or f32 and any head_dim
from 1 to 256, as the TPU kernels do (:func:`kernel_takes`); each is
compiled for 32, 64, 128 and 256 columns (the 256 ones in sources of their
own, ``csrc/*_w256.cu``, entry points ending in ``_w256``), and a head_dim
runs in the smallest that holds it (:func:`padded_head_dim`), its extra
columns zero, at the scale of its own head_dim. A head_dim that is not a
multiple of 4 would leave rows off the kernels' 8- and 16-byte copies, so
the wrapper pads it with zero columns to the next multiple of 8 before the
launch and slices the outputs back (:func:`kernel_head_dim`), as the TPU
kernel pads the sequence on its host; so too a bf16 head_dim above 128
that is 4 mod 8 (e.g. 132): the 256-column kernels' TMA copies need rows
of a multiple of 16 bytes. Anything else (a head_dim above 256,
another dtype) raises a ``ValueError`` on the kernel route.
``flash_attention`` is differentiable in q, k and v through
``_FlashAttention``, whose backward computes ``D = rowsum(dO * O)`` in
plain torch and then runs the dQ and the dK/dV kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops.matmul import _aligned

PADDED_HEAD_DIMS = (32, 64, 128, 256)  # the widths the kernels are compiled for
DEAD_LSE = 1e30  # logsumexp of a row with no live key
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_TAKES = "head_dim from 1 to 256"


def kernel_head_dim(hd: int, dtype: torch.dtype | None = None) -> int:
    """The head_dim the kernels see: hd where it is a multiple of 4, else
    the next multiple of 8 (the wrapper's zero columns). For bf16 above 128
    columns, where the kernels load by TMA, a multiple of 8 as well."""
    tma = dtype == torch.bfloat16 and hd > PADDED_HEAD_DIMS[-2]
    return hd if hd % (8 if tma else 4) == 0 else -(-hd // 8) * 8


def padded_head_dim(hd: int) -> int:
    """The compiled width a head_dim runs in: the smallest of
    ``PADDED_HEAD_DIMS`` that holds it (0 where none does)."""
    if hd <= 0:
        return 0
    return next((p for p in PADDED_HEAD_DIMS if kernel_head_dim(hd) <= p), 0)


def kernel_takes(hd: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernels take this head_dim and dtype: bf16 or f32,
    head_dim from 1 to 256. ``llama.forward(use_flash=None)`` picks flash on
    CUDA only where they do."""
    return dtype in _SUFFIX and padded_head_dim(hd) > 0


def _check(q, k, v, q_start, kv_len):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, Sq, nh, hd) and k, v (B, T, nkv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, nh, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or nh % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q_start.shape != (b,) or kv_len.shape != (b,):
        raise ValueError(f"flash_attention: q_start and kv_len must be ({b},)")


def _entry(name, padded):
    """The C entry point of a kernel (e.g. ``flash_fwd_bf16``) at a compiled width."""
    return f"qt_{name}" + ("_w256" if padded == 256 else "")


def _kernel_args(name, q, *tensors):
    """The C entry point for q's dtype and head_dim, after the checks the
    kernels need."""
    suffix = _SUFFIX.get(q.dtype)
    if suffix is None:
        raise ValueError(f"{name}: the CUDA kernels take bf16 or f32, got {q.dtype}")
    padded = padded_head_dim(q.shape[-1])
    if not padded:
        raise ValueError(f"{name}: the CUDA kernels take {_TAKES}, got head_dim {q.shape[-1]}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: every operand must be on {q.device}")
    return _entry(f"{name}_{suffix}", padded)


def _to_kernel(x, dtype):
    """x in the kernels' dtype and layout, its head_dim zero-padded to
    :func:`kernel_head_dim`."""
    x = x.to(dtype)
    pad = kernel_head_dim(x.shape[-1], dtype) - x.shape[-1]
    return _aligned(torch.nn.functional.pad(x, (0, pad)) if pad else x)


def _positions(q, k, q_start, kv_len):
    return (q_start.to(device=q.device, dtype=torch.int32).contiguous(),
            torch.clamp(kv_len.to(device=q.device, dtype=torch.int32), max=k.shape[1]))


def _grouped(x, nkv):
    """(B, S, nh, hd) -> (B, S, nkv, rep, hd) in f32."""
    b, s, nh, hd = x.shape
    return x.float().reshape(b, s, nkv, nh // nkv, hd)


def _scores(q, k, q_start, kv_len, causal):
    """f32 scores ``(q . k) * scale`` as (B, nkv, rep, Sq, T) and the live
    mask (B, 1, 1, Sq, T). f32 products of the operands (TF32 must be off on
    CUDA), as the kernels' f32 sums of exact products."""
    b, sq, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    q_start, kv_len = _positions(q, k, q_start, kv_len)
    s = torch.einsum("bsgrd,btgd->bgrst", _grouped(q, nkv), k.float()) * (1.0 / math.sqrt(hd))
    kv_pos = torch.arange(t, device=q.device)
    live = kv_pos[None, None, :] < kv_len[:, None, None]
    if causal:
        q_pos = q_start[:, None] + torch.arange(sq, device=q.device, dtype=torch.int32)
        live = live & (kv_pos[None, None, :] <= q_pos[:, :, None])
    return s, live[:, None, None]


def flash_forward_reference(q, k, v, q_start, kv_len, *, causal=True):
    """Plain version of the forward kernel: (out in q's dtype, lse (B, nh,
    Sq) f32). p = exp(s - max) is rounded to q's dtype before p @ v, as the
    kernel rounds it (there per key tile, against the running max)."""
    b, sq, nh, hd = q.shape
    s, live = _scores(q, k, q_start, kv_len, causal)
    m = torch.where(live, s, -torch.inf).amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrst,btgd->bgrsd", p.to(q.dtype).float(), v.float())
    out = torch.where(l > 0, out / l, 0.0)
    lse = torch.where(l > 0, m + torch.log(l), DEAD_LSE)[..., 0]
    out = out.reshape(b, nh, sq, hd).transpose(1, 2).contiguous().to(q.dtype)
    return out, lse.reshape(b, nh, sq)


def _recompute(q, k, v, do, lse, delta, q_start, kv_len, causal):
    """The backward's p and ds (B, nkv, rep, Sq, T) f32, each rounded to
    q's dtype as the kernels round them before their products."""
    b, sq, nh, hd = q.shape
    nkv = k.shape[2]
    s, live = _scores(q, k, q_start, kv_len, causal)
    shape = (b, nkv, nh // nkv, sq, 1)
    p = torch.where(live, torch.exp(s - lse.reshape(shape)), 0.0)
    dp = torch.einsum("bsgrd,btgd->bgrst", _grouped(do, nkv), v.float())
    ds = p * (dp - delta.reshape(shape)) * (1.0 / math.sqrt(hd))
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dq_reference(q, k, v, do, lse, delta, q_start, kv_len, *, causal=True):
    """Plain version of the dQ kernel: dq = ds @ k, f32 (B, Sq, nh, hd)."""
    b, sq, nh, hd = q.shape
    _, ds = _recompute(q, k, v, do, lse, delta, q_start, kv_len, causal)
    return torch.einsum("bgrst,btgd->bsgrd", ds, k.float()).reshape(b, sq, nh, hd)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, q_start, kv_len, *, causal=True):
    """Plain version of the dK/dV kernel: (dk = ds^T q, dv = p^T dO), f32
    (B, T, nkv, hd), summed over the rep query heads of each KV head."""
    nkv = k.shape[2]
    p, ds = _recompute(q, k, v, do, lse, delta, q_start, kv_len, causal)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, _grouped(q, nkv))
    dv = torch.einsum("bgrst,bsgrd->btgd", p, _grouped(do, nkv))
    return dk, dv


def _sizes(q, k, causal):
    """The kernels' size arguments: their head_dim (:func:`kernel_head_dim`)
    and the scale of q's own."""
    b, sq, nh, hd = q.shape
    return (b, sq, k.shape[1], nh, k.shape[2], kernel_head_dim(hd, q.dtype), int(causal),
            1.0 / math.sqrt(hd))


def flash_forward(q, k, v, q_start, kv_len, *, causal=True, save_lse=False, use_kernel=None):
    """The forward: out in q's dtype and, with ``save_lse``, lse (B, nh, Sq)
    f32 (else None). The kernel route raises under autograd (use
    ``flash_attention``)."""
    _check(q, k, v, q_start, kv_len)
    if not _build.use_kernel_for(use_kernel, q):
        out, lse = flash_forward_reference(q, k, v, q_start, kv_len, causal=causal)
        return out, lse if save_lse else None
    for x in (q, k, v):
        _build.refuse_grad(x, "flash_fwd", "differentiate through flash_attention")
    entry = _kernel_args("flash_fwd", q, k, v, q_start, kv_len)
    sizes = _sizes(q, k, causal)
    q_start, kv_len = _positions(q, k, q_start, kv_len)
    hd = q.shape[-1]
    q, k, v = (_to_kernel(x, q.dtype) for x in (q, k, v))
    b, sq, nh, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, sq), dtype=torch.float32, device=q.device) if save_lse else None
    rc = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), *sizes,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_fwd")
    _build.launches["flash_fwd"] += 1
    return _own_hd(out, hd), lse


def _bwd_launch(name, q, k, v, do, lse, delta, q_start, kv_len, causal, outs):
    _check(q, k, v, q_start, kv_len)
    b, sq, nh, _ = q.shape
    if do.shape != q.shape or lse.shape != (b, nh, sq) or delta.shape != (b, nh, sq):
        raise ValueError(f"{name}: dO must be q's shape and lse, D ({b}, {nh}, {sq}); got "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}")
    entry = _kernel_args(name, q, k, v, do, lse, delta, q_start, kv_len)
    q_start, kv_len = _positions(q, k, q_start, kv_len)
    args = [*(_to_kernel(t, q.dtype) for t in (q, k, v, do)), _aligned(lse.float()),
            _aligned(delta.float())]
    rc = getattr(_build.library(), entry)(
        *(t.data_ptr() for t in args), q_start.data_ptr(), kv_len.data_ptr(),
        *(o.data_ptr() for o in outs), *_sizes(q, k, causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    _build.launches[name] += 1


def _grad_out(shape, q):
    """An f32 gradient of the kernels' head_dim for q's operands, for
    ``shape`` (..., hd)."""
    return torch.empty((*shape[:-1], kernel_head_dim(shape[-1], q.dtype)), dtype=torch.float32,
                       device=q.device)


def _own_hd(x, hd):
    """x's first hd columns (a view), where the kernels padded them."""
    return x[..., :hd] if x.shape[-1] != hd else x


def flash_bwd_dq(q, k, v, do, lse, delta, q_start, kv_len, *, causal=True, use_kernel=None):
    """dq (B, Sq, nh, hd) f32 from the forward's lse and D = rowsum(dO * O)
    (both (B, nh, Sq) f32)."""
    if not _build.use_kernel_for(use_kernel, q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, q_start, kv_len, causal=causal)
    dq = _grad_out(q.shape, q)
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, q_start, kv_len, causal, [dq])
    return _own_hd(dq, q.shape[-1])


def flash_bwd_dkv(q, k, v, do, lse, delta, q_start, kv_len, *, causal=True, use_kernel=None):
    """(dk, dv), each (B, T, nkv, hd) f32, from the same inputs as dq."""
    if not _build.use_kernel_for(use_kernel, q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, q_start, kv_len, causal=causal)
    dk, dv = _grad_out(k.shape, q), _grad_out(k.shape, q)
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, q_start, kv_len, causal, [dk, dv])
    return _own_hd(dk, q.shape[-1]), _own_hd(dv, q.shape[-1])


_DESIGN_KEYS = ("grid_x", "grid_y", "grid_z", "cluster", "blocks_per_sm", "registers",
                "shared_bytes", "spill_bytes", "sms", "stages", "warpgroups", "threads")
_FWD_DESIGN_KEYS = ("grid_x", "grid_y", "grid_z", "warpgroups", "blocks_per_sm", "registers",
                    "shared_bytes", "spill_bytes", "sms", "stages", "threads")


def _design_check(name, hd, dtype):
    if dtype not in _SUFFIX:
        raise ValueError(f"{name}: the CUDA kernels take bf16 or f32, got {dtype}")
    if not padded_head_dim(hd):
        raise ValueError(f"{name}: the CUDA kernels take {_TAKES}, got head_dim {hd}")
    return padded_head_dim(hd)


# the kernels that are warp-specialised at 256 columns in bf16
_WS_KERNELS = ("flash_fwd", "flash_bwd_dkv")
# the f32 kernels whose two blocks of a cluster split hd at 256 columns
_SPLIT_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


def _design_name(name, padded, dtype):
    """"wgmma_3xtf32" (f32), "wgmma_3xtf32_split" (the f32 dQ and dK/dV
    at 256 columns: a pair of blocks splits hd, summing S and dP through
    distributed shared memory), "wgmma_ws" (the bf16 forward and dK/dV at
    256 columns: a TMA producer warpgroup and two consumer warpgroups) or
    "wgmma"."""
    wide = padded == PADDED_HEAD_DIMS[-1]
    if dtype == torch.float32:
        return "wgmma_3xtf32_split" if wide and name in _SPLIT_KERNELS else "wgmma_3xtf32"
    return "wgmma_ws" if wide and name in _WS_KERNELS else "wgmma"


def flash_fwd_design(b, sq, nh, hd, dtype=torch.bfloat16):
    """How the forward kernel launches for ``dtype`` operands at this shape
    on this card: its grid, warpgroups a block (64 query rows each),
    blocks resident per SM, registers a thread, dynamic shared bytes a
    block and spill bytes a thread (from ``cudaFuncGetAttributes``), the
    SMs, its stages (bf16: the K/V ring's; f32: the split K/V buffers) and
    threads a block ("wgmma_ws": its producer warpgroup's too); ``design``
    "wgmma", "wgmma_ws" (bf16 at 256 columns) or "wgmma_3xtf32" (f32);
    ``padded_head_dim`` the compiled width the head_dim runs in (the kernel
    reported is that width's, padded where the two differ)."""
    padded = _design_check("flash_fwd", hd, dtype)
    f32 = dtype == torch.float32
    entry = _entry("flash_fwd_f32_design" if f32 else "flash_fwd_design", padded)
    out = (ctypes.c_int * len(_FWD_DESIGN_KEYS))()
    _build.check(getattr(_build.library(), entry)(kernel_head_dim(hd, dtype), b, sq, nh, out),
                 "flash_fwd")
    return {"design": _design_name("flash_fwd", padded, dtype), "padded_head_dim": padded,
            **dict(zip(_FWD_DESIGN_KEYS, out))}


def flash_bwd_design(name, b, sq, t, nh, nkv, hd, dtype=torch.bfloat16):
    """How the kernel ``name`` (``"flash_bwd_dq"`` or ``"flash_bwd_dkv"``)
    launches for ``dtype`` operands at this shape on this card: its grid,
    cluster size (dK/dV), blocks resident per SM, registers a thread,
    dynamic shared bytes a block and spill bytes a thread (from
    ``cudaFuncGetAttributes``), the SMs, the stages of its cp.async ring
    (f32: the slots of each warpgroup's; "wgmma_ws": its mbarrier ring's),
    its warpgroups and threads a block; ``design`` ("wgmma",
    "wgmma_ws", "wgmma_3xtf32" or, the f32 kernels at 256 columns,
    "wgmma_3xtf32_split") and ``padded_head_dim`` as for
    :func:`flash_fwd_design`."""
    padded = _design_check(name, hd, dtype)
    f32 = dtype == torch.float32
    entry = _entry("flash_bwd_f32_design" if f32 else "flash_bwd_design", padded)
    out = (ctypes.c_int * len(_DESIGN_KEYS))()
    rc = getattr(_build.library(), entry)(int(name == "flash_bwd_dkv"),
                                          kernel_head_dim(hd, dtype), b, sq, t, nh, nkv, out)
    _build.check(rc, name)
    return {"design": _design_name(name, padded, dtype), "padded_head_dim": padded,
            **dict(zip(_DESIGN_KEYS, out))}


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the recompute backward (``quanta_tpu/ops/
    attention.py``'s custom VJP): the forward saves out and lse, never the
    probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, kv_len, causal, use_kernel):
        out, lse = flash_forward(q, k, v, q_start, kv_len, causal=causal, save_lse=True,
                                 use_kernel=use_kernel)
        ctx.save_for_backward(q, k, v, out, lse, q_start, kv_len)
        ctx.causal, ctx.use_kernel = causal, use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, q_start, kv_len = ctx.saved_tensors
        # D = rowsum(dO * O) in f32, (B, nh, Sq) like lse
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        args = (q, k, v, g.to(q.dtype), lse, delta, q_start, kv_len)
        kw = dict(causal=ctx.causal, use_kernel=ctx.use_kernel)
        dq = flash_bwd_dq(*args, **kw)
        dk, dv = flash_bwd_dkv(*args, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q, k, v, q_start, kv_len, *, causal=True, use_kernel=None):
    """Fused GQA attention (see the module docstring). Returns (B, Sq, nh,
    hd) in q's dtype; differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_start, kv_len, causal, use_kernel)
    return flash_forward(q, k, v, q_start, kv_len, causal=causal, use_kernel=use_kernel)[0]
