"""LLM.int8 matmul with outlier decomposition: CUDA kernel wrappers and
their plain versions.

Port of ``quanta_tpu/ops/int8mm.py``. A weight (K, N) keeps a static set of
``outlier_capacity`` input features: their rows stay in bf16
(``w_outlier``) and their int8 codes are zeroed, so the two GEMMs never
count a feature twice. At run time

  - the outlier columns of x are gathered and multiplied with
    ``w_outlier`` in f32 (``torch.matmul``; the JAX package leaves this
    GEMM to XLA, outside its kernel);
  - each row of x gets an absmax scale over its inlier features;
  - the int8 GEMM runs on the tensor cores with ``row_scale * col_scale``
    on the int32 sum: ``csrc/int8mm.cu``, which replaces the Pallas
    ``_mm_i8_fused_kernel`` (x quantized in the prologue, the outlier
    partial added in the epilogue) and ``_mm_i8_kernel`` (x quantized
    beforehand) with two Hopper designs picked by M inside each entry
    point (split-K int8 ``mma.sync`` for decode, int8 wgmma tiles above;
    :func:`matmul_int8_design` says which).

``matmul_int8`` has three routes, as in JAX: the fused kernel (the
default on CUDA: ``fused`` follows "the kernel is used"), the plain-variant
kernel (``fused=False``), and the plain version (``use_kernel=False``).

The plain versions compute the integer product as a float64 matmul of the
integer values, exact on the CPU and on CUDA while K * 127**2 < 2**53
(an f32 product is not: 2048 * 127**2 > 2**24), then round it to f32 and
scale in the kernel's order. Kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops.matmul import _aligned, _design

_EPS = 1e-12
_EXACT_F64 = 2**53
_INT32_MAX = 2**31 - 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class Int8Weight:
    """Weight state for LLM.int8 inference. Layout (K, N) like x @ W."""

    codes: torch.Tensor  # int8 (K_pad, N_pad), outlier rows zeroed
    scale: torch.Tensor  # f32 (N_pad,) per-output-column scales
    outlier_idx: torch.Tensor  # int32 (capacity,) sorted K-indices of outlier features
    w_outlier: torch.Tensor  # bf16 (capacity, N_pad) original rows at outlier_idx
    threshold: float = 6.0
    shape: tuple = ()

    def __post_init__(self):
        self.shape = tuple(self.shape)


def _top_k_indices(stat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties broken toward the lower index
    as ``lax.top_k`` breaks them (``torch.topk`` promises no order): a
    stable descending sort keeps equal values in index order."""
    if k > stat.numel():
        raise ValueError(f"outlier capacity {k} exceeds the {stat.numel()} input features")
    return torch.sort(stat, descending=True, stable=True).indices[:k]


def quantize_int8_weight(
    w: torch.Tensor,
    *,
    threshold: float = 6.0,
    outlier_capacity: int | None = None,
    calib_colmax: torch.Tensor | None = None,
) -> Int8Weight:
    """Prepare a dense (K, N) weight for LLM.int8 inference.

    The outlier features are the top ``outlier_capacity`` (default
    max(32, K // 64)) by ``calib_colmax`` (per-feature max |activation|
    from calibration) or, without it, by the weight row's max |w|. K and N
    are padded to 128 here, once, so no call pads the weight.
    """
    k, n = w.shape
    if outlier_capacity is None:
        outlier_capacity = max(32, k // 64)
    wf = w.to(torch.float32)
    stat = (calib_colmax.to(torch.float32) if calib_colmax is not None
            else wf.abs().amax(dim=1))
    idx = torch.sort(_top_k_indices(stat, outlier_capacity)).values

    w_outlier = wf[idx].to(torch.bfloat16)
    mask = torch.zeros((k,), dtype=torch.float32, device=w.device)
    mask[idx] = 1.0
    w_inlier = wf * (1.0 - mask)[:, None]  # no double counting

    absmax = w_inlier.abs().amax(dim=0)
    # a tensor divisor, so CUDA divides as the CPU does (it would multiply
    # by the reciprocal of a Python scalar)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=_EPS)
    codes = torch.clamp(torch.round(w_inlier / scale[None, :]), -127, 127).to(torch.int8)

    k_pad, n_pad = _round_up(k, 128), _round_up(n, 128)
    return Int8Weight(
        codes=F.pad(codes, (0, n_pad - n, 0, k_pad - k)),
        scale=F.pad(scale, (0, n_pad - n)),
        outlier_idx=idx.to(torch.int32),
        w_outlier=F.pad(w_outlier, (0, n_pad - n)),
        threshold=float(threshold),
        shape=(k, n),
    )


# ------------------------------------------------------ kernels and plain


def quantize_rows(x: torch.Tensor, row_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / row_scale), -127, 127)`` as int8 (the fused
    kernel's prologue)."""
    return torch.clamp(torch.round(x / row_scale[:, None]), -127, 127).to(torch.int8)


def _int_product(xq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int8 @ int8 as float64 (every partial sum is an integer below
    2**53, so no summation order can round it)."""
    if xq.shape[1] * 127 * 127 >= _EXACT_F64:
        raise ValueError(f"K={xq.shape[1]}: the float64 integer product is no longer exact")
    return xq.to(torch.float64) @ codes.to(torch.float64)


def matmul_int8_kernel_reference(xq, codes, row_scale, col_scale) -> torch.Tensor:
    """Plain version of the plain-variant kernel: (M, N) f32."""
    acc = _int_product(xq, codes).to(torch.float32)
    return acc * row_scale[:, None] * col_scale[None, :]


def matmul_int8_fused_reference(x, codes, row_scale, col_scale, y_out) -> torch.Tensor:
    """Plain version of the fused kernel: (M, N) f32."""
    acc = _int_product(quantize_rows(x.to(torch.float32), row_scale), codes).to(torch.float32)
    return acc * row_scale[:, None] * col_scale[None, :] + y_out


def _launch(entry: str, counter: str, a, codes, row_scale, col_scale, y_out, a_dtype):
    m, k = a.shape
    kw, n = codes.shape
    if (a.dtype, codes.dtype, row_scale.dtype, col_scale.dtype) != (
            a_dtype, torch.int8, torch.float32, torch.float32):
        raise TypeError(f"{counter} takes {a_dtype} activations, int8 codes and f32 scales")
    if row_scale.shape != (m,) or col_scale.shape != (n,):
        raise ValueError("row_scale must be (M,) and col_scale (N,)")
    if k * 127 * 127 > _INT32_MAX:
        raise ValueError(f"K={k}: the int32 sum may overflow")
    operands = [a, codes, row_scale, col_scale] + ([] if y_out is None else [y_out])
    if any(t.device != a.device for t in operands):
        raise ValueError(f"all {counter} operands must be on one device")
    if y_out is not None and (y_out.dtype != torch.float32 or y_out.shape != (m, n)):
        raise ValueError("y_out must be f32 (M, N)")
    a, codes = _aligned(a), _aligned(codes)
    row_scale, col_scale = row_scale.contiguous(), col_scale.contiguous()
    y_out = None if y_out is None else _aligned(y_out)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m:
        args = [a.data_ptr(), codes.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr()]
        if y_out is not None:
            # where the fused kernel reads int8 x (every M but the small
            # decode ones), the C call first quantizes x into this scratch
            scratch = torch.empty((m, k), dtype=torch.int8, device=a.device)
            args += [y_out.data_ptr(), scratch.data_ptr()]
        rc = getattr(_build.library(), entry)(
            *args, out.data_ptr(), m, n, k, torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(rc, counter)
        _build.launches[counter] += 1
    return out


_NO_BACKWARD = ("LLM.int8 weights have no backward in the JAX package either; "
                "QLoRA bases are QuantizedTensors (nf4, nf4a, ...)")


def matmul_int8_fused(
    x: torch.Tensor,
    codes: torch.Tensor,
    row_scale: torch.Tensor,
    col_scale: torch.Tensor,
    y_out: torch.Tensor,
    *,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``quantize(x) @ codes * row_scale * col_scale + y_out``: x f32
    (M, K_pad), codes int8 (K_pad, N_pad), y_out f32 (M, N_pad) -> (M,
    N_pad) f32."""
    if x.shape[1] != codes.shape[0]:
        raise ValueError(f"x K={x.shape[1]} != codes K={codes.shape[0]}")
    if not _build.use_kernel_for(use_kernel, x):
        return matmul_int8_fused_reference(x, codes, row_scale, col_scale, y_out)
    _build.refuse_grad(x, "matmul_int8_fused", _NO_BACKWARD)
    return _launch("qt_matmul_int8_fused", "matmul_int8_fused", x, codes, row_scale,
                   col_scale, y_out, torch.float32)


def matmul_int8_kernel(
    xq: torch.Tensor,
    codes: torch.Tensor,
    row_scale: torch.Tensor,
    col_scale: torch.Tensor,
    *,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """``xq (M, K_pad) int8 @ codes (K_pad, N_pad) int8`` scaled by
    row_scale (M,) x col_scale (N_pad,) -> (M, N_pad) f32."""
    if xq.shape[1] != codes.shape[0]:
        raise ValueError(f"xq K={xq.shape[1]} != codes K={codes.shape[0]}")
    if not _build.use_kernel_for(use_kernel, xq):
        return matmul_int8_kernel_reference(xq, codes, row_scale, col_scale)
    return _launch("qt_matmul_int8", "matmul_int8", xq, codes, row_scale, col_scale, None,
                   torch.int8)


def matmul_int8_design(m, n, k, fused=True):
    """How the fused (``fused=True``) or plain-variant LLM.int8 kernel
    launches for x (m, k) and codes (k, n), k = K_pad, on this card: the
    keys of ``matmul.matmul_8bit_design``, ``design`` "decode" (split-K int8
    ``mma.sync``, memory bound) or "prefill" (int8 wgmma tiles of 128 rows;
    fused, after a pass that quantizes x into int8), its grid, K split,
    blocks per SM, registers, shared and spill bytes, stages and rows of x
    a block."""
    return _design("qt_matmul_int8_design", "matmul_int8", m, n, k, int(bool(fused)))


def matmul_int8(
    x: torch.Tensor,
    qw: Int8Weight,
    *,
    out_dtype=None,
    use_kernel: bool | None = None,
    fused: bool | None = None,
) -> torch.Tensor:
    """``x (.., K) @ W (K, N)`` as an int8 GEMM plus an f32 outlier GEMM.

    ``use_kernel=None`` runs the kernels for a CUDA x and the plain
    versions for a CPU one. ``fused`` (default: whether the kernel is
    used) picks the fused route; ``fused=False`` quantizes x beforehand and
    runs the plain-variant GEMM, which with ``use_kernel=False`` is the
    JAX package's XLA oracle.
    """
    kernel = _build.use_kernel_for(use_kernel, x)
    if kernel:
        _build.refuse_grad(x, "matmul_int8", _NO_BACKWARD)
    if fused is None:
        fused = kernel
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = qw.shape
    x2 = x.reshape(-1, k).to(torch.float32)

    # the outlier GEMM, f32: (M, N_pad), since w_outlier was padded
    y_out = x2.index_select(1, qw.outlier_idx) @ qw.w_outlier.to(torch.float32)

    # per-row absmax over the inlier features only: the outlier
    # activations are the large ones and would blow the scale
    # (in place on a fresh tensor; ``index_fill_`` takes the 0 as a kernel
    # argument, where ``xa[:, idx] = 0.0`` copied it from host memory and
    # so waited for the device on every call)
    xa = x2.abs()
    xa.index_fill_(1, qw.outlier_idx.long(), 0.0)
    row_scale = torch.clamp(xa.amax(dim=1) / 127.0, min=_EPS)

    k_pad = qw.codes.shape[0]
    if fused:
        xp = F.pad(x2, (0, k_pad - k)) if k_pad != k else x2
        y = matmul_int8_fused(xp, qw.codes, row_scale, qw.scale, y_out, use_kernel=kernel)
        return y[:, :n].to(out_dtype).reshape(*lead, n)
    # the outlier columns need no zeroing: their codes are zero, so
    # whatever they quantize to (they clip) adds nothing to the int32 sum
    xq = quantize_rows(x2, row_scale)
    if k_pad != k:
        xq = F.pad(xq, (0, k_pad - k))
    y_in = matmul_int8_kernel(xq, qw.codes, row_scale, qw.scale, use_kernel=kernel)
    return (y_in[:, :n] + y_out[:, :n]).to(out_dtype).reshape(*lead, n)


def outlier_coverage(x: torch.Tensor, qw: Int8Weight) -> torch.Tensor:
    """Fraction of the above-threshold activation features that the static
    outlier set covers (diagnostics for the capacity)."""
    k = x.shape[-1]
    colmax = x.reshape(-1, k).abs().amax(dim=0)
    hot = colmax > qw.threshold
    mask = torch.zeros((k,), dtype=torch.bool, device=x.device)
    mask[qw.outlier_idx] = True
    covered = (hot & mask).sum()
    return covered.to(torch.float32) / torch.clamp(hot.sum(), min=1)
