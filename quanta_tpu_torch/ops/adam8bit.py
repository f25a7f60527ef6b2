"""Fused blockwise 8-bit Adam step: CUDA kernel wrapper and its plain version.

Port of ``quanta_tpu/ops/adam8bit.py``. The kernel is ``csrc/adam8bit.cu``
(it replaces the Pallas ``_adam_tile``): per block of 256 elements it
dequantizes the moments, takes the bias-corrected Adam step and
requantizes them, so f32 moments never reach device memory.

State layout (``optim.adam8bit``): m int8 codes with scale
``max(absmax/127, 1e-12)`` per block, v uint8 4th-root companded codes with
scale ``max(blockmax, 1e-12)``, blocks of 256 as rows of ``(nb, 256)``.
The TPU's tile padding of the block rows (``tr``) has no counterpart.

The plain version follows the Pallas kernel's expression order,
``-(lr/bc1)·m / (√(v/bc2) + eps)``, and the kernel follows the plain
version's roundings one for one, so the two agree bit for bit. It divides
by tensors, never by Python scalars: on CUDA, torch turns ``t / 127.0``
into ``t * (1/127)``, which rounds differently. ``lr``, ``bc1`` and
``bc2`` are best passed as device tensors: a Python float becomes one by a
copy that waits for the device.

Dispatch as every wrapper here (``_build.use_kernel_for``): the kernel for
a CUDA tensor, the plain version for a CPU one.
"""

from __future__ import annotations

import torch

from quanta_tpu_torch.ops import _build

BLOCK = 256  # quantization block


def _scalar(s, device) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32, device=device)


def adam8bit_update_reference(
    g_blocks: torch.Tensor,
    m_codes: torch.Tensor,
    m_scale: torch.Tensor,
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    lr,
    bc1,
    bc2,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """Plain-torch version of the kernel; returns (upd, m_codes', m_scale',
    v_codes', v_scale') as the kernel does."""
    dev = g_blocks.device
    lr, bc1, bc2 = (_scalar(s, dev) for s in (lr, bc1, bc2))
    g = g_blocks.to(torch.float32)
    m = m_codes.to(torch.float32) * m_scale
    vq = v_codes.to(torch.float32) * (1.0 / 255.0)
    v = (vq * vq) * (vq * vq) * v_scale

    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    upd = -(lr / bc1) * m / (torch.sqrt(v / bc2) + eps)

    amax = m.abs().amax(dim=1, keepdim=True)
    ms = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    mc = torch.clamp(torch.round(m / ms), -127, 127).to(torch.int8)
    vs = torch.clamp(v.amax(dim=1, keepdim=True), min=1e-12)
    comp = torch.sqrt(torch.sqrt(torch.clamp(v / vs, 0.0, 1.0)))
    vc = torch.clamp(torch.round(comp * 255.0), 0, 255).to(torch.uint8)
    return upd, mc, ms, vc, vs


def adam8bit_update(
    g_blocks: torch.Tensor,   # (nb, 256) f32 (or castable)
    m_codes: torch.Tensor,    # (nb, 256) int8
    m_scale: torch.Tensor,    # (nb, 1) f32
    v_codes: torch.Tensor,    # (nb, 256) uint8
    v_scale: torch.Tensor,    # (nb, 1) f32
    lr,
    bc1,
    bc2,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    use_kernel: bool | None = None,
):
    """Fused blockwise-8-bit Adam step over blockified state.

    Returns (upd (nb, 256) f32, m_codes', m_scale', v_codes', v_scale').
    ``lr``, ``bc1`` and ``bc2`` are floats or 0-dim tensors; the kernel
    reads them from device memory. Passed as device tensors (as
    ``optim.Adam8bit`` passes them), a call never waits for the device.
    """
    if not _build.use_kernel_for(use_kernel, g_blocks):
        return adam8bit_update_reference(g_blocks, m_codes, m_scale, v_codes, v_scale,
                                         lr, bc1, bc2, b1=b1, b2=b2, eps=eps)
    nb = g_blocks.shape[0]
    dev = g_blocks.device
    if g_blocks.shape != (nb, BLOCK) or m_codes.shape != (nb, BLOCK) or \
            v_codes.shape != (nb, BLOCK):
        raise ValueError(f"adam8bit_update takes (nb, {BLOCK}) blocks")
    if m_scale.shape != (nb, 1) or v_scale.shape != (nb, 1):
        raise ValueError("m_scale and v_scale must be (nb, 1)")
    if (m_codes.dtype, v_codes.dtype, m_scale.dtype, v_scale.dtype) != (
            torch.int8, torch.uint8, torch.float32, torch.float32):
        raise TypeError("adam8bit_update takes int8 m codes, uint8 v codes, f32 scales")
    ins = [g_blocks.to(torch.float32), m_codes, m_scale, v_codes, v_scale]
    if any(t.device != dev for t in ins):
        raise ValueError("adam8bit_update: every operand must be on one device")
    ins = [t.contiguous() for t in ins]
    scalars = torch.stack([_scalar(s, dev) for s in (lr, bc1, bc2)])
    outs = [torch.empty_like(t) for t in ins]
    if not nb:
        return tuple(outs)
    rc = _build.library().qt_adam8bit_update(
        *(t.data_ptr() for t in ins), scalars.data_ptr(), *(t.data_ptr() for t in outs),
        nb, b1, b2, 1.0 - b1, 1.0 - b2, eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "adam8bit_update")
    _build.launches["adam8bit_update"] += 1
    return tuple(outs)
