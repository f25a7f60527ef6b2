"""Fused blockwise 8-bit Adam step: CUDA kernel wrappers and their plain versions.

Port of ``quanta_tpu/ops/adam8bit.py``. The kernel is ``csrc/adam8bit.cu``
(it replaces the Pallas ``_adam_tile``): per block of 256 elements it
dequantizes the moments, takes the bias-corrected Adam step and
requantizes them, so f32 moments never reach device memory. One launch
steps a whole table of leaves; the source says how it is laid out.

State layout (``optim.adam8bit``): m int8 codes with scale
``max(absmax/127, 1e-12)`` per block, v uint8 4th-root companded codes with
scale ``max(blockmax, 1e-12)``, blocks of 256 as rows of ``(nb, 256)``.
The TPU's tile padding of the block rows (``tr``) has no counterpart.

Two entry points:

  - ``adam8bit_update``: the JAX function's contract, blockified state in,
    ``(upd, m', v')`` out, one leaf;
  - ``adam8bit_step``: the optimizer's step over many leaves, IN PLACE:
    every parameter takes its update, decoupled weight decay included,
    in its own dtype, and every state tensor its new codes and scales; no
    f32 update reaches device memory.

The plain versions follow the Pallas kernel's expression order,
``-(lr/bc1)·m / (√(v/bc2) + eps)``, and the kernel follows the plain
versions' roundings one for one, so they agree bit for bit. They divide by
tensors, never by Python scalars: on CUDA, torch turns ``t / 127.0`` into
``t * (1/127)``, which rounds differently. ``lr``, ``bc1`` and ``bc2`` are
best passed as device tensors: a Python float becomes one by a copy that
waits for the device.

Dispatch as every wrapper here (``_build.use_kernel_for``): the kernel for
a CUDA tensor, the plain version for a CPU one.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from quanta_tpu_torch.ops import _build

BLOCK = 256  # quantization block
STATE_KEYS = ("m_codes", "m_scale", "v_codes", "v_scale")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class AdamLeaf(ctypes.Structure):
    """One leaf of a kernel launch, laid out as ``csrc/adam8bit.cu``'s
    ``Leaf``: pointers (0 for none), the element count and whether g and p
    are bf16 (else f32)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "g", "p", "upd", "m_codes", "m_scale", "v_codes", "v_scale",
        "m_codes_out", "m_scale_out", "v_codes_out", "v_scale_out")] + [
        ("n", ctypes.c_longlong), ("g_bf16", ctypes.c_int), ("p_bf16", ctypes.c_int)]


def _scalar(s, device) -> torch.Tensor:
    return torch.as_tensor(s, dtype=torch.float32, device=device)


def blockify(x: torch.Tensor):
    """x flattened to f32 and zero-padded to rows of 256: ((nb, 256), n)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(nb, BLOCK), n


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


def _launch(table, n_leaves: int, scalars: torch.Tensor, b1, b2, eps, lr_wd) -> None:
    """One C call over ``n_leaves`` leaves; counts the launches it makes."""
    lib = _build.library()
    rc = lib.qt_adam8bit_step(ctypes.addressof(table), n_leaves, scalars.data_ptr(), b1, b2,
                              1.0 - b1, 1.0 - b2, eps, lr_wd,
                              torch.cuda.current_stream(scalars.device).cuda_stream)
    _build.check(rc, "adam8bit_update")
    _build.launches["adam8bit_update"] += -(-n_leaves // lib.qt_adam8bit_table_leaves())


def adam8bit_update(
    g_blocks: torch.Tensor,   # (nb, 256) f32 or bf16 (or castable)
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
    reads them from device memory. Passed as device tensors, a call never
    waits for the device.
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
    if g_blocks.dtype not in _KERNEL_DTYPES:
        g_blocks = g_blocks.to(torch.float32)
    ins = [t.contiguous() for t in (g_blocks, m_codes, m_scale, v_codes, v_scale)]
    if any(t.device != dev for t in ins):
        raise ValueError("adam8bit_update: every operand must be on one device")
    upd = torch.empty((nb, BLOCK), dtype=torch.float32, device=dev)
    outs = [torch.empty_like(t) for t in ins[1:]]
    if not nb:
        return (upd, *outs)
    scalars = torch.stack([_scalar(s, dev) for s in (lr, bc1, bc2)])
    table = (AdamLeaf * 1)()
    table[0] = AdamLeaf(*(t.data_ptr() for t in ins[:1]), None, upd.data_ptr(),
                        *(t.data_ptr() for t in ins[1:]), *(t.data_ptr() for t in outs),
                        nb * BLOCK, g_blocks.dtype == torch.bfloat16, 0)
    _launch(table, 1, scalars, b1, b2, eps, 0.0)
    return (upd, *outs)


def adam8bit_step_reference(params, grads, states, scalars: torch.Tensor, *, lr: float,
                            weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8) -> None:
    """Plain version of :func:`adam8bit_step`: per leaf, the plain update of
    the blockified gradient, the decay ``- lr * wd * p`` and
    ``p.add_(upd.to(p.dtype))``; the state tensors take their new values in
    place."""
    lr_t, bc1, bc2 = scalars.unbind()
    for p, g, st in zip(params, grads, states):
        gb, n = blockify(g)
        upd, *new = adam8bit_update_reference(gb, *(st[k] for k in STATE_KEYS), lr_t, bc1, bc2,
                                              b1=b1, b2=b2, eps=eps)
        upd = upd.reshape(-1)[:n].reshape(g.shape)
        if weight_decay:
            upd = upd - lr * weight_decay * p.to(torch.float32)
        p.add_(upd.to(p.dtype))
        for k, t in zip(STATE_KEYS, new):
            st[k].copy_(t)


class LeafTable:
    """The kernel's leaf table for a fixed list of parameters and their
    state: checked and filled once, then stepped any number of times, each
    step filling in only the gradients' pointers (``zero_grad`` makes them
    fresh tensors every step). The state tensors are updated in place, so
    the table stays valid while the parameters (and their storage) and the
    state tensors are the same (:meth:`holds`)."""

    def __init__(self, params, states):
        self.params = list(params)
        self.device = self.params[0].device if self.params else None
        self._state_tensors = [tuple(st[k] for k in STATE_KEYS) for st in states]
        if len(self._state_tensors) != len(self.params):
            raise ValueError(f"adam8bit_step: {len(self._state_tensors)} states for "
                             f"{len(self.params)} parameters")
        self._p_ptrs = [p.data_ptr() for p in self.params]
        self._live = []  # indices of the leaves with elements, in the table's order
        self._table = (AdamLeaf * len(self.params))()
        for i, p in enumerate(self.params):
            n = p.numel()
            if p.dtype not in _KERNEL_DTYPES:
                raise TypeError(f"adam8bit_step: the kernel takes f32 or bf16 parameters, "
                                f"got {p.dtype}")
            if not p.is_contiguous() or p.device != self.device:
                raise ValueError("adam8bit_step: the kernel updates contiguous parameters on "
                                 "one device in place")
            state = self._state_tensors[i]
            nb = -(-n // BLOCK)
            if [t.numel() for t in state] != [nb * BLOCK, nb, nb * BLOCK, nb] or \
                    [t.dtype for t in state] != [torch.int8, torch.float32, torch.uint8,
                                                 torch.float32] or \
                    not all(t.is_contiguous() and t.device == self.device for t in state):
                raise ValueError(f"adam8bit_step: the state of a {n}-element leaf must be "
                                 f"contiguous ({nb}, {BLOCK}) int8 / uint8 codes and ({nb}, 1) "
                                 f"f32 scales on its device")
            if n:
                ptrs = [t.data_ptr() for t in state]
                self._table[len(self._live)] = AdamLeaf(
                    None, self._p_ptrs[i], None, *ptrs, *ptrs, n, 0, p.dtype == torch.bfloat16)
                self._live.append(i)

    def holds(self, params, states) -> bool:
        """Whether the table stands for these parameters and state tensors."""
        return len(params) == len(self.params) and all(
            a is b and a.data_ptr() == ptr
            for a, b, ptr in zip(params, self.params, self._p_ptrs)) and all(
            st["m_codes"] is mc and st["m_scale"] is ms and st["v_codes"] is vc and
            st["v_scale"] is vs for (mc, ms, vc, vs), st in zip(self._state_tensors, states))

    def step(self, grads, scalars: torch.Tensor, *, lr: float, weight_decay: float = 0.0,
             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
        """One Adam(W) step of every leaf, IN PLACE (see :func:`adam8bit_step`)."""
        if scalars.shape != (3,) or scalars.dtype != torch.float32 or \
                scalars.device != self.device:
            raise ValueError("adam8bit_step: scalars must be (lr, bc1, bc2) as one f32 (3,) "
                             "tensor on the leaves' device")
        if len(grads) != len(self.params):
            raise ValueError(f"adam8bit_step: {len(grads)} gradients for {len(self.params)} "
                             "parameters")
        keep = []  # contiguous copies of gradients, alive until the launch is queued
        for leaf, i in zip(self._table, self._live):
            g, p = grads[i], self.params[i]
            if g.layout != torch.strided or g.shape != p.shape:
                raise ValueError(f"adam8bit_step: a dense gradient of the parameter's shape "
                                 f"{tuple(p.shape)} is needed, got {g.layout} {tuple(g.shape)}")
            if g.dtype not in _KERNEL_DTYPES or g.device != self.device:
                raise TypeError(f"adam8bit_step: the kernel takes f32 or bf16 gradients on the "
                                f"parameter's device, got {g.dtype} on {g.device}")
            if not g.is_contiguous():
                g = g.contiguous()
                keep.append(g)
            leaf.g = g.data_ptr()
            leaf.g_bf16 = g.dtype == torch.bfloat16
        if self._live:
            _launch(self._table, len(self._live), scalars, b1, b2, eps, lr * weight_decay)


def adam8bit_step(params, grads, states, scalars: torch.Tensor, *, lr: float,
                  weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, use_kernel: bool | None = None) -> None:
    """One Adam(W) step over leaves that share a device and a step count,
    IN PLACE.

    ``params``: the parameters (f32 or bf16, contiguous), each stepped in
    its own dtype; ``grads``: their gradients (f32 or bf16, the
    parameter's shape); ``states``: per leaf a dict of ``STATE_KEYS``
    tensors, ``(nb, 256)`` int8 / uint8 codes and ``(nb, 1)`` f32 scales;
    ``scalars``: ``(lr, bc1, bc2)`` as one f32 ``(3,)`` tensor on the
    device. ``lr`` and ``weight_decay`` are the group's: decay subtracts
    ``lr * weight_decay * p`` from the update. The kernel route makes one
    C call, which launches once per ``qt_adam8bit_table_leaves()`` leaves;
    a caller that steps the same leaves again keeps a :class:`LeafTable`.
    """
    if not params:
        return
    if not _build.use_kernel_for(use_kernel, scalars):
        return adam8bit_step_reference(params, grads, states, scalars, lr=lr,
                                       weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)
    LeafTable(params, states).step(grads, scalars, lr=lr, weight_decay=weight_decay, b1=b1,
                                   b2=b2, eps=eps)
