"""Blockwise 8-bit Adam / AdamW (port of quanta_tpu/optim/adam8bit.py).

The state of each parameter is int8/uint8 codes plus per-block scales,
blocks of 256 elements; each step dequantizes, takes the Adam step and
requantizes per block:

  - m (first moment, signed): symmetric int8, scale absmax/127 per block;
  - v (second moment, non-negative): uint8 with 4th-root companding,
    ``code = round(255 * (v / blockmax)^(1/4))``, which spans v's dynamic
    range where a linear 8-bit code would round small entries to zero.

Two routes, as in the JAX package. The kernel route
(``ops.adam8bit.adam8bit_step``, ``csrc/adam8bit.cu``) fuses the whole
step, the weight decay and the parameter update into one launch over the
leaves that share a device and a step count, and is taken for every CUDA
parameter (the JAX package's "TPU and at least 16K elements" rule was a
TPU tiling threshold). The plain route is the JAX package's XLA path in
torch ops and runs on the CPU, or anywhere with ``use_kernel=False``.
They differ only in the order of the bias-correction arithmetic.

Each parameter is stepped in its own dtype: a bf16 adapter takes a bf16
update, as ``upd.astype(g.dtype)`` and ``optax.apply_updates`` do.
``bc1 = 1 - b1**count`` and ``bc2`` are f32 computations, as JAX computes
them, never Python doubles.
"""

from __future__ import annotations

import math

import torch

from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops.adam8bit import BLOCK  # noqa: F401 (the state's block size)
from quanta_tpu_torch.ops.adam8bit import STATE_KEYS, LeafTable
from quanta_tpu_torch.ops.adam8bit import blockify as _blockify

_EPS = 1e-12


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as IEEE division also on CUDA (where ``x / 127.0`` is a
    reciprocal product)."""
    return x / torch.full_like(x, c)


def _quant_m(m: torch.Tensor):
    blocks, _ = _blockify(m)
    scale = torch.clamp(_div(blocks.abs().amax(dim=1, keepdim=True), 127.0), min=_EPS)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale


def _quant_v(v: torch.Tensor):
    blocks, _ = _blockify(v)
    scale = torch.clamp(blocks.amax(dim=1, keepdim=True), min=_EPS)
    comp = torch.sqrt(torch.sqrt(torch.clamp(blocks / scale, 0.0, 1.0)))
    codes = torch.clamp(torch.round(comp * 255.0), 0, 255).to(torch.uint8)
    return codes, scale


def _deq_m(codes, scale, shape) -> torch.Tensor:
    flat = codes.to(torch.float32) * scale
    return flat.reshape(-1)[: math.prod(shape)].reshape(tuple(shape))


def _deq_v(codes, scale, shape) -> torch.Tensor:
    comp = _div(codes.to(torch.float32), 255.0)
    comp2 = comp * comp  # comp**4 as jnp's integer_pow computes it
    flat = comp2 * comp2 * scale
    return flat.reshape(-1)[: math.prod(shape)].reshape(tuple(shape))


class Adam8bit(torch.optim.Optimizer):
    """Blockwise 8-bit Adam(W) as a ``torch.optim.Optimizer``.

    ``weight_decay > 0`` gives AdamW: decoupled decay ``-lr * wd * p``
    added to the update. ``use_kernel``: None takes the fused CUDA kernel
    for a CUDA parameter and the plain route for a CPU one; True/False
    force (True raises on a CPU parameter).
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, *, use_kernel: bool | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.use_kernel = use_kernel
        self._tables = {}  # (group index, device) -> the kernel's LeafTable

    def load_state_dict(self, state_dict):
        """``torch.optim.Optimizer.load_state_dict``, the 8-bit state keeping
        its dtypes: torch casts every state tensor of a floating parameter
        to the parameter's dtype (int8 codes to f32, and the f32 scales of a
        bf16 adapter to bf16, which rounds them)."""
        saved = state_dict["state"]
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        super().load_state_dict(state_dict)
        for i, p in zip(ids, (p for g in self.param_groups for p in g["params"])):
            if i in saved:
                for k in STATE_KEYS:
                    self.state[p][k] = saved[i][k].to(device=p.device, copy=True)

    @staticmethod
    def _init_state(p: torch.Tensor) -> dict:
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        mc, ms = _quant_m(z)
        vc, vs = _quant_v(z)
        return {"step": 0, "m_codes": mc, "m_scale": ms, "v_codes": vc, "v_scale": vs}

    @staticmethod
    def _scalars(lr, b1, b2, step, device) -> torch.Tensor:
        """(lr, bc1, bc2) as one f32 (3,) tensor on the device. ``bc = 1 -
        b**step`` is an f32 power, as JAX computes it; the three go up in
        one pinned copy that does not wait for the device."""
        count = torch.tensor(float(step), dtype=torch.float32)
        f32 = [torch.tensor(v, dtype=torch.float32) for v in (lr, b1, b2)]
        host = torch.stack([f32[0], 1.0 - f32[1] ** count, 1.0 - f32[2] ** count])
        if device.type == "cuda":
            host = host.pin_memory()
        return host.to(device, non_blocking=True)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for gi, group in enumerate(self.param_groups):
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            b1, b2 = group["betas"]
            leaves = {}  # (step, device) -> (parameters, gradients, states), stepped together
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._init_state(p))
                st["step"] += 1
                ps, grads, states = leaves.setdefault((st["step"], p.device), ([], [], []))
                ps.append(p)
                grads.append(g)
                states.append(st)
            for (count, device), (ps, grads, states) in leaves.items():
                scalars = self._scalars(lr, b1, b2, count, device)
                if _build.use_kernel_for(self.use_kernel, grads[0]):
                    table = self._tables.get((gi, device))
                    if table is None or not table.holds(ps, states):
                        table = self._tables[(gi, device)] = LeafTable(ps, states)
                    table.step(grads, scalars, lr=lr, weight_decay=wd, b1=b1, b2=b2, eps=eps)
                    continue
                _, bc1, bc2 = scalars.unbind()
                for p, g, st in zip(ps, grads, states):
                    if g.is_sparse or g.shape != p.shape:
                        raise ValueError(f"Adam8bit takes a dense gradient of the parameter's "
                                         f"shape {tuple(p.shape)}, got {g.layout} "
                                         f"{tuple(g.shape)}")
                    upd = self._plain_update(g, st, lr, bc1, bc2, b1, b2, eps)
                    if wd:
                        upd = upd - lr * wd * p.to(torch.float32)
                    p.add_(upd.to(p.dtype))
        return loss

    @staticmethod
    def _plain_update(g, st, lr, bc1, bc2, b1, b2, eps) -> torch.Tensor:
        """One leaf's f32 update on the plain route; replaces its state."""
        g32 = g.to(torch.float32)
        m = _deq_m(st["m_codes"], st["m_scale"], g.shape)
        v = _deq_v(st["v_codes"], st["v_scale"], g.shape)
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * g32 * g32
        m_hat = m / bc1
        v_hat = v / bc2
        upd = -lr * m_hat / (torch.sqrt(v_hat) + eps)
        mc, ms = _quant_m(m)
        vc, vs = _quant_v(v)
        st.update(m_codes=mc, m_scale=ms, v_codes=vc, v_scale=vs)
        return upd


class AdamW8bit(Adam8bit):
    """Adam8bit with decoupled weight decay, 1e-2 by default."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, *, use_kernel: bool | None = None):
        super().__init__(params, lr, betas, eps, weight_decay, use_kernel=use_kernel)


def state_nbytes(optimizer: Adam8bit) -> int:
    """Bytes of quantized optimizer state (about 2.03 per parameter)."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))
