"""Fake CUDA kernels for the CPU tests (imports torch and the port only,
never jax, so spawned worker ranks can use it too).

``FakeKernels`` stands in for ``_build.library()``: each C entry point
runs its plain arithmetic on the tensors behind the pointers, so a
wrapper's kernel route (its checks, pointer arithmetic and launch count)
runs on the CPU. ``kernel_routes()`` sends every wrapper there.
"""

import contextlib
import ctypes
import math
from unittest import mock

import pytest
import torch

from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import adam8bit as tadam
from quanta_tpu_torch.ops import attention as tattn


def _view(ptr: int, shape, dtype) -> torch.Tensor:
    """The tensor behind a data pointer (a CPU tensor here)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


class FakeKernels:
    """Stands in for ``_build.library()``: each C entry point the slice
    calls runs its plain arithmetic on the tensors behind the pointers."""

    @staticmethod
    def _weight(codes, scales, levels, n, k2, block, dtype):
        c = _view(codes, (k2, n), torch.uint8)
        s = torch.repeat_interleave(_view(scales, (2 * k2 // block, n), torch.float32), block, 0)
        lv = _view(levels, (16,), torch.float32)
        return (lv[torch.cat([c & 0x0F, c >> 4], 0).long()] * s).to(dtype)

    def _mm(self, dtype, x, codes, scales, levels, out, m, n, k2, block, _stream):
        w = self._weight(codes, scales, levels, n, k2, block, dtype)
        xv = _view(x, (m, 2 * k2), dtype)
        _view(out, (m, n), dtype).copy_((xv.float() @ w.float()).to(dtype))
        return 0

    def _mmt(self, dtype, g, codes, scales, levels, out, m, n, k2, block, _stream):
        w = self._weight(codes, scales, levels, n, k2, block, dtype)
        gv = _view(g, (m, n), dtype)
        _view(out, (m, 2 * k2), dtype).copy_((gv.float() @ w.float().T).to(dtype))
        return 0

    @staticmethod
    def _weight8(codes, scales, levels, n, k, block, dtype):
        """The 8-bit layout: the level table read by each code's byte."""
        c = _view(codes, (k, n), torch.uint8)
        s = torch.repeat_interleave(_view(scales, (k // block, n), torch.float32), block, 0)
        return (_view(levels, (256,), torch.float32)[c.long()] * s).to(dtype)

    def _mm8(self, dtype, x, codes, scales, levels, out, m, n, k, block, _stream):
        w = self._weight8(codes, scales, levels, n, k, block, dtype)
        _view(out, (m, n), dtype).copy_((_view(x, (m, k), dtype).float() @ w.float()).to(dtype))
        return 0

    def _mm8t(self, dtype, g, codes, scales, levels, out, m, n, k, block, _stream):
        w = self._weight8(codes, scales, levels, n, k, block, dtype)
        _view(out, (m, k), dtype).copy_((_view(g, (m, n), dtype).float() @ w.float().T).to(dtype))
        return 0

    @staticmethod
    def _attn(dtype, q, k, v, q_start, kv_len, b, sq, t, nh, nkv, hd, causal, scale):
        assert scale == pytest.approx(1.0 / math.sqrt(hd))
        return (_view(q, (b, sq, nh, hd), dtype), _view(k, (b, t, nkv, hd), dtype),
                _view(v, (b, t, nkv, hd), dtype), _view(q_start, (b,), torch.int32),
                _view(kv_len, (b,), torch.int32), bool(causal))

    def _flash_fwd(self, dtype, q, k, v, q_start, kv_len, out, lse, *sizes_stream):
        *sizes, _stream = sizes_stream
        b, sq, _, nh, _, hd, _, _ = sizes
        qv, kv, vv, qs, kl, causal = self._attn(dtype, q, k, v, q_start, kv_len, *sizes)
        o, l = tattn.flash_forward_reference(qv, kv, vv, qs, kl, causal=causal)
        _view(out, (b, sq, nh, hd), dtype).copy_(o)
        if lse is not None:
            _view(lse, (b, nh, sq), torch.float32).copy_(l)
        return 0

    def _flash_bwd(self, dtype, q, k, v, do, lse, delta, q_start, kv_len, *outs_sizes_stream):
        *outs, b, sq, t, nh, nkv, hd, causal, scale, _stream = outs_sizes_stream
        sizes = (b, sq, t, nh, nkv, hd, causal, scale)
        qv, kv, vv, qs, kl, causal = self._attn(dtype, q, k, v, q_start, kv_len, *sizes)
        stats = (_view(lse, (b, nh, sq), torch.float32), _view(delta, (b, nh, sq), torch.float32))
        args = (qv, kv, vv, _view(do, (b, sq, nh, hd), dtype), *stats, qs, kl)
        if len(outs) == 1:
            res = [tattn.flash_bwd_dq_reference(*args, causal=causal)]
            shapes = [(b, sq, nh, hd)]
        else:
            res = tattn.flash_bwd_dkv_reference(*args, causal=causal)
            shapes = [(b, t, nkv, hd)] * 2
        for ptr, shape, r in zip(outs, shapes, res):
            _view(ptr, shape, torch.float32).copy_(r)
        return 0

    def __getattr__(self, name):
        kinds = {"qt_matmul_4bit_": self._mm, "qt_matmul_4bit_t_": self._mmt,
                 "qt_matmul_8bit_": self._mm8, "qt_matmul_8bit_t_": self._mm8t,
                 "qt_flash_fwd_": self._flash_fwd, "qt_flash_bwd_dq_": self._flash_bwd,
                 "qt_flash_bwd_dkv_": self._flash_bwd}
        for prefix, fn in sorted(kinds.items(), key=lambda kv: -len(kv[0])):
            if name.startswith(prefix):
                dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
                return lambda *a: fn(dtype, *a)
        raise AttributeError(name)

    table_leaves = 128  # leaves one launch takes, as in csrc/adam8bit.cu

    def qt_adam8bit_table_leaves(self):
        return self.table_leaves

    def qt_adam8bit_step(self, leaves, n_leaves, scalars, b1, b2, c1, c2, eps, lr_wd, _stream):
        """The plain arithmetic over the leaf table, in the kernel's order:
        the update, the decay and the add where p is given, the update out
        where asked, the new state in place."""
        assert (c1, c2) == (1.0 - b1, 1.0 - b2)
        f32, i8, u8 = torch.float32, torch.int8, torch.uint8
        lr, bc1, bc2 = _view(scalars, (3,), f32)
        for leaf in (tadam.AdamLeaf * n_leaves).from_address(leaves):
            n, nb = leaf.n, -(-leaf.n // 256)
            rows, cols = (nb, 256), (nb, 1)
            g = _view(leaf.g, (n,), torch.bfloat16 if leaf.g_bf16 else f32)
            state = [_view(leaf.m_codes, rows, i8), _view(leaf.m_scale, cols, f32),
                     _view(leaf.v_codes, rows, u8), _view(leaf.v_scale, cols, f32)]
            upd, *new = tadam.adam8bit_update_reference(tadam.blockify(g)[0], *state, lr, bc1,
                                                        bc2, b1=b1, b2=b2, eps=eps)
            upd = upd.reshape(-1)[:n]
            if leaf.p:
                p = _view(leaf.p, (n,), torch.bfloat16 if leaf.p_bf16 else f32)
                if lr_wd:
                    upd = upd - lr_wd * p.to(f32)
                p.add_(upd.to(p.dtype))
            if leaf.upd:
                _view(leaf.upd, (n,), f32).copy_(upd)
            outs = [_view(leaf.m_codes_out, rows, i8), _view(leaf.m_scale_out, cols, f32),
                    _view(leaf.v_codes_out, rows, u8), _view(leaf.v_scale_out, cols, f32)]
            for o, t in zip(outs, new):
                o.copy_(t)
        return 0


class _Stream:
    cuda_stream = 0


@contextlib.contextmanager
def kernel_routes():
    """Every wrapper takes its kernel route on CPU tensors, into
    FakeKernels; the launch counts start at 0."""
    with mock.patch.object(_build, "use_kernel_for", lambda uk, t: uk is not False), \
            mock.patch.object(_build, "library", lambda: FakeKernels()), \
            mock.patch.object(torch.cuda, "current_stream", lambda dev=None: _Stream()):
        _build.reset_launches()
        yield
