"""Port parity for the QLoRA slice: quanta_tpu_torch's backward, LoRA,
8-bit Adam and train step against quanta_tpu's.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode (``matmul_4bit_t``,
``adam8bit_update``) or its XLA route, as its own tests do. Inputs are made
with numpy from a seed and handed to both. The kernel routes' wiring
(argument order, launch counts, the autograd Function) is rehearsed here
with ``FakeKernels``, whose C entry points run the plain arithmetic on the
tensors behind the pointers. The CUDA kernels themselves:
tests/test_torch_cuda.py.
"""

import importlib
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import core as jcore
from quanta_tpu import nn as jnn
from quanta_tpu import optim as joptim
from quanta_tpu import train as jtrain
from quanta_tpu.models import llama as jllama
from quanta_tpu.nn import lora as jlora
from quanta_tpu.ops import adam8bit as jadam
from quanta_tpu.ops import matmul as jmm
from quanta_tpu_torch import core as tcore
from quanta_tpu_torch import interop
from quanta_tpu_torch import nn as tnn
from quanta_tpu_torch import train as ttrain
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.ops import adam8bit as tadam
from quanta_tpu_torch.ops import attention as tattn
from quanta_tpu_torch.ops import int4c as tint4c
from quanta_tpu_torch.ops import int8mm as tint8
from quanta_tpu_torch.ops import matmul as tmm
from quanta_tpu_torch.optim import adam8bit as toptim
from torch_fakes import FakeKernels, kernel_routes

# the package attribute ``quanta_tpu.optim.adam8bit`` is the function
joptim_mod = importlib.import_module("quanta_tpu.optim.adam8bit")

BF16_ULP = 2.0 ** -7


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# --------------------------------------------------------- matmul_4bit_t


@pytest.mark.parametrize("fmt", ["nf4a", "nf4", "int4", "fp4"])
@pytest.mark.parametrize("m,k,n", [(12, 256, 192), (9, 300, 100)])
def test_matmul_4bit_t_reference_matches_jax(fmt, m, k, n):
    """f32 g: only the summation order differs; bf16 g: the same bf16
    weights, f32 sums in another order, within 2 bf16 ulps of max|ref|.
    n=100 is not a multiple of the 128-column padding: g is zero-padded."""
    w = _rand((k, n), 1)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=64)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=64)
    g = _rand((m, n), 2)
    ref = np.asarray(jmm.matmul_4bit_t(jnp.asarray(g), jq.codes, jq.scale, codebook=jq.codebook,
                                       block=64, interpret=True))
    out = tmm.matmul_4bit_t(torch.from_numpy(g), tq.codes, tq.scale, codebook=tq.codebook,
                            block=64)
    assert out.shape == ref.shape == (m, 2 * tq.codes.shape[0])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    gb = jnp.asarray(g).astype(jnp.bfloat16)
    ref = np.asarray(jmm.matmul_4bit_t(gb, jq.codes, jq.scale, codebook=jq.codebook, block=64,
                                       interpret=True).astype(jnp.float32))
    gt = torch.from_numpy(np.asarray(gb.astype(jnp.float32))).to(torch.bfloat16)
    out = tmm.matmul_4bit_t(gt, tq.codes, tq.scale, codebook=tq.codebook, block=64)
    assert out.dtype == torch.bfloat16
    tol = 2 * BF16_ULP * np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("m", [1, 130])
@pytest.mark.parametrize("fmt", ["nf4", "fp4"])
def test_matmul_4bit_t_bf16_across_m_and_blocks_matches_jax(fmt, m, block):
    """The plain version the card holds the kernel's wgmma tiles against, at
    M on either side of a 128-row tile and at blocks below and above its
    64 packed rows (the quantizer pads K to 16 blocks), bf16 g: the same
    bf16 weights, f32 sums in another order, within 2 bf16 ulps of
    max|ref|."""
    w = _rand((300, 200), 20 + block)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=block)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=block)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    gb = jnp.asarray(_rand((m, 200), 21 + m)).astype(jnp.bfloat16)
    ref = np.asarray(jmm.matmul_4bit_t(gb, jq.codes, jq.scale, codebook=jq.codebook, block=block,
                                       interpret=True).astype(jnp.float32))
    gt = torch.from_numpy(np.asarray(gb.astype(jnp.float32))).to(torch.bfloat16)
    out = tmm.matmul_4bit_t(gt, tq.codes, tq.scale, codebook=tq.codebook, block=block)
    assert out.shape == ref.shape == (m, 2 * tq.codes.shape[0])
    assert np.abs(out.float().numpy() - ref).max() <= 2 * BF16_ULP * np.abs(ref).max()


# ------------------------------------------------ autograd dx through _mmq


@pytest.mark.parametrize("fmt", ["nf4a", "nf4", "int4", "fp4", "int4a", "int8", "int8a"])
def test_backward_dx_matches_jax_grad(fmt):
    """The bounds of the JAX package's own backward test
    (tests/test_ops_matmul.py:278-298)."""
    x, w = _rand((12, 256), 3), _rand((256, 192), 4)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt=fmt, block_size=64)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt=fmt, block_size=64)
    gj = jax.grad(lambda x: jnp.sum(jmm.matmul_quantized(x, jq, interpret=True) ** 2))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tmm.matmul_quantized(xt, tq) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=5e-4, atol=2e-3)


def test_backward_dx_unaligned_and_batched():
    """tests/test_ops_matmul.py:301-312: K and N off the padding, a batch."""
    x, w = _rand((2, 5, 250), 5), _rand((250, 100), 6)
    jq = jcore.quantize_matmul_weight(jnp.asarray(w), fmt="nf4a", block_size=64)
    tq = tcore.quantize_matmul_weight(torch.from_numpy(w), fmt="nf4a", block_size=64)
    gj = jax.grad(lambda x: jnp.sum(jmm.matmul_quantized(x, jq, interpret=True) ** 2))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tmm.matmul_quantized(xt, tq) ** 2).sum().backward()
    assert xt.grad.shape == xt.shape
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------- 8-bit Adam


@pytest.mark.parametrize("shape", [(700,), (64, 40), (3, 256)])
def test_state_quantizers_bit_exact(shape):
    m = _rand(shape, 7, 0.01)
    v = m * m
    jc, js = joptim_mod._quant_m(jnp.asarray(m))
    tc, ts = toptim._quant_m(torch.from_numpy(m))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jvc, jvs = joptim_mod._quant_v(jnp.asarray(v))
    tvc, tvs = toptim._quant_v(torch.from_numpy(v))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    np.testing.assert_array_equal(toptim._deq_m(tc, ts, shape).numpy(),
                                  np.asarray(joptim_mod._deq_m(jc, js, shape)))
    np.testing.assert_array_equal(toptim._deq_v(tvc, tvs, shape).numpy(),
                                  np.asarray(joptim_mod._deq_v(jvc, jvs, shape)))


def _grads(shapes, step):
    """Per-leaf gradients of one step; the first 256 elements of each are
    zero, an all-zero quantization block."""
    out = []
    for i, s in enumerate(shapes):
        g = _rand(s, 100 * step + i).reshape(-1)
        g[:256] = 0.0
        out.append(g.reshape(s))
    return out


def test_adam8bit_update_reference_matches_jax():
    """The plain version of the kernel over 4 chained steps against the
    Pallas kernel (interpret) and against the XLA route of
    ``adam8bit(use_kernel=False)``, at the bounds of
    tests/test_optim.py:120-143."""
    shapes = [(700,), (64, 40)]
    params = {"w": jnp.zeros(shapes[0]), "b": jnp.zeros(shapes[1])}
    tx = joptim.adam8bit(1e-2, use_kernel=False)
    sx = tx.init(params)
    lr, b1, b2 = np.float32(1e-2), 0.9, 0.999
    state = {}
    for name, s in zip(("w", "b"), shapes):
        mc, ms = toptim._quant_m(torch.zeros(s))
        vc, vs = toptim._quant_v(torch.zeros(s))
        state[name] = [mc, ms, vc, vs]
    jstate = {k: [jnp.asarray(t.numpy()) for t in v] for k, v in state.items()}
    for step in range(1, 5):
        g = dict(zip(("w", "b"), _grads(shapes, step)))
        ux, sx = tx.update({k: jnp.asarray(v) for k, v in g.items()}, sx, params)
        bc1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
        bc2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
        for name, s in zip(("w", "b"), shapes):
            gb, n = toptim._blockify(torch.from_numpy(g[name]))
            out = tadam.adam8bit_update(gb, *state[name], float(lr), float(bc1), float(bc2))
            state[name] = list(out[1:])
            jout = jadam.adam8bit_update(jnp.asarray(gb.numpy()), *jstate[name], lr, bc1, bc2,
                                         interpret=True)
            jstate[name] = list(jout[1:])
            upd = out[0].reshape(-1)[:n].reshape(s).numpy()
            for a, b in zip(out, jout):  # against the Pallas kernel
                np.testing.assert_allclose(a.numpy().astype(np.float32),
                                           np.asarray(b, np.float32), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(upd, np.asarray(ux[name]), rtol=1e-5, atol=1e-7)
            assert np.all(upd.reshape(-1)[:256] == 0.0)  # the all-zero block
            q = sx.qstate[name]
            for a, b in zip(state[name], (q.m_codes, q.m_scale, q.v_codes, q.v_scale)):
                np.testing.assert_allclose(a.numpy().astype(np.float32),
                                           np.asarray(b, np.float32), rtol=1e-5, atol=1e-6)


def test_adam8bit_optimizer_matches_jax_xla_route():
    """Adam8bit (plain route) over 4 steps against the JAX package's
    ``adam8bit(use_kernel=False)``, and 8-bit state at ~2 bytes a
    parameter."""
    shapes = [(700,), (64, 40)]
    init = [_rand(s, 20 + i) for i, s in enumerate(shapes)]
    jp = {"w": jnp.asarray(init[0]), "b": jnp.asarray(init[1])}
    tp = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
    tx = joptim.adam8bit(1e-2, use_kernel=False)
    sx = tx.init(jp)
    opt = toptim.Adam8bit(tp, lr=1e-2)
    for step in range(1, 5):
        g = _grads(shapes, step)
        upd, sx = tx.update({"w": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}, sx, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for p, gi in zip(tp, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        for p, name in zip(tp, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[name]),
                                       rtol=1e-5, atol=1e-6)
    n = sum(math.prod(s) for s in shapes)
    assert toptim.state_nbytes(opt) == joptim_mod.state_nbytes(sx)
    assert toptim.state_nbytes(opt) / n < 2.2


def test_adamw_decay():
    """tests/test_optim.py:64-71: a zero gradient leaves pure decay."""
    p = torch.ones(256, requires_grad=True)
    opt = toptim.AdamW8bit([p], lr=0.1, weight_decay=0.5)
    p.grad = torch.zeros(256)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.05, rtol=1e-5)


def test_adam8bit_bf16_param_takes_bf16_update():
    p = torch.zeros(300, dtype=torch.bfloat16, requires_grad=True)
    opt = toptim.Adam8bit([p], lr=1e-2)
    p.grad = torch.ones(300, dtype=torch.bfloat16)
    opt.step()
    assert p.dtype == torch.bfloat16
    # first step: m_hat / sqrt(v_hat) = 1, so the update is -lr, in bf16
    np.testing.assert_array_equal(p.detach().float().numpy(),
                                  torch.tensor(-1e-2).to(torch.bfloat16).float().numpy())


def _ulps_apart(a, b, dtype):
    """|a - b| in units of ``dtype``'s spacing at b (f32 or bf16 values)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    spacing = np.abs(np.spacing(b)) * (2.0 ** 16 if dtype == "bfloat16" else 1.0)
    return np.abs(a - b) / spacing


# leaves of a multi-leaf step: ragged against 256 (700, 2560 + 40) and
# against 8 (15), and one of whole blocks
STEP_SHAPES = [(700,), (64, 40), (3, 5), (2, 256)]


def _step_inputs(shapes, dtype, step):
    """Gradients in ``dtype``; the first leaf's first block all zero."""
    out = []
    for i, s in enumerate(shapes):
        g = _rand(s, 100 * step + i, 10.0 ** (step - 3)).reshape(-1)
        if i == 0:
            g[:256] = 0.0
        out.append(torch.from_numpy(g.reshape(s)).to(getattr(torch, dtype)))
    return out


def _zero_states(shapes):
    states = []
    for s in shapes:
        mc, ms = toptim._quant_m(torch.zeros(s))
        vc, vs = toptim._quant_v(torch.zeros(s))
        states.append(dict(zip(tadam.STATE_KEYS, (mc, ms, vc, vs))))
    return states


def _f32_ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam8bit_step_reference_matches_jax(dtype, wd):
    """The plain multi-leaf step over 3 chained steps against the JAX
    package, leaf by leaf from the port's state and parameters of each
    step: its Pallas kernel (interpret), then ``upd - lr * wd * p`` and
    ``p + upd.astype(p.dtype)``.

    Tolerances: XLA on the CPU contracts the interpreted kernel's
    ``b * m + c * g`` into FMAs and turns ``/ 127`` into a product with the
    reciprocal, so its block scales may sit up to 2 f32 ulps from the
    port's and a code one step away (they are equal where the scales are),
    and its update within rtol 1e-5 (as
    ``test_adam8bit_update_reference_matches_jax``). The decay and the add,
    given the port's update, leave p within 1 ulp of its dtype: XLA may
    contract the decay's product and difference into one FMA, whose f32
    result can round to the neighbouring value of p."""
    lr, b1, b2 = 1e-2, 0.9, 0.999
    params = [torch.from_numpy(_rand(s, 40 + i)).to(getattr(torch, dtype))
              for i, s in enumerate(STEP_SHAPES)]
    states = _zero_states(STEP_SHAPES)
    for step in range(1, 4):
        grads = _step_inputs(STEP_SHAPES, dtype, step)
        bc1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
        bc2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
        # numpy copies: the port steps in place, and jnp.asarray may share a buffer
        before = [(p.float().numpy().copy(), [st[k].numpy().copy() for k in tadam.STATE_KEYS])
                  for p, st in zip(params, states)]
        upds = [tadam.adam8bit_update_reference(tadam.blockify(g)[0], *(st[k] for k in
                                                tadam.STATE_KEYS), lr, bc1, bc2)[0]
                for g, st in zip(grads, states)]
        tadam.adam8bit_step_reference(params, grads, states,
                                      torch.tensor([lr, bc1, bc2], dtype=torch.float32), lr=lr,
                                      weight_decay=wd, b1=b1, b2=b2)
        for (p0, st0), p, st, g, upd in zip(before, params, states, grads, upds):
            gb, n = tadam.blockify(g)
            jupd, *jst = jadam.adam8bit_update(jnp.asarray(gb.numpy()),
                                               *map(jnp.asarray, st0), np.float32(lr), bc1,
                                               bc2, interpret=True)
            np.testing.assert_allclose(upd.numpy(), np.asarray(jupd), rtol=1e-5, atol=1e-7)
            for codes, scale, jcodes, jscale in ((st["m_codes"], st["m_scale"], *jst[:2]),
                                                 (st["v_codes"], st["v_scale"], *jst[2:])):
                ulps = _f32_ulps(scale.numpy(), jscale)
                assert ulps.max() <= 2
                diff = np.abs(codes.numpy().astype(np.int32) - np.asarray(jcodes, np.int32))
                assert diff.max() <= 1 and (diff[ulps[:, 0] == 0] == 0).all()
            jp = jnp.asarray(p0).astype(getattr(jnp, dtype))
            ju = jnp.asarray(upd.numpy()).reshape(-1)[:n].reshape(g.shape)
            if wd:
                ju = ju - lr * wd * jp.astype(jnp.float32)
            want = np.asarray((jp + ju.astype(jp.dtype)).astype(jnp.float32))
            assert _ulps_apart(p.float().numpy(), want, dtype).max() <= 1.0
        assert np.all(states[0]["m_codes"][0].numpy() == 0)  # the all-zero block


def test_adam8bit_kernel_route_steps_in_place(fake_kernels):
    """The multi-leaf kernel route (``FakeKernels`` running the plain
    arithmetic over the C entry point's leaf table, capped at 3 leaves a
    launch) against the plain multi-leaf step: every p and every state
    tensor equal over 3 chained steps, bf16 and f32 leaves in one call, wd >
    0, ragged leaves, a transposed (non-contiguous) gradient; 7 leaves make
    3 launches of one C call. The one-leaf op reads the same table."""
    shapes = STEP_SHAPES + [(40, 64), (5,), (300,)]
    dtypes = ["float32", "bfloat16"] * 4
    runs = {}
    for route in (True, False):
        params = [torch.from_numpy(_rand(s, 60 + i)).to(getattr(torch, d))
                  for i, (s, d) in enumerate(zip(shapes, dtypes))]
        states = _zero_states(shapes)
        _build.reset_launches()
        with mock.patch.object(FakeKernels, "table_leaves", 3):
            for step in range(1, 4):
                grads = [g.to(p.dtype) for g, p in
                         zip(_step_inputs(shapes, "float32", step), params)]
                grads[4] = grads[4].T.contiguous().T  # (40, 64) with (1, 40) strides
                assert not grads[4].is_contiguous()
                scalars = torch.tensor([1e-2, 1 - 0.9 ** step, 1 - 0.999 ** step])
                tadam.adam8bit_step(params, grads, states, scalars, lr=1e-2,
                                    weight_decay=1e-2, use_kernel=route)
        assert _build.launches["adam8bit_update"] == (9 if route else 0)
        runs[route] = (params, states)
    for p, q in zip(runs[True][0], runs[False][0]):
        assert p.dtype == q.dtype and torch.equal(p, q)
    for a, b in zip(runs[True][1], runs[False][1]):
        assert all(torch.equal(a[k], b[k]) for k in tadam.STATE_KEYS)
    # the one-leaf op: fresh outputs, the update out, no parameter
    g = torch.from_numpy(_rand((5, 256), 7))
    st = list(_zero_states([(5, 256)])[0].values())
    outs = [tadam.adam8bit_update(g, *st, 1e-3, 0.1, 0.001, use_kernel=uk) for uk in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert _build.launches["adam8bit_update"] == 1


def test_adam8bit_groups_leaves_by_step_count(fake_kernels):
    """Adam8bit on the kernel route makes one C call per (device, step
    count): a leaf that missed a step goes in a second call; a sparse
    gradient is refused on either route."""
    ps = [torch.zeros(300, requires_grad=True), torch.zeros(40, requires_grad=True)]
    opt = toptim.Adam8bit(ps, lr=1e-2)
    ps[0].grad = torch.ones(300)
    opt.step()
    ps[1].grad = torch.ones(40)
    _build.reset_launches()
    opt.step()
    assert [opt.state[p]["step"] for p in ps] == [2, 1]
    assert _build.launches["adam8bit_update"] == 2
    for use_kernel in (None, False):
        opt = toptim.Adam8bit([ps[1]], lr=1e-2, use_kernel=use_kernel)
        ps[1].grad = torch.ones(40).to_sparse()
        with pytest.raises(ValueError, match="dense gradient"):
            opt.step()


def test_adam8bit_keeps_its_leaf_table_while_it_holds(fake_kernels):
    """The optimizer reuses its leaf table from step to step, and builds a
    new one when a parameter's storage or the state tensors change (here
    ``p.data = ...`` and ``load_state_dict``, which keeps the state's int8,
    uint8 and f32 dtypes on bf16 and f32 leaves); the parameters then step
    as the plain multi-leaf step steps them."""
    ps = [torch.from_numpy(_rand(s, 70 + i)).to(dtype).requires_grad_()
          for i, (s, dtype) in enumerate(zip(STEP_SHAPES, [torch.float32, torch.bfloat16] * 2))]
    ref = [p.detach().clone() for p in ps]
    ref_states = _zero_states(STEP_SHAPES)
    opt = toptim.Adam8bit(ps, lr=1e-2)
    tables = []
    for step in range(1, 5):
        grads = [g.to(p.dtype) for g, p in zip(_step_inputs(STEP_SHAPES, "float32", step), ps)]
        for p, g in zip(ps, grads):
            p.grad = g
        if step == 3:
            ps[1].data = ps[1].data.clone()  # new storage: the old table would write the old
        if step == 4:
            opt.load_state_dict(opt.state_dict())  # new state tensors
        opt.step()
        tables.append(opt._tables[(0, torch.device("cpu"))])
        scalars = toptim.Adam8bit._scalars(1e-2, 0.9, 0.999, step, torch.device("cpu"))
        tadam.adam8bit_step_reference(ref, grads, ref_states, scalars, lr=1e-2)
        for p, q in zip(ps, ref):
            assert torch.equal(p.detach(), q)
    assert tables[0] is tables[1] and tables[2] is not tables[1] and tables[3] is not tables[2]
    for st, want in zip(opt.state.values(), ref_states):
        assert all(st[k].dtype == want[k].dtype and torch.equal(st[k], want[k])
                   for k in tadam.STATE_KEYS)


# --------------------------------------------------------------- LoRA


@pytest.mark.parametrize("base_fmt", ["nf4", "dense"])
def test_lora_linear_matches_jax(base_fmt):
    x, w = _rand((6, 256), 8), _rand((256, 128), 9)
    base = jnp.asarray(w)
    if base_fmt != "dense":
        base = jcore.quantize_matmul_weight(base, fmt=base_fmt, block_size=64)
    lw = jlora.init_lora(base, jax.random.PRNGKey(0), rank=8, dtype=jnp.float32)
    lw = jlora.LoRAWeight(base=lw.base, lora_a=lw.lora_a,
                          lora_b=jnp.asarray(_rand((8, 128), 10, 0.1)), alpha=lw.alpha)
    ref = np.asarray(jnn.linear(jnp.asarray(x), lw, use_kernel=False))
    tl = interop.from_jax_params({"w": lw})["w"]
    assert isinstance(tl, tnn.LoRAWeight) and tl.rank == 8 and tl.lora_b.requires_grad
    out = tnn.linear(torch.from_numpy(x), tl)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-4)
    merged = np.asarray(jlora.merge_lora(lw))
    np.testing.assert_allclose(tnn.merge_lora(tl).numpy(), merged, rtol=1e-5, atol=1e-5)


def test_init_lora_and_add_lora():
    g = torch.Generator().manual_seed(0)
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(g, cfg)
    qp = tnn.quantize_params(params, mode="nf4", min_size=1024)
    lp = ttrain.add_lora(qp, g, rank=4, alpha=8.0, dtype=torch.float32)
    w = lp["layers"][0]["wq"]
    assert isinstance(w, tnn.LoRAWeight) and w.base is qp["layers"][0]["wq"]
    assert w.lora_a.shape == (128, 4) and w.lora_b.shape == (4, 128)
    assert torch.count_nonzero(w.lora_b) == 0 and w.lora_a.requires_grad
    # A ~ normal / sqrt(rank)
    a = torch.cat([lay[n].lora_a.flatten() for lay in lp["layers"] for n in ("wq", "wv")])
    assert 0.4 < a.std().item() < 0.6
    ads = ttrain.extract_adapters(lp)
    assert [sorted(d) for d in ads] == [["wq", "wv"]] * cfg.n_layers
    assert len(list(tnn.lora_parameters(lp))) == 4 * cfg.n_layers
    swapped = ttrain.merge_adapters(lp, [{k: {"a": v["a"] * 0, "b": v["b"]} for k, v in d.items()}
                                         for d in ads])
    assert torch.count_nonzero(swapped["layers"][1]["wv"].lora_a) == 0
    assert lp["layers"][1]["wv"].lora_a.abs().sum() > 0


def test_causal_lm_loss_matches_jax():
    logits, tgt = _rand((2, 5, 11), 11), np.random.default_rng(12).integers(0, 11, (2, 5))
    mask = (np.arange(5)[None, :] < np.array([[5], [3]])).astype(np.float32)
    for mk in (None, mask):
        ref = float(jtrain.causal_lm_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                          None if mk is None else jnp.asarray(mk)))
        out = ttrain.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                                    None if mk is None else torch.from_numpy(mk))
        np.testing.assert_allclose(out.item(), ref, rtol=1e-6)


# ------------------------------------------------------- the whole slice


@pytest.mark.parametrize("fmt", ["nf4", "nf4a"])
def test_qlora_train_step_matches_jax(fmt):
    """JAX ``make_qlora_train_step(use_kernel=False)`` against the port's
    on the CPU: tiny config in f32, f32 rank-8 adapters on wq and wv,
    adam8bit lr 1e-2, 3 steps on one batch. Per-step loss within rel
    1e-4, the step-1 lora_b gradients within rel-L2 1e-4, the adapters
    after step 3 within rel-L2 1e-3 (room for a few m codes that flip at a
    rounding edge)."""
    cfg_j = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    cfg_t = tllama.LlamaConfig.tiny(dtype=torch.float32)
    dense = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    pj = jtrain.add_lora(jnn.quantize_params(dense, mode=fmt, block_size=64, min_size=1024),
                         jax.random.PRNGKey(2), rank=8, dtype=jnp.float32)
    pt = interop.from_jax_params(pj)
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (2, 17)).astype(np.int32)
    bj = {"inputs": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    bt = {"inputs": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}

    def loss_fn(ad):
        logits, _ = jllama.forward(jtrain.merge_adapters(pj, ad), bj["inputs"], cfg_j,
                                   use_kernel=False)
        return jtrain.causal_lm_loss(logits, bj["targets"])

    aj = jtrain.extract_adapters(pj)
    gj = jax.grad(loss_fn)(aj)
    tx = joptim.adam8bit(1e-2)
    sj = tx.init(aj)
    jstep = jax.jit(jtrain.make_qlora_train_step(cfg_j, tx, use_kernel=False))
    opt = toptim.Adam8bit(tnn.lora_parameters(pt), lr=1e-2)
    tstep = ttrain.make_qlora_train_step(cfg_t, opt)
    losses = []
    for step in range(3):
        aj, sj, lj = jstep(aj, sj, pj, bj)
        lt = tstep(pt, bt)
        losses.append(lt.item())
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-4)
        if step == 0:
            for ad_t, ad_j in zip(ttrain.extract_adapters(pt), gj):
                for name in ("wq", "wv"):
                    assert torch.count_nonzero(ad_t[name]["a"].grad) == 0  # B starts at 0
                    assert _rel_l2(ad_t[name]["b"].grad.numpy(), ad_j[name]["b"]) < 1e-4
    assert losses[2] < losses[0]
    for ad_t, ad_j in zip(ttrain.extract_adapters(pt), aj):
        for name in ("wq", "wv"):
            for ab in ("a", "b"):
                assert _rel_l2(ad_t[name][ab].detach().numpy(), ad_j[name][ab]) < 1e-3


def test_train_step_full_parameters():
    """make_train_step over dense parameters that all require a gradient."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    leaves = [params["tok_emb"], params["norm_f"], params["lm_head"]] + [
        t for lay in params["layers"] for t in lay.values()]
    for t in leaves:
        t.requires_grad_()
    opt = toptim.Adam8bit(leaves, lr=1e-2)
    step = ttrain.make_train_step(cfg, opt)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 9)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    losses = [step(params, batch).item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert all(t.grad is not None for t in leaves)


# ------------------------------- kernel routes, rehearsed with fake kernels




@pytest.fixture
def fake_kernels():
    """Every wrapper takes its kernel route on CPU tensors, into FakeKernels."""
    with kernel_routes():
        yield


def test_kernel_routes_refuse_autograd(fake_kernels):
    """A kernel without a backward never hands back a tensor that silently
    carries no gradient: under autograd its route raises, before any
    launch; ``matmul_quantized`` takes the raw 4-bit kernel through its
    autograd Function, whose backward launches ``matmul_4bit_t``."""
    x = torch.from_numpy(_rand((4, 128), 13)).requires_grad_()
    w = torch.from_numpy(_rand((128, 64), 14))
    qt = tcore.quantize_matmul_weight(w, fmt="nf4", block_size=64)
    with pytest.raises(NotImplementedError, match="no backward"):
        tmm.matmul_4bit(x, qt.codes, qt.scale, codebook="nf4")
    for leaf in (tint8.quantize_int8_weight(w), tint4c.quantize_int4c_weight(w)):
        with pytest.raises(NotImplementedError, match="QuantizedTensor"):
            tnn.linear(x, leaf)
    with pytest.raises(NotImplementedError, match="no backward"):
        tint8.matmul_int8_fused(x, torch.zeros((128, 64), dtype=torch.int8), torch.ones(4),
                                torch.ones(64), torch.zeros(4, 64))
    assert sum(_build.launches.values()) == 0
    # without autograd the same routes launch
    with torch.no_grad():
        tmm.matmul_4bit(x, qt.codes, qt.scale, codebook="nf4")
    assert _build.launches["matmul_4bit"] == 1
    # through the Function: forward and backward kernels, the plain gradient
    y = tnn.linear(x, qt)
    (y ** 2).sum().backward()
    assert (_build.launches["matmul_4bit"], _build.launches["matmul_4bit_t"]) == (2, 1)
    xp = x.detach().clone().requires_grad_()
    (tmm.matmul_quantized(xp, qt, use_kernel=False) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), xp.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_flash_kernel_route_refuses_autograd(fake_kernels, needs_grad):
    """The raw flash forward raises before its launch when any of q, k and
    v needs a gradient; ``flash_attention`` takes that input through its
    autograd Function and hands it the plain route's gradient."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 8, 4, 32), (2, 8, 2, 32), (2, 8, 2, 32)))
    q_start, kv_len = torch.tensor([0, 0]), torch.tensor([8, 5])
    grads = {}
    for route in (None, False):
        ins = {"q": q.clone(), "k": k.clone(), "v": v.clone()}
        ins[needs_grad].requires_grad_()
        _build.reset_launches()
        if route is None:
            with pytest.raises(NotImplementedError, match="no backward"):
                tattn.flash_forward(*ins.values(), q_start, kv_len)
            assert _build.launches["flash_fwd"] == 0
        out = tattn.flash_attention(*ins.values(), q_start, kv_len, use_kernel=route)
        (out ** 2).sum().backward()
        flash = [_build.launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
        assert flash == [1 if route is None else 0] * 3
        grads[route] = ins[needs_grad].grad
    np.testing.assert_allclose(grads[None].numpy(), grads[False].numpy(), rtol=1e-5, atol=1e-6)


def test_qlora_kernel_route_launches(fake_kernels):
    """One QLoRA step on the kernel routes: every quantized linear launches
    ``matmul_4bit`` once; ``matmul_4bit_t`` runs for each whose input needs
    a gradient (all but layer 0's wq, wk and wv, which see the frozen
    embedding); one ``adam8bit_update`` a step, over every adapter tensor.
    The result is the plain route's."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    dense = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    base = tnn.quantize_params(dense, mode="nf4", min_size=1024)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 9)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    trees, losses = {}, {}
    for route in (None, False):
        params = ttrain.add_lora(base, torch.Generator().manual_seed(1), rank=4,
                                 dtype=torch.float32)
        opt = toptim.Adam8bit(tnn.lora_parameters(params), lr=1e-2, use_kernel=route)
        step = ttrain.make_qlora_train_step(cfg, opt, use_kernel=route)
        _build.reset_launches()
        losses[route] = [step(params, batch).item() for _ in range(2)]
        per_forward = 7 * cfg.n_layers + 1
        expected = dict.fromkeys(_build.launches, 0)
        if route is None:
            expected.update(matmul_4bit=2 * per_forward, matmul_4bit_t=2 * (per_forward - 3),
                            adam8bit_update=2)
        assert dict(_build.launches) == expected
        trees[route] = ttrain.extract_adapters(params)
    np.testing.assert_allclose(losses[None], losses[False], rtol=1e-5)
    for a, b in zip(trees[None], trees[False]):
        for name in ("wq", "wv"):
            # the kernel route's bias correction is -(lr/bc1)·m, the plain route's -lr·(m/bc1)
            assert _rel_l2(a[name]["b"].detach().numpy(), b[name]["b"].detach().numpy()) < 1e-5


@pytest.mark.parametrize("fmt", ["nf8", "int8a"])
def test_qlora_8bit_kernel_route_launches(fake_kernels, fmt):
    """One QLoRA step on an 8-bit base through the kernel routes: every
    quantized linear launches ``matmul_8bit`` once, ``matmul_8bit_t`` runs
    for each whose input needs a gradient (all but layer 0's wq, wk and
    wv), no 4-bit kernel runs; losses and lora_b gradients are the plain
    route's (int8a's zero-point terms stay outside the kernels on both)."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    dense = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    base = tnn.quantize_params(dense, mode=fmt, min_size=1024)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 9)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    losses, grads = {}, {}
    for route in (None, False):
        params = ttrain.add_lora(base, torch.Generator().manual_seed(1), rank=4,
                                 dtype=torch.float32)
        opt = toptim.Adam8bit(tnn.lora_parameters(params), lr=1e-2, use_kernel=route)
        step = ttrain.make_qlora_train_step(cfg, opt, use_kernel=route)
        _build.reset_launches()
        losses[route] = step(params, batch).item()
        per_forward = 7 * cfg.n_layers + 1
        expected = dict.fromkeys(_build.launches, 0)
        if route is None:
            expected.update(matmul_8bit=per_forward, matmul_8bit_t=per_forward - 3,
                            adam8bit_update=1)
        assert dict(_build.launches) == expected
        grads[route] = [ad[name]["b"].grad.clone() for ad in ttrain.extract_adapters(params)
                        for name in ("wq", "wv")]
    np.testing.assert_allclose(losses[None], losses[False], rtol=1e-6)
    for a, b in zip(grads[None], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_qlora_flash_kernel_route_launches(fake_kernels):
    """One QLoRA step with use_flash=True on the kernel routes: every layer
    launches the flash forward once and, through the autograd Function's
    backward, the dQ and the dK/dV kernels once each; losses and lora_b
    gradients are the plain route's."""
    _flash_step_launches(tllama.LlamaConfig.tiny(dtype=torch.float32))


def test_qlora_flash_kernel_route_launches_at_head_dim_100(fake_kernels):
    """The same step on a tiny Llama of OpenLLaMA-3B's head dim, 100 (dim
    200, 2 heads, 2 layers), which the kernels run padded to 128 columns:
    2 launches of each flash kernel, the plain route's losses and lora_b
    gradients."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, dim=200, n_heads=2, n_kv_heads=2)
    assert cfg.head_dim == 100 and cfg.n_layers == 2
    _flash_step_launches(cfg)


def _flash_step_launches(cfg):
    dense = tllama.init_params(torch.Generator().manual_seed(0), cfg)
    base = tnn.quantize_params(dense, mode="nf4", min_size=1024)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 17)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    losses, grads = {}, {}
    for route in (None, False):
        params = ttrain.add_lora(base, torch.Generator().manual_seed(1), rank=4,
                                 dtype=torch.float32)
        opt = toptim.Adam8bit(tnn.lora_parameters(params), lr=1e-2, use_kernel=route)
        step = ttrain.make_qlora_train_step(cfg, opt, use_kernel=route, use_flash=True)
        _build.reset_launches()
        losses[route] = step(params, batch).item()
        flash = {k: _build.launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        n = cfg.n_layers if route is None else 0
        assert flash == dict.fromkeys(flash, n)
        grads[route] = [ad[name]["b"].grad.clone() for ad in ttrain.extract_adapters(params)
                        for name in ("wq", "wv")]
    np.testing.assert_allclose(losses[None], losses[False], rtol=1e-6)
    for a, b in zip(grads[None], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
