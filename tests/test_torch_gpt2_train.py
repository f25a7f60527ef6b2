"""Port parity for full-parameter training of GPT-2:
``train.make_train_step(forward=gpt2.forward)`` against the JAX package's
``make_train_step(forward=gpt2.forward)``, on the CPU.

The JAX side makes a tiny GPT-2 in f32 and steps it with
``optim.adam8bit(use_kernel=False)`` (its XLA route); the port gets the
same numbers through ``interop.from_jax_params`` and steps every dense
leaf with ``optim.Adam8bit`` (its plain route on CPU tensors). Tokens
come from numpy. Two ports run: one chained from the tree both start
from, and one started before each step from JAX's parameters and 8-bit
state, so that a step's differences are its own. Tolerances:

  - losses: the synced port within rel 1e-5 at every step; the chained
    one within rel 1e-5 at step 1 and 1e-4 at steps 2-3;
  - gradients against ``jax.grad`` at every step: every leaf within 1e-5
    of its largest |gradient| (measured 5.8e-7 at step 1): the backward
    through the tied head (``wte`` takes the embedding's and the head's
    gradient), the layer norms, ``gelu_new`` and the causal attention;
  - parameters after each step: rtol 1e-5 / atol 1e-6, except where Adam
    turns the two frameworks' f32 rounding of a gradient into a step.
    Adam divides each element's moment by that element's own normalizer
    sqrt(v_hat), so a gradient difference above 1e-4 of it moves the step
    by more than atol. Those elements (at most 1% of them; measured 377 of
    120,576 at step 1, then 128, the key biases
    ``attn_qkv/b[dim:2*dim]``, whose gradient is zero in exact arithmetic
    since softmax ignores a shift shared by every key, so both frameworks
    step on rounding noise) stay within lr of JAX's (largest measured:
    1.1e-4, lr 1e-2);
  - 8-bit state after each step: every m and v code within one of JAX's
    (a near-tie of ``round`` resolved the other way), at most 1 in 1000
    differing.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quanta_tpu import optim as joptim
from quanta_tpu import train as jtrain
from quanta_tpu.models import gpt2 as jgpt2
from quanta_tpu_torch.ops.adam8bit import STATE_KEYS
from quanta_tpu_torch import interop
from quanta_tpu_torch import train as ttrain
from quanta_tpu_torch.models import gpt2 as tgpt2
from quanta_tpu_torch.models import llama as tllama
from quanta_tpu_torch.ops import _build
from quanta_tpu_torch.optim import Adam8bit
from quanta_tpu_torch.parallel.sharding import Mesh
from torch_fakes import FakeKernels, kernel_routes

# the package attribute ``quanta_tpu.optim.adam8bit`` is the function
jadam = importlib.import_module("quanta_tpu.optim.adam8bit")

LR = 1e-2
# Adam's step moves by about lr times a gradient difference over the
# element's normalizer sqrt(v_hat): above this share, by more than atol
NOISE_REL = 1e-4
NOISE_SHARE = 1e-2  # at most this share of the elements is stepped on such a difference
MAX_CODE_FLIPS = 1e-3


def _flat(tree, path=""):
    """(path, leaf) pairs in sorted-key order, JAX's leaf order (an 8-bit
    state, a named tuple, is a leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _at(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _batch(cfg, shape, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)
    return ({"inputs": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])},
            {"inputs": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])})


def test_gpt2_full_train_step_matches_jax():
    """Three steps of JAX's and the port's full-parameter GPT-2 step on the
    same batch, at the tolerances of the module docstring: the port
    chained from the tree both start from (losses), and the port started
    before each step from JAX's parameters and 8-bit state (gradients,
    parameters, state)."""
    jcfg, tcfg = jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()
    pj = jgpt2.init_params(jax.random.PRNGKey(0), jcfg)
    bj, bt = _batch(jcfg, (2, 33), 3)

    def loss_fn(p):
        logits, _ = jgpt2.forward(p, bj["inputs"], jcfg, use_kernel=False)
        return jtrain.causal_lm_loss(logits, bj["targets"])

    tx = joptim.adam8bit(LR, use_kernel=False)
    sj = tx.init(pj)
    jstep = jax.jit(jtrain.make_train_step(jcfg, tx, forward=jgpt2.forward, use_kernel=False))
    ports = {}
    for name in ("chained", "synced"):
        pt = interop.from_jax_params(pj)
        leaves = ttrain.dense_parameters(pt)
        assert len(leaves) == 4 + 12 * jcfg.n_layers
        opt = Adam8bit(leaves, lr=LR)
        ports[name] = (pt, opt, ttrain.make_train_step(tcfg, opt, forward=tgpt2.forward))
    pt, opt, tstep = ports["synced"]
    b2 = 0.999
    losses = []
    for step in range(1, 4):
        gj = dict(_flat(jax.grad(loss_fn)(pj)))
        for path, t in _flat(pt):  # JAX's parameters and state into the synced port
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(_at(pj, path))))
            if step > 1:
                for k, q in zip(STATE_KEYS, _at(sj.qstate, path)):
                    opt.state[t][k].copy_(torch.from_numpy(np.array(q)))
        # each element's Adam normalizer this step, sqrt(v_hat), from JAX's state
        vhat = {}
        for path, g in gj.items():
            q = _at(sj.qstate, path)
            v = np.asarray(jadam._deq_v(q.v_codes, q.v_scale, g.shape))
            vhat[path] = (b2 * v + (1 - b2) * np.asarray(g) ** 2) / (1 - b2 ** step)
        pj, sj, lj = jstep(pj, sj, bj)
        lt = tstep(pt, bt).item()
        lc = ports["chained"][2](ports["chained"][0], bt).item()
        losses.append(lc)
        np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
        np.testing.assert_allclose(lc, float(lj), rtol=1e-5 if step == 1 else 1e-4)
        n_flips = n_elems = n_noise = 0
        for path, t in _flat(pt):
            g = np.asarray(gj[path])
            err = np.abs(t.grad.numpy() - g).max()
            assert err <= 1e-5 * np.abs(g).max(), (step, path, err, np.abs(g).max())
            want = np.asarray(_at(pj, path))
            diff = np.abs(t.detach().numpy() - want)
            noise = np.abs(t.grad.numpy() - g) > NOISE_REL * np.sqrt(vhat[path])
            n_noise += int(noise.sum())
            assert (diff[~noise] <= 1e-6 + 1e-5 * np.abs(want[~noise])).all(), (
                step, path, diff[~noise].max())
            assert (diff[noise] <= LR).all(), (step, path, diff.max())
            ours = [opt.state[t][k].numpy().astype(np.int32) for k in ("m_codes", "v_codes")]
            theirs = [np.asarray(c).astype(np.int32) for c in _at(sj.qstate, path)[::2]]
            for a, b in zip(ours, theirs):
                assert np.abs(a - b).max() <= 1, (step, path)
                n_flips += int((a != b).sum())
            n_elems += t.numel()
        assert n_flips <= MAX_CODE_FLIPS * 2 * n_elems, (step, n_flips, n_elems)
        assert n_noise <= NOISE_SHARE * n_elems, (step, n_noise, n_elems)
    assert losses[2] < losses[0]
    # the key bias carries the noise: its gradient is rounding error on both sides
    d = jcfg.dim
    for i in range(jcfg.n_layers):
        g = np.asarray(gj[f"/layers/{i}/attn_qkv/b"])
        assert np.abs(g[d:2 * d]).max() < 1e-6 * np.abs(g).max()


def test_train_step_refuses_another_forward_on_a_mesh():
    """``parallel.spmd`` runs the Llama forward through its layout: a mesh
    takes no other forward; the default forward is still the Llama one."""
    cfg = tgpt2.GPT2Config.tiny()
    params = tgpt2.init_params(torch.Generator().manual_seed(0), cfg)
    opt = Adam8bit(ttrain.dense_parameters(params), lr=LR)
    mesh = Mesh(shape={"data": 2}, coords={"data": 0})
    with pytest.raises(ValueError, match="llama.forward"):
        ttrain.make_train_step(cfg, opt, forward=tgpt2.forward, mesh=mesh)
    ttrain.make_train_step(tllama.LlamaConfig.tiny(), opt, mesh=mesh)
    ttrain.make_train_step(tllama.LlamaConfig.tiny(), opt, forward=tllama.forward, mesh=mesh)


def test_dense_parameters_refuses_a_quantized_leaf():
    from quanta_tpu_torch import nn as tnn

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tnn.quantize_params(tllama.init_params(torch.Generator().manual_seed(0), cfg),
                                 mode="nf4", min_size=1024)
    with pytest.raises(TypeError, match="nn.lora_parameters"):
        ttrain.dense_parameters(params)


@pytest.mark.parametrize("n_layers,launches", [(2, 1), (12, 2)])
def test_gpt2_full_train_step_kernel_route_launches(n_layers, launches):
    """A full-parameter GPT-2 step on the kernel routes (``FakeKernels``):
    the dense forward launches nothing, the optimizer one
    ``adam8bit_update`` per 128 leaves (GPT-2 small's depth: 148 leaves, 2
    launches); step-1 losses equal, and step 2's within rel 1e-6 of the
    plain route's (the kernel's bias correction is -(lr/bc1)·m, the plain
    route's -lr·(m/bc1))."""
    cfg = tgpt2.GPT2Config.tiny(n_layers=n_layers)
    _, bt = _batch(cfg, (2, 17), 5)
    losses = {}
    for route in (None, False):
        params = tgpt2.init_params(torch.Generator().manual_seed(0), cfg)
        leaves = ttrain.dense_parameters(params)
        assert len(leaves) == 4 + 12 * n_layers
        with kernel_routes():
            opt = Adam8bit(leaves, lr=LR, use_kernel=route)
            step = ttrain.make_train_step(cfg, opt, forward=tgpt2.forward, use_kernel=route)
            losses[route] = [step(params, bt).item() for _ in range(2)]
            expected = dict.fromkeys(_build.launches, 0)
            if route is None:
                expected["adam8bit_update"] = 2 * launches
            assert dict(_build.launches) == expected
    assert FakeKernels.table_leaves == 128
    assert losses[None][0] == losses[False][0]
    np.testing.assert_allclose(losses[None][1], losses[False][1], rtol=1e-6)
    assert losses[None][1] < losses[None][0]
