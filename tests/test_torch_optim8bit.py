"""The port's AdamW8bit against the JAX package's jitted `adamw_8bit`, on the CPU.

Inputs from a numpy seed. The JAX optimizer runs under `jax.jit`, as the
JAX trainer runs it, where XLA turns `max|x| / 127` into a product with the
fp32 reciprocal and `mu_hat / (sqrt(nu_hat) + eps)` into one division; the
port computes both the same way. Tolerances: the int8 codes bit-equal;
block scales and parameters within 1e-6 of the largest magnitude (the
global norm's sum runs in another order, so the clipped gradients may differ
by an ulp); the norm within 1e-6 relative.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualforce_tpu.engine import optim as joptim
from dualforce_tpu_torch.engine import optim as toptim
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

# 300 is not a multiple of 256; the 512-element parameter's first block gets
# zero gradients throughout
SHAPES = [(300,), (16, 32), (7, 5), (512,)]
REL = 1e-6


def _grads(steps=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        # the third step's gradients are large: the global-norm clip engages
        step = [(rng.standard_normal(s) * (2.0 if i == 2 else 0.05)).astype(np.float32)
                for s in SHAPES]
        step[3][:256] = 0.0
        out.append(step)
    return out


def _pair(params, lr=1e-2, wd=0.1, warmup=2, total=6, max_grad_norm=1.0):
    tx = joptim.adamw_8bit(lr=lr, weight_decay=wd, max_grad_norm=max_grad_norm,
                           schedule=joptim.warmup_schedule(lr, warmup, total, "cosine"))
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = toptim.AdamW8bit(tp, lr=lr, weight_decay=wd, max_grad_norm=max_grad_norm,
                           schedule=toptim.warmup_schedule(lr, warmup, total, "cosine"))
    return tx, tp, opt


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= REL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _adam_state(state):
    """The `ScaleByAdam8bitState` inside clip -> (adam, decay, lr)."""
    return state[1][0]


def test_adamw8bit_matches_jitted_jax():
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    tx, tp, opt = _pair(params)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    for i, step in enumerate(_grads()):
        jp, state = update([jnp.asarray(g) for g in step], state, jp)
        norm = opt.step([torch.from_numpy(g) for g in step])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(step)), rtol=REL)
        adam = _adam_state(state)
        assert int(adam.count) == opt.count == i + 1
        for k in range(len(SHAPES)):
            for name, (q, s), jq, js in (("mu", opt.mu[k], adam.mu_q[k], adam.mu_s[k]),
                                         ("nu", opt.nu[k], adam.nu_q[k], adam.nu_s[k])):
                assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
                assert s.dtype == torch.float32 and tuple(s.shape) == js.shape
                np.testing.assert_array_equal(q.numpy(), np.asarray(jq),
                                              err_msg=f"step {i} {name} {k}")
                _close(s.numpy(), js, f"step {i} {name} scale {k}")
            _close(tp[k].numpy(), jp[k], f"step {i} param {k}")
    # the zero block keeps zero moments (scale 0, divided by 1); the params moved
    assert not opt.mu[3][0][0].any() and float(opt.mu[3][1][0]) == 0.0
    assert all(not np.array_equal(t.numpy(), p) for t, p in zip(tp, params))


@pytest.mark.parametrize("size", [1, 255, 256, 257, 300])
def test_block_quantization_matches_jitted_jax(size):
    """`quantize_blocks` / `dequantize_blocks` against `_q8` / `_dq8` under
    jit: padding to whole blocks, an all-zero block, ties rounding to even."""
    rng = np.random.default_rng(size)
    x = (rng.standard_normal(size) * 1e-3).astype(np.float32)
    x[: min(size, 3)] = [127.0, 0.5, -1.5][: min(size, 3)]   # codes 127, 0.5, -1.5 -> 0, -2
    for arr in (x, np.zeros_like(x)):
        jq, js = jax.jit(lambda a: joptim._q8(a)[:2])(jnp.asarray(arr))
        q, s = toptim.quantize_blocks(torch.from_numpy(arr))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = toptim.dequantize_blocks(q, s, torch.from_numpy(arr))
        want = joptim._dq8(jq, js, arr.size, arr.shape)
        np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    assert not toptim.quantize_blocks(torch.zeros(size))[0].any()


def test_adamw8bit_state_round_trip():
    """state_dict through torch.save into a fresh optimizer: the resumed
    run ends bit-equal to the uninterrupted one."""
    rng = np.random.default_rng(2)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = _grads(seed=3)
    _, full_p, full = _pair(params)
    for step in grads:
        full.step([torch.from_numpy(g) for g in step])
    _, half_p, half = _pair(params)
    for step in grads[:3]:
        half.step([torch.from_numpy(g) for g in step])
    buf = io.BytesIO()
    torch.save({"params": half_p, "opt": half.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf)
    _, res_p, resumed = _pair([p.numpy() for p in saved["params"]])
    resumed.load_state_dict(saved["opt"])
    assert resumed.count == 3
    for step in grads[3:]:
        resumed.step([torch.from_numpy(g) for g in step])
    for a, b in zip(res_p, full_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for (qa, sa), (qb, sb) in zip(resumed.mu + resumed.nu, full.mu + full.nu):
        assert torch.equal(qa, qb) and torch.equal(sa, sb)


def test_zero_gradient_leaves_parameter_as_it_is():
    """Caveat 10: after a step with gradients, a step whose gradient is zero
    everywhere makes JAX's 8-bit update ~mu / eps for the entries whose
    second-moment codes rounded to 0 (far past lr, while optax's fp32 AdamW
    moves them by ~lr); the port leaves the parameter and its moments as
    they are, and updates the parameters that have gradients as JAX does."""
    rng = np.random.default_rng(4)
    n, lr = 4096, 1e-4
    p0 = np.zeros(n, np.float32)
    live = rng.standard_normal(64).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-4).astype(np.float32)
    g_live = [(rng.standard_normal(64) * 1e-2).astype(np.float32) for _ in range(2)]
    tx = joptim.adamw_8bit(lr=lr, weight_decay=0.0, max_grad_norm=None)
    jp = [jnp.asarray(p0), jnp.asarray(live)]
    state = tx.init(jp)
    tp = [torch.from_numpy(p0.copy()), torch.from_numpy(live.copy())]
    opt = toptim.AdamW8bit(tp, lr=lr, weight_decay=0.0, max_grad_norm=None)
    update = jax.jit(tx.update)
    for step, first in ((0, g), (1, np.zeros(n, np.float32))):
        u, state = update([jnp.asarray(first), jnp.asarray(g_live[step])], state, jp)
        jp = optax.apply_updates(jp, u)
        before = [t.clone() for t in tp]
        moments = [(q.clone(), s.clone()) for q, s in opt.mu + opt.nu]
        opt.step([torch.from_numpy(first), torch.from_numpy(g_live[step])])
        _close(tp[1].numpy(), jp[1], f"live parameter, step {step}")
    print(f"largest update of the zero-gradient step: JAX {float(jnp.abs(u[0]).max()):.3e}, "
          f"lr {lr}")                                      # shown with pytest -s
    assert float(jnp.abs(u[0]).max()) > 100 * lr          # JAX: far past the lr
    assert torch.equal(tp[0], before[0])                   # the port: unchanged
    assert torch.equal(opt.mu[0][0], moments[0][0]) and torch.equal(opt.nu[0][0], moments[2][0])
    assert not torch.equal(tp[1], before[1])


def test_build_optimizer_names():
    params = [torch.zeros(4, requires_grad=True)]
    assert isinstance(toptim.build_optimizer("AdamW8bit", params), toptim.AdamW8bit)
    assert isinstance(toptim.build_optimizer("AdamW", params), toptim.AdamW)
    assert isinstance(toptim.build_optimizer("Lion", params), toptim.OptaxChain)
    with pytest.raises(KeyError, match="Lions"):
        toptim.build_optimizer("Lions", params)
