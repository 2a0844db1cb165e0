"""The port's optimizer registry against the JAX package's, on the CPU in fp32.

Each of the sixteen names of `dualforce_tpu.registry.OPTIMIZERS` (AdamW,
AdamW8bit and the fourteen optax families) is built as both trainers build
it: `lr`, `betas`, `weight_decay`, `max_grad_norm` and a warmup schedule,
and again without `betas` where the factory rejects them. Three steps on
the same gradients (a 1-D parameter, one of 130 x 136, which Adafactor
factors, and a small 2-D one; the second step's gradients are large enough
to be clipped) must leave the parameters within 1e-6 (absolute and
relative) of optax's, fp32 round-off, with the same step count.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualforce_tpu.engine import optim as joptim
from dualforce_tpu.registry import OPTIMIZERS as JAX_OPTIMIZERS

from dualforce_tpu_torch.engine import optim as toptim
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

NAMES = ["AdamW", "AdamW8bit", "Adam", "Adamax", "NAdam", "NAdamW", "RAdam", "AdaBelief",
         "SGD", "RMSprop", "Adagrad", "Adadelta", "Lion", "LAMB", "Adafactor", "Novograd"]
SHAPES = [(7,), (130, 136), (3, 5)]
TOL = dict(rtol=1e-6, atol=1e-6)
MAX_NORM = 1.0


def _build(factory, *args, **kw):
    """As the trainers build an optimizer: with `betas`, else without."""
    try:
        return factory(*args, **kw)
    except TypeError:
        kw.pop("betas")
        return factory(*args, **kw)


def _kwargs(schedule):
    return dict(lr=1e-2, betas=(0.9, 0.999), weight_decay=0.1, max_grad_norm=MAX_NORM,
                schedule=schedule)


def _data(steps, seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * (20.0 if i == 1 else 0.05)).astype(np.float32)
              for s in SHAPES] for i in range(steps)]
    return params, grads


def _counts(state):
    return [int(c) for _, c in optax.tree_utils.tree_get_all_with_path(state, "count")]


def _run_both(name, steps):
    params, grads = _data(steps)
    tx = _build(JAX_OPTIMIZERS.get(name), **_kwargs(joptim.warmup_schedule(1e-2, 1, 10)))
    opt = _build(toptim.build_optimizer, name, [torch.from_numpy(p.copy()) for p in params],
                 **_kwargs(toptim.warmup_schedule(1e-2, 1, 10)))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for got, want, shape in zip(opt.params, jp, SHAPES):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{name} step {step + 1} {shape}")
    return opt, state, params


@pytest.mark.parametrize("name", NAMES)
def test_registry_optimizer_matches_jax(name):
    """Three steps, the second clipped, against the JAX factory's chain."""
    assert float(optax.global_norm(_data(3)[1][1])) > MAX_NORM
    opt, state, params = _run_both(name, 3)
    assert opt.count == 3 and set(_counts(state)) == {3}
    # the schedule's first lr is 0, so the params moved at steps 2 and 3
    assert not np.array_equal(opt.params[1].numpy(), params[1])


def test_radam_rectified_steps_match_jax():
    """RAdam's rectified update starts where its SMA length reaches 5 (about
    the sixth step at b2 0.999): eight steps cover both branches."""
    opt, state, _ = _run_both("RAdam", 8)
    assert opt.count == 8


def test_unknown_kwargs_raise_type_error():
    """The factories' TypeError is what the trainers' retry rule reads."""
    params = [torch.zeros(3)]
    for name in ("SGD", "RMSprop", "Adagrad", "Adadelta", "Adafactor"):
        with pytest.raises(TypeError):
            toptim.build_optimizer(name, params, betas=(0.9, 0.999))
        with pytest.raises(TypeError):
            JAX_OPTIMIZERS.get(name)(betas=(0.9, 0.999))
    with pytest.raises(KeyError, match="Nope"):
        toptim.build_optimizer("Nope", params)
    assert sorted(toptim.OPTIMIZERS) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_frozen_parameter_and_state_held(name):
    """`step(grads, frozen)`: the flagged parameter and its optimizer state
    stay bit-equal while the others move and the count advances."""
    params, grads = _data(3, seed=4)
    opt = _build(toptim.build_optimizer, name, [torch.from_numpy(p.copy()) for p in params],
                 **_kwargs(None))
    opt.step([torch.from_numpy(x) for x in grads[0]])
    before = [p.clone() for p in opt.params]
    state = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in _flat_state(opt, 1).items()}
    opt.step([torch.from_numpy(x) for x in grads[2]], frozen=[False, True, False])
    assert opt.count == 2
    assert torch.equal(opt.params[1], before[1])
    assert not torch.equal(opt.params[0], before[0])
    after = _flat_state(opt, 1)
    assert after.keys() == state.keys()
    for key, value in state.items():
        assert torch.equal(after[key], value), key


def _flat_state(opt, i):
    """Parameter i's optimizer state, by name."""
    if isinstance(opt, toptim.AdamW):
        st = opt.opt.state[opt.params[i]]
        return {k: v for k, v in st.items() if k != "step"}
    if isinstance(opt, toptim.AdamW8bit):
        return {"mu_q": opt.mu[i][0], "mu_s": opt.mu[i][1], "nu_q": opt.nu[i][0],
                "nu_s": opt.nu[i][1]}
    return dict(opt.state[i])


def test_state_dict_round_trip():
    """A registry optimizer resumed from its state dict steps as the one it
    came from."""
    params, grads = _data(3, seed=6)
    a = toptim.build_optimizer("Novograd", [torch.from_numpy(p.copy()) for p in params])
    a.step([torch.from_numpy(x) for x in grads[0]])
    b = toptim.build_optimizer("Novograd", [p.clone() for p in a.params])
    b.load_state_dict(a.state_dict())
    for opt in (a, b):
        opt.step([torch.from_numpy(x) for x in grads[1]])
    assert b.count == a.count == 2
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)
