"""The port's flash-attention forward and dispatcher against the JAX package.

On the CPU `flash_attention` runs the kernel's plain version; here it is
held against the JAX package's Pallas kernel run in interpret mode, as
`tests/test_flash_attention.py` runs it (fp32: 2e-5; bf16 inputs: 2e-2,
since the Pallas kernel rounds the pre-scaled q and the probabilities to
bf16 where the plain version stays in fp32). Sq/Sk are not multiples of
the block sizes, and the kv mask includes a length-0 row, which both
kernels return as zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.ops.attention import attention as jax_attention
from dualforce_tpu.ops.flash_attention import flash_attention as jax_flash

from dualforce_tpu_torch.ops import attention as tatt
from dualforce_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _qkv(seed, b, sq, sk, n, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((b, sq, n, d), (b, sk, n, d), (b, sk, n, d)))


@pytest.mark.parametrize("sq,sk", [(300, 200), (130, 520)])
@pytest.mark.parametrize("lens", [None, (200, 0)], ids=["nomask", "mask"])
def test_plain_matches_pallas_interpret(sq, sk, lens):
    q, k, v = _qkv(0, 2, sq, sk, 2, 128)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    want = np.asarray(jax_flash(q, k, v, kv_valid_len=jl, block_q=128, block_k=128))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    before = flash_attention.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), tl).numpy()
    assert flash_attention.launches == before      # the CPU never launches the kernel
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if lens is not None:
        assert np.all(got[1] == 0) and np.all(want[1] == 0)


def test_plain_bf16_matches_pallas_interpret():
    q, k, v = _qkv(1, 1, 300, 200, 2, 128)
    bf = jnp.bfloat16
    want = np.asarray(jax_flash(*(jnp.asarray(x, bf) for x in (q, k, v)),
                                block_q=128, block_k=128).astype(jnp.float32))
    got = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sq,d", [(300, 128), (100, 128), (300, 64)])
def test_dispatcher_matches_jax(sq, d):
    """The gate (Sq >= 256 and D % 128 == 0 take the flash path) and the
    numbers: JAX on the CPU always takes its reference path."""
    q, k, v = _qkv(2, 2, sq, 150, 2, d)
    lens = np.array([150, 37], np.int32)
    want = np.asarray(jax_attention(q, k, v, kv_valid_len=jnp.asarray(lens)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tl = torch.from_numpy(lens)
    got = tatt.attention(tq, tk, tv, kv_valid_len=tl)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    flash_path = sq >= 256 and d % 128 == 0
    route = flash_attention_plain if flash_path else tatt.attention_ref
    assert torch.equal(got, route(tq, tk, tv, tl))
    np.testing.assert_allclose(tatt.attention(tq, tk, tv, tl, impl="ref").numpy(), want,
                               rtol=2e-5, atol=2e-5)


def test_dispatcher_impl_hook_and_unported_modes():
    """The callable hook; an impl the JAX package does not know is refused.
    The JAX package's "fast", "sage" and "pallas" routes are ported: under
    the gate (8 queries) "fast" and "sage" take the reference, "pallas"
    takes the flash path regardless."""
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 8, 8, 1, 128))
    seen = []
    out = tatt.attention(q, k, v, impl=lambda *a: seen.append(a) or a[0])
    assert out is q and len(seen) == 1 and seen[0][3] is None
    with pytest.raises(ValueError):
        tatt.attention(q, k, v, impl="flash3")
    for impl in ("fast", "sage"):
        assert torch.equal(tatt.attention(q, k, v, impl=impl), tatt.attention_ref(q, k, v))
    assert torch.equal(tatt.attention(q, k, v, impl="pallas"), flash_attention_plain(q, k, v))


def test_wrapper_never_falls_back():
    """A tensor on neither the CPU nor a CUDA device is refused, not routed
    to the plain version."""
    q = torch.empty((1, 300, 1, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
