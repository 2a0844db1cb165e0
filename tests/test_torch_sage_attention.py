"""The port's cap ("fast") mode of the flash forward and its int8-QK
("sage") attention against the JAX package, on the CPU.

On the CPU the wrappers run the kernels' plain versions; here they are held
against the JAX package's Pallas kernels run in interpret mode, as
`tests/test_flash_attention.py` runs them, with `block_q=block_k=128` on
both sides. Tolerances:
- cap mode in fp32: o at 2e-5 (JAX's own bound between its cap and exact
  modes), the gradients of q, k and v through the same call at 5e-4 (the
  backward is the exact mode's, from the cap-mode LSE);
- sage: the int8 values and scales equal those of JAX's prologue under jit
  on the same input, but for a level at an exact rounding tie, which the
  mean over the keys (summed in another order) can flip, counted and
  bounded; the outputs agree to relative L2 1e-3, and both lie within
  JAX's 2.5e-2 of `attention_ref` (the int8 resolution floor);
- the sage route's RoPE, which rotates in bf16 as JAX's does: bit-equal.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.ops import flash_attention as jfa
from dualforce_tpu.ops import rope as jax_rope
from dualforce_tpu.ops.attention import attention_ref as jax_attention_ref

from dualforce_tpu_torch.ops import attention as tatt
from dualforce_tpu_torch.ops import rope as trope
from dualforce_tpu_torch.ops import sage_attention as tsa
from dualforce_tpu_torch.ops.flash_attention import (FAST_SOFTMAX_CAP, flash_attention,
                                                     flash_attention_plain,
                                                     flash_attention_with_lse)

CAP = 30.0


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _qkv(seed, b, sq, sk, n, d=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, n, d), (b, sk, n, d), (b, sk, n, d)))


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def test_cap_constant_matches_jax():
    """The shift of JAX's cap and sage kernels, the port's, and the sage
    kernel's compile-time constant."""
    assert FAST_SOFTMAX_CAP == jfa.FAST_SOFTMAX_CAP == CAP
    src = (Path(tsa.__file__).parents[1] / "csrc" / "sage_fwd.cu").read_text()
    assert f"constexpr float kCap = {CAP:g}.f;" in src


@pytest.mark.parametrize("sq,sk,lens", [(300, 277, None), (256, 300, (300, 0))],
                         ids=["padded", "mask"])
def test_cap_mode_and_grads_match_pallas_interpret(sq, sk, lens):
    """o, and dq/dk/dv of sum(o * w), through JAX's cap-mode `flash_attention`
    and the port's; a kv mask with a length-0 row gives zeros in both."""
    b = 1 if lens is None else 2
    q, k, v = _qkv(0, b, sq, sk, 2)
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, kv_valid_len=jl, block_q=128, block_k=128,
                                softmax_cap=CAP)
        return jnp.sum(o * w), o

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                   has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    before = (flash_attention.launches, flash_attention.cap_launches)
    got = flash_attention(tq, tk, tv, tl, softmax_cap=CAP)
    (got * torch.from_numpy(w)).sum().backward()
    assert (flash_attention.launches, flash_attention.cap_launches) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=5e-4, atol=5e-4,
                                   err_msg=f"d{name}")
    if lens is not None:
        assert np.all(got[1].detach().numpy() == 0) and np.all(np.asarray(want)[1] == 0)


def test_cap_mode_lse():
    """The cap-mode LSE is (cap + log2 l) ln 2: the exact LSE where a row has
    keys, cap * ln 2 where it has none."""
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 260, 150, 2))
    lens = torch.tensor([150, 0], dtype=torch.int32)
    o, lse = flash_attention_with_lse(q, k, v, lens, softmax_cap=CAP)
    want_o, want_lse = flash_attention_plain(q, k, v, lens, return_lse=True)
    np.testing.assert_allclose(o[0].numpy(), want_o[0].numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse[0].numpy(), want_lse[0].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse[1].numpy(), CAP * np.log(2.0), rtol=1e-6)
    assert torch.count_nonzero(o[1]) == 0


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_quantized_bn(qf, kf, bq, bk):
    """JAX's own prologue of `_sage_fwd` (:800-813) on [BN, S, D] fp32 q and
    k, jitted as `_sage_fwd` runs, where XLA turns the divisions by Sk and by
    127 into products with their fp32 reciprocals."""
    bn, sq, d = qf.shape
    sk = kf.shape[1]
    kf = kf - jnp.mean(kf, axis=1, keepdims=True)
    sq_p, sk_p = jfa._ceil_to(sq, bq), jfa._ceil_to(sk, bk)
    qf = jnp.pad(qf, ((0, 0), (0, sq_p - sq), (0, 0)))
    kf = jnp.pad(kf, ((0, 0), (0, sk_p - sk), (0, 0)))
    qi, q_sc = jfa._block_quant_int8(qf, bq)
    ki, k_sc = jfa._block_quant_int8(kf, bk)
    q_sc = q_sc * (d ** -0.5 * jfa.LOG2E)
    return qi[:, :sq], q_sc, ki[:, :sk], k_sc


def _jax_quantized(q, k, bq, bk):
    """`_jax_quantized_bn` on [B, S, N, D] numpy inputs: (qi8, q block
    scales times D^-1/2 log2(e), ki8, k block scales), laid out [B, N, S, D]
    and [B, N, S/blk]."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    out = _jax_quantized_bn(jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * n, sq, d),
                            jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * n, sk, d), bq, bk)
    return tuple(np.asarray(x).reshape(b, n, *x.shape[1:]) for x in out)


def _ties(port_i8, jax_i8, what) -> int:
    diff = np.abs(port_i8.astype(np.int32) - jax_i8.astype(np.int32))
    assert diff.max(initial=0) <= 1, what
    count = int(np.count_nonzero(diff))
    assert count <= 1e-4 * diff.size, (what, count)
    return count


@pytest.mark.parametrize("sq,sk,vlen", [(256, 256, None), (300, 200, None),
                                        (256, 256, (100, 256))],
                         ids=["aligned", "padded", "mask"])
def test_sage_matches_pallas_interpret(sq, sk, vlen):
    """The geometries of `test_sage_int8_close_to_reference`."""
    b, n, d = (2 if vlen else 1), 2, 128
    q, k, v = _qkv(40, b, sq, sk, n, d)
    jl = jnp.asarray(vlen, jnp.int32) if vlen else None

    want, ref = map(np.asarray, jax.jit(lambda q, k, v: (
        jfa.sage_attention(q, k, v, kv_valid_len=jl, block_q=128, block_k=128),
        jax_attention_ref(q, k, v, kv_valid_len=jl)))(q, k, v))
    jqi, jqs, jki, jks = _jax_quantized(q, k, 128, 128)
    tl = torch.tensor(vlen, dtype=torch.int32) if vlen else None
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = tsa.sage_attention.launches
    got = tsa.sage_attention(tq, tk, tv, tl, block_q=128, block_k=128).numpy()
    assert tsa.sage_attention.launches == before          # the CPU never launches

    # the quantization: the same int8 values and scales as JAX's prologue
    bq, bk = tsa.sage_blocks(sq, sk, vlen is not None, 128, 128)
    assert (bq, bk) == (128, 128)
    qi, ki, qs, ks = tsa.sage_quantize(tq, tk, tl, 128, 128)
    ties = _ties(qi.permute(0, 2, 1, 3).numpy(), jqi, "q")
    ties += _ties(ki.permute(0, 2, 1, 3).numpy(), jki, "k")
    np.testing.assert_array_equal(qs.numpy(), np.repeat(jqs, bq, axis=2)[:, :, :sq])
    np.testing.assert_allclose(ks.numpy(), np.repeat(jks, bk, axis=2)[:, :, :sk],
                               rtol=1e-6)
    print(f"sage {sq}x{sk}: {ties} int8 levels differ at rounding ties")

    assert _rel(got, want) <= 1e-3
    assert _rel(got, ref) < 2.5e-2 and _rel(want, ref) < 2.5e-2


# (Sq, Sk, kv mask, (q block, k block)) at the 360p main path's shapes
BLOCKS = [
    (43120, 43120, False, (1232, 1960)),     # video self-attention
    (43120, 512, False, (1232, 512)),        # video text cross
    (43120, 403, False, (1232, 512)),        # a2v bridge
    (403, 43120, False, (512, 1960)),        # v2a bridge
    (403, 403, False, (512, 512)),           # audio self-attention
    (403, 512, False, (512, 512)),           # audio text cross
    (300, 200, True, (384, 256)),            # a kv mask takes no exact divisor
]


def test_sage_block_rule():
    """The quantization blocks at the 360p main path's shapes, and JAX's rule
    (one test over the table)."""
    for sq, sk, masked, want in BLOCKS:
        assert tsa.sage_blocks(sq, sk, masked) == want, (sq, sk)
        jq = jfa._exact_bq(sq, 1024, hi=1264) if sq > 1024 else 1024
        jq = min(jq, jfa._ceil_to(sq, 128))
        jk = (min(1024, jfa._ceil_to(sk, 128)) if masked else
              jfa._exact_bk(sk, 1024, hi_cap=2048) or min(1024, jfa._ceil_to(sk, 128)))
        assert (jq, jk) == want, (sq, sk)


def test_sage_refuses_grad_and_routes():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 256, 256, 1))
    with pytest.raises(RuntimeError):
        tsa.sage_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        out = tsa.sage_attention(q, k, v)
    assert out.grad_fn is None
    q = q.detach()
    assert torch.equal(tatt.attention(q, k, v, impl="sage"), tsa.sage_attention(q, k, v))
    assert torch.equal(tatt.attention(q, k, v, impl="fast"),
                       flash_attention(q, k, v, softmax_cap=CAP))
    short = q[:, :100]
    assert torch.equal(tatt.attention(short, k, v, impl="sage"),
                       tatt.attention_ref(short, k, v))
    assert torch.equal(tatt.attention(short, k, v, impl="pallas"),
                       flash_attention(short, k, v))


def test_sage_route_rope_in_bf16_matches_jax():
    """On the "sage" route the DiT self-attention rotates q and k in bf16, as
    JAX's `self_attention` does (`apply_rope_interleaved(compute_dtype=bf16)`):
    bit-equal, and off from the fp32 rotation by bf16 rounding."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 40, 2, 128)).astype(np.float32)
    ang = rng.uniform(0.0, 6.3, (40, 64)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    want = np.asarray(jax.jit(lambda *a: jax_rope.apply_rope_interleaved(
        *a, compute_dtype=jnp.bfloat16))(x, cos, sin))
    args = tuple(map(torch.from_numpy, (x, cos, sin)))
    got = trope.apply_rope_interleaved(*args, torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32
    assert not torch.equal(got, trope.apply_rope_interleaved(*args))
