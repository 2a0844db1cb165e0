"""The port's flash-attention LSE output and backward against the JAX package.

On the CPU the port's wrappers run the kernels' plain versions, and the
backward is the port's own (`flash_attention_bwd` from the saved LSE, the
formula of the CUDA kernels), never autograd through the plain forward. They
are held against the JAX package's Pallas kernels run in interpret mode, as
`tests/test_flash_attention.py` runs them: the forward with `save_lse`
(`flash_attention_with_lse`) and `jax.grad` through `flash_attention`, whose
backward runs `_bwd_fused` or, with its `_BWD_MODE` set to "split",
`_bwd_split`; the port's side then takes `flash_attention_bwd_fused` or
`flash_attention_bwd_split` (one plain version serves both on the CPU).
Everything in fp32; tolerance 2e-5 on outputs and LSE and 1e-4 on gradients
(fp32 round-off over a few hundred keys). Shapes stay small (N 2, S <= 384,
D 128): the Pallas backward is slow in interpret mode. The routing between
the two backwards is held against JAX's `_bwd` at the sequence lengths of
the 360p and 720p paths, abstractly (`jax.eval_shape`).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu.ops.flash_attention import flash_attention as jax_flash
from dualforce_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse

from dualforce_tpu_torch.ops import flash_attention as fa

jax_fa = importlib.import_module("dualforce_tpu.ops.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCKS = dict(block_q=128, block_k=128)


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _inputs(seed, b, sq, sk, n=2, d=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, n, d), (b, sk, n, d), (b, sk, n, d), (b, sq, n, d),
                           (b, n, sq)))


def _grad_leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("sq,sk,lens", [(300, 200, None), (130, 384, (384, 37))],
                         ids=["nomask", "mask"])
def test_forward_lse_matches_pallas(sq, sk, lens):
    q, k, v, _, _ = _inputs(0, 2, sq, sk)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    want_o, want_lse = jax_flash_lse(q, k, v, kv_valid_len=jl, **BLOCKS)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got_o, got_lse = fa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), tl)
    assert got_lse.shape == (2, 2, sq) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def _route_both(monkeypatch, mode):
    """Force JAX's backward to `mode` ("fused" or "split") and the port's
    routing to the same; returns the routes taken, ("jax", route) and
    ("port", route) in call order."""
    monkeypatch.setattr(jax_fa, "_BWD_MODE", mode)
    monkeypatch.setattr(fa, "bwd_takes_split", lambda sq, d=128: mode == "split")
    taken = []
    for route in ("fused", "split"):
        jax_bwd = getattr(jax_fa, f"_bwd_{route}")
        monkeypatch.setattr(jax_fa, f"_bwd_{route}", lambda *a, _r=route, _f=jax_bwd, **kw:
                            taken.append(("jax", _r)) or _f(*a, **kw))
        wrapper = getattr(fa, f"flash_attention_bwd_{route}")
        monkeypatch.setattr(fa, f"flash_attention_bwd_{route}",
                            lambda *a, _r=route, _w=wrapper: taken.append(("port", _r))
                            or _w(*a))
    return taken


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("sq,sk,lens", [(300, 200, None), (257, 130, (130, 37))],
                         ids=["nomask", "mask"])
def test_flash_grads_match_pallas_backward(sq, sk, lens, mode, monkeypatch):
    """dq, dk, dv of `flash_attention` against `jax.grad` of the JAX
    package's `flash_attention` (its fused or its split Pallas backward), and
    the port's gradient comes from its own backward of the same route
    (`flash_attention_bwd_plain` on the CPU, called once), not from autograd
    through the plain forward."""
    q, k, v, do, _ = _inputs(1, 2, sq, sk)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, kv_valid_len=jl, **BLOCKS) * do)

    taken = _route_both(monkeypatch, mode)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    calls = []
    plain_bwd = fa.flash_attention_bwd_plain
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        lambda *a: calls.append(1) or plain_bwd(*a))
    tq, tk, tv = _grad_leaves(q, k, v)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = fa.flash_attention(tq, tk, tv, tl)
    out.backward(torch.from_numpy(do))
    assert calls == [1] and taken == [("jax", mode), ("port", mode)]
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=f"d{name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_lse_cotangent_matches_pallas_backward(mode, monkeypatch):
    """Gradients through both outputs of `flash_attention_with_lse`: the LSE
    cotangent folds into delta, as `_bwd_prepare` folds it for both of JAX's
    backwards."""
    q, k, v, do, dlse = _inputs(2, 1, 300, 260)
    lens = np.array([201], np.int32)

    def jloss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, kv_valid_len=jnp.asarray(lens), **BLOCKS)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    taken = _route_both(monkeypatch, mode)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _grad_leaves(q, k, v)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, torch.from_numpy(lens))
    torch.autograd.backward((o, lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    assert taken == [("jax", mode), ("port", mode)]
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=f"d{name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("sq", [403, 11440, 43120, 98304, 98305, 100800, 111600, 176400])
def test_bwd_routing_matches_jax(sq, monkeypatch):
    """The port routes a backward to the split kernels exactly where JAX's
    `_bwd` (default "auto" mode, default block_q) routes to `_bwd_split`:
    from 98,305 query rows at D = 128. JAX's side is traced abstractly, with
    `_bwd_fused` and `_bwd_split` replaced by recorders."""
    monkeypatch.setattr(jax_fa, "_BWD_MODE", "auto")
    taken = []
    for route in ("fused", "split"):
        monkeypatch.setattr(jax_fa, f"_bwd_{route}",
                            lambda q, *a, _r=route, **kw: taken.append(_r) or (q, q, q))
    x = jax.ShapeDtypeStruct((1, sq, 128), jnp.bfloat16)
    lse = jax.ShapeDtypeStruct((1, sq), jnp.float32)
    jax.eval_shape(lambda q, lse: jax_fa._bwd(q, q, q, q, lse, q, None, jax_fa.DEFAULT_BQ,
                                               jax_fa.DEFAULT_BK), x, lse)
    want = "split" if sq >= 98305 else "fused"
    assert taken == [want]
    assert fa.bwd_takes_split(sq) == (want == "split")


def test_plain_backward_zeros_for_masked_keys_and_empty_rows():
    """A row with no valid key has LSE -1e4 * ln 2, output 0 and zero dq;
    keys past each valid length get zero dk and dv."""
    q, k, v, do, dlse = _inputs(3, 3, 70, 90)
    lens = torch.tensor([90, 41, 0])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, lens, return_lse=True)
    assert torch.all(o[2] == 0)
    assert torch.allclose(lse[2], torch.tensor(-1e4 / fa.LOG2E))
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do), lens,
                                        torch.from_numpy(dlse))
    assert torch.all(dq[2] == 0)
    for i, n in enumerate(lens.tolist()):
        assert torch.all(dk[i, n:] == 0) and torch.all(dv[i, n:] == 0)
    assert torch.count_nonzero(dq[:2]) > 0 and torch.count_nonzero(dk[1, :41]) > 0


def test_no_grad_forward_skips_the_lse_and_autograd():
    """Serving (no grad) runs the forward without the LSE and records no
    graph; with grad the output's graph node is the port's backward."""
    q, k, v, _, _ = _inputs(4, 1, 40, 40)
    tq, tk, tv = _grad_leaves(q, k, v)
    with torch.no_grad():
        assert fa.flash_attention(tq, tk, tv).grad_fn is None
    out = fa.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__.startswith("GeneratedBackwardFor_dualforce_tpu_flash_fwd_lse")


def test_lse_only_cotangent_matches_pallas_backward():
    """A loss on the LSE alone: the unused output's cotangent arrives as
    None and counts as dO = 0."""
    q, k, v, _, dlse = _inputs(5, 1, 130, 140)

    def jloss(q, k, v):
        return jnp.sum(jax_flash_lse(q, k, v, **BLOCKS)[1] * dlse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _grad_leaves(q, k, v)
    _, lse = fa.flash_attention_with_lse(tq, tk, tv)
    lse.backward(torch.from_numpy(dlse))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=f"d{name}",
                                   **GRAD_TOL)


# --- host-side geometry of the CUDA backward (csrc/flash_bwd.cu) -------------
# The kernels cannot run here; what the wrappers compute for them can.

@pytest.mark.parametrize("sq,padded", [(1, 128), (103, 128), (128, 128), (129, 256),
                                       (11440, 11520), (98305, 98432), (176400, 176512)])
def test_bwd_rows_pad_to_whole_tiles(sq, padded):
    """lse and delta rows, and the fused kernel's dQ workspace, cover whole
    128-row tiles (the dq pass's CTA) and so whole 64-row dQ tiles."""
    assert fa._rows_padded(sq) == padded
    floats = fa.bwd_workspace_floats(2, 3, sq)
    assert floats == 2 * 3 * padded * 128 and floats % (64 * 128) == 0


@pytest.mark.parametrize("layout", ["contiguous", "packed_qkv", "heads_major"])
def test_tma_geometry_follows_the_view(layout):
    """The tensor-map arguments are the dims innermost first (128, N, S, B)
    and the byte strides of N, S and B, read from the view as it is: no copy."""
    b, s, n = 2, 300, 3
    if layout == "contiguous":
        x = torch.zeros(b, s, n, 128)
    elif layout == "packed_qkv":
        x = torch.zeros(b, s, 3, n, 128).unbind(2)[1]
    else:
        x = torch.zeros(b, n, s, 128).transpose(1, 2)
    dims_strides = fa.tma_geometry(x.shape, x.stride())
    assert dims_strides[:4] == (128, n, s, b)
    assert dims_strides[4:] == tuple(2 * x.stride(i) for i in (2, 1, 0))


def test_tma_geometry_of_size_one_dims():
    """A dim of size 1 is never stepped: its stride, whatever the view says,
    is handed over as 256 bytes."""
    x = torch.zeros(1, 5, 1, 128).as_strided((1, 5, 1, 128), (7, 128, 3, 1))
    assert fa.tma_geometry(x.shape, x.stride()) == (128, 1, 5, 1, 256, 256, 256)


@pytest.mark.parametrize("shape,stride", [
    ((1, 10, 2, 128), (2560, 256, 4, 1)),                  # 8-byte head stride
    ((1, 10, 2, 128), (2560, 0, 128, 1)),                  # rows broadcast
    ((2, 10, 1, 128), (2**39, 128, 128, 1)),               # 2^40-byte batch stride
    ((1, 2**31, 1, 128), (2**38, 128, 128, 1)),            # rows past int32 coordinates
], ids=["unaligned", "zero", "too_far", "too_long"])
def test_tma_geometry_refuses_what_a_tensor_map_cannot_take(shape, stride):
    with pytest.raises(ValueError):
        fa.tma_geometry(shape, stride)


def test_preprocess_kernel_takes_cuda_tensors_only():
    """The delta preprocess is a CUDA kernel; on the CPU `_delta` is its plain
    version and the backward uses it."""
    o, do = torch.zeros(1, 4, 1, 128), torch.zeros(1, 4, 1, 128)
    with pytest.raises(ValueError):
        fa.flash_bwd_preprocess(o, do, torch.zeros(1, 1, 4))
