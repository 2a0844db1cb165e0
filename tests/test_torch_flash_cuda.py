"""The CUDA flash-attention kernels (forward, its LSE output, the fused and
the split backward) against their plain versions, on the card.

Skips where there is no CUDA device. It imports no JAX, so on a machine
with the card it runs without the repository's JAX test configuration:
`python -m pytest --noconftest tests/test_torch_flash_cuda.py`.
Tolerance: bf16 output against the fp32 plain version on the same bf16
inputs, relative L2 error <= 1e-2; rows with no valid key are exactly 0.
"""

import pytest
import torch

from dualforce_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (1, 2, 300, 200, None),
    (2, 3, 130, 520, (520, 0)),
    (3, 4, 1000, 512, (512, 200, 0)),
    (1, 12, 403, 4031, None),
])
def test_kernel_matches_plain(cuda, b, n, sq, sk, lens):
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, n, 128, generator=g, device=cuda, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, tl)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(), tl)
    assert _rel(out, want) <= 1e-2
    if lens is not None:
        for i, length in enumerate(lens):
            if length == 0:
                assert torch.count_nonzero(out[i]) == 0


def test_kernel_reads_strided_views(cuda):
    """q/k/v as views into one packed [B, S, 3, N, D] tensor: no copy needed."""
    g = torch.Generator(cuda).manual_seed(1)
    qkv = torch.randn(1, 257, 3, 2, 128, generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    want = flash_attention_plain(q.float(), k.float(), v.float())
    assert _rel(out, want) <= 1e-2


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 300, 1, 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(x, x, x)                       # fp32
    y = torch.zeros(1, 300, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(y, y, y)                       # D = 64


# --- the forward at its tile edges, keyless rows, views, the split over keys --
# The kernel's tiles are 128 query rows and 128 keys: lengths on both sides of
# them, with and without the LSE (within 1e-3 absolute of the fp32 plain one).

def _fwd_inputs(cuda, b, n, sq, sk, lens, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, 128, generator=g, device=cuda, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, v, tl


def _check_fwd(q, k, v, tl, cap=None):
    from dualforce_tpu_torch.ops.flash_attention import flash_attention_with_lse

    before = (flash_attention.launches, flash_attention.cap_launches)
    out, lse = flash_attention_with_lse(q, k, v, tl, softmax_cap=cap)
    plain = flash_attention(q, k, v, tl, softmax_cap=cap)
    torch.cuda.synchronize()
    after = (flash_attention.launches, flash_attention.cap_launches)
    assert after == ((before[0] + 2, before[1]) if cap is None else (before[0], before[1] + 2))
    want, want_lse = flash_attention_plain(q.float(), k.float(), v.float(), tl,
                                           return_lse=True, softmax_cap=cap)
    assert _rel(out, want) <= 1e-2
    assert float((lse - want_lse).abs().max()) <= 1e-3
    assert torch.equal(out, plain)                     # the LSE output changes nothing else
    return out, lse


@pytest.mark.parametrize("sk", [1, 127, 128, 129, 257, 512])
@pytest.mark.parametrize("sq", [1, 63, 127, 128, 129, 403])
def test_forward_at_tile_edges(cuda, sq, sk):
    _check_fwd(*_fwd_inputs(cuda, 1, 2, sq, sk, None, 10))


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (3, 2, 300, 700, (700, 200, 0)),      # kv_len ends inside a key tile; a keyless batch
    (2, 3, 129, 129, (129, 0)),
    (3, 2, 403, 4031, (4031, 1000, 0)),   # a split call whose later ranges hold no key
])
def test_forward_keyless_rows(cuda, b, n, sq, sk, lens):
    from dualforce_tpu_torch.ops.flash_attention import LN2

    out, lse = _check_fwd(*_fwd_inputs(cuda, b, n, sq, sk, lens, 11))
    for i, length in enumerate(lens):
        if length == 0:
            assert torch.count_nonzero(out[i]) == 0
            assert float((lse[i] - (-1.0e4 * LN2)).abs().max()) <= 1e-3


def test_forward_without_keys(cuda):
    """Sk = 0: every row is keyless (zeros; the LSE -1e4 * ln 2, or cap * ln
    2 in cap mode), and no kernel is launched, there being no key to load."""
    from dualforce_tpu_torch.ops.flash_attention import LN2, flash_attention_with_lse

    q = torch.randn(1, 130, 2, 128, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 0, 2, 128, device=cuda, dtype=torch.bfloat16)
    for cap, shift in ((None, -1.0e4), (30.0, 30.0)):
        before = (flash_attention.launches, flash_attention.cap_launches)
        out, lse = flash_attention_with_lse(q, k, k, softmax_cap=cap)
        assert (flash_attention.launches, flash_attention.cap_launches) == before
        assert out.shape == q.shape and torch.count_nonzero(out) == 0
        assert lse.shape == (1, 2, 130)
        assert float((lse - shift * LN2).abs().max()) <= 1e-3


def test_forward_reads_heads_major_views(cuda):
    """q, k, v as [B, S, N, D] views of heads-major [B, N, S, D] tensors."""
    g = torch.Generator(cuda).manual_seed(12)
    q, k, v = (torch.randn(2, 3, s, 128, generator=g, device=cuda,
                           dtype=torch.bfloat16).transpose(1, 2) for s in (333, 517, 517))
    assert not q.is_contiguous()
    _check_fwd(q, k, v, None)


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (1, 2, 403, 4031, None),
    (3, 2, 403, 4031, (4031, 1000, 0)),
    (1, 12, 403, 43120, None),
])
def test_split_forward_matches_whole(cuda, b, n, sq, sk, lens, monkeypatch):
    """A call whose key range is split (`fwd_splits` > 1) against the same call
    left whole and the plain version; one launch each."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    q, k, v, tl = _fwd_inputs(cuda, b, n, sq, sk, lens, 13)
    ctas = b * n * -(-sq // fa.FWD_BLOCK_M)
    assert fa.fwd_splits(ctas, sk, fa._sm_count(q.device)) > 1
    split, split_lse = _check_fwd(q, k, v, tl)
    monkeypatch.setattr(fa, "fwd_splits", lambda ctas, sk, sms: 1)
    whole, whole_lse = _check_fwd(q, k, v, tl)
    assert _rel(split, whole.float()) <= 1e-2
    assert float((split_lse - whole_lse).abs().max()) <= 1e-3


# --- forward LSE output and the backward kernel -----------------------------
# Tolerances: the LSE within 1e-3 absolute of the fp32 plain version; dq, dk
# and dv (bf16, dq through an fp32 workspace that bulk reductions add into in
# an order that varies between runs) within 2e-2 relative L2 of the fp32 plain
# backward on the same bf16 q, k, v, o, dO and the kernel's own LSE.

def _bwd_inputs(cuda, b, n, sq, sk, lens, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, 128, generator=g, device=cuda, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    do = torch.randn(b, sq, n, 128, generator=g, device=cuda, dtype=torch.bfloat16)
    dlse = torch.randn(b, n, sq, generator=g, device=cuda)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, v, do, dlse, tl


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (1, 2, 300, 200, None),
    (2, 3, 130, 520, (520, 0)),
    (3, 2, 1000, 512, (512, 77, 0)),
    (1, 2, 403, 4031, None),
])
def test_lse_matches_plain(cuda, b, n, sq, sk, lens):
    from dualforce_tpu_torch.ops.flash_attention import flash_attention_with_lse

    q, k, v, _, _, tl = _bwd_inputs(cuda, b, n, sq, sk, lens, 2)
    before = flash_attention.launches
    out, lse = flash_attention_with_lse(q, k, v, tl)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, want_lse = flash_attention_plain(q.float(), k.float(), v.float(), tl,
                                           return_lse=True)
    assert _rel(out, want) <= 1e-2
    assert float((lse - want_lse).abs().max()) <= 1e-3


@pytest.mark.parametrize("b,n,sq,sk,lens,with_dlse", [
    (1, 2, 300, 200, None, False),
    (1, 2, 257, 403, None, True),
    (2, 3, 130, 520, (520, 0), True),
    (3, 2, 1000, 512, (512, 77, 0), True),
])
def test_bwd_kernel_matches_plain(cuda, b, n, sq, sk, lens, with_dlse):
    from dualforce_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                         flash_attention_bwd_plain,
                                                         flash_attention_with_lse)

    q, k, v, do, dlse, tl = _bwd_inputs(cuda, b, n, sq, sk, lens, 3)
    dlse = dlse if with_dlse else None
    o, lse = flash_attention_with_lse(q, k, v, tl)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, tl, dlse)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), tl, dlse)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape
        assert _rel(x, w) <= 2e-2, name
    if lens is not None:
        dq, dk, dv = got
        for i, length in enumerate(lens):
            if length == 0:
                assert torch.count_nonzero(dq[i]) == 0
            assert torch.count_nonzero(dk[i, length:]) == 0
            assert torch.count_nonzero(dv[i, length:]) == 0


def test_autograd_goes_through_the_kernels(cuda):
    """Gradients reach q, k and v through the backward kernel, and under
    no_grad the forward runs without the LSE output."""
    from dualforce_tpu_torch.ops.flash_attention import flash_attention_bwd

    q, k, v, do, _, _ = _bwd_inputs(cuda, 1, 2, 300, 300, None, 4)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    for x in (q, k, v):
        assert x.grad is not None and torch.count_nonzero(x.grad) > 0
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


# --- the split backward (dq pass + dk/dv pass) ------------------------------
# The same tolerance as the fused kernel's against the fp32 plain backward
# (2e-2 relative L2). The dk/dv pass is the fused kernel without its dQ
# product, so dk and dv must be bit-equal to the fused kernel's; the dq pass
# sums over key tiles in registers, so two runs must be bit-equal, and its dq
# differs from the fused kernel's (fp32 atomics, another summation order)
# only by rounding: within 2e-2.

def _split_and_fused(q, k, v, do, dlse, tl):
    from dualforce_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_attention_with_lse(q, k, v, tl)
    before = (fa.flash_attention_bwd.launches, fa.flash_attention_bwd.split_launches)
    split = fa.flash_attention_bwd_split(q, k, v, o, lse, do, tl, dlse)
    again = fa.flash_attention_bwd_split(q, k, v, o, lse, do, tl, dlse)
    fused = fa.flash_attention_bwd_fused(q, k, v, o, lse, do, tl, dlse)
    torch.cuda.synchronize()
    after = (fa.flash_attention_bwd.launches, fa.flash_attention_bwd.split_launches)
    assert after == (before[0] + 1, before[1] + 2)
    return o, lse, split, again, fused


@pytest.mark.parametrize("b,n,sq,sk,lens,with_dlse", [
    (1, 2, 300, 200, None, False),
    (1, 2, 257, 403, None, True),
    (2, 3, 130, 520, (520, 0), True),
    (3, 2, 1000, 512, (512, 77, 0), False),
    (3, 2, 1000, 512, (512, 77, 0), True),
    (1, 2, 103, 403, None, True),
    (1, 2, 403, 103, None, False),
    (1, 2, 1000, 1000, None, True),
    (1, 1, 98304, 403, None, False),
    (1, 1, 98305, 403, None, True),
])
def test_split_bwd_matches_plain_and_fused(cuda, b, n, sq, sk, lens, with_dlse):
    from dualforce_tpu_torch.ops.flash_attention import flash_attention_bwd_plain

    q, k, v, do, dlse, tl = _bwd_inputs(cuda, b, n, sq, sk, lens, 5)
    dlse = dlse if with_dlse else None
    o, lse, split, again, fused = _split_and_fused(q, k, v, do, dlse, tl)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), tl, dlse)
    for name, x, w in zip(("dq", "dk", "dv"), split, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape
        assert _rel(x, w) <= 2e-2, name
    for x, y in zip(split, again):
        assert torch.equal(x, y)                       # deterministic
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2], fused[2])
    assert _rel(split[0], fused[0].float()) <= 2e-2
    if lens is not None:
        dq, dk, dv = split
        for i, length in enumerate(lens):
            if length == 0:
                assert torch.count_nonzero(dq[i]) == 0
            assert torch.count_nonzero(dk[i, length:]) == 0
            assert torch.count_nonzero(dv[i, length:]) == 0


def test_bwd_reads_strided_views(cuda):
    """q, k, v as views into one packed [B, S, 3, N, D] tensor and dO as a
    heads-major view: the tensor maps read them through their strides, in
    both backwards."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(cuda).manual_seed(8)
    qkv = torch.randn(2, 333, 3, 2, 128, generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 2, 333, 128, generator=g, device=cuda,
                     dtype=torch.bfloat16).transpose(1, 2)
    assert not (q.is_contiguous() or do.is_contiguous())
    o, lse = fa.flash_attention_with_lse(q, k, v)
    want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                        do.float())
    for route in (fa.flash_attention_bwd_fused, fa.flash_attention_bwd_split):
        got = route(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel(x, w) <= 2e-2, (route.__name__, name)


@pytest.mark.parametrize("sq,with_dlse", [(403, False), (1000, True), (98305, True)])
def test_preprocess_matches_delta(cuda, sq, with_dlse):
    """The preprocess kernel's delta within 1e-5 relative L2 of `_delta`
    (fp32 sums in another order), its lse * log2(e) within fp32 rounding of
    the LSE's, and the rows padded to 128 holding delta 0 and lse +inf."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    q, k, v, do, dlse, _ = _bwd_inputs(cuda, 2, 2, sq, 200, None, 9)
    dlse = dlse if with_dlse else None
    o, lse = fa.flash_attention_with_lse(q, k, v)
    before = fa.flash_bwd_preprocess.launches
    delta, lse2 = fa.flash_bwd_preprocess(o, do, lse, dlse)
    torch.cuda.synchronize()
    assert fa.flash_bwd_preprocess.launches == before + 1
    pad = -(-sq // 128) * 128
    assert delta.shape == lse2.shape == (2, 2, pad)
    assert _rel(delta[..., :sq], fa._delta(o, do, dlse)) <= 1e-5
    assert torch.allclose(lse2[..., :sq], lse * fa.LOG2E, rtol=1e-6, atol=0)
    assert torch.all(delta[..., sq:] == 0) and torch.all(torch.isposinf(lse2[..., sq:]))


@pytest.mark.parametrize("sq,route", [(98304, "fused"), (98305, "split")])
def test_bwd_routes_at_the_boundary(cuda, sq, route):
    """Sq 98,304 is the last length whose dq scratch fits the JAX package's
    48 MiB cap: the fused kernel; one row more takes the split kernels."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    q, k, v, do, _, _ = _bwd_inputs(cuda, 1, 1, sq, 512, None, 6)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    before = (fa.flash_attention_bwd.launches, fa.flash_attention_bwd.split_launches)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    launched = (fa.flash_attention_bwd.launches - before[0],
                fa.flash_attention_bwd.split_launches - before[1])
    assert launched == ((1, 0) if route == "fused" else (0, 1))


@pytest.mark.parametrize("sq,sk", [(450_000, 512), (403, 450_000)], ids=["long_q", "long_k"])
def test_kernels_past_2_31_elements(cuda, sq, sk):
    """One tensor of more than 2^31 elements (40 heads, 450,000 rows): the
    forward with its LSE, the fused and the split backward, each held on two
    heads against its plain version, so that an offset formed in 32 bits
    shows."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    n = 40
    q, k, v, do, dlse, _ = _bwd_inputs(cuda, 1, n, sq, sk, None, 7)
    assert max(x.numel() for x in (q, k)) > 2**31
    o, lse = fa.flash_attention_with_lse(q, k, v)
    heads = [0, n - 1]
    sub = [x[:, :, heads].float() for x in (q, k, v, do)]
    want_o, want_lse = fa.flash_attention_plain(*sub[:3], return_lse=True)
    assert _rel(o[:, :, heads], want_o) <= 1e-2
    assert float((lse[:, heads] - want_lse).abs().max()) <= 1e-3
    del want_o, want_lse
    want = fa.flash_attention_bwd_plain(*sub[:3], o[:, :, heads].float(), lse[:, heads],
                                        sub[3], None, dlse[:, heads])
    for route in (fa.flash_attention_bwd_fused, fa.flash_attention_bwd_split):
        got = route(q, k, v, o, lse, do, None, dlse)
        torch.cuda.synchronize()
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel(x[:, :, heads], w) <= 2e-2, (route.__name__, name)
        del got
