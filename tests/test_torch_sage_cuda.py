"""The CUDA cap mode of the flash forward, the int8-QK sage kernel and its
quantization prologue against their plain versions, and the int8 product of
`nn.Int8Linear`, on the card.

Skips where there is no CUDA device. It imports no JAX, so on a machine with
the card it runs without the repository's JAX test configuration:
`python -m pytest --noconftest tests/test_torch_sage_cuda.py`.
Tolerances: bf16 output against the fp32 plain version on the same inputs
(for sage, the same int8 quantization), relative L2 error <= 1e-2; the cap
mode's LSE within 1e-3 absolute; rows with no valid key exactly 0. The
prologue's Q codes and scales equal `sage_quantize_plain`'s bit for bit (no
sum enters them); its K codes lie at most 1 apart, in at most 1e-4 of the
elements, and its K scales within 1e-6 relative: the kernel sums K over the
keys in another order than the plain version, which moves a centred value
that sits within an ulp of a .5 rounding boundary to the other side.
"""

import pytest
import torch

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.ops import sage_attention as tsa
from dualforce_tpu_torch.ops.flash_attention import (FAST_SOFTMAX_CAP, flash_attention,
                                                     flash_attention_plain,
                                                     flash_attention_with_lse)

SHAPES = [
    (1, 2, 300, 200, None),
    (2, 3, 130, 520, (520, 0)),
    (3, 4, 1000, 512, (512, 77, 0)),
    (1, 12, 403, 4031, None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def _inputs(cuda, b, n, sq, sk, lens, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, 128, generator=g, device=cuda, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, v, tl


def _zero_rows(out, lens):
    if lens is not None:
        for i, length in enumerate(lens):
            if length == 0:
                assert torch.count_nonzero(out[i]) == 0


@pytest.mark.parametrize("b,n,sq,sk,lens", SHAPES)
def test_cap_kernel_matches_plain(cuda, b, n, sq, sk, lens):
    q, k, v, tl = _inputs(cuda, b, n, sq, sk, lens, 0)
    before = (flash_attention.launches, flash_attention.cap_launches)
    out, lse = flash_attention_with_lse(q, k, v, tl, softmax_cap=FAST_SOFTMAX_CAP)
    plain = flash_attention(q, k, v, tl, softmax_cap=FAST_SOFTMAX_CAP)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.cap_launches) == \
        (before[0], before[1] + 2)
    want, want_lse = flash_attention_plain(q.float(), k.float(), v.float(), tl,
                                           return_lse=True, softmax_cap=FAST_SOFTMAX_CAP)
    assert _rel(out, want) <= 1e-2 and torch.equal(out, plain)
    assert float((lse - want_lse).abs().max()) <= 1e-3
    _zero_rows(out, lens)


def _check_cap(q, k, v, tl):
    before = (flash_attention.launches, flash_attention.cap_launches)
    out, lse = flash_attention_with_lse(q, k, v, tl, softmax_cap=FAST_SOFTMAX_CAP)
    plain = flash_attention(q, k, v, tl, softmax_cap=FAST_SOFTMAX_CAP)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.cap_launches) == \
        (before[0], before[1] + 2)
    want, want_lse = flash_attention_plain(q.float(), k.float(), v.float(), tl,
                                           return_lse=True, softmax_cap=FAST_SOFTMAX_CAP)
    assert _rel(out, want) <= 1e-2 and torch.equal(out, plain)
    assert float((lse - want_lse).abs().max()) <= 1e-3
    return out, lse


@pytest.mark.parametrize("sk", [1, 127, 128, 129, 257, 512])
@pytest.mark.parametrize("sq", [1, 63, 127, 128, 129, 403])
def test_cap_kernel_at_tile_edges(cuda, sq, sk):
    """The cap mode on both sides of the kernel's 128-row and 128-key tiles."""
    _check_cap(*_inputs(cuda, 1, 2, sq, sk, None, 3))


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (3, 2, 300, 700, (700, 200, 0)),      # kv_len ends inside a key tile; a keyless batch
    (3, 2, 403, 4031, (4031, 1000, 0)),   # a split call whose later ranges hold no key
])
def test_cap_kernel_keyless_rows(cuda, b, n, sq, sk, lens):
    """A keyless batch gets exact zeros and the LSE cap * ln 2."""
    from dualforce_tpu_torch.ops.flash_attention import LN2

    out, lse = _check_cap(*_inputs(cuda, b, n, sq, sk, lens, 4))
    _zero_rows(out, lens)
    for i, length in enumerate(lens):
        if length == 0:
            assert float((lse[i] - FAST_SOFTMAX_CAP * LN2).abs().max()) <= 1e-3


@pytest.mark.parametrize("b,n,sq,sk,lens", SHAPES)
def test_sage_kernel_matches_plain(cuda, b, n, sq, sk, lens):
    q, k, v, tl = _inputs(cuda, b, n, sq, sk, lens, 1)
    qi, ki, qs, ks = tsa.sage_quantize(q, k, tl)
    before = tsa.sage_attention.launches
    out = tsa.sage_fwd(qi, ki, v, qs, ks, tl)
    torch.cuda.synchronize()
    assert tsa.sage_attention.launches == before + 1
    want = tsa.sage_fwd_plain(qi, ki, v.float(), qs, ks, tl)
    assert out.dtype == torch.bfloat16 and _rel(out, want) <= 1e-2
    _zero_rows(out, lens)
    exact = flash_attention_plain(q.float(), k.float(), v.float(), tl)
    assert _rel(out, exact) <= 2.5e-2          # the int8 floor, JAX's own bound


def test_sage_attention_reads_strided_v(cuda):
    """v as a view into a packed [B, S, 3, N, D] tensor, through `sage_attention`."""
    g = torch.Generator(cuda).manual_seed(2)
    qkv = torch.randn(1, 257, 3, 2, 128, generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    with torch.no_grad():
        out = tsa.sage_attention(q, k, v)
    want = tsa.sage_attention_plain(q, k, v.float())
    assert _rel(out, want) <= 1e-2


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 300, 1, 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(x, x, x, softmax_cap=FAST_SOFTMAX_CAP)     # fp32
    qi = torch.zeros(1, 300, 1, 128, device=cuda, dtype=torch.int8)
    s = torch.ones(1, 1, 300, device=cuda)
    with pytest.raises(TypeError):
        tsa.sage_fwd(qi, qi, x, s, s)                                # fp32 v
    with pytest.raises(TypeError):
        tsa.sage_fwd(qi.float(), qi, x.bfloat16(), s, s)             # fp32 q
    y = torch.zeros(1, 300, 1, 64, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):
        tsa.sage_fwd(y, y, y.bfloat16(), s, s)                       # D = 64
    with pytest.raises(ValueError):
        tsa.sage_fwd(qi, qi, x.bfloat16(), s[:, :, :10], s)          # short scales
    with pytest.raises(RuntimeError):
        tsa.sage_attention(x.bfloat16().requires_grad_(), x.bfloat16(), x.bfloat16())


@pytest.mark.parametrize("rows", [5, 300])
def test_int8_linear_on_the_card(cuda, rows):
    """`torch._int_mm` (few rows padded) against the same w8a8 arithmetic on
    the CPU: the int32 products are exact, so the outputs agree to fp32
    round-off."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(512, 256).requires_grad_(False)
    q = tnn.Int8Linear.from_linear(lin)
    x = torch.randn(1, rows, 512)
    want = q(x)
    got = q.to(cuda)(x.to(cuda))
    assert _rel(got.cpu(), want) <= 1e-6


# --- the sage kernel's edges and the prologue -------------------------------

def _check_sage(q, k, v, tl):
    """The prologue and the kernel (one launch each) against the plain
    kernel on the same quantization; returns the output."""
    before = (tsa.sage_quantize.launches, tsa.sage_attention.launches)
    qi, ki, qs, ks = tsa.sage_quantize(q, k, tl)
    out = tsa._launch_sage(qi, ki, v, qs, ks, tl)
    torch.cuda.synchronize()
    assert (tsa.sage_quantize.launches, tsa.sage_attention.launches) == \
        (before[0] + 1, before[1] + 1)
    want = tsa.sage_fwd_plain(qi, ki, v.float(), qs, ks, tl)
    assert out.dtype == torch.bfloat16 and _rel(out, want) <= 1e-2
    return out


@pytest.mark.parametrize("sk", [1, 63, 127, 128, 129, 403])
@pytest.mark.parametrize("sq", [1, 63, 127, 128, 129, 403])
def test_sage_kernel_at_tile_edges(cuda, sq, sk):
    """Both sides of the kernel's 128-row and 128-key tiles."""
    _check_sage(*_inputs(cuda, 1, 2, sq, sk, None, 5))


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (3, 2, 300, 700, (700, 200, 0)),      # kv_len ends inside a key tile; a keyless batch
    (3, 2, 403, 4031, (4031, 1000, 0)),   # a split call whose later ranges hold no key
])
def test_sage_kernel_keyless_rows(cuda, b, n, sq, sk, lens):
    out = _check_sage(*_inputs(cuda, b, n, sq, sk, lens, 6))
    _zero_rows(out, lens)


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (1, 2, 403, 4031, None),
    (3, 2, 403, 4031, (4031, 1000, 0)),
    (1, 12, 403, 43120, None),            # the v2a call at 360p
])
def test_sage_split_matches_whole(cuda, b, n, sq, sk, lens, monkeypatch):
    """A call split over keys against the same call left whole; one launch
    each."""
    from dualforce_tpu_torch.ops import flash_attention as fa

    q, k, v, tl = _inputs(cuda, b, n, sq, sk, lens, 7)
    assert tsa.fwd_splits(b * n * -(-sq // fa.FWD_BLOCK_M), sk, fa._sm_count(q.device)) > 1
    split = _check_sage(q, k, v, tl)
    monkeypatch.setattr(tsa, "fwd_splits", lambda ctas, sk, sms: 1)
    whole = _check_sage(q, k, v, tl)
    assert _rel(split, whole.float()) <= 1e-2
    _zero_rows(split, lens)


def test_sage_kernel_repeats_itself(cuda):
    """Two calls on the same inputs are bit-equal: each row's sum is taken
    in one fixed order, with no atomics."""
    q, k, v, tl = _inputs(cuda, 2, 3, 700, 1100, (1100, 390), 8)
    assert torch.equal(_check_sage(q, k, v, tl), _check_sage(q, k, v, tl))


def test_sage_kernel_reads_heads_major_v(cuda):
    """v as a [B, N, S, D] tensor seen as [B, S, N, D]."""
    g = torch.Generator(cuda).manual_seed(9)
    q, k = (torch.randn(2, 517, 3, 128, generator=g, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    v = torch.randn(2, 3, 517, 128, generator=g, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)
    assert not v.is_contiguous()
    _check_sage(q, k, v, None)


def _check_prologue(q, k, tl):
    """The prologue against `sage_quantize_plain` with the tolerances of the
    module docstring; two calls bit-equal."""
    got = tsa.sage_quantize(q, k, tl)
    again = tsa.sage_quantize(q, k, tl)
    torch.cuda.synchronize()
    want = tsa.sage_quantize_plain(q, k, tl)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for x, w in zip(got, want):
        assert x.shape == w.shape and x.dtype == w.dtype and x.is_contiguous()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    diff = (got[1].int() - want[1].int()).abs()
    assert int(diff.max()) <= 1 and int(torch.count_nonzero(diff)) <= 1e-4 * diff.numel()
    assert float(((got[3] - want[3]).abs() / want[3]).max()) <= 1e-6
    return got


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (1, 2, 300, 200, None),               # one block each, padded
    (2, 3, 130, 520, (520, 0)),           # a kv mask: blocks capped at Sk rounded to 128
    (1, 1, 1, 403, None),                 # one row
    (1, 2, 4000, 5000, None),             # several blocks, Sk not a multiple of the block
    (1, 1, 43120, 43120, None),           # video self-attention's blocks, 1232 and 1960
])
def test_prologue_matches_plain(cuda, b, n, sq, sk, lens):
    q, k, _, tl = _inputs(cuda, b, n, sq, sk, lens, 10)
    _check_prologue(q, k, tl)


def test_prologue_reads_strided_views(cuda):
    """q and k as views into a packed [B, S, 3, N, D] tensor."""
    g = torch.Generator(cuda).manual_seed(11)
    qkv = torch.randn(2, 1000, 3, 4, 128, generator=g, device=cuda, dtype=torch.bfloat16)
    q, k, _ = qkv.unbind(2)
    _check_prologue(q, k, None)


def test_sage_launch_counts(cuda):
    """`sage_attention` on the card runs the prologue and the kernel once
    each; `sage_attention_plain` launches nothing."""
    q, k, v, _ = _inputs(cuda, 1, 2, 300, 300, None, 12)
    before = (tsa.sage_quantize.launches, tsa.sage_attention.launches)
    with torch.no_grad():
        out = tsa.sage_attention(q, k, v)
        plain = tsa.sage_attention_plain(q, k, v.float())
    torch.cuda.synchronize()
    assert (tsa.sage_quantize.launches, tsa.sage_attention.launches) == \
        (before[0] + 1, before[1] + 1)
    assert _rel(out, plain) <= 1e-2


def test_prologue_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 300, 1, 128, device=cuda)
    with pytest.raises(TypeError):
        tsa.sage_quantize(x, x)                                      # fp32
    y = torch.zeros(1, 300, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tsa.sage_quantize(y, y)                                      # D = 64


@pytest.mark.parametrize("sq,sk", [(450_000, 512), (403, 450_000)], ids=["long_q", "long_k"])
def test_sage_past_2_31_elements(cuda, sq, sk):
    """One int8 tensor of more than 2^31 elements (40 heads, 450,000 rows):
    the prologue and the kernel, held on two heads against their plain
    versions, so that an offset formed in 32 bits shows."""
    n = 40
    q, k, v, _ = _inputs(cuda, 1, n, sq, sk, None, 13)
    qi, ki, qs, ks = tsa.sage_quantize(q, k)
    assert max(x.numel() for x in (qi, ki)) > 2**31
    out = tsa.sage_fwd(qi, ki, v, qs, ks)
    torch.cuda.synchronize()
    heads = [0, n - 1]
    sub = [x[:, :, heads].contiguous() for x in (q, k)]
    pqi, pki, pqs, pks = tsa.sage_quantize_plain(*sub)
    assert torch.equal(qi[:, :, heads], pqi) and torch.equal(qs[:, heads], pqs)
    diff = (ki[:, :, heads].int() - pki.int()).abs()
    assert int(diff.max()) <= 1 and int(torch.count_nonzero(diff)) <= 1e-4 * diff.numel()
    assert float(((ks[:, heads] - pks).abs() / pks).max()) <= 1e-6
    del pqi, pki, pqs, pks, diff
    want = tsa.sage_fwd_plain(qi[:, :, heads], ki[:, :, heads], v[:, :, heads].float(),
                              qs[:, heads].contiguous(), ks[:, heads].contiguous())
    assert _rel(out[:, :, heads], want) <= 1e-2
