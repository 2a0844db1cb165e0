"""The sage prologue's plain version against the JAX package's, its CPU
route, and the tensor-map geometry of the sage kernel's int8 operands, on the
CPU.

The prologue (K mean-centred over all Sk keys, per-block absmax int8 of Q and
K, the softmax scale and log2(e) folded into the q scales) is jnp code in
`_sage_fwd`; the port's `sage_quantize_plain` is held against it at edge
shapes, with the quantization blocks `sage_blocks` picks by default, under
jit, as `_sage_fwd` runs: there XLA turns the divisions by Sk and by 127
into products with their fp32 reciprocals and folds 1/127 and the q scales'
factor into one constant. Tolerances: Q's int8 codes and scales
equal JAX's (no sum enters them); K's codes lie at most 1 apart, in at most
1e-4 of the elements (the sum over the keys is taken in another order), and
K's scales within 1e-6 relative. The CUDA prologue is held to
`sage_quantize_plain` by the card tests (`tests/test_torch_sage_cuda.py`).
"""

import numpy as np
import pytest
import torch
from test_torch_sage_attention import _jax_quantized

from dualforce_tpu_torch.ops import flash_attention as tfa
from dualforce_tpu_torch.ops import sage_attention as tsa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _qk(seed, b, sq, sk, n, d=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, n, d)).astype(np.float32),
            rng.standard_normal((b, sk, n, d)).astype(np.float32))


def _close_codes(port_i8, jax_i8, what) -> None:
    diff = np.abs(port_i8.astype(np.int32) - jax_i8.astype(np.int32))
    assert diff.max(initial=0) <= 1, what
    assert np.count_nonzero(diff) <= 1e-4 * diff.size, what


@pytest.mark.parametrize("b,n,sq,sk,lens", [
    (1, 2, 200, 300, None),               # Sk not a multiple of its block (384)
    (2, 2, 256, 300, (300, 100)),         # a kv mask: blocks capped at Sk rounded to 128
    (1, 2, 1, 403, None),                 # one query row
    (1, 1, 1300, 1030, None),             # several Q blocks, the last one partial
])
def test_plain_prologue_matches_jax(b, n, sq, sk, lens):
    q, k = _qk(21, b, sq, sk, n)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    bq, bk = tsa.sage_blocks(sq, sk, lens is not None)
    jqi, jqs, jki, jks = _jax_quantized(q, k, bq, bk)
    qi, ki, qs, ks = tsa.sage_quantize_plain(torch.from_numpy(q), torch.from_numpy(k), tl)
    assert qi.dtype == ki.dtype == torch.int8 and qs.dtype == ks.dtype == torch.float32
    assert qi.shape == (b, sq, n, 128) and ki.shape == (b, sk, n, 128)
    assert qs.shape == (b, n, sq) and ks.shape == (b, n, sk)
    np.testing.assert_array_equal(qi.permute(0, 2, 1, 3).numpy(), jqi)
    _close_codes(ki.permute(0, 2, 1, 3).numpy(), jki, "k")
    np.testing.assert_array_equal(qs.numpy(), np.repeat(jqs, bq, axis=2)[:, :, :sq])
    np.testing.assert_allclose(ks.numpy(), np.repeat(jks, bk, axis=2)[:, :, :sk], rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [None, (300, 0)], ids=["whole", "mask"])
def test_cpu_prologue_is_the_plain_one(dtype, lens):
    """`sage_quantize` on CPU tensors is `sage_quantize_plain`, and counts no
    launch; so is the prologue inside `sage_attention_plain`."""
    q, k = (torch.from_numpy(x).to(dtype) for x in _qk(22, 2, 260, 300, 3))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    before = tsa.sage_quantize.launches
    got = tsa.sage_quantize(q, k, tl)
    want = tsa.sage_quantize_plain(q, k, tl)
    assert tsa.sage_quantize.launches == before
    assert all(torch.equal(x, w) and x.is_contiguous() for x, w in zip(got, want))
    v = torch.randn(2, 300, 3, 128).to(dtype)
    assert torch.equal(tsa.sage_attention(q, k, v, tl), tsa.sage_attention_plain(q, k, v, tl))
    assert tsa.sage_quantize.launches == before


def test_tma_geometry_of_int8_views():
    """1-byte elements: the byte strides of a contiguous int8 [B, S, N, 128]
    view are its element strides; bf16 (the default) doubles them."""
    x = torch.zeros(2, 333, 4, 128, dtype=torch.int8)
    assert tfa.tma_geometry(x.shape, x.stride(), 1) == (128, 4, 333, 2, 128, 512, 333 * 512)
    assert tfa.tma_geometry(x.shape, x.stride()) == (128, 4, 333, 2, 256, 1024, 333 * 1024)


def test_tma_geometry_size_one_dims():
    """A dim of size 1 is never stepped: its stride is one 128-element row of
    the element size, whatever the view says."""
    odd = torch.zeros(1, 5, 1, 128, dtype=torch.int8).as_strided((1, 5, 1, 128), (7, 128, 3, 1))
    assert tfa.tma_geometry(odd.shape, odd.stride(), 1) == (128, 1, 5, 1, 128, 128, 128)
    assert tfa.tma_geometry(odd.shape, odd.stride(), 2) == (128, 1, 5, 1, 256, 256, 256)


@pytest.mark.parametrize("stride", [(80 * 128, 200, 128, 1), (80 * 128, 128, 8, 1)],
                         ids=["rows", "heads"])
def test_tma_geometry_refuses_int8_strides(stride):
    """Element strides that are multiples of 8 but not of 16: refused for
    int8, taken for bf16 (16-byte multiples there)."""
    shape = (2, 40, 2, 128)
    with pytest.raises(ValueError):
        tfa.tma_geometry(shape, stride, 1)
    assert tfa.tma_geometry(shape, stride)[4:6] == (2 * stride[2], 2 * stride[1])
