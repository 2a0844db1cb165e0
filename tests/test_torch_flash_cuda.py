"""The CUDA flash-attention kernel against its plain version, on the card.

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
