"""The forward kernel's host-side choices, on the CPU: how a call's key range
is split across CTAs (`fwd_splits`) and the tensor-map arguments the wrapper
passes for q, k and v.

The forward kernel gives each CTA 128 query rows of one (batch, head). Where
B * N * ceil(Sq / 128) CTAs would leave SMs of the card idle (the 403-query
audio-side calls), the key tiles are cut into ranges that run as CTAs of
their own, each range at least FWD_MIN_SPLIT_TILES tiles of 128 keys.
"""

import math

import pytest
import torch

from dualforce_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H100_SMS = 132


def _ctas(b, n, sq):
    return b * n * -(-sq // fa.FWD_BLOCK_M)


@pytest.mark.parametrize("n,sq,sk", [
    (40, 43120, 43120), (40, 43120, 512), (40, 43120, 403),       # 360p video side
    (40, 176400, 176400), (40, 176400, 512), (40, 176400, 403),   # 720p video side
    (40, 11440, 11440), (40, 11440, 103),                         # 360p training
])
def test_full_grids_stay_whole(n, sq, sk):
    assert _ctas(1, n, sq) >= H100_SMS
    assert fa.fwd_splits(_ctas(1, n, sq), sk, H100_SMS) == 1


@pytest.mark.parametrize("n,sq,sk,want", [
    (12, 403, 43120, 11),     # v2a at 360p: 48 CTAs, 337 key tiles -> 528 CTAs, 4 whole waves
    (12, 403, 176400, 11),    # v2a at 720p
    (12, 403, 403, 1),        # audio self: 4 key tiles, too few to split
    (12, 403, 512, 1),        # audio text cross
    (2, 403, 4031, 4),        # 8 CTAs, 32 tiles: at most 4 ranges of 8
    (1, 1, 1023, 1),          # 7 tiles: below one range's minimum twice over
])
def test_splits_at_the_path_shapes(n, sq, sk, want):
    assert fa.fwd_splits(_ctas(1, n, sq), sk, H100_SMS) == want


@pytest.mark.parametrize("ctas", [1, 7, 48, 100, 131])
@pytest.mark.parametrize("sk", [1, 1024, 2047, 5000, 43120])
def test_every_range_keeps_its_minimum(ctas, sk):
    splits = fa.fwd_splits(ctas, sk, H100_SMS)
    tiles = -(-sk // fa.FWD_BLOCK_N)
    assert 1 <= splits <= max(1, tiles // fa.FWD_MIN_SPLIT_TILES)
    if splits > 1:
        per_split = -(-tiles // splits)         # the C launcher's cut
        assert per_split >= fa.FWD_MIN_SPLIT_TILES
        assert -(-tiles // per_split) <= splits  # no range past the grid
        # no count with fewer ranges fills the waves as well
        fill = lambda s: (ctas * s / H100_SMS) / math.ceil(ctas * s / H100_SMS)
        assert all(fill(s) < fill(splits) for s in range(1, splits))


def test_forward_tensor_maps_follow_packed_views():
    """The forward reads q, k and v of a packed [B, S, 3, N, D] tensor through
    their strides: the geometry the C launcher encodes its maps from."""
    qkv = torch.zeros(2, 333, 3, 4, 128, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    geom = list(fa._geometry((q.shape, k.shape, v.shape), (q.stride(), k.stride(), v.stride())))
    row = 3 * 4 * 128 * 2
    assert geom == [128, 4, 333, 2, 256, row, 333 * row] * 3
