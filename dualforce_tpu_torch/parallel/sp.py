"""Sequence- and weight-parallel block stack (counterpart of `dualforce_tpu/parallel/sp.py`).

`sp_forward_blocks` runs `forward_dual_tower` in every rank of a
(data, fsdp, cp) mesh, each on its part of the work:

  - the token sequences are zero-padded to cp multiples and each rank keeps
    its contiguous chunk, with its slice of the RoPE tables (the cross
    RoPE's video tables sliced, its audio tables whole);
  - video self-attention is a ring, audio self-attention gathers its K/V,
    text cross-attention is local, the bridge LSE-combines v2a
    (`models/dual_tower.py`, `models/bridge.py`); every pad tail is masked
    out of every softmax, so cp > 1 equals cp = 1;
  - where the data axis divides the batch (and no per-item context lengths
    are given), each data rank takes its slice of the batch;
  - with fsdp > 1 each layer's weights are gathered from their shards just
    before the layer runs (`sharding.GatheredWeights`);
  - the outputs are gathered back whole on every rank and unpadded.

The JAX package's `shard_map` is one program over all devices; here every
rank runs this function and they meet in the collectives, so each rank
must make the same calls in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dualforce_tpu_torch.models.dual_tower import forward_dual_tower
from dualforce_tpu_torch.parallel import mesh as pm
from dualforce_tpu_torch.parallel.sharding import GatheredWeights, shard_batch


def _pad_chunk(x: torch.Tensor, dim: int, cp: int, idx: int):
    """x zero-padded along `dim` to a multiple of cp, and rank idx's chunk."""
    pad = -x.shape[dim] % cp
    if pad:
        widths = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, pad]
        x = F.pad(x, widths)
    n = x.shape[dim] // cp
    return x.narrow(dim, idx * n, n), pad


def sp_forward_blocks(mesh, video_blocks, audio_blocks, bridge,
                      visual_x: torch.Tensor, audio_x: torch.Tensor,
                      visual_ctx: torch.Tensor, audio_ctx: torch.Tensor,
                      visual_t_mod: torch.Tensor, audio_t_mod: torch.Tensor,
                      visual_rope, audio_rope, cross_rope=None,
                      condition_scale: Optional[float] = None,
                      a2v_condition_scale: Optional[float] = None,
                      v2a_condition_scale: Optional[float] = None,
                      attn_impl="auto", ctx_valid_len: Optional[torch.Tensor] = None,
                      video_grid=None):
    """The interleaved block stack over `mesh` (arguments as
    `forward_dual_tower`'s, whole on every rank: visual_x [B, Lv, V],
    audio_x [B, La, A], RoPE tables [L, d/2], cross RoPE [1, L, head_dim]).
    The sequence goes over "cp"; the batch is split over "data" where that
    axis divides it and no `ctx_valid_len` is given (`sharding.shard_batch`;
    JAX's per-item lengths stay replicated, so the batch does too). Returns
    the whole, unpadded (visual_x, audio_x) on every rank."""
    shape = pm.mesh_shape(mesh)
    cp = shape["cp"]
    idx = mesh.get_local_rank("cp")
    lv, la = visual_x.shape[1], audio_x.shape[1]
    b = visual_x.shape[0]
    dax = None
    if ctx_valid_len is None and shape["data"] > 1 and b % shape["data"] == 0:
        dax = pm.MeshAxis(mesh, "data")
        visual_x, audio_x, visual_ctx, audio_ctx, visual_t_mod, audio_t_mod = shard_batch(
            (visual_x, audio_x, visual_ctx, audio_ctx, visual_t_mod, audio_t_mod), mesh)
    visual_x, vpad = _pad_chunk(visual_x, 1, cp, idx)
    audio_x, apad = _pad_chunk(audio_x, 1, cp, idx)
    visual_rope = tuple(_pad_chunk(r, 0, cp, idx)[0] for r in visual_rope)
    audio_rope = tuple(_pad_chunk(r, 0, cp, idx)[0] for r in audio_rope)
    if cross_rope is not None:
        cross_rope = (tuple(_pad_chunk(r, 1, cp, idx)[0] for r in cross_rope[0]),
                      tuple(F.pad(r, (0, 0, 0, apad)) for r in cross_rope[1]))
    params = None
    if shape["fsdp"] > 1:
        fsdp = pm.MeshAxis(mesh, "fsdp")
        params = {"video": GatheredWeights(video_blocks, "blocks.", fsdp),
                  "audio": GatheredWeights(audio_blocks, "blocks.", fsdp),
                  "bridge": GatheredWeights(bridge, "", fsdp)}
    sp_axis = pm.MeshAxis(mesh, "cp") if cp > 1 else None
    vx, ax = forward_dual_tower(
        video_blocks, audio_blocks, bridge, visual_x, audio_x, visual_ctx, audio_ctx,
        visual_t_mod, audio_t_mod, visual_rope, audio_rope, cross_rope=cross_rope,
        condition_scale=condition_scale, a2v_condition_scale=a2v_condition_scale,
        v2a_condition_scale=v2a_condition_scale, attn_impl=attn_impl,
        ctx_valid_len=ctx_valid_len, params=params, video_grid=video_grid,
        sp_axis=sp_axis, sp_video_valid=lv if vpad else None,
        sp_audio_valid=la if apad else None)
    if sp_axis is not None:
        vx, ax = (pm.all_gather(t, sp_axis, dim=1) for t in (vx, ax))
    if dax is not None:
        vx, ax = (pm.all_gather(t, dax, dim=0) for t in (vx, ax))
    return vx[:, :lv], ax[:, :la]
