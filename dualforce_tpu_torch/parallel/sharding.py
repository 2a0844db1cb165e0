"""Weight sharding over the `fsdp` axis (counterpart of `dualforce_tpu/parallel/sharding.py`).

JAX's rule (`_leaf_spec`): a leaf of rank >= 2 shards the larger of its
last two dims over `fsdp` where the axis size divides it (else the other,
if it divides); smaller leaves and undivided dims stay whole. The JAX
package stacks each tower's blocks and each bridge direction's conditioners
into [L, ...] leaves, so the rule sees the layer dim as the second-to-last
dim of a stacked 1-D leaf, and a spec on the layer dim replicates the leaf
(`sp.py`'s `_no_layer_shard`). The port keeps its blocks as modules, so
`leaf_dim` applies the rule to each parameter's stacked shape in the JAX
layout ([L] + the JAX leaf's shape: a linear's weight is [in, out] there,
[out, in] here) and maps the chosen dim back to the port's tensor, so that
each rank holds exactly the slice JAX's `param_pspecs` gives it.

Only the blocks and the conditioners are sharded; UMT5, the VAEs and the
towers' embeddings and heads stay whole on every rank (JAX's GSPMD shards
them too: a difference in memory only). `GatheredWeights` gathers one
layer's shards as the layer reads them (through `nn.call`) and lets them go
after: the counterpart of JAX's `layer_param_map` hook.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.parallel import mesh as pm

TOWERS = ("video_dit", "video_dit_2", "audio_dit")
BRIDGE_STACKS = ("audio_to_video_conditioners", "video_to_audio_conditioners")


def leaf_spec(shape: Sequence[int], fsdp_size: int) -> Optional[int]:
    """The dim (negative index) `_leaf_spec` shards over `fsdp`, or None."""
    if len(shape) < 2 or fsdp_size <= 1:
        return None
    d_last, d_prev = shape[-1], shape[-2]
    if d_last >= d_prev and d_last % fsdp_size == 0:
        return -1
    if d_prev % fsdp_size == 0:
        return -2
    if d_last % fsdp_size == 0:
        return -1
    return None


def _jax_order(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """The port's dims in the JAX leaf's order: a linear's weight (and the
    packed `in_proj_weight`) is transposed there."""
    owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
    leaf = name.rpartition(".")[2]
    if p.ndim == 2 and ((leaf == "weight" and isinstance(owner, nn.Linear))
                        or leaf == "in_proj_weight"):
        return (1, 0)
    return tuple(range(p.ndim))


def leaf_dim(module: nn.Module, name: str, p: torch.Tensor, layers: int,
             fsdp_size: int) -> Optional[int]:
    """The dim of the port's parameter `name` (a block's, stacked `layers`
    deep in the JAX tree) that `fsdp` shards, or None (whole)."""
    order = _jax_order(module, name, p)
    stacked = [layers] + [p.shape[i] for i in order]
    spec = leaf_spec(stacked, fsdp_size)
    if spec is None or spec + len(stacked) == 0:     # the layer dim: replicated
        return None
    return order[spec + len(stacked) - 1]


def _block_sets(name: str, module: nn.Module):
    """(module holding the sharded parameters, {its parameter name: stack depth})."""
    if name in TOWERS:
        blocks = module.blocks
        return blocks, {n: len(blocks) for n, _ in blocks.named_parameters()}
    stacks = {s: len(getattr(module, s)) for s in BRIDGE_STACKS}
    return module, {n: stacks[n.partition(".")[0]] for n, _ in module.named_parameters()
                    if n.partition(".")[0] in stacks}


def shard_params(modules: Dict[str, nn.Module], mesh) -> Dict[str, nn.Module]:
    """Keep this rank's `fsdp` slice of every tower block and bridge
    conditioner parameter (in place; the whole tensors are freed). The
    holder of the blocks (a tower's `blocks`, the bridge) records
    {parameter name: sharded dim} as `fsdp_dims`, which `GatheredWeights`
    reads. Quantized towers are not sharded (ROADMAP A7b). Returns
    `modules`."""
    fsdp = pm.mesh_shape(mesh).get("fsdp", 1)
    if fsdp <= 1:
        return modules
    idx = mesh.get_local_rank("fsdp")
    for name, module in modules.items():
        if name not in TOWERS and name != "bridge":
            continue
        holder, depth = _block_sets(name, module)
        if any(isinstance(m, (dnn.Int8Linear, dnn.Int4Linear)) for m in holder.modules()):
            raise ValueError("fsdp sharding of quantized towers is not ported (ROADMAP A7b)")
        dims = {}
        for pname, p in holder.named_parameters():
            if pname not in depth:
                continue
            d = leaf_dim(holder, pname, p, depth[pname], fsdp)
            if d is None:
                continue
            size = p.shape[d] // fsdp
            p.data = p.data.narrow(d, idx * size, size).clone()
            dims[pname] = d
        holder.fsdp_dims = dims
    return modules


def _layer_of(name: str) -> str:
    """The layer a block parameter belongs to: `3.` of `3.ffn.0.weight`,
    `audio_to_video_conditioners.1.` of the bridge's."""
    parts = name.split(".")
    i = next(i for i, p in enumerate(parts) if p.isdigit())
    return ".".join(parts[:i + 1]) + "."


class GatheredWeights(Mapping):
    """{prefix + parameter name: the whole tensor} for the sharded
    parameters of `holder` (its `fsdp_dims`). Reading one entry of a layer
    all-gathers all of that layer's shards over the fsdp axis in one
    collective; the entries are handed out as they are read and not kept:
    `nn.call` reads one layer's entries just before the layer runs, and they
    are freed with the call."""

    def __init__(self, holder: nn.Module, prefix: str, axis: pm.MeshAxis):
        self.holder, self.prefix, self.axis = holder, prefix, axis
        self.dims = getattr(holder, "fsdp_dims", {})
        self.pending: Dict[str, torch.Tensor] = {}

    def __iter__(self):
        return (self.prefix + n for n in self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, key: str) -> torch.Tensor:
        name = key[len(self.prefix):]
        if name not in self.pending:
            layer = _layer_of(name)
            names = [n for n in self.dims if n.startswith(layer)]
            whole = pm.all_gather_many([self.holder.get_parameter(n) for n in names],
                                       [self.dims[n] for n in names], self.axis)
            self.pending = dict(zip(names, whole))
        return self.pending.pop(name)


def block_bytes(modules: Dict[str, nn.Module]) -> int:
    """Bytes of the tower blocks' and the bridge conditioners' parameters
    this rank holds."""
    total = 0
    for name, module in modules.items():
        if name in TOWERS or name == "bridge":
            holder, depth = _block_sets(name, module)
            total += sum(p.numel() * p.element_size() for n, p in holder.named_parameters()
                         if n in depth)
    return total


def shard_batch(batch, mesh):
    """This rank's slice of the batch over the `data` axis: the leading dim
    of every tensor whose leading dim the axis divides (others whole)."""
    data = pm.mesh_shape(mesh).get("data", 1)
    if data <= 1:
        return batch
    idx = mesh.get_local_rank("data")

    def take(x):
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] % data == 0:
            n = x.shape[0] // data
            return x[idx * n:(idx + 1) * n]
        return x

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(take(v) for v in batch)
    return take(batch)
