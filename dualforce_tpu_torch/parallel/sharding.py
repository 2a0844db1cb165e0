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

Quantized towers (`nn.Int8Linear`, `nn.Int4Linear`) shard as JAX's
`param_pspecs` of the quantized tree: each quantized leaf (the int8 weight
and its per-output-channel scales, the packed int4 nibbles and their group
scales) by the same rule on its own JAX shape, and `GatheredWeights`
gathers them per layer with the rest, int8 moving as int8. JAX quantizes
GSPMD-global arrays, so its numbers are those of the whole tower: a tower
sharded before it is quantized (`quantize_sharded`) quantizes each layer
whole and shards the result, and a tower quantized first shards its
quantized leaves; both give each rank the same slices.

Only the blocks and the conditioners are sharded; UMT5, the VAEs and the
towers' embeddings and heads stay whole on every rank (JAX's GSPMD shards
them too: a difference in memory only). `GatheredWeights` gathers one
layer's shards as the layer reads them (through `nn.call`) and lets them go
after: the counterpart of JAX's `layer_param_map` hook.

Training: the shards of trained blocks stay leaf parameters that the
optimizer updates (`Shard` tells it where each lies in the whole tensor).
The fsdp ranks compute the same tokens, so a gathered weight's gradient is
each rank's own slice (counted once, not fsdp times), and
`reduce_gradients` sums the rest over `data` and `cp`.
"""

from __future__ import annotations

import copy
import itertools
from collections.abc import Mapping
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
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


# the quantized layers' transposed leaves: [out, in] (int4: [out, in / 2], [out, in / group])
# here, [in, out] in JAX's `kernel_q`, `kernel_q4`, `kernel_scale4`
_TRANSPOSED = {dnn.Int8Linear: ("weight_q",), dnn.Int4Linear: ("weight_q4", "weight_scale4")}


def _jax_order(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[Optional[int], ...]:
    """The port's dims in the JAX leaf's order (None: a dim of size 1 the
    port's tensor lacks): a linear's weight (and the packed
    `in_proj_weight`) is transposed there, as are a quantized linear's
    int8 weight and int4 nibbles and scales; an int8 linear's scales are
    [1, out] there, [out] here."""
    owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
    leaf = name.rpartition(".")[2]
    if p.ndim == 2 and ((leaf == "weight" and isinstance(owner, nn.Linear))
                        or leaf == "in_proj_weight"
                        or leaf in _TRANSPOSED.get(type(owner), ())):
        return (1, 0)
    if isinstance(owner, dnn.Int8Linear) and leaf == "weight_scale":
        return (None, 0)
    return tuple(range(p.ndim))


def leaf_dim(module: nn.Module, name: str, p: torch.Tensor, layers: int,
             fsdp_size: int) -> Optional[int]:
    """The dim of the port's parameter or buffer `name` (a block's, stacked
    `layers` deep in the JAX tree) that `fsdp` shards, or None (whole)."""
    order = _jax_order(module, name, p)
    stacked = [layers] + [1 if i is None else p.shape[i] for i in order]
    spec = leaf_spec(stacked, fsdp_size)
    if spec is None or spec + len(stacked) == 0:     # the layer dim: replicated
        return None
    return order[spec + len(stacked) - 1]


def _tensors(holder: nn.Module):
    """A holder's parameters and buffers (a quantized linear's weights are
    buffers), by name."""
    yield from holder.named_parameters()
    yield from holder.named_buffers()


def _get(holder: nn.Module, name: str) -> torch.Tensor:
    owner, _, leaf = name.rpartition(".")
    return getattr(holder.get_submodule(owner) if owner else holder, leaf)


def _set(holder: nn.Module, name: str, t: torch.Tensor) -> None:
    """Replace the parameter or buffer `name` by `t` (a parameter keeps its
    object, its data replaced)."""
    owner, _, leaf = name.rpartition(".")
    mod = holder.get_submodule(owner) if owner else holder
    if leaf in mod._parameters:
        mod._parameters[leaf].data = t
    else:
        mod._buffers[leaf] = t


def block_holder(name: str, module: nn.Module) -> nn.Module:
    """The module holding what fsdp shards: a tower's `blocks`, the bridge."""
    return module.blocks if name in TOWERS else module


def _block_sets(name: str, module: nn.Module):
    """(module holding the sharded tensors, {its parameter or buffer name:
    stack depth})."""
    if name in TOWERS:
        blocks = module.blocks
        return blocks, {n: len(blocks) for n, _ in _tensors(blocks)}
    stacks = {s: len(getattr(module, s)) for s in BRIDGE_STACKS}
    return module, {n: stacks[n.partition(".")[0]] for n, _ in _tensors(module)
                    if n.partition(".")[0] in stacks}


def _shard_holder(holder: nn.Module, depth: Dict[str, int], fsdp: int, idx: int
                  ) -> Dict[str, int]:
    """Keep this rank's slice (the `idx`-th of `fsdp`) of each of the
    holder's tensors in `depth` that `leaf_dim` shards; returns {name:
    sharded dim}."""
    dims = {}
    for pname, p in list(_tensors(holder)):
        if pname not in depth:
            continue
        d = leaf_dim(holder, pname, p, depth[pname], fsdp)
        if d is None:
            continue
        size = p.shape[d] // fsdp
        _set(holder, pname, p.data.narrow(d, idx * size, size).clone())
        dims[pname] = d
    return dims


def shard_params(modules: Dict[str, nn.Module], mesh) -> Dict[str, nn.Module]:
    """Keep this rank's `fsdp` slice of every tower block and bridge
    conditioner parameter (in place; the whole tensors are freed), and of a
    quantized linear's weights and scales. The holder of the blocks (a
    tower's `blocks`, the bridge) records {tensor name: sharded dim} as
    `fsdp_dims`, which `GatheredWeights` reads. A shard stays the same
    `Parameter` object, so a module that trains (full fine-tuning) trains
    its shards; a module sharded already keeps its shards. Returns
    `modules`."""
    fsdp = pm.mesh_shape(mesh).get("fsdp", 1)
    if fsdp <= 1:
        return modules
    idx = mesh.get_local_rank("fsdp")
    for name, module in modules.items():
        if name not in TOWERS and name != "bridge":
            continue
        holder, depth = _block_sets(name, module)
        axis = getattr(holder, "fsdp_axis", None)
        if axis is not None:           # sharded already: its shards stay
            if pm.axis_size(axis) != fsdp:
                raise ValueError(f"{name} is sharded over fsdp {pm.axis_size(axis)}, "
                                 f"not {fsdp}")
            continue
        holder.fsdp_dims = _shard_holder(holder, depth, fsdp, idx)
        holder.fsdp_axis = pm.MeshAxis(mesh, "fsdp")
    return modules


@torch.no_grad()
def quantize_sharded(name: str, module: nn.Module, mode: str) -> nn.Module:
    """`nn.quantize_modules(module, mode)` for a tower or bridge whose
    blocks `shard_params` sharded: a copy (sharing what it does not
    quantize) in which each layer's shards are gathered whole, the layer
    quantized whole (so the numbers are those of quantizing the whole
    tower, as JAX's GSPMD arrays give them), and its tensors sharded again
    by `leaf_dim`, the quantized leaves on their JAX shapes. One layer is
    whole at a time. `module` is left as it was."""
    holder, depth = _block_sets(name, module)
    axis, dims = holder.fsdp_axis, holder.fsdp_dims
    memo = {id(t): t for t in itertools.chain(module.parameters(), module.buffers())}
    memo[id(axis)] = axis
    out = copy.deepcopy(module, memo)
    out_holder, _ = _block_sets(name, out)
    fsdp, idx = pm.axis_size(axis), pm.axis_index(axis)
    new_dims = {}
    for layer in sorted({_layer_of(n) for n in depth}, key=lambda x: (len(x), x)):
        names = sorted(n for n in dims if n.startswith(layer))
        whole = pm.all_gather_many([_get(holder, n) for n in names],
                                   [dims[n] for n in names], axis) if names else []
        parent, _, key = layer[:-1].rpartition(".")
        owner = out_holder.get_submodule(parent) if parent else out_holder
        sub = getattr(owner, key)
        for n, w in zip(names, whole):     # the copy's tensors whole, the source's untouched
            leaf_owner, _, leaf = n[len(layer):].rpartition(".")
            m = sub.get_submodule(leaf_owner) if leaf_owner else sub
            if leaf in m._parameters:
                m._parameters[leaf] = nn.Parameter(w, requires_grad=False)
            else:
                m._buffers[leaf] = w
        setattr(owner, key, dnn.quantize_modules(sub, mode))
        stack = next(d for k, d in depth.items() if k.startswith(layer))
        layer_depth = {layer + n: stack for n, _ in _tensors(getattr(owner, key))}
        new_dims.update(_shard_holder(out_holder, layer_depth, fsdp, idx))
    out_holder.fsdp_dims = new_dims
    return out


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

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.startswith(self.prefix) and \
            key[len(self.prefix):] in self.dims

    def __getitem__(self, key: str) -> torch.Tensor:
        name = key[len(self.prefix):]
        if name not in self.pending:
            layer = _layer_of(name)
            names = [n for n in self.dims if n.startswith(layer)]
            # the fsdp ranks use the whole weights alike: a trained shard's
            # gradient is its slice of the whole one's
            whole = pm.all_gather_many([_get(self.holder, n) for n in names],
                                       [self.dims[n] for n in names], self.axis,
                                       identical=True)
            self.pending = dict(zip(names, whole))
        return self.pending.pop(name)


def gathered_params(mesh, video_blocks, audio_blocks, bridge,
                    params: Optional[Dict[str, Mapping]] = None) -> Optional[Dict]:
    """`forward_dual_tower`'s `params` over a mesh: with fsdp > 1, each
    holder's `GatheredWeights`, under the given mapping of that key where
    there is one (a LoRA's `engine.lora.MergedWeights`, which then merges
    into the gathered base weights: `over`); else `params` as given."""
    if pm.mesh_shape(mesh).get("fsdp", 1) <= 1:
        return params
    fsdp = pm.MeshAxis(mesh, "fsdp")
    params = dict(params or {})
    for key, holder, prefix in (("video", video_blocks, "blocks."),
                                ("audio", audio_blocks, "blocks."), ("bridge", bridge, "")):
        gathered = GatheredWeights(holder, prefix, fsdp)
        params[key] = params[key].over(gathered) if key in params else gathered
    return params


class Shard(NamedTuple):
    """Where an fsdp shard lies in its whole tensor: sharded along `dim`
    over `axis`, this rank's slice the `axis_index`-th of `axis_size`."""
    axis: pm.MeshAxis
    dim: int
    whole_shape: Tuple[int, ...]


def shards_of(modules: Dict[str, nn.Module], params: Sequence[torch.Tensor]
              ) -> List[Optional[Shard]]:
    """Per parameter of `params` (a trainer's, in its order): its `Shard`
    where `shard_params` sharded it, else None."""
    found = {}
    for name, module in modules.items():
        if name not in TOWERS and name != "bridge":
            continue
        holder = block_holder(name, module)
        axis = getattr(holder, "fsdp_axis", None)
        for pname, d in getattr(holder, "fsdp_dims", {}).items():
            p = holder.get_parameter(pname)
            whole = list(p.shape)
            whole[d] *= pm.axis_size(axis)
            found[id(p)] = Shard(axis, d, tuple(whole))
    return [found.get(id(p)) for p in params]


def whole_shapes(modules: Dict[str, nn.Module]) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{module: {parameter name in the module: its whole shape}} for every
    parameter `shard_params` sharded (a module given in shards)."""
    out: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for name, module in modules.items():
        if name not in TOWERS and name != "bridge":
            continue
        holder = block_holder(name, module)
        prefix = "blocks." if name in TOWERS else ""
        for pname, d in getattr(holder, "fsdp_dims", {}).items():
            shape = list(holder.get_parameter(pname).shape)
            shape[d] *= pm.axis_size(holder.fsdp_axis)
            out.setdefault(name, {})[prefix + pname] = tuple(shape)
    return out


def objective_share(mesh) -> float:
    """The share of a loss that every rank computes whole which each rank
    differentiates: 1 / (data * cp). `sp_forward_blocks`' gathers
    reduce-scatter their cotangents (JAX's transpose), so the ranks' shares
    add up to the loss once; fsdp ranks are copies of one another."""
    shape = pm.mesh_shape(mesh)
    return 1.0 / (shape.get("data", 1) * shape.get("cp", 1))


_BUCKET = 1 << 26     # fp32 elements per reduction (256 MiB)


def _reduce(grads: List[torch.Tensor], axis: pm.MeshAxis, scale: float = 1.0) -> None:
    """Each of `grads` (in place) summed over `axis` in fp32, times `scale`,
    in buckets of at most `_BUCKET` elements (every rank cuts the same)."""
    i = 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and (j == i or size + grads[j].numel() <= _BUCKET):
            size += grads[j].numel()
            j += 1
        flat = pm.psum(torch.cat([g.reshape(-1).float() for g in grads[i:j]]), axis)
        if scale != 1.0:
            flat = flat * scale
        start = 0
        for g in grads[i:j]:
            g.copy_(flat[start:start + g.numel()].view(g.shape))
            start += g.numel()
        i = j


@torch.no_grad()
def reduce_gradients(grads: Sequence[torch.Tensor], shards: Sequence[Optional[Shard]],
                     mesh) -> List[torch.Tensor]:
    """The step's gradients after the backward, each rank having
    differentiated its `objective_share`: summed over `data` and `cp`; a
    gradient of a parameter that is whole on every rank is averaged over
    `fsdp` (the fsdp ranks computed the same one: counted once, and the
    replicas stay equal where a kernel sums in a varying order), an fsdp
    shard's is its own. Sums in fp32, cast back to each gradient's dtype.
    Returns new tensors in the same order."""
    shape = pm.mesh_shape(mesh)
    grads = [g.clone() for g in grads]
    for name in ("data", "cp"):
        if shape.get(name, 1) > 1:
            _reduce(grads, pm.MeshAxis(mesh, name))
    fsdp = shape.get("fsdp", 1)
    if fsdp > 1:
        whole = [g for g, s in zip(grads, shards) if s is None]
        _reduce(whole, pm.MeshAxis(mesh, "fsdp"), 1.0 / fsdp)
    return grads


def block_bytes(modules: Dict[str, nn.Module]) -> int:
    """Bytes of the tower blocks' and the bridge conditioners' parameters
    this rank holds."""
    total = 0
    for name, module in modules.items():
        if name in TOWERS or name == "bridge":
            holder, depth = _block_sets(name, module)
            total += sum(p.numel() * p.element_size() for n, p in _tensors(holder)
                         if n in depth)
    return total


def shard_batch(batch, mesh):
    """This rank's slice of the batch over the `data` axis: the leading dim
    of every tensor or numpy array whose leading dim the axis divides
    (others whole)."""
    data = pm.mesh_shape(mesh).get("data", 1)
    if data <= 1:
        return batch
    idx = mesh.get_local_rank("data")

    def take(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim and x.shape[0] % data == 0:
            n = x.shape[0] // data
            return x[idx * n:(idx + 1) * n]
        return x

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(take(v) for v in batch)
    return take(batch)
