"""Parameter sharding of the SAM zoo over the trainer's ('data', 'model')
mesh (the JAX package's parallel/shardings.py).

The rule is the JAX package's, applied to each port parameter's flax path
(models/convert.sam_flax_paths, the converter's own key map): a 2-D
kernel under ``mlp/lin1/`` or ``/qkv/`` is column-parallel when the
model axis divides its outputs, one under ``mlp/lin2/``, ``/proj/`` or
``out_proj`` row-parallel when it divides its inputs; everything else is
replicated (a TinyViT block's ``mlp.fc1``/``mlp.fc2`` are ``mlp/lin1``/
``mlp/lin2`` there). A flax kernel is (in, out) and a torch weight (out,
in), so column-parallel ``P(None, 'model')`` splits the torch weight's
dim 0 (``COLUMN``) and row-parallel ``P('model', None)`` its dim 1
(``ROW``), in contiguous blocks, rank k of the model group holding block
k.

``apply_shardings`` keeps this rank's blocks under the same parameter
names and gives each split layer a ``shard`` through which
models/common.linear runs its product (parallel/collectives for the
conjugate pairs):

  * an MLP (``fc1``/``lin1`` -> activation -> ``fc2``/``lin2``) whose
    both layers are split stays split between the two products: the
    first's input enters through ``copy_to_group``, the second's partial
    products leave through ``reduce_from_group``;
  * a fused qkv is gathered before the head split, unless its blocks
    hold whole heads (TinyViT's per-head [q, k, v] layout when the model
    axis divides the heads): then the attention runs on this rank's heads
    (their slice of ``attention_biases``) and the ``proj`` after it takes
    its block as it is. ViT-Det's (B, N, 3, heads, hd) layout always
    gathers;
  * a row-parallel layer fed a whole input (the decoder's ``out_proj``,
    whose q/k/v projections stay whole) slices it;
  * a column layer's bias is split with its weight; a row layer's is
    added once, after the sum.

LoRA factors stay whole (the rule does not match ``down``/``up`` or the
factors); ``merge_lora_shards`` merges their product's block into a
split weight.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .collectives import (
    copy_to_group, gather_blocks, gather_from_group, reduce_from_group,
)
from .mesh import Mesh, NamedSharding, process_mesh

COLUMN = ("model", None)
ROW = (None, "model")

_MLP_PAIRS = (("fc1", "fc2"), ("lin1", "lin2"))


def _flax_spec(joined: str, dim_in: int, dim_out: int, nmodel: int):
    """The JAX package's rule on a 2-D kernel's flax path: its
    PartitionSpec as a tuple over the flax (in, out) kernel."""
    if ("mlp/lin1/" in joined or "/qkv/" in joined) and dim_out % nmodel == 0:
        return (None, "model")
    if ("mlp/lin2/" in joined or "/proj/" in joined
            or "out_proj" in joined) and dim_in % nmodel == 0:
        return ("model", None)
    return ()


def sam_param_shardings(mesh: Mesh, model: nn.Module
                        ) -> Dict[str, NamedSharding]:
    """{port parameter name: NamedSharding} of ``model`` (a port SAM) on
    ``mesh``: ``COLUMN`` or ``ROW`` for the weights the JAX rule splits,
    () for every other parameter (biases and norms are replicated, as
    there)."""
    from ..models.convert import sam_flax_paths

    paths = sam_flax_paths(model)
    nmodel = mesh.shape["model"]
    out = {}
    for name, p in model.named_parameters():
        spec = ()
        path = paths.get(name)
        if path is not None and path[0] == "params" and p.ndim == 2:
            joined = "/".join(path[1:])
            if joined.endswith("kernel"):
                dim_out, dim_in = p.shape
                flax = _flax_spec(joined, dim_in, dim_out, nmodel)
                spec = flax[::-1]
        out[name] = NamedSharding(mesh, spec)
    return out


class _Shard:
    """A dense layer's block on this rank of the model group."""

    def __init__(self, group, rank: int, size: int) -> None:
        self.group, self.rank, self.size = group, rank, size

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        width = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * width, width)


class ColumnShard(_Shard):
    """Rows (output features) of the torch weight; with ``gather`` the
    output is made whole."""

    dim = 0

    def __init__(self, group, rank: int, size: int, gather: bool = True
                 ) -> None:
        super().__init__(group, rank, size)
        self.gather = gather

    def __call__(self, x, layer: nn.Linear, dtype):
        x = copy_to_group(x, self.group)
        bias = None if layer.bias is None else layer.bias.to(dtype)
        y = F.linear(x.to(dtype), layer.weight.to(dtype), bias)
        return gather_from_group(y, self.group, -1) if self.gather else y


class RowShard(_Shard):
    """Columns (input features) of the torch weight; a whole input is
    sliced first unless ``input_split``."""

    dim = 1

    def __init__(self, group, rank: int, size: int,
                 input_split: bool = False) -> None:
        super().__init__(group, rank, size)
        self.input_split = input_split

    def __call__(self, x, layer: nn.Linear, dtype):
        if not self.input_split:
            x = self.block(copy_to_group(x, self.group), -1)
        y = reduce_from_group(F.linear(x.to(dtype), layer.weight.to(dtype)),
                              self.group)
        return y if layer.bias is None else y + layer.bias.to(dtype)


class HeadPart:
    """This rank's heads of a per-head parameter (TinyViT's
    ``attention_biases``), whose gradient is summed over the model
    group."""

    def __init__(self, group, rank: int, size: int) -> None:
        self.group, self.rank, self.size = group, rank, size

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        h = t.shape[0] // self.size
        return copy_to_group(t, self.group).narrow(0, self.rank * h, h)


def _whole_heads(attn: nn.Module, size: int) -> bool:
    from ..models.tinyvit import Attention

    return isinstance(attn, Attention) and attn.num_heads % size == 0


def apply_shardings(model: nn.Module, shardings: Dict[str, NamedSharding]
                    ) -> nn.Module:
    """Keep this rank's blocks of the split weights of ``model`` (in
    place, same names, ``requires_grad`` kept) and route their products
    (see the module docstring). The rank's place comes from the mesh of
    the shardings (parallel/mesh.process_mesh). ``model.shard_layout``
    becomes {parameter name: its shard} of every split tensor; a model
    axis of 1 changes nothing."""
    specs = {n: sh.spec for n, sh in shardings.items()}
    model.shard_layout = {}
    if not any(specs.values()):
        return model
    mesh = next(iter(shardings.values())).mesh
    pm = process_mesh(mesh)
    place = (pm.model_group, pm.model, pm.n_model)
    modules = dict(model.named_modules())
    for name, mod in modules.items():
        if not isinstance(mod, nn.Linear):
            continue
        spec = specs.get(f"{name}.weight", ())
        if spec == COLUMN:
            mod.shard = ColumnShard(*place)
        elif spec == ROW:
            mod.shard = RowShard(*place)
    for mod in modules.values():
        for first, second in _MLP_PAIRS:
            a, b = getattr(mod, first, None), getattr(mod, second, None)
            if (isinstance(getattr(a, "shard", None), ColumnShard)
                    and isinstance(getattr(b, "shard", None), RowShard)):
                a.shard.gather = False
                b.shard.input_split = True
        qkv, proj = getattr(mod, "qkv", None), getattr(mod, "proj", None)
        if (_whole_heads(mod, pm.n_model)
                and isinstance(getattr(qkv, "shard", None), ColumnShard)
                and isinstance(getattr(proj, "shard", None), RowShard)):
            qkv.shard.gather = False
            proj.shard.input_split = True
            mod.head_part = HeadPart(*place)
    with torch.no_grad():
        for name, mod in modules.items():
            shard = getattr(mod, "shard", None) if isinstance(
                mod, nn.Linear) else None
            if shard is None:
                continue
            kept = [("weight", shard.dim)]
            if mod.bias is not None and shard.dim == 0:
                kept.append(("bias", 0))
            for pname, dim in kept:
                p = getattr(mod, pname)
                setattr(mod, pname, nn.Parameter(
                    shard.block(p.detach(), dim).clone(),
                    requires_grad=p.requires_grad))
                model.shard_layout[f"{name}.{pname}"] = (shard, dim)
    return model


def gather_tensor(t: torch.Tensor, shard: Optional[Tuple]) -> torch.Tensor:
    """A split tensor made whole (a collective over its model group);
    ``shard`` None returns ``t``."""
    if shard is None:
        return t
    s, dim = shard
    return gather_blocks(t.detach(), s.group, dim)


def block_of(t: torch.Tensor, shard: Optional[Tuple]) -> torch.Tensor:
    """This rank's block of a whole tensor; ``shard`` None returns
    ``t``."""
    if shard is None:
        return t
    s, dim = shard
    return s.block(t, dim).clone()


def merge_lora_shards(model: nn.Module, lora, heads_by_dim=None
                      ) -> Dict[str, torch.Tensor]:
    """models/lora.merge_lora on ``model``'s named parameters, a split
    weight taking its block of the factors' product (computed whole from
    the whole factors, which enter through ``copy_to_group``): base
    block + delta block, the same sums as the whole merge's."""
    from ..models.lora import merge_lora

    params = dict(model.named_parameters())
    layout = getattr(model, "shard_layout", None) or {}
    merged = {}
    for site, fac in lora.items():
        key = f"{site}.weight"
        shard = layout.get(key)
        if shard is None:
            merged.update(merge_lora({key: params[key]}, {site: fac},
                                     heads_by_dim))
            continue
        s, dim = shard
        w = params[key]
        full = list(w.shape)
        full[dim] *= s.size
        zero = torch.zeros(full, dtype=w.dtype, device=w.device)
        whole = {k: copy_to_group(v, s.group) for k, v in fac.items()}
        delta = merge_lora({key: zero}, {site: whole}, heads_by_dim)[key]
        merged[key] = w.detach() + s.block(delta, dim)
    return merged
