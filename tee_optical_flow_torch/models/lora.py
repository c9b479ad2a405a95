"""LoRA for the port's SAM (the JAX package's models/lora.py).

The reference wraps the torch Linears it adapts (sam_LoRa.py:17-65: the
fused qkv of TinyViT's attention gets low-rank deltas on q and v;
:165-236: the decoder's self, cross and final attentions get them on
their q and v projections; A kaiming-uniform, B zero, :241-263). Here, as
in the JAX package, the factors live apart from the model: ``init_lora``
makes them, ``merge_lora`` adds their product to the detached base
weights, and the train step runs the model on the merged weights through
``torch.func.functional_call``, so only the factors receive gradients.

Layout. A flax Dense kernel is (in, out) and a torch Linear weight (out,
in): the strided per-head q and v *columns* of the JAX package's fused
qkv kernel are *rows* of the torch weight (``qkv_qv_columns`` gives the
indices of both). The port keeps its factors in torch's layout: ``a``
(rank, in) and ``b`` (out, rank), delta = b @ a; ``lora_from_flax``
carries the JAX package's (in, rank) / (rank, out) factors across.

Sites are named by the port's module names (``image_encoder.layers.1.
blocks.0.attn.qkv``, ``mask_decoder.transformer.layers.0.self_attn.
q_proj``); a fused site holds ``a_q, b_q, a_v, b_v``, a dense one ``a,
b``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# fused-qkv head count by the block's width, vit_t's stages (the JAX
# package's merge_lora default)
VIT_T_HEADS_BY_DIM = {128: 4, 160: 5, 320: 10}

_DECODER_ATTNS = ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token", "final_attn_token_to_image")


def qkv_qv_columns(dim: int, num_heads: int) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of q and v in TinyViT's fused qkv output (per head:
    key_dim q, key_dim k, key_dim v with attn_ratio 1): columns of a flax
    kernel, rows of the torch weight."""
    kd = dim // num_heads
    per = 3 * kd
    q_cols, v_cols = [], []
    for h in range(num_heads):
        base = h * per
        q_cols.extend(range(base, base + kd))
        v_cols.extend(range(base + 2 * kd, base + 3 * kd))
    return np.asarray(q_cols), np.asarray(v_cols)


def iter_attn_sites(model: nn.Module) -> List[Tuple[str, str]]:
    """(site, kind) of every LoRA-able projection in module order: kind
    ``fused_qkv`` for the qkv of a TinyViT or a ViT-Det attention, ``dense``
    for the q and v projections of the decoder's attentions."""
    from .image_encoder import RelPosAttention
    from .tinyvit import Attention
    from .transformer import DownsampledAttention

    sites = []
    for name, m in model.named_modules():
        if isinstance(m, (Attention, RelPosAttention)):
            sites.append((f"{name}.qkv", "fused_qkv"))
        elif (isinstance(m, DownsampledAttention)
              and name.rsplit(".", 1)[-1] in _DECODER_ATTNS):
            sites.append((f"{name}.q_proj", "dense"))
            sites.append((f"{name}.v_proj", "dense"))
    return sites


def _kaiming(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(6.0 / fan_in)
    return (torch.rand(shape, generator=g) * 2 - 1) * bound


def init_lora(model: nn.Module, rank: int = 4, seed: int = 0,
              encoder: bool = True, decoder: bool = True,
              encoder_layers: Optional[List[int]] = None,
              device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The LoRA factors {site: {name: tensor}}, leaf tensors that require
    grad, on ``device`` (the model's by default). ``a`` is
    kaiming-uniform from a ``torch.Generator`` seeded with ``seed``
    (bound sqrt(6 / fan_in)), ``b`` zero, so the merged model starts as
    the base one. ``encoder_layers`` keeps the encoder's sites of those
    flat attention-block indices (module order; None or [] = all)."""
    g = torch.Generator().manual_seed(seed)
    if device is None:
        device = next(model.parameters()).device
    modules = dict(model.named_modules())
    wanted = set(encoder_layers or [])
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    enc_idx = -1
    for site, kind in iter_attn_sites(model):
        in_enc = site.startswith("image_encoder.")
        if in_enc:
            enc_idx += 1
        if (in_enc and not encoder) or (not in_enc and not decoder):
            continue
        if in_enc and wanted and enc_idx not in wanted:
            continue
        out_f, in_f = modules[site].weight.shape
        if kind == "fused_qkv":
            if out_f != 3 * in_f:
                raise ValueError(f"{site}: unexpected fused qkv layout")
            fac = {"a_q": _kaiming((rank, in_f), in_f, g),
                   "b_q": torch.zeros(in_f, rank),
                   "a_v": _kaiming((rank, in_f), in_f, g),
                   "b_v": torch.zeros(in_f, rank)}
        else:
            fac = {"a": _kaiming((rank, in_f), in_f, g),
                   "b": torch.zeros(out_f, rank)}
        lora[site] = {k: v.to(device).requires_grad_(True)
                      for k, v in fac.items()}
    return lora


def merge_lora(params: Dict[str, torch.Tensor],
               lora: Dict[str, Dict[str, torch.Tensor]],
               heads_by_dim: Optional[Dict[int, int]] = None
               ) -> Dict[str, torch.Tensor]:
    """The merged weights {``<site>.weight``: base + delta} of every site
    in ``lora``, from ``params`` (a model's named parameters or state
    dict). The base weight is detached, so gradients reach the factors
    only; the other parameters are the model's own. A fused qkv site's
    head count comes from ``heads_by_dim`` by its width (vit_t's by
    default), as in the JAX package: a ViT-Det encoder's qkv (width 768,
    1024 or 1280) has none there, so encoder LoRA on vit_b/l/h raises
    ValueError at the first merge, as the JAX package's does; decoder-only
    LoRA trains."""
    heads_by_dim = heads_by_dim or VIT_T_HEADS_BY_DIM
    merged = {}
    for site, fac in lora.items():
        key = f"{site}.weight"
        w = params[key].detach()
        if "a_q" in fac:
            dim = w.shape[1]
            heads = heads_by_dim.get(dim)
            if heads is None:
                raise ValueError(f"no head count known for dim {dim}")
            q_rows, v_rows = (torch.from_numpy(i).to(w.device)
                              for i in qkv_qv_columns(dim, heads))
            w = w.index_add(0, q_rows, fac["b_q"] @ fac["a_q"])
            w = w.index_add(0, v_rows, fac["b_v"] @ fac["a_v"])
        else:
            w = w + fac["b"] @ fac["a"]
        merged[key] = w
    return merged


_FLAX_SITE = (
    (re.compile(r"^image_encoder/stage(\d+)_block(\d+)/attn/qkv$"),
     r"image_encoder.layers.\1.blocks.\2.attn.qkv"),
    (re.compile(r"^image_encoder/block(\d+)/attn/qkv$"),
     r"image_encoder.blocks.\1.attn.qkv"),
    (re.compile(r"^mask_decoder/transformer/layer(\d+)/(\w+)/(\w+)$"),
     r"mask_decoder.transformer.layers.\1.\2.\3"),
    (re.compile(r"^mask_decoder/transformer/final_attn_token_to_image/(\w+)$"),
     r"mask_decoder.transformer.final_attn_token_to_image.\1"),
)


def site_from_flax(name: str) -> str:
    """A JAX package LoRA site (its flax path joined by '/') -> the
    port's module name."""
    for pattern, repl in _FLAX_SITE:
        if pattern.match(name):
            return pattern.sub(repl, name)
    raise ValueError(f"unknown LoRA site {name!r}")


def lora_from_flax(lora_tree, device=None
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Carry the JAX package's factor tree (numpy or jax arrays: a (in,
    rank), b (rank, out)) across to the port's layout (a (rank, in), b
    (out, rank)), as leaf tensors that require grad."""
    out = {}
    for name, fac in lora_tree.items():
        out[site_from_flax(name)] = {
            k: torch.from_numpy(np.array(v, np.float32).T.copy()).to(
                device or "cpu").requires_grad_(True)
            for k, v in fac.items()}
    return out
