"""The mask decoder's two-way (token <-> image) transformer (the JAX
package's models/transformer.py) with the reference torch state-dict keys
(``layers.{i}.{self_attn,cross_attn_token_to_image,
cross_attn_image_to_token}.{q,k,v,out}_proj``, ``norm1..4``, ``mlp.lin1/2``,
``final_attn_token_to_image``, ``norm_final_attn``).

Attention is an explicit matmul, softmax, matmul: the scores and the
weighted sum accumulate in float32, the softmax runs in float32 and is cast
to the compute type, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .common import Adapter, MLPBlock, layer_norm, linear


class DownsampledAttention(nn.Module):
    """Multi-head attention projecting into embedding_dim /
    downsample_rate channels."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.k_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.v_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim)
        self.dtype = dtype

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.reshape(b, n, self.num_heads, -1).transpose(1, 2).to(
            torch.float32)

    def forward(self, q, k, v) -> torch.Tensor:
        dt = self.dtype
        qh = self._split(linear(q, self.q_proj, dt))
        kh = self._split(linear(k, self.k_proj, dt))
        vh = self._split(linear(v, self.v_proj, dt))
        head_dim = qh.shape[-1]
        attn = torch.matmul(qh, kh.transpose(-2, -1)) / (head_dim ** 0.5)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn.to(torch.float32), vh).to(dt)
        b = out.shape[0]
        out = out.transpose(1, 2).reshape(b, -1, self.internal_dim)
        return linear(out, self.out_proj, dt)


class TwoWayAttentionBlock(nn.Module):
    """Token self-attention, token->image cross-attention, MLP (ReLU),
    image->token cross-attention, each followed by a layer norm. With
    ``use_adapter`` the MLP's output goes through ``MLP_Adapter`` (with
    its skip) before the residual sum (the JAX package's
    ``mlp_adapter``)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False,
                 use_adapter: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.self_attn = DownsampledAttention(embedding_dim, num_heads,
                                              dtype=dtype)
        self.norm1 = nn.LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate, dtype=dtype)
        self.norm2 = nn.LayerNorm(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act=torch.relu,
                            dtype=dtype)
        self.norm3 = nn.LayerNorm(embedding_dim)
        self.norm4 = nn.LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate, dtype=dtype)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.MLP_Adapter = Adapter(embedding_dim) if use_adapter else None

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = layer_norm(queries, self.norm1)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = layer_norm(queries, self.norm2)

        mlp_out = self.mlp(queries)
        if self.MLP_Adapter is not None:
            mlp_out = self.MLP_Adapter(mlp_out)
        queries = layer_norm(queries + mlp_out, self.norm3)

        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = layer_norm(keys, self.norm4)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 use_adapter: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0),
                                 use_adapter=use_adapter, dtype=dtype)
            for i in range(depth))
        self.final_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate, dtype=dtype)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding (B, C, h, w), image_pe (1, C, h, w),
        point_embedding (B, N, C) -> (tokens (B, N, C), image (B, h*w,
        C))."""
        b, c, h, w = image_embedding.shape
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return layer_norm(queries, self.norm_final_attn), keys
