"""SAM mask decoder with hypernetwork heads (the JAX package's
models/mask_decoder.py), with the reference torch state-dict keys
(``iou_token``, ``mask_tokens``, ``transformer``, ``output_upscaling.
{0,1,3}``, ``output_hypernetworks_mlps.{i}.layers.{j}``,
``iou_prediction_head.layers.{j}``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .common import LayerNorm2d, conv_transpose2d, gelu, linear
from .transformer import TwoWayTransformer


class MLP(nn.Module):
    """``num_layers``-deep ReLU MLP (key ``layers.{j}``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = linear(x, layer, self.dtype)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, use_adapter: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_mask_tokens = num_multimask_outputs + 1
        self.dtype = dtype
        self.transformer = TwoWayTransformer(
            depth=2, embedding_dim=transformer_dim, num_heads=8,
            mlp_dim=2048, use_adapter=use_adapter, dtype=dtype)
        self.iou_token = nn.Embedding(1, transformer_dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens,
                                        transformer_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(transformer_dim, transformer_dim // 4, 2, 2),
            LayerNorm2d(transformer_dim // 4), nn.GELU(),
            nn.ConvTranspose2d(transformer_dim // 4, transformer_dim // 8, 2,
                               2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(transformer_dim, transformer_dim, transformer_dim // 8, 3,
                dtype=dtype) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(transformer_dim, iou_head_hidden_dim,
                                       self.num_mask_tokens, iou_head_depth,
                                       dtype=dtype)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeddings (B, C, h, w), image_pe (1, C, h, w), sparse
        (B, N, C), dense (B, C, h, w) -> (masks (B, K, 4h, 4w) float32,
        iou_pred (B, K))."""
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        output_tokens = output_tokens[None].expand(b, -1, -1)
        tokens = torch.cat([output_tokens, sparse_prompt_embeddings], dim=1)

        src = image_embeddings + dense_prompt_embeddings
        hs, src_out = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        _, c, h, w = src.shape
        up, dt = self.output_upscaling, self.dtype
        x = src_out.transpose(1, 2).reshape(b, c, h, w)
        x = gelu(up[1](conv_transpose2d(x, up[0], dt)))
        upscaled = gelu(conv_transpose2d(x, up[3], dt))  # (B, C/8, 4h, 4w)

        hyper_in = torch.stack([mlp(mask_tokens_out[:, i, :])
                                for i, mlp in enumerate(
                                    self.output_hypernetworks_mlps)], dim=1)
        bu, cu, hu, wu = upscaled.shape
        # the hypernetwork product accumulates in float32 and stays float32
        masks = torch.matmul(hyper_in.to(torch.float32),
                             upscaled.to(torch.float32).reshape(bu, cu, -1))
        masks = masks.reshape(b, -1, hu, wu)
        iou_pred = self.iou_prediction_head(iou_token_out)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
