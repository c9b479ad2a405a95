"""SAM prompt encoder (the JAX package's models/prompt_encoder.py) with the
reference torch state-dict keys: ``pe_layer.positional_encoding_gaussian_
matrix`` (a buffer), ``point_embeddings.{0..3}``, ``not_a_point_embed``,
``mask_downscaling.{0,1,3,4,6}`` and ``no_mask_embed``; and the
reference's unused ``PromptAutoEncoder``.

Points, boxes and masks are all ported, so a checkpoint loads strictly;
the pipeline takes the no-prompt path (the ``no_mask_embed`` dense
default broadcast over the embedding grid). Dense outputs are NCHW.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .common import LayerNorm2d, conv2d, gelu


class PositionEmbeddingRandom(nn.Module):
    """Gaussian random Fourier features of coordinates in [0, 1]."""

    def __init__(self, num_pos_feats: int = 128) -> None:
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn((2, num_pos_feats)))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """(..., 2) -> (..., 2 * num_pos_feats)."""
        c = 2.0 * coords - 1.0
        c = c @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """Dense PE of an (h, w) grid of pixel centres -> (h, w, C)."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        return self(torch.stack([xx, yy], dim=-1))


class PromptAutoEncoder(nn.Module):
    """Image-conditioned prompt embeddings (the JAX package's
    ``PromptAutoEncoder``; reference prompt_encoder.py:50-100, unused by
    any pipeline): a small conv stack downsamples the image itself into
    the dense embedding, and the sparse embeddings are empty. Keys
    ``image_downscaling.{0,1,3,4,6}``, as the reference module's.

    The reference's quirks are kept: the first 3x3 conv has no padding
    (the map shrinks by 2 before the stride-4 conv, so a 1024^2 input
    gives a 255^2 dense grid, not 256^2), and the sparse output has zero
    width. NCHW in and out."""

    def __init__(self, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16, embed_dim: int = 256,
                 in_chans: int = 3,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.image_downscaling = nn.Sequential(
            nn.Conv2d(in_chans, mask_in_chans // 4, 3),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 4, 4),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, C, H, W) -> (sparse (B, 0, D), dense (B, D, h', w'))."""
        ds, dt = self.image_downscaling, self.dtype
        x = gelu(ds[1](conv2d(images, ds[0], dt)))
        x = gelu(ds[4](conv2d(x, ds[3], dt)))
        dense = conv2d(x, ds[6], dt)
        sparse = torch.zeros((images.shape[0], 0, self.embed_dim),
                             dtype=torch.float32, device=images.device)
        return sparse, dense


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.dtype = dtype
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0/1: negative/positive point, 2/3: box corners
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, C, h, w) positional encoding of the embedding grid."""
        h, w = self.image_embedding_size
        return self.pe_layer.grid(h, w).permute(2, 0, 1)[None]

    def _scale(self) -> torch.Tensor:
        return torch.tensor([self.input_image_size[1],
                             self.input_image_size[0]], dtype=torch.float32,
                            device=self.no_mask_embed.weight.device)

    def _embed_points(self, points, labels, pad: bool) -> torch.Tensor:
        points = points + 0.5  # pixel centre
        if pad:
            points = torch.cat([points, points.new_zeros(
                (points.shape[0], 1, 2))], dim=1)
            labels = torch.cat([labels, -labels.new_ones(
                (labels.shape[0], 1))], dim=1)
        pe = self.pe_layer(points / self._scale())
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        pe = torch.where(lab == 0, pe + self.point_embeddings[0].weight[0],
                         pe)
        return torch.where(lab == 1, pe + self.point_embeddings[1].weight[0],
                           pe)

    def _embed_boxes(self, boxes) -> torch.Tensor:
        corners = (boxes + 0.5).reshape(-1, 2, 2)
        pe = self.pe_layer(corners / self._scale())
        return torch.stack([pe[:, 0] + self.point_embeddings[2].weight[0],
                            pe[:, 1] + self.point_embeddings[3].weight[0]],
                           dim=1)

    def _embed_masks(self, masks) -> torch.Tensor:
        """(B, 1, 4h, 4w) -> (B, C, h, w)."""
        md, dt = self.mask_downscaling, self.dtype
        x = gelu(md[1](conv2d(masks, md[0], dt)))
        x = gelu(md[4](conv2d(x, md[3], dt)))
        return conv2d(x, md[6], dt)

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None, boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None, batch_size: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sparse (B, N, C), dense (B, C, h, w))."""
        bs = batch_size
        if points is not None:
            bs = points[0].shape[0]
        elif boxes is not None:
            bs = boxes.shape[0]
        elif masks is not None:
            bs = masks.shape[0]
        dev = self.no_mask_embed.weight.device
        sparse = torch.zeros((bs, 0, self.embed_dim), device=dev)
        if points is not None:
            coords, labels = points
            sparse = torch.cat([sparse, self._embed_points(
                coords, labels, pad=(boxes is None))], dim=1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], dim=1)
        if masks is not None:
            dense = self._embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(
                1, self.embed_dim, 1, 1).expand(bs, -1, h, w)
        return sparse, dense
