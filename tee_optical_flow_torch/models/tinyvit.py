"""TinyViT-5M image encoder of vit_t SAM (MobileSAM's backbone): the JAX
package's models/tinyvit.py as torch modules, NCHW between stages, with
the reference torch state-dict keys (tiny_vit_sam.py: ``patch_embed.seq``,
``layers.{s}.blocks.{i}``, ``layers.{s}.downsample``, ``neck.{0..3}``).

vit_t: embed_dims (64, 128, 160, 320), depths (2, 2, 6, 2), heads (2, 4,
5, 10), windows (7, 7, 14, 7); a 1024x1024 input gives a 64x64x256
embedding. The cast points follow the JAX package (see models/common.py).
Every forward takes ``train``: its Conv2d_BN layers then normalise by the
batch statistics (models/common.Conv2d_BN). ``adapter_stages`` gives the
blocks of those stages a ``Space_Adapter`` after the attention and an
``MLP_Adapter`` beside the MLP (the JAX package's ``space_adapter`` and
``mlp_adapter``).
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (
    Adapter, Conv2d_BN, LayerNorm2d, conv2d, gelu, layer_norm, linear,
)


@functools.lru_cache(maxsize=8)
def attention_bias_idxs(res: int) -> Tuple[np.ndarray, int]:
    """(N, N) int table mapping token pairs of a res x res window to
    unique |offset| ids, and the number of ids."""
    points = list(itertools.product(range(res), range(res)))
    offsets = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n), len(offsets)


class Attention(nn.Module):
    """Pre-norm multi-head attention with a learned bias per token offset,
    on (B, N, C) windows. The scores and the weighted sum accumulate in
    float32; the softmax runs in float32 and is cast to ``dtype``."""

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 resolution: int, attn_ratio: float = 1.0,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.d = int(attn_ratio * key_dim)
        self.dh = self.d * num_heads
        nh_kd = key_dim * num_heads
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, self.dh + 2 * nh_kd)
        self.proj = nn.Linear(self.dh, dim)
        idxs, n_offsets = attention_bias_idxs(resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads,
                                                         n_offsets))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs),
                             persistent=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        kd = self.key_dim
        x = layer_norm(x, self.norm)
        qkv = linear(x, self.qkv, self.dtype)
        qkv = qkv.reshape(b, n, self.num_heads, 2 * kd + self.d)
        qkv = qkv.permute(0, 2, 1, 3).to(torch.float32)  # (B, H, N, *)
        q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
        attn = torch.matmul(q, k.transpose(-2, -1)) * (kd ** -0.5)
        attn = attn + self.attention_biases[:, self.attention_bias_idxs]
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(attn.to(torch.float32), v).to(self.dtype)
        out = out.transpose(1, 2).reshape(b, n, self.dh)
        return linear(out, self.proj, self.dtype)


class Mlp(nn.Module):
    """The TinyViT block's pre-norm MLP (keys ``norm``, ``fc1``,
    ``fc2``)."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(linear(layer_norm(x, self.norm), self.fc1, self.dtype))
        return linear(h, self.fc2, self.dtype)


class MBConv(nn.Module):
    """Inverted residual conv block."""

    def __init__(self, dim: int, expand_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        hidden = int(dim * expand_ratio)
        self.conv1 = Conv2d_BN(dim, hidden, 1, dtype=dtype)
        self.conv2 = Conv2d_BN(hidden, hidden, 3, 1, 1, groups=hidden,
                               dtype=dtype)
        self.conv3 = Conv2d_BN(hidden, dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = gelu(self.conv1(x, train))
        y = gelu(self.conv2(y, train))
        return gelu(self.conv3(y, train) + x)


class PatchMerging(nn.Module):
    """1x1 expand, 3x3 depthwise, 1x1. The depthwise conv has stride 1
    when ``keep_resolution`` or the output width is 320, 448 or 576 (the
    MobileSAM change that keeps the last stage at 1/16), else 2."""

    def __init__(self, dim: int, out_dim: int, keep_resolution: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        stride = 1 if keep_resolution or out_dim in (320, 448, 576) else 2
        self.conv1 = Conv2d_BN(dim, out_dim, 1, dtype=dtype)
        self.conv2 = Conv2d_BN(out_dim, out_dim, 3, stride, 1,
                               groups=out_dim, dtype=dtype)
        self.conv3 = Conv2d_BN(out_dim, out_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = gelu(self.conv2(gelu(self.conv1(x, train)), train))
        return self.conv3(y, train)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C) windows, zero-padding the
    bottom and right to a multiple of ``ws``."""
    b, h, w, c = x.shape
    pad_b = (ws - h % ws) % ws
    pad_r = (ws - w % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    ph, pw = h + pad_b, w + pad_r
    nh, nw = ph // ws, pw // ws
    x = x.reshape(b, nh, ws, nw, ws, c).transpose(2, 3)
    return x.reshape(b * nh * nw, ws * ws, c), (ph, pw, nh, nw)


def window_unpartition(x: torch.Tensor, ws: int, b: int, h: int, w: int,
                       dims) -> torch.Tensor:
    """Inverse of window_partition, cropping the padding."""
    ph, pw, nh, nw = dims
    x = x.reshape(b, nh, nw, ws, ws, x.shape[-1]).transpose(2, 3)
    return x.reshape(b, ph, pw, -1)[:, :h, :w]


class TinyViTBlock(nn.Module):
    """Windowed attention, then a depthwise local conv, then the MLP; on
    an NCHW map. With ``use_adapter`` the attention's output goes through
    ``Space_Adapter`` (with its skip) and half of ``MLP_Adapter`` (no
    skip) of the MLP's input joins the MLP's residual sum."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, local_conv_size: int = 3,
                 use_adapter: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.window_size = window_size
        self.attn = Attention(dim, dim // num_heads, num_heads, window_size,
                              dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.local_conv = Conv2d_BN(dim, dim, local_conv_size, 1,
                                    local_conv_size // 2, groups=dim,
                                    dtype=dtype)
        if use_adapter:
            self.Space_Adapter = Adapter(dim)
            self.MLP_Adapter = Adapter(dim, skip_connect=False)
        self.use_adapter = use_adapter

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, c, h, w = x.shape
        ws = self.window_size
        tokens = x.permute(0, 2, 3, 1)  # (B, H, W, C)
        if h == ws and w == ws:
            y = self.attn(tokens.reshape(b, h * w, c)).reshape(b, h, w, c)
        else:
            wins, dims = window_partition(tokens, ws)
            y = window_unpartition(self.attn(wins), ws, b, h, w, dims)
        if self.use_adapter:
            y = self.Space_Adapter(y.reshape(b, h * w, c)).reshape(b, h, w,
                                                                   c)
        x = x + y.permute(0, 3, 1, 2)
        x = self.local_conv(x, train)
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.use_adapter:
            tokens = (tokens + self.mlp(tokens)
                      + 0.5 * self.MLP_Adapter(tokens))
        else:
            tokens = tokens + self.mlp(tokens)
        return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Stage(nn.Module):
    """A stage's blocks and its trailing merge (reference ConvLayer /
    BasicLayer: keys ``blocks`` and ``downsample``)."""

    def __init__(self, blocks, downsample: Optional[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, train)
        return x if self.downsample is None else self.downsample(x, train)


class _PatchEmbed(nn.Module):
    """Two 3x3 stride-2 Conv2d_BN with a GELU between (key ``seq``)."""

    def __init__(self, d0: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.seq = nn.Sequential(
            Conv2d_BN(3, d0 // 2, 3, 2, 1, dtype=dtype), nn.GELU(),
            Conv2d_BN(d0 // 2, d0, 3, 2, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.seq[2](gelu(self.seq[0](x, train)), train)


class TinyViT(nn.Module):
    """vit_t SAM image encoder: (B, 3, S, S) -> (B, neck_dim, S/16, S/16).

    ``norm_head`` and ``head`` are the reference model's classifier head:
    SAM never runs them, they are here so that a reference checkpoint
    loads with ``strict=True``."""

    def __init__(self, img_size: int = 1024,
                 embed_dims: Sequence[int] = (64, 128, 160, 320),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (2, 4, 5, 10),
                 window_sizes: Sequence[int] = (7, 7, 14, 7),
                 mlp_ratio: float = 4.0, neck_dim: int = 256,
                 keep_resolution_stage: int = 2, head_classes: int = 1000,
                 adapter_stages: Sequence[int] = (),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(embed_dims[0], dtype)
        layers = [_Stage([MBConv(embed_dims[0], 4.0, dtype=dtype)
                          for _ in range(depths[0])],
                         PatchMerging(embed_dims[0], embed_dims[1],
                                      dtype=dtype))]
        for stage in (1, 2, 3):
            dim = embed_dims[stage]
            blocks = [TinyViTBlock(dim, num_heads[stage],
                                   window_sizes[stage], mlp_ratio,
                                   use_adapter=stage in adapter_stages,
                                   dtype=dtype)
                      for _ in range(depths[stage])]
            merge = None if stage == 3 else PatchMerging(
                dim, embed_dims[stage + 1],
                keep_resolution=(stage == keep_resolution_stage),
                dtype=dtype)
            layers.append(_Stage(blocks, merge))
        self.layers = nn.ModuleList(layers)
        self.norm_head = nn.LayerNorm(embed_dims[-1])
        self.head = nn.Linear(embed_dims[-1], head_classes)
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dims[-1], neck_dim, 1, bias=False),
            LayerNorm2d(neck_dim),
            nn.Conv2d(neck_dim, neck_dim, 3, padding=1, bias=False),
            LayerNorm2d(neck_dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.patch_embed(x, train)
        for layer in self.layers:
            x = layer(x, train)
        x = self.neck[1](conv2d(x, self.neck[0], self.dtype))
        return self.neck[3](conv2d(x, self.neck[2], self.dtype))
