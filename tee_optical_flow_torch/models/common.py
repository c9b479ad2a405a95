"""Shared building blocks of the SAM model (the JAX package's
models/common.py), as torch modules with the reference torch state-dict
keys.

Layout is NCHW for feature maps and (B, N, C) for tokens, as in the
reference torch SAM. Parameters are float32; ``dtype`` is the compute
type, applied at the JAX package's cast points rather than through
``torch.autocast`` (whose cast points differ):

  * a dense layer or a convolution casts its input, weight and bias to
    ``dtype`` and returns ``dtype`` (flax ``Dense``/``Conv``/
    ``ConvTranspose`` with ``dtype=``);
  * batch norm and the token layer norm compute in float32 and return
    float32 (flax ``BatchNorm``/``LayerNorm`` with ``dtype=float32``);
  * ``LayerNorm2d`` computes in float32 and returns its input's type.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact erf GELU (torch ``nn.GELU``; flax ``gelu(approximate=
    False)``)."""
    return F.gelu(x)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer`` applied in ``dtype``: input, weight and bias cast first."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def conv2d(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer`` (a Conv2d) applied in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias,
                    layer.stride, layer.padding, layer.dilation,
                    layer.groups)


def conv_transpose2d(x: torch.Tensor, layer: nn.ConvTranspose2d,
                     dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (a ConvTranspose2d) applied in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), bias,
                              layer.stride, layer.padding)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)`` over the last axis: float32
    statistics with the fast variance E[x^2] - E[x]^2 clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias, in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


class LayerNorm2d(nn.Module):
    """Layer norm over the channel axis of an NCHW map (eps 1e-6),
    computed in float32 and returned in the input's type."""

    def __init__(self, num_channels: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(1, keepdim=True)
        var = ((xf - mu) ** 2).mean(1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + self.eps)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2, the transformer feed-forward (keys
    ``lin1``/``lin2``)."""

    def __init__(self, embedding_dim: int, mlp_dim: int, act=gelu,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(linear(x, self.lin1, self.dtype))
        return linear(h, self.lin2, self.dtype)


class Conv2d_BN(nn.Module):
    """Conv2d without bias, then eval-mode BatchNorm (eps 1e-5) on the
    running statistics (reference tiny_vit_sam.py Conv2d_BN; keys ``c``
    and ``bn``). The convolution runs in ``dtype``; the norm computes
    (x - mean) * (rsqrt(var + eps) * weight) + bias in float32 and returns
    float32, as flax ``BatchNorm(dtype=float32)`` does."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.c = nn.Conv2d(in_ch, out_ch, kernel, stride, padding,
                           groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.c, self.dtype).to(torch.float32)
        bn = self.bn
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return ((y - bn.running_mean[:, None, None]) * mul[:, None, None]
                + bn.bias[:, None, None])
