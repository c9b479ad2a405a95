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


class Adapter(nn.Module):
    """Bottleneck adapter for PEFT (the JAX package's ``Adapter``; the
    reference's Medical-SAM-Adapter keys ``D_fc1``/``D_fc2``): down to
    ``int(dim * mlp_ratio)`` channels, GELU, back up, with the input added
    when ``skip_connect``. Computes in float32 whatever the model's
    compute type, as the JAX package's (its ``dtype`` default)."""

    def __init__(self, dim: int, mlp_ratio: float = 0.25,
                 skip_connect: bool = True) -> None:
        super().__init__()
        hidden = max(1, int(dim * mlp_ratio))
        self.D_fc1 = nn.Linear(dim, hidden)
        self.D_fc2 = nn.Linear(hidden, dim)
        self.skip_connect = skip_connect

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(linear(x, self.D_fc1, torch.float32))
        h = linear(h, self.D_fc2, torch.float32)
        return x + h if self.skip_connect else h


# flax BatchNorm's momentum in the JAX package's ConvBN: running statistics
# move to BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch
BN_MOMENTUM = 0.9


class Conv2d_BN(nn.Module):
    """Conv2d without bias, then BatchNorm (eps 1e-5) (reference
    tiny_vit_sam.py Conv2d_BN; keys ``c`` and ``bn``). The convolution
    runs in ``dtype``; the norm computes (x - mean) * (rsqrt(var + eps) *
    weight) + bias in float32 and returns float32, as flax
    ``BatchNorm(dtype=float32)`` does.

    ``train=False`` normalises by the running statistics. ``train=True``
    has flax ``BatchNorm(use_running_average=False)``'s semantics: the
    batch mean and the biased batch variance over (N, H, W), in float32,
    the variance as E[x^2] - E[x]^2 clipped at 0; the new running
    statistics, ``BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch``
    with the biased variance (``nn.BatchNorm2d`` would store the unbiased
    one), are kept in ``pending_stats`` and written into the buffers only
    by ``commit_batch_stats``. A forward that runs again under
    ``torch.utils.checkpoint`` recomputes the same pending values, so the
    statistics move once per step, as flax's mutable ``batch_stats``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.c = nn.Conv2d(in_ch, out_ch, kernel, stride, padding,
                           groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.dtype = dtype
        self.pending_stats = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv2d(x, self.c, self.dtype).to(torch.float32)
        bn = self.bn
        if train:
            mean = y.mean((0, 2, 3))
            var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.pending_stats = (
                    BN_MOMENTUM * bn.running_mean
                    + (1 - BN_MOMENTUM) * mean.detach(),
                    BN_MOMENTUM * bn.running_var
                    + (1 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return ((y - mean[:, None, None]) * mul[:, None, None]
                + bn.bias[:, None, None])


def commit_batch_stats(model: nn.Module) -> int:
    """Write every Conv2d_BN's pending running statistics (from its last
    train-mode forward) into its buffers; returns how many moved."""
    n = 0
    for m in model.modules():
        if isinstance(m, Conv2d_BN) and m.pending_stats is not None:
            mean, var = m.pending_stats
            m.bn.running_mean.copy_(mean)
            m.bn.running_var.copy_(var)
            m.pending_stats = None
            n += 1
    return n
