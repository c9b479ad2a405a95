"""Baseline segmentation/classification nets carried by the reference
(the JAX package's models/baselines.py).

The reference vendors a zoo of baselines from its upstream fork
(finetune-SAM/models/: UNet/TransUNet variants unet/unet_model.py:83-516,
ResNet resnet.py:80, VGG vgg.py:21, EfficientNet efficientnet.py:199,
SEResNet senet.py:110, SqueezeNet squeezenet.py:40, VanillaVAE vae.py:9,
GAN Discriminator discriminator.py:44, TAG tag.py:243, the implicit
critics implicitnet.py:43 and implicitefficientnet.py:113). No pipeline
runs them; they are part of the surface, behind the same ``get_network``
factory (reference utils/utils.py:114). Plain torch modules: convolutions,
products and norms, with no kernel of this repo.

Layout: feature maps are NCHW where the JAX package's are NHWC, token
tensors (B, N, C) in both; each class says what it takes and returns.
Module and parameter names follow the flax names (``down0.conv0``,
``s1b0.bn2``, ``t_attn_0.query``), so
``models/convert.baseline_state_dict_from_flax`` carries a JAX variables
tree across. Where flax infers a layer's input width or a parameter's
size from the first input, the port's constructor takes it:
``in_channels`` (and ``image_size`` where a dense layer or an embedding
depends on it), with the defaults the JAX tests use.

flax's arithmetic, kept here: ``nn.gelu`` is the tanh approximation;
``nn.LayerNorm`` has epsilon 1e-6 and the fast variance
(``common.layer_norm``); ``nn.BatchNorm`` momentum 0.99, epsilon 1e-5,
biased batch variance in train mode, the running statistics committed by
``common.commit_batch_stats`` (``common.BatchNorm2d``); ``padding="SAME"``
(flax's default) pads low = total // 2 and high = the rest, also with a
stride or an even kernel (``SameConv2d``); ``jax.image.resize(...,
"nearest")`` samples half-pixel centres (``nearest-exact``);
``nn.MultiHeadDotProductAttention`` divides the query by sqrt(head dim)
before the product. ``forward(..., train=True)`` normalises by the
batch, as the JAX ``apply(..., train=True, mutable=["batch_stats"])``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm2d, layer_norm


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(F.relu(x), max=6.0)


def _nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "nearest")`` of an NCHW map."""
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class SameConv2d(nn.Conv2d):
    """A Conv2d with flax's ``padding="SAME"``: the output is
    ceil(size / stride) and the padding total // 2 before, the rest
    after, per axis."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, bias: bool = True) -> None:
        super().__init__(in_ch, out_ch, kernel, stride, 0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[2:]),
                              reversed(self.kernel_size),
                              reversed(self.stride)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class _MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout)
    on (B, N, D) tokens: ``query``, ``key``, ``value`` and ``out`` are its
    DenseGeneral projections as (D, D) linear layers."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(hd)
        attn = torch.softmax(q @ heads(self.key(x)).transpose(-1, -2), -1)
        out = (attn @ heads(self.value(x))).transpose(1, 2)
        return self.out(out.reshape(b, n, d))


class DoubleConv(nn.Module):
    """Two (3x3 conv without bias, batch norm, ReLU); NCHW."""

    def __init__(self, features: int, in_features: Optional[int] = None
                 ) -> None:
        super().__init__()
        cin = in_features or features
        for i in range(2):
            self.add_module(f"conv{i}", nn.Conv2d(
                cin if i == 0 else features, features, 3, padding=1,
                bias=False))
            self.add_module(f"bn{i}", BatchNorm2d(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x, train))
        return x


class UNet(nn.Module):
    """Classic encoder/decoder UNet (reference unet/unet_model.py UNet):
    (B, in_channels, H, W) -> (B, num_classes, H, W) logits (the JAX
    package's NHWC in and out)."""

    def __init__(self, num_classes: int = 2, base: int = 64, depth: int = 4,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.depth = depth
        f, cin = base, in_channels
        for d in range(depth):
            self.add_module(f"down{d}", DoubleConv(f, cin))
            cin, f = f, f * 2
        self.bottleneck = DoubleConv(f, cin)
        for d in reversed(range(depth)):
            f //= 2
            self.add_module(f"upconv{d}", SameConv2d(2 * f, f, 2))
            self.add_module(f"up{d}", DoubleConv(f, 2 * f))
        self.head = nn.Conv2d(base, num_classes, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        skips = []
        for d in range(self.depth):
            x = getattr(self, f"down{d}")(x, train)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x, train)
        for d in reversed(range(self.depth)):
            x = _nearest(x, x.shape[2] * 2, x.shape[3] * 2)
            x = getattr(self, f"upconv{d}")(x)
            x = torch.cat([skips[d], x], dim=1)
            x = getattr(self, f"up{d}")(x, train)
        return self.head(x)


class ResBlock(nn.Module):
    """Basic residual block, NCHW; the projection (1x1 conv + batch norm)
    exists where the JAX block's shapes differ: a stride or a change of
    width."""

    def __init__(self, features: int, stride: int = 1,
                 in_features: Optional[int] = None) -> None:
        super().__init__()
        cin = in_features or features
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        if stride != 1 or cin != features:
            self.proj = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.bnp = BatchNorm2d(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "proj"):
            x = self.bnp(self.proj(x), train)
        return F.relu(x + y)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the channels of an NCHW map."""

    def __init__(self, channels: int, reduction: int = 16) -> None:
        super().__init__()
        self.fc1 = nn.Linear(channels, max(1, channels // reduction))
        self.fc2 = nn.Linear(max(1, channels // reduction), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean((2, 3))))
        s = torch.sigmoid(self.fc2(s))
        return x * s[:, :, None, None]


class ResNet(nn.Module):
    """ResNet-18-style classifier (reference resnet.py:80); ``use_se`` the
    SEResNet variant (reference senet.py:110). (B, in_channels, H, W) ->
    (B, num_classes)."""

    def __init__(self, num_classes: int = 2,
                 stages: Sequence[int] = (2, 2, 2, 2), use_se: bool = False,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.stages = tuple(stages)
        self.use_se = use_se
        self.stem = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm2d(64)
        f = cin = 64
        for s, blocks in enumerate(self.stages):
            for i in range(blocks):
                stride = 2 if (s > 0 and i == 0) else 1
                self.add_module(f"s{s}b{i}", ResBlock(f, stride, cin))
                if use_se:
                    self.add_module(f"s{s}se{i}", SEBlock(f))
                cin = f
            f *= 2
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for s, blocks in enumerate(self.stages):
            for i in range(blocks):
                x = getattr(self, f"s{s}b{i}")(x, train)
                if self.use_se:
                    x = getattr(self, f"s{s}se{i}")(x)
        return self.head(x.mean((2, 3)))


class VGG(nn.Module):
    """VGG-11-style classifier (reference vgg.py:21). (B, in_channels, H,
    W) -> (B, num_classes)."""

    def __init__(self, num_classes: int = 2,
                 cfg: Sequence = (64, "M", 128, "M", 256, 256, "M", 512, 512,
                                  "M"),
                 in_channels: int = 3) -> None:
        super().__init__()
        self.cfg = tuple(cfg)
        cin = in_channels
        for i, c in enumerate(self.cfg):
            if c != "M":
                self.add_module(f"conv{i}", nn.Conv2d(cin, c, 3, padding=1))
                cin = c
        self.fc1 = nn.Linear(cin, 512)
        self.head = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i, c in enumerate(self.cfg):
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.fc1(x.mean((2, 3))))
        return self.head(x)


class SqueezeNet(nn.Module):
    """Fire-module classifier (reference squeezenet.py:40). (B,
    in_channels, H, W) -> (B, num_classes). The stem is flax's default
    SAME 3x3 stride-2 convolution."""

    FIRES = (("f1", 16, 64), ("f2", 16, 64), ("f3", 32, 128),
             ("f4", 32, 128))

    def __init__(self, num_classes: int = 2, in_channels: int = 3) -> None:
        super().__init__()
        self.stem = SameConv2d(in_channels, 64, 3, 2)
        cin = 64
        for name, squeeze, expand in self.FIRES:
            self.add_module(f"{name}_s", nn.Conv2d(cin, squeeze, 1))
            self.add_module(f"{name}_e1", nn.Conv2d(squeeze, expand, 1))
            self.add_module(f"{name}_e3", nn.Conv2d(squeeze, expand, 3,
                                                    padding=1))
            cin = 2 * expand
        self.head = nn.Conv2d(cin, num_classes, 1)

    def _fire(self, x: torch.Tensor, name: str) -> torch.Tensor:
        s = F.relu(getattr(self, f"{name}_s")(x))
        e1 = F.relu(getattr(self, f"{name}_e1")(s))
        e3 = F.relu(getattr(self, f"{name}_e3")(s))
        return torch.cat([e1, e3], dim=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.stem(x))
        x = F.max_pool2d(x, 3, 2)
        x = self._fire(x, "f1")
        x = self._fire(x, "f2")
        x = F.max_pool2d(x, 3, 2)
        x = self._fire(x, "f3")
        x = self._fire(x, "f4")
        return self.head(x).mean((2, 3))


def _build_mbconv(owner: nn.Module, in_channels: int,
                  widths: Sequence[int]) -> None:
    """The EfficientNet trunk of EfficientNetLite and
    ImplicitEfficientNet, registered on ``owner`` under the flax names: a
    3x3 stride-2 stem (batch norm, swish), then per width an inverted
    bottleneck (1x1 expand x4, 3x3 stride-2 depthwise, squeeze-excite,
    1x1 project, batch norm)."""
    owner.stem = nn.Conv2d(in_channels, 32, 3, 2, 1, bias=False)
    owner.stem_bn = BatchNorm2d(32)
    cin = 32
    for i, wdt in enumerate(widths):
        hidden = cin * 4
        owner.add_module(f"m{i}_expand", nn.Conv2d(cin, hidden, 1,
                                                   bias=False))
        owner.add_module(f"m{i}_bn1", BatchNorm2d(hidden))
        owner.add_module(f"m{i}_dw", nn.Conv2d(
            hidden, hidden, 3, 2, 1, groups=hidden, bias=False))
        owner.add_module(f"m{i}_bn2", BatchNorm2d(hidden))
        owner.add_module(f"m{i}_se", SEBlock(hidden, reduction=4))
        owner.add_module(f"m{i}_proj", nn.Conv2d(hidden, wdt, 1, bias=False))
        owner.add_module(f"m{i}_bn3", BatchNorm2d(wdt))
        cin = wdt


def _run_mbconv(owner: nn.Module, x: torch.Tensor, n: int, train: bool
                ) -> torch.Tensor:
    x = F.silu(owner.stem_bn(owner.stem(x), train))
    for i in range(n):
        def m(name):
            return getattr(owner, f"m{i}_{name}")

        y = F.silu(m("bn1")(m("expand")(x), train))
        y = F.silu(m("bn2")(m("dw")(y), train))
        y = m("se")(y)
        x = m("bn3")(m("proj")(y), train)
    return x


class EfficientNetLite(nn.Module):
    """MBConv classifier in the EfficientNet family
    (reference efficientnet.py:199). (B, in_channels, H, W) -> (B,
    num_classes)."""

    def __init__(self, num_classes: int = 2,
                 widths: Sequence[int] = (16, 24, 40, 80),
                 in_channels: int = 3) -> None:
        super().__init__()
        self.widths = tuple(widths)
        _build_mbconv(self, in_channels, self.widths)
        self.head = nn.Linear(self.widths[-1], num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _run_mbconv(self, x, len(self.widths), train)
        return self.head(x.mean((2, 3)))


class VanillaVAE(nn.Module):
    """Conv VAE (reference vae.py:9) on square (B, in_channels,
    image_size, image_size) images -> (recon (B, in_channels, S, S), mu,
    logvar), the JAX package's order.

    The reparametrisation draw is explicit: ``eps`` (B, latent_dim), or a
    standard normal draw from ``generator``; with neither, z = mu (the JAX
    call without ``rng``). The flattened encoder map feeds ``mu`` and
    ``logvar`` in the JAX package's NHWC order, and ``dec_in``'s output is
    read back as NHWC: the forward permutes around both, so the dense
    layers keep the flax kernels' row order."""

    def __init__(self, latent_dim: int = 128,
                 hidden: Sequence[int] = (32, 64, 128, 256),
                 in_channels: int = 3, image_size: int = 64) -> None:
        super().__init__()
        self.hidden = tuple(hidden)
        cin, hw = in_channels, image_size
        for i, c in enumerate(self.hidden):
            self.add_module(f"enc{i}", nn.Conv2d(cin, c, 3, 2, 1))
            cin, hw = c, (hw - 1) // 2 + 1
        self.enc_hw = hw
        flat = hw * hw * self.hidden[-1]
        self.mu = nn.Linear(flat, latent_dim)
        self.logvar = nn.Linear(flat, latent_dim)
        self.dec_in = nn.Linear(latent_dim, flat)
        for i, c in enumerate(reversed(self.hidden[:-1])):
            self.add_module(f"dec{i}", nn.Conv2d(cin, c, 3, padding=1))
            cin = c
        self.dec_out = nn.Conv2d(cin, in_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False):
        b, in_hw = x.shape[0], x.shape[2]
        h = x
        for i in range(len(self.hidden)):
            h = F.leaky_relu(getattr(self, f"enc{i}")(h), 0.01)
        e = h.shape[2]
        flat = h.permute(0, 2, 3, 1).reshape(b, -1)
        mu, logvar = self.mu(flat), self.logvar(flat)
        if eps is None and generator is not None:
            eps = torch.randn(mu.shape, generator=generator,
                              device=generator.device).to(mu.device)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        h = self.dec_in(z).reshape(b, e, e, self.hidden[-1])
        h = h.permute(0, 3, 1, 2)
        for i in range(len(self.hidden) - 1):
            h = _nearest(h, h.shape[2] * 2, h.shape[3] * 2)
            h = F.leaky_relu(getattr(self, f"dec{i}")(h), 0.01)
        h = _nearest(h, in_hw, in_hw)
        return torch.tanh(self.dec_out(h)), mu, logvar


class Discriminator(nn.Module):
    """PatchGAN-style discriminator (reference discriminator.py:44):
    (B, in_channels, H, W) -> (B, 1, H/16, W/16) scores. Its head is a
    flax SAME 4x4 convolution (one row and column of padding before, two
    after)."""

    def __init__(self, base: int = 64, in_channels: int = 3) -> None:
        super().__init__()
        f, cin = base, in_channels
        for i in range(4):
            self.add_module(f"d{i}", nn.Conv2d(cin, f, 4, 2, 1))
            cin, f = f, f * 2
        self.head = SameConv2d(cin, 1, 4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"d{i}")(x), 0.2)
        return self.head(x)


def get_network(name: str, num_classes: int = 2, **kw):
    """Factory matching the reference's get_network dispatch
    (utils/utils.py:114)."""
    table = {
        "unet": lambda: UNet(num_classes=num_classes, **kw),
        "transunet": lambda: TransUNet(num_classes=num_classes, **kw),
        "munet": lambda: MUNet(num_classes=num_classes, **kw),
        "goinnet": lambda: GoinNet(num_classes=num_classes, **kw),
        "vit": lambda: ViTEncoder(**kw),
        "resnet": lambda: ResNet(num_classes=num_classes, **kw),
        "seresnet": lambda: ResNet(num_classes=num_classes, use_se=True, **kw),
        "vgg": lambda: VGG(num_classes=num_classes, **kw),
        "squeezenet": lambda: SqueezeNet(num_classes=num_classes, **kw),
        "efficientnet": lambda: EfficientNetLite(num_classes=num_classes, **kw),
        "vae": lambda: VanillaVAE(**kw),
        "discriminator": lambda: Discriminator(**kw),
        "tag": lambda: TAG(num_classes=num_classes, **kw),
        # implicit critics take (seg, label, natural) — see class docs
        "implicitnet": lambda: ImplicitNet(**kw),
        "implicitefficientnet": lambda: ImplicitEfficientNet(**kw),
    }
    if name not in table:
        raise ValueError(f"unknown network {name!r}; choose from {sorted(table)}")
    return table[name]()


def _build_block(owner: nn.Module, pre: str, i: int, dim: int, heads: int,
                 hidden: int) -> None:
    """A pre-norm transformer block on (B, N, D) tokens (ln1, attn, ln2,
    fc1, gelu, fc2), the body of ViTEncoder, SmallDecoder and TransUNet's
    bottleneck, registered on ``owner`` under the flax names
    ``{pre}ln1_{i}`` ..."""
    owner.add_module(f"{pre}ln1_{i}", _ln(dim))
    owner.add_module(f"{pre}attn_{i}", _MultiHeadAttention(dim, heads))
    owner.add_module(f"{pre}ln2_{i}", _ln(dim))
    owner.add_module(f"{pre}fc1_{i}", nn.Linear(dim, hidden))
    owner.add_module(f"{pre}fc2_{i}", nn.Linear(hidden, dim))


def _run_block(owner: nn.Module, pre: str, i: int, t: torch.Tensor
               ) -> torch.Tensor:
    def m(name):
        return getattr(owner, f"{pre}{name}_{i}")

    t = t + m("attn")(layer_norm(t, m("ln1")))
    return t + m("fc2")(_gelu(m("fc1")(layer_norm(t, m("ln2")))))


class ViTEncoder(nn.Module):
    """Small generic ViT (reference models/sam/modeling/vit.py:19-135:
    patch embedding + standard pre-norm transformer encoder). Used by
    SmallDecoder and standalone as a classifier backbone. (B, in_channels,
    image_size, image_size) -> (B, dim, image_size / patch, image_size /
    patch) (the JAX package's (B, h, w, dim)); ``pos_embed`` holds one
    row per patch of ``image_size``."""

    def __init__(self, dim: int = 256, depth: int = 4, heads: int = 8,
                 patch: int = 8, mlp_ratio: float = 4.0,
                 in_channels: int = 3, image_size: int = 256) -> None:
        super().__init__()
        self.depth = depth
        self.patch_embed = SameConv2d(in_channels, dim, patch, patch)
        grid = -(-image_size // patch)
        self.pos_embed = nn.Parameter(
            torch.randn(1, grid * grid, dim) * 0.02)
        for i in range(depth):
            _build_block(self, "", i, dim, heads, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.patch_embed(x)
        b, d, hh, ww = x.shape
        tokens = x.flatten(2).transpose(1, 2) + self.pos_embed
        for i in range(self.depth):
            tokens = _run_block(self, "", i, tokens)
        return tokens.transpose(1, 2).reshape(b, d, hh, ww)


class SmallDecoder(nn.Module):
    """Segmenter-style mask decoder alternative (reference
    models/sam/modeling/mask_decoder.py SmallDecoder:18-102): class tokens
    attend over image tokens through a small transformer; masks come from
    token/patch dot products. (B, in_dim, h, w) embeddings (the JAX
    package's (B, h, w, in_dim)) -> (B, num_classes, h, w); ``proj_in``
    exists where ``in_dim`` (``dim`` by default) differs from ``dim``."""

    def __init__(self, num_classes: int = 2, dim: int = 256, depth: int = 2,
                 heads: int = 8, in_dim: Optional[int] = None) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.depth = depth
        if in_dim is not None and in_dim != dim:
            self.proj_in = nn.Linear(in_dim, dim)
        self.cls_tokens = nn.Parameter(torch.randn(num_classes, dim) * 0.02)
        for i in range(depth):
            _build_block(self, "", i, dim, heads, dim * 4)

    def forward(self, image_embeddings: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        b, c, h, w = image_embeddings.shape
        tokens = image_embeddings.flatten(2).transpose(1, 2)
        if hasattr(self, "proj_in"):
            tokens = self.proj_in(tokens)
        cls = self.cls_tokens[None].expand(b, -1, -1)
        seq = torch.cat([cls, tokens], dim=1)
        for i in range(self.depth):
            seq = _run_block(self, "", i, seq)
        cls_out = seq[:, :self.num_classes]
        patch_out = seq[:, self.num_classes:]
        masks = torch.einsum("bkd,bnd->bkn", cls_out, patch_out)
        return masks.reshape(b, self.num_classes, h, w)


class _ResNetEncoder(nn.Module):
    """Shared ResNet-34-style encoder with skip taps (the backbone the
    reference's TransUNet/MUNet/GoinNet wrap, unet/unet_model.py:83-516):
    NCHW -> (bottom, [stem, stage 0, ..., stage 3] maps)."""

    def __init__(self, stages: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 3) -> None:
        super().__init__()
        self.stages = tuple(stages)
        self.stem = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm2d(64)
        f = cin = 64
        for s, blocks in enumerate(self.stages):
            for i in range(blocks):
                stride = 2 if (s > 0 and i == 0) else 1
                self.add_module(f"s{s}b{i}", ResBlock(f, stride, cin))
                cin = f
            f *= 2
        self.out_channels = cin

    def forward(self, x: torch.Tensor, train: bool = False):
        x = F.relu(self.stem_bn(self.stem(x), train))
        skips = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for s, blocks in enumerate(self.stages):
            for i in range(blocks):
                x = getattr(self, f"s{s}b{i}")(x, train)
            skips.append(x)
        return x, skips


class TransUNet(nn.Module):
    """ResNet-encoder UNet with a transformer bottleneck
    (reference unet/unet_model.py TransUNet:83): (B, in_channels, H, W)
    -> (B, num_classes, H, W) logits."""

    def __init__(self, num_classes: int = 2, trans_depth: int = 2,
                 trans_heads: int = 8, in_channels: int = 3) -> None:
        super().__init__()
        self.trans_depth = trans_depth
        self.encoder = _ResNetEncoder(in_channels=in_channels)
        c = self.encoder.out_channels
        for i in range(trans_depth):
            _build_block(self, "t_", i, c, trans_heads, c * 2)
        # the skip widths, deepest first: stages 2, 1, 0 and the stem
        skip_ch = (256, 128, 64, 64)
        cin = c
        for d, sc in enumerate(skip_ch):
            self.add_module(f"up{d}", nn.Conv2d(cin, sc, 3, padding=1))
            self.add_module(f"fuse{d}", nn.Conv2d(2 * sc, sc, 3, padding=1))
            cin = sc
        self.head = nn.Conv2d(cin, num_classes, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        bottom, skips = self.encoder(x, train)
        b, c, h, w = bottom.shape
        tokens = bottom.flatten(2).transpose(1, 2)
        for i in range(self.trans_depth):
            tokens = _run_block(self, "t_", i, tokens)
        x = tokens.transpose(1, 2).reshape(b, c, h, w)
        for d, skip in enumerate(reversed(skips[:-1])):
            x = _nearest(x, skip.shape[2], skip.shape[3])
            x = F.relu(getattr(self, f"up{d}")(x))
            x = torch.cat([x, skip], dim=1)
            x = F.relu(getattr(self, f"fuse{d}")(x))
        x = _nearest(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.head(x)


class MUNet(nn.Module):
    """ResNet-encoder UNet (no transformer bottleneck) — the reference's
    MUNet variant (unet/unet_model.py:274); NCHW as TransUNet."""

    def __init__(self, num_classes: int = 2, in_channels: int = 3) -> None:
        super().__init__()
        self.core = TransUNet(num_classes=num_classes, trans_depth=0,
                              in_channels=in_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.core(x, train)


class GoinNet(nn.Module):
    """ResNet-UNet emitting segmentation plus an auxiliary global
    classification head (reference unet/unet_model.py GoinNet:427):
    (B, in_channels, H, W) -> (seg (B, num_classes, H, W), aux (B,
    num_classes)), the JAX package's order."""

    def __init__(self, num_classes: int = 2, in_channels: int = 3) -> None:
        super().__init__()
        self.encoder = _ResNetEncoder(in_channels=in_channels)
        self.seg = TransUNet(num_classes=num_classes, trans_depth=1,
                             in_channels=in_channels)
        self.aux_head = nn.Linear(self.encoder.out_channels, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        bottom, _ = self.encoder(x, train)
        seg = self.seg(x, train)
        return seg, self.aux_head(bottom.mean((2, 3)))


# ---------------------------------------------------------------------------
# TAG part-token transformer + implicit realism nets (the last three
# reference baselines: models/tag/tag.py:243 + tag_layers.py,
# implicitnet.py:43, implicitefficientnet.py:113)
# ---------------------------------------------------------------------------


class _AnyAttention(nn.Module):
    """Cross/self attention over arbitrary token sets with optional
    additive per-head positional terms (reference tag_layers.py
    AnyAttention:75 + apply_pos:11): q/k/v each layer-normed then
    linearly projected, per-head dot-product attention (scaled after the
    product), output proj. Tokens (B, N, dim)."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.norm_q, self.norm_k, self.norm_v = _ln(dim), _ln(dim), _ln(dim)
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, qpos=None, kpos=None) -> torch.Tensor:
        hd = self.dim // self.num_heads

        def add_pos(t, pos):
            # pos (N, 1, hd) broadcasts over batch and heads
            b, n, _ = t.shape
            th = t.reshape(b, n, self.num_heads, hd) + pos[None]
            return th.reshape(b, n, self.dim)

        if qpos is not None:
            q = add_pos(q, qpos)
        if kpos is not None:
            k = add_pos(k, kpos)
        q = self.to_q(layer_norm(q, self.norm_q))
        k = self.to_k(layer_norm(k, self.norm_k))
        v = self.to_v(layer_norm(v, self.norm_v))
        b = q.shape[0]
        qh = q.reshape(b, -1, self.num_heads, hd)
        kh = k.reshape(b, -1, self.num_heads, hd)
        vh = v.reshape(b, -1, self.num_heads, hd)
        attn = torch.einsum("bqgc,bkgc->bqgk", qh, kh) * (hd ** -0.5)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bqgk,bkgc->bqgc", attn, vh).reshape(
            b, -1, self.dim)
        return self.proj(out)


class _SimpleReasoning(nn.Module):
    """Residual token-mixing over the part axis (tag_layers.py:63) on
    (B, P, dim) parts."""

    def __init__(self, num_parts: int, dim: int) -> None:
        super().__init__()
        self.norm = _ln(dim)
        self.mix = nn.Parameter(torch.randn(num_parts, num_parts)
                                / math.sqrt(num_parts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = layer_norm(x, self.norm)
        # 1x1 Conv1d over the token axis == dense mixing of parts
        return x + torch.einsum("pq,bqc->bpc", self.mix, t)


class _TagMlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu(self.fc1(layer_norm(x, self.norm))))


class TAGStage(nn.Module):
    """One TAG stage (reference tag.py Stage:133): depthwise-conv patch
    embedding of the feature map, part tokens projected to the stage
    width, then decoder blocks broadcasting part information back into
    the features (x cross-attends the parts; reference tag.py
    Decoder:73 — the stage-level Encoder and patch-local attention are
    commented out in the reference and therefore omitted). The final
    stage can instead pool INTO the parts (last_enc: Encoder:44 with
    SimpleReasoning) for classification.

    Divergence note (the JAX package's, kept): the reference's
    ``to_part`` pushes the (B, N, C) part tokens through a Conv2d patch
    embed, which cannot run on a 3-D tensor — dead-as-shipped upstream
    code. The intended projection (its commented-out ``proj_token``:
    token mix + Linear + Norm) is what this implements.

    (x (B, in_ch, H, W), parts (B, P, part_ch)) -> (x (B, out_ch, H',
    W'), parts (B, P, out_ch)), or (parts, parts) with ``last_enc``.
    ``rpn_kpos`` is a parameter the JAX stage declares and never reads;
    it is kept so the variables carry across."""

    def __init__(self, out_ch: int, num_blocks: int, num_heads: int,
                 num_enc_heads: int, stride: int, num_parts: int,
                 ffn_exp: int = 3, last_enc: bool = False, in_ch: int = 64,
                 part_ch: int = 64) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.last_enc = last_enc
        hd = out_ch // num_heads
        self.to_token = nn.Conv2d(in_ch, in_ch, 3, stride, 1, groups=in_ch)
        self.proj_x = nn.Linear(in_ch, out_ch, bias=False)
        self.proj_norm = _ln(out_ch)
        self.proj_token = nn.Linear(part_ch, out_ch, bias=False)
        self.part_norm = _ln(out_ch)
        self.rpn_qpos = nn.Parameter(torch.randn(num_parts, 1, hd) * 0.02)
        self.rpn_kpos = nn.Parameter(torch.randn(num_parts, 1, hd) * 0.02)
        for i in range(num_blocks):
            self.add_module(f"blk{i}_attn", _AnyAttention(out_ch, num_heads))
            self.add_module(f"blk{i}_ffn", _TagMlp(out_ch, out_ch * ffn_exp))
        if last_enc:
            self.last_enc_attn = _AnyAttention(out_ch, num_enc_heads)
            self.last_enc_reason = _SimpleReasoning(num_parts, out_ch)

    def forward(self, x: torch.Tensor, parts: torch.Tensor):
        x = self.to_token(x)
        b, c, nh, nw = x.shape
        x = layer_norm(self.proj_x(x.flatten(2).transpose(1, 2)),
                       self.proj_norm)
        parts = layer_norm(self.proj_token(parts), self.part_norm)
        for i in range(self.num_blocks):
            x = x + getattr(self, f"blk{i}_attn")(
                q=x, k=parts, v=parts, qpos=None, kpos=self.rpn_qpos)
            x = x + getattr(self, f"blk{i}_ffn")(x)
        if self.last_enc:
            parts = parts + self.last_enc_attn(q=parts, k=x, v=x,
                                               qpos=self.rpn_qpos, kpos=None)
            parts = self.last_enc_reason(parts)
            return parts, parts
        return x.transpose(1, 2).reshape(b, -1, nh, nw), parts


class TAG(nn.Module):
    """TAG part-token classifier (reference models/tag/tag.py:243,
    TAG_tiny config tag.py:387: stem 7x7/2 + maxpool/2, four stages with
    learned part tokens, last-stage encoder pooling into the parts, mean
    over parts -> fc head). (B, in_channels, H, W) -> (B, num_classes)."""

    def __init__(self, num_classes: int = 1000, inplanes: int = 64,
                 num_chs: Sequence[int] = (64, 128, 256, 512),
                 num_layers: Sequence[int] = (1, 1, 2, 1),
                 num_strides: Sequence[int] = (1, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 num_enc_heads: Sequence[int] = (1, 2, 4, 8),
                 num_parts: Sequence[int] = (32, 32, 32, 32),
                 has_last_encoder: bool = True, in_channels: int = 3) -> None:
        super().__init__()
        self.n_stages = len(num_layers)
        self.has_last_encoder = has_last_encoder
        self.conv1 = nn.Conv2d(in_channels, inplanes, 7, 2, 3, bias=False)
        self.norm1 = BatchNorm2d(inplanes)
        self.rpn_tokens = nn.Parameter(
            torch.randn(1, num_parts[0], inplanes) * 0.02)
        cin = inplanes
        for i in range(self.n_stages):
            self.add_module(f"layer_{i}", TAGStage(
                out_ch=num_chs[i], num_blocks=num_layers[i],
                num_heads=num_heads[i], num_enc_heads=num_enc_heads[i],
                stride=num_strides[i], num_parts=num_parts[i],
                last_enc=has_last_encoder and i == self.n_stages - 1,
                in_ch=cin, part_ch=cin))
            cin = num_chs[i]
        if not has_last_encoder:
            self.last_linear = nn.Conv2d(cin, cin, 1, bias=False)
            self.last_norm = BatchNorm2d(cin)
        self.last_fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b = x.shape[0]
        x = _gelu(self.norm1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        parts = self.rpn_tokens.expand(b, -1, -1)
        for i in range(self.n_stages):
            x, parts = getattr(self, f"layer_{i}")(x, parts)
        if self.has_last_encoder:
            out = _gelu(x).mean(1)
        else:
            x = self.last_norm(self.last_linear(x), train)
            out = _gelu(x).mean((2, 3))
        return self.last_fc(out)


class _LinearBottleneck(nn.Module):
    """MobileNetV2-style inverted residual (reference implicitnet.py
    LinearBottleNeck:10), NCHW."""

    def __init__(self, out_ch: int, stride: int, t: int = 6,
                 in_ch: int = 32) -> None:
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        hidden = in_ch * t
        self.expand = nn.Conv2d(in_ch, hidden, 1)
        self.bn1 = BatchNorm2d(hidden)
        self.dw = nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden)
        self.bn2 = BatchNorm2d(hidden)
        self.proj = nn.Conv2d(hidden, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _relu6(self.bn1(self.expand(x), train))
        h = _relu6(self.bn2(self.dw(h), train))
        h = self.bn3(self.proj(h), train)
        return h + x if self.residual else h


def _critic_input(seg, label, natural) -> torch.Tensor:
    """(label broadcast, natural, seg) stacked on the channel axis."""
    b, _, h, w = seg.shape
    lab = label.reshape(b, 1, 1, 1).expand(b, 1, h, w).to(seg.dtype)
    return torch.cat([lab, natural, seg], dim=1)


class ImplicitNet(nn.Module):
    """Implicit per-pixel realism critic (reference implicitnet.py:43):
    concatenates a broadcast class label (B,), the natural image (B, 3,
    H, W) and the segmentation (B, 1, H, W) into a 5-channel input, runs a
    MobileNetV2-style trunk and emits a sigmoid map (B, 1, H', W'). The
    reference's ``pre`` conv is a 1x1 with padding=1 (implicitnet.py:48):
    64 px grow to 66 before the three stride-2 stages, giving 9x9 —
    quirk preserved."""

    CFG = (  # (repeat, out_ch, stride, t) — implicitnet.py:53-60
        (1, 16, 1, 1), (2, 24, 2, 6), (3, 32, 2, 6), (4, 64, 2, 6),
        (3, 96, 1, 6), (3, 160, 1, 6), (1, 320, 1, 6))

    def __init__(self, in_channels: int = 5) -> None:
        super().__init__()
        self.pre = nn.Conv2d(in_channels, 32, 1, padding=1)
        self.pre_bn = BatchNorm2d(32)
        cin = 32
        for si, (rep, ch, stride, t) in enumerate(self.CFG):
            for r in range(rep):
                self.add_module(f"s{si}_b{r}", _LinearBottleneck(
                    ch, stride if r == 0 else 1, t, cin))
                cin = ch
        self.conv1 = nn.Conv2d(cin, 1280, 1)
        self.conv1_bn = BatchNorm2d(1280)
        self.conv2 = nn.Conv2d(1280, 1, 1)

    def forward(self, seg, label, natural, train: bool = False):
        x = _critic_input(seg, label, natural)
        x = _relu6(self.pre_bn(self.pre(x), train))
        for si, (rep, _, _, _) in enumerate(self.CFG):
            for r in range(rep):
                x = getattr(self, f"s{si}_b{r}")(x, train)
        x = _relu6(self.conv1_bn(self.conv1(x), train))
        return torch.sigmoid(self.conv2(x))


class ImplicitEfficientNet(nn.Module):
    """EfficientNet-trunk implicit critic (reference
    implicitefficientnet.py:113): 5-channel stem over (label, natural,
    seg) as ImplicitNet takes them, MBConv trunk, head selected by
    ``head_type`` — 'map' (sigmoid realism map (B, 1, h, w)), 'img'
    (3-channel reconstruction (B, 3, 4h, 4w)), or 'feature' (gram matrix
    (B, C, C) of centered features for a style-type loss). Only the
    chosen head's layers exist, as in flax."""

    def __init__(self, head_type: str = "map",
                 widths: Sequence[int] = (16, 24, 40, 80),
                 in_channels: int = 5) -> None:
        super().__init__()
        self.head_type = head_type
        self.widths = tuple(widths)
        _build_mbconv(self, in_channels, self.widths)
        cin = self.widths[-1]
        if head_type == "img":
            for i, ch in enumerate((448, 112)):
                self.add_module(f"up{i}", nn.Conv2d(cin, ch, 3, padding=1))
                self.add_module(f"up{i}_bn", BatchNorm2d(ch))
                cin = ch
            self.head_img = nn.Conv2d(cin, 3, 1)
        elif head_type != "feature":
            self.head_map = nn.Conv2d(cin, 1, 1)

    def forward(self, seg, label, natural, train: bool = False):
        x = _critic_input(seg, label, natural)
        x = _run_mbconv(self, x, len(self.widths), train)
        if self.head_type == "feature":
            f = x.flatten(2).transpose(1, 2)
            f = f - f.mean(1, keepdim=True)
            return torch.einsum("bnc,bnd->bcd", f, f) / f.shape[1]
        if self.head_type == "img":
            for i in range(2):
                x = _nearest(x, x.shape[2] * 2, x.shape[3] * 2)
                x = getattr(self, f"up{i}")(x)
                x = getattr(self, f"up{i}_bn")(F.relu(x), train)
            return torch.sigmoid(self.head_img(x))
        return torch.sigmoid(self.head_map(x))
