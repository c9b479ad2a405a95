"""ViT-Det image encoder of SAM vit_b / vit_l / vit_h: the JAX package's
models/image_encoder.py as torch modules, with the reference torch
state-dict keys (image_encoder.py: ``patch_embed.proj``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,attn.rel_pos_h,attn.rel_pos_w,
norm2,mlp.lin1,mlp.lin2}``, ``neck.{0..3}``, and the PEFT adapters
``Space_Adapter``, ``MLP_Adapter`` and ``Depth_Adapter``).

16x16 patch embedding, an absolute position embedding, transformer
blocks with windowed attention (window 14) except at the global-attention
indexes, the decomposed relative position bias, and the 256-wide neck.
Tokens are (B, H, W, C) between blocks. The cast points follow the JAX
package (models/common.py): a dense layer or a convolution computes in
``dtype``; the position embedding, the relative-position tables and the
norms are float32, so the residual stream is float32 from the position
embedding on, as in flax's type promotion.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops import attention_kernels, norm_kernels
from ..utils.tracing import trace_stage
from .common import Adapter, LayerNorm2d, MLPBlock, conv2d, layer_norm, linear
from .tinyvit import window_partition, window_unpartition


def rel_pos_embed(rel_pos: torch.Tensor, q_size: int, k_size: int
                  ) -> torch.Tensor:
    """The relative position embeddings of a q/k size pair, (q_size,
    k_size, head_dim), the table linearly resized first where its length
    is not 2 * max(q_size, k_size) - 1.

    The resize is the JAX package's arithmetic written out (torch
    ``F.interpolate(mode="linear")``'s: half-pixel centres, no
    antialiasing, positions clipped to the table, floor and the next
    index), not a call of ``interpolate``."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    n = rel_pos.shape[0]
    if n != max_rel_dist:
        dev = rel_pos.device
        pos = torch.clamp((torch.arange(max_rel_dist, device=dev,
                                        dtype=torch.float32) + 0.5)
                          * (n / max_rel_dist) - 0.5, 0.0, n - 1.0)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.clamp(lo + 1, max=n - 1)
        frac = (pos - lo)[:, None]
        rel_pos = rel_pos[lo] * (1.0 - frac) + rel_pos[hi] * frac
    # the indexes are made where the table lies: a copy from the host would
    # wait for the card at every call
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] \
        * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] \
        * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64)]


class RelPosAttention(nn.Module):
    """Multi-head attention with the decomposed relative position bias, on
    (B, H, W, C). The scores and the weighted sum accumulate in float32
    (the JAX package's ``preferred_element_type``); the bias is float32
    (its tables are); the softmax runs in float32 and is cast to
    ``dtype``. ``input_size`` sets the tables' lengths (2 * size - 1).
    With ``span_attrs`` the attention itself, from q, k and v to the
    weighted sum (not the two projections), runs as one ``global_attn``
    span with those attributes (utils/tracing).

    Where ``takes_kernel`` holds (a bfloat16 module on a card, no
    gradient asked for) the attention is one launch of
    ``csrc/relpos_attention.cu`` (ops/attention_kernels); elsewhere the
    plain version, ``_attend``."""

    def __init__(self, dim: int, num_heads: int,
                 input_size: Tuple[int, int] = (14, 14),
                 use_rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * input_size[0] - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * input_size[1] - 1, self.head_dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                span_attrs: Optional[dict] = None) -> torch.Tensor:
        b, h, w, dim = x.shape
        heads, hd = self.num_heads, self.head_dim
        qkv = linear(x, self.qkv, self.dtype).reshape(b, h * w, 3, heads, hd)
        with (contextlib.nullcontext() if span_attrs is None
              else trace_stage("global_attn", **span_attrs)):
            if self.takes_kernel(qkv):
                out = self._attend_kernel(qkv, h, w)
            else:
                q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, heads, N, hd)
                out = self._attend(q, k, v, h, w).transpose(1, 2)
        out = out.to(self.dtype).reshape(b, h, w, dim)
        return linear(out, self.proj, self.dtype)

    def takes_kernel(self, qkv: torch.Tensor) -> bool:
        """Whether the attention of ``qkv`` runs in the kernel: a tensor on
        a card, a bfloat16 module (the kernel would lower a float32
        module's precision) and no gradient to record (the kernel has no
        backward). A CPU tensor, a float32 module and a call that needs
        gradients (fine-tuning, LoRA) take the plain version."""
        if qkv.device.type != "cuda" or self.dtype != torch.bfloat16:
            return False
        return not (torch.is_grad_enabled() and (
            qkv.requires_grad
            or any(p.requires_grad for p in self.parameters(recurse=False))))

    def _bias_terms(self, q: torch.Tensor, h: int, w: int):
        """The two float32 bias projections of the (B, N, heads, hd)
        queries on the h x w grid, q . rel_h and q . rel_w over hd (the JAX
        package's einsums "byhwc,hkc->byhwk" and "byhwc,wkc->byhwk"), each
        as one batched product over the grid axis its table depends on. One
        float32 copy of the queries, laid out (w, B, heads, h, hd), is both
        products' operand by strides: its grid rows are a batch of (w B
        heads, hd) matrices, its grid columns one of (B heads h, hd)
        matrices. Returns (B, heads, h, w, h) and (B, heads, h, w, w)
        views, which the kernel reads by strides."""
        b, _, heads, hd = q.shape
        rh = rel_pos_embed(self.rel_pos_h, h, h)  # (h, h, hd)
        rw = rel_pos_embed(self.rel_pos_w, w, w)  # (w, w, hd)
        by_col = q.reshape(b, h, w, heads, hd).permute(2, 0, 3, 1, 4)
        qf = torch.empty(by_col.shape, dtype=torch.float32, device=q.device)
        qf.copy_(by_col)
        by_row = qf.permute(3, 0, 1, 2, 4).reshape(h, w * b * heads, hd)
        bias_h = torch.bmm(by_row, rh.transpose(1, 2))
        bias_w = torch.bmm(qf.view(w, b * heads * h, hd), rw.transpose(1, 2))
        return (bias_h.view(h, w, b, heads, h).permute(2, 3, 0, 1, 4),
                bias_w.view(w, b, heads, h, w).permute(1, 2, 3, 0, 4))

    def _attend_kernel(self, qkv: torch.Tensor, h: int, w: int
                       ) -> torch.Tensor:
        """(B, N, 3, heads, hd) bfloat16 qkv on a card -> the bfloat16
        (B, N, heads, hd) weighted sum, in ``csrc/relpos_attention.cu``."""
        if not self.use_rel_pos:
            raise ValueError("the attention kernel takes the relative "
                             "position bias; this module has none")
        bias_h, bias_w = self._bias_terms(qkv[:, :, 0], h, w)
        return attention_kernels.rel_pos_attention(
            qkv, bias_h, bias_w, h, w, self.head_dim ** -0.5)

    def _attend(self, q, k, v, h: int, w: int) -> torch.Tensor:
        """(B, heads, N, hd) q, k, v -> the float32 weighted sum: the plain
        version of the kernel."""
        b, heads, _, hd = q.shape
        qf = q.to(torch.float32)
        attn = torch.matmul(qf, k.to(torch.float32).transpose(-2, -1)) \
            * (hd ** -0.5)
        if self.use_rel_pos:
            rh = rel_pos_embed(self.rel_pos_h, h, h)  # (h, h, hd)
            rw = rel_pos_embed(self.rel_pos_w, w, w)  # (w, w, hd)
            qr = qf.reshape(b, heads, h, w, hd)
            bias_h = torch.einsum("byhwc,hkc->byhwk", qr, rh)
            bias_w = torch.einsum("byhwc,wkc->byhwk", qr, rw)
            bias = bias_h[..., :, None] + bias_w[..., None, :]
            attn = attn + bias.reshape(b, heads, h * w, h * w)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        return torch.matmul(attn.to(torch.float32), v.to(torch.float32))


def closest_factors(n: int) -> Tuple[int, int]:
    """The factor pair (a, b), a <= b, a * b == n, closest to sqrt(n): the
    grid of the thd branch's depth attention (the JAX package's choice,
    which differs from the reference's ``closest_numbers``: (2, 2) for 4
    where the reference gives (1, 4))."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def residual_norm_plain(x: torch.Tensor, norm: nn.LayerNorm, window: int,
                        branch: Optional[torch.Tensor] = None):
    """The plain version of ``ops/norm_kernels.residual_norm``, in
    ``Block.forward``'s own sequence: without ``branch``, ``layer_norm`` of
    the (B, H, W, C) stream ``x``, partitioned into (B nh nw, ws, ws, C)
    windows (``window`` > 0; the pad zero) and cast to bfloat16; with
    ``branch`` (that layout, or (B, H, W, C)), cropped back to the grid,
    (x + branch, ``layer_norm`` of it cast to bfloat16)."""
    b, h, w, c = x.shape
    if branch is None:
        x = layer_norm(x, norm)
        if window > 0:
            x = window_partition(x, window)[0].reshape(-1, window, window, c)
        return x.to(torch.bfloat16)
    if window > 0:
        ph, pw = -(-h // window) * window, -(-w // window) * window
        branch = window_unpartition(branch.reshape(-1, window * window, c),
                                    window, b, h, w,
                                    (ph, pw, ph // window, pw // window))
    x = x + branch
    return x, layer_norm(x, norm).to(torch.bfloat16)


class Block(nn.Module):
    """Pre-norm transformer block on (B, H, W, C): windowed attention
    (``window_size`` > 0, the map zero-padded to whole windows) or global
    attention (0), then the MLP. With ``use_adapter`` the attention's
    output goes through ``Space_Adapter`` (with its skip) and half of
    ``MLP_Adapter`` (no skip) of the MLP's input joins its sum.

    ``thd`` (the 3D branch, reference image_encoder.py:211-231 as the JAX
    package has it): the batch is (volumes x ``chunk`` slices); before the
    spatial attention, the same attention weights attend over the depth
    axis at every spatial location, the chunk's slices laid out on a
    near-square grid (``closest_factors``), through ``Depth_Adapter`` (no
    skip), and the result joins the spatial attention's output. A batch
    that ``chunk`` does not divide raises ValueError. A global block's
    spatial attention is the ``global_attn`` span, attribute ``block``
    (``index``).

    Where ``takes_kernel`` holds, the work around the attention (the norms,
    the casts, the window partition and the residual add before the MLP)
    is two launches of ``csrc/layer_norm.cu`` (ops/norm_kernels,
    ``_forward_kernel``); elsewhere the plain sequence below."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 14, use_adapter: bool = False,
                 input_size: Tuple[int, int] = (64, 64), thd: bool = False,
                 chunk: int = 0, dtype: torch.dtype = torch.float32,
                 index: int = 0) -> None:
        super().__init__()
        self.window_size = window_size
        self.index = index
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = RelPosAttention(
            dim, num_heads,
            input_size=(window_size, window_size) if window_size > 0
            else input_size, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), dtype=dtype)
        if use_adapter:
            self.Space_Adapter = Adapter(dim)
            self.MLP_Adapter = Adapter(dim, skip_connect=False)
        if thd:
            self.Depth_Adapter = Adapter(dim, skip_connect=False)
        self.use_adapter = use_adapter
        self.thd = thd
        self.chunk = chunk

    def _depth_attention(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        d = self.chunk
        if d <= 0 or b % d:
            raise ValueError(
                f"thd branch needs batch ({b}) divisible by chunk ({d})")
        dh, dw = closest_factors(d)
        # (b*d, h, w, c) -> (b*h*w, dh, dw, c)
        xd = x.reshape(b // d, d, h * w, c).transpose(1, 2)
        xd = layer_norm(xd.reshape(-1, dh, dw, c), self.norm1)
        xd = self.Depth_Adapter(self.attn(xd))
        # back to (b*d, h, w, c)
        xd = xd.reshape(b // d, h * w, d, c).transpose(1, 2)
        return xd.reshape(b, h, w, c)

    def takes_kernel(self, x: torch.Tensor) -> bool:
        """Whether the block's norms run in the kernel: a tensor on a card,
        a bfloat16 block (the attention kernel's condition), no adapter
        (``MLP_Adapter`` reads norm2's float32 output), no depth branch,
        and no gradient to record (the kernel has no backward). A CPU
        tensor, a float32 block, an adapter or depth block and a call that
        needs gradients (fine-tuning, LoRA) take the plain sequence."""
        if x.device.type != "cuda" or self.attn.dtype != torch.bfloat16 \
                or self.use_adapter or self.thd:
            return False
        return not (torch.is_grad_enabled() and (
            x.requires_grad
            or any(p.requires_grad for p in self.parameters())))

    def _forward_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """The block on ``takes_kernel``'s calls: LN1 straight into the
        attention's bfloat16 windows (or tokens), then the residual add and
        LN2 in one pass that reads the attention's output where it lies;
        the MLP and its residual add as in ``forward``."""
        ws = self.window_size
        # the encoder's stream arrives channels-first in memory (the patch
        # embedding's permute); the kernel reads it, and returns it, as
        # contiguous (B, H, W, C) rows
        x = x.contiguous()
        n1, n2 = self.norm1, self.norm2
        normed = norm_kernels.residual_norm(x, n1.weight, n1.bias, n1.eps, ws)
        if ws > 0:
            branch = self.attn(normed)
        else:
            branch = self.attn(normed, span_attrs={"block": self.index})
        x, normed = norm_kernels.residual_norm(x, n2.weight, n2.bias, n2.eps,
                                               ws, branch=branch)
        return x + self.mlp(normed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_kernel(x):
            return self._forward_kernel(x)
        b, h, w, c = x.shape
        shortcut = x
        xd = self._depth_attention(x) if self.thd else None
        x = layer_norm(x, self.norm1)
        ws = self.window_size
        if ws > 0:
            wins, dims = window_partition(x, ws)
            wins = self.attn(wins.reshape(-1, ws, ws, c))
            x = window_unpartition(wins.reshape(-1, ws * ws, c), ws, b, h, w,
                                   dims)
        else:
            x = self.attn(x, span_attrs={"block": self.index})
        if self.use_adapter:
            x = self.Space_Adapter(x)
        if xd is not None:
            x = x + xd
        x = shortcut + x
        normed = layer_norm(x, self.norm2)
        mlp_out = self.mlp(normed)
        if self.use_adapter:
            mlp_out = mlp_out + 0.5 * self.MLP_Adapter(normed)
        return x + mlp_out


class _PatchEmbed(nn.Module):
    """The patch embedding convolution (key ``proj``)."""

    def __init__(self, patch_size: int, embed_dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class ImageEncoderViT(nn.Module):
    """SAM's ViT-Det encoder: (B, 3, S, S) -> (B, out_chans, S/16, S/16).

    ``adapter_blocks`` are the block indexes that get adapters; ``thd``
    and ``chunk`` turn on every block's depth branch (see Block). ``train``
    is taken for the Sam interface; the encoder has no batch norm, so it
    changes nothing."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 adapter_blocks: Sequence[int] = (), thd: bool = False,
                 chunk: int = 0, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        grid = img_size // patch_size
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size=0 if i in global_attn_indexes else window_size,
                  use_adapter=i in adapter_blocks, input_size=(grid, grid),
                  thd=thd, chunk=chunk, dtype=dtype, index=i)
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(x, self.patch_embed.proj, self.dtype).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = x.permute(0, 3, 1, 2)
        x = self.neck[1](conv2d(x, self.neck[0], self.dtype))
        return self.neck[3](conv2d(x, self.neck[2], self.dtype))
