"""ViT-Det's relative-position attention as one CUDA kernel
(``csrc/relpos_attention.cu``).

``rel_pos_attention`` runs the attention of a ``RelPosAttention`` module
(models/image_encoder.py) on the card: q, k and v in bfloat16 read by
strides from the ``qkv`` projection's (B, N, 3, heads, hd) output, the
two float32 bias projections Qh (B, heads, h, w, h) and Qw (B, heads, h,
w, w) computed before the call and read by strides; the scores, the
decomposed bias, the softmax and the weighted sum inside the kernel. It
returns the bfloat16 (B, N, heads, hd) sum. The plain version is
``RelPosAttention._attend``, which the module keeps for the CPU, for
float32 modules and for calls that need gradients; the module picks
(``RelPosAttention.takes_kernel``), this wrapper never falls back: what
the kernel does not take raises.

The call goes through a PyTorch operator
(``tee_optical_flow::rel_pos_attention``, defined in a
``torch.library.Library``) with a shape-only fake, so that
``torch.export`` of a bfloat16 model on the card records the kernel and
the exported program runs it. Each call adds one to the counter
``launches.rel_pos_attention`` (``utils.tracing``). The kernel's design,
and what bounds it, is in the source's head note.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.tracing import count
from .cuda_lib import check_launch, launch_context, load_library, ptr

# head widths the kernel is built for: vit_b and vit_l (64), vit_h (80)
HEAD_DIMS = (64, 80)
# keys a tile (the source's kBc)
KEY_TILE = 64


def attention_geometry(w: int) -> Tuple[int, int, bool]:
    """(warps a block, 16-row tiles a warp, tile_row) for an attention on a
    grid ``w`` wide. Where a key tile lies within one grid row (w a
    multiple of ``KEY_TILE``: the global blocks' 64x64) the bias takes the
    within-a-row path, and a block 4 warps of two row tiles, so that every
    k and v fragment read from shared memory feeds two products; else (the
    windowed blocks' 14x14, the depth attention's 2x2) 8 warps of one row
    tile. A sweep of every geometry on an H100 (two runs; PERF.md
    section 6): within a row 4 x 2 is 2-8% faster than 8 x 1 at 16x64 and
    vit_h's 64x64, within 4% at vit_b's; across rows 8 x 1 is 19-23%
    faster at 14x14, 25-30% at 40x40 and 48x48, and within 8% either way
    from 24x24 to 36x36 and at 64x64."""
    return (4, 2, True) if w % KEY_TILE == 0 else (8, 1, False)


def _check(qkv: torch.Tensor, qh: torch.Tensor, qw: torch.Tensor, h: int,
           w: int) -> None:
    if qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16 \
            or qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(
            "rel_pos_attention: qkv must be a bfloat16 (B, N, 3, heads, hd) "
            f"tensor on a card; got {qkv.dtype} {tuple(qkv.shape)} on "
            f"{qkv.device}")
    b, n, _, heads, hd = qkv.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rel_pos_attention: head width {hd} is not one "
                         f"the kernel is built for {HEAD_DIMS}")
    if n != h * w:
        raise ValueError(f"rel_pos_attention: {n} tokens on a {h}x{w} grid")
    if h + w > 0xFFFF:
        raise ValueError(f"rel_pos_attention: a {h}x{w} grid is too wide")
    if qkv.stride(-1) != 1 or any(s % 8 for s in qkv.stride()[:4]):
        raise ValueError("rel_pos_attention: each head's values must be "
                         "contiguous and 16-byte aligned; got strides "
                         f"{qkv.stride()}")
    for name, t, side in (("qh", qh, h), ("qw", qw, w)):
        if t.device != qkv.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (b, heads, h, w, side) \
                or t.stride(-1) != 1:
            raise ValueError(
                f"rel_pos_attention: {name} must be a float32 "
                f"{(b, heads, h, w, side)} tensor on {qkv.device} with "
                f"contiguous rows; got {t.dtype} {tuple(t.shape)} strides "
                f"{t.stride()} on {t.device}")


def _launch(qkv: torch.Tensor, qh: torch.Tensor, qw: torch.Tensor, h: int,
            w: int, scale: float,
            geometry: Tuple[int, int, bool]) -> torch.Tensor:
    """One launch of the kernel in the given geometry (warps a block,
    16-row tiles a warp, tile_row): the bfloat16 (B, N, heads, hd) sum.
    The operator below gives it ``attention_geometry``'s choice; the
    library builds only those, and refuses any other at the launch."""
    _check(qkv, qh, qw, h, w)
    if qkv.data_ptr() % 16:
        raise ValueError("rel_pos_attention: qkv must start 16-byte aligned")
    b, n, _, heads, hd = qkv.shape
    out = torch.empty((b, n, heads, hd), dtype=torch.bfloat16,
                      device=qkv.device)
    sb, sn, s3, sh, _ = qkv.stride()
    bias_strides = (ctypes.c_longlong * 8)(*qh.stride()[:4], *qw.stride()[:4])
    warps, m_tiles, tile_row = geometry
    lib = load_library()
    with launch_context(qkv.device) as stream:
        check_launch("rel_pos_attention", lib.rel_pos_attention(
            ptr(qkv), ptr(qh), ptr(qw), ctypes.addressof(bias_strides),
            ptr(out), b, n, heads, hd, h, w, sb, sn, s3, sh, scale, warps,
            m_tiles, int(tile_row), stream))
    count("launches.rel_pos_attention")
    return out


def _rel_pos_attention_impl(qkv, qh, qw, h, w, scale):
    return _launch(qkv, qh, qw, h, w, scale, attention_geometry(w))


# the operator, registered for every backend (a tensor off the card then
# raises in _check) through a plain torch.library.Library: torch.library
# .custom_op's wrapper imports torch._dynamo at its first call, seconds of
# every process's set-up
_LIB = torch.library.Library("tee_optical_flow", "FRAGMENT")
_LIB.define("rel_pos_attention(Tensor qkv, Tensor qh, Tensor qw, int h, "
            "int w, float scale) -> Tensor")
_LIB.impl("rel_pos_attention", _rel_pos_attention_impl,
          "CompositeExplicitAutograd")


@torch.library.register_fake("tee_optical_flow::rel_pos_attention", lib=_LIB)
def _(qkv, qh, qw, h, w, scale):
    b, n, _, heads, hd = qkv.shape
    return qkv.new_empty((b, n, heads, hd))


def rel_pos_attention(qkv: torch.Tensor, qh: torch.Tensor, qw: torch.Tensor,
                      h: int, w: int, scale: float) -> torch.Tensor:
    """The attention over the h x w grid of ``qkv`` (B, h * w, 3, heads,
    hd), bfloat16 on a card, with the bias projections ``qh`` (B, heads, h,
    w, h) and ``qw`` (B, heads, h, w, w) in float32, any strides but
    contiguous rows: the bfloat16 (B, N, heads, hd) weighted sum, in the
    geometry ``attention_geometry`` picks for the grid. An hd the kernel is
    not built for, or a layout it cannot read, raises ValueError."""
    return torch.ops.tee_optical_flow.rel_pos_attention(qkv, qh, qw, h, w,
                                                        float(scale))
