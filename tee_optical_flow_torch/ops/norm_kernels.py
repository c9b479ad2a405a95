"""ViT-Det's per-token residual pass as one CUDA kernel
(``csrc/layer_norm.cu``).

``residual_norm`` runs, on the card, the work of a ViT-Det block
(models/image_encoder.Block) around its attention: without ``branch``
(LN1) the bfloat16 layer norm of the float32 stream ``x`` (B, H, W, C),
written in the windowed attention's (B nh nw, ws, ws, C) layout where
``window`` > 0 (the pad zero) or (B, H, W, C) where it is 0; with
``branch`` (add + LN2) the float32 sum ``x + branch``, ``branch`` the
attention's bfloat16 output read from that layout, and its bfloat16 layer
norm, both (B, H, W, C). The norm is ``models/common.layer_norm``'s
arithmetic with the row sums in the kernel's order (the source's head
note). The plain version is ``models/image_encoder.residual_norm_plain``,
Block.forward's own sequence; the block picks (``Block.takes_kernel``),
this wrapper never falls back: what the kernel does not take raises.

The call goes through two PyTorch operators
(``tee_optical_flow::layer_norm_cast`` and
``tee_optical_flow::add_layer_norm_cast``, defined in a
``torch.library.Library``) with shape-only fakes, so that ``torch.export``
of a bfloat16 model on the card records the kernel and the exported
program runs it. Each call adds one to the counter
``launches.residual_norm`` (``utils.tracing``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..utils.tracing import count
from .cuda_lib import check_launch, launch_context, load_library, ptr

# token widths the kernel is built for: vit_b, vit_l and vit_h
WIDTHS = (768, 1024, 1280)


def layout(b: int, h: int, w: int, c: int, window: int) -> Tuple[int, ...]:
    """The shape of a (b, h, w, c) grid's tokens in the window layout, (b
    ceil(h / ws) ceil(w / ws), ws, ws, c), the pad included; (b, h, w, c)
    for window 0."""
    if not window:
        return (b, h, w, c)
    return (b * -(-h // window) * -(-w // window), window, window, c)


def _check(x: torch.Tensor, branch: Optional[torch.Tensor],
           weight: torch.Tensor, bias: torch.Tensor, window: int) -> None:
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 4:
        raise ValueError(
            "residual_norm: x must be a float32 (B, H, W, C) tensor on a "
            f"card; got {x.dtype} {tuple(x.shape)} on {x.device}")
    b, h, w, c = x.shape
    if c not in WIDTHS:
        raise ValueError(f"residual_norm: width {c} is not one the kernel "
                         f"is built for {WIDTHS}")
    if window < 0:
        raise ValueError(f"residual_norm: window {window} < 0")
    tensors = [("x", x, torch.float32, tuple(x.shape)),
               ("weight", weight, torch.float32, (c,)),
               ("bias", bias, torch.float32, (c,))]
    if branch is not None:
        tensors.append(("branch", branch, torch.bfloat16,
                        layout(b, h, w, c, window)))
    for name, t, dtype, shape in tensors:
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"residual_norm: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {x.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _launch(x: torch.Tensor, branch: Optional[torch.Tensor],
            weight: torch.Tensor, bias: torch.Tensor, eps: float,
            window: int):
    """One launch of the kernel: LN1's bfloat16 normed tokens, or with
    ``branch`` add + LN2's (x, normed)."""
    _check(x, branch, weight, bias, window)
    if any(t.data_ptr() % 16 for t in (x, branch, weight, bias)
           if t is not None):
        raise ValueError("residual_norm: every tensor must start 16-byte "
                         "aligned")
    b, h, w, c = x.shape
    if branch is None:
        x_out = None
        normed = torch.empty(layout(b, h, w, c, window), dtype=torch.bfloat16,
                             device=x.device)
    else:
        x_out = torch.empty_like(x)
        normed = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lib = load_library()
    with launch_context(x.device) as stream:
        check_launch("residual_norm", lib.residual_norm(
            ptr(x), ptr(branch), ptr(weight), ptr(bias), ptr(x_out),
            ptr(normed), b, h, w, c, window, eps, stream))
    count("launches.residual_norm")
    return normed if branch is None else (x_out, normed)


# the operators, registered for every backend (a tensor off the card then
# raises in _check) through a plain torch.library.Library, as
# ops/attention_kernels registers its own
_LIB = torch.library.Library("tee_optical_flow", "FRAGMENT")
_LIB.define("layer_norm_cast(Tensor x, Tensor weight, Tensor bias, "
            "float eps, int window) -> Tensor")
_LIB.define("add_layer_norm_cast(Tensor x, Tensor branch, Tensor weight, "
            "Tensor bias, float eps, int window) -> (Tensor, Tensor)")
_LIB.impl("layer_norm_cast",
          lambda x, weight, bias, eps, window:
          _launch(x, None, weight, bias, eps, window),
          "CompositeExplicitAutograd")
_LIB.impl("add_layer_norm_cast",
          lambda x, branch, weight, bias, eps, window:
          _launch(x, branch, weight, bias, eps, window),
          "CompositeExplicitAutograd")


@torch.library.register_fake("tee_optical_flow::layer_norm_cast", lib=_LIB)
def _(x, weight, bias, eps, window):
    return x.new_empty(layout(*x.shape, window), dtype=torch.bfloat16)


@torch.library.register_fake("tee_optical_flow::add_layer_norm_cast",
                             lib=_LIB)
def _(x, branch, weight, bias, eps, window):
    return x.new_empty(x.shape), x.new_empty(x.shape, dtype=torch.bfloat16)


def residual_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float, window: int,
                  branch: Optional[torch.Tensor] = None
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One pass over the float32 stream ``x`` (B, H, W, C) on a card, C one
    of ``WIDTHS``, with the norm's float32 ``weight`` and ``bias`` (C,) and
    ``eps``: without ``branch``, its bfloat16 layer norm in the window
    layout (``window`` > 0) or (B, H, W, C); with the bfloat16 ``branch``
    in that layout, (x + branch, the bfloat16 layer norm of that sum), both
    (B, H, W, C). Every tensor contiguous; a width, type or layout the
    kernel does not take raises ValueError."""
    if branch is None:
        return torch.ops.tee_optical_flow.layer_norm_cast(
            x, weight, bias, float(eps), int(window))
    return tuple(torch.ops.tee_optical_flow.add_layer_norm_cast(
        x, branch, weight, bias, float(eps), int(window)))
