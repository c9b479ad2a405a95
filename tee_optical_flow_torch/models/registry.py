"""SAM builders (the JAX package's models/registry.py).

``build_sam_vit_t`` returns the vit_t Sam as a torch module on ``device``
(``cuda`` unless the caller asks for ``cpu``), with seeded random weights
or a reference checkpoint's. ``num_classes`` is the decoder's
num_multimask_outputs, as the reference wires it (build_sam.py:85-97).
The ViT-Det encoders (vit_b, vit_l, vit_h) and the PEFT adapters are not
ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..core import resolve_device
from .common import LayerNorm2d
from .sam import Sam
from .tinyvit import TinyViT


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights from an explicit ``torch.Generator``, in the
    order of ``model.modules()``: dense and conv weights normal with
    variance 1/fan_in and zero biases (flax's lecun-normal and zeros),
    embeddings and the prompt encoder's Gaussian matrix standard normal,
    norms at one and zero, batch-norm statistics at mean 0, variance 1.
    The relative attention biases start at zero, as in flax."""
    g = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=g) * std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                if isinstance(m, nn.Linear):
                    fan_in = w.shape[1]
                elif isinstance(m, nn.Conv2d):
                    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                else:  # ConvTranspose2d weight (I, O, k, k)
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                normal_(w, 1.0 / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, 1.0)
            elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            if hasattr(m, "positional_encoding_gaussian_matrix"):
                normal_(m.positional_encoding_gaussian_matrix, 1.0)
            if hasattr(m, "attention_biases"):
                m.attention_biases.zero_()


def build_sam_vit_t(num_classes: int = 3, image_size: int = 1024,
                    checkpoint: Optional[str] = None,
                    dtype: torch.dtype = torch.float32, seed: int = 0,
                    device=None, adapter_stages: Sequence[int] = (),
                    use_decoder_adapter: bool = False) -> Sam:
    """vit_t SAM (TinyViT embed_dims (64, 128, 160, 320), depths (2, 2,
    6, 2), heads (2, 4, 5, 10), windows (7, 7, 14, 7)), computing in
    ``dtype`` (float32 parameters either way), in eval mode on
    ``device``. ``checkpoint`` is a reference torch ``.pth``
    (models/convert.load_torch_checkpoint)."""
    if adapter_stages or use_decoder_adapter:
        raise NotImplementedError(
            "the PEFT adapters (adapter_stages, use_decoder_adapter) are not "
            "ported yet: ROADMAP.md, queue 1, item 8 (training)")
    dev = resolve_device(device)
    model = Sam(TinyViT(img_size=image_size, dtype=dtype),
                num_classes=num_classes, image_size=image_size, dtype=dtype)
    init_weights(model, seed)
    if checkpoint:
        from .convert import load_torch_checkpoint

        load_torch_checkpoint(checkpoint, model)
    return model.to(dev).eval()


def _vitdet(arch: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"SAM {arch} (the ViT-Det encoder, the JAX package's "
            "models/image_encoder.py) is not ported yet: ROADMAP.md, queue "
            "1, item 4")

    build.__name__ = f"build_sam_{arch}"
    return build


build_sam_vit_b = _vitdet("vit_b")
build_sam_vit_l = _vitdet("vit_l")
build_sam_vit_h = _vitdet("vit_h")

sam_model_registry = {
    "default": build_sam_vit_h,
    "vit_h": build_sam_vit_h,
    "vit_l": build_sam_vit_l,
    "vit_b": build_sam_vit_b,
    "vit_t": build_sam_vit_t,
}
