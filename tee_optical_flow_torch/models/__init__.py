"""The SAM segmentor of the PyTorch port: vit_t (TinyViT encoder) and
vit_b/l/h (ViT-Det encoder), the prompt encoder and the two-way mask
decoder as torch modules with the reference torch state-dict keys, their
PEFT adapters and LoRA factors (``lora``), int8 weights (``quantize``),
the batched clip segmentor the pipeline runs, and the interactive
predictor (``predictor``), the automatic mask generator (``amg``) and
export (``export``)."""

from .registry import (
    build_sam_vit_b, build_sam_vit_h, build_sam_vit_l, build_sam_vit_t,
    sam_model_registry,
)
from .sam import Sam, make_clip_segmentor, preprocess_frames

__all__ = ["Sam", "build_sam_vit_b", "build_sam_vit_h", "build_sam_vit_l",
           "build_sam_vit_t", "make_clip_segmentor", "preprocess_frames",
           "sam_model_registry"]
