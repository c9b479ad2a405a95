"""The SAM segmentor of the PyTorch port: vit_t (TinyViT encoder, prompt
encoder, two-way mask decoder) as torch modules with the reference torch
state-dict keys, its PEFT adapters and LoRA factors (``lora``), and the
batched clip segmentor the pipeline runs."""

from .registry import build_sam_vit_t, sam_model_registry
from .sam import Sam, make_clip_segmentor, preprocess_frames

__all__ = ["Sam", "build_sam_vit_t", "make_clip_segmentor",
           "preprocess_frames", "sam_model_registry"]
