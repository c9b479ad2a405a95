"""LR schedule and per-layer LR decay (the JAX package's train/schedule.py).

Parity with the reference's in-loop lr mutation
(SingleGPU_train_finetune_noprompt.py:121-134): lr * (i+1)/warmup during
warmup, then lr * (1 - shift/max_iter)^0.9. The optimizer reads it as a
``LambdaLR`` factor at the count of applied updates (optax evaluates its
schedule at the same count).

Layer-wise LR decay mirrors TinyViT.set_layer_lr_decay (reference
tiny_vit_sam.py:655-687, invoked with 0.8 from build_sam.py:77): with
depth = sum(depths), block k gets lr scale decay^(depth-1-k), the patch
embed gets the scale of block 0, each PatchMerging the scale of the last
block of its stage, and everything else (the SAM neck, the prompt
encoder, the mask decoder) 1.0. The JAX package keys this on flax names
that only TinyViT has (``patch_embed_conv*``, ``stage{i}_block{j}``,
``merge{i}``); the port on TinyViT's own parameter names
(``image_encoder.patch_embed.seq``, ``image_encoder.layers.{i}.blocks.
{j}``, ``image_encoder.layers.{i}.downsample``), with the same rules. So a
ViT-Det encoder (vit_b/l/h: ``image_encoder.patch_embed.proj``,
``image_encoder.blocks.{i}``) keeps 1.0 everywhere, as in the JAX
package. The scale becomes the parameter
group's lr factor, so it multiplies the decoupled weight decay too, as
the JAX package's transform chained after ``adamw`` does.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

VIT_T_DEPTHS = (2, 2, 6, 2)


def warmup_poly_schedule(base_lr: float, warmup_period: int,
                         max_iterations: int, power: float = 0.9
                         ) -> Callable[[int], float]:
    """step -> lr: linear warmup to ``base_lr`` over ``warmup_period``
    steps, then polynomial decay to 0 at ``max_iterations`` past it."""

    def schedule(step: int) -> float:
        step = float(step)
        poly = base_lr * max(1.0 - max(step - warmup_period, 0.0)
                             / max(max_iterations, 1), 0.0) ** power
        if warmup_period <= 0 or step >= warmup_period:
            return poly
        return base_lr * (step + 1.0) / max(warmup_period, 1)

    return schedule


_BLOCK_RE = re.compile(r"^image_encoder\.layers\.(\d+)\.blocks\.(\d+)\.")
_MERGE_RE = re.compile(r"^image_encoder\.layers\.(\d+)\.downsample\.")


def tinyvit_lr_scale_for_name(name: str, decay: float,
                              depths: Sequence[int] = VIT_T_DEPTHS) -> float:
    """LR scale of the port's parameter ``name`` (rules above). Names
    outside the TinyViT encoder (the neck, the prompt encoder, the
    decoder, and the LoRA factors, which the trainer names
    ``lora/<site>/<factor>``, as the JAX package's factor tree falls
    outside its flax names too) get 1.0."""
    depth = sum(depths)
    starts = [0]
    for d in depths:
        starts.append(starts[-1] + d)

    def scale(k: int) -> float:
        return decay ** (depth - 1 - k)

    if name.startswith("image_encoder.patch_embed.seq."):
        return scale(0)
    m = _BLOCK_RE.match(name)
    if m:
        return scale(starts[int(m.group(1))] + int(m.group(2)))
    m = _MERGE_RE.match(name)
    if m:
        return scale(starts[int(m.group(1)) + 1] - 1)
    return 1.0
