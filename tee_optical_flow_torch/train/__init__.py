"""SAM fine-tuning on one card (the JAX package's train/): losses and
metrics, the warmup -> poly schedule and TinyViT layer decay, the AdamW
train loop with its freeze policies (vanilla, adapter, LoRA), torch
checkpoints, the CSV image/mask dataset, prompts, evaluation, WGAN-GP
helpers and visualisation."""

from .losses import (
    combined_loss, cross_entropy_loss, dice_coeff_multi_class, dice_loss,
)
from .loop import (
    TrainConfigRuntime, make_eval_step, make_train_step, train_model,
)
from .schedule import warmup_poly_schedule

__all__ = [
    "dice_loss", "cross_entropy_loss", "combined_loss",
    "dice_coeff_multi_class", "warmup_poly_schedule", "TrainConfigRuntime",
    "make_train_step", "make_eval_step", "train_model",
]
