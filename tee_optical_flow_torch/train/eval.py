"""Held-out evaluation: per-class IoU and Dice (the JAX package's
train/eval.py).

Parity with reference finetune-SAM/val_finetune_noprompt.py:38-113
(argmax prediction :80, per-class IoU :89-94, per-class Dice :96-99),
each batch on the model's device.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable

import numpy as np
import torch

from .losses import per_class_iou_dice

logger = logging.getLogger(__name__)


def evaluate_model(model, batches: Iterable, num_cls: int,
                   verbose: bool = True) -> Dict[str, np.ndarray]:
    """Run eval over (images (B, S, S, 3), labels (B, out, out)) numpy
    batches; returns the mean per-class ``iou`` and ``dice`` arrays of
    shape (num_cls,)."""
    device = next(model.parameters()).device
    model.eval()
    iou_sum = np.zeros(num_cls)
    dice_sum = np.zeros(num_cls)
    n = 0
    with torch.no_grad():
        for images, labels in batches:
            x = torch.from_numpy(np.asarray(images)).to(device)
            logits, _ = model(x.permute(0, 3, 1, 2), multimask_output=True,
                              train=False)
            pred = torch.argmax(logits, dim=1)
            iou, dice = per_class_iou_dice(
                pred, torch.from_numpy(np.asarray(labels)).to(device),
                num_cls)
            iou_sum += iou.cpu().numpy()
            dice_sum += dice.cpu().numpy()
            n += 1
    result = {"iou": iou_sum / max(n, 1), "dice": dice_sum / max(n, 1)}
    if verbose:
        for c in range(num_cls):
            logger.info("class %d: IoU %.4f Dice %.4f",
                        c, result["iou"][c], result["dice"][c])
    return result
