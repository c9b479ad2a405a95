"""Segmentation losses and metrics (the JAX package's train/losses.py).

Parity with the reference training recipe
(SingleGPU_train_finetune_noprompt.py:76-77, :113-115): monai
DiceLoss(sigmoid=True, squared_pred=True, to_onehot_y=True, mean) plus
CrossEntropyLoss, and the dice_coeff_multi_class eval metric
(utils/dsc.py:79-92: all classes incl. background, smooth=1, dice per
image then mean). Also the generic loss library of utils/losses.py
(generalized dice, BCE-dice, weighted CE). Every loss computes in float32
from the logits (B, C, H, W); labels are (B, H, W) integers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _onehot(labels: torch.Tensor, num_cls: int) -> torch.Tensor:
    """(B, H, W) int -> (B, C, H, W) float32."""
    return F.one_hot(labels.long(), num_cls).permute(0, 3, 1, 2).to(
        torch.float32)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              squared_pred: bool = True, smooth: float = 1e-5
              ) -> torch.Tensor:
    """monai-style dice: sigmoid on the logits, one-hot labels, mean over
    channels and batch."""
    num_cls = logits.shape[1]
    probs = torch.sigmoid(logits.to(torch.float32))
    onehot = _onehot(labels, num_cls)
    dims = (2, 3)
    inter = torch.sum(probs * onehot, dim=dims)
    if squared_pred:
        denom = (torch.sum(probs ** 2, dim=dims)
                 + torch.sum(onehot ** 2, dim=dims))
    else:
        denom = torch.sum(probs, dim=dims) + torch.sum(onehot, dim=dims)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return torch.mean(1.0 - dice)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """torch CrossEntropyLoss semantics (mean over pixels)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=1)
    onehot = _onehot(labels, logits.shape[1])
    return -torch.mean(torch.sum(onehot * logp, dim=1))


def combined_loss(logits: torch.Tensor, labels: torch.Tensor):
    """dice + CE, returning (total, dice, ce) as the reference logs
    them."""
    ld = dice_loss(logits, labels)
    lc = cross_entropy_loss(logits, labels)
    return ld + lc, ld, lc


def dice_coeff_multi_class(pred_labels: torch.Tensor,
                           true_labels: torch.Tensor, n_classes: int,
                           smooth: float = 1.0) -> torch.Tensor:
    """Mean dice over all classes of argmax'd predictions (reference
    utils/dsc.py:79-92). pred/true (B, H, W) int.

    The pixel counts are exact in float32 (below 2^24 per image), and the
    B x C scores are summed one by one in a fixed order and divided once
    by a tensor, so the card and the CPU give the same bits from the same
    labels (torch.mean may sum in another order on each, and CUDA divides
    by a Python number as a product with its reciprocal)."""
    scores = []
    for cls in range(n_classes):
        p = (pred_labels == cls).to(torch.float32)
        t = (true_labels == cls).to(torch.float32)
        inter = torch.sum(p * t, dim=(1, 2))
        union = torch.sum(p, dim=(1, 2)) + torch.sum(t, dim=(1, 2))
        scores.append((2.0 * inter + smooth) / (union + smooth))
    flat = torch.stack(scores).flatten()
    total = flat[0]
    for k in range(1, flat.numel()):
        total = total + flat[k]
    return total / torch.full_like(total, flat.numel())


def per_class_iou_dice(pred_labels: torch.Tensor, true_labels: torch.Tensor,
                       n_classes: int, eps: float = 1e-7):
    """Per-class IoU and Dice for held-out eval (reference
    val_finetune_noprompt.py:89-99). Returns (iou (C,), dice (C,))."""
    ious, dices = [], []
    for cls in range(n_classes):
        p = (pred_labels == cls).to(torch.float32)
        t = (true_labels == cls).to(torch.float32)
        inter = torch.sum(p * t)
        union = torch.sum(p) + torch.sum(t) - inter
        ious.append(inter / (union + eps))
        dices.append(2 * inter / (torch.sum(p) + torch.sum(t) + eps))
    return torch.stack(ious), torch.stack(dices)


def generalized_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Class-frequency-weighted dice (reference utils/losses.py
    GeneralizedDiceLoss:131-163)."""
    probs = torch.softmax(logits.to(torch.float32), dim=1)
    onehot = _onehot(labels, logits.shape[1])
    dims = (0, 2, 3)
    w = 1.0 / (torch.sum(onehot, dim=dims) ** 2 + eps)
    inter = torch.sum(w * torch.sum(probs * onehot, dim=dims))
    denom = torch.sum(w * torch.sum(probs + onehot, dim=dims))
    return 1.0 - 2.0 * inter / (denom + eps)


def bce_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                  alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """BCE + dice combo (reference utils/losses.py BCEDiceLoss:166-177)."""
    onehot = _onehot(labels, logits.shape[1])
    x = logits.to(torch.float32)
    bce = torch.mean(torch.clamp(x, min=0) - x * onehot
                     + torch.log1p(torch.exp(-torch.abs(x))))
    return alpha * bce + beta * dice_loss(logits, labels)


def weighted_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                                eps: float = 1e-7) -> torch.Tensor:
    """CE weighted by inverse class frequency (reference utils/losses.py
    WeightedCrossEntropyLoss:180-207)."""
    onehot = _onehot(labels, logits.shape[1])
    freq = torch.mean(onehot, dim=(0, 2, 3))
    weights = 1.0 / (freq + eps)
    weights = weights / torch.sum(weights)
    logp = torch.log_softmax(logits.to(torch.float32), dim=1)
    per_class = -torch.sum(onehot * logp, dim=(0, 2, 3)) / (
        torch.sum(onehot, dim=(0, 2, 3)) + eps)
    return torch.sum(weights * per_class)
