"""Training visualisation and misc eval utilities (the JAX package's
train/visutils.py). matplotlib is imported inside the function that draws.

Parity with the reference's grab-bag (finetune-SAM/utils/utils.py:
create_logger :384, vis_image :969, eval_seg :1014).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Sequence

import numpy as np

from ..utils import safe_makedir


def create_logger(log_dir: str, phase: str = "train") -> logging.Logger:
    """File + console logger named by timestamp (reference utils.py:384)."""
    safe_makedir(log_dir)
    stamp = time.strftime("%Y-%m-%d-%H-%M")
    log_file = os.path.join(log_dir, f"{stamp}_{phase}.log")
    logger = logging.getLogger(f"tee_optical_flow_torch.{phase}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(
            "%(asctime)-15s %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    return logger


def vis_image(images: np.ndarray, pred_masks: np.ndarray,
              true_masks: np.ndarray, save_path: str,
              max_rows: int = 4) -> str:
    """Side-by-side image / prediction / ground-truth panel
    (reference utils.py vis_image:969)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    n = min(len(images), max_rows)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        img = np.asarray(images[i])
        if img.ndim == 3 and img.shape[-1] == 3:
            img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
        axes[i][0].imshow(img)
        axes[i][0].set_title("image")
        axes[i][1].imshow(np.asarray(pred_masks[i]), cmap="tab10")
        axes[i][1].set_title("prediction")
        axes[i][2].imshow(np.asarray(true_masks[i]), cmap="tab10")
        axes[i][2].set_title("ground truth")
        for ax in axes[i]:
            ax.axis("off")
    parent = os.path.dirname(save_path)
    if parent:
        safe_makedir(parent)
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def eval_seg(pred_logits: np.ndarray, true_masks: np.ndarray,
             thresholds: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9)):
    """Mean (IoU, Dice) over binarization thresholds for single-channel
    logits (reference utils.py eval_seg:1014)."""

    pred = np.asarray(pred_logits, np.float32)
    true = np.asarray(true_masks) > 0.5
    ious, dices = [], []
    for th in thresholds:
        p = 1.0 / (1.0 + np.exp(-pred)) > th
        inter = np.logical_and(p, true).sum()
        union = np.logical_or(p, true).sum()
        ious.append(inter / max(union, 1))
        dices.append(2 * inter / max(p.sum() + true.sum(), 1))
    return float(np.mean(ious)), float(np.mean(dices))
