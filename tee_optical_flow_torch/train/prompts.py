"""Prompt synthesis from masks (point / box / jittered box): the port's
own copy of the JAX package's train/prompts.py, host numpy and scipy.

Parity with reference finetune-SAM/utils/funcs.py: interior points via the
distance transform (get_first_prompt :23-100), per-component top boxes
(get_top_boxes :103-146), and the jittered tight bbox (MaskToBoxSimple
:148-172). Host-side numpy (runs in the data pipeline).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def get_first_point(mask: np.ndarray, region_type: str = "largest_3",
                    rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pick deep-interior positive click points, one per prominent
    component. Returns (points (K, 2) as (x, y), labels (K,))."""
    rng = rng or np.random.default_rng(0)
    fg = mask > 0
    if not fg.any():
        return np.zeros((1, 2), np.float32), -np.ones(1, np.float32)
    lbl, n = ndimage.label(fg)
    sizes = ndimage.sum(fg, lbl, range(1, n + 1))
    k = min(int(region_type.split("_")[-1]) if "_" in region_type else 1, n)
    top = np.argsort(sizes)[::-1][:k] + 1
    points, labels = [], []
    for comp in top:
        comp_mask = lbl == comp
        dist = ndimage.distance_transform_edt(comp_mask)
        # sample among the deepest 10% interior pixels
        thresh = dist.max() * 0.9
        ys, xs = np.nonzero(dist >= thresh)
        j = int(rng.integers(0, len(ys)))
        points.append([float(xs[j]), float(ys[j])])
        labels.append(1.0)
    return np.asarray(points, np.float32), np.asarray(labels, np.float32)


def get_top_boxes(mask: np.ndarray, k: int = 3) -> np.ndarray:
    """Tight bbox per largest-k component -> (K, 4) as (x0, y0, x1, y1)."""
    fg = mask > 0
    if not fg.any():
        return np.zeros((1, 4), np.float32)
    lbl, n = ndimage.label(fg)
    sizes = ndimage.sum(fg, lbl, range(1, n + 1))
    top = np.argsort(sizes)[::-1][:min(k, n)] + 1
    boxes = []
    for comp in top:
        ys, xs = np.nonzero(lbl == comp)
        boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
    return np.asarray(boxes, np.float32)


def mask_to_box(mask: np.ndarray, jitter: float = 0.1,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Jittered tight bbox of the whole foreground -> (1, 4)
    (reference MaskToBoxSimple)."""
    rng = rng or np.random.default_rng(0)
    fg = mask > 0
    h, w = mask.shape
    if not fg.any():
        return np.asarray([[0, 0, w - 1, h - 1]], np.float32)
    ys, xs = np.nonzero(fg)
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    bw, bh = x1 - x0, y1 - y0
    noise = rng.uniform(-jitter, jitter, size=4)
    box = np.asarray([
        max(0.0, x0 + noise[0] * bw), max(0.0, y0 + noise[1] * bh),
        min(w - 1.0, x1 + noise[2] * bw), min(h - 1.0, y1 + noise[3] * bh),
    ], np.float32)
    return box[None]
