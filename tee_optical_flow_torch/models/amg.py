"""Automatic mask generation: the mask utilities and the grid-prompt
generator (the JAX package's models/amg.py; reference
finetune-SAM/models/sam/utils/amg.py: MaskData :16, RLE encode/decode,
calculate_stability_score :156, point grids, generate_crop_boxes :200,
batched_mask_to_box :303; automatic_mask_generator.py
SamAutomaticMaskGenerator :35): prompt the predictor with a point grid,
filter by predicted IoU and stability score, NMS the boxes, return
COCO-style records.

The mask post-processing is host numpy, as in the JAX package; each
point's prompt runs through the predictor's decoder on the device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np


class MaskData:
    """Dict-of-parallel-arrays with filter/cat (reference amg.py:16-84)."""

    def __init__(self, **kwargs):
        self._stats: Dict[str, Any] = dict(kwargs)

    def __getitem__(self, key):
        return self._stats[key]

    def __setitem__(self, key, value):
        self._stats[key] = value

    def keys(self):
        return self._stats.keys()

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray) -> None:
        for k, v in self._stats.items():
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in np.nonzero(keep)[0]]

    def cat(self, other: "MaskData") -> None:
        for k, v in other.items():
            if k not in self._stats:
                self._stats[k] = v
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v])
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + v


def calculate_stability_score(masks: np.ndarray, mask_threshold: float,
                              threshold_offset: float) -> np.ndarray:
    """IoU between high- and low-thresholded masks (reference :156-172)."""
    hi = (masks > (mask_threshold + threshold_offset)).sum(axis=(-1, -2))
    lo = (masks > (mask_threshold - threshold_offset)).sum(axis=(-1, -2))
    return hi / np.maximum(lo, 1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gy, gx = np.meshgrid(pts, pts, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """Crops of decreasing size per layer (reference :200-245)."""
    crop_boxes, layer_idxs = [], []
    h, w = im_size
    crop_boxes.append([0, 0, w, h])
    layer_idxs.append(0)

    def crop_len(orig, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig) / n_crops))

    for layer in range(n_layers):
        n_per_side = 2 ** (layer + 1)
        overlap = int(overlap_ratio * min(h, w) * (2 / n_per_side))
        cw = crop_len(w, n_per_side, overlap)
        ch = crop_len(h, n_per_side, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n_per_side)]
        y0s = [int((ch - overlap) * i) for i in range(n_per_side)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([x0, y0, min(x0 + cw, w), min(y0 + ch, h)])
                layer_idxs.append(layer + 1)
    return crop_boxes, layer_idxs


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(..., H, W) bool -> (..., 4) xyxy; zeros for empty masks
    (reference :303-346)."""
    shape = masks.shape
    flat = masks.reshape(-1, shape[-2], shape[-1])
    boxes = np.zeros((flat.shape[0], 4), np.float32)
    for i, m in enumerate(flat):
        ys, xs = np.nonzero(m)
        if ys.size:
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes.reshape(shape[:-2] + (4,))


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Uncompressed column-major RLE (reference rle helpers)."""
    h, w = mask.shape
    flat = mask.transpose().ravel().astype(np.int8)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    out = np.zeros(h * w, bool)
    pos = 0
    val = False
    for count in rle["counts"]:
        out[pos:pos + count] = val
        pos += count
        val = not val
    return out.reshape(w, h).transpose()


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy NMS keep-indices (replaces torchvision batched_nms)."""
    order = np.argsort(scores)[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx1 - xx0) * np.maximum(0, yy1 - yy0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = ((boxes[rest, 2] - boxes[rest, 0]) *
                  (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


class SamAutomaticMaskGenerator:
    """Grid-prompted whole-image mask generation
    (reference automatic_mask_generator.py:35-372, single-crop variant
    with the same filtering thresholds)."""

    def __init__(self, predictor, points_per_side: int = 32,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 min_mask_region_area: int = 0):
        self.predictor = predictor
        self.point_grid = build_point_grid(points_per_side)
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        h, w = image.shape[:2]
        self.predictor.set_image(image)
        data = MaskData(masks=np.zeros((0, h, w), bool),
                        iou_preds=np.zeros(0, np.float32),
                        points=np.zeros((0, 2), np.float32))
        for pt in self.point_grid:
            coords = np.array([[pt[0] * w, pt[1] * h]], np.float32)
            masks, ious, _ = self.predictor.predict(
                point_coords=coords, point_labels=np.ones(1),
                multimask_output=True)
            batch = MaskData(masks=masks, iou_preds=np.asarray(ious),
                             points=np.repeat(coords, len(masks), axis=0))
            data.cat(batch)

        keep = data["iou_preds"] > self.pred_iou_thresh
        data.filter(keep)
        stability = calculate_stability_score(
            data["masks"].astype(np.float32), 0.5,
            self.stability_score_offset * 0.05)
        data.filter(stability > self.stability_score_thresh)
        if len(data["masks"]) == 0:
            return []

        boxes = batched_mask_to_box(data["masks"])
        keep_idx = box_nms(boxes, data["iou_preds"], self.box_nms_thresh)
        mask_keep = np.zeros(len(data["masks"]), bool)
        mask_keep[keep_idx] = True
        data.filter(mask_keep)
        boxes = batched_mask_to_box(data["masks"])

        records = []
        for i in range(len(data["masks"])):
            m = data["masks"][i]
            if self.min_mask_region_area and m.sum() < self.min_mask_region_area:
                continue
            records.append({
                "segmentation": m,
                "rle": mask_to_rle(m),
                "area": int(m.sum()),
                "bbox": boxes[i].tolist(),
                "predicted_iou": float(data["iou_preds"][i]),
                "point_coords": [data["points"][i].tolist()],
            })
        return records
