"""ResizeLongestSide: image, coordinate and box resizing to the SAM input
size (the JAX package's models/transforms.py; reference
finetune-SAM/models/sam/utils/transforms.py:16-101).

The pixel resample is ``jax.image.resize(method="bilinear")``'s
(ops/warp.resize_bilinear: its antialiased weights when an image
shrinks), then round and clip to uint8, on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.warp import resize_bilinear


class ResizeLongestSide:
    def __init__(self, target_length: int) -> None:
        self.target_length = target_length

    @staticmethod
    def get_preprocess_shape(oldh: int, oldw: int, long_side: int
                             ) -> Tuple[int, int]:
        scale = long_side / max(oldh, oldw)
        newh, neww = oldh * scale, oldw * scale
        return int(newh + 0.5), int(neww + 0.5)

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """(H, W[, C]) uint8 -> resized so that the longest side is the
        target, uint8."""
        h, w = image.shape[:2]
        nh, nw = self.get_preprocess_shape(h, w, self.target_length)
        x = torch.from_numpy(np.asarray(image, np.float32))
        planes = x.reshape(h, w, -1).permute(2, 0, 1)
        out = resize_bilinear(planes.contiguous(), nh, nw).permute(1, 2, 0)
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        return out.reshape((nh, nw) + image.shape[2:]).numpy()

    def apply_coords(self, coords: np.ndarray, original_size) -> np.ndarray:
        oldh, oldw = original_size
        nh, nw = self.get_preprocess_shape(oldh, oldw, self.target_length)
        coords = np.asarray(coords, np.float64).copy()
        coords[..., 0] = coords[..., 0] * (nw / oldw)
        coords[..., 1] = coords[..., 1] * (nh / oldh)
        return coords

    def apply_boxes(self, boxes: np.ndarray, original_size) -> np.ndarray:
        boxes = self.apply_coords(
            np.asarray(boxes).reshape(-1, 2, 2), original_size)
        return boxes.reshape(-1, 4)
