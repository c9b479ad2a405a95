"""Interactive SAM predictor: embed an image once, prompt it many times
(the JAX package's models/predictor.py; reference
finetune-SAM/models/sam/predictor.py:17-270).

``set_image`` runs the encoder once on the model's device and keeps the
embedding there; each ``predict`` runs only the prompt encoder and the
mask decoder on it. Masks are postprocessed as the reference's
``Sam.postprocess_masks``: the low-resolution logits resized to the input
size, cropped to the unpadded region and resized to the original image
(``jax.image.resize(method="bilinear")``'s weights, ops/warp.
resize_bilinear, which antialias when they shrink).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.imaging import IMAGENET_MEAN, IMAGENET_STD
from ..ops.warp import resize_bilinear
from .transforms import ResizeLongestSide


class SamPredictor:
    def __init__(self, model) -> None:
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.transform = ResizeLongestSide(model.image_size)
        self.reset_image()

    def reset_image(self) -> None:
        self.is_image_set = False
        self.features: Optional[torch.Tensor] = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray) -> None:
        """(H, W, 3) uint8 RGB -> the embedding, kept on the device."""
        self.original_size = image.shape[:2]
        resized = self.transform.apply_image(image)
        self.input_size = resized.shape[:2]
        s = self.model.image_size
        padded = np.zeros((s, s, 3), np.float32)
        padded[:resized.shape[0], :resized.shape[1]] = resized / 255.0
        normalized = (padded - IMAGENET_MEAN) / IMAGENET_STD
        x = torch.from_numpy(np.ascontiguousarray(
            normalized.transpose(2, 0, 1)[None])).to(self.device)
        self.features = self.model.image_encoder(x)
        self.is_image_set = True

    def get_image_embedding(self) -> torch.Tensor:
        if not self.is_image_set:
            raise RuntimeError("An image must be set with set_image(...)")
        return self.features

    @torch.no_grad()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True):
        """(masks (K, H, W) bool, iou_predictions (K,) float32,
        low_res_logits (K, 4*grid, 4*grid) float32), numpy. ``point_coords`` (N, 2) xy and
        ``point_labels`` (N,) in the original image's pixels, ``box`` (4,)
        or (M, 4) xyxy, ``mask_input`` (4*grid, 4*grid) logits."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with set_image(...)")

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        points = boxes = masks = None
        if point_coords is not None:
            points = (dev(self.transform.apply_coords(
                point_coords, self.original_size))[None],
                dev(point_labels)[None])
        if box is not None:
            boxes = dev(self.transform.apply_boxes(box, self.original_size))
        if mask_input is not None:
            masks = dev(mask_input)[None, None]
        pe = self.model.prompt_encoder
        sparse, dense = pe(points, boxes, masks, batch_size=1)
        logits, iou = self.model.mask_decoder(
            self.features, pe.get_dense_pe(), sparse, dense,
            multimask_output=multimask_output)
        logits = logits[0]  # (K, 4g, 4g)
        s = self.model.image_size
        up = resize_bilinear(logits, s, s)
        up = up[:, :self.input_size[0], :self.input_size[1]].contiguous()
        full = resize_bilinear(up, *self.original_size)
        return ((full > 0.0).cpu().numpy(),
                iou[0].to(torch.float32).cpu().numpy(),
                logits.cpu().numpy())
