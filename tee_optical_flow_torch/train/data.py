"""Training data: CSV-listed image/mask pairs -> host batches (the JAX
package's train/data.py).

Parity with reference finetune-SAM/utils/dataset.py (Public_dataset:20-199):
CSV rows of image,mask paths; empty-mask filtering (:87-107); SAM vs
MedSAM normalisation (:121-124); flip/rot90 augmentation drawn from
``np.random.default_rng(seed)`` in the train phase (:109-125); and
point/box prompts (:177-198). Images stay NHWC float32 numpy on the host;
the trainer moves each batch to the device and transposes it there once.

Files are read and resized with PIL (``Image.resize`` BILINEAR for
images, NEAREST for masks), as in the JAX package; PIL is imported where
a file is read, so the module imports without it.
"""

from __future__ import annotations

import csv
import logging
import os
import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _load_image(path: str, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    return np.asarray(img).astype(np.float32) / 255.0


def _load_mask(path: str, size: int) -> np.ndarray:
    from PIL import Image

    m = Image.open(path).convert("L").resize((size, size), Image.NEAREST)
    return np.asarray(m).astype(np.int32)


class PublicDataset:
    """CSV img/mask list dataset with SAM normalisation and augmentation."""

    def __init__(self, img_folder: str, mask_folder: str, list_path: str,
                 phase: str = "train", image_size: int = 1024,
                 out_size: int = 256, targets: str = "multi_all",
                 normalize_type: str = "sam", if_prompt: bool = False,
                 prompt_type: str = "point", delimiter: str = ",",
                 seed: int = 0):
        self.img_folder = img_folder
        self.mask_folder = mask_folder
        self.phase = phase
        self.image_size = image_size
        self.out_size = out_size
        self.targets = targets
        self.normalize_type = normalize_type
        self.if_prompt = if_prompt
        self.prompt_type = prompt_type
        self.rng = np.random.default_rng(seed)

        self.rows: List[Tuple[str, str]] = []
        with open(list_path) as f:
            for row in csv.reader(f, delimiter=delimiter):
                if len(row) >= 2:
                    self.rows.append((row[0].strip(), row[1].strip()))

    def __len__(self) -> int:
        return len(self.rows)

    def _augment(self, img: np.ndarray, mask: np.ndarray):
        if self.phase != "train":
            return img, mask
        if self.rng.random() < 0.5:
            img = img[:, ::-1]
            mask = mask[:, ::-1]
        k = int(self.rng.integers(0, 4))
        if k:
            img = np.rot90(img, k, axes=(0, 1))
            mask = np.rot90(mask, k, axes=(0, 1))
        return np.ascontiguousarray(img), np.ascontiguousarray(mask)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_rel, mask_rel = self.rows[idx]
        img = _load_image(os.path.join(self.img_folder, img_rel),
                          self.image_size)
        mask_full = _load_mask(os.path.join(self.mask_folder, mask_rel),
                               self.image_size)
        if self.targets == "combine_all":
            mask_full = (mask_full > 0).astype(np.int32)
        img, mask_full = self._augment(img, mask_full)

        if self.normalize_type == "sam":
            img = (img - IMAGENET_MEAN) / IMAGENET_STD
        elif self.normalize_type == "medsam":
            lo, hi = img.min(), img.max()
            img = (img - lo) / max(hi - lo, 1e-8)

        # the mask at the decoder's output size (NEAREST by striding)
        step = self.image_size // self.out_size
        mask = mask_full[::step, ::step][:self.out_size, :self.out_size]

        sample = {"image": img.astype(np.float32),
                  "mask": mask.astype(np.int32)}
        if self.if_prompt:
            from .prompts import get_first_point, mask_to_box

            if self.prompt_type == "point":
                sample["point"], sample["point_label"] = get_first_point(
                    mask_full, rng=self.rng)
            else:
                sample["boxes"] = mask_to_box(mask_full, rng=self.rng)
        return sample

    def filter_empty(self) -> "PublicDataset":
        """Drop rows whose mask has no foreground (reference :87-107)."""
        kept = []
        for img_rel, mask_rel in self.rows:
            m = _load_mask(os.path.join(self.mask_folder, mask_rel), 64)
            if (m > 0).any():
                kept.append((img_rel, mask_rel))
        dropped = len(self.rows) - len(kept)
        if dropped:
            logger.info("filtered %d empty-mask rows", dropped)
        self.rows = kept
        return self


def batch_iterator(dataset: PublicDataset, batch_size: int,
                   shuffle: bool = True, drop_last: bool = True,
                   seed: int = 0, prefetch: int = 2
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images (B, S, S, 3), masks (B, out, out)) numpy batches,
    made on a background thread (the torch DataLoader worker equivalent,
    one process)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    n_full = len(order) // batch_size
    indices = [order[i * batch_size:(i + 1) * batch_size]
               for i in range(n_full)]
    if not drop_last and len(order) % batch_size:
        indices.append(order[n_full * batch_size:])

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()

    def producer():
        for batch_idx in indices:
            imgs = np.stack([dataset[i]["image"] for i in batch_idx])
            msks = np.stack([dataset[i]["mask"] for i in batch_idx])
            q.put((imgs, msks))
        q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        yield item
