"""Model export for serving (the JAX package's models/export.py).

The reference ships an ONNX-exportable decoder wrapper
(finetune-SAM/models/sam/utils/onnx.py SamOnnxModel); the JAX package
serializes its jitted forward as StableHLO with ``jax.export``. The port
uses ``torch.export``: ``export_forward`` traces the no-prompt multimask
forward (images -> argmax labels, iou) into an ``ExportedProgram`` and
returns its bytes (``torch.export.save``), ``load_exported`` loads one
back as a callable module (``torch.export.load(...).module()``).

The two artifacts are not interchangeable: a ``jax.export`` artifact
holds StableHLO for an XLA runtime and takes (B, S, S, 3) images, a
``torch.export`` one holds an ATen graph for PyTorch and takes (B, 3, S,
S) images; neither loads the other.
"""

from __future__ import annotations

import io
from typing import Optional

import torch
import torch.nn as nn


class _Forward(nn.Module):
    """images (B, 3, S, S), normalised -> (labels (B, S/4, S/4) uint8,
    iou (B, K))."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor):
        logits, iou = self.model(images, multimask_output=True)
        return torch.argmax(logits, dim=1).to(torch.uint8), iou


def export_forward(model: nn.Module, image_size: Optional[int] = None,
                   batch: int = 1) -> bytes:
    """The serialized ``ExportedProgram`` of ``model``'s no-prompt forward
    at ``batch`` images of ``image_size`` (the model's by default), traced
    on the model's device."""
    size = image_size or model.image_size
    device = next(model.parameters()).device
    example = torch.zeros(batch, 3, size, size, device=device)
    with torch.no_grad():
        program = torch.export.export(_Forward(model.eval()), (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_exported(model: nn.Module, path: str, **kw) -> str:
    data = export_forward(model, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_exported(path: str):
    """The callable module of a saved export."""
    return torch.export.load(path).module()
