"""The SAM module and batched clip inference (the JAX package's
models/sam.py).

The pipeline's inference recipe (reference evaluate_1_slice,
calculate_optical_flow.py:47-88): resize each frame to image_size^2,
ImageNet-normalise, encoder -> no-prompt prompt encoder -> multimask
decoder -> argmax over classes -> NEAREST resize back to the clip. The
clip goes through in fixed micro-batches, the tail batch shifted to end
on the last frame, so that every batch has one shape.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.imaging import IMAGENET_MEAN, IMAGENET_STD
from ..ops.warp import resize_bilinear
from ..utils.tracing import count, trace_stage
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder
from .quantize import (
    QuantizedTensor, dequantize_state, int8_serving_copy, tensor_bytes,
)


class Sam(nn.Module):
    """image_encoder + prompt_encoder + mask_decoder (keys as the
    reference torch Sam). ``use_decoder_adapter`` gives the decoder
    transformer's blocks their ``MLP_Adapter``."""

    def __init__(self, image_encoder: nn.Module, num_classes: int = 3,
                 image_size: int = 1024, embed_dim: int = 256,
                 use_decoder_adapter: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        grid = image_size // 16
        self.image_size = image_size
        self.dtype = dtype
        self.image_encoder = image_encoder
        self.prompt_encoder = PromptEncoder(
            embed_dim, (grid, grid), (image_size, image_size), 16,
            dtype=dtype)
        self.mask_decoder = MaskDecoder(embed_dim, num_classes,
                                        use_adapter=use_decoder_adapter,
                                        dtype=dtype)

    def forward(self, images: torch.Tensor, points=None, boxes=None,
                masks=None, multimask_output: bool = True,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, 3, S, S), already normalised -> (logits (B, K, S/4,
        S/4) float32, iou_pred (B, K)). ``train`` normalises the
        encoder's batch norms by the batch (the JAX package's
        ``Sam.__call__(train=)``); see models/common.Conv2d_BN. The
        encoder runs as one ``sam_encoder`` span, the prompt encoder and
        the decoder as one ``mask_decoder`` span (utils/tracing)."""
        with trace_stage("sam_encoder"):
            embeddings = self.image_encoder(images, train=train)
        with trace_stage("mask_decoder"):
            sparse, dense = self.prompt_encoder(points, boxes, masks,
                                                batch_size=images.shape[0])
            return self.mask_decoder(embeddings, self.prompt_encoder.
                                     get_dense_pe(), sparse, dense,
                                     multimask_output=multimask_output)


def preprocess_frames(frames: torch.Tensor, image_size: int = 1024
                      ) -> torch.Tensor:
    """(B, H, W, 3) or single-channel (B, H, W) uint8 -> (B, 3, S, S)
    float32, ImageNet-normalised (reference: PIL resize to S^2, ToTensor,
    Normalize).

    The resize is ``jax.image.resize(method="bilinear")``'s
    (ops/warp.resize_bilinear: its antialiased weights when a frame
    shrinks). A single-channel clip is resized before the channel
    broadcast, a third of the work."""
    x = frames.to(torch.float32) / 255.0
    s = image_size
    if x.ndim == 3:
        x = resize_bilinear(x, s, s)[:, None]
    else:
        b, h, w, c = x.shape
        x = resize_bilinear(x.permute(0, 3, 1, 2).reshape(b * c, h, w), s, s)
        x = x.reshape(b, c, s, s)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device).reshape(1, 3, 1, 1)
    std = torch.from_numpy(IMAGENET_STD).to(x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def _batch_starts(n: int, micro_batch: int):
    """Chunk starts, the tail shifted back so that every chunk holds
    ``micro_batch`` frames (a clip shorter than one chunk gives [0])."""
    if n < micro_batch:
        return [0]
    return [min(start, n - micro_batch) for start in range(0, n, micro_batch)]


def _stitch(outs, n: int, micro_batch: int) -> torch.Tensor:
    """Concatenate chunk outputs and drop the shifted tail's overlap or a
    short clip's padding."""
    pred = torch.cat(outs, dim=0)
    if n < micro_batch:
        return pred[:n]
    if pred.shape[0] != n:
        tail_keep = n - (pred.shape[0] - micro_batch)
        return torch.cat([pred[:-micro_batch], pred[-tail_keep:]], dim=0)
    return pred


def _nearest_idx(pred_hw, th: int, tw: int):
    """Row and column indices of a NEAREST resize of pred_hw to (th, tw)
    (PIL's NEAREST, as the reference resizes the argmax back)."""
    yi = (np.arange(th) * pred_hw[0] // th).clip(0, pred_hw[0] - 1)
    xi = (np.arange(tw) * pred_hw[1] // tw).clip(0, pred_hw[1] - 1)
    return yi, xi


def make_clip_segmentor(model: Sam, out_hw: Optional[Tuple[int, int]] = None,
                        micro_batch: int = 4, mesh=None,
                        weights_int8: bool = False
                        ) -> Callable[[np.ndarray], np.ndarray]:
    """A callable (N, H, W, 3) uint8 host frames -> (N, H, W) uint8 labels,
    running ``model`` on the device its parameters lie on.

    Frames go through in micro-batches of ``micro_batch`` (a short clip's
    one batch padded with its last frame); the argmax'd S/4 x S/4
    prediction is NEAREST-resized to ``out_hw`` or the clip's size. The
    callable also carries ``labels_device(clip, clip_hw)``: the same on a
    clip that already lies on the device, (N, H, W) single-channel or
    (N, H, W, 3), returning the labels on the device.

    ``weights_int8`` stores the weight of every dense layer and
    convolution as symmetric per-output-channel int8 (models/quantize.py)
    and dequantizes it into the model's compute type inside each
    micro-batch's forward: the int8 values and their scales are what stays
    on the device, the compute-type copy lives for one forward. The
    segmentor then runs a copy of ``model`` without those weights
    (``model`` itself is not changed: drop it to free its weights). The
    callable's ``resident_weight_bytes`` is the bytes of the weights it
    keeps on the device (parameters and buffers; int8 values and scales
    with ``weights_int8``), and its ``forward`` the model's forward as it
    runs it (normalised (B, 3, S, S) images -> (logits, iou)).

    With ``mesh`` (parallel/mesh.py) the segmentor runs frame-axis data
    parallel over the mesh's 'data' axis, the multi-device serving analog
    of flow/pipeline.compute_clip_flow_sharded: one replica of the model
    (or of its int8 serving copy) on each distinct device of
    ``mesh.data_devices`` (a device named twice shares one; the model's
    own device keeps ``model``), each micro-batch split into one chunk of
    ``micro_batch / mesh.shape['data']`` frames per entry, run on that
    entry's device, and the labels gathered in frame order (on the host,
    or with ``labels_device`` on the clip's device). Frames are
    independent, so the labels are the single-device segmentor's up to
    the convolution algorithms a smaller batch may pick. A micro-batch
    not divisible by the data axis raises ShardingError. The
    ``resident_weight_bytes`` count every replica.

    The counter ``segmentor_frames`` (utils/tracing) adds the frames each
    micro-batch runs through the encoder: a short clip's padding and the
    shifted tail's overlap included."""
    model.eval()
    device = next(model.parameters()).device
    if mesh is not None:
        from ..exceptions import ShardingError

        if micro_batch % mesh.shape["data"]:
            raise ShardingError(
                f"micro_batch={micro_batch} not divisible by the mesh "
                f"data axis ({mesh.shape['data']})")
        devices = mesh.data_devices
    else:
        devices = [device]
    if weights_int8:
        net, qweights = int8_serving_copy(model)
        dtype = net.dtype
    else:
        net = model
    replicas = {}
    resident = 0
    for dev in dict.fromkeys(devices):
        net_d = net if dev == device else copy.deepcopy(net).to(dev)
        if weights_int8:
            q_d = {k: QuantizedTensor(v.q.to(dev), v.scale.to(dev))
                   for k, v in qweights.items()}
            kept = [t for n, t in net_d.state_dict().items()
                    if n not in q_d]
            resident += tensor_bytes(kept + list(q_d.values()))

            def forward(x: torch.Tensor, net_d=net_d, q_d=q_d):
                return torch.func.functional_call(
                    net_d, dequantize_state(q_d, dtype), (x,))
        else:
            resident += tensor_bytes(net_d.state_dict().values())
            forward = net_d
        replicas[dev] = forward
    share = micro_batch // len(devices)

    @torch.no_grad()
    def run_batch(chunk: torch.Tensor, home: torch.device) -> torch.Tensor:
        count("segmentor_frames", chunk.shape[0])
        outs = []
        for k, dev in enumerate(devices):
            part = chunk[k * share:(k + 1) * share].to(dev)
            with torch.cuda.device(dev) if dev.type == "cuda" \
                    else contextlib.nullcontext():
                logits, _ = replicas[dev](preprocess_frames(
                    part, net.image_size))
                outs.append(torch.argmax(logits, dim=1).to(torch.uint8))
        return torch.cat([o.to(home) for o in outs])

    def _labels(clip: torch.Tensor, th: int, tw: int,
                home: torch.device) -> torch.Tensor:
        n = clip.shape[0]
        outs = []
        for s in _batch_starts(n, micro_batch):
            chunk = clip[s:s + micro_batch]
            if chunk.shape[0] < micro_batch:
                reps = micro_batch - chunk.shape[0]
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    reps, *chunk.shape[1:])], dim=0)
            outs.append(run_batch(chunk, home))
        pred = _stitch(outs, n, micro_batch)
        yi, xi = _nearest_idx(pred.shape[1:3], th, tw)
        yi = torch.from_numpy(yi).to(pred.device)
        xi = torch.from_numpy(xi).to(pred.device)
        return pred.index_select(1, yi).index_select(2, xi)

    def labels_device(clip_dev: torch.Tensor, clip_hw: Tuple[int, int]
                      ) -> torch.Tensor:
        """(N, H, W[, 3]) uint8 on the device -> (N, th, tw) uint8 labels
        on the clip's device; a constructor ``out_hw`` overrides
        ``clip_hw``."""
        th, tw = out_hw or clip_hw
        return _labels(clip_dev, th, tw, clip_dev.device)

    def segment(frames: np.ndarray) -> np.ndarray:
        frames = np.ascontiguousarray(frames)
        th, tw = out_hw or frames.shape[1:3]
        return _labels(torch.from_numpy(frames), th, tw,
                       devices[0]).cpu().numpy()

    segment.labels_device = labels_device
    segment.resident_weight_bytes = resident
    segment.forward = replicas[devices[0]]
    return segment
