"""Weight-only int8 for SAM inference (the JAX package's
models/quantize.py).

Scheme: symmetric per-output-channel int8 on the weight of every
``nn.Linear``, ``nn.Conv2d`` and ``nn.ConvTranspose2d`` (the leaves the
JAX package quantizes: every flax ``kernel`` with ndim >= 2) and on
nothing else. Biases, norms, the position embedding, the relative
position tables, TinyViT's attention biases, the prompt encoder's
embeddings and Gaussian matrix and the decoder's tokens stay float32:
they are added, not multiplied, so an absolute error there would go
straight into the activations. The output channel is dim 0 of a
``Linear`` (out, in) and a ``Conv2d`` (out, in, kh, kw) weight and dim 1
of a ``ConvTranspose2d`` (in, out, kh, kw) weight (the decoder's
``output_upscaling``). Scales and int8 values are computed in numpy
float32 with the JAX package's operations, so they are bit-equal to its
``quantize_variables_int8`` on the same weights. (The reference TinyViT's
classifier head, which SAM never runs and the JAX tree does not hold, is
an ``nn.Linear`` and is quantized with the rest.)

``make_clip_segmentor(weights_int8=True)`` keeps the int8 values and
scales on the card and dequantizes into the compute type inside each
micro-batch's forward (``dequantize_state`` through
``torch.func.functional_call``): the compute-type copy lives for one
forward.
"""

from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn as nn


class QuantizedTensor(NamedTuple):
    """int8 values and float32 per-output-channel scales; ``scale`` has
    the weight's rank, 1 on every axis but the output channel's."""

    q: torch.Tensor
    scale: torch.Tensor


State = Dict[str, Union[torch.Tensor, QuantizedTensor]]


def quantized_weights(model: nn.Module) -> List[Tuple[str, int]]:
    """(name of the weight, its output-channel dim) of every quantized
    leaf of ``model``, in module order."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) \
                and m.weight.is_floating_point() and m.weight.ndim >= 2:
            axis = 1 if isinstance(m, nn.ConvTranspose2d) else 0
            out.append((f"{name}.weight" if name else "weight", axis))
    return out


def quantize_array(w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """(int8 values, float32 scales) of ``w`` per channel along ``axis``:
    the JAX package's ``_quantize_leaf`` arithmetic (numpy float32)."""
    x32 = np.asarray(w, np.float32)
    reduce_axes = tuple(a for a in range(x32.ndim) if a != axis)
    amax = np.max(np.abs(x32), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x32 / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_state_int8(model: nn.Module) -> State:
    """``model``'s state dict with every quantized leaf replaced by a
    :class:`QuantizedTensor` on the leaf's device; the other tensors are
    the model's own."""
    state: State = dict(model.state_dict())
    for name, axis in quantized_weights(model):
        w = state[name]
        q, scale = quantize_array(w.detach().cpu().numpy(), axis)
        state[name] = QuantizedTensor(torch.from_numpy(q).to(w.device),
                                      torch.from_numpy(scale).to(w.device))
    return state


def dequantize_state(state: State, dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Each :class:`QuantizedTensor` of ``state`` as ``dtype``: the int8
    values times the float32 scale, then the cast (scaling after the cast
    would round twice), on the values' device; other entries unchanged."""
    return {k: ((v.q.to(torch.float32) * v.scale).to(dtype)
                if isinstance(v, QuantizedTensor) else v)
            for k, v in state.items()}


def quantization_error(model: nn.Module) -> float:
    """The largest round-trip error of a quantized leaf over its own
    largest magnitude (the JAX package's diagnostic; symmetric int8 keeps
    it under 0.5/127)."""
    err = 0.0
    params = dict(model.named_parameters())
    for name, axis in quantized_weights(model):
        w = params[name].detach().cpu().numpy().astype(np.float32)
        q, scale = quantize_array(w, axis)
        deq = q.astype(np.float32) * scale
        amax = np.maximum(np.max(np.abs(w)), 1e-12)
        err = max(err, float(np.max(np.abs(deq - w)) / amax))
    return err


def int8_serving_copy(model: nn.Module) -> Tuple[nn.Module,
                                                 Dict[str, QuantizedTensor]]:
    """(a copy of ``model`` whose quantized weights are empty
    placeholders, those weights quantized): what the int8 segmentor keeps
    on the device. The copy runs only through ``functional_call`` with
    the dequantized weights; ``model`` is left as it was."""
    names = dict(quantized_weights(model))
    params = dict(model.named_parameters())
    memo = {id(params[n]): nn.Parameter(
        torch.empty(0, device=params[n].device), requires_grad=False)
        for n in names}
    skeleton = copy.deepcopy(model, memo)
    state = quantize_state_int8(model)
    return skeleton, {n: state[n] for n in names}


def tensor_bytes(tensors) -> int:
    """Bytes held by an iterable of tensors and QuantizedTensors."""
    total = 0
    for t in tensors:
        parts = t if isinstance(t, QuantizedTensor) else (t,)
        total += sum(p.numel() * p.element_size() for p in parts)
    return total
