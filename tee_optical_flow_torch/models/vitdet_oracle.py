"""Plain float32 forward of SAM with the ViT-Det image encoder (vit_b, vit_l,
vit_h): the oracle the port's ViT-Det segmentor is held to.

Written from facebookresearch/segment-anything's ``modeling/
image_encoder.py`` (``ImageEncoderViT``, ``Block``, ``Attention``,
``window_partition``, ``window_unpartition``, ``get_rel_pos``,
``add_decomposed_rel_pos``), ``prompt_encoder.py``
(``PositionEmbeddingRandom``, the no-prompt branch of ``PromptEncoder``),
``mask_decoder.py`` (``MaskDecoder.predict_masks``, ``MLP``),
``transformer.py`` (``TwoWayTransformer``, ``TwoWayAttentionBlock``,
``Attention``) and ``common.py`` (``LayerNorm2d``, ``MLPBlock``), with the
decoder's ``num_multimask_outputs`` set to the number of classes, as
finetune-SAM builds it for the reference system (``cfg.py --arch vit_h``).
Plain torch operations on a state dict with the reference torch keys (the
port's ``Sam.state_dict()``); it imports nothing of the port and no JAX.
Every product runs in float32: ``sam_logits`` turns TF32 off for matrix
products and cuDNN while it runs.

Departures from the published code:

  * the no-prompt path only: empty sparse embeddings and the
    ``no_mask_embed`` dense embedding, which is all the pipeline asks;
  * a batch of images, each with its own no-prompt tokens: the decoder adds
    each image's dense embedding to its own image embedding, where the
    published decoder repeats one image's embedding over a batch of
    prompts (finetune-SAM's decoder does the same when the two batches
    agree);
  * global attention (``window_size`` 0) is computed one head at a time,
    so that the scores of 4,096 tokens fit; windowed attention whole;
  * the output is the multimask low-resolution logits (B, K, S/4, S/4),
    mask tokens 1..K, with no ``postprocess_masks`` upscaling and no IoU
    head: the pipeline takes the argmax of these logits;
  * ``preprocess`` is the pipeline's input (the reference system's
    evaluate_1_slice): the frame resized to S x S bilinearly
    (``F.interpolate``, half-pixel centres, antialiased when shrinking),
    scaled to [0, 1] and ImageNet-normalised, in place of
    segment-anything's ``ResizeLongestSide``, its 0-255 pixel mean and its
    padding;
  * no PEFT adapters: a state dict that holds adapter weights raises
    ValueError.

NOT for production use: float32 throughout, head by head. The production
path is ``models/sam.py`` with ``models/image_encoder.py``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def preprocess(frames: torch.Tensor, image_size: int) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 3) uint8 frames -> (B, 3, S, S) float32:
    resized bilinearly to S x S, scaled to [0, 1], ImageNet-normalised. A
    single-channel frame is resized, then repeated over three channels."""
    x = frames.to(torch.float32) / 255.0
    x = x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(image_size, image_size), mode="bilinear",
                      align_corners=False, antialias=True)
    if x.shape[1] == 1:
        x = x.expand(-1, 3, -1, -1)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


# --- the image encoder (segment-anything modeling/image_encoder.py) ----------

def window_partition(x: torch.Tensor, window_size: int):
    """(B, H, W, C) -> windows (B * nW, ws, ws, C), zero-padded to whole
    windows, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window_size, window_size, wp // window_size,
               window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window_size: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """Windows back to (B, H, W, C), the padding removed."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.view(b, hp // window_size, wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """The relative positional embeddings of a query and key size, the
    table linearly interpolated where its length is not 2 * max - 1."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear")
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size,
                                                          1.0)
    return resized[relative.long().to(resized.device)]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor,
                           rh: torch.Tensor, rw: torch.Tensor,
                           q_size: Tuple[int, int], k_size: Tuple[int, int]
                           ) -> torch.Tensor:
    """attn (B, q_h * q_w, k_h * k_w) plus the decomposed relative
    position bias of q (B, q_h * q_w, C)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    return (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b, q_h * q_w, k_h * k_w)


def attention(x: torch.Tensor, p: Dict[str, torch.Tensor], num_heads: int,
              head_by_head: bool) -> torch.Tensor:
    """segment-anything's ViT ``Attention`` with the decomposed relative
    position bias on (B, H, W, C); ``p`` holds its weights by their names
    under ``attn.``."""
    b, h, w, _ = x.shape
    n = h * w
    qkv = F.linear(x, p["qkv.weight"], p["qkv.bias"]).reshape(
        b, n, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * num_heads, n, -1).unbind(0)
    hd = q.shape[-1]
    scale = hd ** -0.5
    rh = get_rel_pos(h, h, p["rel_pos_h"])
    rw = get_rel_pos(w, w, p["rel_pos_w"])
    if head_by_head:
        q, k, v = (t.reshape(b, num_heads, n, hd) for t in (q, k, v))
        outs = []
        for head in range(num_heads):
            qh = q[:, head]
            attn = (qh * scale) @ k[:, head].transpose(-2, -1)
            attn = add_decomposed_rel_pos(attn, qh, rh, rw, (h, w), (h, w))
            outs.append(attn.softmax(dim=-1) @ v[:, head])
        out = torch.stack(outs, dim=1)
    else:
        attn = (q * scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, rh, rw, (h, w), (h, w))
        out = (attn.softmax(dim=-1) @ v).view(b, num_heads, n, hd)
    out = out.view(b, num_heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(
        b, h, w, -1)
    return F.linear(out, p["proj.weight"], p["proj.bias"])


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """segment-anything's ``LayerNorm2d`` over the channels of (B, C, H,
    W)."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return weight[:, None, None] * x + bias[:, None, None]


def _sub(state: Dict[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def image_encoder(state: Dict[str, torch.Tensor], x: torch.Tensor, *,
                  num_heads: int, global_attn_indexes: Sequence[int],
                  window_size: int = 14, patch_size: int = 16
                  ) -> torch.Tensor:
    """``ImageEncoderViT``: (B, 3, S, S) -> (B, 256, S/16, S/16);
    ``state`` holds the encoder's weights by their names under
    ``image_encoder.``."""
    x = F.conv2d(x, state["patch_embed.proj.weight"],
                 state["patch_embed.proj.bias"], stride=patch_size)
    x = x.permute(0, 2, 3, 1) + state["pos_embed"]
    depth = 1 + max(int(k.split(".")[1]) for k in state
                    if k.startswith("blocks."))
    for i in range(depth):
        p = _sub(state, f"blocks.{i}.")
        ws = 0 if i in global_attn_indexes else window_size
        shortcut = x
        x = F.layer_norm(x, x.shape[-1:], p["norm1.weight"], p["norm1.bias"],
                         1e-6)
        if ws > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, ws)
        x = attention(x, _sub(p, "attn."), num_heads, head_by_head=ws == 0)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        x = shortcut + x
        y = F.layer_norm(x, x.shape[-1:], p["norm2.weight"], p["norm2.bias"],
                         1e-6)
        y = F.linear(F.gelu(F.linear(y, p["mlp.lin1.weight"],
                                     p["mlp.lin1.bias"])),
                     p["mlp.lin2.weight"], p["mlp.lin2.bias"])
        x = x + y
    x = x.permute(0, 3, 1, 2)
    x = layer_norm_2d(F.conv2d(x, state["neck.0.weight"]),
                      state["neck.1.weight"], state["neck.1.bias"])
    return layer_norm_2d(F.conv2d(x, state["neck.2.weight"], padding=1),
                         state["neck.3.weight"], state["neck.3.bias"])


# --- the prompt encoder's no-prompt branch and the mask decoder ---------------

def dense_pe(gaussian: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``PositionEmbeddingRandom.forward((h, w))``: (C, h, w)."""
    grid = torch.ones((h, w), device=gaussian.device, dtype=gaussian.dtype)
    y_embed = (grid.cumsum(dim=0) - 0.5) / h
    x_embed = (grid.cumsum(dim=1) - 0.5) / w
    coords = 2 * torch.stack([x_embed, y_embed], dim=-1) - 1
    coords = 2 * math.pi * (coords @ gaussian)
    return torch.cat([torch.sin(coords), torch.cos(coords)],
                     dim=-1).permute(2, 0, 1)


def _attend(p: Dict[str, torch.Tensor], q, k, v, num_heads: int
            ) -> torch.Tensor:
    """transformer.py's ``Attention`` (with its downsampled projections)."""
    q = F.linear(q, p["q_proj.weight"], p["q_proj.bias"])
    k = F.linear(k, p["k_proj.weight"], p["k_proj.bias"])
    v = F.linear(v, p["v_proj.weight"], p["v_proj.bias"])

    def separate(t):
        b, n, c = t.shape
        return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)

    q, k, v = separate(q), separate(k), separate(v)
    attn = q @ k.permute(0, 1, 3, 2) / math.sqrt(q.shape[-1])
    out = torch.softmax(attn, dim=-1) @ v
    b, heads, n, c = out.shape
    out = out.transpose(1, 2).reshape(b, n, heads * c)
    return F.linear(out, p["out_proj.weight"], p["out_proj.bias"])


def _norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"])


def two_way_transformer(state: Dict[str, torch.Tensor], image_embedding,
                        image_pe, point_embedding, num_heads: int = 8):
    """``TwoWayTransformer``: -> (queries (B, N, C), keys (B, h*w, C))."""
    keys = image_embedding.flatten(2).permute(0, 2, 1)
    key_pe = image_pe.flatten(2).permute(0, 2, 1)
    queries = point_embedding
    query_pe = point_embedding
    depth = 1 + max(int(k.split(".")[1]) for k in state
                    if k.startswith("layers."))
    for i in range(depth):
        p = _sub(state, f"layers.{i}.")
        if i == 0:  # skip_first_layer_pe
            queries = _attend(_sub(p, "self_attn."), queries, queries,
                              queries, num_heads)
        else:
            q = queries + query_pe
            queries = queries + _attend(_sub(p, "self_attn."), q, q,
                                        queries, num_heads)
        queries = _norm(queries, p, "norm1")
        q, k = queries + query_pe, keys + key_pe
        queries = queries + _attend(_sub(p, "cross_attn_token_to_image."),
                                    q, k, keys, num_heads)
        queries = _norm(queries, p, "norm2")
        mlp = F.linear(F.relu(F.linear(queries, p["mlp.lin1.weight"],
                                       p["mlp.lin1.bias"])),
                       p["mlp.lin2.weight"], p["mlp.lin2.bias"])
        queries = _norm(queries + mlp, p, "norm3")
        q, k = queries + query_pe, keys + key_pe
        keys = keys + _attend(_sub(p, "cross_attn_image_to_token."), k, q,
                              queries, num_heads)
        keys = _norm(keys, p, "norm4")
    q, k = queries + point_embedding, keys + key_pe
    queries = queries + _attend(_sub(state, "final_attn_token_to_image."),
                                q, k, keys, num_heads)
    return _norm(queries, state, "norm_final_attn"), keys


def _mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """mask_decoder.py's ``MLP``: ReLU between the layers."""
    n = 1 + max(int(k.split(".")[1]) for k in p if k.startswith("layers."))
    for j in range(n):
        x = F.linear(x, p[f"layers.{j}.weight"], p[f"layers.{j}.bias"])
        if j < n - 1:
            x = F.relu(x)
    return x


def mask_decoder(state: Dict[str, torch.Tensor], image_embeddings, image_pe,
                 dense) -> torch.Tensor:
    """``MaskDecoder.predict_masks`` with no sparse prompts, then the
    multimask slice: (B, K, 4h, 4w) logits."""
    b = image_embeddings.shape[0]
    tokens = torch.cat([state["iou_token.weight"],
                        state["mask_tokens.weight"]], dim=0)
    num_mask_tokens = state["mask_tokens.weight"].shape[0]
    tokens = tokens[None].expand(b, -1, -1)
    src = image_embeddings + dense
    _, c, h, w = src.shape
    hs, src = two_way_transformer(_sub(state, "transformer."), src, image_pe,
                                  tokens)
    mask_tokens_out = hs[:, 1:1 + num_mask_tokens, :]
    src = src.transpose(1, 2).reshape(b, c, h, w)
    up = F.conv_transpose2d(src, state["output_upscaling.0.weight"],
                            state["output_upscaling.0.bias"], stride=2)
    up = F.gelu(layer_norm_2d(up, state["output_upscaling.1.weight"],
                              state["output_upscaling.1.bias"]))
    up = F.gelu(F.conv_transpose2d(up, state["output_upscaling.3.weight"],
                                   state["output_upscaling.3.bias"],
                                   stride=2))
    hyper_in = torch.stack([
        _mlp(_sub(state, f"output_hypernetworks_mlps.{i}."),
             mask_tokens_out[:, i, :]) for i in range(num_mask_tokens)],
        dim=1)
    b, c, h, w = up.shape
    masks = (hyper_in @ up.view(b, c, h * w)).view(b, -1, h, w)
    return masks[:, 1:]


# --- the whole model -----------------------------------------------------------

def sam_logits(state: Dict[str, torch.Tensor], images: torch.Tensor, *,
               num_heads: int, global_attn_indexes: Sequence[int],
               window_size: int = 14) -> torch.Tensor:
    """SAM's no-prompt multimask forward: normalised (B, 3, S, S) images
    -> (B, K, S/4, S/4) float32 logits, K the number of classes, from a
    state dict with the reference torch keys (``Sam.state_dict()``), on
    the images' device, with TF32 off."""
    if any("Adapter" in k for k in state):
        raise ValueError("vitdet_oracle: the state dict holds PEFT adapter "
                         "weights, which the oracle does not run")
    state = {k: v.to(images.device, torch.float32) for k, v in state.items()}
    with _no_tf32():
        emb = image_encoder(_sub(state, "image_encoder."),
                            images.to(torch.float32), num_heads=num_heads,
                            global_attn_indexes=global_attn_indexes,
                            window_size=window_size)
        b, c, h, w = emb.shape
        pe = dense_pe(state["prompt_encoder.pe_layer."
                            "positional_encoding_gaussian_matrix"], h, w)
        dense = state["prompt_encoder.no_mask_embed.weight"].reshape(
            1, -1, 1, 1).expand(b, -1, h, w)
        return mask_decoder(_sub(state, "mask_decoder."), emb, pe[None],
                            dense)


def label_gap(ref_logits: torch.Tensor, labels: torch.Tensor) -> float:
    """The mean, over every pixel, of the reference's best logit less its
    logit at the served label: ref_logits (N, K, H, W), labels (N, H, W)
    class indices in [0, K)."""
    best = ref_logits.amax(dim=1)
    served = torch.gather(ref_logits, 1, labels[:, None].to(torch.int64))
    return float((best - served[:, 0]).to(torch.float64).mean())
