"""Weights into the port's SAM.

``sam_state_dict_from_flax`` carries a JAX package variables tree (numpy
arrays) across to the port: the inverse of that package's
``convert_tinyvit``, ``convert_prompt_encoder`` and
``convert_mask_decoder`` (its models/convert.py), and of
``convert_vitdet`` for the ViT-Det encoders, giving a state dict
under the reference torch keys that ``Sam.load_state_dict(strict=True)``
takes; ``prompt_autoencoder_state_dict_from_flax`` does the same for the
JAX package's ``PromptAutoEncoder`` (the inverse of its
``convert_prompt_autoencoder``). Layouts:

  flax Conv kernel (kH, kW, I, O)            -> torch (O, I, kH, kW)
  flax depthwise kernel (k, k, 1, C)         -> torch (C, 1, k, k)
  flax ConvTranspose kernel (k, k, I, O),    -> torch (I, O, k, k), after
    spatially flipped                           flipping it back
  flax Dense kernel (I, O)                   -> torch Linear weight (O, I)
  params bn.{scale, bias} + batch_stats      -> BatchNorm weight, bias,
    bn.{mean, var}                              running_mean, running_var
  adapter {down, up} (space_adapter,         -> D_fc1, D_fc2 of
    mlp_adapter, depth_adapter)                 Space_Adapter, MLP_Adapter,
                                                Depth_Adapter

``load_torch_checkpoint`` loads a reference ``.pth`` (the fine-tuned
checkpoint_best.pth or the public mobile_sam.pt), whose keys the port's
modules already use.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..exceptions import CheckpointError


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class _StateDict:
    def __init__(self) -> None:
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value) -> None:
        self.sd[key] = torch.from_numpy(np.array(value, np.float32,
                                                  copy=True))

    def conv(self, key: str, p) -> None:
        # (kH, kW, I, O) -> (O, I, kH, kW); depthwise (k, k, 1, C) the same
        self.put(key + ".weight", _f32(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.put(key + ".bias", p["bias"])

    def conv_transpose(self, key: str, p) -> None:
        self.put(key + ".weight",
                 _f32(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        self.put(key + ".bias", p["bias"])

    def dense(self, key: str, p) -> None:
        self.put(key + ".weight", _f32(p["kernel"]).T)
        if "bias" in p:
            self.put(key + ".bias", p["bias"])

    def norm(self, key: str, p) -> None:
        """flax LayerNorm (scale, bias) -> weight, bias."""
        self.put(key + ".weight", p["scale"])
        self.put(key + ".bias", p["bias"])

    def norm2d(self, key: str, p) -> None:
        self.put(key + ".weight", p["weight"])
        self.put(key + ".bias", p["bias"])

    def adapter(self, key: str, p) -> None:
        self.dense(key + ".D_fc1", p["down"])
        self.dense(key + ".D_fc2", p["up"])

    def conv_bn(self, key: str, p, s) -> None:
        self.conv(key + ".c", p["c"])
        self.put(key + ".bn.weight", p["bn"]["scale"])
        self.put(key + ".bn.bias", p["bn"]["bias"])
        self.put(key + ".bn.running_mean", s["bn"]["mean"])
        self.put(key + ".bn.running_var", s["bn"]["var"])
        self.sd[key + ".bn.num_batches_tracked"] = torch.tensor(0)


def _depth(tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _tinyvit_from_flax(out: _StateDict, enc, enc_s,
                       head_classes: int) -> None:
    p = "image_encoder."
    out.conv_bn(p + "patch_embed.seq.0", enc["patch_embed_conv1"],
                enc_s["patch_embed_conv1"])
    out.conv_bn(p + "patch_embed.seq.2", enc["patch_embed_conv2"],
                enc_s["patch_embed_conv2"])
    for i in range(_depth(enc, "stage0_block")):
        name = f"stage0_block{i}"
        for conv in ("conv1", "conv2", "conv3"):
            out.conv_bn(f"{p}layers.0.blocks.{i}.{conv}", enc[name][conv],
                        enc_s[name][conv])
    for m in range(3):
        for conv in ("conv1", "conv2", "conv3"):
            out.conv_bn(f"{p}layers.{m}.downsample.{conv}",
                        enc[f"merge{m}"][conv], enc_s[f"merge{m}"][conv])
    for stage in (1, 2, 3):
        for i in range(_depth(enc, f"stage{stage}_block")):
            b, bs = enc[f"stage{stage}_block{i}"], enc_s[
                f"stage{stage}_block{i}"]
            t = f"{p}layers.{stage}.blocks.{i}"
            out.norm(t + ".attn.norm", b["attn"]["norm"])
            out.dense(t + ".attn.qkv", b["attn"]["qkv"])
            out.dense(t + ".attn.proj", b["attn"]["proj"])
            out.put(t + ".attn.attention_biases",
                    b["attn"]["attention_biases"])
            out.conv_bn(t + ".local_conv", b["local_conv"], bs["local_conv"])
            out.norm(t + ".mlp.norm", b["mlp_norm"])
            out.dense(t + ".mlp.fc1", b["mlp"]["lin1"])
            out.dense(t + ".mlp.fc2", b["mlp"]["lin2"])
            if "space_adapter" in b:
                out.adapter(t + ".Space_Adapter", b["space_adapter"])
                out.adapter(t + ".MLP_Adapter", b["mlp_adapter"])
    _neck_from_flax(out, enc)
    width = _f32(enc["neck_conv1"]["kernel"]).shape[2]
    out.put(p + "norm_head.weight", np.ones(width))
    out.put(p + "norm_head.bias", np.zeros(width))
    out.put(p + "head.weight", np.zeros((head_classes, width)))
    out.put(p + "head.bias", np.zeros(head_classes))


def _vitdet_from_flax(out: _StateDict, enc) -> None:
    """The inverse of the JAX package's ``convert_vitdet``, with the
    adapters (``space_adapter``, ``mlp_adapter``, ``depth_adapter`` ->
    ``Space_Adapter``, ``MLP_Adapter``, ``Depth_Adapter``)."""
    p = "image_encoder."
    out.conv(p + "patch_embed.proj", enc["patch_embed"])
    out.put(p + "pos_embed", enc["pos_embed"])
    for i in range(_depth(enc, "block")):
        b = enc[f"block{i}"]
        t = f"{p}blocks.{i}"
        out.norm(t + ".norm1", b["norm1"])
        out.norm(t + ".norm2", b["norm2"])
        out.dense(t + ".attn.qkv", b["attn"]["qkv"])
        out.dense(t + ".attn.proj", b["attn"]["proj"])
        if "rel_pos_h" in b["attn"]:
            out.put(t + ".attn.rel_pos_h", b["attn"]["rel_pos_h"])
            out.put(t + ".attn.rel_pos_w", b["attn"]["rel_pos_w"])
        out.dense(t + ".mlp.lin1", b["mlp"]["lin1"])
        out.dense(t + ".mlp.lin2", b["mlp"]["lin2"])
        for flax_name, key in (("space_adapter", "Space_Adapter"),
                               ("mlp_adapter", "MLP_Adapter"),
                               ("depth_adapter", "Depth_Adapter")):
            if flax_name in b:
                out.adapter(f"{t}.{key}", b[flax_name])
    _neck_from_flax(out, enc)


def _neck_from_flax(out: _StateDict, enc) -> None:
    p = "image_encoder."
    out.conv(p + "neck.0", enc["neck_conv1"])
    out.norm2d(p + "neck.1", enc["neck_ln1"])
    out.conv(p + "neck.2", enc["neck_conv2"])
    out.norm2d(p + "neck.3", enc["neck_ln2"])


def sam_state_dict_from_flax(variables: Dict[str, Any], num_classes: int = 3,
                             head_classes: int = 1000
                             ) -> Dict[str, torch.Tensor]:
    """A JAX ``Sam`` variables tree (vit_t, or vit_b/l/h: the encoder's
    tree says which) -> the port's state dict.

    The reference TinyViT's classifier head (``image_encoder.norm_head``,
    ``image_encoder.head``), which SAM never runs and the JAX package
    does not hold, is filled with ones and zeros."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    enc = params["image_encoder"]
    out = _StateDict()
    if "pos_embed" in enc:
        _vitdet_from_flax(out, enc)
    else:
        _tinyvit_from_flax(out, enc, stats["image_encoder"], head_classes)

    pe = params["prompt_encoder"]
    p = "prompt_encoder."
    out.put(p + "pe_layer.positional_encoding_gaussian_matrix",
            pe["pe_layer"]["positional_encoding_gaussian_matrix"])
    for i in range(4):
        out.put(f"{p}point_embeddings.{i}.weight", pe[f"point_embed_{i}"])
    out.put(p + "not_a_point_embed.weight", pe["not_a_point_embed"])
    out.put(p + "no_mask_embed.weight", pe["no_mask_embed"])
    out.conv(p + "mask_downscaling.0", pe["mask_conv1"])
    out.norm2d(p + "mask_downscaling.1", pe["mask_ln1"])
    out.conv(p + "mask_downscaling.3", pe["mask_conv2"])
    out.norm2d(p + "mask_downscaling.4", pe["mask_ln2"])
    out.conv(p + "mask_downscaling.6", pe["mask_conv3"])

    md = params["mask_decoder"]
    p = "mask_decoder."
    n_tokens = _depth(md, "hypernet_")
    if n_tokens != num_classes + 1:
        raise CheckpointError(
            f"the variables hold {n_tokens} mask tokens, num_classes="
            f"{num_classes} needs {num_classes + 1}")
    out.put(p + "iou_token.weight", md["iou_token"])
    out.put(p + "mask_tokens.weight", md["mask_tokens"])
    tf = md["transformer"]
    for i in range(_depth(tf, "layer")):
        lay = tf[f"layer{i}"]
        t = f"{p}transformer.layers.{i}"
        for attn in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out.dense(f"{t}.{attn}.{proj}", lay[attn][proj])
        for n in range(1, 5):
            out.norm(f"{t}.norm{n}", lay[f"norm{n}"])
        out.dense(t + ".mlp.lin1", lay["mlp"]["lin1"])
        out.dense(t + ".mlp.lin2", lay["mlp"]["lin2"])
        if "mlp_adapter" in lay:
            out.adapter(t + ".MLP_Adapter", lay["mlp_adapter"])
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out.dense(f"{p}transformer.final_attn_token_to_image.{proj}",
                  tf["final_attn_token_to_image"][proj])
    out.norm(p + "transformer.norm_final_attn", tf["norm_final_attn"])
    out.conv_transpose(p + "output_upscaling.0", md["upscale_conv1"])
    out.norm2d(p + "output_upscaling.1", md["upscale_ln"])
    out.conv_transpose(p + "output_upscaling.3", md["upscale_conv2"])
    for i in range(n_tokens):
        for j in range(3):
            out.dense(f"{p}output_hypernetworks_mlps.{i}.layers.{j}",
                      md[f"hypernet_{i}"][f"layer{j}"])
    for j in range(3):
        out.dense(f"{p}iou_prediction_head.layers.{j}",
                  md["iou_prediction_head"][f"layer{j}"])
    return out.sd


def prompt_autoencoder_state_dict_from_flax(params: Dict[str, Any]
                                            ) -> Dict[str, torch.Tensor]:
    """A JAX ``PromptAutoEncoder``'s params (numpy) -> the port's
    ``PromptAutoEncoder`` state dict: the inverse of the JAX package's
    ``convert_prompt_autoencoder`` (its ``down_conv1/2/3`` and
    ``down_ln1/2`` onto ``image_downscaling.{0,3,6}`` and ``{1,4}``)."""
    out = _StateDict()
    for idx, name in ((0, "down_conv1"), (3, "down_conv2"),
                      (6, "down_conv3")):
        out.conv(f"image_downscaling.{idx}", params[name])
    out.norm2d("image_downscaling.1", params["down_ln1"])
    out.norm2d("image_downscaling.4", params["down_ln2"])
    return out.sd


ARCHS = ("vit_t", "vit_b", "vit_l", "vit_h")


def load_torch_checkpoint(path: str, model: torch.nn.Module,
                          arch: str = "vit_t") -> torch.nn.Module:
    """Load a reference ``.pth`` into ``model`` with ``strict=True``: a
    state dict, a module, or a dict holding the state dict under
    ``"model"``. A LoRA run's checkpoint (train/checkpoint.py) also holds
    its factors under ``"lora"`` (and the fused-qkv head counts under
    ``"heads_by_dim"``): they are merged into the base weights
    (models/lora.merge_lora). The file is unpickled in full, as the
    reference saves whole objects: load only checkpoints from a trusted
    source. The model's adapters that the checkpoint lacks (one of a
    model without them, such as mobile_sam.pt) keep their own weights;
    every other key must match. ``arch`` is the model's (vit_t or
    vit_b/l/h); any other raises CheckpointError, as the JAX package's
    converter does."""
    if arch not in ARCHS:
        raise CheckpointError(
            f"Converter for arch {arch!r} not implemented yet")
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    lora = sd.get("lora") if isinstance(sd.get("lora"), dict) else None
    heads_by_dim = sd.get("heads_by_dim")
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    if lora:
        from .lora import merge_lora

        sd = dict(sd)
        sd.update(merge_lora(sd, lora, heads_by_dim))
    sd = {**{k: v for k, v in model.state_dict().items()
             if "_Adapter." in k and k not in sd}, **sd}
    model.load_state_dict(sd, strict=True)
    return model
