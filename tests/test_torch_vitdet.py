"""The PyTorch port's ViT-Det SAM (vit_b/l/h: models/image_encoder.py, the
registry's builders, convert, int8 weights, LoRA sites, the layer-decay
rule, the train step and cli.train --arch vit_b) against the JAX
package's, on the CPU.

The model is a mini ViT-Det: image 64 (a 4x4 token grid), embed 64, depth
2, 2 heads, window 3 (so the 4x4 grid pads to 6x6: four windows), global
attention at block 1, neck and decoder 64 wide, 3 classes. Its JAX
variables are seeded random values of the flax tree (``jax.eval_shape`` of
the init, no flax init run), carried across by
``convert.sam_state_dict_from_flax``.

Tolerances (from CPU runs of these tests):
  * float32 modules: 1e-5 max-abs (the encoder's outputs are of
    magnitude 1-5; measured within 2e-6); ``rel_pos_embed`` 1e-6 (the
    same float32 operations);
  * bfloat16: at least 97% of the argmax labels equal JAX's bf16 labels
    (tests/test_torch_sam.py's bound for vit_t);
  * int8: the quantized leaves' int8 values and scales bit-equal, the
    int8 segmentor's labels equal (float32 compute);
  * one train step: the loss within 1e-6 relative, every gradient within
    1e-4 x its tensor's max-abs (tensors zero in exact arithmetic, the
    attention k-projection biases, under 1e-7 x the largest gradient on
    both sides, as tests/test_torch_train.py states).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tee_optical_flow_torch import config as t_config
from tee_optical_flow_torch.cli import process as t_process
from tee_optical_flow_torch.cli import train as t_cli_train
from tee_optical_flow_torch.exceptions import CheckpointError
from tee_optical_flow_torch.models import image_encoder as t_ie
from tee_optical_flow_torch.models import lora as t_lora
from tee_optical_flow_torch.models import quantize as t_quant
from tee_optical_flow_torch.models import registry as t_registry
from tee_optical_flow_torch.models.convert import (
    load_torch_checkpoint, sam_state_dict_from_flax,
)
from tee_optical_flow_torch.models.sam import Sam, make_clip_segmentor
from tee_optical_flow_torch.train import checkpoint as t_checkpoint
from tee_optical_flow_torch.train import loop as t_loop
from tee_optical_flow_torch.train import schedule as t_schedule
from tee_optical_flow_tpu import config as j_config
from tee_optical_flow_tpu.models import convert as j_convert
from tee_optical_flow_tpu.models import image_encoder as j_ie
from tee_optical_flow_tpu.models import lora as j_lora
from tee_optical_flow_tpu.models import quantize as j_quant
from tee_optical_flow_tpu.models import registry as j_registry
from tee_optical_flow_tpu.models import sam as j_sam
from tee_optical_flow_tpu.parallel.mesh import make_mesh
from tee_optical_flow_tpu.train import loop as j_loop
from tee_optical_flow_tpu.train import schedule as j_schedule

torch.set_num_threads(1)

SIZE, OUT, CLASSES = 64, 16, 3
MINI = dict(embed_dim=64, depth=2, num_heads=2, out_chans=64, window_size=3,
            global_attn_indexes=(1,))
ADAPTERS = (0, 1)
F32_ATOL = 1e-5
BF16_AGREE = 0.97
GRAD_REL, GRAD_NOISE = 1e-4, 1e-7


def _random_variables(model, size, seed, batch=1):
    """Seeded random variables of the JAX ``model``'s tree: kernels normal
    with variance 1/fan_in, norm scales 1 + 0.1 N, biases, the position
    embedding and the relative-position tables 0.1 N, the rest N(0, 1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((batch, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "weight"):
            return 1 + 0.1 * z
        if name in ("bias", "pos_embed", "rel_pos_h", "rel_pos_w"):
            return 0.1 * z
        return z

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(fill, shapes))


def _jax_sam(dtype=jnp.float32, adapter_blocks=(), **kw):
    enc = j_ie.ImageEncoderViT(img_size=SIZE, adapter_blocks=adapter_blocks,
                               dtype=dtype, **dict(MINI, **kw))
    return j_sam.Sam(image_encoder=enc, num_classes=CLASSES, image_size=SIZE,
                     embed_dim=64, use_decoder_adapter=bool(adapter_blocks),
                     dtype=dtype)


def _port_sam(variables, dtype=torch.float32, adapter_blocks=(), **kw):
    enc = t_ie.ImageEncoderViT(img_size=SIZE, adapter_blocks=adapter_blocks,
                               dtype=dtype, **dict(MINI, **kw))
    model = Sam(enc, CLASSES, SIZE, embed_dim=64,
                use_decoder_adapter=bool(adapter_blocks), dtype=dtype)
    model.load_state_dict(sam_state_dict_from_flax(variables, CLASSES),
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def mini():
    model = _jax_sam()
    variables = _random_variables(model, SIZE, 1)
    return model, variables, _port_sam(variables)


@pytest.fixture(scope="module")
def adapted():
    model = _jax_sam(adapter_blocks=ADAPTERS)
    variables = _random_variables(model, SIZE, 2)
    return model, variables, _port_sam(variables, adapter_blocks=ADAPTERS)


def _apply(module, variables, *args, **kw):
    return jax.jit(functools.partial(module.apply, **kw))(variables, *args)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _close(ref, got, atol=F32_ATOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _images(seed, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


# --- the encoder, module by module ---------------------------------------------

@pytest.mark.parametrize("n,q,k", [(7, 4, 4), (27, 4, 4), (5, 6, 6),
                                   (7, 2, 3)],
                         ids=["no_resize", "shrink", "grow", "q_ne_k"])
def test_rel_pos_embed_matches_jax(rng, n, q, k):
    table = rng.normal(size=(n, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(j_ie._rel_pos_embed, static_argnums=(1, 2))(
        jnp.asarray(table), q, k))
    _close(ref, t_ie.rel_pos_embed(_t(table), q, k), atol=1e-6)


def test_closest_factors_match_jax():
    assert [t_ie.closest_factors(n) for n in range(1, 40)] == \
        [j_ie._closest_factors(n) for n in range(1, 40)]


@pytest.mark.parametrize("block", [0, 1], ids=["windowed", "global"])
def test_block_matches_jax(mini, rng, block):
    _, variables, port = mini
    x = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    ref = _apply(j_ie.Block(64, 2, window_size=3 if block == 0 else 0,
                            input_size=(4, 4)),
                 {"params": variables["params"]["image_encoder"]
                  [f"block{block}"]}, jnp.asarray(x))
    with torch.no_grad():
        _close(ref, port.image_encoder.blocks[block](_t(x)))


@pytest.mark.parametrize("case", ["plain", "adapters"])
def test_encoder_matches_jax(mini, adapted, case):
    jmodel, variables, port = mini if case == "plain" else adapted
    x = _images(3)
    enc = jmodel.image_encoder
    ref = _apply(enc, {"params": variables["params"]["image_encoder"]},
                 jnp.asarray(x))
    with torch.no_grad():
        got = port.image_encoder(_nchw(x))
    assert got.shape == (2, 64, 4, 4)
    _close(np.asarray(ref).transpose(0, 3, 1, 2), got)


def test_thd_branch_matches_jax():
    """The depth branch at chunk 4 (a 2x2 depth grid, so the block's
    relative-position tables are resized), on 2 volumes of 4 slices;
    a batch that the chunk does not divide raises in both."""
    jenc = j_ie.ImageEncoderViT(img_size=SIZE, thd=True, chunk=4, **MINI)
    jvars = _random_variables(jenc, SIZE, 4, batch=4)
    jsam_like = {"params": {"image_encoder": jvars["params"]}}
    enc = t_ie.ImageEncoderViT(img_size=SIZE, thd=True, chunk=4, **MINI)
    sd = {k[len("image_encoder."):]: v for k, v in _encoder_state(
        jsam_like).items()}
    enc.load_state_dict(sd, strict=True)
    assert "blocks.0.Depth_Adapter.D_fc1.weight" in sd
    x = _images(5, n=8)
    ref = _apply(jenc, jvars, jnp.asarray(x))
    with torch.no_grad():
        _close(np.asarray(ref).transpose(0, 3, 1, 2), enc(_nchw(x)))
    with pytest.raises(ValueError, match="divisible by chunk"):
        jenc.apply(jvars, jnp.asarray(x[:6]))
    with pytest.raises(ValueError, match="divisible by chunk"):
        enc(_nchw(x[:6]))


def _encoder_state(variables):
    """The encoder's part of sam_state_dict_from_flax for a tree that holds
    only ``params.image_encoder``."""
    from tee_optical_flow_torch.models import convert as t_convert

    out = t_convert._StateDict()
    t_convert._vitdet_from_flax(out, variables["params"]["image_encoder"])
    return out.sd


# --- the whole model, bf16, conversion, builders --------------------------------

@pytest.mark.parametrize("case", ["plain", "adapters"])
def test_sam_logits_match_jax(mini, adapted, case):
    jmodel, variables, port = mini if case == "plain" else adapted
    x = _images(6)
    logits_j, iou_j = _apply(jmodel, variables, jnp.asarray(x))
    with torch.no_grad():
        logits_t, iou_t = port(_nchw(x))
    assert logits_t.shape == (2, CLASSES, SIZE // 4, SIZE // 4)
    _close(logits_j, logits_t)
    _close(iou_j, iou_t)


def test_sam_bf16_matches_jax(mini):
    _, variables, _ = mini
    x = _images(7, n=4)
    logits_j, _ = _apply(_jax_sam(jnp.bfloat16), variables, jnp.asarray(x))
    port = _port_sam(variables, torch.bfloat16)
    with torch.no_grad():
        logits_t, _ = port(_nchw(x))
    assert logits_t.dtype == torch.float32
    agree = float(np.mean(np.asarray(logits_j).argmax(1)
                          == logits_t.numpy().argmax(1)))
    assert agree >= BF16_AGREE, agree


def test_state_dict_round_trip(mini, tmp_path):
    """flax -> the port (strict load) -> the JAX package's convert_vitdet,
    prompt encoder and decoder converters -> the same variables, bit for
    bit; a reference-style {"model": state dict} file loads back under
    arch vit_b, and an arch without a converter raises CheckpointError."""
    _, variables, port = mini
    sd = port.state_dict()
    params = jax.tree.map(np.zeros_like, variables["params"])
    j_convert.convert_vitdet(sd, params, depth=MINI["depth"])
    j_convert.convert_prompt_encoder(sd, params)
    j_convert.convert_mask_decoder(sd, params, num_mask_tokens=CLASSES + 1)
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(want) == len(got)
    for path, leaf in want:
        a, b = np.asarray(leaf), np.asarray(got[path])
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    path = str(tmp_path / "checkpoint_best.pth")
    torch.save({"model": sd}, path)
    fresh = _port_sam(_random_variables(_jax_sam(), SIZE, 9))
    load_torch_checkpoint(path, fresh, arch="vit_b")
    for k, v in sd.items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    with pytest.raises(CheckpointError, match="vit_x"):
        load_torch_checkpoint(path, fresh, arch="vit_x")
    with pytest.raises(j_convert.CheckpointError, match="vit_x"):
        j_convert.convert_sam_state_dict(sd, variables, arch="vit_x")


def test_builders_match_jax(monkeypatch):
    """vit_b/l/h: each builder's width, depth, heads and global blocks are
    the JAX package's (its _build_vitdet's arguments); vit_b at image 32
    holds every tensor of the JAX vit_b tree under its torch key and
    shape, in eval mode on the CPU; the default is vit_h."""
    seen = {}
    monkeypatch.setattr(j_registry, "_build_vitdet",
                        lambda *a: seen.setdefault(a[-1], a[:4]))
    monkeypatch.setattr(t_registry, "_build_vitdet",
                        lambda *a: seen.setdefault("port_" + a[0], a[1:5]))
    for arch in ("vit_b", "vit_l", "vit_h"):
        j_registry.sam_model_registry[arch](num_classes=3)
        t_registry.sam_model_registry[arch](num_classes=3)
        assert tuple(seen[arch]) == tuple(seen["port_" + arch]), arch
    assert seen["vit_b"] == (768, 12, 12, (2, 5, 8, 11))
    monkeypatch.undo()
    assert t_registry.sam_model_registry["default"] is \
        t_registry.build_sam_vit_h
    jmodel = j_registry.Sam(
        image_encoder=j_ie.ImageEncoderViT(img_size=32), num_classes=3,
        image_size=32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    ones = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes)
    want = sam_state_dict_from_flax(ones, 3)
    a = t_registry.build_sam_vit_b(num_classes=3, image_size=32, seed=3,
                                   device="cpu")
    sa = a.state_dict()
    assert sorted(sa) == sorted(want)
    assert all(sa[k].shape == want[k].shape for k in want)
    assert not a.training and a.image_encoder.blocks[2].window_size == 0


# --- int8 weights ---------------------------------------------------------------

def test_quantize_matches_jax(mini):
    """The port's quantized leaves are the JAX package's (the same count
    and set once carried to torch names), their int8 values and scales
    bit-equal; every other tensor is the model's own; the diagnostic
    error is the JAX package's."""
    _, variables, port = mini
    jq = j_quant.quantize_variables_int8(variables)
    is_q = lambda x: isinstance(x, j_quant.QuantizedArray)  # noqa: E731

    def carried(fn):
        tree = jax.tree.map(lambda leaf: fn(leaf) if is_q(leaf)
                            else np.full(np.shape(leaf), np.nan, np.float32),
                            jq, is_leaf=is_q)
        return sam_state_dict_from_flax(tree, CLASSES)

    q_ref = carried(lambda a: a.q.astype(np.float32))
    s_ref = carried(lambda a: np.broadcast_to(a.scale, a.q.shape))
    n_jax = len([x for x in jax.tree.leaves(jq, is_leaf=is_q) if is_q(x)])
    state = t_quant.quantize_state_int8(port)
    quantized = {k for k, v in state.items()
                 if isinstance(v, t_quant.QuantizedTensor)}
    assert quantized == {k for k, v in q_ref.items()
                         if not torch.isnan(v).any()}
    assert len(quantized) == n_jax > 10
    own = port.state_dict()
    for k, v in state.items():
        if k in quantized:
            assert v.q.dtype == torch.int8 and v.scale.dtype == torch.float32
            assert torch.equal(v.q.float(), q_ref[k]), k
            assert torch.equal(v.scale.expand_as(v.q), s_ref[k]), k
        else:
            assert v.data_ptr() == own[k].data_ptr(), k
    assert t_quant.quantization_error(port) == \
        j_quant.quantization_error(variables)
    deq = t_quant.dequantize_state(state, torch.bfloat16)
    w = "image_encoder.blocks.0.attn.qkv.weight"
    assert deq[w].dtype == torch.bfloat16
    assert torch.equal(deq[w], (state[w].q.float() * state[w].scale)
                       .to(torch.bfloat16))


def test_int8_segmentor_matches_jax(mini):
    """make_clip_segmentor(weights_int8=True) against the JAX package's
    int8 segmentor (float32 compute on dequantized weights): labels equal
    on a clip with a shifted tail, on both routes; the int8 segmentor
    keeps fewer weight bytes and leaves the model's weights as they
    were."""
    jmodel, variables, port = mini
    frames = (np.random.default_rng(8).uniform(size=(3, 40, 48, 3)) * 255
              ).astype(np.uint8)
    ref = np.asarray(j_sam.make_clip_segmentor(
        jmodel, variables, micro_batch=2, weights_int8=True)(frames))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    seg = make_clip_segmentor(port, micro_batch=2, weights_int8=True)
    np.testing.assert_array_equal(seg(frames), ref)
    np.testing.assert_array_equal(
        seg.labels_device(torch.from_numpy(frames), (40, 48)).numpy(), ref)
    assert all(torch.equal(v, before[k]) for k, v in
               port.state_dict().items())
    full = make_clip_segmentor(port, micro_batch=2)
    assert seg.resident_weight_bytes < 0.4 * full.resident_weight_bytes


def test_int8_segmentor_drops_the_float_weights(mini):
    """The int8 segmentor keeps no reference to the model it was made from
    (its float32 weights are freed with the model) and its copy of the
    model holds empty placeholders where the quantized weights were."""
    import gc
    import weakref

    model = _port_sam(mini[1])
    alive = weakref.ref(model)
    seg = make_clip_segmentor(model, weights_int8=True)
    net, qweights = t_quant.int8_serving_copy(model)
    del model
    gc.collect()
    assert alive() is None and callable(seg)
    params = dict(net.named_parameters())
    assert qweights and all(params[k].numel() == 0 for k in qweights)


# --- LoRA and the layer-decay rule ----------------------------------------------

def test_lora_sites_and_merges_match_jax(mini):
    """The same sites as the JAX package's, the encoder's in its order
    (the JAX walk follows its tree's key order, which jax's tree functions
    sort: the decoder's final attention comes first there); encoder LoRA on
    ViT-Det raises the same ValueError in both at the merge (no head count
    for the encoder's width); decoder-only factors merge to the same
    weights."""
    _, variables, port = mini
    jsites = [t_lora.site_from_flax(s)
              for s in j_lora.init_lora(variables["params"], rank=4)]
    tsites = [s for s, _ in t_lora.iter_attn_sites(port)]
    assert sorted(jsites) == sorted(tsites)
    assert [s for s in jsites if s.startswith("image_encoder.")] == \
        [s for s in tsites if s.startswith("image_encoder.")] == \
        ["image_encoder.blocks.0.attn.qkv", "image_encoder.blocks.1.attn.qkv"]
    jsites = j_lora.init_lora(variables["params"], rank=4)
    with pytest.raises(ValueError, match="no head count known for dim 64"):
        j_lora.merge_lora(variables["params"], jsites)
    with pytest.raises(ValueError, match="no head count known for dim 64"):
        t_lora.merge_lora(dict(port.named_parameters()),
                          t_lora.lora_from_flax(jsites))
    jdec = j_lora.init_lora(variables["params"], rank=4, encoder=False)
    rng = np.random.default_rng(4)
    jdec = {s: {k: np.asarray(v) if k == "a" else 0.05 * rng.normal(
        size=v.shape).astype(np.float32) for k, v in f.items()}
        for s, f in jdec.items()}
    merged = j_lora.merge_lora(jax.tree.map(jnp.asarray, variables["params"]),
                               jax.tree.map(jnp.asarray, jdec))
    want = sam_state_dict_from_flax({"params": jax.tree.map(np.asarray,
                                                            merged)}, CLASSES)
    got = t_lora.merge_lora(dict(port.named_parameters()),
                            t_lora.lora_from_flax(jdec))
    assert len(got) == len(jdec) == 14
    for key, w in got.items():
        np.testing.assert_allclose(w.detach().numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["vit_b_mini", "vit_t"])
def test_layer_decay_scales_match_jax(adapted, arch):
    """Every parameter's scale under decay 0.8: the JAX function on its
    flax path (filled into the tree, carried across) against the port's
    on the port's name. ViT-Det keeps 1.0 everywhere (the JAX rule names
    only TinyViT's layers); vit_t keeps its decayed scales."""
    if arch == "vit_t":
        jmodel = j_sam.Sam(image_encoder=j_registry.TinyViT(img_size=SIZE),
                           num_classes=3, image_size=SIZE)
        port = t_registry.build_sam_vit_t(3, SIZE, device="cpu")
    else:
        jmodel, _, port = adapted
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, j_schedule.
                                   tinyvit_lr_scale_for_path(path, 0.8),
                                   np.float32), dict(shapes))
    carried = sam_state_dict_from_flax(tree, 3)
    scales = []
    for name, _ in port.named_parameters():
        if name.startswith(("image_encoder.norm_head.",
                            "image_encoder.head.")):
            continue
        want = float(carried[name].flatten()[0])
        got = t_schedule.tinyvit_lr_scale_for_name(name, 0.8)
        assert got == pytest.approx(want, rel=1e-6), name
        scales.append(got)
    assert (set(scales) == {1.0}) == (arch != "vit_t")


# --- one train step against the JAX step ----------------------------------------

POLICIES = {
    "vanilla": dict(finetune_type="vanilla", if_update_encoder=True),
    "adapter": dict(finetune_type="adapter", if_update_encoder=True),
    "lora_decoder": dict(finetune_type="lora", if_update_encoder=True),
}


def _capture_tx():
    """An optax transform that applies nothing and keeps the gradients as
    its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def batch():
    images = _images(10)
    yy, xx = np.mgrid[0:OUT, 0:OUT]
    labels = np.stack([
        ((yy - 8) ** 2 + (xx - 7) ** 2 < 20).astype(np.int32) + (xx > 12),
        2 * ((yy - 5) ** 2 + (xx - 9) ** 2 < 16).astype(np.int32)])
    return images, labels.astype(np.int32)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_train_step_matches_jax(adapted, batch, policy):
    """One step of the vanilla policy (encoder updated), of the adapter
    policy (adapters in encoder blocks 0 and 1 and the decoder) and of
    decoder-only LoRA: the loss and every trainable gradient against the
    JAX package's train step."""
    jmodel, variables, _ = adapted
    images, labels = batch
    kw = POLICIES[policy]
    base = dict(num_cls=CLASSES, image_size=SIZE, out_size=OUT)
    jcfg = j_config.TrainConfig(**base, **kw)
    rt = j_loop.TrainConfigRuntime(
        cfg=jcfg, mesh=make_mesh(data_axis=1, devices=jax.devices()[:1]),
        schedule=lambda s: 1e-4, tx=_capture_tx())
    jlora = tlora = None
    if policy == "lora_decoder":
        jlora = j_lora.init_lora(variables["params"], rank=4, encoder=False)
        rng = np.random.default_rng(6)
        jlora = {s: {k: np.asarray(v) if k == "a" else 0.05 * rng.normal(
            size=v.shape).astype(np.float32) for k, v in f.items()}
            for s, f in jlora.items()}
        tlora = t_lora.lora_from_flax(jlora)
    init, step = j_loop.make_train_step(
        jmodel, rt, lora_merge=j_lora.merge_lora if jlora else None, **kw)
    _, _, jgrads, metrics = step(*init(variables, jlora),
                                 jnp.asarray(images), jnp.asarray(labels))
    port = _port_sam(variables, adapter_blocks=ADAPTERS)
    pinit, pstep = t_loop.make_train_step(
        port, t_loop.build_runtime(t_config.TrainConfig(**base, **kw), 1,
                                   device="cpu"), **kw)
    state = pinit(tlora)
    pm, grads = pstep.loss_and_grads(state, images, labels)
    assert float(pm["total_loss"]) == pytest.approx(
        float(metrics["total_loss"]), rel=1e-6)
    jgrads = jax.tree.map(np.asarray, jgrads)
    if jlora:
        want = {f"lora/{s}/{k}": t.detach() for s, f in
                t_lora.lora_from_flax(jgrads).items() for k, t in f.items()}
    else:
        zeros = jax.tree.map(np.zeros_like, variables["params"])
        want = sam_state_dict_from_flax(
            {"params": j_loop.merge_params(jgrads, zeros)}, CLASSES)
    names = [n for n, _ in state.trainable]
    if policy == "adapter":
        assert any("blocks.1.Space_Adapter" in n for n in names)
        assert all("Adapter" in n for n in names)
    gmax = max(float(want[n].abs().max()) for n in names)
    for name in names:
        ref = want[name]
        got = grads.get(name, torch.zeros_like(ref))
        scale = float(ref.abs().max())
        if scale < GRAD_NOISE * gmax:
            assert float(got.abs().max()) < GRAD_NOISE * gmax, name
        else:
            assert float((got - ref).abs().max()) <= GRAD_REL * scale, name


# --- cli.train --arch vit_b -> load_segmentor ------------------------------------

def _png_run(tmp_path, n=2):
    from PIL import Image

    rng = np.random.default_rng(2)
    img, mask = tmp_path / "img", tmp_path / "mask"
    img.mkdir()
    mask.mkdir()
    rows = []
    for i in range(n):
        Image.fromarray((rng.uniform(size=(SIZE, SIZE, 3)) * 255).astype(
            np.uint8)).save(img / f"{i}.png")
        lab = np.zeros((SIZE, SIZE), np.uint8)
        lab[8 + 4 * i:40, 10:44] = 1 + i % 2
        Image.fromarray(lab).save(mask / f"{i}.png")
        rows.append(f"{i}.png,{i}.png")
    lst = tmp_path / "list.csv"
    lst.write_text("\n".join(rows) + "\n")
    return str(img), str(mask), str(lst)


def test_cli_train_vit_b_adapter_then_serve(tmp_path, monkeypatch):
    """cli.train --arch vit_b --finetune_type adapter --if_encoder_adapter
    (adapters on blocks 0 and 11) at image 64 for one step: args.json says
    vit_b, model_kwargs_of_run gives adapter_blocks, and
    load_segmentor(model_dtype="int8") (the registry bound to image 64)
    serves the checkpoint with the labels of the trained model's int8
    segmentor (bfloat16 compute)."""
    pytest.importorskip("PIL", reason="the CLI reads PNG files")
    img, mask, lst = _png_run(tmp_path)
    run = str(tmp_path / "run")
    assert t_cli_train.main([
        "--arch", "vit_b", "--finetune_type", "adapter",
        "--if_encoder_adapter", "--encoder_adapter_depths", "0", "11",
        "--dir_checkpoint", run, "--img_folder", img, "--mask_folder", mask,
        "--train_img_list", lst, "--val_img_list", lst, "--num_cls", "3",
        "--image_size", str(SIZE), "--out_size", str(OUT), "--epochs", "1",
        "-b", "2", "--device", "cpu"]) == 0
    with open(os.path.join(run, "args.json")) as f:
        run_args = json.load(f)
    assert run_args["arch"] == "vit_b"
    assert t_checkpoint.model_kwargs_of_run(run_args) == dict(
        adapter_blocks=(0, 11), use_decoder_adapter=False)
    monkeypatch.setitem(t_registry.sam_model_registry, "vit_b",
                        functools.partial(t_registry.build_sam_vit_b,
                                          image_size=SIZE))
    trained = t_registry.build_sam_vit_b(
        3, SIZE, device="cpu", dtype=torch.bfloat16, adapter_blocks=(0, 11),
        checkpoint=os.path.join(run, "checkpoint_best.pth"))
    assert trained.image_encoder.blocks[11].use_adapter
    frames = (np.random.default_rng(3).integers(0, 256, (3, 48, 40, 3))
              .astype(np.uint8))
    served = t_process.load_segmentor(run, model_dtype="int8",
                                      device="cpu")(frames)
    np.testing.assert_array_equal(
        served, make_clip_segmentor(trained, weights_int8=True)(frames))
