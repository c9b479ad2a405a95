"""The PyTorch port's SAM (models/) against the JAX package's, on the CPU.

Two architectures: the mini vit_t-shaped arch of tests/conftest.py
(image 64, embed dims (16, 32, 40, 80), embed 64) and the full-width
vit_t at image 128, whose stage 2 (8x8 tokens, 14-token windows) pads to
one 14x14 window. The JAX variables are seeded random values of the
flax trees (biases, norms and batch statistics off their identities) and
are carried across by ``sam_state_dict_from_flax``; the modules are held
one by one, then the whole model, then the clip segmentor.

Tolerances, from CPU runs of these tests: the float32 modules agree with
the JAX ones to float32 rounding (measured max-abs 2.4e-7 to 2.4e-6 on
outputs of magnitude 1-5, 3.5e-6 on vit_t's logits): bound 2e-5 max-abs.
bfloat16 rounds at other places in the two frameworks (XLA may keep
intermediate results in float32), about as far apart as bfloat16 is from
float32 itself: measured against JAX's bf16 run, 100% (mini) and 99.2%
(vit_t) of the argmax labels agree and the logits' max-abs error is 1.0%
and 1.1% of their range (JAX's own bf16 against its float32: 99.4% and
99.3%, 1.0% and 1.0%). Bounds: at least 97% of the labels, error under 4%
of the range.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tee_optical_flow_torch.models.convert import (
    load_torch_checkpoint, sam_state_dict_from_flax,
)
from tee_optical_flow_torch.models.registry import build_sam_vit_t
from tee_optical_flow_torch.models.sam import (
    Sam, make_clip_segmentor, preprocess_frames,
)
from tee_optical_flow_torch.models.tinyvit import TinyViT
from tee_optical_flow_tpu.models import common as jc
from tee_optical_flow_tpu.models import mask_decoder as jmd
from tee_optical_flow_tpu.models import prompt_encoder as jpe
from tee_optical_flow_tpu.models import sam as jsam
from tee_optical_flow_tpu.models import tinyvit as jtv
from tee_optical_flow_tpu.models import transformer as jtr
from tee_optical_flow_tpu.models.convert import convert_sam_state_dict

torch.set_num_threads(1)

F32_ATOL = 2e-5
BF16_AGREE = 0.97
BF16_REL = 0.04

MINI = dict(embed_dims=(16, 32, 40, 80), depths=(1, 1, 2, 1),
            num_heads=(1, 2, 2, 2), window_sizes=(4, 4, 4, 4), neck_dim=64)


def _random_variables(model, size, seed):
    """Seeded random variables of the JAX ``model``'s tree (its shapes
    from ``jax.eval_shape`` of its init, no forward run): kernels normal
    with variance 1/fan_in, norms' scales 1 + 0.1 N(0, 1), biases, batch
    means and the attention biases 0.1 N(0, 1), batch variances
    1 + 0.1 |N(0, 1)|, embeddings and the Gaussian matrix N(0, 1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.normal(size=shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name == "var":
            return 1 + 0.1 * np.abs(z)
        if name in ("scale", "weight"):
            return 1 + 0.1 * z
        if name in ("bias", "mean", "attention_biases"):
            return 0.1 * z
        return z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(variables, arch, dtype=torch.float32):
    if arch == "mini":
        enc = TinyViT(img_size=64, dtype=dtype, **MINI)
        model = Sam(enc, 3, 64, embed_dim=64, dtype=dtype)
    else:
        enc = TinyViT(img_size=128, dtype=dtype)
        model = Sam(enc, 3, 128, dtype=dtype)
    model.load_state_dict(sam_state_dict_from_flax(variables, 3),
                          strict=True)
    return model.eval()


def _jax_model(arch, dtype=jnp.float32):
    if arch == "mini":
        enc = jtv.TinyViT(img_size=64, dtype=dtype, **MINI)
        return jsam.Sam(image_encoder=enc, num_classes=3, image_size=64,
                        embed_dim=64, dtype=dtype)
    return jsam.Sam(image_encoder=jtv.TinyViT(img_size=128, dtype=dtype),
                    num_classes=3, image_size=128, dtype=dtype)


@pytest.fixture(scope="module")
def mini():
    model = _jax_model("mini")
    variables = _random_variables(model, 64, 1)
    return model, variables, _port(variables, "mini")


@pytest.fixture(scope="module")
def vit_t128():
    model = _jax_model("vit_t")
    variables = _random_variables(model, 128, 2)
    return model, variables, _port(variables, "vit_t")


def _apply(module, variables, *args, **kw):
    """``module.apply`` compiled whole (op-by-op dispatch on the CPU
    compiles every operation apart and takes several times longer)."""
    return jax.jit(functools.partial(module.apply, **kw))(variables, *args)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _close(ref, got, atol=F32_ATOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _sub(variables, *path):
    """The flax variables of a submodule."""
    out = {}
    for col in ("params", "batch_stats"):
        node = variables.get(col, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out


@pytest.mark.parametrize("name,path,kw", [
    ("patch_embed 3x3 stride 2", ("patch_embed_conv1",),
     dict(features=8, kernel=3, stride=2, padding=1)),
    ("MBConv 1x1", ("stage0_block0", "conv1"), dict(features=64)),
    ("MBConv depthwise 3x3", ("stage0_block0", "conv2"),
     dict(features=64, kernel=3, padding=1, groups=64)),
])
def test_conv2d_bn_matches_jax(mini, rng, name, path, kw):
    _, variables, port = mini
    mod = {"patch_embed_conv1": port.image_encoder.patch_embed.seq[0],
           "stage0_block0": port.image_encoder.layers[0].blocks[0]}[path[0]]
    if len(path) > 1:
        mod = getattr(mod, path[1])
    cin = 3 if path[0] == "patch_embed_conv1" else kw["features"] // (
        1 if "groups" in kw else 4)
    x = rng.normal(size=(2, 16, 16, cin)).astype(np.float32)
    ref = _apply(jc.ConvBN(**kw), _sub(variables, "image_encoder", *path),
                 jnp.asarray(x))
    with torch.no_grad():
        _close(np.asarray(ref).transpose(0, 3, 1, 2), mod(_nchw(x)))


def test_window_attention_matches_jax(mini, rng):
    _, variables, port = mini
    x = rng.normal(size=(8, 16, 32)).astype(np.float32)
    ref = _apply(jtv.WindowAttention(32, 16, 2, 1.0, 4),
                 _sub(variables, "image_encoder", "stage1_block0", "attn"),
                 jnp.asarray(x))
    with torch.no_grad():
        _close(ref, port.image_encoder.layers[1].blocks[0].attn(_t(x)))


@pytest.mark.parametrize("arch,stage,dim,heads,ws,hw", [
    ("mini", 1, 32, 2, 4, 8),      # four windows
    ("mini", 2, 40, 2, 4, 4),      # one window, no partition
    ("vit_t", 2, 160, 5, 14, 8),   # padded 8 -> 14
])
def test_tinyvit_block_matches_jax(mini, vit_t128, rng, arch, stage, dim,
                                   heads, ws, hw):
    _, variables, port = mini if arch == "mini" else vit_t128
    x = rng.normal(size=(2, hw, hw, dim)).astype(np.float32)
    ref = _apply(jtv.TinyViTBlock(dim, heads, ws),
                 _sub(variables, "image_encoder", f"stage{stage}_block0"),
                 jnp.asarray(x))
    blk = port.image_encoder.layers[stage].blocks[0]
    with torch.no_grad():
        _close(np.asarray(ref).transpose(0, 3, 1, 2), blk(_nchw(x)))


def test_tinyvit_matches_jax(mini, rng):
    _, variables, port = mini
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = _apply(jtv.TinyViT(img_size=64, **MINI),
                 _sub(variables, "image_encoder"), jnp.asarray(x))
    with torch.no_grad():
        _close(np.asarray(ref).transpose(0, 3, 1, 2),
               port.image_encoder(_nchw(x)))


@pytest.mark.parametrize("prompt", ["none", "points", "boxes", "mask"])
def test_prompt_encoder_matches_jax(mini, rng, prompt):
    _, variables, port = mini
    fpe = jpe.PromptEncoder(embed_dim=64, image_embedding_size=(4, 4),
                            input_image_size=(64, 64))
    v = _sub(variables, "prompt_encoder")
    pe = port.prompt_encoder
    kw_j, kw_t = {}, {}
    if prompt == "points":
        pts = rng.uniform(0, 64, size=(2, 3, 2)).astype(np.float32)
        lab = np.asarray([[1, 0, -1], [0, 1, 1]], np.float32)
        kw_j["points"] = (jnp.asarray(pts), jnp.asarray(lab))
        kw_t["points"] = (_t(pts), _t(lab))
    elif prompt == "boxes":
        boxes = rng.uniform(0, 64, size=(2, 4)).astype(np.float32)
        kw_j["boxes"], kw_t["boxes"] = jnp.asarray(boxes), _t(boxes)
    elif prompt == "mask":
        m = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
        kw_j["masks"], kw_t["masks"] = jnp.asarray(m), _nchw(m)
    sparse_j, dense_j = _apply(fpe, v, batch_size=2, **kw_j)
    pe_j = _apply(fpe, v, method=fpe.get_dense_pe)
    with torch.no_grad():
        sparse_t, dense_t = pe(batch_size=2, **kw_t)
        _close(sparse_j, sparse_t)
        _close(np.asarray(dense_j).transpose(0, 3, 1, 2), dense_t)
        _close(np.asarray(pe_j).transpose(2, 0, 1)[None], pe.get_dense_pe())


def test_two_way_transformer_matches_jax(mini, rng):
    _, variables, port = mini
    emb = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    pe = rng.normal(size=(4, 4, 64)).astype(np.float32)
    tok = rng.normal(size=(2, 5, 64)).astype(np.float32)
    q_j, k_j = _apply(jtr.TwoWayTransformer(embedding_dim=64),
                      _sub(variables, "mask_decoder", "transformer"),
                      jnp.asarray(emb), jnp.asarray(pe)[None],
                      jnp.asarray(tok))
    with torch.no_grad():
        q_t, k_t = port.mask_decoder.transformer(
            _nchw(emb), _t(pe.transpose(2, 0, 1)[None]), _t(tok))
    _close(q_j, q_t)
    _close(k_j, k_t)


def test_mask_decoder_matches_jax(mini, rng):
    _, variables, port = mini
    emb = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    pe = rng.normal(size=(4, 4, 64)).astype(np.float32)
    sparse = rng.normal(size=(2, 2, 64)).astype(np.float32)
    dense = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    m_j, iou_j = _apply(jmd.MaskDecoder(transformer_dim=64),
                        _sub(variables, "mask_decoder"), jnp.asarray(emb),
                        jnp.asarray(pe), jnp.asarray(sparse),
                        jnp.asarray(dense))
    with torch.no_grad():
        m_t, iou_t = port.mask_decoder(
            _nchw(emb), _t(pe.transpose(2, 0, 1)[None]), _t(sparse),
            _nchw(dense))
    assert m_t.shape == (2, 3, 16, 16) and m_t.dtype == torch.float32
    _close(m_j, m_t)
    _close(iou_j, iou_t)


@pytest.mark.parametrize("arch", ["mini", "vit_t"])
def test_sam_logits_match_jax(mini, vit_t128, rng, arch):
    model, variables, port = mini if arch == "mini" else vit_t128
    size = 64 if arch == "mini" else 128
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    logits_j, iou_j = _apply(model, variables, jnp.asarray(x))
    with torch.no_grad():
        logits_t, iou_t = port(_nchw(x))
    assert logits_t.shape == (2, 3, size // 4, size // 4)
    _close(logits_j, logits_t)
    _close(iou_j, iou_t)


@pytest.mark.parametrize("arch", ["mini", "vit_t"])
def test_sam_bf16_matches_jax(mini, vit_t128, rng, arch):
    """The same weights computing in bfloat16 on both sides (float32
    parameters, the JAX package's cast points): label agreement and the
    logits' max-abs error against their range."""
    _, variables, _ = mini if arch == "mini" else vit_t128
    size = 64 if arch == "mini" else 128
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    logits_j, _ = _apply(_jax_model(arch, jnp.bfloat16), variables,
                         jnp.asarray(x))
    port = _port(variables, arch, torch.bfloat16)
    with torch.no_grad():
        logits_t, _ = port(_nchw(x))
    assert logits_t.dtype == torch.float32
    ref = np.asarray(logits_j, np.float32)
    got = logits_t.numpy()
    agree = float(np.mean(ref.argmax(1) == got.argmax(1)))
    rel = float(np.abs(got - ref).max() / (ref.max() - ref.min()))
    assert agree >= BF16_AGREE and rel < BF16_REL, (agree, rel)


@pytest.mark.parametrize("hw", [(40, 48), (96, 80)], ids=["grow", "shrink"])
def test_preprocess_frames_matches_jax(rng, hw):
    """Growing to 64 and shrinking to 64 (jax.image.resize antialiases
    when it shrinks; the port uses its weights); the single-channel route
    equals the RGB route of the same gray frames."""
    frames = (rng.uniform(size=(2, *hw, 3)) * 255).astype(np.uint8)
    ref = np.asarray(jsam.preprocess_frames(jnp.asarray(frames), 64))
    got = preprocess_frames(torch.from_numpy(frames), 64)
    assert got.shape == (2, 3, 64, 64)
    _close(ref.transpose(0, 3, 1, 2), got, atol=1e-5)
    gray = np.ascontiguousarray(frames[..., 0])
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    np.testing.assert_array_equal(
        preprocess_frames(torch.from_numpy(gray), 64).numpy(),
        preprocess_frames(torch.from_numpy(rgb), 64).numpy())


@pytest.fixture(scope="module")
def segmentors(mini):
    model, variables, port = mini
    return ({None: jsam.make_clip_segmentor(model, variables, micro_batch=2),
             (30, 20): jsam.make_clip_segmentor(model, variables,
                                                out_hw=(30, 20),
                                                micro_batch=2)},
            {None: make_clip_segmentor(port, micro_batch=2),
             (30, 20): make_clip_segmentor(port, out_hw=(30, 20),
                                           micro_batch=2)})


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("out_hw", [None, (30, 20)], ids=["clip", "out_hw"])
def test_clip_segmentor_matches_jax(segmentors, rng, n, out_hw):
    """Labels against JAX for a clip shorter than one micro-batch, one
    with a shifted tail and one with two full batches and a tail, on the
    host route and on labels_device (RGB and single-channel clips)."""
    jseg, tseg = segmentors[0][out_hw], segmentors[1][out_hw]
    gray = (rng.uniform(size=(n, 40, 48)) * 255).astype(np.uint8)
    frames = np.repeat(gray[..., None], 3, axis=-1)
    ref = np.asarray(jseg(frames))
    got = tseg(frames)
    assert got.shape == ref.shape == (n, *(out_hw or (40, 48)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    for clip in (frames, gray):
        dev = tseg.labels_device(torch.from_numpy(clip), (40, 48))
        np.testing.assert_array_equal(dev.numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(jseg.labels_device(jnp.asarray(gray), (40, 48))), ref)


def test_state_dict_round_trip(vit_t128, tmp_path):
    """JAX variables -> the port (strict load) -> the JAX package's own
    converter -> the same variables, bit for bit: the port holds every
    tensor under the reference torch key the converter reads. And a
    reference-style checkpoint file ({"model": state dict}) loads back."""
    _, variables, port = vit_t128
    back = convert_sam_state_dict(port.state_dict(), variables,
                                  arch="vit_t", num_classes=3)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        a, b = np.asarray(leaf), np.asarray(got[path])
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    path = str(tmp_path / "checkpoint_best.pth")
    torch.save({"model": port.state_dict()}, path)
    fresh = build_sam_vit_t(num_classes=3, image_size=128, seed=5,
                            device="cpu")
    load_torch_checkpoint(path, fresh)
    for k, v in port.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k


def test_build_sam_vit_t_is_seeded():
    a = build_sam_vit_t(num_classes=3, image_size=64, seed=3, device="cpu")
    b = build_sam_vit_t(num_classes=3, image_size=64, seed=3, device="cpu")
    c = build_sam_vit_t(num_classes=3, image_size=64, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["image_encoder.patch_embed.seq.0.c.weight"],
                           sc["image_encoder.patch_embed.seq.0.c.weight"])
    assert a.mask_decoder.num_mask_tokens == 4
    assert not a.training
