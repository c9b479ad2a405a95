"""The PyTorch port's SAM predictor, ResizeLongestSide, the automatic mask
generator and export (models/{predictor,transforms,amg,export}.py)
against the JAX package's, on the CPU.

The model is the mini ViT-Det of tests/test_torch_vitdet.py (image 64,
embed 64, depth 2, window 3, global attention at block 1, 3 classes), its
JAX variables seeded random values of the flax tree carried across by
``convert.sam_state_dict_from_flax``.

Tolerances (from CPU runs of these tests): the resized images equal but
for rounding ties (a resampled value within 1e-3 of k + 0.5 may round
either way; measured 1 pixel of 10,176); the point grids, crop boxes, mask boxes, RLEs and NMS picks are equal; the image
embedding, the low-resolution logits and the IoU predictions within 1e-5
(float32 in another order); the masks equal (the logits' signs agree
away from ties, and the random model's logits are not near zero there);
the exported program's labels and IoUs equal to the eager model's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tee_optical_flow_torch.models import amg as t_amg
from tee_optical_flow_torch.models import export as t_export
from tee_optical_flow_torch.models.convert import sam_state_dict_from_flax
from tee_optical_flow_torch.models.image_encoder import ImageEncoderViT
from tee_optical_flow_torch.models.predictor import SamPredictor
from tee_optical_flow_torch.models.sam import Sam
from tee_optical_flow_torch.models.transforms import ResizeLongestSide
from tee_optical_flow_tpu.models import amg as j_amg
from tee_optical_flow_tpu.models import image_encoder as j_ie
from tee_optical_flow_tpu.models import predictor as j_pred
from tee_optical_flow_tpu.models import sam as j_sam
from tee_optical_flow_tpu.models import transforms as j_tr

torch.set_num_threads(1)

SIZE, CLASSES = 64, 3
MINI = dict(embed_dim=64, depth=2, num_heads=2, out_chans=64, window_size=3,
            global_attn_indexes=(1,))
ATOL = 1e-5
TIE = 1e-3


def _random_variables(model, seed):
    """Seeded random variables of the JAX ``model``'s tree (as in
    tests/test_torch_vitdet.py)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
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


@pytest.fixture(scope="module")
def mini():
    jmodel = j_sam.Sam(image_encoder=j_ie.ImageEncoderViT(img_size=SIZE,
                                                          **MINI),
                       num_classes=CLASSES, image_size=SIZE, embed_dim=64)
    variables = _random_variables(jmodel, 1)
    port = Sam(ImageEncoderViT(img_size=SIZE, **MINI), CLASSES, SIZE,
               embed_dim=64)
    port.load_state_dict(sam_state_dict_from_flax(variables, CLASSES),
                         strict=True)
    return jmodel, variables, port.eval()


def _image(seed, h, w):
    return (np.random.default_rng(seed).uniform(size=(h, w, 3)) * 255
            ).astype(np.uint8)


# --- ResizeLongestSide ------------------------------------------------------------

def _equal_but_ties(got, want, image):
    """Equal, but for pixels whose resampled float value lies within
    TIE of a rounding boundary (k + 0.5): there the two float32 sums,
    taken in another order, may round to neighbouring integers (measured
    1 pixel of 10,176 when 96x80 shrinks to 64x53)."""
    ref = np.asarray(jax.image.resize(jnp.asarray(image, jnp.float32),
                                      want.shape, method="bilinear"))
    diff = got != want
    near = np.abs(ref - np.floor(ref) - 0.5) < TIE
    assert np.all(near[diff]), np.argwhere(diff & ~near)[:5]
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= 1


@pytest.mark.parametrize("hw", [(40, 56), (96, 80), (64, 64)],
                         ids=["grow", "shrink", "same"])
def test_resize_longest_side_matches_jax(hw):
    image = _image(1, *hw)
    jt, tt = j_tr.ResizeLongestSide(SIZE), ResizeLongestSide(SIZE)
    for img in (image, image[..., 0]):
        want = jt.apply_image(img)
        got = tt.apply_image(img)
        assert got.dtype == np.uint8 and got.shape == want.shape
        _equal_but_ties(got, want, img)
    coords = np.random.default_rng(2).uniform(0, 50, size=(5, 2))
    np.testing.assert_array_equal(tt.apply_coords(coords, hw),
                                  jt.apply_coords(coords, hw))
    np.testing.assert_array_equal(tt.apply_boxes(coords[:4].reshape(-1), hw),
                                  jt.apply_boxes(coords[:4].reshape(-1), hw))
    assert tt.get_preprocess_shape(*hw, 1024) == \
        jt.get_preprocess_shape(*hw, 1024)


# --- SamPredictor -----------------------------------------------------------------

@pytest.fixture(scope="module")
def predictors(mini):
    jmodel, variables, port = mini
    jp = j_pred.SamPredictor(jmodel, jax.tree.map(jnp.asarray, variables))
    tp = SamPredictor(port)
    image = _image(3, 40, 56)
    jp.set_image(image)
    tp.set_image(image)
    return jp, tp


def test_set_image_matches_jax(predictors):
    jp, tp = predictors
    assert tp.original_size == jp.original_size
    assert tuple(tp.input_size) == tuple(jp.input_size) == (46, 64)
    emb = tp.get_image_embedding()
    assert emb.shape == (1, 64, 4, 4)
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(jp.get_image_embedding()).transpose(
            0, 3, 1, 2), rtol=0, atol=ATOL)


PROMPTS = {
    "none": dict(),
    "points": dict(point_coords=np.array([[10.0, 20.0], [40.0, 8.0]]),
                   point_labels=np.array([1, 0])),
    "box_and_point": dict(point_coords=np.array([[30.0, 15.0]]),
                          point_labels=np.array([1]),
                          box=np.array([5.0, 4.0, 50.0, 30.0])),
    "mask_single": dict(mask_input="mask", multimask_output=False),
}


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_predict_matches_jax(predictors, prompt):
    jp, tp = predictors
    kw = dict(PROMPTS[prompt])
    if kw.get("mask_input") == "mask":
        kw["mask_input"] = np.random.default_rng(4).normal(
            size=(SIZE // 4, SIZE // 4)).astype(np.float32)
    masks_j, iou_j, low_j = jp.predict(**kw)
    masks_t, iou_t, low_t = tp.predict(**kw)
    k = 1 if prompt == "mask_single" else CLASSES
    assert masks_t.shape == (k, 40, 56) and masks_t.dtype == bool
    assert low_t.shape == (k, SIZE // 4, SIZE // 4)
    np.testing.assert_allclose(low_t, np.asarray(low_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(iou_t, np.asarray(iou_j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(masks_t, masks_j)


def test_predict_needs_an_image(mini):
    with pytest.raises(RuntimeError, match="set_image"):
        SamPredictor(mini[2]).predict()


# --- amg --------------------------------------------------------------------------

def test_amg_utilities_match_jax(rng):
    masks = rng.normal(size=(5, 12, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        t_amg.calculate_stability_score(masks, 0.0, 0.5),
        j_amg.calculate_stability_score(masks, 0.0, 0.5))
    np.testing.assert_array_equal(t_amg.build_point_grid(4),
                                  j_amg.build_point_grid(4))
    for a, b in zip(t_amg.build_all_layer_point_grids(8, 2, 2),
                    j_amg.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(a, b)
    assert t_amg.generate_crop_boxes((48, 64), 2, 512 / 1500) == \
        j_amg.generate_crop_boxes((48, 64), 2, 512 / 1500)
    binary = masks > 0.8
    binary[2] = False
    np.testing.assert_array_equal(t_amg.batched_mask_to_box(binary),
                                  j_amg.batched_mask_to_box(binary))
    for m in binary:
        rle = t_amg.mask_to_rle(m)
        assert rle == j_amg.mask_to_rle(m)
        np.testing.assert_array_equal(t_amg.rle_to_mask(rle), m)
    boxes = np.sort(rng.uniform(0, 20, size=(8, 2, 2)), axis=1).reshape(8, 4)
    scores = rng.uniform(size=8)
    np.testing.assert_array_equal(t_amg.box_nms(boxes, scores, 0.3),
                                  j_amg.box_nms(boxes, scores, 0.3))
    data = t_amg.MaskData(a=np.arange(4), b=[10, 11, 12, 13])
    data.filter(np.array([True, False, True, True]))
    data.cat(t_amg.MaskData(a=np.array([7]), b=[17], c=np.zeros(1)))
    assert data["a"].tolist() == [0, 2, 3, 7]
    assert data["b"] == [10, 12, 13, 17] and sorted(data.keys()) == [
        "a", "b", "c"]


def test_mask_generator_matches_jax(mini):
    """The generator's records on a 2x2 point grid, every prompt kept by
    its filters (thresholds below any score), then NMS: the same records
    with the same masks, RLEs, areas, boxes and points; the predicted
    IoUs within 1e-5."""
    jmodel, variables, port = mini
    kw = dict(points_per_side=2, pred_iou_thresh=-1e9,
              stability_score_thresh=-1.0, box_nms_thresh=0.7)
    image = _image(5, 48, 40)
    want = j_amg.SamAutomaticMaskGenerator(
        j_pred.SamPredictor(jmodel, jax.tree.map(jnp.asarray, variables)),
        **kw).generate(image)
    got = t_amg.SamAutomaticMaskGenerator(SamPredictor(port),
                                          **kw).generate(image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
        assert g["rle"] == w["rle"] and g["area"] == w["area"]
        assert g["bbox"] == w["bbox"]
        assert g["point_coords"] == w["point_coords"]
        assert g["predicted_iou"] == pytest.approx(w["predicted_iou"],
                                                   abs=ATOL)


# --- export -----------------------------------------------------------------------

def test_export_round_trip(mini, tmp_path):
    """torch.export of the no-prompt multimask forward: the saved program,
    loaded back, gives the eager model's labels and IoUs; the bytes are a
    torch.export archive."""
    _, _, port = mini
    path = t_export.save_exported(port, str(tmp_path / "sam.pt2"), batch=2)
    loaded = t_export.load_exported(path)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 3, SIZE, SIZE)).astype(np.float32))
    labels, iou = loaded(x)
    with torch.no_grad():
        logits, iou_ref = port(x)
    assert labels.dtype == torch.uint8 and labels.shape == (2, 16, 16)
    assert torch.equal(labels, logits.argmax(1).to(torch.uint8))
    assert torch.equal(iou, iou_ref)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"
