"""The port's ViT-Det SAM against its plain float32 oracle
(``models/vitdet_oracle.py``, written from segment-anything), on the CPU at
a small size with seeded random weights: one whole layer period of the
encoder (three windowed blocks and one global block), a 16x16 token map
that the 5-wide windows must pad to 20x20, relative-position tables of
another length than the blocks' (resized by both), a nonzero position
embedding, biases and norms, the neck and the no-prompt decoder.

The port in float32 is within 1e-5 of the oracle's largest logit. In
bfloat16, the label gap ratio (the mean gap between the float32 oracle's
best logit and its logit at the served class, over the same gap of the
oracle run in bfloat16) stays under the limit of the benchmark's SAM cell,
and the port served with int8 weights exceeds it.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tee_optical_flow_torch.models import vitdet_oracle as vo
from tee_optical_flow_torch.models.image_encoder import ImageEncoderViT
from tee_optical_flow_torch.models.registry import init_weights
from tee_optical_flow_torch.models.sam import Sam, make_clip_segmentor

ROOT = Path(__file__).resolve().parents[1]
# image size, width, depth, heads, window, global blocks: a 16x16 token map
SIZE, WIDTH, DEPTH, HEADS, WINDOW, GLOBAL = 256, 64, 4, 4, 5, (3,)
# the blocks whose tables are longer than 2 * size - 1
RESIZED = ("blocks.1.", "blocks.3.")


def _state(seed=0):
    """A float32 model's state dict with random tables, position
    embedding, biases and norms."""
    model = _model(torch.float32, seed)
    g = torch.Generator().manual_seed(seed + 1)
    state = model.state_dict()
    for k, v in state.items():
        if k.endswith(("rel_pos_h", "rel_pos_w")):
            n = v.shape[0] + (4 if k.startswith(
                tuple("image_encoder." + b for b in RESIZED)) else 0)
            state[k] = torch.randn((n, v.shape[1]), generator=g) * 0.5
        elif k.endswith("pos_embed"):
            state[k] = torch.randn(v.shape, generator=g) * 0.5
        elif k.endswith(".bias") or ("norm" in k and k.endswith("weight")):
            state[k] = v + torch.randn(v.shape, generator=g) * 0.1
    return state


def _model(dtype, seed=0, state=None):
    encoder = ImageEncoderViT(img_size=SIZE, embed_dim=WIDTH, depth=DEPTH,
                              num_heads=HEADS, window_size=WINDOW,
                              global_attn_indexes=GLOBAL, dtype=dtype)
    model = Sam(encoder, num_classes=3, image_size=SIZE, dtype=dtype)
    init_weights(model, seed)
    if state is not None:
        for k, v in state.items():
            if "rel_pos" in k:
                owner, name = k.rsplit(".", 1)
                setattr(model.get_submodule(owner), name,
                        torch.nn.Parameter(v.clone()))
        model.load_state_dict(state)
    return model.eval()


def _images(seed=0, n=8):
    frames = np.random.default_rng(seed).integers(0, 255, (n, 48, 64),
                                                  dtype=np.uint8)
    return vo.preprocess(torch.from_numpy(frames), SIZE)


def _oracle(state, images):
    return vo.sam_logits(state, images, num_heads=HEADS,
                         global_attn_indexes=GLOBAL, window_size=WINDOW)


def test_the_case_covers_what_it_is_named_for():
    grid = SIZE // 16
    assert grid % WINDOW and DEPTH == GLOBAL[-1] + 1
    state = _state()
    for block in RESIZED:
        table = state[f"image_encoder.{block}attn.rel_pos_h"]
        size = grid if int(block.split(".")[1]) in GLOBAL else WINDOW
        assert table.shape[0] != 2 * size - 1


def test_port_in_float32_matches_the_oracle():
    state = _state()
    images = _images()
    with torch.no_grad():
        port, _ = _model(torch.float32, state=state)(images)
        ref = _oracle(state, images)
    assert port.shape == ref.shape == (8, 3, SIZE // 4, SIZE // 4)
    scale = float(ref.abs().max())
    assert float((port - ref).abs().max()) <= 1e-5 * scale


def test_label_gap_ratio_passes_bf16_and_fails_int8():
    with open(ROOT / "benchmark" / "workloads"
              / "sam-vit_h-rvio.clip480.json") as f:
        limit = json.load(f)["limits"]["label_gap_ratio"]
    state = _state()
    images = _images()
    bf16 = _model(torch.bfloat16, state=state)
    with torch.no_grad():
        ref = _oracle(state, images)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            ref_bf16 = _oracle(state, images).float()
        served, _ = bf16(images)
        int8, _ = make_clip_segmentor(bf16, weights_int8=True).forward(
            images)
    gap = vo.label_gap(ref, ref_bf16.argmax(1))
    assert gap > 0
    assert vo.label_gap(ref, served.argmax(1)) / gap < limit
    assert vo.label_gap(ref, int8.argmax(1)) / gap > limit


def test_label_gap_is_zero_at_the_best_class_only():
    logits = torch.tensor([[[[1.0, 3.0]], [[2.0, 0.5]]]])  # (1, 2, 1, 2)
    assert vo.label_gap(logits, torch.tensor([[[1, 0]]])) == 0.0
    assert vo.label_gap(logits, torch.tensor([[[0, 1]]])) \
        == pytest.approx((1.0 + 2.5) / 2)


def test_adapters_are_refused():
    state = dict(_state(), **{"image_encoder.blocks.0.Space_Adapter."
                              "D_fc1.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="adapter"):
        _oracle(state, _images(n=1))


def test_the_oracle_imports_nothing_of_the_port_or_jax():
    tree = ast.parse(Path(vo.__file__).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import of the port"
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}
