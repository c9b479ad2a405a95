"""The SAM cell's pieces on the CPU: its operation count against
FlopCounterMode, its readers, and small runs of the cell with the timed
path broken underneath, one fault for each check it adds.

A small run builds a ViT-Det SAM of the configuration's kind at a size the
CPU holds (128x128 images, 64 wide, 4 blocks with global attention at the
last, windows of 5 on an 8x8 token map) in place of the registry's vit_h,
and runs the clip driver's small traffic through it."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import counts_sam, harness
from benchmark.drivers import sam_clip
from conftest import SMALL_TRAFFIC

CELL = "sam-vit_h-rvio.clip480"
SMALL_MODEL = dict(image_size=128, embed_dim=64, depth=4, num_heads=4,
                   head_dim=16, window_size=5, global_attn_indexes=[3])
NEW_METRICS = ("sam_encoder_s.sam", "global_attn_s.sam",
               "segmentor_frames.sam", "labelling_rounds.sam",
               "idle_share.sam", "mfu.sam", "global_attn_roofline.sam",
               "decode_s.sam", "prep_s.sam", "segmentation_s.sam",
               "labelling_s.sam", "optical_flow_s.sam", "host_syncs.sam")
# the stages the clip path's own span readers take, by metric
STAGES = {"decode_s.sam": "dicom_read", "prep_s.sam": "clip_prep",
          "segmentation_s.sam": "segmentation", "labelling_s.sam": "labelling",
          "optical_flow_s.sam": "optical_flow"}


def _small_model(model_cfg, device):
    from tee_optical_flow_torch.models.image_encoder import ImageEncoderViT
    from tee_optical_flow_torch.models.sam import Sam

    dtype = getattr(torch, model_cfg["dtype"])
    encoder = ImageEncoderViT(
        img_size=model_cfg["image_size"], embed_dim=model_cfg["embed_dim"],
        depth=model_cfg["depth"], num_heads=model_cfg["num_heads"],
        window_size=model_cfg["window_size"],
        global_attn_indexes=tuple(model_cfg["global_attn_indexes"]),
        dtype=dtype)
    model = Sam(encoder, num_classes=model_cfg["num_classes"],
                image_size=model_cfg["image_size"], dtype=dtype)
    return model.to(device).eval()


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(sam_clip, "build_model", _small_model)

    def run(seed=5, control=None, trace=False):
        cell = copy.deepcopy(harness.load_cell(CELL))
        cell["traffic_data"].update(SMALL_TRAFFIC)
        cell["config_data"]["model"].update(SMALL_MODEL)
        return sam_clip.run(cell, seed=seed, seconds=0.0, trace=trace,
                            device="cpu", t_start=0.0, control=control)
    return run


def test_the_cell_is_a_new_set_of_files():
    cell = harness.load_cell(CELL)
    assert harness.driver(cell) is sam_clip
    assert cell["control"] in sam_clip.CONTROLS
    assert cell["config_data"]["reduced"] == []
    model = cell["config_data"]["model"]
    assert (model["embed_dim"], model["depth"], model["num_heads"],
            model["window_size"], model["global_attn_indexes"]) \
        == (1280, 32, 16, 14, [7, 15, 23, 31])
    assert model["embed_dim"] // model["num_heads"] == model["head_dim"]
    assert model["embed_dim"] * model["mlp_ratio"] == model["mlp_dim"]
    with open(harness.HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    mine = [m for m in bench["per_layer"] if m["name"] in NEW_METRICS]
    assert len(mine) == len(NEW_METRICS)
    assert all(m["workloads"] == [CELL] for m in mine)


@pytest.mark.parametrize("size", [
    dict(image_size=128, embed_dim=64, depth=4, num_heads=4, window_size=5,
         global_attn_indexes=[3], num_classes=3, micro_batch=2),
    dict(image_size=96, embed_dim=32, depth=3, num_heads=2, window_size=4,
         global_attn_indexes=[0, 2], num_classes=2, micro_batch=3)])
def test_the_count_is_flop_counter_modes(size):
    """The shapes' count against torch's FlopCounterMode over one forward
    of the port's model (grad on: its module hooks need it)."""
    from torch.utils.flop_counter import FlopCounterMode

    model_cfg = dict(size, patch_size=16, mlp_ratio=4.0, out_chans=256,
                     dtype="float32")
    model = _small_model(model_cfg, "cpu")
    images = torch.randn(size["micro_batch"], 3, size["image_size"],
                         size["image_size"])
    with FlopCounterMode(display=False) as counter:
        model(images)
    assert counter.get_total_flops() == counts_sam.forward_flops(
        model_cfg, size["micro_batch"])


def test_vit_h_counts():
    """vit_h's frame: 5.9647 TFLOP (the smoke's FlopCounterMode reading of
    the whole segmentor, resize included, was 5.9663); a global block's
    attention on 4 frames is operation-bound, 0.3527 ms."""
    model = harness.load_cell(CELL)["config_data"]["model"]
    assert counts_sam.flop_per_frame(model) == pytest.approx(5.9647e12,
                                                             rel=1e-4)
    assert counts_sam.global_attn_least_s(model) == pytest.approx(
        0.35270e-3, rel=1e-4)


def _sam_record(**kw):
    return dict({"driver": "sam_clip", "clip_s": 10.3, "timed_clip_s": 4.7,
                 "profiled_clip_s": 4.8,
                 "stages": {"sam_encoder": 3.8, "global_attn": 1.0,
                            "dicom_read": 0.05, "clip_prep": 0.07,
                            "segmentation": 3.9, "labelling": 0.06,
                            "optical_flow": 0.35},
                 "stage_calls": {"global_attn": 40.0},
                 "trace": {"busy_s": 4.6, "window_s": 5.0},
                 "real_frames": 33, "flop_per_frame": 5.9647e12,
                 "global_attn_least_s": 40 * 0.3527e-3}, **kw)


def test_the_readers_leave_other_drivers_alone():
    readers = harness.metric_readers()
    clip_record = {"driver": "clip", "clip_s": 0.6, "timed_clip_s": 0.6,
                   "stages": {"sam_encoder": 1.0, "global_attn": 1.0,
                              **{stage: 1.0 for stage in STAGES.values()}},
                   "trace": {"busy_s": 0.5, "window_s": 1.0},
                   "real_frames": 33, "flop_per_frame": 1.0,
                   "global_attn_least_s": 1.0}
    for name in NEW_METRICS:
        assert readers[name].read(clip_record) is None, name
    got = {name: readers[name].read(_sam_record()) for name in NEW_METRICS}
    assert got["sam_encoder_s.sam"] == 3.8
    assert got["global_attn_s.sam"] == 1.0
    assert got["idle_share.sam"] == pytest.approx(8.0)
    assert got["mfu.sam"] == pytest.approx(
        100 * 33 * 5.9647e12 / 4.7 / 989.4e12)
    assert got["global_attn_roofline.sam"] == pytest.approx(1.4108)
    for name, stage in STAGES.items():
        assert got[name] == _sam_record()["stages"][stage], name
    # with no clip timed outside the profiler, the profiled clip's time
    assert readers["mfu.sam"].read(_sam_record(timed_clip_s=None)) \
        == pytest.approx(100 * 33 * 5.9647e12 / 4.8 / 989.4e12)
    # a program without the spans: the readers find nothing
    bare = _sam_record(stages={}, global_attn_least_s=0.0)
    for name in ("sam_encoder_s.sam", "global_attn_s.sam",
                 "global_attn_roofline.sam", *STAGES):
        assert readers[name].read(bare) is None, name


def test_the_counter_readers_skip_a_program_without_the_counter(
        monkeypatch):
    from tee_optical_flow_torch.utils import tracing

    readers = harness.metric_readers()
    monkeypatch.setattr(tracing, "get_counters",
                        lambda: {"clips": 2, "labelling_rounds": 100})
    assert readers["segmentor_frames.sam"].read(_sam_record()) is None
    assert readers["host_syncs.sam"].read(_sam_record()) == 0
    assert readers["labelling_rounds.sam"].read(_sam_record()) == 50
    monkeypatch.setattr(tracing, "get_counters",
                        lambda: {"clips": 2, "host_syncs": 150})
    assert readers["host_syncs.sam"].read(_sam_record()) == 75
    monkeypatch.delattr(tracing, "get_counters")
    for name in ("labelling_rounds.sam", "host_syncs.sam"):
        assert readers[name].read(_sam_record()) is None, name


def test_the_unbroken_run_is_correct_and_traced(small, monkeypatch):
    """The traced path, the profiler stood in for (it reads the card):
    every new reader finds its number, the shares under 100%."""
    def stand_in(fn, spans):
        fn()
        return {"busy_s": 0.9, "window_s": 1.0, "kernels": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}

    monkeypatch.setattr(sam_clip, "profile", stand_in)
    run = small(trace=True)
    line = harness.result_line(run, trace=True)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"decode_diff", "mask_diff", "flow_gap_px",
                                   "label_gap_ratio"}
    assert set(NEW_METRICS) <= set(line["metrics"])
    for name in ("idle_share.sam", "mfu.sam", "global_attn_roofline.sam"):
        assert 0 < line["metrics"][name]["value"] < 100, name
    # 9 frames bucketed to 16: four micro-batches of 4, one span each
    assert run["stage_calls"]["sam_encoder"] == 4
    assert run["stage_calls"]["global_attn"] == 4
    assert line["metrics"]["segmentor_frames.sam"]["value"] == 16
    assert not any(k.endswith(".clip") for k in line["metrics"])


def _deep_labels(inner):
    """Labels whose ``rv`` is a wall around a serpentine corridor of
    background (label 0) that reaches the border through one gap: its fill
    needs several times 2*(H+W) rounds."""
    def labels_device(clip_dev, clip_hw):
        out = inner(clip_dev, clip_hw).clone()
        h, w = out.shape[1:]
        corridor = np.zeros((h - 2, w - 2), bool)
        corridor[0::2] = True
        for k, row in enumerate(range(1, h - 2, 2)):
            corridor[row, w - 3 if k % 2 == 0 else 0] = True
        wall = np.ones((h, w), bool)
        wall[1:-1, 1:-1] = ~corridor
        wall[1, 0] = False
        out[:] = torch.from_numpy(wall).to(out.dtype)
        return out
    return labels_device


def _fixed_rounds(mask, connectivity):
    """The JAX package's labelling: a fixed 2*(H+W) rounds."""
    from tee_optical_flow_torch.ops import morphology as mo

    _, h, w = mask.shape
    big = h * w
    ids = torch.where(mask, torch.arange(big, dtype=torch.int32).reshape(
        1, h, w), big)
    for _ in range(2 * (h + w)):
        ids = torch.where(mask, mo._neighbor_min(ids, big, connectivity), big)
    return ids, 2 * (h + w)


@pytest.mark.parametrize("fixed", [False, True], ids=["converged", "fixed"])
def test_a_fixed_round_labelling_fails_mask_diff_on_a_deep_mask(
        small, monkeypatch, fixed):
    from tee_optical_flow_torch.ops import morphology as mo

    build = sam_clip.build_segmentor

    def deep(*args, **kw):
        state, seg = build(*args, **kw)
        seg.labels_device = _deep_labels(seg.labels_device)
        return state, seg

    monkeypatch.setattr(sam_clip, "build_segmentor", deep)
    if fixed:
        monkeypatch.setattr(mo, "_label_plain", _fixed_rounds)
    checks = harness.result_line(small(), False)["checks"]
    if fixed:
        assert checks["mask_diff"]["value"] > checks["mask_diff"]["limit"]
    else:
        assert checks["mask_diff"]["value"] == 0
    assert checks["decode_diff"]["value"] == 0


def test_int8_weights_fail_label_gap_ratio(small):
    line = harness.result_line(small(control="int8-weights"), False)
    gap = line["checks"]["label_gap_ratio"]
    assert not line["correct"] and gap["value"] > gap["limit"]
    assert line["checks"]["mask_diff"]["value"] == 0


def test_the_weights_are_drawn_whole_from_the_seed():
    """Every tensor of the state dict comes from the run's seed: the same
    seed gives the same tensors, another seed others, and the tables,
    the position embedding, every bias and every norm's shift are
    nonzero (so that the checks see the layers that read them)."""
    model_cfg = dict(harness.load_cell(CELL)["config_data"]["model"],
                     **SMALL_MODEL)
    model = _small_model(model_cfg, "cpu")
    one = sam_clip.draw_state(model, 5, "cpu")
    assert one.keys() == model.state_dict().keys()
    again = sam_clip.draw_state(model, 5, "cpu")
    other = sam_clip.draw_state(model, 6, "cpu")
    for k, v in one.items():
        assert torch.equal(v, again[k]), k
        assert not torch.equal(v, other[k]), k
        assert v.shape == model.state_dict()[k].shape, k
        assert v.std() > 0, k
    kinds = [k for k in one if k.endswith(("rel_pos_h", "rel_pos_w",
                                           "pos_embed", ".bias"))]
    assert len(kinds) > 2 * SMALL_MODEL["depth"]


def _transposed_rel_pos(rel_pos_embed):
    def fault(rel_pos, q_size, k_size):
        return rel_pos_embed(rel_pos, q_size, k_size).transpose(0, 1)
    return fault


@pytest.mark.parametrize("fault", ["rel_pos_transposed", "pos_embed_lost"])
def test_a_fault_in_the_position_terms_fails_label_gap_ratio(
        small, monkeypatch, fault):
    """The relative-position bias indexed q for k, or a position
    embedding the load leaves out: the served labels lose more than the
    reference's own bfloat16 does, by more than the limit."""
    from tee_optical_flow_torch.models import image_encoder

    if fault == "rel_pos_transposed":
        monkeypatch.setattr(image_encoder, "rel_pos_embed",
                            _transposed_rel_pos(image_encoder.rel_pos_embed))
    else:
        def losing(model_cfg, device):
            model = _small_model(model_cfg, device)
            load = model.load_state_dict

            def without(state, strict=True):
                kept = {k: v for k, v in state.items()
                        if not k.endswith("pos_embed")}
                return load(kept, strict=False)
            model.load_state_dict = without
            return model
        monkeypatch.setattr(sam_clip, "build_model", losing)
    line = harness.result_line(small(), False)
    gap = line["checks"]["label_gap_ratio"]
    assert not line["correct"] and gap["value"] > gap["limit"], gap
    assert line["checks"]["mask_diff"]["value"] == 0
