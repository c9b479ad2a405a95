"""A small run on the CPU with the timed path broken underneath comes out
not correct, once for each fault a clip cell can have (an answer altered
where it is produced: a decoded pixel, a mask pixel, the flow, a flow
value that is not a number), and so does each cell's control; the
unbroken run is correct."""

import contextlib

import pytest

from benchmark import harness
from conftest import run_small


@contextlib.contextmanager
def replaced(module, name, fn):
    inner = getattr(module, name)
    setattr(module, name, fn(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def altered_read(inner):
    def read(path):
        ds, arr = inner(path)
        arr = arr.copy()
        arr[0, 20, 30] = 255 - arr[0, 20, 30]
        return ds, arr
    return read


def altered_flow(inner):
    def flow(*args, **kw):
        out = inner(*args, **kw).clone()
        out[0, 30, 40, 0] += 0.5
        return out
    return flow


def nan_flow(inner):
    def flow(*args, **kw):
        out = inner(*args, **kw).clone()
        out[1, 20, 50, 1] = float("nan")
        return out
    return flow


def altered_otsu(inner):
    def masks(*args, **kw):
        out = inner(*args, **kw)
        out["otsu"][3, 30, 40] = ~out["otsu"][3, 30, 40]
        return out
    return masks


@pytest.mark.parametrize("name", ["otsu-tvl1.clip480",
                                  "otsu-tvl1.clip600"])
def test_the_unbroken_run_is_correct(name):
    line = run_small(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


FAULTS = [
    ("otsu-tvl1.clip480", "read_dicom_clip", altered_read, "decode_diff"),
    ("otsu-tvl1.clip480", "compute_clip_flow", altered_flow, "flow_gap_px"),
    ("otsu-tvl1.clip480", "compute_clip_flow", nan_flow, "flow_gap_px"),
    ("otsu-tvl1.clip480", "predict_movie_thres", altered_otsu, "mask_diff"),
]


@pytest.mark.parametrize("name,target,fault,check", FAULTS,
                         ids=[f[2].__name__ for f in FAULTS])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        name, target, fault, check):
    from tee_optical_flow_torch.flow import pipeline

    with replaced(pipeline, target, fault):
        line = run_small(name)
    assert not line["correct"]
    assert line["checks"][check]["value"] > line["checks"][check]["limit"]


def test_the_controls_are_not_correct():
    """The reference in bfloat16 at a small size on the CPU; the cells'
    TF32 control needs the card (below)."""
    assert not run_small("otsu-tvl1.clip480",
                         control="bf16-reference")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["otsu-tvl1.clip480", "otsu-tvl1.clip600"])
def test_the_tf32_control_is_not_correct_on_the_card(name, card):
    """TF32 rounds products on the card only (a CPU's float32 product is
    exact float32), so this control is held on the card, at a small
    size."""
    assert harness.load_cell(name)["control"] == "tf32-reference"
    line = run_small(name, control="tf32-reference", device=card)
    assert not line["correct"], line["checks"]
