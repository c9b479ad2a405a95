"""The probes behind PERF.md's open questions, at a size the CPU holds."""

import numpy as np
import torch

from benchmark import harness, inputs, probes
from benchmark.reference import masks as ref_masks

FLOW = harness.load_json("configs", "otsu-tvl1")["flow"]


def test_rounds_needed_is_the_longest_path_to_a_root():
    # one 4-connected row of 10 pixels: its root's label reaches the far
    # end after 9 rounds
    m = torch.zeros(1, 3, 12, dtype=torch.bool)
    m[0, 1, 1:11] = True
    assert probes.rounds_needed(m) == 9
    # a serpentine is far longer than 2 (H + W)
    h = w = 24
    s = torch.zeros(1, h, w, dtype=torch.bool)
    s[0, ::2, :] = True
    s[0, 1::4, -1] = True
    s[0, 3::4, 0] = True
    assert probes.rounds_needed(s) > 2 * (h + w)
    assert torch.unique(ref_masks.label(s, 1)[s]).numel() == 1


def test_otsu_rounds_of_a_small_clip():
    clip = inputs.echo_clips(3, 1, 4, 48, 64, amplitudes=[0.04], period=16,
                             device="cpu")[0]
    got = probes.otsu_rounds(clip, FLOW)
    assert got["program_rounds"] == 2 * (48 + 64)
    assert 0 < got["fill"] <= got["program_rounds"]
    assert 0 < got["size_filter"] <= got["program_rounds"]


def test_scipy_witness_equals_the_program_on_compact_labels():
    from tee_optical_flow_torch.flow.segment import clean_mask

    g = torch.Generator().manual_seed(1)
    coarse = torch.randint(0, 3, (6, 6, 8), generator=g)
    labels = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2).numpy()
    flow = dict(FLOW, min_mask_size=40)
    from tee_optical_flow_torch.config import OpticalFlowCalculationConfig

    got = clean_mask(labels, "RVIO_2class", device="cpu",
                     config=OpticalFlowCalculationConfig.from_dict(flow))
    for name, value in (("rv", 1), ("av", 2)):
        assert np.array_equal(got[name][..., 0],
                              probes.scipy_clean(labels, value, flow))


def test_pairing_counts_rows_whose_mask_is_their_images():
    got = probes.pairing_readings(0)
    assert got["rows"] == 8
    assert 0 <= got["rows_matched"] <= 8
    # one __getitem__ draws one augmentation for both
    assert got["getitem_matched"] == 8
