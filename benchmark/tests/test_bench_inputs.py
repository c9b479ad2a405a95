"""Inputs depend on the seed alone, and the DICOMs read back."""

import numpy as np
import torch

from benchmark import inputs

AMPS = [0.02, 0.04, 0.06]


def clips(seed):
    return inputs.echo_clips(seed, 3, 5, 48, 64, amplitudes=AMPS,
                             period=16, device="cpu")


def test_same_seed_same_clips_other_seed_other_clips():
    big = 2 ** 31 + 17
    a, b = clips(big), clips(big)
    assert a.dtype == torch.uint8 and a.shape == (3, 5, 48, 64)
    assert torch.equal(a, b)
    assert not torch.equal(a, clips(big + 1))
    assert not torch.equal(a, clips(-big))
    # the three clips of a pool differ, and the fan's outside stays black
    assert not torch.equal(a[0], a[1])
    sector = inputs.sector_geometry(48, 64, "cpu")["sector"]
    assert int(a[:, :, ~sector].max()) == 0


def test_every_seed_draws_the_same_amplitudes():
    for seed in (0, 7, 2 ** 31 + 3):
        order = inputs.seed_rng(seed, "clips").permutation(3)
        assert sorted(order) == [0, 1, 2]


def test_dicom_reads_back_through_the_program(tmp_path):
    from tee_optical_flow_torch.io.dicom import (
        extract_metadata, read_dicom_clip,
    )

    frames = clips(3)[0].numpy()
    rgb = np.repeat(frames[..., None], 3, axis=-1)
    path = str(tmp_path / "c.dcm")
    inputs.write_dicom(path, rgb, frame_rate=30, pixel_spacing=0.05)
    ds, arr = read_dicom_clip(path)
    assert np.array_equal(arr, rgb)
    meta = extract_metadata(ds)
    assert meta["frame_rate"] == 30.0
    assert meta["pixel_spacing"] == 0.05
