"""The PyTorch port's own copies of the host modules against the JAX
package's: the DICOM writer and reader (uncompressed, RLE and
JPEG-Lossless; tests/test_torch_dicom.py holds the rest of the decode), the
clip-shape bucketing of core, and the synthetic echo content the smoke
run is built from. Everything here is integer or float64 host code run
by both sides on the same inputs, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch import core as t_core
from tee_optical_flow_torch import synthetic as t_syn
from tee_optical_flow_torch.exceptions import DICOMReadError
from tee_optical_flow_torch.io import dicom as t_dicom
from tee_optical_flow_torch.io import dicom_write as t_write
from tee_optical_flow_tpu import core as j_core
from tee_optical_flow_tpu import synthetic as j_syn
from tee_optical_flow_tpu.io import dicom as j_dicom
from tee_optical_flow_tpu.io import dicom_write as j_write
from tee_optical_flow_tpu.ops import tvl1_oracle as j_oracle

torch.set_num_threads(1)


def _frames(rng, channels):
    """A clip with constant rows (RLE replicate runs) and speckle
    (literal runs)."""
    shape = (3, 17, 22) + ((3,) if channels == 3 else ())
    clip = rng.integers(0, 256, size=shape, dtype=np.uint8)
    clip[:, :4] = 0
    return clip


def _assert_same_read(path):
    j_ds, j_arr = j_dicom.read_dicom_clip(path)
    t_ds, t_arr = t_dicom.read_dicom_clip(path)
    np.testing.assert_array_equal(j_arr, t_arr)
    assert t_arr.dtype == j_arr.dtype
    j_meta = j_dicom.extract_metadata(j_ds)
    t_meta = t_dicom.extract_metadata(t_ds)
    assert sorted(j_meta) == sorted(t_meta)
    for key in j_meta:
        np.testing.assert_array_equal(j_meta[key], t_meta[key])
    return t_arr


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("syntax", ["native", "rle"])
def test_dicom_round_trips_between_packages(rng, tmp_path, syntax, channels):
    """The port's writer is read back exactly by both readers, and the
    JAX package's writer by the port's reader."""
    clip = _frames(rng, channels)
    kw = dict(frame_rate=25, pixel_spacing=0.07, transfer_syntax=syntax)
    t_path = str(tmp_path / "port.dcm")
    j_path = str(tmp_path / "jax.dcm")
    t_write.write_dicom_clip(t_path, clip, **kw)
    j_write.write_dicom_clip(j_path, clip, **kw)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    # the reader hands a monochrome clip on as RGB, as the reference does
    rgb = clip if channels == 3 else np.repeat(clip[..., None], 3, axis=-1)
    for path in (t_path, j_path):
        np.testing.assert_array_equal(_assert_same_read(path), rgb)


def test_jpeg_frames_are_refused(rng, tmp_path, monkeypatch):
    """JPEG frames are refused only where no decoder is available: a
    JPEG-Lossless clip, once refused outright, is read (written by either
    package's writer, byte-equal) exactly as the JAX package reads it, and
    raises DICOMReadError without the native decoder; the writer refuses
    transfer syntaxes it does not know."""
    clip = _frames(rng, 1)
    path, j_path = str(tmp_path / "jpeg.dcm"), str(tmp_path / "j.dcm")
    t_write.write_dicom_clip(path, clip, transfer_syntax="jpeg_lossless")
    j_write.write_dicom_clip(j_path, clip, transfer_syntax="jpeg_lossless")
    assert open(path, "rb").read() == open(j_path, "rb").read()
    np.testing.assert_array_equal(_assert_same_read(path),
                                  np.repeat(clip[..., None], 3, axis=-1))
    with pytest.raises(ValueError, match="transfer_syntax"):
        t_write.write_dicom_clip(path, clip, transfer_syntax="jpeg2000")
    from tee_optical_flow_torch.io import dicom_native

    monkeypatch.setattr(dicom_native, "_lib", None)
    monkeypatch.setattr(dicom_native, "_lib_failed", True)
    with pytest.raises(DICOMReadError, match="JPEG"):
        t_dicom.read_dicom_clip(path)


def test_bucketing_matches_jax(rng):
    for n, b in ((33, 8), (40, 8), (7, 1), (1, 4)):
        assert t_core.bucketed_frame_count(n, b) == \
            j_core.bucketed_frame_count(n, b)
    for h, w in ((480, 640), (600, 800), (37, 45)):
        assert t_core.bucketed_spatial(h, w, 32) == \
            j_core.bucketed_spatial(h, w, 32)
    clip = rng.integers(0, 256, size=(5, 6, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(j_core.pad_clip_frames(clip, 8),
                                  t_core.pad_clip_frames(clip, 8))
    imgs = rng.uniform(size=(3, 10, 13)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(j_core.pad_spatial_edge(imgs, 16, 32)),
        t_core.pad_spatial_edge(torch.from_numpy(imgs), 16, 32).numpy())
    assert t_core.pad_spatial_edge(torch.from_numpy(imgs), 10, 13).shape \
        == (3, 10, 13)


def test_synthetic_content_matches_jax(rng):
    h, w = 40, 52
    for key, mask in j_syn.echo_sector_masks(h, w).items():
        np.testing.assert_array_equal(mask, t_syn.echo_sector_masks(h, w)[key])
    for a, b in zip(j_syn.make_echo_pair(3, h, w),
                    t_syn.make_echo_pair(3, h, w)):
        np.testing.assert_array_equal(a, b)
    img = rng.uniform(size=(h, w)) * 255
    sx = rng.uniform(-3, w + 3, size=(h, w))
    sy = rng.uniform(-3, h + 3, size=(h, w))
    np.testing.assert_array_equal(j_oracle.bicubic_sample(img, sx, sy),
                                  t_syn.bicubic_sample(img, sx, sy))
