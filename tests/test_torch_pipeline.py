"""The PyTorch port's main path end to end on the CPU, against the JAX
package's: DICOM -> Otsu masks -> TV-L1 -> HDF5, under the reduced config
of tests/test_dicom_pipeline.py. The DICOM is written by the JAX
package's writer and read by the port's copy of the reader; the port's
HDF5 is read back by the JAX package's OpticalFlowDataset."""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch.config import (
    OpticalFlowCalculationConfig as TorchConfig,
)
from tee_optical_flow_torch.flow import pipeline as t_pipe
from tee_optical_flow_tpu.config import (
    OpticalFlowCalculationConfig as JaxConfig,
)
from tee_optical_flow_tpu.dataset import OpticalFlowDataset
from tee_optical_flow_tpu.flow import pipeline as j_pipe
from tee_optical_flow_tpu.io.dicom_write import write_dicom_clip

torch.set_num_threads(1)

REDUCED = dict(min_mask_size=50, tvl1_nscales=3, tvl1_zoom_factor=0.5,
               tvl1_warps=3, tvl1_outer_iterations=2,
               tvl1_inner_iterations=15, tvl1_median_filtering=False)


def _synthetic_clip(rng, n=8, h=48, w=48):
    """Bright blob drifting +1 px/frame on dark speckle (the clip of
    tests/test_dicom_pipeline.py)."""
    clip = (rng.uniform(size=(n, h, w)) * 40).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        cy, cx = h // 2, w // 4 + i
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 8.0 ** 2))
        clip[i] = np.clip(clip[i] + (blob * 215), 0, 255).astype(np.uint8)
    return np.repeat(clip[..., None], 3, axis=-1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One DICOM through the port and through the JAX package."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    dcm = str(tmp / "stanford_TEST_1.dcm")
    write_dicom_clip(dcm, _synthetic_clip(np.random.default_rng(7)))
    out_t = str(tmp / "torch.hdf5")
    out_j = str(tmp / "jax.hdf5")
    kw = dict(verbose=False, mode="otsu", no_saliency=True, OF_algo="TVL1",
              include_waveforms=False)
    t_pipe.process_video(dcm, out_t, None, config=TorchConfig(**REDUCED),
                         device="cpu", **kw)
    j_pipe.process_video(dcm, out_j, None, config=JaxConfig(**REDUCED), **kw)
    return dcm, out_t, out_j


def test_port_hdf5_has_reference_schema(runs):
    _, out_t, _ = runs
    with OpticalFlowDataset(out_t) as ds:
        assert ds.nframes == 6  # 8 raw - 2
        assert ds.mode == "otsu"
        assert ds.units_converted_flag
        assert abs(ds.frame_rate - 30.0) < 1e-6
        assert abs(ds.pixel_spacing - 0.05) < 1e-6
        assert ds.accepted_labels == ["otsu"]
        assert ds.vel_array.shape == (8, 48, 48, 2)
        # flow duplicated on the last frame
        np.testing.assert_array_equal(ds.vel_array[-1], ds.vel_array[-2])
        assert ds.RTimePresent


def test_port_matches_jax_run(runs):
    """Masks bit for bit; flow within float16 storage rounding plus the
    solvers' float32 drift (flow in cm/s, 1 px = 1.5 cm/s here: the
    bound of 0.01 cm/s mean / 0.05 max end-point error is 0.007 / 0.03
    px)."""
    import h5py

    _, out_t, out_j = runs
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        assert sorted(ft.keys()) == sorted(fj.keys())
        assert ft["flow"].dtype == ft["echo"].dtype == np.float16
        np.testing.assert_array_equal(ft["otsu"][()], fj["otsu"][()])
        np.testing.assert_array_equal(ft["echo"][()], fj["echo"][()])
        for key in ("nframes", "mode", "frame_rate", "pixel_spacing",
                    "labels", "ID", "HR", "no_saliency", "units_converted"):
            np.testing.assert_array_equal(ft["flow"].attrs[key],
                                          fj["flow"].attrs[key])
        a = ft["flow"][()].astype(np.float32)
        b = fj["flow"][()].astype(np.float32)
    epe = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    assert epe.mean() < 0.01 and epe.max() < 0.05, (epe.mean(), epe.max())
    assert np.abs(b).max() > 0.5  # the blob moved: the flow is not all 0


def test_in_memory_clip_matches_jax(runs, tmp_path):
    """_clip_override/_metadata_override: the same in-memory clip through
    both packages writes the same masks and echo and, within the bounds
    above, the same flow; with no metadata given the flow is left in px
    (conversion factor 1) and the patient id and heart rate are empty and
    0. The clip is the DICOM's own, so the port's in-memory run equals its
    DICOM run apart from the units."""
    import h5py

    _, out_dcm, _ = runs
    clip = _synthetic_clip(np.random.default_rng(7))
    kw = dict(verbose=False, mode="otsu", no_saliency=True, OF_algo="TVL1",
              include_waveforms=False, _clip_override=clip)
    out_t, out_j = str(tmp_path / "t.hdf5"), str(tmp_path / "j.hdf5")
    t_pipe.process_video("mem.dcm", out_t, None, config=TorchConfig(**REDUCED),
                         device="cpu", **kw)
    j_pipe.process_video("mem.dcm", out_j, None, config=JaxConfig(**REDUCED),
                         **kw)
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj, \
            h5py.File(out_dcm, "r") as fd:
        assert sorted(ft.keys()) == sorted(fj.keys())
        for key in ("otsu", "echo"):
            np.testing.assert_array_equal(ft[key][()], fj[key][()])
            np.testing.assert_array_equal(ft[key][()], fd[key][()])
        for key in ("nframes", "mode", "frame_rate", "pixel_spacing",
                    "labels", "ID", "HR", "no_saliency", "units_converted"):
            np.testing.assert_array_equal(ft["flow"].attrs[key],
                                          fj["flow"].attrs[key])
        assert ft["flow"].attrs["ID"] == "" and ft["flow"].attrs["HR"] == 0
        a = ft["flow"][()].astype(np.float32)
        b = fj["flow"][()].astype(np.float32)
        # the DICOM run stored cm/s: 0.05 cm/px at 30 frames/s
        d = fd["flow"][()].astype(np.float32) / np.float32(1.5)
    epe = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    assert epe.mean() < 0.01 and epe.max() < 0.05, (epe.mean(), epe.max())
    np.testing.assert_allclose(a, d, rtol=0, atol=0.01)


def test_config_json_round_trips_between_packages(tmp_path):
    jcfg = JaxConfig(tvl1_epsilon=0.02, frame_bucket=4, **REDUCED)
    path = str(tmp_path / "flow.json")
    jcfg.to_json(path)
    tcfg = TorchConfig.from_json(path)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert JaxConfig.from_json(tcfg.to_json()).to_dict() == jcfg.to_dict()
    assert TorchConfig().to_dict() == JaxConfig().to_dict()


def test_process_folder_isolates_failures(runs, tmp_path):
    """A folder of one good and one corrupt DICOM: the good one is written
    by the write-behind thread, the bad one lands in the error list."""
    import shutil

    dcm, _, _ = runs
    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(dcm, src / "a.dcm")
    (src / "b.dcm").write_bytes(b"not a dicom")
    out = tmp_path / "out"
    errors = t_pipe.process_folder(
        str(src), str(out), None, mode="otsu", no_saliency=True,
        config=TorchConfig(**REDUCED), device="cpu")
    assert errors == [str(src / "b.dcm")]
    assert os.path.exists(out / "a.hdf5")


def test_unported_paths_are_refused(runs, tmp_path):
    """What the pipeline still lacks raises before anything is written:
    TV-L1 gamma > 0. WASE and waveforms are ported
    (tests/test_torch_cohort.py); WASE in otsu mode stays a configuration
    error, as in the JAX package."""
    from tee_optical_flow_torch.exceptions import ConfigurationError

    dcm, _, _ = runs
    out = str(tmp_path / "x.hdf5")
    with pytest.raises(NotImplementedError, match="gamma"):
        t_pipe.process_video(dcm, out, None, mode="otsu", no_saliency=True,
                             config=TorchConfig(tvl1_gamma=0.1, **REDUCED),
                             device="cpu")
    with pytest.raises(ConfigurationError, match="otsu"):
        t_pipe.process_video(dcm, out, None, mode="otsu", bkgd_comp="WASE",
                             config=TorchConfig(**REDUCED), device="cpu")
    assert not os.path.exists(out)


def test_entry_points_need_a_card_unless_cpu_is_asked(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    dcm, _, _ = runs
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.process_video(dcm, str(tmp_path / "x.hdf5"), None,
                             mode="otsu", no_saliency=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.compute_clip_flow(np.zeros((2, 32, 32), np.float32))
