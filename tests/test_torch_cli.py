"""The PyTorch port's run configuration, cache and DICOM-folder CLI
against the JAX package's, on the CPU and the same seeded numpy inputs.

  * PipelineConfig / DeviceConfig: JSON written by either package loads
    in the other and round-trips equal; every validator refusal raises
    ConfigurationError in both, and int8 passes both;
  * cache: the keys of arrays and plain values equal the JAX package's,
    a tensor's equal its array's, and eviction is least recently used;
  * cli.process.main (port with --device cpu) against the JAX main on a
    folder of two small otsu DICOMs at --nchunks 2 under one reduced
    flow config (a PipelineConfig JSON the JAX package wrote): the same
    files in the same chunk folders, masks and echo bit for bit, the
    attributes equal, the flow within 1e-3 px (1.5e-3 cm/s) plus one
    float16 step of the stored value; a corrupt .dcm gives rc 1 in both;
    an existing file is skipped unless --recalculate;
  * load_segmentor: a checkpoint_best.pth gives the file's parameters,
    equal to the JAX load_segmentor's variables carried across by
    models/convert; its two refusals (an orbax-only directory,
    data_axis > 1); int8 weights and a vit_b args.json served;
  * the config-5 CLI run (RVIO_2class, WASE, saliency, waveforms, two
    chunks) equal bit for bit to the port's own process_video on the same
    DICOM and checkpoint (process_video is held to the JAX package by
    tests/test_torch_cohort.py and tests/test_torch_segment.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch import cache as t_cache
from tee_optical_flow_torch import config as t_config
from tee_optical_flow_torch.cli import process as t_cli
from tee_optical_flow_torch.exceptions import ConfigurationError as TError
from tee_optical_flow_torch.exceptions import ShardingError as TShardingError
from tee_optical_flow_torch.flow import pipeline as t_pipe
from tee_optical_flow_torch.models import registry as t_registry
from tee_optical_flow_torch.models import sam as t_sam
from tee_optical_flow_tpu import cache as j_cache
from tee_optical_flow_tpu import config as j_config
from tee_optical_flow_tpu.cli import process as j_cli
from tee_optical_flow_tpu.exceptions import ConfigurationError as JError
from tee_optical_flow_tpu.exceptions import ShardingError as JShardingError
from tee_optical_flow_tpu.io.dicom_write import write_dicom_clip

torch.set_num_threads(1)

# tests/test_torch_cohort.py's reduced config: bilinear warps and fixed
# iteration counts keep the JAX solve's compile short and the two solves
# free of epsilon-stop decisions near the threshold
REDUCED = dict(min_mask_size=50, tvl1_nscales=3, tvl1_zoom_factor=0.5,
               tvl1_warps=3, tvl1_outer_iterations=2,
               tvl1_inner_iterations=15, tvl1_median_filtering=False,
               tvl1_interpolation="bilinear", tvl1_epsilon=0.0)
# cm/s per px of the written DICOMs (pixel spacing 0.05 cm, 30 frames/s)
CM_S_PER_PX = 0.05 * 30
FLOW_PX_TOL = 1e-3


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


# --- configuration ----------------------------------------------------------

def _configs(mod):
    return [
        mod.PipelineConfig(),
        mod.PipelineConfig(
            flow=mod.OpticalFlowCalculationConfig(tvl1_epsilon=0.02,
                                                  frame_bucket=4),
            processing=mod.ProcessingConfig(verbose=True,
                                            sampling_rate=60),
            device=mod.DeviceConfig(data_axis=2, model_dtype="float32",
                                    compilation_cache_dir="/cache"),
            mode="RVIO_2class", of_algo="deepflow", no_saliency=False,
            wase=True, include_waveforms=False,
            save_mask_subset=["rv", "av"]),
    ]


@pytest.mark.parametrize("case", [0, 1])
def test_pipeline_config_json_round_trips_between_packages(tmp_path, case):
    jcfg, tcfg = _configs(j_config)[case], _configs(t_config)[case]
    assert jcfg.to_json() == tcfg.to_json()
    path = str(tmp_path / "jax.json")
    jcfg.to_json(path)
    got = t_config.PipelineConfig.from_json(path)
    assert got == tcfg
    assert isinstance(got.device, t_config.DeviceConfig)
    assert isinstance(got.flow, t_config.OpticalFlowCalculationConfig)
    assert j_config.PipelineConfig.from_json(got.to_json()) == jcfg
    assert t_config.DeviceConfig.from_json(
        j_config.DeviceConfig(data_axis=4).to_json()) == \
        t_config.DeviceConfig(data_axis=4)


_REFUSALS = {
    "mode": dict(mode="LAX"),
    "of_algo": dict(of_algo="farneback"),
    "lambda": dict(flow=dict(lambda_value=0.0)),
    "zoom": dict(flow=dict(tvl1_zoom_factor=1.0)),
    "tvl1_interp": dict(flow=dict(tvl1_interpolation="nearest")),
    "deepflow_interp": dict(flow=dict(deepflow_interpolation="nearest")),
    "otsu_wase": dict(mode="otsu", wase=True),
    "compute_dtype": dict(device=dict(compute_dtype="bfloat16")),
    "model_dtype": dict(device=dict(model_dtype="int4")),
}


@pytest.mark.parametrize("name", sorted(_REFUSALS))
def test_every_validator_refusal_raises_in_both(name):
    data = _REFUSALS[name]
    with pytest.raises(JError):
        j_config.validate_pipeline_config(
            j_config.PipelineConfig.from_dict(data))
    with pytest.raises(TError):
        t_config.validate_pipeline_config(
            t_config.PipelineConfig.from_dict(data))


def test_int8_and_defaults_pass_validation_in_both():
    for mod in (j_config, t_config):
        mod.validate_pipeline_config(mod.PipelineConfig())
        mod.validate_pipeline_config(mod.PipelineConfig(
            mode="RVIO_2class", wase=True,
            device=mod.DeviceConfig(model_dtype="int8")))


# --- cache -------------------------------------------------------------------

def test_cache_keys_equal_jax(rng):
    arr = rng.normal(size=(3, 5)).astype(np.float32)
    strided = rng.integers(0, 9, size=(4, 6)).astype(np.int64)[:, ::2]
    assert t_cache.hash_array(arr) == j_cache.hash_array(arr)
    assert t_cache.hash_array(strided) == j_cache.hash_array(strided)
    assert t_cache.hash_array(torch.from_numpy(arr)) == \
        j_cache.hash_array(arr)
    for args, kwargs in (((arr, 3, "rv"), {"nbins": 32}),
                         ((), {"b": strided, "a": (1, 2.5)}),
                         ((None, [1, 2]), {})):
        assert t_cache.hash_args(*args, **kwargs) == \
            j_cache.hash_args(*args, **kwargs)
    assert t_cache.hash_args(torch.from_numpy(arr), k=torch.ones(2)) == \
        j_cache.hash_args(arr, k=np.ones(2, np.float32))
    assert t_cache.hash_args(arr) != t_cache.hash_args(arr + 1)


def test_cache_lru_order_and_decorator():
    c = t_cache.ComputationCache(max_size=2)
    c.set("a", 1)
    c.set("b", 2)
    assert c.get("a") == 1            # a is now the most recent
    c.set("c", 3)                     # evicts b
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert (c.hits, c.misses, len(c)) == (3, 1, 2)
    assert c.invalidate("a") and not c.invalidate("a")
    calls = []

    @t_cache.cached_computation(cache=c)
    def double(x):
        calls.append(1)
        return x * 2

    x = torch.arange(4)
    assert torch.equal(double(x), x * 2)
    assert torch.equal(double(torch.arange(4)), x * 2)
    assert len(calls) == 1
    t_cache.clear_cache()
    assert len(t_cache.get_cache()) == 0


# --- cli/process: otsu, two chunks -------------------------------------------

@pytest.fixture(scope="module")
def otsu_runs(tmp_path_factory):
    """Two small otsu DICOMs (and a folder with a corrupt third) through
    the JAX CLI and the port's, under one reduced PipelineConfig JSON
    written by the JAX package."""
    tmp = tmp_path_factory.mktemp("cli_otsu")
    dcm_dir = tmp / "dcm"
    dcm_dir.mkdir()
    for name, seed in (("a", 7), ("b", 8)):
        write_dicom_clip(str(dcm_dir / f"{name}.dcm"),
                         _synthetic_clip(np.random.default_rng(seed)))
    cfg = str(tmp / "pipeline.json")
    j_config.PipelineConfig(
        mode="otsu", of_algo="tvl1", no_saliency=True,
        include_waveforms=False,
        flow=j_config.OpticalFlowCalculationConfig(**REDUCED)).to_json(cfg)
    bad_dir = tmp / "bad"
    bad_dir.mkdir()
    write_dicom_clip(str(bad_dir / "a.dcm"),
                     _synthetic_clip(np.random.default_rng(7)))
    (bad_dir / "z.dcm").write_bytes(b"garbage")
    argv = ["--dcm_folder", str(dcm_dir), "--nchunks", "2", "--mode",
            "otsu", "--config", cfg]
    bad = ["--dcm_folder", str(bad_dir), "--config", cfg, "--mode", "otsu"]
    out = {"tmp": tmp, "argv": argv, "rc": {}, "bad_rc": {}}
    for name, main, extra in (("jax", j_cli.main, []),
                              ("torch", t_cli.main, ["--device", "cpu"])):
        out["rc"][name] = main(argv + ["--save_folder", str(tmp / name)]
                               + extra)
        out["bad_rc"][name] = main(
            bad + ["--save_folder", str(tmp / f"bad_{name}")] + extra)
    return out


def test_process_cli_matches_jax(otsu_runs):
    import h5py

    tmp = otsu_runs["tmp"]
    assert otsu_runs["rc"] == {"jax": 0, "torch": 0}
    for name in ("jax", "torch"):
        assert sorted(os.listdir(tmp / name)) == ["chunk0", "chunk1"]
        assert os.listdir(tmp / name / "chunk0") == ["a.hdf5"]
        assert os.listdir(tmp / name / "chunk1") == ["b.hdf5"]
    for rel in ("chunk0/a.hdf5", "chunk1/b.hdf5"):
        with h5py.File(tmp / "torch" / rel, "r") as ft, \
                h5py.File(tmp / "jax" / rel, "r") as fj:
            assert sorted(ft.keys()) == sorted(fj.keys())
            for key in ("otsu", "echo", "RWaveTime"):
                np.testing.assert_array_equal(ft[key][()], fj[key][()])
            assert sorted(ft["flow"].attrs) == sorted(fj["flow"].attrs)
            for key in fj["flow"].attrs:
                np.testing.assert_array_equal(ft["flow"].attrs[key],
                                              fj["flow"].attrs[key])
            a, b = ft["flow"][()], fj["flow"][()]
        step = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
        bound = FLOW_PX_TOL * CM_S_PER_PX + step.astype(np.float32)
        assert (diff <= bound).all(), float((diff - bound).max())
        assert np.abs(b.astype(np.float32)).max() > 0.5  # the blob moved


def test_process_cli_corrupt_file_gives_rc_1_in_both(otsu_runs):
    tmp = otsu_runs["tmp"]
    assert otsu_runs["bad_rc"] == {"jax": 1, "torch": 1}
    for name in ("jax", "torch"):
        assert os.listdir(tmp / f"bad_{name}" / "chunk0") == ["a.hdf5"]


def test_process_cli_skips_existing_unless_recalculate(otsu_runs):
    tmp = otsu_runs["tmp"]
    out = tmp / "torch"
    argv = otsu_runs["argv"] + ["--save_folder", str(out), "--device", "cpu"]
    files = [out / "chunk0" / "a.hdf5", out / "chunk1" / "b.hdf5"]
    before = [os.stat(f).st_mtime_ns for f in files]
    saved = []
    assert t_cli.main(argv, _save_fn=lambda path, *a, **k:
                      saved.append(path)) == 0
    assert saved == [] and [os.stat(f).st_mtime_ns for f in files] == before
    assert t_cli.main(argv + ["--recalculate"], _save_fn=lambda path, *a,
                      **k: saved.append(path)) == 0
    assert saved == [str(f) for f in files]
    assert [os.stat(f).st_mtime_ns for f in files] == before


def test_process_cli_refuses_a_missing_card_unless_cpu(otsu_runs,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(otsu_runs["argv"] + ["--save_folder",
                                        str(otsu_runs["tmp"] / "nocard")])


# --- load_segmentor ----------------------------------------------------------

def _checkpoint_dir(path, arch="vit_t", seed=1, pth=True):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "args.json"), "w") as f:
        json.dump({"num_cls": 3, "arch": arch, "image_size": 1024}, f)
    if pth:
        model = t_registry.build_sam_vit_t(num_classes=3, seed=seed,
                                           device="cpu")
        torch.save(model.state_dict(),
                   os.path.join(path, "checkpoint_best.pth"))
    return str(path)


def _capture_model(monkeypatch, module, seen):
    inner = module.make_clip_segmentor

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, "make_clip_segmentor", capture)


def test_load_segmentor_reads_the_pth_as_jax_does(tmp_path, monkeypatch):
    """The port's segmentor holds the file's parameters; the JAX
    load_segmentor's variables, carried to torch keys by the port's
    models/convert, equal them (the JAX init's random values are replaced
    by the file's, so its init is skipped: zeros of jax.eval_shape's
    shapes)."""
    import jax.numpy as jnp

    from tee_optical_flow_torch.models.convert import sam_state_dict_from_flax
    from tee_optical_flow_tpu.models import registry as j_registry
    from tee_optical_flow_tpu.models import sam as j_sam

    ckpt = _checkpoint_dir(tmp_path / "run")
    sd = torch.load(os.path.join(ckpt, "checkpoint_best.pth"))
    seen_t, seen_j = [], []
    _capture_model(monkeypatch, t_sam, seen_t)
    _capture_model(monkeypatch, j_sam, seen_j)

    def shapes_only(model, image_size, seed=0):
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                              jnp.zeros((1, image_size, image_size, 3)))
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)

    monkeypatch.setattr(j_registry, "_init_variables", shapes_only)
    seg = t_cli.load_segmentor(ckpt, model_dtype="float32", device="cpu")
    assert callable(seg) and callable(seg.labels_device)
    (model,), kw = seen_t[0]
    assert kw == {"micro_batch": 4}
    assert model.image_size == 1024 and not model.training
    got = model.state_dict()
    assert sorted(got) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(got[key], value), key

    j_cli.load_segmentor(ckpt, model_dtype="float32")
    (_, variables), kw = seen_j[0]
    assert kw["micro_batch"] == 4
    carried = sam_state_dict_from_flax(jax.tree.map(np.asarray, variables),
                                       num_classes=3)
    # the reference TinyViT's classifier head has no JAX counterpart (the
    # segmentor never runs it): convert fills it with constants
    unused = ("image_encoder.norm_head.", "image_encoder.head.")
    assert sorted(carried) == sorted(sd)
    for key, value in carried.items():
        if not key.startswith(unused):
            assert torch.equal(torch.as_tensor(value), sd[key]), key


# an orbax-only run dir (reading orbax needs JAX); data_axis 2 on fewer
# devices than that: the CPU is one device, as a JAX process with one
# device says, and on the one card the same (chip_smoke.phase_mesh)
_SEG_REFUSALS = {
    "orbax": (dict(pth=False), dict(), NotImplementedError, "item 8"),
    "data_axis": (dict(), dict(data_axis=2), TShardingError,
                  "mesh 2x1 != 1 devices"),
}


@pytest.mark.parametrize("name", sorted(_SEG_REFUSALS))
def test_load_segmentor_refusals(tmp_path, name):
    make, call, error, match = _SEG_REFUSALS[name]
    ckpt = _checkpoint_dir(tmp_path / "run", **make)
    if name == "orbax":
        os.makedirs(os.path.join(ckpt, "checkpoint_best"))
    with pytest.raises(error, match=match):
        t_cli.load_segmentor(ckpt, device="cpu", **call)
    if name == "data_axis":
        from tee_optical_flow_tpu.parallel.mesh import make_mesh

        with pytest.raises(JShardingError, match=match):
            make_mesh(data_axis=2, devices=jax.devices()[:1])
    with pytest.raises(TError):
        t_cli.load_segmentor(ckpt, model_dtype="int4", device="cpu")


@pytest.mark.parametrize("case", ["int8", "vit_b"])
def test_load_segmentor_serves_int8_and_vit_b(tmp_path, monkeypatch, case):
    """model_dtype="int8": the checkpoint's model built in bfloat16 and
    served with int8 weights (fewer resident bytes than the bfloat16
    segmentor's float32 parameters); an args.json that says vit_b: the
    seeded vit_b (ViT-Det, 768 wide, 12 blocks) at 1024."""
    from tee_optical_flow_torch.models.image_encoder import ImageEncoderViT

    if case == "int8":
        ckpt = _checkpoint_dir(tmp_path / "run")
        call = dict(model_dtype="int8")
    else:
        ckpt = _checkpoint_dir(tmp_path / "run", arch="vit_b", pth=False)
        call = dict(model_dtype="float32")
    seen = []
    _capture_model(monkeypatch, t_sam, seen)
    seg = t_cli.load_segmentor(ckpt, device="cpu", **call)
    (model,), kw = seen[0]
    assert model.image_size == 1024 and not model.training
    if case == "int8":
        assert kw == {"micro_batch": 4, "weights_int8": True}
        assert model.dtype == torch.bfloat16
        full = t_sam.make_clip_segmentor(model)
        assert seg.resident_weight_bytes < 0.4 * full.resident_weight_bytes
    else:
        assert kw == {"micro_batch": 4}
        enc = model.image_encoder
        assert isinstance(enc, ImageEncoderViT) and len(enc.blocks) == 12
        assert enc.pos_embed.shape == (1, 64, 64, 768)


# --- cli/process: config 5 at a small size -----------------------------------

def _ecg(seconds, rate=500):
    t = np.arange(int(seconds * rate)) / rate
    ecg = 0.05 * np.sin(2 * np.pi * 0.4 * t)
    for beat in (0.05, 0.2):
        c = int(beat * rate)
        ecg[c - 10:c + 11] += 1.2 * np.hanning(21)
    return ecg


def test_config5_cli_matches_process_video(tmp_path, monkeypatch):
    """BASELINE config 5's CLI run (RVIO_2class with WASE, saliency and
    waveforms, a PipelineConfig JSON, a checkpoint directory, two chunks)
    on two 8x64x64 DICOMs, the vit_t segmentor at 128 (the registry
    entry bound to image_size=128: the CLI's wiring, not the model, is
    under test) in float32, against process_video on the same DICOM with
    load_segmentor's segmentor: every dataset and attribute equal."""
    import functools

    import h5py

    monkeypatch.setitem(t_registry.sam_model_registry, "vit_t",
                        functools.partial(t_registry.build_sam_vit_t,
                                          image_size=128))
    dcm_dir, wf_dir = tmp_path / "dcm", tmp_path / "wf"
    dcm_dir.mkdir()
    wf_dir.mkdir()
    for name, seed in (("p1", 3), ("p2", 4)):
        write_dicom_clip(str(dcm_dir / f"{name}.dcm"), _synthetic_clip(
            np.random.default_rng(seed), h=64, w=64))
        np.save(wf_dir / f"{name}_II.npy", _ecg(8 / 30))
        np.save(wf_dir / f"{name}_ART.npy",
                80 + 20 * np.sin(np.arange(34) / 5.0))
    ckpt = _checkpoint_dir(tmp_path / "run")
    cfg_path = str(tmp_path / "config5.json")
    cfg = t_config.PipelineConfig(
        mode="RVIO_2class", of_algo="tvl1", no_saliency=False, wase=True,
        include_waveforms=True,
        flow=t_config.OpticalFlowCalculationConfig(**REDUCED),
        device=t_config.DeviceConfig(model_dtype="float32"))
    cfg.to_json(cfg_path)
    rc = t_cli.main(["--dcm_folder", str(dcm_dir), "--save_folder",
                     str(tmp_path / "out"), "--nchunks", "2",
                     "--checkpoint_dir", ckpt, "--waveform_folder",
                     str(wf_dir), "--config", cfg_path, "--device", "cpu"])
    assert rc == 0
    direct = str(tmp_path / "direct.hdf5")
    t_pipe.process_video(
        str(dcm_dir / "p2.dcm"), direct,
        t_cli.load_segmentor(ckpt, model_dtype="float32", device="cpu"),
        verbose=False, mode="RVIO_2class", bkgd_comp="WASE",
        no_saliency=False, OF_algo="TVL1", include_waveforms=True,
        waveform_folder=str(wf_dir), config=cfg.flow, device="cpu")
    assert os.listdir(tmp_path / "out" / "chunk0") == ["p1.hdf5"]
    with h5py.File(tmp_path / "out" / "chunk1" / "p2.hdf5", "r") as fc, \
            h5py.File(direct, "r") as fd:
        assert sorted(fc.keys()) == sorted(fd.keys())
        assert {"ecg", "art", "rv", "av", "bkgd"} <= set(fc.keys())
        for key in fd.keys():
            np.testing.assert_array_equal(fc[key][()], fd[key][()], key)
        for key in fd["flow"].attrs:
            np.testing.assert_array_equal(fc["flow"].attrs[key],
                                          fd["flow"].attrs[key])
        assert not fc["flow"].attrs["no_saliency"]
        assert fc["flow"].attrs["waveforms_present"]


# --- tracing, the kernel build cache, HDF5 context managers ------------------

def test_stage_timer_and_profiled_stage():
    from torch.profiler import ProfilerActivity, profile

    from tee_optical_flow_torch.utils import (
        StageTimer, get_stage_report, trace_stage,
    )

    get_stage_report(reset=True)
    with StageTimer("a") as timer:
        pass
    with StageTimer("a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_stage("marked", profile=True):
            torch.ones(3).sum()
    report = get_stage_report(reset=True)
    assert list(report) == ["a", "marked"]
    assert report["a"]["calls"] == 2 and timer.elapsed >= 0
    assert any(e.name == "marked" for e in prof.events())
    assert get_stage_report() == {}


def test_enable_compilation_cache_moves_the_kernel_build(tmp_path,
                                                         monkeypatch):
    from tee_optical_flow_torch.core import enable_compilation_cache
    from tee_optical_flow_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    target = tmp_path / "kernels"
    assert enable_compilation_cache(str(target))
    assert cuda_lib.BUILD_DIR == target and target.is_dir()
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert not enable_compilation_cache(str(blocker / "sub"))
    assert cuda_lib.BUILD_DIR == target


def test_hdf5_context_managers_match_jax(tmp_path, rng):
    from tee_optical_flow_torch.io import HDF5Reader, HDF5Writer
    from tee_optical_flow_tpu.io import HDF5Reader as JReader

    data = rng.normal(size=(4, 3)).astype(np.float32)
    path = str(tmp_path / "sub" / "x.hdf5")
    HDF5Writer(path).write_dataset("d", data, units="cm/s", n=4)
    for reader in (HDF5Reader(path), JReader(path)):
        np.testing.assert_array_equal(reader.read_dataset("d"), data)
        attrs = reader.read_attributes("d")
        assert attrs["units"] == "cm/s" and attrs["n"] == 4
        with pytest.raises(KeyError):
            reader.read_dataset("nope")
