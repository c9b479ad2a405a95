"""The port's paths on the card, where no other test holds them there:
process_video through each route (the wrappers' ``launches.<wrapper>``
counters and the kernel library's device launches against the design,
the flow against the clip's analytic motion), the kernels held to their
plain versions on the arguments the Otsu cells' 33-frame clips hand them
(39 pairs a level), WASE, the command lines
(``cli.process`` with a checkpoint directory and a PipelineConfig JSON,
vit_b served in bfloat16 and int8, ``cli.train`` then ``cli.process``),
TV-L1's gamma path with its standalone medians, the frame-axis mesh and
the training mesh on one card, and the modules that run plain PyTorch on
a card against their CPU runs. Marked ``cuda``; without a CUDA device
every test skips, decided inside the ``card`` fixture.

The card suite, on the machine with the card (no JAX there, so the
repo's conftest cannot load; these files import none):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py tests/test_torch_attention.py \\
        tests/test_torch_labelling.py tests/test_torch_tracing.py \\
        tests/test_torch_train_mesh.py tests/test_torch_card_paths.py \\
        tests/test_torch_norm_kernel.py -q

The clips are ``echo_clip``'s (tests/test_torch_cuda.py) at the smallest
sizes that take each route: 256x320 keeps the production pyramids' five
levels (TV-L1's and DeepFlow's) with K1 at every TV-L1 level; 600x800
buckets to 608x800, whose finest level is above
``ops/tvl1.per_iteration_stop``'s rule and runs the block loop; 8 frames
are 7 pairs. Where the waveforms need two beats, and where the kernels
meet the main path's batch, the clip has 33 frames.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from tee_optical_flow_torch.ops import morphology as mo
from tee_optical_flow_torch.ops.cuda_lib import (
    device_launch_count, load_library,
)
from tee_optical_flow_torch.utils.tracing import (
    get_counters, get_stage_report,
)
from test_torch_cuda import NEAR, _max_abs, card, echo_clip  # noqa: F401
from test_torch_labelling import labelling_schedule, rounds_needed
from test_torch_train_mesh import MESHES, _specs, files  # noqa: F401

pytestmark = pytest.mark.cuda

FPS, SPACING_CM = 30, 0.05
SMALL, BLOCK_LOOP = (8, 256, 320), (8, 600, 800)
# flow on the wall against the analytic motion: median and p95 end-point
# error in px. The port's CPU run of the 33x480x640 clip measured a median
# of 0.013-0.033 px and a p95 of 0.065-0.078 (DeepFlow 0.034-0.044 and
# 0.098-0.119) over three windows of pairs; the bounds leave 3x of that
WALL_TVL1, WALL_DEEPFLOW = (0.1, 0.25), (0.13, 0.36)
# TV-L1 under the production config: 5 levels x 5 warps, one K1 or block
# loop call each (a block-loop call: 10 blocks of 30 steps); DeepFlow 5
# levels x 3 fixed points of K3. A tiled K3 call is 3 psi rounds x (1
# coefficients + 3 sweep launches of S = 4 SOR iterations), a resident one
# one launch
TV_CALLS, TV_WARPS, TV_OUTER, TV_INNER = 25, 5, 10, 30
DF_CALLS, K3_TILED = 15, 12
WRAPPERS = ("tvl1_outer_loop", "tvl1_block_loop", "tvl1_inner_block",
            "median_filter_5x5", "sor_sweeps", "connected_components",
            "rel_pos_attention", "residual_norm")
# the masks' labellings a clip: fill and size filter (Otsu), both for each
# of rv and av (RVIO_2class)
OTSU_LABELLINGS, RVIO_LABELLINGS = 2, 4
CLASSES = 3
# vit_b's transformer blocks: one attention launch and two residual_norm
# launches each a micro-batch
VITB_BLOCKS = 12
# the int8 segmentor's logits against bfloat16's, of their max-abs (the
# JAX package's bound, tests/test_models.py); float32 labels card against
# CPU at least this share equal (a label flips only on a near-tie)
INT8_REL, F32_AGREE = 0.15, 0.998
# the config-4 clip: its 16-frame contraction cycle lasts one second at
# COHORT_FPS, so 33 frames hold two beats; a synthetic ECG (500 Hz) has an
# R wave at the start of each contraction, an arterial trace (125 Hz) a
# pulse a second. Labels from the clip's geometry: rv the wall ring, av a
# disc at the ring centre of COHORT_AV_RADIUS x H (over the 500 px
# cleanup at 256 rows), background the rest
COHORT_FPS, COHORT_AV_RADIUS = 16.0, 0.06
COHORT_BEATS_S = (0.05, 1.05, 2.0)
# WASE against its float64 recomputation on the host (px: float32 sums
# over the clip in the card's order); card rows against the CPU's
COHORT_WASE_ATOL, COHORT_ROW_RTOL = 1e-5, 1e-5
# TV-L1 gamma: 5 levels x 5 warps x 10 outer iterations x u and v
GAMMA_MEDIANS_EPS0 = 5 * 5 * 10 * 2
# card against CPU: the baselines' and PromptAutoEncoder's outputs, of
# their max-abs; the saliency map's max-abs difference
REL, SALIENCY_ATOL = 1e-4, 1e-4
# the training mesh on one card against one process (vanilla policy,
# strict float32): losses, gradients (of each tensor's max-abs; a tensor
# zero in exact arithmetic holds float32 noise under GRAD_NOISE x the
# largest gradient on both sides), running statistics (of the largest of
# their kind), eval loss and DSC
LOSS_REL, GRAD_REL, GRAD_NOISE = 1e-4, 1e-3, 1e-6
STATS_REL, DSC_ABS = 1e-5, 1e-3


def _launches():
    """Every wrapper's ``launches.<wrapper>`` counter now."""
    now = get_counters()
    return {name: now.get(f"launches.{name}", 0) for name in WRAPPERS}


def _since(before, **want):
    """The wrappers' launches since ``before``, and the design: ``want``'s
    counts, 0 for every other wrapper."""
    now = _launches()
    return ({k: now[k] - before[k] for k in WRAPPERS},
            {k: want.get(k, 0) for k in WRAPPERS})


def _record_labellings(monkeypatch):
    """Every connected_components call from here on keeps its (N, H, W)
    mask and connectivity in the list returned."""
    calls = []
    inner = mo.connected_components

    def recording(mask, connectivity=2):
        m = mask.to(torch.bool).clone()
        calls.append((m[None] if m.ndim == 2 else m, connectivity))
        return inner(mask, connectivity)

    monkeypatch.setattr(mo, "connected_components", recording)
    return calls


def _planned_passes(calls):
    """The pass launches labelling_schedule plans for recorded
    labellings, each from a plain count of the rounds its mask needs."""
    return sum(labelling_schedule(rounds_needed(m, c), *m.shape[1:])[2]
               for m, c in calls)


def _write_dicom(folder, frames, name="echo.dcm"):
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip

    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, name)
    write_dicom_clip(path, np.repeat(frames[..., None], 3, axis=-1),
                     frame_rate=FPS, pixel_spacing=SPACING_CM)
    return path


def _layouts():
    """(layouts, save_fn): what process_video would write, kept as
    io/hdf5.optical_flow_layout's dict under the save path (the card's
    machine has no h5py)."""
    from tee_optical_flow_torch.io.hdf5 import optical_flow_layout

    out = {}

    def save(save_path, flow, echo, masks, metadata, waveforms,
             verbose=False, **kw):
        out[save_path] = optical_flow_layout(flow, echo, masks, metadata,
                                             waveforms, **kw)

    return out, save


def _check_schema(layout, n, h, w, mode):
    """The HDF5 schema: shapes, dtypes, mask names, the duplicated last
    flow frame, finite flow."""
    from tee_optical_flow_torch.flow.segment import LABEL_MAPS

    flow, attrs = layout["flow"]
    assert flow.shape == (n, h, w, 2) and flow.dtype == np.float16
    assert layout["echo"][0].shape == (n, h, w)
    names = ["otsu"] if mode == "otsu" else list(LABEL_MAPS[mode]) + ["bkgd"]
    assert list(attrs["labels"]) == names
    for name in names:
        mask = layout[name][0]
        assert mask.shape == (n, h, w, 2) and mask.dtype == bool, name
    np.testing.assert_array_equal(flow[-1], flow[-2])
    assert np.isfinite(flow.astype(np.float32)).all()
    assert attrs["nframes"] == n and attrs["mode"] == mode


def _wall_epe(flow_cm_s, truth, bounds):
    """The saved flow (cm/s) in px against the analytic motion on the
    wall: median and p95 end-point error within ``bounds``."""
    from tee_optical_flow_torch.synthetic import echo_sector_masks

    px = flow_cm_s[:-1].astype(np.float32) / (SPACING_CM * FPS)
    h, w = px.shape[1:3]
    wall = echo_sector_masks(h, w)["wall"].copy()
    wall[:8] = wall[-8:] = False
    wall[:, :8] = wall[:, -8:] = False
    epe = np.hypot(px[..., 0] - truth[..., 0],
                   px[..., 1] - truth[..., 1])[:, wall]
    med, p95 = float(np.median(epe)), float(np.percentile(epe, 95))
    assert med < bounds[0] and p95 < bounds[1], (med, p95)


def _vit_t_segmentor(labels):
    """vit_t at 1024, seeded random weights, bfloat16, micro-batch 4, its
    labels_device appending each call's labels to ``labels``."""
    from tee_optical_flow_torch.models import (
        build_sam_vit_t, make_clip_segmentor,
    )

    seg = make_clip_segmentor(build_sam_vit_t(
        num_classes=CLASSES, seed=0, dtype=torch.bfloat16), micro_batch=4)
    return _recording(seg, labels)


def _recording(seg, labels):
    inner = seg.labels_device

    def recording(clip, clip_hw):
        labels.append(inner(clip, clip_hw))
        return labels[-1]

    seg.labels_device = recording
    return seg


def _masks_match_cpu(labels, layout, mode="RVIO_2class"):
    """The saved masks bit-equal to clean_mask on the CPU over the card's
    labels (every bucketed frame)."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.segment import clean_mask

    ref = clean_mask(labels.cpu(), mode, config=default_optical_flow_config())
    n = layout["flow"][0].shape[0]
    for name in layout["flow"][1]["labels"]:
        np.testing.assert_array_equal(layout[name][0], ref[name][:n],
                                      err_msg=name)


# --- process_video, route by route --------------------------------------

PATHS = {
    "otsu_tvl1": ("otsu", "TVL1", SMALL),
    "otsu_tvl1_block_loop": ("otsu", "TVL1", BLOCK_LOOP),
    "otsu_deepflow": ("otsu", "deepflow", SMALL),
    "rvio_vit_t_tvl1": ("RVIO_2class", "TVL1", SMALL),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_process_video_launches_as_designed(card, path, tmp_path,
                                            monkeypatch):
    """One clip through process_video: each wrapper's calls and the kernel
    library's device launches equal the route's design (K1 one launch a
    call; the block loop outer x (sweeps + 1) at epsilon 0.01; K3 one
    resident or K3_TILED tiled launches a call; no standalone median and,
    for vit_t, no attention launch; each labelling whole groups of passes
    up to its first quiet pass), the flow within the wall bounds, and a
    segmentor's masks bit-equal to clean_mask on the CPU over its labels
    on the card."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import process_video
    from tee_optical_flow_torch.ops import deepflow_kernels as dk

    mode, algo, (n, h, w) = PATHS[path]
    frames, truth = echo_clip(n, h, w)
    dcm = _write_dicom(str(tmp_path), frames)
    lib = load_library()
    k3_calls = []
    inner = dk.sor_sweeps

    def k3(*args, **kw):
        k3_calls.append(tuple(args[0].shape[1:]))
        return inner(*args, **kw)

    monkeypatch.setattr(dk, "sor_sweeps", k3)
    labels = []
    seg = _vit_t_segmentor(labels) if mode != "otsu" else None
    layouts, save = _layouts()
    before = _launches()
    calls = _record_labellings(monkeypatch)
    torch.cuda.synchronize()
    device_launch_count(lib, reset=True)
    process_video(dcm, "out.hdf5", seg, verbose=False, mode=mode,
                  OF_algo=algo, no_saliency=True,
                  config=default_optical_flow_config(), _save_fn=save)
    torch.cuda.synchronize()
    devices = device_launch_count(lib)
    labellings = OTSU_LABELLINGS if mode == "otsu" else RVIO_LABELLINGS
    if algo == "deepflow":
        got, want = _since(before, sor_sweeps=DF_CALLS,
                           connected_components=labellings)
        design = sum(1 if dk.resident(lib, *s) else K3_TILED
                     for s in k3_calls)
    elif path == "otsu_tvl1_block_loop":
        # the finest level's warps take the block loop, the others K1
        got, want = _since(before, tvl1_outer_loop=TV_CALLS - TV_WARPS,
                           tvl1_block_loop=TV_WARPS,
                           connected_components=labellings)
        design = TV_CALLS - TV_WARPS + TV_WARPS * TV_OUTER * (
            lib.tvl1_block_sweeps(TV_INNER) + 1)
    else:
        got, want = _since(before, tvl1_outer_loop=TV_CALLS,
                           connected_components=labellings)
        design = TV_CALLS
    assert got == want
    assert len(calls) == labellings
    assert devices == design + _planned_passes(calls), (devices, design)
    (layout,) = layouts.values()
    _check_schema(layout, n, h, w, mode)
    _wall_epe(layout["flow"][0], truth,
              WALL_DEEPFLOW if algo == "deepflow" else WALL_TVL1)
    if mode == "otsu":
        otsu = layout["otsu"][0]
        assert otsu.any() and not otsu.all()
    else:
        _masks_match_cpu(labels[-1], layout)


# --- the kernels on the main path's own arguments ------------------------

# The Otsu cells' clips: 33 frames bucket to 40, so every level solves 39
# pairs. Per route, the wrapper recorded, the level shapes whose first call
# is held to the plain version, and each level's calls in one clip
MAIN_FRAMES, MAIN_PAIRS = 33, 39
MAIN_PATHS = {
    "tvl1_480x640": ("TVL1", (480, 640), "tvl1_outer_loop",
                     ((480, 640), (197, 262)), TV_WARPS),
    "tvl1_600x800": ("TVL1", (600, 800), "tvl1_block_loop",
                     ((608, 800),), TV_WARPS),
    "deepflow_480x640": ("deepflow", (480, 640), "sor_sweeps",
                         ((480, 640), (240, 320), (120, 160), (60, 80),
                          (30, 40)), DF_CALLS // 5),
}


def _device_launches(lib, fn):
    """fn()'s result and the kernel library's device launches it made."""
    torch.cuda.synchronize()
    device_launch_count(lib, reset=True)
    out = fn()
    torch.cuda.synchronize()
    return out, device_launch_count(lib)


@pytest.mark.parametrize("path", list(MAIN_PATHS))
def test_main_path_kernels_match_plain(card, path, tmp_path, monkeypatch):
    """A 33-frame Otsu clip through process_video at the cells' sizes, the
    first call of the route's kernel at each recorded level kept and held
    to its plain version on those arguments (39 pairs, the production
    iterations): K1 within 0.05 px at the path's epsilon 0.01 (a pair may
    stop one step apart on an ulp of its error sum) and bit-equal at 0;
    the block loop at 0.01 with every pair bit-equal to the plain state
    after a block count its stop reaches when a decision within NEAR of
    the threshold flips, bit-equal at 0, and K2 alone and the median
    bit-equal on its arguments; K3 bit-equal at each of DeepFlow's five
    levels. Each call makes its designed device launches, and each level
    the route's calls."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import process_video
    from tee_optical_flow_torch.ops import deepflow_kernels as dk
    from tee_optical_flow_torch.ops import tvl1 as tt
    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops import warp as tw

    algo, hw, name, shapes, per_level = MAIN_PATHS[path]
    frames, _ = echo_clip(MAIN_FRAMES, *hw)
    dcm = _write_dicom(str(tmp_path), frames)
    owner = dk if algo == "deepflow" else tt
    inner = getattr(owner, name)
    captured, calls = {}, {}

    def recording(*args, **kw):
        shape = tuple(args[0].shape[1:])
        calls[shape] = calls.get(shape, 0) + 1
        if shape in shapes and shape not in captured:
            captured[shape] = ([None if a is None else
                                tuple(t.clone() for t in a)
                                if isinstance(a, tuple) else a.clone()
                                for a in args], dict(kw))
        return inner(*args, **kw)

    monkeypatch.setattr(owner, name, recording)
    _, save = _layouts()
    process_video(dcm, "out.hdf5", None, verbose=False, mode="otsu",
                  OF_algo=algo, no_saliency=True,
                  config=default_optical_flow_config(), _save_fn=save)
    monkeypatch.undo()
    assert sorted(captured) == sorted(shapes)
    assert all(c == per_level for c in calls.values()), calls
    lib = load_library()
    for shape in shapes:
        args, kw = captured[shape]
        assert args[0].shape[0] == MAIN_PAIRS, (shape, args[0].shape)
        if algo == "deepflow":
            planes, match = args[:10], args[10] if len(args) > 10 else None
            got, dev = _device_launches(
                lib, lambda: dk.sor_sweeps(*planes, match, **kw))
            ref = dk.sor_sweeps_plain(*planes, match, **kw)
            assert _max_abs(got, ref) == 0.0, shape
            assert dev == (1 if dk.resident(lib, *shape) else K3_TILED)
            continue
        assert kw["epsilon"] == 0.01 and kw["use_median"], kw
        for eps in (0.01, 0.0):
            kwe = dict(kw, epsilon=eps)
            if name == "tvl1_outer_loop":
                got, dev = _device_launches(
                    lib, lambda: tk.tvl1_outer_loop(*args, **kwe))
                ref = tk.tvl1_outer_loop_plain(*args, **kwe)
                err = _max_abs(got, ref)
                assert err <= (0.05 if eps else 0.0), (shape, eps, err)
                assert dev == 1, (shape, eps, dev)
                continue
            got, dev = _device_launches(
                lib, lambda: tk.tvl1_block_loop(*args, **kwe))
            if eps:
                _, reachable, matched, margin = tk.block_loop_stops(
                    args, got, near=NEAR, **kwe)
                for j in range(MAIN_PAIRS):
                    assert reachable[j] & matched[j], (
                        j, reachable[j], matched[j], margin[j])
            else:
                assert _max_abs(got, tk.tvl1_block_loop_plain(
                    *args, **kwe)) == 0.0
            sweeps = lib.tvl1_block_sweeps(kw["inner_iters"])
            assert dev == kw["outer_iters"] * (sweeps + (1 if eps else 0))
        if name == "tvl1_block_loop":
            kw2 = dict(n_iters=kw["inner_iters"], l_t=kw["l_t"],
                       theta=kw["theta"], taut=kw["taut"])
            got, dev = _device_launches(
                lib, lambda: tk.tvl1_inner_block(*args, **kw2))
            assert _max_abs(got, tk.tvl1_inner_block_plain(
                *args, **kw2)) == 0.0
            assert dev == lib.tvl1_block_sweeps(kw["inner_iters"])
            u = args[4]
            assert torch.equal(tw.median_filter_5x5(u),
                               tw.median_filter_5x5_plain(u))


# --- WASE and waveforms (BASELINE config 4's clip path) ------------------

def _geometry_labels(h, w):
    """(h, w) uint8 labels from the clip's geometry: rv (1) the wall ring,
    av (2) a disc at the ring centre, background (0) the rest."""
    from tee_optical_flow_torch.synthetic import echo_sector_masks

    yy, xx = np.mgrid[0:h, 0:w]
    label_map = np.zeros((h, w), np.uint8)
    label_map[echo_sector_masks(h, w)["wall"]] = 1
    label_map[np.hypot(yy - 0.55 * h, xx - 0.5 * w)
              < COHORT_AV_RADIUS * h] = 2
    return label_map


def _waveforms(folder, base):
    """Synthetic ``<base>_II.npy`` (ECG, 500 Hz) and ``<base>_ART.npy``
    (arterial, 125 Hz) in ``folder``, as long as the config-4 clip."""
    seconds = 33 / COHORT_FPS
    ecg = 0.05 * np.sin(2 * np.pi * 0.4 * np.arange(int(seconds * 500))
                        / 500.0)
    for beat in COHORT_BEATS_S:
        c = int(beat * 500)
        ecg[c - 10:c + 11] += 1.2 * np.hanning(21)
    t_art = np.arange(int(seconds * 125)) / 125.0
    art = 80 + 20 * np.sin(2 * np.pi * (t_art - 0.3))
    np.save(os.path.join(folder, f"{base}_II.npy"), ecg)
    np.save(os.path.join(folder, f"{base}_ART.npy"), art)


@pytest.fixture(scope="module")
def config4(tmp_path_factory):
    """The 33x256x320 clip through process_video(mode="RVIO_2class",
    bkgd_comp="WASE", include_waveforms=True) on the card with geometry
    labels and the synthetic waveforms: its layout, and WASE's inputs and
    output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow import pipeline as pl

    folder = str(tmp_path_factory.mktemp("config4"))
    frames, _ = echo_clip(33, *SMALL[1:])
    _waveforms(folder, "clip")
    label_map = _geometry_labels(*SMALL[1:])
    wase = {}
    inner = pl.wase_background

    def recording(flow_pairs, bkgd):
        out = inner(flow_pairs, bkgd)
        wase.update(flow=flow_pairs.clone(), bkgd=bkgd.clone(), out=out)
        return out

    layouts, save = _layouts()
    pl.wase_background = recording
    try:
        pl.process_video(
            os.path.join(folder, "clip.dcm"), "clip.hdf5",
            lambda clip: np.broadcast_to(
                label_map, np.asarray(clip).shape[:3]).copy(),
            verbose=False, mode="RVIO_2class", OF_algo="TVL1",
            no_saliency=True, bkgd_comp="WASE", include_waveforms=True,
            waveform_folder=folder, config=default_optical_flow_config(),
            _clip_override=np.repeat(frames[..., None], 3, axis=-1),
            _metadata_override={"pixel_spacing": SPACING_CM,
                                "frame_rate": COHORT_FPS, "R_times": None,
                                "R_wave_data_present": False},
            _save_fn=save)
    finally:
        pl.wase_background = inner
    (layout,) = layouts.values()
    return layout, wase


def test_wase_and_waveforms_on_card(card, config4):
    """The waveforms saved; WASE on the card within COHORT_WASE_ATOL of
    its float64 recomputation on the host from the card's own flow and
    mask."""
    layout, wase = config4
    assert {"ecg", "art", "rv", "av", "bkgd"} <= set(layout)
    assert layout["flow"][1]["waveforms_present"]
    flow64 = wase["flow"].double().cpu()
    b_sum = wase["bkgd"].double().sum(dim=0).cpu()[..., None]
    total = (flow64 * b_sum).sum(dim=(1, 2, 3))
    count = ((flow64 != 0).double() * b_sum).sum(dim=(1, 2, 3))
    bg64 = torch.where(count > 0, total / count, torch.zeros_like(total))
    err = float((wase["out"].double().cpu()
                 - (flow64 - bg64[:, None, None, None])).abs().max())
    assert err <= COHORT_WASE_ATOL, err


def _statistics_only(self, filt_arr, frame_times, sys_frames, dia_frames,
                     nframes, *args, cc_method="angle", **kw):
    """VisualizationManager.plot_peak_line without the drawing (the
    card's machine has no matplotlib): its 9-tuple."""
    return self.single_statistics(self.single_peak_data(
        filt_arr, frame_times, sys_frames, dia_frames, nframes,
        cc_method=cc_method))


def _radlong_statistics_only(self, hi_rad, lo_rad, hi_long, lo_long,
                             frame_times, sys_frames, dia_frames, nframes,
                             *args, cc_method="angle", **kw):
    """plot_peak_line_radlong without the drawing: its 18-tuple."""
    rad = self.radlong_peak_data(hi_rad, lo_rad, frame_times, sys_frames,
                                 dia_frames, nframes, cc_method=cc_method)
    lng = self.radlong_peak_data(hi_long, lo_long, frame_times, sys_frames,
                                 dia_frames, nframes, cc_method=cc_method)
    return self.radlong_statistics(rad, lng)


@pytest.mark.parametrize("entry", ["percentile_plot",
                                   "percentile_plot_radlong"])
@pytest.mark.parametrize("cc_method", ["ecg_lazy", "arterial"])
def test_legacy_shim_card_matches_cpu(card, config4, entry, cc_method,
                                      tmp_path, monkeypatch):
    """The legacy entry points on the config-4 dataset, drawing left out:
    the card's statistics equal the CPU's from the card's AV centroid
    track (floats within COHORT_ROW_RTOL, integers equal), not all 0."""
    from tee_optical_flow_torch import legacy
    from tee_optical_flow_torch.analysis import centroid as cen
    from tee_optical_flow_torch.analysis import histograms as hist
    from tee_optical_flow_torch.dataset import OpticalFlowDataset
    from tee_optical_flow_torch.viz.manager import VisualizationManager

    ds = OpticalFlowDataset("clip.hdf5", _file_override=config4[0])
    monkeypatch.setattr(VisualizationManager, "plot_peak_line",
                        _statistics_only)
    monkeypatch.setattr(VisualizationManager, "plot_peak_line_radlong",
                        _radlong_statistics_only)
    fn = getattr(legacy, entry)
    got = fn(ds, "velocity", "rv", cc_method, save_dir=str(tmp_path),
             device=card)
    cents = cen.calc_AV_centroid(ds.get_mask("av"), ds.nframes, device=card)
    monkeypatch.setattr(hist, "calc_AV_centroid", lambda *a, **k: cents)
    ref = fn(ds, "velocity", "rv", cc_method, save_dir=str(tmp_path),
             device="cpu")
    assert len(got) == len(ref) == (18 if entry.endswith("radlong") else 9)
    for i, (g, r) in enumerate(zip(got, ref)):
        if isinstance(r, (int, np.integer)) or r == 0:
            assert g == r, (i, g, r)
        else:
            assert abs(g - r) <= COHORT_ROW_RTOL * abs(r), (i, g, r)
    assert any(v != 0 for v in got)


# --- the command lines ----------------------------------------------------

def _checkpoint(folder, arch, model):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "args.json"), "w") as f:
        json.dump({"num_cls": CLASSES, "arch": arch}, f)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(folder, "checkpoint_best.pth"))
    return folder


def _pipeline_json(folder, model_dtype):
    """BASELINE config 5's PipelineConfig (RVIO_2class, TV-L1 under the
    production config, saliency, WASE, waveforms) as a JSON file."""
    from tee_optical_flow_torch.config import DeviceConfig, PipelineConfig

    cfg = PipelineConfig(mode="RVIO_2class", of_algo="tvl1",
                         no_saliency=False, wase=True,
                         include_waveforms=True,
                         device=DeviceConfig(model_dtype=model_dtype))
    path = os.path.join(folder, f"pipeline_{model_dtype}.json")
    cfg.to_json(path)
    return cfg, path


def test_cli_process_config5_on_card(card, tmp_path, monkeypatch):
    """cli.process.main over three 33x256x320 DICOMs at --nchunks 2 with a
    vit_t checkpoint directory, their waveforms and config 5's
    PipelineConfig JSON, writes handed to ``_save_fn``: rc 0; the 2 + 1
    split; each clip's schema with its waveforms and saliency flag; 25 K1
    calls and four labellings a clip; the first clip's arrays bit-equal to
    a direct process_video call with a segmentor loaded from the same
    directory where their labels agree, else the labels at least
    F32_AGREE equal."""
    from tee_optical_flow_torch.cli import process as cli
    from tee_optical_flow_torch.flow import pipeline as pl
    from tee_optical_flow_torch.models import build_sam_vit_t

    n, h, w = 33, *SMALL[1:]
    dcm_dir, wf_dir, out = (str(tmp_path / d) for d in ("dcm", "wf", "out"))
    os.makedirs(wf_dir)
    names = ["a.dcm", "b.dcm", "c.dcm"]
    for seed, name in enumerate(names):
        _write_dicom(dcm_dir, echo_clip(n, h, w, seed=seed)[0], name)
        _waveforms(wf_dir, name[:-4])
    ckpt = _checkpoint(str(tmp_path / "run"), "vit_t", build_sam_vit_t(
        num_classes=CLASSES, seed=0, device="cpu"))
    cfg, cfg_path = _pipeline_json(str(tmp_path), "bfloat16")
    labels = []
    inner = cli.load_segmentor
    monkeypatch.setattr(cli, "load_segmentor", lambda *a, **k: _recording(
        inner(*a, **k), labels))
    layouts, save = _layouts()
    before = _launches()
    rc = cli.main(["--dcm_folder", dcm_dir, "--save_folder", out,
                   "--nchunks", "2", "--checkpoint_dir", ckpt,
                   "--waveform_folder", wf_dir, "--config", cfg_path],
                  _save_fn=save)
    assert rc == 0
    got, want = _since(before, tvl1_outer_loop=TV_CALLS * len(names),
                       connected_components=RVIO_LABELLINGS * len(names))
    assert got == want
    expect = [os.path.join(out, "chunk0", "a.hdf5"),
              os.path.join(out, "chunk0", "b.hdf5"),
              os.path.join(out, "chunk1", "c.hdf5")]
    assert sorted(layouts) == expect
    for path in expect:
        layout = layouts[path]
        _check_schema(layout, n, h, w, "RVIO_2class")
        assert {"ecg", "art"} <= set(layout)
        attrs = layout["flow"][1]
        assert attrs["waveforms_present"] and not attrs["no_saliency"]
    direct, save_direct = _layouts()
    direct_labels = []
    pl.process_video(
        os.path.join(dcm_dir, names[0]), "direct.hdf5",
        _recording(inner(ckpt, model_dtype="bfloat16"), direct_labels),
        verbose=False, mode="RVIO_2class", bkgd_comp="WASE",
        no_saliency=False, OF_algo="TVL1", include_waveforms=True,
        waveform_folder=wf_dir, config=cfg.flow, _save_fn=save_direct)
    (ref,) = direct.values()
    got = layouts[expect[0]]
    assert sorted(got) == sorted(ref)
    agree = float((labels[0] == direct_labels[0]).float().mean())
    if agree == 1.0:
        for key in ref:
            np.testing.assert_array_equal(got[key][0], ref[key][0],
                                          err_msg=key)
    else:
        # WASE couples every pair to the clip's whole background mask
        assert agree >= F32_AGREE, agree


def test_cli_process_serves_vit_b_in_bfloat16_and_int8(card, tmp_path,
                                                       monkeypatch):
    """cli.process over one 8x256x320 DICOM with a vit_b checkpoint
    directory under config 5's PipelineConfig, in bfloat16 and in int8
    weights: rc 0; 25 K1 calls, four labellings, the attention kernel
    once and the residual pass twice a block and micro-batch (VITB_BLOCKS
    blocks a micro-batch through the encoder); the schema; the masks
    bit-equal to clean_mask on the CPU over the card's labels; int8 logits
    within INT8_REL of bfloat16's."""
    from tee_optical_flow_torch.cli import process as cli
    from tee_optical_flow_torch.models import (
        build_sam_vit_b, preprocess_frames,
    )

    n, h, w = SMALL
    frames = echo_clip(n, h, w)[0]
    dcm_dir, wf_dir = str(tmp_path / "dcm"), str(tmp_path / "wf")
    _write_dicom(dcm_dir, frames)
    os.makedirs(wf_dir)
    _waveforms(wf_dir, "echo")
    ckpt = _checkpoint(str(tmp_path / "run"), "vit_b", build_sam_vit_b(
        num_classes=CLASSES, seed=0, device="cpu"))
    inner = cli.load_segmentor
    x = preprocess_frames(torch.from_numpy(frames[:4]).to(card), 1024)
    logits = {}
    for dtype in ("bfloat16", "int8"):
        _, cfg_path = _pipeline_json(str(tmp_path), dtype)
        labels, segs = [], []

        def load(*args, **kw):
            segs.append(_recording(inner(*args, **kw), labels))
            return segs[-1]

        monkeypatch.setattr(cli, "load_segmentor", load)
        layouts, save = _layouts()
        before = _launches()
        encoders = get_stage_report().get("sam_encoder", {}).get("calls", 0)
        rc = cli.main(["--dcm_folder", dcm_dir, "--save_folder",
                       str(tmp_path / f"out_{dtype}"), "--checkpoint_dir",
                       ckpt, "--waveform_folder", wf_dir, "--config",
                       cfg_path], _save_fn=save)
        assert rc == 0
        encoders = get_stage_report()["sam_encoder"]["calls"] - encoders
        assert encoders > 0
        got, want = _since(before, tvl1_outer_loop=TV_CALLS,
                           connected_components=RVIO_LABELLINGS,
                           rel_pos_attention=VITB_BLOCKS * encoders,
                           residual_norm=2 * VITB_BLOCKS * encoders)
        assert got == want, dtype
        (layout,) = layouts.values()
        _check_schema(layout, n, h, w, "RVIO_2class")
        _masks_match_cpu(labels[0], layout)
        with torch.no_grad():
            logits[dtype] = segs[0].forward(x)[0].float()
    err = float((logits["int8"] - logits["bfloat16"]).abs().max())
    assert err <= INT8_REL * float(logits["bfloat16"].abs().max()), err


def test_cli_train_then_process_on_card(card, tmp_path):
    """cli.train on the card (vit_t at 64, 2 epochs on PNGs of the clip
    with geometry labels) writes args.json and checkpoint_best.pth;
    cli.process serves that directory on the card: rc 0, the schema."""
    from PIL import Image

    from tee_optical_flow_torch.cli import process as cli_process
    from tee_optical_flow_torch.cli import train as cli_train

    n, h, w = SMALL
    frames = echo_clip(n, h, w)[0]
    img, mask = tmp_path / "img", tmp_path / "mask"
    img.mkdir()
    mask.mkdir()
    Image.fromarray(_geometry_labels(h, w)).save(mask / "labels.png")
    for k in range(n):
        Image.fromarray(np.repeat(frames[k][..., None], 3, axis=-1)).save(
            img / f"{k}.png")
    for name, ks in (("train", range(4)), ("val", range(4, 8))):
        (tmp_path / f"{name}.csv").write_text(
            "".join(f"{k}.png,labels.png\n" for k in ks))
    run = str(tmp_path / "run")
    rc = cli_train.main([
        "--dir_checkpoint", run, "--img_folder", str(img), "--mask_folder",
        str(mask), "--train_img_list", str(tmp_path / "train.csv"),
        "--val_img_list", str(tmp_path / "val.csv"), "--num_cls",
        str(CLASSES), "--image_size", "64", "--out_size", "16", "--epochs",
        "2", "-b", "2", "--warmup_period", "2", "--device", "cuda"])
    assert rc == 0
    assert {"args.json", "checkpoint_best.pth"} <= set(os.listdir(run))
    dcm_dir = str(tmp_path / "dcm")
    _write_dicom(dcm_dir, frames)
    layouts, save = _layouts()
    rc = cli_process.main(["--dcm_folder", dcm_dir, "--save_folder",
                           str(tmp_path / "out"), "--checkpoint_dir", run,
                           "--mode", "RVIO_2class"], _save_fn=save)
    assert rc == 0
    (layout,) = layouts.values()
    _check_schema(layout, n, h, w, "RVIO_2class")


# --- TV-L1's gamma path: the standalone median --------------------------

def test_tvl1_gamma_path_launches_the_median(card, tmp_path, monkeypatch):
    """process_video with tvl1_gamma=1.0 under the production config: no
    K1, every device launch but the labellings' a standalone median (at
    most GAMMA_MEDIANS_EPS0: the epsilon stop ends a warp's outer loop
    once every pair is frozen), the flow within the wall bounds, the
    median bit-equal to its plain version on the finest level's arguments
    the path handed it; at epsilon 0 the solve makes GAMMA_MEDIANS_EPS0
    median launches."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import (
        compute_clip_flow, process_video,
    )
    from tee_optical_flow_torch.ops import tvl1 as tt
    from tee_optical_flow_torch.ops import warp as tw
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8

    n, h, w = SMALL
    frames, truth = echo_clip(n, h, w)
    dcm = _write_dicom(str(tmp_path), frames)
    cfg = default_optical_flow_config()
    cfg.tvl1_gamma = 1.0
    medians = {}
    inner = tt.median_filter_5x5

    def recording(f):
        medians.setdefault(tuple(f.shape), f.clone())
        return inner(f)

    monkeypatch.setattr(tt, "median_filter_5x5", recording)
    lib = load_library()
    layouts, save = _layouts()
    before = _launches()
    calls = _record_labellings(monkeypatch)
    torch.cuda.synchronize()
    device_launch_count(lib, reset=True)
    process_video(dcm, "out.hdf5", None, verbose=False, mode="otsu",
                  OF_algo="TVL1", no_saliency=True, config=cfg,
                  _save_fn=save)
    torch.cuda.synchronize()
    medians_run = device_launch_count(lib) - _planned_passes(calls)
    assert 0 < medians_run <= GAMMA_MEDIANS_EPS0
    got, want = _since(before, median_filter_5x5=medians_run,
                       connected_components=OTSU_LABELLINGS)
    assert got == want
    (layout,) = layouts.values()
    _wall_epe(layout["flow"][0], truth, WALL_TVL1)
    finest = medians[max(medians, key=lambda s: s[1] * s[2])]
    assert torch.equal(tw.median_filter_5x5(finest),
                       tw.median_filter_5x5_plain(finest))
    cfg.tvl1_epsilon = 0.0
    images = img2uint8(gray_from_clip(torch.from_numpy(frames[:4]).to(card)))
    before = _launches()
    compute_clip_flow(images, "TVL1", cfg)
    assert _launches()["median_filter_5x5"] - before["median_filter_5x5"] \
        == GAMMA_MEDIANS_EPS0


# --- the frame-axis mesh on one card --------------------------------------

@pytest.mark.parametrize("algo,shards", [("TVL1", 1), ("TVL1", 2),
                                         ("deepflow", 2)])
def test_sharded_flow_on_one_card(card, algo, shards):
    """compute_clip_flow_sharded over ``shards`` entries of cuda:0 (the
    shards one after the other): bit-equal to the unsharded solve, each
    shard making the unsharded solve's wrapper calls and device
    launches."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow import pipeline as tp
    from tee_optical_flow_torch.ops.deepflow import deepflow_config_kwargs
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.ops.tvl1 import tvl1_config_kwargs
    from tee_optical_flow_torch.parallel import make_mesh

    cfg = default_optical_flow_config()
    frames, _ = echo_clip(*SMALL)
    images = img2uint8(gray_from_clip(torch.from_numpy(frames).to(card)))
    solve, kw = ((tp.tvl1_flow_pairs, tvl1_config_kwargs(cfg))
                 if algo == "TVL1" else
                 (tp.deepflow_pairs, deepflow_config_kwargs(cfg)))
    lib = load_library()
    runs = []
    for fn in (lambda: solve(images[:-1], images[1:], **kw),
               lambda: tp.compute_clip_flow_sharded(
                   images, make_mesh(devices=["cuda:0"] * shards), algo,
                   cfg)):
        before = _launches()
        torch.cuda.synchronize()
        device_launch_count(lib, reset=True)
        flow = fn()
        torch.cuda.synchronize()
        runs.append((flow, _since(before)[0], device_launch_count(lib)))
    (ref, ref_calls, ref_dev), (flow, calls, dev) = runs
    assert flow.shape == ref.shape == (SMALL[0] - 1, *SMALL[1:], 2)
    assert torch.equal(flow, ref)
    assert calls == {k: shards * v for k, v in ref_calls.items()}
    assert dev == shards * ref_dev


# --- SAM fine-tuning on a mesh of ranks of one card (gloo) ----------------

@pytest.fixture(scope="module")
def card_ranks(files):
    """{mesh: (rank results, one-process results)} for the vanilla policy
    on 2x1 and 2x2 meshes whose every entry is cuda:0: one launch per
    world size, each held to the one-process run on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tee_optical_flow_torch.parallel.launch import launch
    from tee_optical_flow_torch.train.mesh_steps import run_steps

    def specs(key):
        (n, m), shard = MESHES[key] if key != "1x1" else ((1, 1), False)
        return [dict(s, devices=["cuda:0"] * (n * m), timed=0, light=True)
                for s in _specs(files, (n, m), shard, ["vanilla"])]

    (ref,) = run_steps(specs("1x1"))
    out = {}
    for key in ("2x1", "2x2"):
        world = MESHES[key][0][0] * MESHES[key][0][1]
        ranks = launch(run_steps, (specs(key),),
                       devices=["cuda:0"] * world, timeout=600)
        out[key] = ([r[0] for r in ranks], ref)
    return out


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_mesh_step_on_one_card_matches_one_process(card, card_ranks, mesh):
    """Every rank over gloo holds the same gradients, statistics and
    losses; rank 0's are the one-process run's on the card within the
    bounds above; the batch norms are cross-replica on a data axis and
    tensors split on a model axis."""
    res, ref = card_ranks[mesh]
    (n, m), shard = MESHES[mesh]
    assert all(r["backend"] == "gloo" for r in res)
    assert res[0]["cross_replica"] == (res[0]["batchnorms"] if n > 1 else 0)
    assert bool(res[0]["split"]) == shard
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for kind in ("grads", "stats"):
            for name, t in res[0][kind].items():
                assert torch.equal(r[kind][name], t), (kind, name)
    got = res[0]
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= LOSS_REL * abs(b), (got["losses"],
                                                 ref["losses"])
    assert sorted(got["grads"]) == sorted(ref["grads"])
    gmax = max(float(v.abs().max()) for v in ref["grads"].values())
    for name, r in ref["grads"].items():
        scale = float(r.abs().max())
        g = got["grads"][name]
        if scale < GRAD_NOISE * gmax:
            assert float(g.abs().max()) < GRAD_NOISE * gmax, name
        else:
            assert float((g - r).abs().max()) <= GRAD_REL * scale, name
    for kind in ("running_mean", "running_var"):
        keys = [k for k in ref["stats"] if k.endswith(kind)]
        top = max(float(ref["stats"][k].abs().max()) for k in keys)
        for k in keys:
            err = float((got["stats"][k] - ref["stats"][k]).abs().max())
            assert err <= STATS_REL * top, (k, err)
    assert abs(got["eval"][0] - ref["eval"][0]) <= LOSS_REL * abs(
        ref["eval"][0])
    assert abs(got["eval"][1] - ref["eval"][1]) <= DSC_ABS


# --- plain PyTorch on the card against the CPU ----------------------------

def test_saliency_card_matches_cpu(card):
    """fine_grained_saliency of the clip's gray frames, card against CPU
    within SALIENCY_ATOL."""
    from tee_optical_flow_torch.ops.imaging import gray_from_clip
    from tee_optical_flow_torch.ops.saliency import fine_grained_saliency

    gray = gray_from_clip(torch.from_numpy(echo_clip(*SMALL)[0]).to(card))
    got = fine_grained_saliency(gray)
    ref = fine_grained_saliency(gray.cpu())
    assert got.shape == gray.shape
    assert float((got.cpu() - ref).abs().max()) <= SALIENCY_ATOL


def test_prompt_autoencoder_card_matches_cpu(card):
    """PromptAutoEncoder (seeded weights) on 4 preprocessed frames at
    1024 in float32: the dense embedding within REL of its max-abs, the
    sparse one empty."""
    from tee_optical_flow_torch.models.prompt_encoder import (
        PromptAutoEncoder,
    )
    from tee_optical_flow_torch.models.sam import preprocess_frames

    torch.manual_seed(0)
    pae = PromptAutoEncoder().eval()
    frames = echo_clip(4, *SMALL[1:])[0]
    x = preprocess_frames(torch.from_numpy(frames), 1024)
    with torch.no_grad():
        _, ref = pae(x)
        sparse, got = pae.to(card)(x.to(card))
    assert tuple(got.shape) == (4, 256, 255, 255)
    assert tuple(sparse.shape) == (4, 0, 256)
    assert float((got.cpu() - ref).abs().max()) <= REL * float(
        ref.abs().max())


BASELINES = ("unet", "transunet", "munet", "goinnet", "vit", "resnet",
             "seresnet", "vgg", "squeezenet", "efficientnet", "vae",
             "discriminator", "tag", "implicitnet", "implicitefficientnet",
             "smalldecoder")


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_forward_card_matches_cpu(card, name):
    """Each baseline network at its default widths (get_network's 2
    classes), a batch of 2 at 128 in eval mode (the implicit critics on a
    1-channel segmentation, a label and a 3-channel image; SmallDecoder
    on a 256-channel map at 1/8 the size): the card's output within REL of
    the CPU's max-abs."""
    from tee_optical_flow_torch.models import baselines as tb

    rng = np.random.default_rng(0)
    b, s = 2, 128

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    img = normal(b, 3, s, s)
    if name == "smalldecoder":
        build, inputs = tb.SmallDecoder, [normal(b, 256, s // 8, s // 8)]
    else:
        kw = dict(image_size=s) if name in ("vit", "vae") else {}
        build = lambda: tb.get_network(name, **kw)  # noqa: E731
        inputs = ([torch.from_numpy(rng.uniform(size=(b, 1, s, s)).astype(
            np.float32)), torch.from_numpy(rng.integers(0, 2, b).astype(
                np.float32)), img] if name.startswith("implicit") else [img])
    torch.manual_seed(0)
    cpu = build().eval()
    gpu = copy.deepcopy(cpu).to(card)
    with torch.no_grad():
        ref = cpu(*inputs)
        got = gpu(*[t.to(card) for t in inputs])
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        g = g.float().cpu()
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        assert float((g - r).abs().max()) <= REL * float(r.abs().max())
