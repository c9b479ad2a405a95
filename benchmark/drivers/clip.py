"""Clip cells: a cohort of synthetic echo DICOMs through the program's
``flow.pipeline.process_video``, one after another, as ``process_folder``'s
loop calls it, with a ``_save_fn`` of the benchmark's own that keeps what
the comparison needs (the card's machine has no h5py).

Set-up: the kernel and DICOM libraries (built once per checkout), the
pool of clips from the seed on the device, written as uncompressed DICOMs
into TMPDIR, and one warm-up clip, which has every shape the window
uses. Window: clips taken in turn from the
pool until ``seconds`` have passed; ``clip_s`` is the time from the
window's start to the end of its last clip over the clips completed.

After the window: the peak memory is read, the program's state freed,
and a sample of the completed clips drawn from the seed is held to the
plain reference (``benchmark/reference``), computed from the benchmark's
own frames: the decoded luma, every mask and the flow. A reading that is
not a finite number counts as infinite, so it fails its limit.

With a trace, the window's first clips run under the profiler; the
program's stages are read per clip, and the reference's solve of the
profiled clips counts the TV-L1 work they needed.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np

from .. import counts, inputs
from ..reference import masks as ref_masks
from ..reference import tvl1 as ref_tvl1
from ..trace import Spans, profile


def _gray(frames):
    """Luma of RGB-coded grayscale uint8 frames: the channel over 255."""
    import torch

    return frames.to(torch.float32) / 255.0


@contextlib.contextmanager
def tf32(enabled: bool):
    """Matrix products and convolutions in TF32 or not, inside the block."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_outputs(frames, cfg: dict, traffic: dict, dtype=None,
                      work=None, with_tf32=False) -> dict:
    """The plain reference's arrays for one clip of (N, H, W) uint8 frames
    on the device, in the units ``process_video`` hands its save function:
    the luma and the flow in float16, the flow scaled by the clip's pixel
    spacing x frame rate and its last pair repeated, the masks as (N, H, W)
    bools. ``dtype`` computes the flow and the threshold in
    another type, ``with_tf32`` the resize products in TF32 (the
    controls); by default every product is float32, TF32 off."""
    import torch

    dtype = dtype or torch.float32
    flow_cfg = cfg["flow"]
    if cfg["mode"] != "otsu" or cfg["of_algo"].lower() != "tvl1" \
            or flow_cfg["tvl1_gamma"] != 0 or not cfg["no_saliency"]:
        raise NotImplementedError("the reference makes Otsu masks and "
                                  "solves TV-L1 without the illumination "
                                  "term on normalised frames")
    gray = _gray(frames)
    m = ref_masks.otsu_masks(gray.to(dtype), flow_cfg)
    with tf32(with_tf32):
        flow = ref_tvl1.clip_flow(ref_tvl1.img2uint8(gray.to(dtype)),
                                  flow_cfg, work=work,
                                  dtype=dtype).to(torch.float32)
    cf = torch.tensor(traffic["pixel_spacing_cm"] * traffic["frame_rate"],
                      dtype=torch.float32, device=flow.device)
    flow = (flow * cf).to(torch.float16)
    flow = torch.cat([flow, flow[-1:]])
    return {"echo": gray.to(torch.float16), "masks": m, "flow": flow}


def compare(got: dict, ref: dict, px_per_unit: float) -> dict:
    """Per clip: luma values that differ, mask pixels that differ (over
    every mask, each as one channel), and the flow's widest gap in px
    (the stored flow times ``px_per_unit``)."""
    import torch

    dev = ref["flow"].device
    echo = torch.from_numpy(np.ascontiguousarray(got["echo"])).to(dev)
    decode = int((echo != ref["echo"]).sum())
    if set(got["masks"]) != set(ref["masks"]):
        mask = float("inf")
    else:
        mask = sum(int((torch.from_numpy(np.ascontiguousarray(
            got["masks"][k][..., 0])).to(dev) != ref["masks"][k]).sum())
            for k in ref["masks"])
    flow = torch.from_numpy(np.ascontiguousarray(got["flow"])).to(dev)
    if flow.shape != ref["flow"].shape:
        gap = float("inf")
    else:
        gap = float((flow.float() - ref["flow"].float()).abs().max()
                    * px_per_unit)
    return {"decode_diff": decode, "mask_diff": mask, "flow_gap_px": gap}


@contextlib.contextmanager
def dicom_pool(clips, traffic: dict):
    """The pool's clips written as RGB-coded uncompressed DICOMs into a
    directory of TMPDIR, removed on exit; yields their paths."""
    workdir = tempfile.mkdtemp(prefix="tee-bench-")
    try:
        paths = []
        for j, frames in enumerate(clips.cpu().numpy()):
            paths.append(os.path.join(workdir, f"clip{j}.dcm"))
            inputs.write_dicom(
                paths[-1], np.repeat(frames[..., None], 3, axis=-1),
                frame_rate=traffic["frame_rate"],
                pixel_spacing=traffic["pixel_spacing_cm"])
        yield paths
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: Optional[str] = None) -> dict:
    """One run of a clip cell (see the module docstring). ``control``
    puts a control in the program's place: ``"bf16-reference"`` the
    plain reference computed in bfloat16, ``"tf32-reference"`` with its
    products in TF32."""
    import torch

    from tee_optical_flow_torch.config import OpticalFlowCalculationConfig
    from tee_optical_flow_torch.flow import pipeline
    from tee_optical_flow_torch.utils import get_stage_report

    cfg, traffic = cell["config_data"], cell["traffic_data"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from tee_optical_flow_torch.io import dicom_native
        from tee_optical_flow_torch.ops import cuda_lib

        cuda_lib.load_library()
        dicom_native.native_available()
        print(f"libraries: kernels {cuda_lib.build_info}, dicomlite "
              f"{dicom_native.build_info}", file=sys.stderr)
    clips = inputs.echo_clips(seed, traffic["pool"], traffic["frames"],
                              traffic["height"], traffic["width"],
                              amplitudes=traffic["amplitudes"],
                              period=traffic["period_frames"], device=device)
    kwargs = dict(mode=cfg["mode"], OF_algo=cfg["of_algo"],
                  no_saliency=cfg["no_saliency"], device=device,
                  config=OpticalFlowCalculationConfig.from_dict(cfg["flow"]),
                  verbose=False)
    kept = {}

    def keeper(k):
        def save(save_path, flow_arr, echo_gray, mask_dict, *args, **kw):
            kept[k] = {"flow": flow_arr, "echo": echo_gray,
                       "masks": mask_dict}
        return save

    def discard(*args, **kw):
        return None

    spans = Spans()
    order = []
    attempted = failed = 0
    traced = None
    with dicom_pool(clips, traffic) as paths:
        def one(k, save):
            j = k % len(paths)
            if control in ("bf16-reference", "tf32-reference"):
                ref = reference_outputs(
                    clips[j], cfg, traffic,
                    dtype=torch.bfloat16 if control == "bf16-reference"
                    else torch.float32,
                    with_tf32=control == "tf32-reference")
                save(None, ref["flow"].cpu().numpy(),
                     ref["echo"].cpu().numpy(),
                     {name: np.repeat(m.cpu().numpy()[..., None], 2, axis=-1)
                      for name, m in ref["masks"].items()})
                return
            with spans.span("clip"):
                pipeline.process_video(paths[j], f"clip{k}.hdf5", None,
                                       _save_fn=save, **kwargs)

        for k in range(traffic["warm_clips"]):
            one(k, discard)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        stage = pipeline.trace_stage
        if trace:
            pipeline.trace_stage = spans.wrap_stage(stage)
        get_stage_report(reset=True)
        t0 = time.perf_counter()
        try:
            while True:
                first = attempted
                # with a trace, the window's first clips run as one span
                # under the profiler
                count = traffic["profiled_clips"] if trace and not first \
                    else 1
                ks = range(first, first + count)
                attempted += count
                order.extend(k % len(paths) for k in ks)

                def step(ks=ks):
                    for k in ks:
                        one(k, keeper(k))
                try:
                    if trace and not first:
                        traced = profile(step, spans)
                    else:
                        step()
                except Exception:  # a clip that fails counts; the run goes on
                    failed += count
                    traceback.print_exc(file=sys.stderr)
                t_end = time.perf_counter()
                if t_end - t0 >= seconds:
                    break
        finally:
            pipeline.trace_stage = stage
    clip_s = (t_end - t0) / attempted
    stages = {name: v["total_s"] / attempted
              for name, v in get_stage_report(reset=True).items()}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card
                   else "cpu", "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                   if on_card else 0}
    if on_card:
        torch.cuda.empty_cache()

    run = {"driver": "clip", "attempted": attempted, "failed": failed,
           "device": device_info,
           "end_to_end": {"clip_s": (clip_s, "s"), "setup_s": (setup_s, "s")},
           "clip_s": clip_s, "stages": stages, "trace": traced,
           "profiled_clip_s": None if traced is None
           else traced["window_s"] / traffic["profiled_clips"]}
    run["checks"], run["tvl1_bound_s"] = check_clips(
        cell, clips, kept, order, seed, trace)
    return run


def check_clips(cell, clips, kept, order, seed, trace):
    """The sampled clips against the reference; with a trace also the
    profiled clips' counted TV-L1 work. Returns (checks, bound seconds of
    the profiled clips' TV-L1 work, or None)."""
    from .. import harness

    cfg, traffic = cell["config_data"], cell["traffic_data"]
    limits = cell["limits"]
    done = sorted(kept)
    rng = inputs.seed_rng(seed, "sample")
    sample, seen = [], set()
    for k in rng.permutation(done):
        if order[k] not in seen and len(sample) < traffic["checked_clips"]:
            sample.append(int(k))
            seen.add(order[k])
    profiled = list(range(traffic["profiled_clips"])) if trace else []
    worst = {"decode_diff": 0, "mask_diff": 0, "flow_gap_px": 0.0}
    bound = 0.0
    for k in sorted(set(sample) | set(profiled)):
        if k not in kept:
            continue
        frames = clips[order[k]]
        work = ref_tvl1.Work()
        got = kept[k]
        ref = reference_outputs(frames, cfg, traffic, work=work)
        if k in profiled:
            bound += counts.tvl1_bound_s(work.calls)
        if k not in sample:
            continue
        diffs = compare(got, ref, 1.0 / (traffic["pixel_spacing_cm"]
                                         * traffic["frame_rate"]))
        for name, value in diffs.items():
            # max() keeps its first argument against a NaN: a reading
            # that is not finite is infinite here
            worst[name] = max(worst[name], value if math.isfinite(value)
                              else float("inf"))
        print(f"clip {k} (pool {order[k]}): {diffs}", file=sys.stderr)
    if len(sample) == 0:
        worst = {name: float("inf") for name in worst}
    checks = {name: harness.check(value, limits[name])
              for name, value in worst.items()}
    return checks, (bound if trace else None)

