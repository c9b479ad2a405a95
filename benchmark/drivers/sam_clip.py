"""SAM clip cells: a cohort of synthetic echo DICOMs through the program's
``flow.pipeline.process_video`` in a segmentor mode, one after another, as
``process_folder``'s loop calls it, with the SAM segmentor built as
``cli.process.load_segmentor`` builds it from a checkpoint: the
registry's architecture with the configuration's classes and compute
type, a whole state dict loaded into it (``load_state_dict``, strict),
served by ``make_clip_segmentor`` in micro-batches. The state dict stands
in for the checkpoint: every tensor is drawn from the run's seed on the
card (``draw_state``), the relative-position tables, the position
embedding, the biases and the norms' affines nonzero, and the same tensors
are what the reference computes with.

Set-up: the kernel and DICOM libraries, the pool of clips (the clip
driver's, written as uncompressed DICOMs into TMPDIR), the segmentor, and
one warm-up clip, which has every shape the window uses. Window: clips
taken in turn from the pool until ``seconds`` have passed; ``clip_s`` is
the time from the window's start to the end of its last clip over the
clips completed.

After the window, a sample of the completed clips drawn from the seed is
held to the plain references (``benchmark/reference``), computed on the
card from the benchmark's own frames:

  * ``decode_diff`` and ``flow_gap_px``: the luma and the plain TV-L1 flow,
    as in the clip cells;
  * ``mask_diff``: the program's cleaned masks against
    ``reference/masks.py``'s pieces, composed as the program's
    ``clean_mask_device`` composes them for the mode (per label the moving
    average, the fill and the size filter, labelled to convergence; then
    ``bkgd`` as NOT their union), applied to the labels the timed path
    produced. A pass-through wrapper of the segmentor's ``labels_device``
    keeps them: no copy and no wait in the window;
  * ``label_gap_ratio``: from ``reference/sam.py``'s float32 logits of the
    clip's frames, the mean gap between its best class and the class the
    program served (both at the clip's size through the program's NEAREST
    resize), over the same gap for the class that reference run in
    bfloat16 (autocast) picks. Logits, not labels alone: random weights
    make argmax flips on rounding.

A reading that is not a finite number counts as infinite. The control
``int8-weights`` serves the same model with int8 weights
(``make_clip_segmentor(weights_int8=True)``), a lower precision than the
configuration's.

With a trace, the window's first clips run under the profiler, and the
program's spans (the stage report: seconds and calls per clip), the mean
time of the window's clips run outside the profiler (``clip_s`` counts
the seconds the profiler takes to read its trace) and the cell's counts
(``benchmark/counts_sam.py``) go into the record.
"""

from __future__ import annotations

import math
import sys
import time
import traceback
from typing import Optional

from .. import counts_sam, harness, inputs
from ..reference import masks as ref_masks
from ..reference import sam as ref_sam
from ..reference import tvl1 as ref_tvl1
from ..trace import Spans, profile
from .clip import compare, dicom_pool, tf32

# label values per mode (a frozen copy of the program's
# flow/segment.LABEL_MAPS, after the reference system's
# calculate_optical_flow.py:132-152)
LABEL_MAPS = {"RVIO_2class": {"rv": 1, "av": 2}}
CONTROLS = ("int8-weights",)


def build_model(model_cfg: dict, device):
    """The registry's ``arch`` with ``num_classes`` classes, computing in
    the configuration's type, as ``load_segmentor`` builds it."""
    import torch

    from tee_optical_flow_torch.models.registry import sam_model_registry

    return sam_model_registry[model_cfg["arch"]](
        num_classes=model_cfg["num_classes"],
        image_size=model_cfg["image_size"],
        dtype=getattr(torch, model_cfg["dtype"]), device=device)


# the spread of the drawn biases, norm affines (about 1 and 0) and
# position embedding; a relative-position table's spread is
# REL_POS_SPREAD / sqrt(head width), so that each axis's bias q . r has a
# spread of REL_POS_SPREAD at any head width, as the scaled scores have 1
BIAS_SPREAD = 0.1
POS_EMBED_SPREAD = 0.5
REL_POS_SPREAD = 2.0


def draw_state(model, seed: int, device) -> dict:
    """A whole state dict for ``model``, drawn from ``seed`` on
    ``device`` in the order of ``model.named_modules()``: dense and conv
    weights normal with variance 1/fan-in, every bias and the norms'
    shifts normal with spread ``BIAS_SPREAD``, the norms' scales 1 plus
    the same, the relative-position tables and the position embedding
    normal (see the spreads above), embeddings and the prompt encoder's
    Gaussian matrix standard normal. A tensor of another kind raises."""
    import math

    import torch
    import torch.nn as nn

    from tee_optical_flow_torch.models.common import LayerNorm2d

    gen = inputs.torch_generator(seed, "weights", device)

    def normal(t, std, mean=0.0):
        return torch.randn(t.shape, generator=gen, device=device,
                           dtype=torch.float32) * std + mean

    state = {}
    for prefix, m in model.named_modules():
        own = dict(m.named_parameters(recurse=False))
        own.update(m.named_buffers(recurse=False))
        for name, t in own.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) \
                    and name == "weight":
                fan_in = (t.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else t.shape[1]) * t[0, 0].numel()
                state[key] = normal(t, 1.0 / math.sqrt(fan_in))
            elif name == "bias":
                state[key] = normal(t, BIAS_SPREAD)
            elif isinstance(m, (nn.LayerNorm, LayerNorm2d)) \
                    and name == "weight":
                state[key] = normal(t, BIAS_SPREAD, 1.0)
            elif name in ("rel_pos_h", "rel_pos_w"):
                state[key] = normal(t, REL_POS_SPREAD
                                    / math.sqrt(t.shape[1]))
            elif name == "pos_embed":
                state[key] = normal(t, POS_EMBED_SPREAD)
            elif isinstance(m, nn.Embedding) \
                    or name == "positional_encoding_gaussian_matrix":
                state[key] = normal(t, 1.0)
            else:
                raise ValueError(f"draw_state: no rule for {key} "
                                 f"({type(m).__name__})")
    return state


def build_segmentor(model_cfg: dict, seed: int, device,
                    weights_int8: bool = False):
    """(the drawn state dict, the clip segmentor): ``build_model``'s
    model with ``draw_state``'s tensors loaded as a checkpoint's are,
    served in micro-batches."""
    from tee_optical_flow_torch.models.sam import make_clip_segmentor

    model = build_model(model_cfg, device)
    state = draw_state(model, seed, device)
    model.load_state_dict(state, strict=True)
    return state, make_clip_segmentor(model,
                                      micro_batch=model_cfg["micro_batch"],
                                      weights_int8=weights_int8)


def flow_reference(frames, cfg: dict, traffic: dict) -> dict:
    """The luma and the plain TV-L1 flow of (N, H, W) uint8 frames, in the
    units ``process_video`` hands its save function (float16; the flow
    scaled by the clip's pixel spacing x frame rate, its last pair
    repeated), every product float32 with TF32 off."""
    import torch

    flow_cfg = cfg["flow"]
    if cfg["of_algo"].lower() != "tvl1" or flow_cfg["tvl1_gamma"] != 0 \
            or not cfg["no_saliency"] or cfg["bkgd_comp"] != "none":
        raise NotImplementedError("the reference solves TV-L1 without the "
                                  "illumination term on normalised frames, "
                                  "with no background compensation")
    gray = frames.to(torch.float32) / 255.0
    with tf32(False):
        flow = ref_tvl1.clip_flow(ref_tvl1.img2uint8(gray), flow_cfg,
                                  dtype=torch.float32)
    cf = torch.tensor(traffic["pixel_spacing_cm"] * traffic["frame_rate"],
                      dtype=torch.float32, device=flow.device)
    flow = (flow * cf).to(torch.float16)
    return {"echo": gray.to(torch.float16),
            "flow": torch.cat([flow, flow[-1:]])}


def mask_reference(labels, mode: str, flow_cfg: dict) -> dict:
    """The cleaned masks of an (N, H, W) label movie, composed as the
    program composes them: per label the moving average, the fill and the
    size filter (labelled to convergence), then ``bkgd`` as NOT their
    union."""
    masks = {}
    for name, value in LABEL_MAPS[mode].items():
        avg = ref_masks.moving_average(labels == value,
                                       flow_cfg["moving_avg_window"],
                                       flow_cfg["moving_avg_threshold"])
        masks[name] = ref_masks.clean(avg, flow_cfg["min_mask_size"])
    union = None
    for m in masks.values():
        union = m if union is None else union | m
    masks["bkgd"] = ~union
    return masks


def reference_logits(model_cfg: dict, state: dict, frames,
                     bf16: bool = False):
    """reference/sam.py's (N, K, S/4, S/4) logits of (N, H, W) uint8
    frames, a micro-batch at a time, in float32 (or under bfloat16
    autocast)."""
    import contextlib

    import torch

    mb = model_cfg["micro_batch"]
    out = []
    for s in range(0, frames.shape[0], mb):
        x = ref_sam.preprocess(frames[s:s + mb], model_cfg["image_size"])
        with (torch.autocast(x.device.type, dtype=torch.bfloat16) if bf16
              else contextlib.nullcontext()):
            out.append(ref_sam.sam_logits(
                state, x, num_heads=model_cfg["num_heads"],
                global_attn_indexes=model_cfg["global_attn_indexes"],
                window_size=model_cfg["window_size"]).to(torch.float32))
    return torch.cat(out)


def label_gap_ratio(model_cfg: dict, state: dict, frames, served) -> float:
    """The served (N, H, W) labels' mean gap below the float32 reference's
    best logit, over the gap of the reference's own bfloat16 argmax."""
    import torch

    with torch.no_grad():
        ref = reference_logits(model_cfg, state, frames)
        ref_bf16 = reference_logits(model_cfg, state, frames, bf16=True)
    h, w = served.shape[1:]
    yi = ref_sam.nearest_index(ref.shape[2], h, ref.device)
    xi = ref_sam.nearest_index(ref.shape[3], w, ref.device)

    def at_clip_size(t):
        return t.index_select(-2, yi).index_select(-1, xi)

    ref_full = at_clip_size(ref)
    gap = ref_sam.label_gap(ref_full, served.to(ref.device))
    own = ref_sam.label_gap(ref_full, at_clip_size(ref_bf16.argmax(1)))
    if own == 0:
        return 0.0 if gap == 0 else float("inf")
    return gap / own


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: Optional[str] = None) -> dict:
    """One run of a SAM clip cell (see the module docstring). ``control``
    ``"int8-weights"`` serves the model with int8 weights."""
    import torch

    from tee_optical_flow_torch.config import OpticalFlowCalculationConfig
    from tee_optical_flow_torch.flow import pipeline
    from tee_optical_flow_torch.utils import get_stage_report

    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r} (known: {CONTROLS})")
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    model_cfg = cfg["model"]
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
    state, segmentor = build_segmentor(model_cfg, seed, device,
                                       weights_int8=control == "int8-weights")
    # the labels of the timed path, by clip: handed on untouched
    served, current = {}, [None]
    labels_device = segmentor.labels_device

    def capturing(clip_dev, clip_hw):
        labels = labels_device(clip_dev, clip_hw)
        if current[0] is not None:
            served[current[0]] = labels
        return labels

    segmentor.labels_device = capturing
    kwargs = dict(mode=cfg["mode"], OF_algo=cfg["of_algo"],
                  no_saliency=cfg["no_saliency"], bkgd_comp=cfg["bkgd_comp"],
                  device=device,
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
    # seconds of each clip of the window run outside the profiler (whose
    # trace takes tens of seconds to read after a SAM clip)
    timed = []
    attempted = failed = 0
    traced = None
    with dicom_pool(clips, traffic) as paths:
        def one(k, save):
            current[0] = None if save is discard else k
            with spans.span("clip"):
                pipeline.process_video(paths[k % len(paths)],
                                       f"clip{k}.hdf5", segmentor,
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
                count = traffic["profiled_clips"] if trace and not first \
                    else 1
                ks = range(first, first + count)
                attempted += count
                order.extend(k % len(paths) for k in ks)

                def step(ks=ks):
                    for k in ks:
                        one(k, keeper(k))
                t_step = time.perf_counter()
                try:
                    if trace and not first:
                        traced = profile(step, spans)
                    else:
                        step()
                        timed.append(time.perf_counter() - t_step)
                except Exception:  # a clip that fails counts; the run goes on
                    failed += count
                    traceback.print_exc(file=sys.stderr)
                t_end = time.perf_counter()
                if t_end - t0 >= seconds:
                    break
        finally:
            pipeline.trace_stage = stage
            segmentor.labels_device = labels_device
    clip_s = (t_end - t0) / attempted
    report = get_stage_report(reset=True)
    stages = {name: v["total_s"] / attempted for name, v in report.items()}
    calls = {name: v["calls"] / attempted for name, v in report.items()}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card
                   else "cpu", "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                   if on_card else 0}
    if on_card:
        torch.cuda.empty_cache()

    run = {"driver": "sam_clip", "attempted": attempted, "failed": failed,
           "device": device_info,
           "end_to_end": {"clip_s": (clip_s, "s"), "setup_s": (setup_s, "s")},
           "clip_s": clip_s, "stages": stages, "stage_calls": calls,
           "trace": traced,
           "profiled_clip_s": None if traced is None
           else traced["window_s"] / traffic["profiled_clips"],
           "timed_clip_s": sum(timed) / len(timed) if timed else None,
           "real_frames": traffic["frames"],
           "flop_per_frame": counts_sam.flop_per_frame(model_cfg),
           "global_attn_least_s": calls.get("global_attn", 0.0)
           * counts_sam.global_attn_least_s(model_cfg)}
    run["checks"] = check_clips(cell, clips, kept, served, order, seed,
                                state)
    return run


def check_clips(cell, clips, kept, served, order, seed, state) -> dict:
    """The sampled clips against the references; returns the checks."""
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    limits = cell["limits"]
    done = sorted(k for k in kept if k in served)
    rng = inputs.seed_rng(seed, "sample")
    sample, seen = [], set()
    for k in rng.permutation(done):
        if order[k] not in seen and len(sample) < traffic["checked_clips"]:
            sample.append(int(k))
            seen.add(order[k])
    worst = {"decode_diff": 0, "mask_diff": 0, "flow_gap_px": 0.0,
             "label_gap_ratio": 0.0}
    for k in sorted(sample):
        frames = clips[order[k]]
        n = frames.shape[0]
        ref = flow_reference(frames, cfg, traffic)
        ref["masks"] = {name: m[:n] for name, m in mask_reference(
            served[k], cfg["mode"], cfg["flow"]).items()}
        diffs = compare(kept[k], ref, 1.0 / (traffic["pixel_spacing_cm"]
                                             * traffic["frame_rate"]))
        diffs["label_gap_ratio"] = label_gap_ratio(cfg["model"], state,
                                                   frames, served[k][:n])
        for name, value in diffs.items():
            worst[name] = max(worst[name], value if math.isfinite(value)
                              else float("inf"))
        print(f"clip {k} (pool {order[k]}): {diffs}", file=sys.stderr)
    if len(sample) == 0:
        worst = {name: float("inf") for name in worst}
    return {name: harness.check(value, limits[name])
            for name, value in worst.items()}
