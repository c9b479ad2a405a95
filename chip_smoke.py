"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tee_optical_flow_torch/csrc/, holds
each against its plain PyTorch version on the card at the main path's
shapes, drives the main path (a 33-frame 480x640 synthetic echo DICOM
through process_video(mode="otsu", OF_algo="TVL1", no_saliency=True) under
the production config) and the path of the second kernel (a 600x800
clip), and checks what comes out. Imports nothing of JAX. Exits non-zero,
with no result line, when there is no CUDA device or a phase fails.

Output: progress lines; then, before the last line, the card's name and
power limit (nvidia-smi) and one JSON line {"kernels": [...]} with each
kernel's launches on its path, error against its plain version, times and
bound; last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, at 700 W): HBM rate and
# float32 outside the tensor cores. bound_ms is the larger of the bytes a
# call must move over the first and the operations it does over the second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

CLIP_FRAMES, CLIP_H, CLIP_W = 33, 480, 640
K2_H, K2_W = 600, 800
FPS, SPACING_CM = 30, 0.05
# the clip's radial contraction c_k = A sin(2 pi k / period): a 16-frame
# cardiac cycle, up to ~2.2 px of wall motion per frame at 480x640
AMPLITUDE, PERIOD = 0.04, 16
# the main path's batch: 33 frames bucket to 40 (frame_bucket 8), 39 pairs
MAIN_PAIRS = 39

# operations per pixel, counted from the algorithm: a primal-dual step is
# 28 float ops in the primal and 28 in the dual (+5 for the epsilon
# error), a 5x5 median 9 + 66 compare-exchanges of 2 ops each per plane
OPS_STEP, OPS_ERR, OPS_MEDIAN_PLANE = 56, 5, 150
# bytes a step of csrc/tvl1.cu moves per pixel: the primal reads 11 planes
# and writes 2, the dual reads 6 and writes 4 (neighbours from cache)
STEP_BYTES = (11 + 2 + 6 + 4) * 4

# flow sanity on the wall: end-point error against the analytic motion.
# The port's CPU run of the same clip at the same settings measured a
# median of 0.013-0.033 px and a p95 of 0.065-0.078 px over three windows
# of pairs (motion 0.4-2.2 px); the bounds leave 3x of that
WALL_MEDIAN_EPE_PX, WALL_P95_EPE_PX = 0.1, 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def echo_clip(n: int, h: int, w: int, seed: int = 0):
    """(n, h, w) uint8 frames of the synthetic echo sector contracting by
    c_k about the ring centre, and the (n-1, h, w, 2) true flow of each
    consecutive pair in px (u = columns, v = rows)."""
    from tee_optical_flow_torch.synthetic import (
        bicubic_sample, echo_sector_masks, make_echo_pair,
    )

    img, _ = make_echo_pair(seed, h, w, contraction=0.0)
    sector = echo_sector_masks(h, w)["sector"]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = 0.55 * h, 0.5 * w
    cs = AMPLITUDE * np.sin(2 * np.pi * np.arange(n) / PERIOD)
    frames = np.empty((n, h, w), np.uint8)
    for k, c in enumerate(cs):
        f = bicubic_sample(img.astype(np.float64), xx + c * (xx - cx),
                           yy + c * (yy - cy))
        f[~sector] = 0.0
        frames[k] = np.round(np.clip(f, 0, 255))
    # frame k shows I(x_c + (1 + c_k)(x - x_c)): a point at x moves to
    # x_c + (1 + c_k)/(1 + c_{k+1}) (x - x_c) in frame k + 1
    s = (1 + cs[:-1]) / (1 + cs[1:]) - 1
    flow = np.stack([s[:, None, None] * (xx - cx)[None],
                     s[:, None, None] * (yy - cy)[None]], axis=-1)
    return frames, flow.astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls, timed with CUDA events after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def level_inputs(frames_u8, flow_px, device):
    """One warp's K1/K2 inputs at a finest pyramid level, as _tvl1_scale
    builds them: per-frame img2uint8 of the clip, the bicubic tiled warp
    (max_disp 17 at the finest level of max_disp 16) at the true flow."""
    import torch

    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.ops.warp import (
        centered_gradient, warp_many_shift_tiled2d,
    )

    images = img2uint8(gray_from_clip(
        torch.from_numpy(frames_u8).to(device)))
    i0, i1 = images[:-1].contiguous(), images[1:].contiguous()
    flow = torch.from_numpy(flow_px).to(device)
    u, v = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(i1)
    i1w, i1wx, i1wy = warp_many_shift_tiled2d(
        (i1, i1x, i1y), u, v, max_disp=17, local_r=8, kernel="bicubic")
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u - i1wy * v - i0
    zeros = torch.zeros_like(u)
    return [t.contiguous() for t in
            (rho_c, i1wx, i1wy, grad, u, v, zeros, zeros, zeros, zeros)]


def k1_active_work(args, *, outer_iters, inner_iters, epsilon, l_t, theta,
                   taut):
    """(pair-steps, pair-medians) that the epsilon stop lets run on these
    inputs: the plain version's loop (tvl1_outer_loop_plain), counting
    the active pairs at each median and each step."""
    import torch

    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops.warp import median_filter_5x5_plain

    rho_c, i1wx, i1wy, grad = args[:4]
    state = list(args[4:])
    b, h, w = state[0].shape
    thresh = float(torch.tensor(epsilon * epsilon * h * w,
                                dtype=torch.float32))
    th, inv_grad = tk.derived_constants(grad, l_t)
    err = torch.full((b,), float("inf"), device=grad.device)
    steps = medians = 0
    for _ in range(outer_iters):
        medians += int((err > thresh).sum())
        state[0] = median_filter_5x5_plain(state[0], err=err, thresh=thresh)
        state[1] = median_filter_5x5_plain(state[1], err=err, thresh=thresh)
        for _ in range(inner_iters):
            act = err > thresh
            steps += int(act.sum())
            new = tk._plain_step(rho_c, i1wx, i1wy, th, inv_grad, *state,
                                 l_t=l_t, theta=theta, taut=taut)
            derr = torch.sum((new[0] - state[0]) ** 2
                             + (new[1] - state[1]) ** 2, dim=(1, 2))
            err = torch.where(act, derr, err)
            state = [torch.where(act[:, None, None], a, c)
                     for a, c in zip(new, state)]
    return steps, medians


def phase_setup():
    import torch

    from tee_optical_flow_torch.ops import cuda_lib

    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.load_library()
    log(f"kernels built in {cuda_lib.build_info['seconds']:.1f} s: "
        f"{cuda_lib.build_info['path']}")
    for line in cuda_lib.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    log(f"h5py present: {has_h5py}")
    return card, has_h5py


def phase_kernels(clip, truth):
    """Each kernel's wrapper against its plain version on the same card
    tensors, at the shapes the main path gives it."""
    import torch

    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops import warp as tw

    dev = torch.device("cuda")
    lt, theta, taut = 0.15 * 0.3, 0.3, 0.25 / 0.3
    records = {}

    # the main path's finest level: all 39 pairs of the bucketed clip
    frames = np.concatenate([clip, np.repeat(clip[-1:], 7, axis=0)])
    flow = np.concatenate([truth, np.zeros_like(truth[:7])])
    args = level_inputs(frames, flow, dev)
    b, h, w = args[0].shape
    assert b == MAIN_PAIRS, b
    npx = b * h * w

    # the median alone: bit-equal
    u = args[4]
    got = tw.median_filter_5x5(u)
    ref = tw.median_filter_5x5_plain(u)
    err = float((got - ref).abs().max())
    log(f"median 5x5 ({b},{h},{w}): max|kernel - plain| = {err} "
        f"(tolerance 0: bit-equal)")
    assert torch.equal(got, ref), err
    ms = cuda_ms(lambda: tw.median_filter_5x5(u), 20)
    plain_ms = cuda_ms(lambda: tw.median_filter_5x5_plain(u), 5)
    bms, by = bound(2 * 4 * npx, OPS_MEDIAN_PLANE * npx)
    log(f"median: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
        f"{bms:.4f} ms ({by})")
    records["median_filter_5x5"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bms,
                                        bound_by=by)

    # K1 at the full 10 x 30 budget, epsilon 0 and the production 0.01
    kw = dict(outer_iters=10, inner_iters=30, use_median=True, l_t=lt,
              theta=theta, taut=taut)
    k1 = {}
    for eps, tol in ((0.0, 0.0), (0.01, 0.05)):
        got = tk.tvl1_outer_loop(*args, epsilon=eps, **kw)
        t0 = time.perf_counter()
        ref = tk.tvl1_outer_loop_plain(*args, epsilon=eps, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs(got, ref)
        log(f"K1 tvl1_outer_loop ({b},{h},{w}) eps={eps}: max|kernel - "
            f"plain| = {err} (tolerance {tol}"
            f"{': bit-equal' if tol == 0 else ': a pair may stop one step apart on an ulp of its error sum'})")
        assert err <= tol, (eps, err)
        ms = cuda_ms(lambda: tk.tvl1_outer_loop(*args, epsilon=eps, **kw), 3)
        if eps > 0:
            steps, medians = k1_active_work(args, epsilon=eps, **{
                k: kw[k] for k in ("outer_iters", "inner_iters", "l_t",
                                   "theta", "taut")})
            ops_px = (steps * (OPS_STEP + OPS_ERR)
                      + medians * 2 * OPS_MEDIAN_PLANE) * h * w
            log(f"K1 eps={eps}: {steps} of {b * 300} pair-steps and "
                f"{medians} of {b * 10} pair-medians ran")
        else:
            ops_px = b * (300 * OPS_STEP + 10 * 2 * OPS_MEDIAN_PLANE) * h * w
        bms, by = bound(16 * 4 * npx, ops_px)
        log(f"K1 eps={eps}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
            f"bound {bms:.4f} ms ({by})")
        if eps == 0.0:
            log(f"K1 eps=0: the kernels' own traffic ({STEP_BYTES} B per "
                f"pixel and step) streams at "
                f"{300 * STEP_BYTES * npx / ms / 1e9:.3f} TB/s")
        k1[eps] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by)
    records["tvl1_outer_loop"] = dict(k1[0.01], eps0=k1[0.0])

    # K2: one 30-iteration block at the K2 path's finest level (608x800,
    # the 2 pairs of its 3-frame clip)
    k2_clip, k2_truth = echo_clip(3, 608, 800, seed=1)
    args2 = level_inputs(k2_clip, k2_truth, dev)
    b2, h2, w2 = args2[0].shape
    kw2 = dict(n_iters=30, l_t=lt, theta=theta, taut=taut)
    got = tk.tvl1_inner_block(*args2, **kw2)
    ref = tk.tvl1_inner_block_plain(*args2, **kw2)
    err = max_abs(got, ref)
    log(f"K2 tvl1_inner_block ({b2},{h2},{w2}) 30 steps: max|kernel - "
        f"plain| = {err} (tolerance 0: bit-equal)")
    assert err == 0.0, err
    ms = cuda_ms(lambda: tk.tvl1_inner_block(*args2, **kw2), 10)
    plain_ms = cuda_ms(lambda: tk.tvl1_inner_block_plain(*args2, **kw2), 3)
    npx2 = b2 * h2 * w2
    bms, by = bound(16 * 4 * npx2, 30 * OPS_STEP * npx2)
    log(f"K2: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, bound "
        f"{bms:.4f} ms ({by}); own traffic at "
        f"{30 * STEP_BYTES * npx2 / ms / 1e9:.3f} TB/s")
    records["tvl1_inner_block"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bms,
                                       bound_by=by)
    return records


def reset_counts():
    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops import warp as tw

    tk.tvl1_outer_loop.launches = 0
    tk.tvl1_inner_block.launches = 0
    tw.median_filter_5x5.launches = 0


def read_counts():
    from tee_optical_flow_torch.ops import tvl1_kernels as tk
    from tee_optical_flow_torch.ops import warp as tw

    return {"tvl1_outer_loop": tk.tvl1_outer_loop.launches,
            "tvl1_inner_block": tk.tvl1_inner_block.launches,
            "median_filter_5x5": tw.median_filter_5x5.launches}


def check_outputs(saved, n, h, w, truth):
    """The HDF5 schema on what process_video wrote (or handed to its save
    function), and the flow against the analytic motion on the wall."""
    from tee_optical_flow_torch.synthetic import echo_sector_masks

    flow, echo, masks = saved["flow"], saved["echo"], saved["masks"]
    attrs = saved["attrs"]
    assert flow.shape == (n, h, w, 2) and flow.dtype == np.float16, \
        (flow.shape, flow.dtype)
    assert echo.shape == (n, h, w) and echo.dtype == np.float16
    assert list(masks) == ["otsu"], list(masks)
    assert masks["otsu"].shape == (n, h, w, 2) and masks["otsu"].dtype == bool
    assert masks["otsu"].any() and not masks["otsu"].all()
    np.testing.assert_array_equal(flow[-1], flow[-2])  # duplicated last
    assert np.isfinite(flow.astype(np.float32)).all()
    assert attrs["nframes"] == n and attrs["mode"] == "otsu"
    assert abs(attrs["frame_rate"] - FPS) < 1e-9
    assert abs(attrs["pixel_spacing"] - SPACING_CM) < 1e-12
    px = flow[:-1].astype(np.float32) / (SPACING_CM * FPS)
    wall = echo_sector_masks(h, w)["wall"].copy()
    wall[:8] = wall[-8:] = False
    wall[:, :8] = wall[:, -8:] = False
    epe = np.hypot(px[..., 0] - truth[..., 0], px[..., 1] - truth[..., 1])
    epe = epe[:, wall]
    med, p95 = float(np.median(epe)), float(np.percentile(epe, 95))
    motion = float(np.median(np.hypot(truth[..., 0], truth[..., 1])[:, wall]))
    log(f"flow vs analytic motion on the wall ({epe.size} px-pairs, median "
        f"true motion {motion:.3f} px): EPE median {med:.4f} px (bound "
        f"{WALL_MEDIAN_EPE_PX}), p95 {p95:.4f} px (bound {WALL_P95_EPE_PX})")
    assert med < WALL_MEDIAN_EPE_PX and p95 < WALL_P95_EPE_PX, (med, p95)


def profile_clip(run_clip):
    """One more clip under torch.profiler: the device's busy share of the
    clip's wall time (kernel time over wall, one stream) and the kernels
    that take it. The profiler's own cost inflates the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_clip()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    log(f"profiled clip: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), {len(kernels)} device events")
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"  {t:9.2f} ms {c:7d}x {name[:90]}")


def phase_slice(clip, truth, has_h5py, workdir):
    """The main path through its entry point, twice; counts from each."""
    import torch

    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow.pipeline import (
        compute_clip_flow, process_video,
    )
    from tee_optical_flow_torch.io.dicom import read_dicom_clip
    from tee_optical_flow_torch.io.dicom_write import write_dicom_clip
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8
    from tee_optical_flow_torch.utils import get_stage_report

    n, h, w = clip.shape
    dcm = os.path.join(workdir, "echo_synthetic.dcm")
    write_dicom_clip(dcm, np.repeat(clip[..., None], 3, axis=-1),
                     frame_rate=FPS, pixel_spacing=SPACING_CM)
    out = os.path.join(workdir, "echo_synthetic.hdf5")
    cfg = default_optical_flow_config()
    saved = {}

    def capture(save_path, flow_arr, echo_gray, mask_dict, metadata,
                waveforms, **kw):
        saved.update(flow=flow_arr, echo=echo_gray, masks=mask_dict,
                     attrs={"nframes": metadata["nframes"], "mode": kw["mode"],
                            "frame_rate": metadata["frame_rate"],
                            "pixel_spacing": metadata["pixel_spacing"]})

    kw = dict(verbose=False, mode="otsu", OF_algo="TVL1", no_saliency=True,
              config=cfg)
    if not has_h5py:
        kw["_save_fn"] = capture
        log("h5py is absent: the schema is checked on the arrays handed to "
            "process_video's save function")
    clip_s, counts = [], []
    for _ in range(2):
        get_stage_report(reset=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_video(dcm, out, None, **kw)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        counts.append(read_counts())
        log(f"process_video: {clip_s[-1]:.3f} s, launches {counts[-1]}")
        log("  stages (host clock, s): " + ", ".join(
            f"{k} {v['total_s']:.3f}" for k, v in get_stage_report().items()))
    for c in counts:
        # 5 levels x 5 warps, one batched K1 call each; no level of
        # 480x640 passes the K2 size bound; 10 x 2 medians per K1 call
        assert c["tvl1_outer_loop"] == 25, c
        assert c["tvl1_inner_block"] == 0, c
        assert c["median_filter_5x5"] == 500, c
    if has_h5py:
        import h5py

        with h5py.File(out, "r") as f:
            saved = dict(flow=f["flow"][()], echo=f["echo"][()],
                         masks={k: f[k][()] for k in f["flow"].attrs["labels"]},
                         attrs={k: f["flow"].attrs[k] for k in
                                ("nframes", "mode", "frame_rate",
                                 "pixel_spacing")})
            assert sorted(f.keys()) == ["RWaveTime", "echo", "flow", "otsu"]
    check_outputs(saved, n, h, w, truth)
    profile_clip(lambda: process_video(dcm, out, None, **kw))

    # the solver alone, on the same flow inputs, timed to completion
    _, arr = read_dicom_clip(dcm)
    frames = np.concatenate([arr, np.repeat(arr[-1:], 7, axis=0)])[..., 0]
    images = img2uint8(gray_from_clip(torch.from_numpy(
        np.ascontiguousarray(frames)).cuda()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_clip_flow(images, "TVL1", cfg)
    torch.cuda.synchronize()
    solver_s = time.perf_counter() - t0
    log(f"steady-state clip: {clip_s[1]:.3f} s (first run {clip_s[0]:.3f} s);"
        f" solver alone: {solver_s:.3f} s for {images.shape[0] - 1} pairs "
        f"at {h}x{w}")
    return counts[1], clip_s[1], solver_s


def phase_k2_path():
    """compute_clip_flow on a 600x800 clip (bucketed to 608x800): its
    finest level takes K2, the rest K1."""
    import torch

    from tee_optical_flow_torch.flow.pipeline import compute_clip_flow
    from tee_optical_flow_torch.ops.imaging import gray_from_clip, img2uint8

    clip, truth = echo_clip(3, K2_H, K2_W, seed=2)
    images = img2uint8(gray_from_clip(torch.from_numpy(clip).cuda()))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow = compute_clip_flow(images, "TVL1")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    log(f"K2 path, compute_clip_flow (3, {K2_H}, {K2_W}): {seconds:.3f} s "
        f"(first call), launches {counts}")
    assert flow.shape == (2, K2_H, K2_W, 2), tuple(flow.shape)
    assert bool(torch.isfinite(flow).all())
    # the finest level: 5 warps x 10 blocks; 4 coarser levels: 5 warps
    assert counts["tvl1_inner_block"] == 50, counts
    assert counts["tvl1_outer_loop"] == 20, counts
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card, has_h5py = phase_setup()
    clip, truth = echo_clip(CLIP_FRAMES, CLIP_H, CLIP_W)
    records = phase_kernels(clip, truth)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as workdir:
        main_counts, clip_s, solver_s = phase_slice(clip, truth, has_h5py,
                                                    workdir)
    k2_counts = phase_k2_path()
    kernels = []
    for name, route_src, replaces, counts, path in (
            ("tvl1_outer_loop", "cuda",
             "tee_optical_flow_tpu/ops/tvl1_pallas.py:198",
             main_counts, "main: otsu+TVL1 33x480x640"),
            ("median_filter_5x5", "cuda",
             "tee_optical_flow_tpu/ops/tvl1_pallas.py:248",
             main_counts, "main: otsu+TVL1 33x480x640"),
            ("tvl1_inner_block", "cuda",
             "tee_optical_flow_tpu/ops/tvl1_pallas.py:141",
             k2_counts, "K2: compute_clip_flow 3x600x800")):
        rec = records[name]
        kernels.append({
            "name": name, "route": route_src,
            "source": "tee_optical_flow_torch/csrc/tvl1.cu",
            "replaces": replaces, "launches": counts[name], "path": path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            **({"eps0": rec["eps0"]} if "eps0" in rec else {}),
        })
    log(f"clip_s {clip_s:.3f} solver_s {solver_s:.3f} total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
