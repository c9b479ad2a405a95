"""The PyTorch port's DeepFlow path against the JAX package's, on the CPU:
the gather warp, the patch-ZNCC matcher, K3's plain version (the psi x
red-black SOR solve) against the XLA solve and the Pallas kernel in
interpret mode, K3's tiled and resident decompositions emulated on the
CPU, the fine-grained saliency map, a whole solve, ``process_video`` with
DeepFlow on the normalised and the saliency input, and the float64 Brox
oracle.

The whole solve and the two pipeline runs use one reduced configuration
on (2, 64, 64) pairs, so that the JAX package compiles ``deepflow_pairs``
once for all of them. Each test states its tolerance.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch.config import (
    OpticalFlowCalculationConfig as TorchConfig,
)
from tee_optical_flow_torch.flow import pipeline as t_pipe
from tee_optical_flow_torch.ops import deepflow as td
from tee_optical_flow_torch.ops import deepflow_kernels as tk
from tee_optical_flow_torch.ops import saliency as ts
from tee_optical_flow_torch.ops import warp as tw
from tee_optical_flow_torch.utils.tracing import get_counters
from tee_optical_flow_tpu.config import (
    OpticalFlowCalculationConfig as JaxConfig,
)
from tee_optical_flow_tpu.flow import pipeline as j_pipe
from tee_optical_flow_tpu.io.dicom_write import write_dicom_clip
from tee_optical_flow_tpu.ops import deepflow as jd
from tee_optical_flow_tpu.ops import saliency as js
from tee_optical_flow_tpu.ops import warp as jw
from tee_optical_flow_tpu.ops.deepflow_oracle import deepflow_flow_oracle, epe
from tee_optical_flow_tpu.ops.deepflow_pallas import sor_sweeps_pallas
from test_torch_pipeline import _synthetic_clip

torch.set_num_threads(1)

# the reduced DeepFlow configuration of the whole-solve and pipeline
# tests: the production statics (bicubic, matching at the two coarsest
# levels, omega 1.6) at fewer levels and sweeps; max_disp 4 keeps every
# level on the one-pass shift warp (the tiled warp is held against JAX in
# test_torch_ops) and the JAX compile near 10 s
REDUCED = dict(min_mask_size=50, deepflow_nscales=3,
               deepflow_sor_iterations=4, deepflow_psi_iterations=2,
               deepflow_fp_iterations=2, deepflow_max_displacement=4,
               frame_bucket=1)
SOLVE = dict(alpha=8.0, delta=0.5, gamma=5.0, omega=1.6)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _texture(rng, h=64, w=64, smooth=3.0):
    img = ndimage.gaussian_filter(rng.uniform(size=(h, w)), smooth)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255.0).astype(np.float32)


def test_bilinear_warp_matches_jax(rng):
    """Random flow of up to ~15 px on a 24x30 image: most samples land
    inside, many past the border clamps. Within 1e-5 of the JAX warp."""
    img = (rng.uniform(size=(2, 24, 30)) * 255).astype(np.float32)
    u = (rng.normal(size=img.shape) * 6.0).astype(np.float32)
    v = (rng.normal(size=img.shape) * 6.0).astype(np.float32)
    xs = np.arange(30)[None, None, :] + u
    assert (xs < 0).any() and (xs > 29).any()  # the clamps are reached
    ref = np.asarray(jw.bilinear_warp(img, u, v))
    got = tw.bilinear_warp(_t(img), _t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_coarse_match_matches_jax(rng):
    """Textured content moved by (-2.4, 1.3) px plus noise. The matcher's
    integer argmax may flip on a near-tie where the two sides round a
    ZNCC score an ulp apart, nothing else: um, vm and conf agree on at
    least 99.5% of the pixels (measured: all 3840 agree, over three
    seeds)."""
    i0 = np.stack([_texture(rng, 40, 48, smooth=1.0) for _ in range(2)])
    i1 = np.stack([ndimage.shift(f, (1.3, -2.4), order=3, mode="nearest")
                   for f in i0])
    i1 = (i1 + rng.normal(size=i1.shape) * 2.0).astype(np.float32)
    ref = [np.asarray(a) for a in jd.coarse_match(i0, i1, radius=4)]
    got = [a.numpy() for a in td.coarse_match(_t(i0), _t(i1), radius=4)]
    differ = np.zeros(i0.shape, bool)
    for a, c in zip(ref, got):
        differ |= a != c
    n = int(differ.sum())
    assert n <= 0.005 * differ.size, f"{n} of {differ.size} pixels differ"
    assert ref[2].mean() > 0.2  # the matcher is confident somewhere


def test_coarse_match_zero_motion_and_shift(rng):
    """The port alone, as tests/test_deepflow_trainloop.py holds the JAX
    matcher: identical images match exactly zero where confident; an
    integer shift is recovered exactly in the interior."""
    img = _texture(rng, 48, 48, smooth=1.0)
    um, vm, conf = (a.numpy() for a in
                    td.coarse_match(_t(img[None]), _t(img[None]), radius=4))
    sel = conf > 0
    assert sel.mean() > 0.3
    assert np.abs(um[sel]).max() == 0.0
    assert np.abs(vm[sel]).max() == 0.0

    shifted = np.roll(img, 3, axis=1)
    um, vm, conf = (a.numpy() for a in
                    td.coarse_match(_t(img[None]), _t(shifted[None]),
                                    radius=4))
    sel = conf > 0
    sel[:, :, :8] = False  # roll wraps content at both edges
    sel[:, :, -8:] = False
    assert sel.mean() > 0.2
    np.testing.assert_array_equal(um[sel], 3.0)
    np.testing.assert_array_equal(vm[sel], 0.0)


def _sor_inputs(rng, b=2, h=21, w=37):
    """The JAX package's own parity inputs (test_deepflow_trainloop.py):
    random planes at the scales of a real level, and a matching triple."""
    def f(scale):
        return (rng.normal(size=(b, h, w)) * scale).astype(np.float32)

    i0, i1w = f(40.0) + 100.0, f(40.0) + 100.0
    i1wx, i1wy = f(8.0), f(8.0)
    i1wxx, i1wxy, i1wyy = f(2.0), f(2.0), f(2.0)
    u0, v0 = f(0.8), f(0.8)
    um, vm = f(1.0), f(1.0)
    conf = np.abs(f(1.0))
    return i0, i1w, (i1wx, i1wy, i1wxx, i1wxy, i1wyy), (u0, v0), \
        (um, vm, conf)


def _kernel_args(i0, i1w, derivs, flow):
    """K3's ten planes as _sor_sweeps builds them, as float32 tensors."""
    it = _t(i1w - i0)
    i0x, i0y = tw.centered_gradient(_t(i0))
    itx = _t(derivs[0]) - i0x
    ity = _t(derivs[1]) - i0y
    return [_t(a) for a in derivs] + [it, itx, ity] + [_t(a) for a in flow]


@pytest.mark.parametrize("with_match", [False, True])
def test_sor_sweeps_plain_matches_jax(rng, with_match):
    """K3's plain version (through the wrapper, on CPU tensors) against
    the XLA ``_sor_sweeps`` and against the Pallas kernel in interpret
    mode, psi 2 x SOR 5 on 2x21x37. 1e-5 is not reached: on increments
    up to 4.5 px the two sides' float32 roundings (the JAX CPU backend
    fuses and rounds a few operations differently) grow over the ten
    over-relaxed sweeps to 1.26e-5 (measured over four seeds), so the
    bound is 3x that, 4e-5 (the JAX package's own interpret-parity bound
    is 1e-4)."""
    i0, i1w, derivs, flow, match = _sor_inputs(rng)
    match = match if with_match else None
    kw = dict(psi_iters=2, sor_iters=5, beta=0.3, **SOLVE)
    before = get_counters().get("launches.sor_sweeps", 0)
    got = td._sor_sweeps(*[_t(a) for a in (i0, i1w, *derivs, *flow)],
                         match=None if match is None else
                         tuple(_t(a) for a in match), **kw)
    # CPU tensors: no launch
    assert get_counters().get("launches.sor_sweeps", 0) == before
    xla = jd._sor_sweeps(i0, i1w, *derivs, *flow, match=match, **kw)
    args = [a.numpy() for a in _kernel_args(i0, i1w, derivs, flow)]
    pallas = sor_sweeps_pallas(*args, match, interpret=True, **kw)
    for tag, ref in (("xla", xla), ("pallas", pallas)):
        for name, a, c in zip(("du", "dv"), ref, got):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=0,
                                       atol=4e-5, err_msg=f"{tag} {name}")
    assert float(got[0].abs().max()) > 0.1  # the solve moved


# csrc/deepflow.cu's tiled route, scaled down: a 16x12 extended tile and
# S = 2 SOR iterations per sweep launch (halo 4) give 8x4 tiles, several
# per image, with a ragged last tile and halos across both image edges
EMU_EW, EMU_EH, EMU_S = 16, 12, 2


def _robust_emu(x2):
    return 1.0 / (2.0 * torch.sqrt(x2 + 1e-6))


def _nbrs(f, gy, gx, h, w):
    """(N, S, W, E) neighbours of every position of a (B, EH, EW) region
    whose rows and columns lie at image coordinates gy, gx: the next
    position in the region, or the pixel itself at the image edge (the
    region's own rim reads itself; the kernels never update it)."""
    eh, ew = f.shape[1:]
    ly = torch.arange(eh)
    lx = torch.arange(ew)
    gy, gx = gy.view(eh, 1), gx.view(1, ew)
    n = torch.where(gy > 0, f[:, torch.clamp_min(ly - 1, 0)], f)
    s = torch.where(gy < h - 1, f[:, torch.clamp_max(ly + 1, eh - 1)], f)
    w_ = torch.where(gx > 0, f[:, :, torch.clamp_min(lx - 1, 0)], f)
    e = torch.where(gx < w - 1, f[:, :, torch.clamp_max(lx + 1, ew - 1)], f)
    return n, s, w_, e


def _emu_coefs(i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0, match,
               du, dv, *, alpha, delta, gamma, beta):
    """The fused weights + coefficients pass (coefs_kernel, and the first
    two phases of resident_kernel's psi round) -> (w, rhs1c, rhs2c, p11,
    p22, a12, inv_denom), every expression in the kernels' order."""
    h, w = u0.shape[1:]
    gy, gx = torch.arange(h), torch.arange(w)
    un, us, uw, ue = _nbrs(u0 + du, gy, gx, h, w)
    vn, vs, vw, ve = _nbrs(v0 + dv, gy, gx, h, w)
    ux, uy = 0.5 * (ue - uw), 0.5 * (us - un)
    vx, vy = 0.5 * (ve - vw), 0.5 * (vs - vn)
    wgt = _robust_emu(ux * ux + uy * uy + vx * vx + vy * vy) * alpha
    r_int = it + i1wx * du + i1wy * dv
    r_gx = itx + i1wxx * du + i1wxy * dv
    r_gy = ity + i1wxy * du + i1wyy * dv
    psi_d = _robust_emu(r_int * r_int) * delta
    psi_g = _robust_emu(r_gx * r_gx + r_gy * r_gy) * gamma
    a11 = psi_d * i1wx * i1wx + psi_g * (i1wxx * i1wxx + i1wxy * i1wxy)
    a12 = psi_d * i1wx * i1wy + psi_g * (i1wxx * i1wxy + i1wxy * i1wyy)
    a22 = psi_d * i1wy * i1wy + psi_g * (i1wxy * i1wxy + i1wyy * i1wyy)
    b1 = -(psi_d * i1wx * it + psi_g * (i1wxx * itx + i1wxy * ity))
    b2 = -(psi_d * i1wy * it + psi_g * (i1wxy * itx + i1wyy * ity))
    if match is not None:
        um, vm, conf = match
        ru = u0 + du - um
        rv = v0 + dv - vm
        a_m = beta * conf * _robust_emu(ru * ru + rv * rv)
        a11 = a11 + a_m
        a22 = a22 + a_m
        b1 = b1 + a_m * (um - u0)
        b2 = b2 + a_m * (vm - v0)
    wn, ws, ww, we = (0.5 * (wgt + x) for x in _nbrs(wgt, gy, gx, h, w))
    wsum = wn + ws + ww + we
    un, us, uw, ue = _nbrs(u0, gy, gx, h, w)
    vn, vs, vw, ve = _nbrs(v0, gy, gx, h, w)
    su0 = wn * un + ws * us + ww * uw + we * ue - wsum * u0
    sv0 = wn * vn + ws * vs + ww * vw + we * ve - wsum * v0
    p11 = a11 + wsum
    p22 = a22 + wsum
    denom = p11 * p22 - a12 * a12
    inv_denom = 1.0 / torch.where(denom.abs() > 1e-6, denom, 1e-6)
    return wgt, b1 + su0, b2 + sv0, p11, p22, a12, inv_denom


def _emu_half_sweeps(du, dv, coefs, gy, gx, h, w, n_half, omega):
    """n_half red-black half sweeps (red first), in place, on a region at
    image rows gy and columns gx (sor_px): half sweep j updates the pixels
    of its colour inside the image and at least j inside the region's rim
    (none of the rim when the region is the whole image)."""
    wgt, rhs1c, rhs2c, p11, p22, a12, inv_denom = coefs
    eh, ew = du.shape[1:]
    ly = torch.arange(eh).view(eh, 1)
    lx = torch.arange(ew).view(1, ew)
    gyv, gxv = gy.view(eh, 1), gx.view(1, ew)
    inside = (gyv >= 0) & (gyv < h) & (gxv >= 0) & (gxv < w)
    colour = (gyv + gxv) % 2
    whole = eh == h and ew == w
    wn, ws, ww, we = (0.5 * (wgt + x) for x in _nbrs(wgt, gy, gx, h, w))
    for j in range(1, n_half + 1):
        sel = inside & (colour == (j - 1) % 2)
        if not whole:
            sel = sel & (ly >= j) & (ly < eh - j) & (lx >= j) & (lx < ew - j)
        dn, ds_, dw, de = _nbrs(du, gy, gx, h, w)
        dun = wn * dn + ws * ds_ + ww * dw + we * de
        dn, ds_, dw, de = _nbrs(dv, gy, gx, h, w)
        dvn = wn * dn + ws * ds_ + ww * dw + we * de
        rhs1 = rhs1c + dun
        rhs2 = rhs2c + dvn
        du_star = (p22 * rhs1 - a12 * rhs2) * inv_denom
        dv_star = (p11 * rhs2 - a12 * rhs1) * inv_denom
        du = torch.where(sel, (1.0 - omega) * du + omega * du_star, du)
        dv = torch.where(sel, (1.0 - omega) * dv + omega * dv_star, dv)
    return du, dv


def _emu_sweep_launch(src, dst, coefs, n_half, omega):
    """One sweep_kernel launch: every extended tile loads du/dv from src
    and the coefficients, runs n_half half sweeps on its own copy and
    writes its tile into dst. With src is dst (no ping-pong) a tile's halo
    holds the tiles written before it."""
    _, h, w = src[0].shape
    r = 2 * EMU_S
    tw, th = EMU_EW - 2 * r, EMU_EH - 2 * r
    for ty in range(-(-h // th)):
        for tx in range(-(-w // tw)):
            gy = torch.arange(EMU_EH) + ty * th - r
            gx = torch.arange(EMU_EW) + tx * tw - r
            cy, cx = gy.clamp(0, h - 1), gx.clamp(0, w - 1)

            def load(f):
                return f[:, cy][:, :, cx]

            du, dv = _emu_half_sweeps(load(src[0]), load(src[1]),
                                      [load(c) for c in coefs], gy, gx, h,
                                      w, n_half, omega)
            ys = slice(r, r + min(th, h - ty * th))
            xs = slice(r, r + min(tw, w - tx * tw))
            oy, ox = ty * th, tx * tw
            dst[0][:, oy:oy + th, ox:ox + tw] = du[:, ys, xs]
            dst[1][:, oy:oy + th, ox:ox + tw] = dv[:, ys, xs]


def _emulate_k3(i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0,
                match, *, route, psi_iters, sor_iters, omega, alpha, delta,
                gamma, beta):
    """csrc/deepflow.cu's decomposition on the CPU. ``route`` "resident":
    resident_kernel, per psi round the coefficients of the whole pair,
    then 2 x sor_iters half sweeps in place on it. "tiled": per psi round
    the coefficients pass, then sweep launches of EMU_S SOR iterations
    (the last runs the remainder) on extended tiles, du/dv ping-ponging
    between two buffers. "no_pingpong": the tiled route writing its tiles
    into the buffer it reads."""
    planes = (i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0)
    kw = dict(alpha=alpha, delta=delta, gamma=gamma, beta=beta)
    b, h, w = u0.shape
    zeros = (torch.zeros_like(u0), torch.zeros_like(v0))
    if route == "resident":
        du, dv = zeros
        gy, gx = torch.arange(h), torch.arange(w)
        for _ in range(psi_iters):
            coefs = _emu_coefs(*planes, match, du, dv, **kw)
            du, dv = _emu_half_sweeps(du, dv, coefs, gy, gx, h, w,
                                      2 * sor_iters, omega)
        return du, dv
    launches = psi_iters * -(-sor_iters // EMU_S)
    bufs = [(torch.empty_like(u0), torch.empty_like(v0)),
            (torch.empty_like(u0), torch.empty_like(v0))]
    cur = launches % 2 if route == "tiled" else 0
    src = zeros  # the first psi round reads no du/dv
    if route == "no_pingpong":
        bufs[0] = (zeros[0].clone(), zeros[1].clone())
        src = bufs[0]
    for _ in range(psi_iters):
        coefs = _emu_coefs(*planes, match, *src, **kw)
        for done in range(0, sor_iters, EMU_S):
            dst = bufs[cur ^ 1] if route == "tiled" else bufs[0]
            _emu_sweep_launch(src, dst, coefs,
                              2 * min(EMU_S, sor_iters - done), omega)
            src = dst
            cur ^= 1
    assert route != "tiled" or src is bufs[0]  # the last launch wrote du/dv
    return src


@pytest.mark.parametrize("with_match,shape,routes", [
    pytest.param(False, (2, 9, 14), ("tiled", "resident"), id="False"),
    pytest.param(True, (2, 9, 14), ("tiled", "resident"), id="True"),
    pytest.param(False, (2, 21, 37), ("tiled",), id="tiled-21x37"),
    pytest.param(True, (2, 21, 37), ("tiled",), id="tiled-21x37-match"),
    pytest.param(False, (2, 21, 37), ("resident",), id="resident-21x37"),
    pytest.param(True, (2, 21, 37), ("resident",),
                 id="resident-21x37-match"),
])
def test_kernel_decomposition_is_bit_equal(rng, with_match, shape, routes):
    """K3's decomposition (csrc/deepflow.cu) equals the plain version bit
    for bit (tolerance 0): the fused coefficients pass, and either the
    resident route (the whole pair in place) or the tiled route at scaled
    down sizes (8x4 tiles with halos of 4 recomputed per tile, 2 SOR
    iterations per launch with a 1-iteration remainder, du/dv ping-pong).
    On 2x9x14 and 2x21x37 every border pixel of both colours reads itself
    as its clamped neighbour, and the last tiles of a row and a column are
    ragged."""
    i0, i1w, derivs, flow, match = _sor_inputs(rng, *shape)
    args = _kernel_args(i0, i1w, derivs, flow)
    match = tuple(_t(a) for a in match) if with_match else None
    kw = dict(psi_iters=3, sor_iters=5, beta=0.3, **SOLVE)
    ref = tk.sor_sweeps_plain(*args, match, **kw)
    for route in routes:
        got = _emulate_k3(*args, match, route=route, **kw)
        for a, c in zip(ref, got):
            assert torch.equal(a, c), (route, float((a - c).abs().max()))


def test_kernel_decomposition_needs_the_pingpong(rng):
    """The tiled route writing its tiles in place, into the buffer the
    other tiles read their halos from, is not the plain version: the
    ping-pong is what keeps it exact."""
    i0, i1w, derivs, flow, _ = _sor_inputs(rng, 2, 21, 37)
    args = _kernel_args(i0, i1w, derivs, flow)
    kw = dict(psi_iters=3, sor_iters=5, beta=0.3, **SOLVE)
    ref = tk.sor_sweeps_plain(*args, None, **kw)
    got = _emulate_k3(*args, None, route="no_pingpong", **kw)
    assert not torch.equal(ref[0], got[0])
    assert float((ref[0] - got[0]).abs().max()) > 1e-4


def test_fine_grained_saliency_matches_jax(rng):
    """3x40x56 frames in [0, 255]: within 1e-5 of the JAX map (the port
    sums its box means in float64, the JAX package in float32)."""
    frames = (rng.uniform(size=(3, 40, 56)) * 255).astype(np.float32)
    ref = np.asarray(js.fine_grained_saliency(frames))
    got = ts.fine_grained_saliency(_t(frames)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.min() == 0.0 and got.max() == 1.0


def _saliency_float64(frames, radii=(2, 4, 8, 16)):
    """The saliency map with every box mean and sum in float64 (NumPy)."""
    img = frames.astype(np.float64)
    on = np.zeros_like(img)
    off = np.zeros_like(img)
    for r in radii:
        p = np.pad(img, ((0, 0), (r + 1, r), (r + 1, r)), mode="edge")
        ii = p.cumsum(1).cumsum(2)
        k = 2 * r + 1
        s = ii[:, k:, k:] - ii[:, :-k, k:] - ii[:, k:, :-k] + ii[:, :-k, :-k]
        on += np.maximum(img - s / (k * k), 0.0)
        off += np.maximum(s / (k * k) - img, 0.0)
    sal = on + off
    lo = sal.min(axis=(1, 2), keepdims=True)
    hi = sal.max(axis=(1, 2), keepdims=True)
    return (sal - lo) / np.maximum(hi - lo, 1e-12)


def test_fine_grained_saliency_at_clip_size(rng):
    """One 480x640 frame, the clip's size. The port sums its integral
    images in float64 and the JAX package in float32, where an integral
    image reaches ~8e7 and one ulp is 8. Port vs JAX: within 2.6e-3
    (measured 6.9e-4 to 8.5e-4 over three seeds, bound 3x). Port vs a
    float64 NumPy map: within 1e-6 (measured 1.6e-7 to 1.8e-7), closer
    than the JAX map is."""
    frames = (rng.uniform(size=(1, 480, 640)) * 255).astype(np.float32)
    ref = np.asarray(js.fine_grained_saliency(frames))
    got = ts.fine_grained_saliency(_t(frames)).numpy()
    exact = _saliency_float64(frames)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.6e-3)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    assert np.abs(got - exact).max() < np.abs(ref - exact).max()


def test_deepflow_clip_flow_matches_jax(rng):
    """A whole solve of two textured pairs moved by about 1 px under the
    reduced configuration (the pipeline tests' compile): end-point error
    against the JAX flow, mean under 1e-4 px and max under 2e-3 px
    (measured over three seeds: mean 2.1e-6 to 2.9e-6, max 3.6e-4 to
    3.9e-4 px, on flows of up to 7 px)."""
    base = [_texture(rng) for _ in range(2)]
    frames = np.stack([base[0],
                       ndimage.shift(base[0], (0.7, -1.2), order=3,
                                     mode="nearest"),
                       ndimage.shift(base[0], (1.2, -0.5), order=3,
                                     mode="nearest")]).astype(np.float32)
    ref = np.asarray(jd.deepflow_clip_flow(frames,
                                           config=JaxConfig(**REDUCED)))
    got = td.deepflow_clip_flow(_t(frames), config=TorchConfig(**REDUCED))
    got = got.numpy()
    assert got.shape == ref.shape == (2, 64, 64, 2)
    err = np.hypot(got[..., 0] - ref[..., 0], got[..., 1] - ref[..., 1])
    assert err.mean() < 1e-4 and err.max() < 2e-3, (err.mean(), err.max())
    assert np.abs(ref).max() > 0.5  # the solve found the motion


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 3-frame DICOM (the TV-L1 pipeline test's drifting blob; 48x48
    buckets to the 64x64 solve) through the port's and the JAX package's
    process_video with DeepFlow, on the normalised and the saliency
    input."""
    tmp = tmp_path_factory.mktemp("torch_deepflow")
    dcm = str(tmp / "stanford_TEST_2.dcm")
    write_dicom_clip(dcm, _synthetic_clip(np.random.default_rng(11), n=3))
    outs = {}
    for no_saliency in (True, False):
        kw = dict(verbose=False, mode="otsu", OF_algo="deepflow",
                  no_saliency=no_saliency, include_waveforms=False)
        out_t = str(tmp / f"torch_{no_saliency}.hdf5")
        out_j = str(tmp / f"jax_{no_saliency}.hdf5")
        t_pipe.process_video(dcm, out_t, None,
                             config=TorchConfig(**REDUCED), device="cpu",
                             **kw)
        j_pipe.process_video(dcm, out_j, None, config=JaxConfig(**REDUCED),
                             **kw)
        outs[no_saliency] = (out_t, out_j)
    return outs


@pytest.mark.parametrize("no_saliency", [True, False])
def test_deepflow_pipeline_matches_jax(runs, no_saliency):
    """Masks and echo bit for bit, the same HDF5 schema, and the flow
    (cm/s; 1 px = 1.5 cm/s here) within float16 storage rounding plus the
    solvers' float32 drift: mean end-point error under 0.01 px, max under
    0.05 px (measured: mean 2.2e-5 / 1.1e-6 px, max 2.6e-3 / 1.3e-3 px
    on the normalised / saliency input; the matcher flipped no pixel)."""
    import h5py

    out_t, out_j = runs[no_saliency]
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        assert sorted(ft.keys()) == sorted(fj.keys())
        assert ft["flow"].shape == fj["flow"].shape == (3, 48, 48, 2)
        assert ft["flow"].dtype == ft["echo"].dtype == np.float16
        np.testing.assert_array_equal(ft["otsu"][()], fj["otsu"][()])
        np.testing.assert_array_equal(ft["echo"][()], fj["echo"][()])
        for key in ("nframes", "mode", "frame_rate", "pixel_spacing",
                    "labels", "ID", "HR", "no_saliency", "units_converted"):
            np.testing.assert_array_equal(ft["flow"].attrs[key],
                                          fj["flow"].attrs[key])
        a = ft["flow"][()].astype(np.float32) / 1.5
        b = fj["flow"][()].astype(np.float32) / 1.5
    err = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    assert err.mean() < 0.01 and err.max() < 0.05, (err.mean(), err.max())
    if no_saliency:
        assert np.abs(b).max() > 0.5  # the blob moved: the flow is not 0


def test_deepflow_matches_float64_oracle(rng):
    """The port alone against the float64 Brox/DeepFlow oracle, as
    tests/test_deepflow_oracle.py holds the JAX solver: 96x120 smooth
    non-rigid motion, matching off, production psi 3 x SOR 12 x 3 fixed
    points; interior median EPE under 0.06 px and p95 under 0.15 px
    (measured over three seeds: median 0.034-0.038 px, p95 0.082-0.094
    px)."""
    h, w = 96, 120
    img = _texture(rng, h, w).astype(np.float64)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = 1.5 * np.sin(2 * np.pi * yy / h)
    v = -1.0 * np.cos(2 * np.pi * xx / w)
    i1 = ndimage.map_coordinates(img, [yy + v, xx + u], order=3,
                                 mode="nearest")
    golden = deepflow_flow_oracle(img, i1, nscales=3, fp_iters=3,
                                  psi_iters=3, sor_iters=12, omega=1.6)
    ours = td.deepflow_pairs(_t(img[None]), _t(i1[None]), nscales=3,
                             matching=False, iters=12, psi_iters=3,
                             omega=1.6, fp_iters=3)[0].numpy()
    err = epe(ours, golden)[8:-8, 8:-8]
    assert np.median(err) < 0.06, np.median(err)
    assert np.percentile(err, 95) < 0.15, np.percentile(err, 95)


def test_deepflow_entry_point_needs_a_card_unless_cpu_is_asked():
    """A host clip goes to ``cuda`` unless the CPU is asked for; without a
    card that raises, as the TV-L1 path does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    frames = np.zeros((2, 32, 32), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.deepflow_clip_flow(frames)
    flow = td.deepflow_clip_flow(frames, device="cpu", nscales=2, iters=1,
                                 psi_iters=1, fp_iters=1)
    assert flow.shape == (1, 32, 32, 2) and not bool(flow.abs().any())
