"""The block loop's decomposition on the card, emulated on the CPU and held
to the plain version (``tvl1_block_loop_plain``).

``csrc/tvl1.cu``'s ``tvl1_block_loop`` runs one warp's loop at a level
above K1's size rule as a train of launches. Per block: sweep launches
(an even number, at least 2, the block's steps spread over them) that
each load an extended tile (the tile and a halo of S pixels) of the state
and the constants into shared memory, run up to S fused steps there in
place over shrinking rows and columns, and write only the tile; the state
ping-pongs between the caller's buffers and a scratch copy from launch to
launch. The first launch of a block stages the flow over the extended
tile and two more pixels, clamped to the image, takes the 5x5 median, and
with the stop keeps the post-median flow (um); the last writes each
tile's block delta sum((nu-um)^2 + (nv-vm)^2) to a slot, each thread over
its pixels in order and then a shuffle tree, and a block-end launch adds
a pair's slots in a fixed order and counts its strikes. Frozen pairs'
launches do nothing. The emulation below follows that order in float32
(the card builds with --fmad=false, so each operation rounds as here), at
the kernel's own geometry (read from the source) and at a scaled-down one
whose tiles are a few pixels wide.

Tolerance: bit-equal state at epsilon 0, 1e3 (every pair freezes after
exactly two blocks), 1e-9 (the whole budget) and with a batch where two
pairs freeze early and two run the whole budget, on shapes that are a
multiple of neither tile side. A halo one pixel short must differ. The
card tests' tolerance at epsilon > 0 (``tvl1_kernels.block_loop_stops``)
is held here too: it must accept the plain result and refuse a state one
block short.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tee_optical_flow_torch
from tee_optical_flow_torch.ops import tvl1_kernels as tk
from tee_optical_flow_torch.ops import warp as tw

torch.set_num_threads(1)

KW = dict(l_t=0.15 * 0.3, theta=0.3, taut=0.25 / 0.3)
# the block-end launch's threads
END_THREADS = 256


def _source_geometry():
    """(S, EW, EH, threads) as csrc/tvl1.cu defines them by default."""
    src = (Path(tee_optical_flow_torch.__file__).parent / "csrc"
           / "tvl1.cu").read_text()
    return tuple(int(re.search(rf"#define {name} (\d+)", src).group(1))
                 for name in ("K2_S", "K2_EW", "K2_EH", "K2_THREADS"))


# (steps per launch, extended width, extended height, threads, halo): the
# kernel's, and a scaled-down one with two-warp blocks
GEOMETRIES = {"kernel": _source_geometry() + (_source_geometry()[0],),
              "small": (2, 12, 10, 64, 2)}


def _tree_sum(s):
    """s[t] += s[t + half] for half = n/2 .. 1, in float32: a shuffle
    tree's order."""
    s = s.clone()
    half = s.numel() // 2
    while half:
        s[:half] = s[:half] + s[half:2 * half]
        half //= 2
    return s[0]


def _block_sum(v):
    """block_sum: the tree over each warp's 32 lanes, then over the warps'
    sums."""
    return _tree_sum(torch.stack([_tree_sum(w) for w in v.split(32)]))


def _thread_sums(e, threads):
    """Each thread's sum over the flat pixels t, t + threads, ... in order."""
    acc = torch.zeros(threads)
    for i0 in range(0, e.numel(), threads):
        part = e[i0:i0 + threads]
        acc[:part.numel()] = acc[:part.numel()] + part
    return acc


def _median_window(plane, y0, x0, eh, ew):
    """The 5x5 median over an eh x ew region at (y0, x0) of an (H, W)
    plane, from its window two pixels wider on each side, clamped to the
    image (median25: sorted columns, then the column-median network)."""
    h, w = plane.shape
    ys = (torch.arange(eh + 4) + y0 - 2).clamp(0, h - 1)
    xs = (torch.arange(ew + 4) + x0 - 2).clamp(0, w - 1)
    raw = plane[ys][:, xs]
    wires = []
    for c in range(5):
        col = [raw[p:p + eh, c:c + ew] for p in range(5)]
        tw._compare_exchange(col, tw.SORT5_NETWORK)
        wires += col
    tw._compare_exchange(wires, tw.COLUMN_MEDIAN_25_NETWORK)
    return wires[tw.COLUMN_MEDIAN_25_TARGET]


def _back_diff(a, prev, first, last):
    return torch.where(first, a, torch.where(last, -prev, a - prev))


def _steps(t, n_steps, gy, gx, h, w, *, l_t, theta, taut):
    """tile_steps on the shared-memory planes t (dict of (EH, EW)), in
    place: step j updates the primal on rows and columns j .. E-j and the
    dual on j .. E-j-1, pixels inside the image only."""
    eh, ew = t["u"].shape
    inimg = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    for j in range(1, n_steps + 1):
        r, c = slice(j, eh - j + 1), slice(j, ew - j + 1)
        rl, cl = slice(j, eh - j + 1), slice(j - 1, ew - j)
        ru, cu = slice(j - 1, eh - j), slice(j, ew - j + 1)
        yy, xx = gy[r, c], gx[r, c]
        fx, lx, fy, ly = xx == 0, xx == w - 1, yy == 0, yy == h - 1
        dx1 = _back_diff(t["p11"][r, c], t["p11"][rl, cl], fx, lx)
        dx2 = _back_diff(t["p21"][r, c], t["p21"][rl, cl], fx, lx)
        dy1 = _back_diff(t["p12"][r, c], t["p12"][ru, cu], fy, ly)
        dy2 = _back_diff(t["p22"][r, c], t["p22"][ru, cu], fy, ly)
        uo, vo = t["u"][r, c], t["v"][r, c]
        ix, iy = t["ix"][r, c], t["iy"][r, c]
        rho = (t["rc"][r, c] + ix * uo) + iy * vo
        th = t["th"][r, c]
        neg, pos = rho < -th, rho > th
        rg = rho * t["ig"][r, c]
        ltx, lty = l_t * ix, l_t * iy
        d1 = torch.where(neg, ltx, torch.where(pos, -ltx, -rg * ix))
        d2 = torch.where(neg, lty, torch.where(pos, -lty, -rg * iy))
        m = inimg[r, c]
        t["u"][r, c] = torch.where(m, (uo + d1) + theta * (dx1 + dy1), uo)
        t["v"][r, c] = torch.where(m, (vo + d2) + theta * (dx2 + dy2), vo)

        r, c = slice(j, eh - j), slice(j, ew - j)
        rs, cs = slice(j + 1, eh - j + 1), slice(j + 1, ew - j + 1)
        yy, xx = gy[r, c], gx[r, c]
        zero = torch.zeros(())
        uc, vc = t["u"][r, c], t["v"][r, c]
        ux = torch.where(xx < w - 1, t["u"][r, cs] - uc, zero)
        uy = torch.where(yy < h - 1, t["u"][rs, c] - uc, zero)
        vx = torch.where(xx < w - 1, t["v"][r, cs] - vc, zero)
        vy = torch.where(yy < h - 1, t["v"][rs, c] - vc, zero)
        ng1 = 1.0 + taut * torch.sqrt(ux * ux + uy * uy)
        ng2 = 1.0 + taut * torch.sqrt(vx * vx + vy * vy)
        m = inimg[r, c]
        for name, d, ng in (("p11", ux, ng1), ("p12", uy, ng1),
                            ("p21", vx, ng2), ("p22", vy, ng2)):
            p = t[name][r, c]
            t[name][r, c] = torch.where(m, (p + taut * d) / ng, p)


def _sweep(consts, src, dst, um, slots, active, *, n_steps, median,
           save_um, delta, geometry, l_t, theta, taut):
    """One block_sweep_kernel launch over every (tile, active pair)."""
    _, ew, eh, threads, halo = geometry
    b, h, w = src[0].shape
    tw_, th_ = ew - 2 * halo, eh - 2 * halo
    tiles = [(ty * th_ - halo, tx * tw_ - halo)
             for ty in range(math.ceil(h / th_))
             for tx in range(math.ceil(w / tw_))]
    names = ("u", "v", "p11", "p12", "p21", "p22")
    for k in active:
        for n, (y0, x0) in enumerate(tiles):
            gy = (torch.arange(eh) + y0)[:, None].expand(eh, ew)
            gx = (torch.arange(ew) + x0)[None, :].expand(eh, ew)
            inimg = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            cy, cx = gy.clamp(0, h - 1), gx.clamp(0, w - 1)
            nan = torch.tensor(float("nan"))

            def load(plane):
                return torch.where(inimg, plane[cy, cx], nan)

            t = {name: load(p[k]) for name, p in zip(names, src)}
            if median:
                t["u"] = torch.where(
                    inimg, _median_window(src[0][k], y0, x0, eh, ew), nan)
                t["v"] = torch.where(
                    inimg, _median_window(src[1][k], y0, x0, eh, ew), nan)
            rc, ix, iy, grad = (load(c[k]) for c in consts)
            th, ig = tk.derived_constants(grad, l_t)
            t.update(rc=rc, ix=ix, iy=iy, th=th, ig=ig)
            centre = (inimg & (torch.arange(eh)[:, None] >= halo)
                      & (torch.arange(eh)[:, None] < eh - halo)
                      & (torch.arange(ew)[None, :] >= halo)
                      & (torch.arange(ew)[None, :] < ew - halo))
            if save_um:
                um[0][k][gy[centre], gx[centre]] = t["u"][centre]
                um[1][k][gy[centre], gx[centre]] = t["v"][centre]
            _steps(t, n_steps, gy, gx, h, w, l_t=l_t, theta=theta, taut=taut)
            for name, d in zip(names, dst):
                d[k][gy[centre], gx[centre]] = t[name][centre]
            if delta:
                e = torch.zeros((eh, ew))
                eu = t["u"][centre] - um[0][k][gy[centre], gx[centre]]
                ev = t["v"][centre] - um[1][k][gy[centre], gx[centre]]
                e[centre] = eu * eu + ev * ev
                slots[k, n] = _block_sum(_thread_sums(e.reshape(-1), threads))


def block_sweeps(n_iters, s):
    """tvl1_block_sweeps: ceil(n / S), made even, at least 2."""
    n = -(-n_iters // s)
    return max(2, n + (n & 1))


def emulate_block_loop(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
                       *, outer_iters, inner_iters, use_median, l_t, theta,
                       taut, epsilon, geometry, steps_per_launch=None):
    """tvl1_block_loop's order on the CPU. ``steps_per_launch`` overrides
    the kernel's S (the halo stays ``geometry``'s): a mutation."""
    b, h, w = u.shape
    s = steps_per_launch or geometry[0]
    consts = (rho_c, i1wx, i1wy, grad)
    use_stop = epsilon > 0.0
    thresh = float(torch.tensor(epsilon * epsilon * h * w,
                                dtype=torch.float32))
    bufs = ([t.clone() for t in (u, v, p11, p12, p21, p22)],
            [torch.full_like(u, float("nan")) for _ in range(6)])
    um = [torch.full_like(u, float("nan")) for _ in range(2)]
    strikes = [0] * b
    slots = None
    sweeps = block_sweeps(inner_iters, s)
    for _ in range(outer_iters):
        active = [k for k in range(b) if not use_stop or strikes[k] < 2]
        for i in range(sweeps):
            src, dst = bufs[i & 1], bufs[1 - (i & 1)]
            n_steps = inner_iters // sweeps + (i < inner_iters % sweeps)
            kw = dict(n_steps=n_steps, median=use_median and i == 0,
                      save_um=use_stop and i == 0,
                      delta=use_stop and i == sweeps - 1, geometry=geometry,
                      l_t=l_t, theta=theta, taut=taut)
            if slots is None:
                tiles_n = math.ceil(h / (geometry[2] - 2 * geometry[4])) * \
                    math.ceil(w / (geometry[1] - 2 * geometry[4]))
                slots = torch.full((b, tiles_n), float("nan"))
            _sweep(consts, src, dst, um, slots, active, **kw)
        if use_stop:
            # block_end_kernel: thread t adds slots t, t + 256, ... in
            # order, then block_sum; frozen pairs untouched
            for k in active:
                derr = _block_sum(_thread_sums(slots[k], END_THREADS))
                strikes[k] = strikes[k] + 1 if float(derr) < thresh else 0
    return tuple(bufs[0]), strikes


def _inputs(seed, b=3, h=37, w=53):
    """A warp's inputs: random data at a level's scales."""
    rng = np.random.default_rng(seed)

    def f(scale):
        return torch.from_numpy(
            (rng.normal(size=(b, h, w)) * scale).astype(np.float32))

    rho_c, i1wx, i1wy = f(5.0), f(3.0), f(3.0)
    grad = i1wx * i1wx + i1wy * i1wy
    grad[:, 5:8, 5:8] = 0.0  # the grad <= eps branch
    return [rho_c, i1wx, i1wy, grad, f(0.5), f(0.5)] + [f(0.1)
                                                        for _ in range(4)]


# (epsilon, pairs zeroed): bit-equal cases. 1e3 freezes every pair after
# two blocks; 1e-9 runs the whole budget; "mixed" zeroes pairs 0 and 2,
# which freeze after two blocks while 1 and 3 run the whole budget
CASES = {"eps0": (0.0, ()), "eps1e3": (1e3, ()), "eps1e-9": (1e-9, ()),
         "mixed": (1e-6, (0, 2))}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulation_bit_equal(geometry, case):
    epsilon, zeroed = CASES[case]
    args = _inputs(seed=1, b=4 if zeroed else 3)
    for t in args:
        t[list(zeroed)] = 0.0
    kw = dict(outer_iters=3, inner_iters=7, use_median=True, epsilon=epsilon,
              **KW)
    got, strikes = emulate_block_loop(*args, geometry=GEOMETRIES[geometry],
                                      **kw)
    ref = tk.tvl1_block_loop_plain(*args, **kw)
    for a, c in zip(got, ref):
        assert torch.equal(a, c)
    if epsilon == 1e3:
        assert strikes == [2] * 3
        two = tk.tvl1_block_loop_plain(*args, **dict(kw, outer_iters=2,
                                                     epsilon=0.0))
        for a, c in zip(got, two):
            assert torch.equal(a, c)
    if case == "mixed":
        assert strikes == [2, 0, 2, 0], strikes
    assert float((got[0] - args[4]).abs().max()) > 0.01


def test_emulation_without_median():
    """No median: the block delta is taken against the block's start."""
    args = _inputs(seed=3)
    kw = dict(outer_iters=3, inner_iters=5, use_median=False, epsilon=1e-9,
              **KW)
    got, _ = emulate_block_loop(*args, geometry=GEOMETRIES["small"], **kw)
    for a, c in zip(got, tk.tvl1_block_loop_plain(*args, **kw)):
        assert torch.equal(a, c)


def test_short_halo_differs():
    """A mutation: S + 1 steps per launch on a halo of S. The tile's outer
    ring misses its last step, so the result differs from the plain
    version (the kernel's static halo of S is what makes it exact)."""
    args = _inputs(seed=2)
    s = GEOMETRIES["small"][0]
    kw = dict(outer_iters=2, inner_iters=6, use_median=True, epsilon=0.0,
              **KW)
    got, _ = emulate_block_loop(*args, geometry=GEOMETRIES["small"],
                                steps_per_launch=s + 1, **kw)
    ref = tk.tvl1_block_loop_plain(*args, **kw)
    assert not all(torch.equal(a, c) for a, c in zip(got, ref))


@pytest.mark.parametrize("case", ["eps1e3", "eps1e-9", "mixed"])
def test_block_loop_stops(case):
    """``block_loop_stops``, the card's tolerance at epsilon > 0. The plain
    result matches at the plain stop's own count, the only reachable one
    when no decision may flip; a state one block short is never accepted,
    as no stop ends after one block even when every decision flips."""
    epsilon, zeroed = CASES[case]
    args = _inputs(seed=1, b=4 if zeroed else 3)
    for t in args:
        t[list(zeroed)] = 0.0
    kw = dict(outer_iters=3, inner_iters=7, use_median=True, epsilon=epsilon,
              **KW)
    ref = tk.tvl1_block_loop_plain(*args, **kw)
    blocks, reachable, matched, margin = tk.block_loop_stops(
        args, ref, near=0.0, **kw)
    assert blocks == {"eps1e3": [2, 2, 2], "eps1e-9": [3, 3, 3],
                      "mixed": [2, 3, 2, 3]}[case]
    for j, n in enumerate(blocks):
        assert reachable[j] == {n} and n in matched[j], (j, matched[j])
        assert margin[j] > 0.0
    short = tk.tvl1_block_loop_plain(*args, **dict(kw, outer_iters=1,
                                                   epsilon=0.0))
    _, reachable, matched, _ = tk.block_loop_stops(args, short, near=math.inf,
                                                   **kw)
    for j in range(len(blocks)):
        assert reachable[j] == {2, 3}
        if j not in zeroed:
            assert matched[j] == {1} and not reachable[j] & matched[j]
