"""K1's decomposition on the card, emulated on the CPU and held to the
plain version (``tvl1_outer_loop_plain``).

``csrc/tvl1.cu``'s ``outer_loop_kernel`` runs the whole TV-L1 outer loop
in one cooperative launch: per phase (a median, or one fused primal-dual
step) it walks the (active pair, tile) work items, each tile computing the
primal over itself plus its right column and bottom row (the halo,
recomputed) and the dual from those; the six state planes ping-pong
between two buffers by a per-pair parity; every tile writes its error sum
to a slot, after the grid barrier one block per pair adds the pair's slots
in a fixed order, and after the next barrier every block rebuilds the list
of active pairs. The
emulation below follows that order in float32 (the card builds with
--fmad=false, so each operation rounds as here).

Tolerances: at epsilon 0 and at epsilon 2.0 (pairs freeze at different
steps, no decision near the threshold) the emulation is bit-equal to the
plain version and freezes each pair at the same step; at the production
epsilon 0.01 a pair may stop one step apart on an ulp of its error sum,
which the card tests bound at 0.05 px max-abs.
"""

import numpy as np
import pytest
import torch

from tee_optical_flow_torch.ops import tvl1_kernels as tk
from tee_optical_flow_torch.ops import warp as tw

torch.set_num_threads(1)

KW = dict(l_t=0.15 * 0.3, theta=0.3, taut=0.25 / 0.3)
# (tile width, tile height, thread rows): the kernel's 32x16 tile with
# 32x8 threads, and 8x8 tiles with 8x4 threads, whose edge tiles at 37x53
# are partial in both directions
TILINGS = {"kernel": (32, 16, 8), "8x8": (8, 8, 4)}


def _inputs(seed, rho_scale=5.0, grad_scale=(3.0, 3.0, 3.0), h=37, w=53):
    """A warp's inputs for 3 pairs, pair k's image gradient scaled by
    grad_scale[k]."""
    rng = np.random.default_rng(seed)
    b = len(grad_scale)

    def f(scale):
        return torch.from_numpy(
            (rng.normal(size=(b, h, w)) * scale).astype(np.float32))

    rho_c = f(1.0) * torch.tensor(rho_scale)[..., None, None]
    g = torch.tensor(grad_scale)[:, None, None]
    i1wx, i1wy = f(1.0) * g, f(1.0) * g
    grad = i1wx * i1wx + i1wy * i1wy
    grad[:, 5:8, 5:8] = 0.0  # the grad <= eps branch
    return [rho_c, i1wx, i1wy, grad, f(0.5), f(0.5)] + [f(0.1)
                                                        for _ in range(4)]


# Inputs whose pairs freeze at epsilon 2.0 after 2, 3 and 5 steps: with
# |grad I| ~ 70 the data step moves each pixel by l_t |grad I| > 2 px (an
# error above 2^2 per pixel) until rho falls inside its threshold, which
# takes longer for a larger residual
STAGGERED = dict(rho_scale=(600.0, 1500.0, 4000.0),
                 grad_scale=(50.0, 50.0, 50.0))


def _median_tile(plane, ys, xs):
    """median5x5_px over the pixels ys x xs of one (H, W) plane: 5 clamped
    window columns, each sorted, then the column-median network."""
    h, w = plane.shape
    wires = []
    for c in range(5):
        xc = (xs + c - 2).clamp(0, w - 1)
        col = [plane[(ys + p - 2).clamp(0, h - 1)][:, xc] for p in range(5)]
        tw._compare_exchange(col, tw.SORT5_NETWORK)
        wires += col
    tw._compare_exchange(wires, tw.COLUMN_MEDIAN_25_NETWORK)
    return wires[tw.COLUMN_MEDIAN_25_TARGET]


def _primal_region(c, s, ys, xs, *, l_t, theta):
    """primal_px at every pixel of ys x xs, from the pair's constants c
    (rho_c, i1wx, i1wy, th, inv_grad) and state s (u, v, p11..p22), with
    the neighbours p[x-1] and p[y-1] read from the whole planes."""
    h, w = s[0].shape
    y, x = ys[:, None], xs[None, :]
    at = (ys[:, None], xs[None, :])
    left = (ys[:, None], (xs - 1).clamp(min=0)[None, :])
    up = ((ys - 1).clamp(min=0)[:, None], xs[None, :])
    rho_c, ix, iy, th, ig = (t[at] for t in c)
    uo, vo = s[0][at], s[1][at]
    rho = (rho_c + ix * uo) + iy * vo
    neg, pos = rho < -th, rho > th
    rg = rho * ig
    ltx, lty = l_t * ix, l_t * iy
    d1 = torch.where(neg, ltx, torch.where(pos, -ltx, -rg * ix))
    d2 = torch.where(neg, lty, torch.where(pos, -lty, -rg * iy))

    def back(a, nb, first, last):
        return torch.where(first, a, torch.where(last, -nb, a - nb))

    p11, p12, p21, p22 = (t[at] for t in s[2:])
    dx1 = back(p11, s[2][left], x == 0, x == w - 1)
    dx2 = back(p21, s[4][left], x == 0, x == w - 1)
    dy1 = back(p12, s[3][up], y == 0, y == h - 1)
    dy2 = back(p22, s[5][up], y == 0, y == h - 1)
    un = (uo + d1) + theta * (dx1 + dy1)
    vn = (vo + d2) + theta * (dx2 + dy2)
    return uo, vo, un, vn, (p11, p12, p21, p22)


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


def _step_tile(c, cur_uv, cur_p, out_uv, out_p, y0, x0, tiling, *, l_t,
               theta, taut):
    """step_tile: the fused step on one tile; returns the tile's error sum
    in the kernel's order (per thread over its rows, then block_sum)."""
    tw_, th_, rows = tiling
    h, w = cur_uv[0].shape
    s = list(cur_uv) + list(cur_p)
    # the tile plus its right column and bottom row, inside the image
    ys = torch.arange(y0, min(y0 + th_ + 1, h))
    xs = torch.arange(x0, min(x0 + tw_ + 1, w))
    uo, vo, un, vn, ps = _primal_region(c, s, ys, xs, l_t=l_t, theta=theta)
    ny, nx = min(th_, h - y0), min(tw_, w - x0)  # the tile's own pixels
    y = ys[:ny, None]
    x = xs[None, :nx]
    uc, vc = un[:ny, :nx], vn[:ny, :nx]
    # the new flow as the dual reads it from shared memory: the halo row
    # and column exist where they lie in the image, and only there is a
    # forward difference taken
    un_s, vn_s = torch.zeros((2, ny + 1, nx + 1))
    un_s[:un.shape[0], :un.shape[1]] = un
    vn_s[:vn.shape[0], :vn.shape[1]] = vn
    zero = torch.zeros(())
    ux = torch.where(x < w - 1, un_s[:ny, 1:] - uc, zero)
    uy = torch.where(y < h - 1, un_s[1:, :nx] - uc, zero)
    vx = torch.where(x < w - 1, vn_s[:ny, 1:] - vc, zero)
    vy = torch.where(y < h - 1, vn_s[1:, :nx] - vc, zero)
    ng1 = 1.0 + taut * torch.sqrt(ux * ux + uy * uy)
    ng2 = 1.0 + taut * torch.sqrt(vx * vx + vy * vy)
    p11, p12, p21, p22 = (p[:ny, :nx] for p in ps)
    sl = (slice(y0, y0 + ny), slice(x0, x0 + nx))
    out_uv[0][sl], out_uv[1][sl] = uc, vc
    out_p[0][sl] = (p11 + taut * ux) / ng1
    out_p[1][sl] = (p12 + taut * uy) / ng1
    out_p[2][sl] = (p21 + taut * vx) / ng2
    out_p[3][sl] = (p22 + taut * vy) / ng2
    # the error: thread (tx, ty) adds its rows ty, ty + rows, ... in order
    eu, ev = uc - uo[:ny, :nx], vc - vo[:ny, :nx]
    e = eu * eu + ev * ev
    acc = torch.zeros((rows, tw_))
    for r in range(th_ // rows):
        blk = e[r * rows:(r + 1) * rows]
        if blk.numel():
            acc[:blk.shape[0], :blk.shape[1]] = \
                acc[:blk.shape[0], :blk.shape[1]] + blk
    return _block_sum(acc.reshape(-1))


def emulate_outer_loop(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
                       *, outer_iters, inner_iters, use_median, l_t, theta,
                       taut, epsilon, tiling):
    """outer_loop_kernel's order on the CPU. Returns the state and the
    steps each pair ran."""
    b, h, w = u.shape
    tw_, th_, rows = tiling
    threads = tw_ * rows
    th, inv_grad = tk.derived_constants(grad, l_t)
    use_stop = epsilon > 0.0
    thresh = float(torch.tensor(epsilon * epsilon * h * w,
                                dtype=torch.float32))
    buf = [[t.clone() for t in (u, v, p11, p12, p21, p22)],
           [torch.full_like(u, float("nan")) for _ in range(6)]]
    tiles = [(y0, x0) for y0 in range(0, h, th_) for x0 in range(0, w, tw_)]
    err = [float("inf")] * b
    puv, pp, steps = [0] * b, [0] * b, [0] * b
    derr = torch.empty(b)
    for _ in range(outer_iters):
        phases = ([-1] if use_median else []) + list(range(inner_iters))
        for k in phases:
            # every block rebuilds the same ordered list after the barrier
            act = [j for j in range(b) if not use_stop or err[j] > thresh]
            if not act:
                break
            for j in act:
                c = [t[j] for t in (rho_c, i1wx, i1wy, th, inv_grad)]
                cur_uv = [buf[puv[j]][i][j] for i in (0, 1)]
                out_uv = [buf[1 - puv[j]][i][j] for i in (0, 1)]
                if k < 0:
                    for y0, x0 in tiles:
                        ys = torch.arange(y0, min(y0 + th_, h))
                        xs = torch.arange(x0, min(x0 + tw_, w))
                        for src, dst in zip(cur_uv, out_uv):
                            dst[y0:y0 + ys.numel(), x0:x0 + xs.numel()] = \
                                _median_tile(src, ys, xs)
                    continue
                cur_p = [buf[pp[j]][i][j] for i in (2, 3, 4, 5)]
                out_p = [buf[1 - pp[j]][i][j] for i in (2, 3, 4, 5)]
                slots = torch.stack([
                    _step_tile(c, cur_uv, cur_p, out_uv, out_p, y0, x0,
                               tiling, l_t=l_t, theta=theta, taut=taut)
                    for y0, x0 in tiles])
                # after the barrier, one block: thread t adds slots t,
                # t + threads, ... in order, then block_sum
                acc = torch.zeros(threads)
                for i0 in range(0, len(tiles), threads):
                    part = slots[i0:i0 + threads]
                    acc[:part.numel()] = acc[:part.numel()] + part
                derr[j] = _block_sum(acc)
            # the barrier: flip the parities of the pairs that ran, take
            # their error
            for j in act:
                puv[j] ^= 1
                if k >= 0:
                    pp[j] ^= 1
                    steps[j] += 1
                    if use_stop:
                        err[j] = float(derr[j])
        else:
            continue
        break
    # the copy back: each pair's state from the buffer its parity names
    out = [torch.stack([buf[(puv if i < 2 else pp)[j]][i][j]
                        for j in range(b)]) for i in range(6)]
    return tuple(out), steps


def _plain_steps(args, *, outer_iters, inner_iters, use_median, l_t, theta,
                 taut, epsilon):
    """The steps each pair runs in tvl1_outer_loop_plain's loop, and its
    result: the same loop, counting."""
    rho_c, i1wx, i1wy, grad = args[:4]
    state = list(args[4:])
    b, h, w = state[0].shape
    thresh = float(torch.tensor(epsilon * epsilon * h * w,
                                dtype=torch.float32))
    th, inv_grad = tk.derived_constants(grad, l_t)
    err = torch.full((b,), float("inf"))
    steps = torch.zeros(b, dtype=torch.int64)
    for _ in range(outer_iters):
        if not bool((err > thresh).any()):
            break
        if use_median:
            state[0] = tw.median_filter_5x5_plain(state[0], err=err,
                                                  thresh=thresh)
            state[1] = tw.median_filter_5x5_plain(state[1], err=err,
                                                  thresh=thresh)
        for _ in range(inner_iters):
            act = err > thresh
            if not bool(act.any()):
                break
            steps += act.long()
            new = tk._plain_step(rho_c, i1wx, i1wy, th, inv_grad, *state,
                                 l_t=l_t, theta=theta, taut=taut)
            derr = torch.sum((new[0] - state[0]) ** 2
                             + (new[1] - state[1]) ** 2, dim=(1, 2))
            err = torch.where(act, derr, err)
            state = [torch.where(act[:, None, None], a, c)
                     for a, c in zip(new, state)]
    return tuple(state), steps.tolist()


@pytest.mark.parametrize("use_median", [True, False])
@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("epsilon", [0.0, 2.0])
def test_emulation_bit_equal(epsilon, tiling, use_median):
    """Bit-equal state, and at epsilon 2.0 the same step count per pair,
    with pairs freezing at different steps (an odd count leaves a pair's
    state in the second buffer, so the copy back is held too)."""
    args = _inputs(seed=1, **(STAGGERED if epsilon > 0 else {}))
    kw = dict(outer_iters=3, inner_iters=7, use_median=use_median,
              epsilon=epsilon, **KW)
    got, steps = emulate_outer_loop(*args, tiling=TILINGS[tiling], **kw)
    ref, ref_steps = _plain_steps(args, **kw)
    plain = tk.tvl1_outer_loop_plain(*args, **kw)
    for a, c, d in zip(got, ref, plain):
        assert torch.equal(c, d)  # the counting loop is the plain loop
        assert torch.equal(a, c)
    assert steps == ref_steps
    if epsilon > 0:
        assert steps == [2, 3, 5], steps


def test_emulation_production_epsilon():
    """At the production epsilon a stop may flip on an ulp of the error
    sum: within the 0.05 px the card is held to."""
    args = _inputs(seed=2)
    kw = dict(outer_iters=4, inner_iters=10, use_median=True, epsilon=0.01,
              **KW)
    got, steps = emulate_outer_loop(*args, tiling=TILINGS["8x8"], **kw)
    ref = tk.tvl1_outer_loop_plain(*args, **kw)
    err = max(float((a - c).abs().max()) for a, c in zip(got, ref))
    assert err <= 0.05, err
    assert all(0 < s <= 40 for s in steps), steps
