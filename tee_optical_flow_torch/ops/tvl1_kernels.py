"""K1 and K2: the TV-L1 primal-dual loops as CUDA kernels, each with its
plain PyTorch version beside it.

  * ``tvl1_outer_loop`` (K1) replaces the TPU kernel ``_fused_scale_kernel``
    (JAX package ops/tvl1_pallas.py:198-313, entry
    ``tvl1_outer_loop_pallas`` :320-374): one warp's whole outer loop,
    ``outer_iters`` x [5x5 median of u and v, then ``inner_iters``
    primal-dual steps], with the per-pair epsilon stop checked before
    every median and every step. Plain version: ``tvl1_outer_loop_plain``,
    whose epsilon semantics are the JAX package's ``_tvl1_outer_eps_xla``.
  * ``tvl1_block_loop`` runs one warp's whole loop at the levels above
    K1's size rule: the JAX package's ``_tvl1_outer_eps_block``
    (ops/tvl1.py:175-233) around K2, ``_inner_block_kernel``
    (ops/tvl1_pallas.py:141-195, entry ``tvl1_inner_block_pallas``
    :388-459), with the median between blocks. Plain version:
    ``tvl1_block_loop_plain``.
  * ``tvl1_inner_block`` (K2 alone): ``n_iters`` primal-dual steps, no
    median and no stop. Plain version: ``tvl1_inner_block_plain`` (the JAX
    ``tvl1_inner_block_xla``).

On a CUDA tensor a wrapper makes one call of ``csrc/tvl1.cu`` on the
current stream (K1: one persistent cooperative launch; the block loop and
K2 alone: a train of sweep launches issued from C); on a CPU tensor it
runs the plain version. It never falls back. Each wrapper counts its calls
in its ``launches`` attribute. The kernels' design, and what bounds them,
is in the source's head note.

The wrappers return new tensors and leave their inputs untouched, as the
JAX functions do: the state is copied once per call and ping-pongs
between the copy and a scratch buffer, ending in the copy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_lib import (
    check_inputs, check_launch, launch_context, load_library, ptr,
)
from .warp import divergence, forward_diff, median_filter_5x5_plain

_GRAD_EPS = 1e-10

State = Tuple[torch.Tensor, ...]


def derived_constants(grad: torch.Tensor, l_t: float):
    """th = l_t * grad and the guarded reciprocal gradient, per warp, in
    the JAX wrapper's exact form (tvl1_pallas.py:334-336)."""
    grad = grad.to(torch.float32)
    th = l_t * grad
    inv_grad = torch.where(grad > _GRAD_EPS,
                           1.0 / torch.clamp_min(grad, _GRAD_EPS),
                           torch.zeros_like(grad))
    return th, inv_grad


def _plain_step(rho_c, i1wx, i1wy, th, inv_grad, u, v, p11, p12, p21, p22,
                *, l_t, theta, taut):
    """One primal-dual iteration; returns (u, v, p11, p12, p21, p22)."""
    ltx = l_t * i1wx
    lty = l_t * i1wy
    rho = rho_c + i1wx * u + i1wy * v
    neg = rho < -th
    pos = rho > th
    rg = rho * inv_grad
    # soft-thresholded data step (the v-subproblem)
    d1 = torch.where(neg, ltx, torch.where(pos, -ltx, -rg * i1wx))
    d2 = torch.where(neg, lty, torch.where(pos, -lty, -rg * i1wy))
    # u-subproblem: proximal TV step via the dual field
    un = (u + d1) + theta * divergence(p11, p12)
    vn = (v + d2) + theta * divergence(p21, p22)
    ux, uy = forward_diff(un)
    vx, vy = forward_diff(vn)
    # keep the division form (see cuda_lib's note on parity)
    ng1 = 1.0 + taut * torch.sqrt(ux * ux + uy * uy)
    ng2 = 1.0 + taut * torch.sqrt(vx * vx + vy * vy)
    return (un, vn, (p11 + taut * ux) / ng1, (p12 + taut * uy) / ng1,
            (p21 + taut * vx) / ng2, (p22 + taut * vy) / ng2)


def tvl1_inner_block_plain(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21,
                           p22, *, n_iters, l_t, theta, taut) -> State:
    """``n_iters`` primal-dual iterations on (B, H, W) state: the plain
    version of K2 (JAX ``tvl1_inner_block_xla``, ops/tvl1.py:57-97)."""
    th, inv_grad = derived_constants(grad, l_t)
    state = (u, v, p11, p12, p21, p22)
    for _ in range(n_iters):
        state = _plain_step(rho_c, i1wx, i1wy, th, inv_grad, *state,
                            l_t=l_t, theta=theta, taut=taut)
    return state


def _fixed_loop_plain(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22, *,
                      outer_iters, inner_iters, use_median, l_t, theta, taut):
    """``outer_iters`` x [median + ``inner_iters`` steps] for every pair:
    K1's and the block loop's rule at epsilon 0 (the JAX ``outer_body``,
    ops/tvl1.py:422-430)."""
    state = (u, v, p11, p12, p21, p22)
    for _ in range(outer_iters):
        uu, vv, *ps = state
        if use_median:
            uu = median_filter_5x5_plain(uu)
            vv = median_filter_5x5_plain(vv)
        state = tvl1_inner_block_plain(
            rho_c, i1wx, i1wy, grad, uu, vv, *ps, n_iters=inner_iters,
            l_t=l_t, theta=theta, taut=taut)
    return state


def _threshold(epsilon, h, w) -> float:
    """eps^2 * H * W rounded to float32, as jnp.float32(...) rounds it."""
    return float(torch.tensor(epsilon * epsilon * h * w, dtype=torch.float32))


def tvl1_outer_loop_plain(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21,
                          p22, *, outer_iters, inner_iters, use_median, l_t,
                          theta, taut, epsilon=0.0) -> State:
    """The plain version of K1.

    epsilon == 0: ``outer_iters`` x [median + ``inner_iters`` steps].
    epsilon > 0: the JAX package's ``_tvl1_outer_eps_xla``
    (ops/tvl1.py:100-172): err, the sum of squared flow updates of a
    pair's last inner iteration, starts at +inf; a pair whose err is not
    above eps^2*H*W is frozen before every median and every step. The loop
    ends early once every pair is frozen, as the JAX while_loop does."""
    if epsilon <= 0.0:
        return _fixed_loop_plain(
            rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
            outer_iters=outer_iters, inner_iters=inner_iters,
            use_median=use_median, l_t=l_t, theta=theta, taut=taut)

    b, h, w = u.shape
    thresh = _threshold(epsilon, h, w)
    th, inv_grad = derived_constants(grad, l_t)
    err = torch.full((b,), float("inf"), dtype=torch.float32, device=u.device)
    state = [u, v, p11, p12, p21, p22]
    for _ in range(outer_iters):
        if not bool((err > thresh).any()):
            break
        if use_median:
            state[0] = median_filter_5x5_plain(state[0], err=err,
                                               thresh=thresh)
            state[1] = median_filter_5x5_plain(state[1], err=err,
                                               thresh=thresh)
        for _ in range(inner_iters):
            act = err > thresh
            if not bool(act.any()):
                break
            new = _plain_step(rho_c, i1wx, i1wy, th, inv_grad, *state,
                              l_t=l_t, theta=theta, taut=taut)
            derr = torch.sum((new[0] - state[0]) ** 2
                             + (new[1] - state[1]) ** 2, dim=(1, 2))
            err = torch.where(act, derr, err)
            m = act[:, None, None]
            state = [torch.where(m, a, c) for a, c in zip(new, state)]
    return tuple(state)


def tvl1_block_loop_plain(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
                          *, outer_iters, inner_iters, use_median, l_t, theta,
                          taut, epsilon=0.0) -> State:
    """The plain version of the block loop: one warp's whole loop at a
    level that takes K2.

    epsilon == 0: ``outer_iters`` x [median + ``inner_iters`` steps].
    epsilon > 0: the JAX package's ``_tvl1_outer_eps_block``
    (ops/tvl1.py:175-233), the stop at outer-block granularity: a pair
    freezes after TWO CONSECUTIVE blocks each moved less than
    eps^2*H*W in total, the block delta sum((nu-um)^2 + (nv-vm)^2) taken
    against the flow after the block's median. Frozen pairs keep their
    state; the loop ends once every pair is frozen, as the JAX
    while_loop does."""
    kw = dict(n_iters=inner_iters, l_t=l_t, theta=theta, taut=taut)
    if epsilon <= 0.0:
        return _fixed_loop_plain(
            rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
            outer_iters=outer_iters, inner_iters=inner_iters,
            use_median=use_median, l_t=l_t, theta=theta, taut=taut)
    b, h, w = u.shape
    thresh = _threshold(epsilon, h, w)
    strikes = torch.zeros((b,), dtype=torch.int32, device=u.device)
    state = (u, v, p11, p12, p21, p22)
    for _ in range(outer_iters):
        act = strikes < 2
        if not bool(act.any()):
            break
        u, v, p11, p12, p21, p22 = state
        m = act[:, None, None]
        if use_median:
            um = torch.where(m, median_filter_5x5_plain(u), u)
            vm = torch.where(m, median_filter_5x5_plain(v), v)
        else:
            um, vm = u, v
        nu, nv, n11, n12, n21, n22 = tvl1_inner_block_plain(
            rho_c, i1wx, i1wy, grad, um, vm, p11, p12, p21, p22, **kw)
        derr = torch.sum((nu - um) ** 2 + (nv - vm) ** 2, dim=(1, 2))
        strikes = torch.where(
            act, torch.where(derr < thresh, strikes + 1,
                             torch.zeros_like(strikes)), strikes)
        state = (torch.where(m, nu, um), torch.where(m, nv, vm),
                 torch.where(m, n11, p11), torch.where(m, n12, p12),
                 torch.where(m, n21, p21), torch.where(m, n22, p22))
    return state


def block_loop_stops(inputs, got, *, near, outer_iters, inner_iters,
                     use_median, l_t, theta, taut, epsilon):
    """Holds ``got``, a block loop's result at epsilon > 0, to the plain
    version when the block delta may be summed in another order, so that
    a decision whose delta lies near the threshold may flip. A pair's state
    after n blocks of the stop is the fixed loop's (``_fixed_loop_plain``)
    after n blocks, so this walks that loop once. Per pair it returns:

      * ``blocks``: the blocks the plain version's stop runs;
      * ``reachable``: the block counts at which the stop may end when
        every decision whose block delta lay within ``near`` (a share of
        the threshold) of it may go either way;
      * ``matched``: the block counts after which the fixed loop's state
        equals ``got``'s, bit for bit;
      * ``margin``: the least distance from the threshold of a block delta
        of the blocks the plain stop runs, as a share of the threshold.

    ``got`` holds to the plain version where every pair's ``reachable``
    and ``matched`` meet."""
    rho_c, i1wx, i1wy, grad = inputs[:4]
    state = tuple(inputs[4:])
    b, h, w = state[0].shape
    thresh = _threshold(epsilon, h, w)
    blocks, strikes = [outer_iters] * b, [0] * b
    live = [{0} for _ in range(b)]  # strikes of the stops still running
    reachable = [set() for _ in range(b)]
    matched = [set() for _ in range(b)]
    margin = [float("inf")] * b
    for k in range(1, outer_iters + 1):
        uu, vv, *ps = state
        if use_median:
            uu = median_filter_5x5_plain(uu)
            vv = median_filter_5x5_plain(vv)
        state = tvl1_inner_block_plain(
            rho_c, i1wx, i1wy, grad, uu, vv, *ps, n_iters=inner_iters,
            l_t=l_t, theta=theta, taut=taut)
        derr = torch.sum((state[0] - uu) ** 2 + (state[1] - vv) ** 2,
                         dim=(1, 2)).tolist()
        same = torch.stack([(a == c).flatten(1).all(1)
                            for a, c in zip(state, got)]).all(0).tolist()
        for j in range(b):
            if same[j]:
                matched[j].add(k)
            below = derr[j] < thresh
            if strikes[j] < 2:
                margin[j] = min(margin[j], abs(derr[j] - thresh) / thresh)
                strikes[j] = strikes[j] + 1 if below else 0
                if strikes[j] == 2:
                    blocks[j] = k
            ways = ({below, not below}
                    if abs(derr[j] - thresh) <= near * thresh else {below})
            nxt = set()
            for s in live[j]:
                for d in ways:
                    if d and s == 1:
                        reachable[j].add(k)
                    else:
                        nxt.add(s + 1 if d else 0)
            live[j] = nxt
    for j in range(b):
        if live[j]:
            reachable[j].add(outer_iters)
    return blocks, reachable, matched, margin


def block_loop(lib: ctypes.CDLL, inputs, *, outer_iters, inner_iters,
               use_median, l_t, theta, taut, epsilon=0.0) -> State:
    """One call of ``lib``'s ``tvl1_block_loop`` on checked card tensors
    (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22) -> the new state.
    The wrappers pass the kernel library; a measurement may pass a variant
    of it (``cuda_lib.load_library``)."""
    rho_c, i1wx, i1wy, grad = inputs[:4]
    b, h, w = rho_c.shape
    dev = rho_c.device
    state = tuple(t.clone() for t in inputs[4:])
    # the other half of the ping-pong; with the stop, the post-median flow,
    # the per-tile delta slots and the strikes
    scratch = torch.empty((6, b, h, w), dtype=torch.float32, device=dev)
    use_stop = epsilon > 0.0
    um = slots = strikes = None
    if use_stop:
        um = torch.empty((2, b, h, w), dtype=torch.float32, device=dev)
        slots = torch.empty((b * lib.tvl1_block_tiles(h, w),),
                            dtype=torch.float32, device=dev)
        strikes = torch.empty((b,), dtype=torch.int32, device=dev)
    thresh = _threshold(epsilon, h, w) if use_stop else 0.0
    with launch_context(dev) as stream:
        check_launch("tvl1_block_loop", lib.tvl1_block_loop(
            ptr(rho_c), ptr(i1wx), ptr(i1wy), ptr(grad),
            *(ptr(t) for t in state), ptr(scratch), ptr(um), ptr(slots),
            ptr(strikes), b, h, w, outer_iters, inner_iters,
            int(use_median), int(use_stop), ctypes.c_float(l_t),
            ctypes.c_float(theta), ctypes.c_float(taut),
            ctypes.c_float(thresh), stream))
    return state


def tvl1_inner_block(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22, *,
                     n_iters, l_t, theta, taut) -> State:
    """K2: ``n_iters`` primal-dual iterations on (B, H, W) float32 state.
    On a card tensor one call of ``csrc/tvl1.cu``'s block loop with one
    block, no median and no stop (``tvl1_block_sweeps(n_iters)`` sweep
    launches); ``tvl1_inner_block_plain`` on a CPU tensor. Counts its calls
    in ``tvl1_inner_block.launches``."""
    inputs = (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22)
    if all(t.device.type == "cpu" for t in inputs):
        return tvl1_inner_block_plain(*inputs, n_iters=n_iters, l_t=l_t,
                                      theta=theta, taut=taut)
    check_inputs("tvl1_inner_block", inputs)
    state = block_loop(load_library(), inputs, outer_iters=1,
                       inner_iters=n_iters, use_median=False, l_t=l_t,
                       theta=theta, taut=taut)
    tvl1_inner_block.launches += 1
    return state


tvl1_inner_block.launches = 0


def tvl1_block_loop(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22, *,
                    outer_iters, inner_iters, use_median, l_t, theta, taut,
                    epsilon=0.0) -> State:
    """One warp's whole loop at a level that takes K2 (see
    ``tvl1_block_loop_plain`` for the semantics) on (B, H, W) float32
    state. On a card tensor ONE call of ``csrc/tvl1.cu``'s
    ``tvl1_block_loop``, which issues every launch on the current stream
    (per block: the sweep launches, the median fused into the first, and
    with the stop a block-end launch) and never waits on the host; frozen
    pairs' launches do no work. On a CPU tensor, the plain version. Counts
    its calls in ``tvl1_block_loop.launches``.

    Strike decisions equal the plain version's up to the order in which
    the block delta is summed."""
    inputs = (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22)
    kw = dict(outer_iters=outer_iters, inner_iters=inner_iters,
              use_median=use_median, l_t=l_t, theta=theta, taut=taut,
              epsilon=epsilon)
    if all(t.device.type == "cpu" for t in inputs):
        return tvl1_block_loop_plain(*inputs, **kw)
    check_inputs("tvl1_block_loop", inputs)
    state = block_loop(load_library(), inputs, **kw)
    tvl1_block_loop.launches += 1
    return state


tvl1_block_loop.launches = 0


def tvl1_outer_loop(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22, *,
                    outer_iters, inner_iters, use_median, l_t, theta, taut,
                    epsilon=0.0) -> State:
    """K1: one warp's whole outer loop (see ``tvl1_outer_loop_plain`` for
    the semantics) on (B, H, W) float32 state. On a card tensor, one
    cooperative launch of ``csrc/tvl1.cu``'s persistent kernel, which runs
    the medians, the steps and the epsilon stop on the device and ends
    once every pair has frozen; a refused launch raises. On a CPU tensor,
    the plain version. Counts its calls in ``tvl1_outer_loop.launches``.

    Stop decisions equal the plain version's up to the order in which the
    error sum is reduced."""
    inputs = (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22)
    if all(t.device.type == "cpu" for t in inputs):
        return tvl1_outer_loop_plain(
            *inputs, outer_iters=outer_iters, inner_iters=inner_iters,
            use_median=use_median, l_t=l_t, theta=theta, taut=taut,
            epsilon=epsilon)
    check_inputs("tvl1_outer_loop", inputs)
    b, h, w = u.shape
    dev = u.device
    th, inv_grad = derived_constants(grad, l_t)
    state = tuple(t.clone() for t in (u, v, p11, p12, p21, p22))
    lib = load_library()
    # the other half of each pair's ping-pong, the per-tile error slots and
    # the per-pair error
    scratch = torch.empty((6, b, h, w), dtype=torch.float32, device=dev)
    partials = torch.empty((b * lib.tvl1_num_tiles(h, w),),
                           dtype=torch.float32, device=dev)
    derr = torch.empty((b,), dtype=torch.float32, device=dev)
    with launch_context(dev) as stream:
        check_launch("tvl1_outer_loop", lib.tvl1_outer_loop(
            ptr(rho_c), ptr(i1wx), ptr(i1wy), ptr(th), ptr(inv_grad),
            *(ptr(t) for t in state), ptr(scratch), ptr(partials),
            ptr(derr), b, h, w, outer_iters, inner_iters,
            int(use_median), int(epsilon > 0.0), ctypes.c_float(l_t),
            ctypes.c_float(theta), ctypes.c_float(taut),
            ctypes.c_float(epsilon * epsilon * h * w), stream))
    tvl1_outer_loop.launches += 1
    return state


tvl1_outer_loop.launches = 0
