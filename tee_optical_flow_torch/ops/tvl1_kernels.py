"""K1 and K2: the TV-L1 primal-dual loops as CUDA kernels, each with its
plain PyTorch version beside it.

  * ``tvl1_outer_loop`` (K1) replaces the TPU kernel ``_fused_scale_kernel``
    (JAX package ops/tvl1_pallas.py:198-313, entry
    ``tvl1_outer_loop_pallas`` :320-374): one warp's whole outer loop,
    ``outer_iters`` x [5x5 median of u and v, then ``inner_iters``
    primal-dual steps], with the per-pair epsilon stop checked before
    every median and every step. Plain version: ``tvl1_outer_loop_plain``,
    whose epsilon semantics are the JAX package's ``_tvl1_outer_eps_xla``.
  * ``tvl1_inner_block`` (K2) replaces ``_inner_block_kernel``
    (ops/tvl1_pallas.py:141-195, entry ``tvl1_inner_block_pallas``
    :388-459): ``n_iters`` primal-dual steps, no median and no stop. Plain
    version: ``tvl1_inner_block_plain`` (the JAX ``tvl1_inner_block_xla``).

On a CUDA tensor a wrapper launches the kernels of ``csrc/tvl1.cu`` on the
current stream (K1: one persistent cooperative launch per call; K2: two
launches per step); on a CPU tensor it runs the plain version. It never
falls back. Each wrapper counts its calls in its ``launches`` attribute.
The kernels' design, and what bounds them, is in the source's head note.

The wrappers return new tensors and leave their inputs untouched, as the
JAX functions do: the state is copied once per call; K2 updates the copy
in place, K1 ping-pongs each pair between it and a scratch copy and ends
with the result in it.
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

    b, h, w = u.shape
    # the threshold rounds to float32, as jnp.float32(...) rounds it
    thresh = float(torch.tensor(epsilon * epsilon * h * w,
                                dtype=torch.float32))
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


def _launch_steps(lib, stream, consts, state, n_iters, *, l_t, theta, taut):
    """n_iters x (primal, dual) on the state, in place."""
    rho_c, i1wx, i1wy, th, inv_grad = consts
    u, v, p11, p12, p21, p22 = state
    b, h, w = u.shape
    c_lt, c_theta, c_taut = (ctypes.c_float(l_t), ctypes.c_float(theta),
                             ctypes.c_float(taut))
    for _ in range(n_iters):
        check_launch("tvl1_primal", lib.tvl1_primal(
            ptr(rho_c), ptr(i1wx), ptr(i1wy), ptr(th), ptr(inv_grad),
            ptr(u), ptr(v), ptr(p11), ptr(p12), ptr(p21), ptr(p22),
            b, h, w, c_lt, c_theta, stream))
        check_launch("tvl1_dual", lib.tvl1_dual(
            ptr(u), ptr(v), ptr(p11), ptr(p12), ptr(p21), ptr(p22),
            b, h, w, c_taut, stream))


def tvl1_inner_block(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22, *,
                     n_iters, l_t, theta, taut) -> State:
    """K2: ``n_iters`` primal-dual iterations on (B, H, W) float32 state.
    CUDA kernels on a card tensor, ``tvl1_inner_block_plain`` on a CPU
    tensor. Counts its calls in ``tvl1_inner_block.launches``."""
    inputs = (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22)
    if all(t.device.type == "cpu" for t in inputs):
        return tvl1_inner_block_plain(*inputs, n_iters=n_iters, l_t=l_t,
                                      theta=theta, taut=taut)
    check_inputs("tvl1_inner_block", inputs)
    th, inv_grad = derived_constants(grad, l_t)
    state = tuple(t.clone() for t in (u, v, p11, p12, p21, p22))
    lib = load_library()
    with launch_context(u.device) as stream:
        _launch_steps(lib, stream, (rho_c, i1wx, i1wy, th, inv_grad), state,
                      n_iters, l_t=l_t, theta=theta, taut=taut)
    tvl1_inner_block.launches += 1
    return state


tvl1_inner_block.launches = 0


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
