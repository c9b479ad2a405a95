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
current stream; on a CPU tensor it runs the plain version. It never falls
back. Each wrapper counts its calls in its ``launches`` attribute. The
kernels' design, and what bounds them, is in the source's head note.

The wrappers return new tensors and leave their inputs untouched, as the
JAX functions do: the state is copied once per call and then updated in
place by the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_lib import check_launch, launch_context, load_library, ptr
from .warp import (
    divergence, forward_diff, median_filter_5x5, median_filter_5x5_plain,
)

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


def _check_inputs(name, tensors):
    ref = tensors[0]
    if ref.ndim != 3:
        raise ValueError(f"{name}: expected (B, H, W) tensors, got "
                         f"{tuple(ref.shape)}")
    for t in tensors:
        if t.device != ref.device or t.dtype != torch.float32 \
                or t.shape != ref.shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: every input must be a contiguous float32 "
                f"{tuple(ref.shape)} tensor on {ref.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_steps(lib, stream, consts, state, n_iters, *, l_t, theta, taut,
                  err=None, thresh=0.0, partials=None, active=None,
                  nblocks=0):
    """n_iters x (primal, [err_reduce], dual) on the state, in place."""
    rho_c, i1wx, i1wy, th, inv_grad = consts
    u, v, p11, p12, p21, p22 = state
    b, h, w = u.shape
    c_lt, c_theta, c_taut = (ctypes.c_float(l_t), ctypes.c_float(theta),
                             ctypes.c_float(taut))
    c_thresh = ctypes.c_float(thresh)
    for _ in range(n_iters):
        check_launch("tvl1_primal", lib.tvl1_primal(
            ptr(rho_c), ptr(i1wx), ptr(i1wy), ptr(th), ptr(inv_grad),
            ptr(u), ptr(v), ptr(p11), ptr(p12), ptr(p21), ptr(p22),
            b, h, w, c_lt, c_theta, ptr(err), c_thresh, ptr(partials),
            stream))
        if err is not None:
            check_launch("tvl1_err_reduce", lib.tvl1_err_reduce(
                ptr(partials), nblocks, ptr(err), ptr(active), c_thresh, b,
                stream))
        check_launch("tvl1_dual", lib.tvl1_dual(
            ptr(u), ptr(v), ptr(p11), ptr(p12), ptr(p21), ptr(p22),
            b, h, w, c_taut, ptr(active), stream))


def tvl1_inner_block(rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22, *,
                     n_iters, l_t, theta, taut) -> State:
    """K2: ``n_iters`` primal-dual iterations on (B, H, W) float32 state.
    CUDA kernels on a card tensor, ``tvl1_inner_block_plain`` on a CPU
    tensor. Counts its calls in ``tvl1_inner_block.launches``."""
    inputs = (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22)
    if all(t.device.type == "cpu" for t in inputs):
        return tvl1_inner_block_plain(*inputs, n_iters=n_iters, l_t=l_t,
                                      theta=theta, taut=taut)
    _check_inputs("tvl1_inner_block", inputs)
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
    the semantics) on (B, H, W) float32 state. CUDA kernels on a card
    tensor, the plain version on a CPU tensor. Counts its calls in
    ``tvl1_outer_loop.launches``.

    On the card the batch runs the full budget: a frozen pair's launches
    return at once, and the host never waits for the error inside the
    loop. Stop decisions equal the plain version's up to the order in
    which the error sum is reduced."""
    inputs = (rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22)
    if all(t.device.type == "cpu" for t in inputs):
        return tvl1_outer_loop_plain(
            *inputs, outer_iters=outer_iters, inner_iters=inner_iters,
            use_median=use_median, l_t=l_t, theta=theta, taut=taut,
            epsilon=epsilon)
    _check_inputs("tvl1_outer_loop", inputs)
    b, h, w = u.shape
    th, inv_grad = derived_constants(grad, l_t)
    u, v, p11, p12, p21, p22 = (t.clone() for t in (u, v, p11, p12, p21, p22))
    lib = load_library()
    err: Optional[torch.Tensor] = None
    partials = active = None
    nblocks = 0
    thresh = 0.0
    if epsilon > 0.0:
        thresh = epsilon * epsilon * h * w
        nblocks = lib.tvl1_num_blocks(h, w)
        err = torch.full((b,), float("inf"), dtype=torch.float32,
                         device=u.device)
        active = torch.ones((b,), dtype=torch.int32, device=u.device)
        partials = torch.empty((b * nblocks,), dtype=torch.float32,
                               device=u.device)
    consts = (rho_c, i1wx, i1wy, th, inv_grad)
    with launch_context(u.device) as stream:
        for _ in range(outer_iters):
            if use_median:
                u = median_filter_5x5(u, err=err, thresh=thresh)
                v = median_filter_5x5(v, err=err, thresh=thresh)
            _launch_steps(lib, stream, consts, (u, v, p11, p12, p21, p22),
                          inner_iters, l_t=l_t, theta=theta, taut=taut,
                          err=err, thresh=thresh, partials=partials,
                          active=active, nblocks=nblocks)
    tvl1_outer_loop.launches += 1
    return u, v, p11, p12, p21, p22


tvl1_outer_loop.launches = 0
