"""K3: the DeepFlow psi x red-black SOR solve as CUDA kernels, with its
plain PyTorch version beside it.

``sor_sweeps`` replaces the TPU kernel ``_sor_kernel`` (JAX package
ops/deepflow_pallas.py:62-190, entry ``sor_sweeps_pallas`` :197-249), and
takes the same arguments: the warped derivative images, the temporal
differences, the level's base flow and an optional matching triple.
Plain version: ``sor_sweeps_plain``, whose body is the JAX package's XLA
``deepflow._sor_sweeps`` (ops/deepflow.py:206-279).

On a CUDA tensor the wrapper makes one call of ``deepflow_solve``
(``csrc/deepflow.cu``), which issues every launch of the solve on the
current stream, with a work buffer where the size rule
(``deepflow_resident``) sends the level to the tiled route; on a CPU
tensor it runs the plain version. It never falls
back. It counts its calls in ``sor_sweeps.launches``. The kernels'
design, and what bounds them, is in the source's head note.

The wrapper returns new tensors (du, dv) and leaves its inputs untouched,
as the JAX function does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_lib import (
    check_inputs, check_launch, launch_context, load_library, ptr,
)
from .deepflow import _checkerboard, _robust, _shifts4, _smoothness_weights

_EPS = 1e-6

Match = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def sor_sweeps_plain(i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0,
                     match: Match = None, *, psi_iters, sor_iters, omega,
                     alpha, delta, gamma, beta=0.0):
    """``psi_iters`` x [lagged robust weights, coefficients,
    ``sor_iters`` red-black SOR sweeps] on (B, H, W) float32 -> (du, dv).
    Nesting, update order and constants are the JAX package's."""
    du = torch.zeros_like(u0)
    dv = torch.zeros_like(v0)
    red = _checkerboard(u0.shape, u0.device)
    black = ~red
    for _ in range(psi_iters):
        # data-term robust weights, lagged at the current increment
        r_int = it + i1wx * du + i1wy * dv
        r_gx = itx + i1wxx * du + i1wxy * dv
        r_gy = ity + i1wxy * du + i1wyy * dv
        psi_d = _robust(r_int * r_int) * delta
        psi_g = _robust(r_gx * r_gx + r_gy * r_gy) * gamma

        # linear system coefficients (per pixel)
        a11 = psi_d * i1wx * i1wx + psi_g * (i1wxx * i1wxx + i1wxy * i1wxy)
        a12 = psi_d * i1wx * i1wy + psi_g * (i1wxx * i1wxy + i1wxy * i1wyy)
        a22 = psi_d * i1wy * i1wy + psi_g * (i1wxy * i1wxy + i1wyy * i1wyy)
        b1 = -(psi_d * i1wx * it + psi_g * (i1wxx * itx + i1wxy * ity))
        b2 = -(psi_d * i1wy * it + psi_g * (i1wxy * itx + i1wyy * ity))

        # matching soft constraint: beta * conf * psi(|w - w_match|^2)
        if match is not None:
            um, vm, conf = match
            ru = u0 + du - um
            rv = v0 + dv - vm
            a_m = beta * conf * _robust(ru * ru + rv * rv)
            a11 = a11 + a_m
            a22 = a22 + a_m
            b1 = b1 + a_m * (um - u0)
            b2 = b2 + a_m * (vm - v0)

        # smoothness: edge-averaged diffusivities, lagged at the increment
        w = _smoothness_weights(u0 + du, v0 + dv) * alpha
        wn, ws, ww, we = ((0.5 * (w + s)) for s in _shifts4(w))
        wsum = wn + ws + ww + we
        un, us, uw, ue = _shifts4(u0)
        vn, vs, vw, ve = _shifts4(v0)
        su0 = wn * un + ws * us + ww * uw + we * ue - wsum * u0
        sv0 = wn * vn + ws * vs + ww * vw + we * ve - wsum * v0

        p11 = a11 + wsum
        p22 = a22 + wsum
        denom = p11 * p22 - a12 * a12
        denom = torch.where(torch.abs(denom) > _EPS, denom, _EPS)
        inv_denom = 1.0 / denom
        rhs1c = b1 + su0
        rhs2c = b2 + sv0

        for _ in range(sor_iters):
            for mask in (red, black):
                dn, ds_, dw, de = _shifts4(du)
                dun = wn * dn + ws * ds_ + ww * dw + we * de
                dn, ds_, dw, de = _shifts4(dv)
                dvn = wn * dn + ws * ds_ + ww * dw + we * de
                rhs1 = rhs1c + dun
                rhs2 = rhs2c + dvn
                du_star = (p22 * rhs1 - a12 * rhs2) * inv_denom
                dv_star = (p11 * rhs2 - a12 * rhs1) * inv_denom
                du = torch.where(mask, (1.0 - omega) * du + omega * du_star,
                                 du)
                dv = torch.where(mask, (1.0 - omega) * dv + omega * dv_star,
                                 dv)
    return du, dv


def sor_sweeps(i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0,
               match: Match = None, *, psi_iters, sor_iters, omega, alpha,
               delta, gamma, beta=0.0):
    """K3: the fixed-point solve for (du, dv) on (B, H, W) float32 inputs
    (see ``sor_sweeps_plain``). CUDA kernels on card tensors, the plain
    version on CPU tensors. Counts its calls in ``sor_sweeps.launches``."""
    inputs = (i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0,
              *(match or ()))
    kw = dict(psi_iters=psi_iters, sor_iters=sor_iters, omega=omega,
              alpha=alpha, delta=delta, gamma=gamma, beta=beta)
    if all(t.device.type == "cpu" for t in inputs):
        return sor_sweeps_plain(*inputs[:10], match, **kw)
    check_inputs("sor_sweeps", inputs)
    if match is not None and len(match) != 3:
        raise ValueError("match must be an (um, vm, conf) triple")
    du, dv = solve(load_library(), inputs[:10], match, **kw)
    sor_sweeps.launches += 1
    return du, dv


def resident(lib: ctypes.CDLL, h: int, w: int) -> bool:
    """Whether ``lib``'s K3 solves an h x w level with one resident launch
    per call on the current card (the C entry's size rule)."""
    flag = ctypes.c_int()
    check_launch("deepflow_resident",
                 lib.deepflow_resident(h, w, ctypes.byref(flag)))
    return bool(flag.value)


def solve(lib: ctypes.CDLL, planes, match: Match, *, psi_iters, sor_iters,
          omega, alpha, delta, gamma, beta):
    """One call of ``lib``'s ``deepflow_solve`` on checked card tensors
    -> new (du, dv). ``sor_sweeps`` passes the kernel library; a
    measurement may pass a variant of it (``cuda_lib.load_library``)."""
    u0 = planes[8]
    b, h, w = u0.shape
    du = torch.empty_like(u0)
    dv = torch.empty_like(u0)
    with launch_context(u0.device) as stream:
        work = None if resident(lib, h, w) else torch.empty(
            (9, b, h, w), dtype=torch.float32, device=u0.device)
        check_launch("deepflow_solve", lib.deepflow_solve(
            *(ptr(t) for t in planes),
            *(ptr(t) for t in (match or (None, None, None))),
            ptr(du), ptr(dv), ptr(work), b, h, w, psi_iters, sor_iters,
            ctypes.c_float(omega), ctypes.c_float(1.0 - omega),
            ctypes.c_float(alpha), ctypes.c_float(delta),
            ctypes.c_float(gamma), ctypes.c_float(beta), stream))
    return du, dv


sor_sweeps.launches = 0
