"""The PyTorch port's TV-L1 solver against the JAX package's, on the CPU:
one primal-dual step, K2's plain version (the inner block), K1's plain
version (the per-warp outer loop with the epsilon stop), the block loop
(the two-quiet-blocks stop around K2, and its epsilon-0 fixed loop), the
per-size dispatch rule, whole solves, and the gamma solver (one step and
whole solves).

The JAX side runs as its own tests run it on the CPU: the XLA twins, and
the Pallas kernels in interpret mode. Tolerances: one step agrees to
float32 rounding of its O(1) values (the JAX CPU backend rounds a few
operations differently, measured 1.2e-7); a few dozen steps stay within
1e-5, as the JAX package's own interpret-parity tests require; whole
solves are compared by max-abs flow difference at epsilon=0, and by
end-point error at epsilon=0.01, where a stop decision may flip on an
ulp of the error sum.
"""

import functools

import numpy as np
import pytest
import torch

from tee_optical_flow_torch.ops import tvl1 as tt
from tee_optical_flow_torch.ops import tvl1_kernels as tk
from tee_optical_flow_torch.ops import warp as tw
from tee_optical_flow_tpu.ops import tvl1 as jt
from tee_optical_flow_tpu.ops import tvl1_pallas as jp
from tee_optical_flow_tpu.ops import warp as jw

torch.set_num_threads(1)

STEP_ATOL = 1e-6
LOOP_ATOL = 1e-5
# the gamma step computes grad = i1wx^2 + i1wy^2 + gamma^2 itself, and
# XLA's CPU backend contracts that sum into a fused multiply-add: grad and
# th = l_t * grad may differ by an ulp, so a pixel whose rho lies within
# that ulp of +-th takes the other branch of the soft threshold; the two
# branches meet there to a few ulps of the data step (|d| up to ~3):
# measured 1.7e-6 at one pixel of 3,840, every other pixel within STEP_ATOL
GAMMA_STEP_ATOL = 4e-6
NAMES = ("u", "v", "p11", "p12", "p21", "p22")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _state(rng, b=2, h=40, w=48):
    def f(scale):
        return (rng.normal(size=(b, h, w)) * scale).astype(np.float32)

    rho_c, i1wx, i1wy = f(5.0), f(3.0), f(3.0)
    grad = i1wx * i1wx + i1wy * i1wy
    grad[:, 5:8, 5:8] = 0.0  # exercise the grad <= eps branch
    u, v = f(0.5), f(0.5)
    ps = [f(0.1) for _ in range(4)]
    return (rho_c, i1wx, i1wy, grad, u, v, *ps)


def _assert_close(ref, got, atol, what=""):
    for name, a, c in zip(NAMES, ref, got):
        np.testing.assert_allclose(np.asarray(a), c.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{name} {what}")


@pytest.mark.parametrize("n_iters", [1, 13])
def test_inner_block_matches_jax(rng, n_iters):
    """K2's plain version against the XLA twin and against the Pallas K2
    in interpret mode (tile_h=16 over h=40: three tiles with halos, as
    tests/test_tvl1.py runs it)."""
    args = _state(rng)
    kw = dict(n_iters=n_iters, l_t=0.15 * 0.3, theta=0.3, taut=0.25 / 0.3)
    got = tk.tvl1_inner_block(*[_t(a) for a in args], **kw)
    atol = STEP_ATOL if n_iters == 1 else LOOP_ATOL
    _assert_close(jt.tvl1_inner_block_xla(*args, **kw), got, atol, "xla")
    _assert_close(jp.tvl1_inner_block_pallas(*args, tile_h=16,
                                             interpret=True, **kw),
                  got, atol, "pallas")


def _warped_level(rng, b=2, h=36, w=48):
    """rho_c/grad from a real warp (h=36: not a sublane multiple, so the
    Pallas kernel pads and must mask its error sum)."""
    i0 = (rng.uniform(size=(b, h, w)) * 255).astype(np.float32)
    i1 = (rng.uniform(size=(b, h, w)) * 255).astype(np.float32)
    u = (rng.normal(size=(b, h, w)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, h, w)) * 0.5).astype(np.float32)
    i1x, i1y = jw.centered_gradient(i1)
    i1w, i1wx, i1wy = (np.asarray(a) for a in
                       jw.warp_many_shift((i1, i1x, i1y), u, v, max_disp=4))
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u - i1wy * v - i0
    zeros = np.zeros((b, h, w), np.float32)
    return (rho_c, i1wx, i1wy, grad, u, v, zeros, zeros, zeros, zeros)


@pytest.mark.parametrize("epsilon", [0.0, 0.2, 2.0])
def test_outer_loop_matches_jax(rng, epsilon):
    """K1's plain version against the Pallas K1 in interpret mode and
    against the masked XLA loop (_tvl1_outer_eps_xla; at epsilon=0 the
    composed median + inner-block loop), across thresholds that stop
    pairs at different depths."""
    args = _warped_level(rng)
    kw = dict(outer_iters=3, inner_iters=7, use_median=True, l_t=0.045,
              theta=0.3, taut=0.25 / 0.3)
    got = tk.tvl1_outer_loop(*[_t(a) for a in args], epsilon=epsilon, **kw)
    pallas = jp.tvl1_outer_loop_pallas(*args, epsilon=epsilon,
                                       interpret=True, **kw)
    _assert_close(pallas, got, LOOP_ATOL, f"pallas eps={epsilon}")
    if epsilon > 0:
        xla = jt._tvl1_outer_eps_xla(*args, epsilon=epsilon, **kw)
    else:
        xla = list(args[4:])
        for _ in range(kw["outer_iters"]):
            xla[0] = jw.median_filter_5x5(xla[0])
            xla[1] = jw.median_filter_5x5(xla[1])
            xla = list(jt.tvl1_inner_block_xla(
                *args[:4], *xla, n_iters=kw["inner_iters"], l_t=kw["l_t"],
                theta=kw["theta"], taut=kw["taut"]))
    _assert_close(xla, got, LOOP_ATOL, f"xla eps={epsilon}")
    if epsilon == 2.0:
        # a huge threshold stops every pair after its first inner step:
        # the flow moved by exactly one median and one step
        one = tk.tvl1_outer_loop(*[_t(a) for a in args], epsilon=0.0,
                                 **dict(kw, outer_iters=1, inner_iters=1))
        for a, c in zip(one, got):
            np.testing.assert_array_equal(a.numpy(), c.numpy())


def _block_loop_vs_jax(rng, epsilon, inner):
    """tvl1_block_loop on CPU tensors (its plain version) against the JAX
    _tvl1_outer_eps_block around ``inner`` (the XLA inner block, or the
    Pallas K2 in interpret mode with tile_h=16: three tiles with halos over
    h=40), or at epsilon 0 the JAX fixed loop of median + inner block."""
    args = _state(rng, b=3)
    kw = dict(n_iters=10, l_t=0.15 * 0.3, theta=0.3, taut=0.25 / 0.3)
    if inner == "xla":
        j_inner = functools.partial(jt.tvl1_inner_block_xla, *args[:4], **kw)
    else:
        j_inner = functools.partial(jp.tvl1_inner_block_pallas, *args[:4],
                                    tile_h=16, interpret=True, **kw)
    outer = 6
    if epsilon > 0:
        ref = jt._tvl1_outer_eps_block(j_inner, *args[4:], outer_iters=outer,
                                       use_median=True, epsilon=epsilon)
    else:
        ref = list(args[4:])
        for _ in range(outer):
            ref[0] = jw.median_filter_5x5(ref[0])
            ref[1] = jw.median_filter_5x5(ref[1])
            ref = list(j_inner(*ref))
    got = tk.tvl1_block_loop(
        *[_t(a) for a in args], outer_iters=outer, inner_iters=kw["n_iters"],
        use_median=True, l_t=kw["l_t"], theta=kw["theta"], taut=kw["taut"],
        epsilon=epsilon)
    _assert_close(ref, got, LOOP_ATOL, f"{inner} eps={epsilon}")
    return args, kw, got


@pytest.mark.parametrize("epsilon", [1e3, 1e-9, 0.01])
def test_outer_eps_block_matches_jax(rng, epsilon):
    """The two-quiet-blocks stop (the block loop's plain version) against
    the JAX _tvl1_outer_eps_block with the XLA inner block, as
    tests/test_tvl1.py runs it: a huge epsilon freezes every pair after
    exactly two blocks, a tiny one runs the whole budget, the production
    one stops in between. Within LOOP_ATOL: the same ops, a few rounded
    differently by the JAX CPU backend."""
    args, kw, got = _block_loop_vs_jax(rng, epsilon, "xla")
    if epsilon == 1e3:
        state = [_t(a) for a in args[4:]]
        for _ in range(2):
            state[0] = tw.median_filter_5x5(state[0])
            state[1] = tw.median_filter_5x5(state[1])
            state = list(tk.tvl1_inner_block(*[_t(a) for a in args[:4]],
                                             *state, **kw))
        for a, c in zip(state, got):
            np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("epsilon", [1e3, 1e-9, 0.01])
def test_block_loop_matches_jax_pallas(rng, epsilon):
    """The same stop around the Pallas K2 in interpret mode."""
    _block_loop_vs_jax(rng, epsilon, "pallas")


def test_block_loop_fixed_matches_jax(rng):
    """Epsilon 0: outer_iters x [median, inner block] for every pair,
    against the JAX median + tvl1_inner_block_xla loop."""
    _block_loop_vs_jax(rng, 0.0, "xla")


def test_dispatch_rule_matches_fits_vmem_fused():
    """The port keeps the TPU's per-size choice of stopping rule: K1's
    per-iteration stop where fits_vmem_fused holds, K2's block stop above
    it. A 480x640 pyramid is all K1; the finest level of a 608x800 bucket
    (padded 608x896: 47.9 MB > 40 MiB) is K2 and the next one K1."""
    sizes = [(480, 640), (600, 800), (608, 800)]
    for h, w in list(sizes):
        sizes += jw.pyramid_shapes(h, w, 5, 0.8)[1:]
    for h, w in sizes:
        assert tt.per_iteration_stop(h, w) == jp.fits_vmem_fused(h, w), (h, w)
    assert all(tt.per_iteration_stop(h, w)
               for h, w in jw.pyramid_shapes(480, 640, 5, 0.8))
    assert not tt.per_iteration_stop(608, 800)
    assert tt.per_iteration_stop(486, 640)


def _textured_pairs(rng, h=40, w=48):
    from scipy import ndimage

    i0s, i1s = [], []
    for shift in ((1.0, -1.5), (-0.5, 2.0)):
        img = ndimage.gaussian_filter(rng.uniform(size=(h, w)), 2.0)
        img = (img - img.min()) / (img.max() - img.min()) * 255.0
        i0s.append(img)
        i1s.append(ndimage.shift(img, shift, order=3, mode="nearest"))
    return (np.stack(i0s).astype(np.float32),
            np.stack(i1s).astype(np.float32))


@pytest.mark.parametrize("epsilon", [0.0, 0.01])
def test_tvl1_flow_pairs_matches_jax(rng, epsilon):
    """Whole multi-scale solves, bicubic (the tiled warp is held against
    JAX in test_torch_ops and rides the pipeline test: its JAX compile
    costs 20 s a solve here). At epsilon=0 the iteration
    counts are fixed and the flows agree to 1e-3 px (measured 2e-4, ulps
    grown over ~200 steps); at epsilon=0.01 a pair may stop one step
    earlier or later on an ulp of the error sum, so the bound is on the
    end-point error: mean under 0.01 px, max under 0.1 px."""
    i0, i1 = _textured_pairs(rng)
    kw = dict(nscales=3, zoom=0.8, warps=2, outer_iters=4, inner_iters=15,
              use_median=True, max_disp=4, epsilon=epsilon,
              interpolation="bicubic")
    ref = np.asarray(jt.tvl1_flow_pairs(i0, i1, **kw))
    got = tt.tvl1_flow_pairs(_t(i0), _t(i1), use_pallas=True, **kw).numpy()
    assert got.shape == ref.shape == (2, 40, 48, 2)
    if epsilon == 0.0:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    else:
        epe = np.hypot(got[..., 0] - ref[..., 0], got[..., 1] - ref[..., 1])
        assert epe.mean() < 0.01 and epe.max() < 0.1, (epe.mean(), epe.max())


def _gamma_level(rng, b=2, h=40, w=48):
    """A pyramid level's inputs: two textured frames with a brightness
    ramp between them, and a small flow and illumination field."""
    i0, i1 = _textured_pairs(rng, h, w)
    i1 = i1 + np.linspace(0.0, 20.0, w, dtype=np.float32)[None, None]
    u, v, w_ = (rng.normal(size=(b, h, w)).astype(np.float32) * s
                for s in (0.5, 0.5, 2.0))
    return i0, i1, u, v, w_


def test_gamma_is_refused(rng, monkeypatch):
    """gamma > 0 (OpenCV's illumination term) was refused until the gamma
    solver was ported; it now runs, and one step of it matches the JAX
    step (``_gamma_warp_matches_jax``)."""
    _gamma_warp_matches_jax(rng, monkeypatch, inner_iters=1)


def test_gamma_steps_match_jax(rng, monkeypatch):
    _gamma_warp_matches_jax(rng, monkeypatch, inner_iters=3)


def _gamma_warp_matches_jax(rng, monkeypatch, inner_iters):
    """One warp of the gamma solver with ``inner_iters`` steps (no median,
    epsilon 0) against the JAX ``_tvl1_scale_gamma``: u, v and w to
    float32 rounding (GAMMA_STEP_ATOL after one step, LOOP_ATOL after
    more). Both take the same warped frame and gradients, drawn at the
    magnitudes of ``_state`` (the warp is held to the JAX package's in
    test_torch_ops), so the comparison is of the step."""
    b, h, w = 2, 40, 48
    i0 = rng.uniform(0.0, 50.0, size=(b, h, w)).astype(np.float32)
    i1w = i0 + (rng.normal(size=(b, h, w)) * 5.0).astype(np.float32)
    i1wx, i1wy = ((rng.normal(size=(b, h, w)) * 3.0).astype(np.float32)
                  for _ in range(2))
    i1wx[:, 5:8, 5:8] = i1wy[:, 5:8, 5:8] = 0.0
    u, v, ill = ((rng.normal(size=(b, h, w)) * s).astype(np.float32)
                 for s in (0.5, 0.5, 2.0))
    warped = (i1w, i1wx, i1wy)
    monkeypatch.setattr(jt, "warp_many_shift", lambda *a, **k: warped)
    monkeypatch.setattr(tt, "warp_many_shift",
                        lambda *a, **k: [_t(x) for x in warped])
    kw = dict(lam=0.15, tau=0.25, theta=0.3, gamma=1.0, warps=1,
              outer_iters=1, inner_iters=inner_iters, use_median=False,
              max_disp=4, epsilon=0.0, warp_kernel="bilinear")
    ref = jt._tvl1_scale_gamma(i0, i0, u, v, ill, **kw)
    got = tt._tvl1_scale_gamma(*map(_t, (i0, i0, u, v, ill)), **kw)
    atol = GAMMA_STEP_ATOL if inner_iters == 1 else LOOP_ATOL
    for name, a, c in zip("uvw", ref, got):
        np.testing.assert_allclose(np.asarray(a), c.numpy(), rtol=0,
                                   atol=atol, err_msg=name)
    assert float((got[2] - _t(ill)).abs().max()) > 0.01  # w moved


@pytest.mark.parametrize("epsilon", [0.0, 0.01])
def test_gamma_flow_pairs_matches_jax(rng, epsilon):
    """Whole reduced gamma solves (bicubic, with the median; at epsilon
    0.01 the early stop's per-pair masks) against the JAX package's, by
    end-point error: max under 1e-3 px, the gamma=0 solves' bound
    (measured 2.4e-4)."""
    i0, i1, *_ = _gamma_level(rng)
    kw = dict(nscales=3, zoom=0.8, warps=2, outer_iters=4, inner_iters=15,
              use_median=True, max_disp=4, epsilon=epsilon, gamma=1.0,
              interpolation="bicubic")
    ref = np.asarray(jt.tvl1_flow_pairs(i0, i1, **kw))
    got = tt.tvl1_flow_pairs(_t(i0), _t(i1), use_pallas=True, **kw).numpy()
    assert got.shape == ref.shape == (2, 40, 48, 2)
    epe = np.hypot(got[..., 0] - ref[..., 0], got[..., 1] - ref[..., 1])
    assert epe.max() < 1e-3, epe.max()
    assert np.abs(ref).max() > 0.5


def test_gamma_early_stop_freezes_pairs_as_jax():
    """At epsilon > 0 a converged pair is frozen: two identical frames
    (the flow stays 0, err drops below eps^2*H*W after the first step)
    beside a moving pair; both packages leave the still pair exactly 0
    and agree on the moving one within 1e-3 px."""
    rng = np.random.default_rng(3)
    i0, i1 = _textured_pairs(rng)
    i1[0] = i0[0]
    kw = dict(nscales=2, zoom=0.8, warps=2, outer_iters=3, inner_iters=10,
              use_median=True, max_disp=4, epsilon=0.01, gamma=1.0,
              interpolation="bilinear")
    ref = np.asarray(jt.tvl1_flow_pairs(i0, i1, **kw))
    got = tt.tvl1_flow_pairs(_t(i0), _t(i1), **kw).numpy()
    assert not ref[0].any() and not got[0].any()
    epe = np.hypot(got[..., 0] - ref[..., 0], got[..., 1] - ref[..., 1])
    assert epe.max() < 1e-3, epe.max()
