"""The port's CUDA kernels (K1, the block loop with K2, the median, K3 and
the labelling) against their plain PyTorch versions, and the SAM
segmentor and one SAM fine-tuning step against their CPU runs, on the
card (vit_t, and vit_b at a small image). Marked ``cuda``; without a CUDA
device every test skips, decided inside the ``card`` fixture so that
every worker collects the same tests.

On the machine with the card (which has no JAX, so the repo's conftest
cannot load there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: the kernels compute each step in the plain version's
operation order with separately rounded operations (built with
--fmad=false), so K2, K1 and the block loop at epsilon=0 and the median
are bit-equal. At epsilon > 0 the per-pair error is summed in another
order than torch.sum, so a pair may stop one step apart in K1 (0.05 px
max-abs) and a block apart in the block loop. There a pair's state must
be bit-equal to the plain fixed loop's after a block count that the
two-quiet-blocks stop reaches when any decision whose block delta lay
within NEAR (a share of the threshold) of it flips
(``tvl1_kernels.block_loop_stops``): the plain version's own count where
no delta came that close. K3 (the DeepFlow SOR
solve) is bit-equal on both of its routes (resident and tiled), with and
without the matching term. The labelling is bit-equal round for round,
where it has not converged too.
"""

import numpy as np
import pytest
import torch

from tee_optical_flow_torch.ops import deepflow_kernels as dk
from tee_optical_flow_torch.ops import morphology as mo
from tee_optical_flow_torch.ops import tvl1_kernels as tk
from tee_optical_flow_torch.ops.cuda_lib import load_library
from tee_optical_flow_torch.ops import warp as tw
from tee_optical_flow_torch.utils.tracing import (
    get_counters, get_stage_report,
)
from test_torch_labelling import CASES as LABEL_CASES
from test_torch_labelling import _cases as label_cases
from test_torch_labelling import (
    deep_masks, labelling_schedule, rounds_needed, scipy_clean,
)

pytestmark = pytest.mark.cuda

SHAPES = {"small": (2, 40, 48), "full": (4, 480, 640)}
# K1 also at the TV-L1 path's coarsest level, a multiple of neither side
# of its 32x16 tile
K1_SHAPES = dict(SHAPES, level=(3, 197, 262))
# the block loop at a ragged shape (a multiple of neither side of its
# tile) and at the K2 path's finest level
K2_SHAPES = {"small": (2, 40, 48), "ragged": (3, 77, 93),
             "level": (4, 608, 800)}
NEAR = 1e-4
# K3 on each side of its size rule (one pair's nine planes in one block's
# shared memory: H x ceil(W/2) <= 3,212): an odd resident shape, the
# largest resident level of the DeepFlow path (60x80), a tiled shape just
# above the rule with ragged last tiles, and two tiled path levels
DF_SHAPES = {"small": (2, 21, 37), "level60": (39, 60, 80),
             "above": (3, 77, 93), "level120": (39, 120, 160),
             "full": (39, 480, 640)}
DF_RESIDENT = {"small", "level60"}
DF_KW = dict(psi_iters=3, sor_iters=12, omega=1.6, alpha=8.0, delta=0.5,
             gamma=5.0, beta=0.3)
KW = dict(l_t=0.15 * 0.3, theta=0.3, taut=0.25 / 0.3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _level(shape, device, seed=0):
    """A warp's inputs from a warped random texture."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    i0 = torch.from_numpy((rng.uniform(size=shape) * 255).astype(np.float32))
    i1 = torch.roll(i0, shifts=(1, -1), dims=(1, 2))
    u = torch.from_numpy((rng.normal(size=shape) * 0.5).astype(np.float32))
    v = torch.from_numpy((rng.normal(size=shape) * 0.5).astype(np.float32))
    i0, i1, u, v = (t.to(device) for t in (i0, i1, u, v))
    i1x, i1y = tw.centered_gradient(i1)
    i1w, i1wx, i1wy = tw.warp_many_shift((i1, i1x, i1y), u, v, max_disp=4,
                                         kernel="bicubic")
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u - i1wy * v - i0
    zeros = torch.zeros_like(u)
    return [t.contiguous() for t in
            (rho_c, i1wx, i1wy, grad, u, v, zeros, zeros, zeros, zeros)]


def _launches(wrapper):
    """The wrapper's calls so far (its ``launches.<wrapper>`` counter)."""
    return get_counters().get(f"launches.{wrapper}", 0)


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("size", ["small", "full"])
def test_median_bit_equal(card, size):
    f = _level(SHAPES[size], card)[4]
    f[:, 3:9, 3:9] = 0.5  # ties
    before = _launches("median_filter_5x5")
    got = tw.median_filter_5x5(f)
    assert _launches("median_filter_5x5") == before + 1
    assert torch.equal(got, tw.median_filter_5x5_plain(f))
    torch.cuda.synchronize()


@pytest.mark.parametrize("size", ["small", "full"])
def test_inner_block_bit_equal(card, size):
    args = _level(SHAPES[size], card)
    before = _launches("tvl1_inner_block")
    got = tk.tvl1_inner_block(*args, n_iters=30, **KW)
    assert _launches("tvl1_inner_block") == before + 1
    ref = tk.tvl1_inner_block_plain(*args, n_iters=30, **KW)
    assert _max_abs(got, ref) == 0.0
    # inputs untouched, as the JAX function leaves them
    assert torch.equal(args[4], _level(SHAPES[size], card)[4])


@pytest.mark.parametrize("epsilon", [0.0, 0.01, 2.0])
@pytest.mark.parametrize("size", ["small", "full", "level"])
def test_outer_loop_matches_plain(card, size, epsilon):
    args = _level(K1_SHAPES[size], card)
    kw = dict(outer_iters=10, inner_iters=30, use_median=True,
              epsilon=epsilon, **KW)
    before = _launches("tvl1_outer_loop")
    got = tk.tvl1_outer_loop(*args, **kw)
    assert _launches("tvl1_outer_loop") == before + 1
    ref = tk.tvl1_outer_loop_plain(*args, **kw)
    err = _max_abs(got, ref)
    assert err <= (0.0 if epsilon == 0.0 else 0.05), err


@pytest.mark.parametrize("use_median", [True, False])
def test_outer_loop_frozen_and_running_pairs(card, use_median):
    """Pairs 0 and 2 are all zero, so their first step moves nothing and
    they freeze at once; pairs 1 and 3 move by far more than the tiny
    threshold and never freeze. No stop decision is near the threshold,
    so the kernel is bit-equal to the plain version, and the running pairs
    equal an epsilon-0 run. Without the median each pair's state ends in
    the kernel's second buffer (21 steps), so the copy back is held too."""
    args = _level((4, 40, 48), card)
    for t in args:
        t[0::2] = 0.0
    kw = dict(outer_iters=3, inner_iters=7, use_median=use_median, **KW)
    got = tk.tvl1_outer_loop(*args, epsilon=1e-6, **kw)
    ref = tk.tvl1_outer_loop_plain(*args, epsilon=1e-6, **kw)
    for a, c in zip(got, ref):
        assert torch.equal(a, c)
    running = tk.tvl1_outer_loop_plain(*args, epsilon=0.0, **kw)
    for a, c in zip(got, running):
        assert torch.equal(a[1::2], c[1::2])
        assert not bool(a[0::2].any())
    assert float((got[0][1::2] - args[4][1::2]).abs().max()) > 0.01


@pytest.mark.parametrize("epsilon", [0.0, 0.01, 1e3])
@pytest.mark.parametrize("size", list(K2_SHAPES))
def test_block_loop_matches_plain(card, size, epsilon):
    """Bit-equal at epsilon 0; at 0.01 every pair bit-equal to the plain
    version's state after a block count its stop reaches when a decision
    within NEAR of the threshold may flip (the plain version's own count
    where no decision came that close); at 1e3 every pair freezes after
    exactly two blocks: the state of two median + block rounds."""
    args = _level(K2_SHAPES[size], card)
    before_in = [t.clone() for t in args]
    kw = dict(outer_iters=10, inner_iters=30, use_median=True,
              epsilon=epsilon, **KW)
    before = _launches("tvl1_block_loop")
    got = tk.tvl1_block_loop(*args, **kw)
    assert _launches("tvl1_block_loop") == before + 1
    ref = tk.tvl1_block_loop_plain(*args, **kw)
    if epsilon > 0:
        _, reachable, matched, margin = tk.block_loop_stops(
            args, got, near=NEAR, **kw)
        for j in range(args[0].shape[0]):
            assert reachable[j] & matched[j], (j, reachable[j], matched[j],
                                               margin[j])
    else:
        assert _max_abs(got, ref) == 0.0
    if epsilon == 1e3:
        two = tk.tvl1_block_loop_plain(*args, **dict(kw, outer_iters=2,
                                                     epsilon=0.0))
        for a, c in zip(got, two):
            assert torch.equal(a, c)
    for a, c in zip(before_in, args):
        assert torch.equal(a, c)


@pytest.mark.parametrize("use_median", [True, False])
def test_block_loop_frozen_and_running_pairs(card, use_median):
    """Pairs 0 and 2 are all zero, so no block moves them and they freeze
    after two blocks; pairs 1 and 3 move by far more than the tiny
    threshold and run the whole budget. No decision is near the
    threshold: bit-equal to the plain version, and the running pairs equal
    an epsilon-0 run."""
    args = _level((4, 40, 48), card)
    for t in args:
        t[0::2] = 0.0
    kw = dict(outer_iters=5, inner_iters=7, use_median=use_median, **KW)
    got = tk.tvl1_block_loop(*args, epsilon=1e-6, **kw)
    ref = tk.tvl1_block_loop_plain(*args, epsilon=1e-6, **kw)
    for a, c in zip(got, ref):
        assert torch.equal(a, c)
    running = tk.tvl1_block_loop_plain(*args, epsilon=0.0, **kw)
    for a, c in zip(got, running):
        assert torch.equal(a[1::2], c[1::2])
        assert not bool(a[0::2].any())
    assert float((got[0][1::2] - args[4][1::2]).abs().max()) > 0.01


def _device_launches(fn, names):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(f"::{n}" in e.name for n in names))


@pytest.mark.parametrize("n_iters", [1, 13, 30])
def test_inner_block_device_launches(card, n_iters):
    """K2 alone is tvl1_block_sweeps(n_iters) sweep launches (an even
    number, at least 2) and nothing else of csrc/tvl1.cu; the block loop
    adds one block-end launch per block with the stop."""
    args = _level(SHAPES["small"], card)
    lib = load_library()
    sweeps = lib.tvl1_block_sweeps(n_iters)
    assert sweeps >= 2 and sweeps % 2 == 0
    names = ("block_sweep_kernel", "block_end_kernel", "outer_loop_kernel",
             "median5x5_kernel")
    got = _device_launches(
        lambda: tk.tvl1_inner_block(*args, n_iters=n_iters, **KW), names)
    assert got == sweeps
    got = _device_launches(
        lambda: tk.tvl1_block_loop(*args, outer_iters=3, inner_iters=n_iters,
                                   use_median=True, epsilon=0.01, **KW),
        names)
    assert got == 3 * (sweeps + 1)


LIBRARY_KERNELS = ("outer_loop_kernel", "median5x5_kernel",
                   "block_sweep_kernel", "block_end_kernel", "coefs_kernel",
                   "sweep_kernel", "resident_kernel", "label_pass_kernel")


@pytest.mark.parametrize("call", ["outer_loop", "median", "inner_block",
                                  "block_loop", "sor_resident", "sor_tiled",
                                  "refused", "labelling"])
def test_device_launch_count(card, call):
    """The kernel library's own count of the launches its C entries issued
    (``cuda_lib.device_launch_count``) equals each call's design count: K1
    one cooperative launch, the median one, K2 alone
    ``tvl1_block_sweeps(n)`` sweep launches, the block loop with the stop
    outer x (sweeps + 1), K3 one resident launch or, tiled, 3 psi rounds
    x (1 coefficients + 3 sweep launches of S = 4 SOR iterations), the
    labelling whole groups of pass launches up to its first quiet pass
    (``labelling_schedule`` of a plain count of the rounds needed); a
    call whose
    launch is refused counts none. A profiler trace of the same call
    shows no more of the library's kernels (it may show fewer)."""
    from torch.profiler import ProfilerActivity, profile

    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count

    lib = load_library()
    args = _level(SHAPES["small"], card)
    loop = dict(outer_iters=3, inner_iters=13, use_median=True, **KW)
    if call == "refused":
        lib = load_library({"K2_EW": 160, "K2_EH": 128})
    calls = {
        "outer_loop": (lambda: tk.tvl1_outer_loop(*args, epsilon=0.01,
                                                  **loop), 1),
        "median": (lambda: tw.median_filter_5x5(args[4]), 1),
        "inner_block": (lambda: tk.tvl1_inner_block(*args, n_iters=13, **KW),
                        lib.tvl1_block_sweeps(13)),
        "block_loop": (lambda: tk.tvl1_block_loop(*args, epsilon=0.01,
                                                  **loop),
                       3 * (lib.tvl1_block_sweeps(13) + 1)),
        "sor_resident": (lambda: dk.sor_sweeps(
            *_df_level(DF_SHAPES["small"], card)[0], None, **DF_KW), 1),
        "sor_tiled": (lambda: dk.sor_sweeps(
            *_df_level(DF_SHAPES["above"], card)[0], None, **DF_KW), 12),
        "refused": (lambda: pytest.raises(RuntimeError, tk.block_loop, lib,
                                          args, epsilon=0.01, **loop), 0),
        "labelling": (lambda: mo.connected_components(args[4] > 0, 1),
                      labelling_schedule(rounds_needed(args[4] > 0, 1),
                                            *SHAPES["small"][1:])[2]),
    }
    fn, want = calls[call]
    counts = []
    for traced in (False, True):
        torch.cuda.synchronize()
        device_launch_count(lib, reset=True)
        if traced:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        else:
            fn()
            torch.cuda.synchronize()
        counts.append(device_launch_count(lib))
    assert counts == [want, want], (call, counts)
    seen = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(f"::{n}" in e.name for n in LIBRARY_KERNELS))
    assert seen <= want, (call, seen)


def test_block_loop_raises_on_refused_launch(card):
    """A build whose extended tile needs more shared memory than a block
    may have (160x128: 901,120 B) is refused: the call raises a
    RuntimeError and nothing falls back; the default build still runs
    after it. Bad inputs are refused before any launch."""
    args = _level(SHAPES["small"], card)
    kw = dict(outer_iters=2, inner_iters=5, use_median=True, epsilon=0.01,
              **KW)
    big = load_library({"K2_EW": 160, "K2_EH": 128})
    with pytest.raises(RuntimeError, match="tvl1_block_loop"):
        tk.block_loop(big, args, **kw)
    got = tk.tvl1_block_loop(*args, **kw)
    ref = tk.tvl1_block_loop_plain(*args, **kw)
    assert _max_abs(got, ref) == 0.0
    for bad in (args[4].double(), args[4].cpu(),
                args[4].transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            tk.tvl1_block_loop(*args[:4], bad, *args[5:], **kw)


def test_outer_loop_refuses_bad_inputs(card):
    args = _level(SHAPES["small"], card)
    kw = dict(outer_iters=1, inner_iters=1, use_median=True, **KW)
    for bad in (args[4].double(), args[4].cpu(),
                args[4].transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            tk.tvl1_outer_loop(*args[:4], bad, *args[5:], **kw)
    with pytest.raises(ValueError):
        tk.tvl1_outer_loop(*args[:4], args[4][:1], *args[5:], **kw)


def test_wrappers_refuse_bad_inputs(card):
    args = _level(SHAPES["small"], card)
    with pytest.raises(ValueError):
        tk.tvl1_inner_block(*args[:4], args[4].double(), *args[5:],
                            n_iters=1, **KW)
    with pytest.raises(ValueError):
        tk.tvl1_inner_block(*args[:4], args[4].cpu(), *args[5:],
                            n_iters=1, **KW)
    with pytest.raises(ValueError):
        tw.median_filter_5x5(args[4].transpose(1, 2))


def _df_level(shape, device, seed=0):
    """K3's ten planes and a matching triple, random at the scales of a
    real level (the JAX package's parity inputs)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def f(scale):
        return torch.randn(shape, generator=g, device=device) * scale

    planes = [f(8.0), f(8.0), f(2.0), f(2.0), f(2.0),  # i1wx .. i1wyy
              f(40.0), f(8.0), f(8.0),                 # it, itx, ity
              f(0.8), f(0.8)]                          # u0, v0
    match = (f(1.0), f(1.0), f(1.0).abs())
    return planes, match


@pytest.mark.parametrize("with_match", [False, True])
@pytest.mark.parametrize("size", list(DF_SHAPES))
def test_sor_sweeps_bit_equal(card, size, with_match):
    planes, match = _df_level(DF_SHAPES[size], card)
    match = match if with_match else None
    _, h, w = DF_SHAPES[size]
    assert dk.resident(load_library(), h, w) == (size in DF_RESIDENT)
    before_in = [t.clone() for t in planes + list(match or ())]
    before = _launches("sor_sweeps")
    got = dk.sor_sweeps(*planes, match, **DF_KW)
    assert _launches("sor_sweeps") == before + 1
    ref = dk.sor_sweeps_plain(*planes, match, **DF_KW)
    assert _max_abs(got, ref) == 0.0
    assert float(got[0].abs().max()) > 0.1  # the solve moved
    # inputs untouched, as the JAX function leaves them
    for a, c in zip(before_in, planes + list(match or ())):
        assert torch.equal(a, c)


def test_sor_sweeps_refuses_bad_inputs(card):
    planes, match = _df_level(DF_SHAPES["small"], card)
    for bad in (planes[0].double(), planes[0].cpu(),
                planes[0].transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            dk.sor_sweeps(bad, *planes[1:], None, **DF_KW)
    with pytest.raises(ValueError):
        dk.sor_sweeps(*planes, match[:2], **DF_KW)


def test_sor_sweeps_raises_on_refused_launch(card):
    """A build whose extended tile needs more shared memory than a block
    may have (160x128: 738,432 B) refuses the tiled route's launch: the solve
    raises a RuntimeError and nothing falls back. Its resident route still
    solves a shape under the size rule, also after the refused launch,
    which leaves no error behind for the next call. A non-contiguous match plane is
    refused before any launch."""
    big = load_library({"K3_EW": 160, "K3_EH": 128})
    small, _ = _df_level(DF_SHAPES["small"], card)
    above, match = _df_level(DF_SHAPES["above"], card)
    ref = dk.sor_sweeps_plain(*small, None, **DF_KW)
    assert _max_abs(dk.solve(big, small, None, **DF_KW), ref) == 0.0
    with pytest.raises(RuntimeError, match="deepflow_solve"):
        dk.solve(big, above, None, **DF_KW)
    assert _max_abs(dk.solve(big, small, None, **DF_KW), ref) == 0.0
    got = dk.sor_sweeps(*above, None, **DF_KW)
    assert _max_abs(got, dk.sor_sweeps_plain(*above, None, **DF_KW)) == 0.0
    bad = (match[0], match[1], match[2].transpose(1, 2).contiguous()
           .transpose(1, 2))
    with pytest.raises(ValueError):
        dk.sor_sweeps(*above, bad, **DF_KW)



# --- the labelling kernel (csrc/labelling.cu) --------------------------------

def _label_plain_on_card(monkeypatch):
    """Route connected_components' CUDA branch through the plain loop."""
    monkeypatch.setattr(mo, "_label_on_card",
                        lambda m, c: mo._label_plain(m, c))


def _labelling_spans():
    """The labelling spans closed so far (the stage report's calls)."""
    return get_stage_report().get("labelling", {}).get("calls", 0)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("geometry,case", LABEL_CASES)
def test_labelling_bit_equal(card, geometry, case, connectivity):
    """The emulation's cases (tests/test_torch_labelling.py), the
    serpentine that needs more than 2*(H+W) rounds among them, bit-equal
    to the plain loop on the CPU, rounds run included; one wrapper call
    each."""
    mask = label_cases(geometry)[case]
    before = _launches("connected_components")
    rounds = get_counters().get("labelling_rounds", 0)
    got = mo.connected_components(mask.to(card), connectivity)
    assert _launches("connected_components") == before + 1
    ran = get_counters()["labelling_rounds"] - rounds
    stack = mask if mask.ndim == 3 else mask[None]
    ref, ref_rounds = mo._label_plain(stack, connectivity)
    assert torch.equal(got.cpu(), ref if mask.ndim == 3 else ref[0])
    assert ran == ref_rounds


# echo_clip's radial contraction c_k = A sin(2 pi k / period): a 16-frame
# cardiac cycle, up to ~2.2 px of wall motion per frame at 480x640
AMPLITUDE, PERIOD = 0.04, 16


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


def _otsu_stack(h, w, device):
    """Otsu masks of echo_clip's 33-frame clip, bucketed to 40 frames as
    the clip path does."""
    from tee_optical_flow_torch.ops.otsu import otsu_mask_stack

    frames, _ = echo_clip(33, h, w)
    frames = np.concatenate([frames, np.repeat(frames[-1:], 7, axis=0)])
    gray = torch.from_numpy(frames).to(device).to(torch.float32) / 255.0
    return otsu_mask_stack(gray)


@pytest.mark.parametrize("hw", [(480, 640), (600, 800)])
def test_labelling_otsu_masks_bit_equal(card, hw, monkeypatch):
    """The Otsu path's fills and size filters at both cells' shapes, and
    the cohort analysis's 8-connected reads, kernel against the plain loop
    on the card; every labelling takes the kernel, one call a span."""
    raw = _otsu_stack(*hw, card)
    calls = {
        "fill": lambda: mo.binary_fill_holes(raw),
        "remove": lambda: mo.remove_small_objects(raw, 500, 1),
        "clean": lambda: mo.clean_binary_stack(raw, 500),
        "centroids": lambda: mo.component_areas_and_centroids(raw),
        "first_area": lambda: mo.label_first_area(raw),
    }
    spans, launches = _labelling_spans(), _launches("connected_components")
    got = {k: fn() for k, fn in calls.items()}
    assert _launches("connected_components") - launches == 6
    assert _labelling_spans() - spans == 6
    _label_plain_on_card(monkeypatch)
    for k, fn in calls.items():
        ref = fn()
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got[k], ref))):
            assert torch.equal(a, b), k


def test_labelling_waits_for_nothing(card):
    """The wrapper waits for nothing but its counted reads of the passes'
    flags, one a group of passes (``host_syncs``, as sync debug mode sees
    them), and the library counts its design's pass launches: whole
    groups up to the first quiet pass, from a plain count of the rounds
    needed."""
    import warnings

    from tee_optical_flow_torch.ops.cuda_lib import device_launch_count

    mask = torch.rand((4, 97, 131), device=card) > 0.4
    mo.connected_components(mask, 1)  # builds and loads the library
    torch.cuda.synchronize()
    want = [labelling_schedule(rounds_needed(mask, c), 97, 131)
            for c in (1, 2)]
    lib = load_library()
    device_launch_count(lib, reset=True)
    syncs = get_counters().get("host_syncs", 0)
    torch.cuda.set_sync_debug_mode("warn")  # the switch itself warns once
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for connectivity in (1, 2):
                mo.connected_components(mask, connectivity)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seen = [w for w in caught if "synchroniz" in str(w.message)]
    reads = sum(r for _, r, _ in want)
    assert len(seen) == get_counters()["host_syncs"] - syncs == reads
    assert device_launch_count(lib) == sum(n for _, _, n in want)


@pytest.mark.parametrize("size", [(21, 30), (96, 200)])
def test_labelling_deep_masks_equal_scipy(card, size):
    """A corridor of background and a serpentine of foreground that need
    more than 2*(H+W) rounds, filled and size-filtered on the card as
    scipy.ndimage does it on the host."""
    masks = deep_masks(*size)
    min_size = int(masks[1].sum()) - 5
    got = mo.clean_binary_stack(masks.to(card), min_size=min_size)
    assert torch.equal(got.cpu(), scipy_clean(masks, min_size))
    assert rounds_needed(masks[1:], 1) > 2 * sum(size)


# the SAM segmentor on the card (no kernel of this repository: library
# convolutions and matrix products), vit_t at its full 1024 width with
# seeded random weights. Float32 with TF32 off against the CPU: max-abs
# logit difference under SAM_F32_REL of the logits' range, argmax labels
# at least SAM_F32_AGREE equal; bfloat16 against float32 on the card: at
# least SAM_BF16_AGREE of the labels
SAM_F32_REL, SAM_F32_AGREE, SAM_BF16_AGREE = 5e-4, 0.998, 0.97


@pytest.fixture(scope="module")
def sam_frames():
    from tee_optical_flow_torch.synthetic import make_echo_pair

    i0, i1 = make_echo_pair(3, 480, 640)
    return np.stack([i0, i1]).round().clip(0, 255).astype(np.uint8)


def _sam_logits(model, frames, device):
    from tee_optical_flow_torch.models.sam import preprocess_frames

    with torch.no_grad():
        x = preprocess_frames(torch.from_numpy(frames).to(device),
                              model.image_size)
        return model(x)[0].float().cpu()


def test_sam_vit_t_card_matches_cpu(card, sam_frames):
    from tee_optical_flow_torch.models.registry import build_sam_vit_t

    cpu = build_sam_vit_t(num_classes=3, seed=0, device="cpu")
    gpu = build_sam_vit_t(num_classes=3, seed=0, device=card)
    ref = _sam_logits(cpu, sam_frames, "cpu")
    got = _sam_logits(gpu, sam_frames, card)
    assert got.shape == ref.shape == (2, 3, 256, 256)
    rel = float((got - ref).abs().max() / (ref.max() - ref.min()))
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    assert rel < SAM_F32_REL and agree >= SAM_F32_AGREE, (rel, agree)
    bf16 = build_sam_vit_t(num_classes=3, seed=0, dtype=torch.bfloat16,
                           device=card)
    low = _sam_logits(bf16, sam_frames, card)
    assert float((low.argmax(1) == got.argmax(1)).float().mean()) \
        >= SAM_BF16_AGREE


def test_sam_segmentor_routes_on_card(card, sam_frames):
    """make_clip_segmentor on the card: the host route, labels_device on
    an RGB and on a single-channel device clip give the same labels; a
    clip of three frames at micro-batch 2 (the shifted tail)."""
    from tee_optical_flow_torch.models.registry import build_sam_vit_t
    from tee_optical_flow_torch.models.sam import make_clip_segmentor

    seg = make_clip_segmentor(build_sam_vit_t(
        num_classes=3, seed=0, dtype=torch.bfloat16, device=card),
        micro_batch=2)
    gray = np.concatenate([sam_frames, sam_frames[:1]])
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    host = seg(rgb)
    assert host.shape == (3, 480, 640) and host.dtype == np.uint8
    assert host.max() <= 2
    for clip in (rgb, gray):
        dev = seg.labels_device(torch.from_numpy(clip).to(card), (480, 640))
        assert dev.is_cuda
        np.testing.assert_array_equal(dev.cpu().numpy(), host)


# --- the cohort analysis's device passes (plain PyTorch, no kernel) -------

def _cohort_inputs(shape=(6, 120, 160), seed=0):
    """Masked unit-scale flow (frame 1 empty) and an AV-like mask stack."""
    rng = np.random.default_rng(seed)
    n, h, w = shape
    flow = rng.normal(scale=2.0, size=(n, h, w, 2)).astype(np.float32)
    keep = rng.uniform(size=(n, h, w)) < 0.6
    keep[1] = False
    yy, xx = np.mgrid[0:h, 0:w]
    av = np.stack([np.hypot(yy - h / 2 - k, xx - w / 2) < 12 + k
                   for k in range(n)])
    av[2, :10, :10] = True  # a second, smaller component
    return flow * keep[..., None], av


def test_cohort_passes_card_match_cpu(card):
    """The histogram pack (bit-equal: whole-number counts, IEEE division,
    the fused interpolation rounded once in float64), the magnitude and
    the radial / longitudinal components (bit-equal), the AV centroids
    (bit-equal: whole-number sums under 2**24) and WASE (float32 sums in
    another order: 1e-6 px) on the card against the same calls on the
    CPU."""
    from tee_optical_flow_torch.analysis.components import (
        calculate_comp_magnitude,
    )
    from tee_optical_flow_torch.analysis.histograms import cart_to_polar
    from tee_optical_flow_torch.flow.pipeline import wase_background
    from tee_optical_flow_torch.ops.histogram import (
        framewise_hist_pack_group,
    )
    from tee_optical_flow_torch.ops.morphology import largest_centroid_series

    flow, av = _cohort_inputs()
    cpu = torch.from_numpy(flow)
    gpu = cpu.to(card)
    for a, b in zip(cart_to_polar(gpu)[:1], cart_to_polar(cpu)[:1]):
        assert torch.equal(a.cpu(), b)
    cents = np.array([[60.3, 80.7]] * flow.shape[0])
    for a, b in zip(calculate_comp_magnitude(gpu, cents),
                    calculate_comp_magnitude(cpu, cents)):
        assert torch.equal(a.cpu(), b)
    p = torch.tensor([[1.0, 99.0], [5.0, 50.0]])
    group = torch.stack([cpu[..., 0], cpu[..., 1]])
    # an empty frame's percentiles are NaN on both (inf * 0)
    torch.testing.assert_close(
        framewise_hist_pack_group(group.to(card), p, nbins=1000).cpu(),
        framewise_hist_pack_group(group, p, nbins=1000), rtol=0, atol=0,
        equal_nan=True)
    for a, b in zip(largest_centroid_series(torch.from_numpy(av).to(card)),
                    largest_centroid_series(torch.from_numpy(av))):
        assert torch.equal(a.cpu(), b)
    bkgd = torch.from_numpy(~av)
    got = wase_background(gpu[:-1], bkgd.to(card)).cpu()
    assert float((got - wase_background(cpu[:-1], bkgd)).abs().max()) <= 1e-6


def test_radlong_overlay_frames_card_match_cpu(card):
    """The overlay video's frames (echo normalisation, the centred norm
    with its float64 steps, the bwr / BrBG table gather and the 50/50
    blend) on the card, bit-equal to the same call on the CPU."""
    from tee_optical_flow_torch.viz.manager import radlong_overlay_frames

    rng = np.random.default_rng(3)
    echo = rng.uniform(size=(6, 120, 160)).astype(np.float16)
    rad = rng.normal(scale=2.0, size=(5, 120, 160)).astype(np.float32)
    lng = rng.normal(scale=0.5, size=(5, 120, 160)).astype(np.float32)
    rad[:, :10] = 0.0
    got = radlong_overlay_frames(echo[:5], rad, lng, 5, device=card)
    ref = radlong_overlay_frames(echo[:5], rad, lng, 5, device="cpu")
    assert got.device.type == "cuda" and got.shape == (5, 120, 320, 3)
    assert torch.equal(got.cpu(), ref)


# --- SAM fine-tuning (plain PyTorch: no kernel of this repository) --------
# one vanilla train step of vit_t at its full 1024 width, batch 1, strict
# float32, card against CPU: the loss within TRAIN_LOSS_REL relative,
# each gradient within TRAIN_GRAD_REL of its tensor's max-abs; a gradient
# that is zero in exact arithmetic (attention k-projection biases, biases
# before a batch norm) is float32 noise on both sides and must stay under
# TRAIN_GRAD_NOISE x the largest
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_NOISE = 1e-4, 1e-3, 1e-6


def test_train_step_card_matches_cpu(card):
    from tee_optical_flow_torch.config import TrainConfig
    from tee_optical_flow_torch.models.registry import build_sam_vit_t
    from tee_optical_flow_torch.train import loop

    rng = np.random.default_rng(0)
    images = rng.normal(size=(1, 1024, 1024, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:256, 0:256]
    labels = (((yy - 128) ** 2 + (xx - 100) ** 2 < 2500).astype(np.int32)
              + 2 * (xx > 200))[None].astype(np.int32)
    out = {}
    for dev in ("cpu", card):
        model = build_sam_vit_t(num_classes=3, seed=2, device=dev)
        rt = loop.build_runtime(TrainConfig(num_cls=3, weight_decay=0.1),
                                1, device=dev)
        init, step = loop.make_train_step(model, rt)
        metrics, grads = step.loss_and_grads(init(), images, labels)
        out[str(dev)] = (float(metrics["total_loss"]),
                         {k: v.cpu() for k, v in grads.items()})
    (loss_c, ref), (loss_g, got) = out["cpu"], out[str(card)]
    assert abs(loss_g - loss_c) <= TRAIN_LOSS_REL * abs(loss_c)
    assert sorted(ref) == sorted(got)
    gmax = max(float(v.abs().max()) for v in ref.values())
    for name, r in ref.items():
        scale = float(r.abs().max())
        if scale < TRAIN_GRAD_NOISE * gmax:
            assert float(got[name].abs().max()) < TRAIN_GRAD_NOISE * gmax
        else:
            assert float((got[name] - r).abs().max()) <= \
                TRAIN_GRAD_REL * scale, name


# vit_b (ViT-Det at its full 768 width, 12 blocks) at a small image (256:
# a 16x16 token grid, windows of 14 padded to 28) with seeded random
# weights: float32 on the card with TF32 off against the CPU (logits within
# SAM_F32_REL of their range, labels at least SAM_F32_AGREE equal), and
# the int8 segmentor's logits against the bfloat16 model's on the card
# within INT8_REL of their largest magnitude (the JAX package's bound,
# tests/test_models.py)
INT8_REL = 0.15


def test_sam_vit_b_card_matches_cpu(card):
    from tee_optical_flow_torch.models.registry import build_sam_vit_b
    from tee_optical_flow_torch.models.sam import (
        make_clip_segmentor, preprocess_frames,
    )

    frames = (np.random.default_rng(1).uniform(size=(2, 96, 128, 3)) * 255
              ).astype(np.uint8)
    kw = dict(num_classes=3, image_size=256, seed=0)
    cpu = build_sam_vit_b(device="cpu", **kw)
    gpu = build_sam_vit_b(device=card, **kw)
    ref = _sam_logits(cpu, frames, "cpu")
    got = _sam_logits(gpu, frames, card)
    assert got.shape == ref.shape == (2, 3, 64, 64)
    rel = float((got - ref).abs().max() / (ref.max() - ref.min()))
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    assert rel < SAM_F32_REL and agree >= SAM_F32_AGREE, (rel, agree)
    bf16 = build_sam_vit_b(device=card, dtype=torch.bfloat16, **kw)
    low = _sam_logits(bf16, frames, card)
    q8 = make_clip_segmentor(bf16, weights_int8=True)
    with torch.no_grad():
        x = preprocess_frames(torch.from_numpy(frames).to(card), 256)
        got8 = q8.forward(x)[0].float().cpu()
    assert float((got8 - low).abs().max()) <= INT8_REL * float(
        low.abs().max())


@pytest.fixture
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards (the shards of a mesh on "
                    "distinct devices)")
    return [torch.device("cuda", i) for i in range(2)]


def test_sharded_flow_runs_each_shard_on_its_card(two_cards, monkeypatch):
    """compute_clip_flow_sharded over [cuda:0, cuda:1]: each shard's pairs
    lie on its card and its solve runs with that card current (the CUDA
    kernels' launches and K1's cooperative grid read it); the gathered
    flow lies on cuda:0 and is bit-equal to the unsharded solve there."""
    from tee_optical_flow_torch.config import default_optical_flow_config
    from tee_optical_flow_torch.flow import pipeline as tp
    from tee_optical_flow_torch.parallel import make_mesh

    solve = tp.tvl1_flow_pairs
    seen = []

    def spy(a, b, **kw):
        seen.append((a.device, b.device, torch.cuda.current_device()))
        return solve(a, b, **kw)

    monkeypatch.setattr(tp, "tvl1_flow_pairs", spy)
    rng = np.random.default_rng(3)
    frames = (rng.uniform(size=(6, 64, 96)) * 255).astype(np.float32)
    cfg = default_optical_flow_config()
    got = tp.compute_clip_flow_sharded(frames, make_mesh(devices=two_cards),
                                       "TVL1", cfg)
    assert seen == [(d, d, d.index) for d in two_cards]
    seen.clear()
    ref = tp.compute_clip_flow(frames, "TVL1", cfg, device=two_cards[0])
    assert got.device == two_cards[0] and torch.equal(got, ref)


def test_sharded_segmentor_on_two_cards(two_cards):
    """vit_t at 256 in float32 on [cuda:0, cuda:1]: one replica per card
    (twice the resident bytes), labels at least SAM_F32_AGREE equal to
    the single-card segmentor's."""
    from tee_optical_flow_torch.models import (
        build_sam_vit_t, make_clip_segmentor,
    )
    from tee_optical_flow_torch.parallel import make_mesh

    model = build_sam_vit_t(num_classes=3, image_size=256, seed=0,
                            device=two_cards[0])
    single = make_clip_segmentor(model)
    sharded = make_clip_segmentor(model, mesh=make_mesh(devices=two_cards))
    assert sharded.resident_weight_bytes == 2 * single.resident_weight_bytes
    clip = (np.random.default_rng(4).uniform(size=(6, 96, 128, 3)) * 255
            ).astype(np.uint8)
    agree = float((single(clip) == sharded(clip)).mean())
    assert agree >= SAM_F32_AGREE, agree


def test_resize_is_batch_invariant_on_card(card):
    """An image's resize does not depend on the images beside it or on
    its place in the batch (products over fixed groups on a card): the
    30x40 -> 60x80 cubic resize of the DeepFlow path's coarsest level
    differed by 3e-5 between a 16- and a 32-image batch when the batch
    went through one product."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(39, 30, 40)).astype(np.float32)).to(card)
    for resize in (tw.resize_cubic, tw.resize_bilinear):
        whole = resize(x, 60, 80)
        for lo, hi in ((0, 16), (3, 20), (5, 6), (20, 39)):
            assert torch.equal(whole[lo:hi], resize(x[lo:hi], 60, 80)), \
                (lo, hi)
