"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a CUDA device every test skips, decided
inside the ``card`` fixture so that every worker collects the same tests.

On the machine with the card (which has no JAX, so the repo's conftest
cannot load there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: the kernels compute each step in the plain version's
operation order with separately rounded operations (built with
--fmad=false), so K2, K1 at epsilon=0 and the median are bit-equal. At
epsilon > 0 the per-pair error is summed in another order than
torch.sum, so a pair may stop one step apart: 0.05 px max-abs.
"""

import numpy as np
import pytest
import torch

from tee_optical_flow_torch.ops import tvl1_kernels as tk
from tee_optical_flow_torch.ops import warp as tw

pytestmark = pytest.mark.cuda

SHAPES = {"small": (2, 40, 48), "full": (4, 480, 640)}
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


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("size", ["small", "full"])
def test_median_bit_equal(card, size):
    f = _level(SHAPES[size], card)[4]
    f[:, 3:9, 3:9] = 0.5  # ties
    before = tw.median_filter_5x5.launches
    got = tw.median_filter_5x5(f)
    assert tw.median_filter_5x5.launches == before + 1
    assert torch.equal(got, tw.median_filter_5x5_plain(f))
    err = torch.tensor([1.0] + [0.0] * (f.shape[0] - 1), device=card)
    gated = tw.median_filter_5x5(f, err=err, thresh=0.5)
    assert torch.equal(gated,
                       tw.median_filter_5x5_plain(f, err=err, thresh=0.5))
    torch.cuda.synchronize()


@pytest.mark.parametrize("size", ["small", "full"])
def test_inner_block_bit_equal(card, size):
    args = _level(SHAPES[size], card)
    before = tk.tvl1_inner_block.launches
    got = tk.tvl1_inner_block(*args, n_iters=30, **KW)
    assert tk.tvl1_inner_block.launches == before + 1
    ref = tk.tvl1_inner_block_plain(*args, n_iters=30, **KW)
    assert _max_abs(got, ref) == 0.0
    # inputs untouched, as the JAX function leaves them
    assert torch.equal(args[4], _level(SHAPES[size], card)[4])


@pytest.mark.parametrize("epsilon", [0.0, 0.01, 2.0])
@pytest.mark.parametrize("size", ["small", "full"])
def test_outer_loop_matches_plain(card, size, epsilon):
    args = _level(SHAPES[size], card)
    kw = dict(outer_iters=10, inner_iters=30, use_median=True,
              epsilon=epsilon, **KW)
    before = tk.tvl1_outer_loop.launches
    got = tk.tvl1_outer_loop(*args, **kw)
    assert tk.tvl1_outer_loop.launches == before + 1
    ref = tk.tvl1_outer_loop_plain(*args, **kw)
    err = _max_abs(got, ref)
    assert err <= (0.0 if epsilon == 0.0 else 0.05), err


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
