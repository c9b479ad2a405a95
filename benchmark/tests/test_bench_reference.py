"""Each plain reference against the program on the CPU at small sizes."""

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.reference import masks as ref_masks
from benchmark.reference import tvl1 as ref_tvl1

FLOW = harness.load_json("configs", "otsu-tvl1")["flow"]


def frames(seed=4, n=5, h=48, w=64):
    return inputs.echo_clips(seed, 1, n, h, w, amplitudes=[0.05],
                             period=16, device="cpu")[0]


def test_tvl1_equals_the_program_bit_for_bit():
    from tee_optical_flow_torch.config import OpticalFlowCalculationConfig
    from tee_optical_flow_torch.flow.pipeline import compute_clip_flow
    from tee_optical_flow_torch.ops.imaging import img2uint8

    gray = frames(h=40, w=56).float() / 255.0
    cfg = OpticalFlowCalculationConfig.from_dict(FLOW)
    got = compute_clip_flow(img2uint8(gray), "TVL1", cfg, device="cpu")
    work = ref_tvl1.Work()
    ref = ref_tvl1.clip_flow(ref_tvl1.img2uint8(gray), FLOW, work=work)
    assert torch.equal(got, ref)
    # one call per level and warp; the stop let fewer steps run than all
    levels = len(ref_tvl1.pyramid_shapes(64, 64, 5, 0.8))
    assert len(work.calls) == levels * FLOW["tvl1_warps"]
    for b, h, w, steps, medians, checks in work.calls:
        assert b == 4 and 0 < steps <= b * 300 and 0 < medians <= b * 10
        assert checks == steps


def test_tvl1_counts_every_step_without_the_stop():
    gray = frames(n=3, h=32, w=32).float() / 255.0
    flow = dict(FLOW, tvl1_epsilon=0.0, tvl1_nscales=1, tvl1_warps=1)
    work = ref_tvl1.Work()
    ref_tvl1.clip_flow(ref_tvl1.img2uint8(gray), flow, work=work)
    assert work.calls == [(2, 32, 32, 2 * 300, 2 * 10, 0)]


def test_block_rule_equals_the_program():
    from tee_optical_flow_torch.ops.tvl1_kernels import tvl1_block_loop_plain

    g = torch.Generator().manual_seed(0)
    args = [torch.randn(2, 24, 32, generator=g) for _ in range(10)]
    args[3] = args[3].abs()
    kw = dict(outer_iters=4, inner_iters=5, use_median=True, l_t=0.045,
              theta=0.3, taut=0.25 / 0.3, epsilon=0.05)
    got = tvl1_block_loop_plain(*args, **kw)
    th = 0.045 * args[3]
    inv = torch.where(args[3] > 1e-10, 1.0 / torch.clamp_min(args[3], 1e-10),
                      torch.zeros_like(args[3]))
    work = ref_tvl1.Work()
    ref = ref_tvl1._block_loop(
        (args[0], args[1], args[2], th, inv), list(args[4:]),
        outer_iters=4, inner_iters=5, use_median=True, epsilon=0.05,
        kw=dict(l_t=0.045, theta=0.3, taut=0.25 / 0.3), work=work)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # per block, each active pair: 5 steps, a median, a stop check
    (b, h, w, steps, medians, checks), = work.calls
    assert (b, h, w) == (2, 24, 32)
    assert steps == 5 * medians and medians == checks and 2 <= checks <= 8


def test_otsu_masks_equal_the_program():
    from tee_optical_flow_torch.config import OpticalFlowCalculationConfig
    from tee_optical_flow_torch.flow.segment import predict_movie_thres

    # small objects at this size are a few dozen pixels
    flow = dict(FLOW, min_mask_size=40)
    f = frames(n=6)
    got = predict_movie_thres(
        f.numpy(), _gray_dev=f.float() / 255.0, device="cpu",
        config=OpticalFlowCalculationConfig.from_dict(flow))["otsu"][..., 0]
    ref = ref_masks.otsu_masks(f.float() / 255.0, flow)["otsu"]
    assert np.array_equal(got, ref.numpy())
    assert 0 < ref.sum() < ref.numel()


def test_labelling_runs_to_convergence():
    # a serpentine whose geodesic length (about 300 px) is far above the
    # 2 (H + W) = 96 rounds of a fixed propagation is one component
    h = w = 24
    m = torch.zeros(1, h, w, dtype=torch.bool)
    m[0, ::2, :] = True
    m[0, 1::4, -1] = True
    m[0, 3::4, 0] = True
    ids = ref_masks.label(m, 1)
    assert torch.unique(ids[m]).numel() == 1

