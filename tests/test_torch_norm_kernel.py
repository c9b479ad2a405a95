"""ViT-Det's residual pass kernel (csrc/layer_norm.cu, ops/norm_kernels.py)
and the choice between it and the plain sequence
(models/image_encoder.Block).

On the CPU: the kernel path of a block, run with the plain version
(``residual_norm_plain``) in the wrapper's place, is bit-equal to
``Block.forward``'s plain sequence (shortcut + branch, ``layer_norm``, the
cast, ``window_partition`` / ``window_unpartition``) at vit_b's, vit_l's
and vit_h's widths, on a 20x20 grid with windows of 7 (padded to 21x21)
and in a global block; the kernel's own arithmetic written out
(``emulate``: a warp's lanes, their sums in the source's order, the xor
butterfly) against the plain version; which calls take the kernel; the
operators' fakes under ``torch.export``.

On the card (marked ``cuda``; skipped without one, decided inside the
``card`` fixture): the kernel bit-equal to ``emulate`` and against the
plain version at vit_h's and vit_b's (4, 64, 64, C) windowed and global
shapes, a whole bfloat16 vit_b encoder with and without it, and the
block's dispatch. This file imports no JAX; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_norm_kernel.py -q -s

Accuracy. The residual add is one float32 add in both versions: bit-equal.
The norm differs from the plain version only in the order of the two row
sums (and, on a card, torch's mean multiplies by 1/C and its rsqrt is
within an ulp of 1/sqrt; the kernel divides and takes 1/sqrt). With the
fast variance E[x^2] - mu^2 the sums' rounding grows with mu^2 / var, so
on this file's rows (means up to about 4 standard deviations) the float32
normed values differ by 1.5e-5 to 4.9e-5 at most (CPU, at the CPU tests'
and the card tests' shapes): held to F32_ATOL. After the bfloat16 cast
at least BF16_EQUAL of the elements are equal (99.983-99.990% on the CPU
at those shapes), and the others one bfloat16 step apart, a step counted
at the larger magnitude or at STEP_FLOOR where both are smaller: below
2^-6 a bfloat16 step (2^-13 and finer) is finer than the float32
difference the two sum orders make, so two values near zero can round
many steps apart while lying within that difference of each other.
"""

import copy
import math
import types

import pytest
import torch

from tee_optical_flow_torch.core import sqrt32
from tee_optical_flow_torch.models import image_encoder as ie
from tee_optical_flow_torch.models.common import layer_norm
from tee_optical_flow_torch.models.tinyvit import window_partition
from tee_optical_flow_torch.ops import norm_kernels as nk
from tee_optical_flow_torch.utils.tracing import get_counters

F32_ATOL = 1e-4
BF16_EQUAL = 0.999
STEP_FLOOR = 2.0 ** -6
# the card test of a whole encoder: the fused encoder's error against the
# float32 one at most this many times the plain bfloat16 encoder's, max and
# mean (tests/test_torch_attention.py's bound)
ERR_RATIO = 1.25
# vit_b/l/h: width -> heads
HEADS = {768: 12, 1024: 16, 1280: 16}


def _stream(b, h, w, c, seed=0):
    """A float32 residual stream (b, h, w, c) whose rows have means up to
    about 4 standard deviations, and a norm's weight and bias drawn about
    1 and 0."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, h, w, c), generator=g)
         + 2.0 * torch.randn((b, h, w, 1), generator=g)) \
        * (0.5 + torch.rand((b, h, w, 1), generator=g))
    norm = torch.nn.LayerNorm(c, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g))
    return x, norm


def _branch(b, h, w, c, window, seed=1):
    """A bfloat16 attention output in the block's layout for ``window``."""
    g = torch.Generator().manual_seed(seed)
    return (0.5 * torch.randn(nk.layout(b, h, w, c, window), generator=g)
            ).to(torch.bfloat16)


def _rows(v, weight, bias, eps):
    """The kernel's norm of the float32 rows ``v`` (R, C): lane l of a warp
    holds columns 8 (l + 32 j) + k and sums them, and apart their squares,
    in the order (j, k); the 32 lane sums meet in the xor butterfly
    (16, 8, 4, 2, 1); mean and E[x^2] divide by C, 1 / sqrt of var + eps
    correctly rounded; then layer_norm's affine, all in float32."""
    r, c = v.shape
    lanes = v.reshape(r, c // 256, 32, 8).permute(0, 2, 1, 3) \
        .reshape(r, 32, c // 32)
    s1 = torch.zeros(r, 32)
    s2 = torch.zeros(r, 32)
    for i in range(c // 32):
        s1 = s1 + lanes[:, :, i]
    for i in range(c // 32):
        s2 = s2 + lanes[:, :, i] * lanes[:, :, i]
    while s1.shape[1] > 1:
        half = s1.shape[1] // 2
        s1 = s1[:, :half] + s1[:, half:]
        s2 = s2[:, :half] + s2[:, half:]
    mu = s1 / c
    var = torch.clamp(s2 / c - mu * mu, min=0.0)
    rstd = 1.0 / sqrt32(var + eps)
    return (v - mu) * (rstd * weight) + bias


def emulate(x, norm, window, branch=None):
    """The kernel's arithmetic in PyTorch, on the CPU, with
    ``residual_norm``'s interface and layouts: the bits the kernel gives."""
    norm = copy.deepcopy(norm).cpu()
    x, weight, bias = (t.detach().cpu() for t in (x, norm.weight, norm.bias))
    c = x.shape[-1]
    if branch is not None:
        x = ie.residual_norm_plain(x, norm, window, branch.cpu())[0]
    normed = _rows(x.reshape(-1, c), weight, bias, norm.eps).reshape(x.shape)
    if branch is None and window > 0:
        normed = window_partition(normed, window)[0].reshape(
            -1, window, window, c)
    normed = normed.to(torch.bfloat16)
    return normed if branch is None else (x, normed)


def _ordered(t):
    """bfloat16 values as integers in the values' order (+0 and -0 both
    0), so that neighbours differ by 1."""
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _bf16_agreement(got, ref):
    """(share of equal elements, largest distance in bfloat16 steps, each
    counted at the larger magnitude or at STEP_FLOOR)."""
    got, ref = got.detach().cpu(), ref.detach().cpu()
    equal = float((got == ref).float().mean())
    top = torch.maximum(got.float().abs(), ref.float().abs())
    step = torch.exp2(torch.floor(torch.log2(torch.clamp(top, min=STEP_FLOOR)))
                      - 7)
    steps = (got.float() - ref.float()).abs() / step
    near = top < STEP_FLOOR
    steps = torch.where(near, steps, (_ordered(got) - _ordered(ref)).abs()
                        .float())
    return equal, float(steps.max())


# --- on the CPU ----------------------------------------------------------

def _block(c, window, dtype=torch.bfloat16, seed=0):
    """A ViT-Det block of width ``c`` on a 20x20 grid (windows of
    ``window``, 0 global) with seeded random weights, its norms drawn about
    1 and 0 and its position tables nonzero."""
    g = torch.Generator().manual_seed(seed)
    blk = ie.Block(c, HEADS[c], window_size=window, input_size=(20, 20),
                   dtype=dtype)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name:
                p.copy_((name.endswith("weight") + 0.2
                         * torch.randn(p.shape, generator=g)))
            elif "rel_pos" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return blk


@pytest.mark.parametrize("window", [7, 0])
@pytest.mark.parametrize("c", [768, 1024, 1280])
def test_kernel_path_with_the_plain_version_is_the_plain_block(
        monkeypatch, c, window):
    """Block._forward_kernel, with residual_norm_plain in the wrapper's
    place, gives the bits of Block.forward's plain sequence: the plain
    version is the block's own arithmetic and layouts (the pad of a 20x20
    grid in windows of 7 included)."""
    blk = _block(c, window)
    x = _stream(2, 20, 20, c)[0]
    calls = []

    def plain(x, weight, bias, eps, window, branch=None):
        norm = blk.norm1 if branch is None else blk.norm2
        assert weight is norm.weight and bias is norm.bias
        assert eps == norm.eps
        calls.append(None if branch is None else tuple(branch.shape))
        return ie.residual_norm_plain(x, norm, window, branch)

    with torch.no_grad():
        ref = blk(x)
        monkeypatch.setattr(nk, "residual_norm", plain)
        monkeypatch.setattr(ie.Block, "takes_kernel", lambda self, x: True)
        got = blk(x)
    assert calls == [None, nk.layout(2, 20, 20, c, window)]
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("window", [7, 0])
@pytest.mark.parametrize("c", [768, 1024, 1280])
def test_kernel_arithmetic_against_the_plain_version(c, window):
    """``emulate`` (the kernel's lanes, sum order and butterfly) against
    the plain version at both entry points: the residual bit-equal, the
    float32 norm within F32_ATOL of layer_norm's, the bfloat16 tokens at
    least BF16_EQUAL equal and never more than a step apart, the window
    pad zero."""
    x, norm = _stream(2, 20, 20, c)
    branch = _branch(2, 20, 20, c, window)
    with torch.no_grad():
        got1 = emulate(x, norm, window)
        ref1 = ie.residual_norm_plain(x, norm, window)
        got_x, got2 = emulate(x, norm, window, branch)
        ref_x, ref2 = ie.residual_norm_plain(x, norm, window, branch)
        f32 = _rows(x.reshape(-1, c), norm.weight, norm.bias, norm.eps)
        gap = float((f32 - layer_norm(x, norm).reshape(-1, c)).abs().max())
    assert gap <= F32_ATOL, gap
    assert torch.equal(got_x, ref_x)
    for got, ref in ((got1, ref1), (got2, ref2)):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        equal, steps = _bf16_agreement(got, ref)
        assert equal >= BF16_EQUAL and steps <= 1, (equal, steps)
    if window:
        pad = torch.ones(2, 21, 21, dtype=torch.bool)
        pad[:, :20, :20] = False
        pad = window_partition(pad[..., None], window)[0].reshape(-1)
        assert not got1.reshape(-1, c)[pad].any()


# (block type, adapter, thd, gradients on, parameters trainable, x needs
# grad, tensor on a card) -> takes the kernel
TAKES_KERNEL = {
    "bf16 no_grad": ((torch.bfloat16, False, False, False, True, False,
                      True), True),
    "bf16 grad, frozen": ((torch.bfloat16, False, False, True, False,
                           False, True), True),
    "bf16 grad": ((torch.bfloat16, False, False, True, True, False, True),
                  False),
    "bf16 grad, x grad": ((torch.bfloat16, False, False, True, False, True,
                           True), False),
    "float32 no_grad": ((torch.float32, False, False, False, True, False,
                         True), False),
    "bf16 adapter": ((torch.bfloat16, True, False, False, True, False,
                      True), False),
    "bf16 thd": ((torch.bfloat16, False, True, False, True, False, True),
                 False),
    "cpu bf16 no_grad": ((torch.bfloat16, False, False, False, True, False,
                          False), False),
}


@pytest.mark.parametrize("case", list(TAKES_KERNEL))
def test_the_kernel_is_taken_where_the_input_allows(case):
    """Block.takes_kernel: a card tensor, a bfloat16 block, no adapter, no
    depth branch and no gradient to record take the kernel; a float32
    block, an adapter or depth block, a call that records gradients and a
    CPU tensor take the plain sequence."""
    (dtype, adapter, thd, grad, trainable, x_grad, on_card), expected = \
        TAKES_KERNEL[case]
    blk = ie.Block(32, 2, window_size=3, use_adapter=adapter, thd=thd,
                   chunk=4, dtype=dtype).requires_grad_(trainable)
    x = (types.SimpleNamespace(device=torch.device("cuda"),
                               requires_grad=x_grad) if on_card
         else torch.zeros(1, 4, 4, 32))
    with torch.set_grad_enabled(grad):
        assert blk.takes_kernel(x) is expected


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel's wrapper was called")


def test_vitdet_encoder_on_the_cpu_never_calls_the_kernel(monkeypatch):
    """A small bfloat16 ViT-Det encoder (windowed and global blocks) under
    no_grad on the CPU runs without the wrapper."""
    monkeypatch.setattr(nk, "residual_norm", _refuse)
    enc = ie.ImageEncoderViT(img_size=64, embed_dim=32, depth=2, num_heads=2,
                             out_chans=16, window_size=3,
                             global_attn_indexes=(1,), dtype=torch.bfloat16)
    with torch.no_grad():
        out = enc(torch.randn(2, 3, 64, 64))
    assert out.shape == (2, 16, 4, 4) and torch.isfinite(out).all()


def test_a_cpu_tensor_given_to_the_wrapper_raises():
    """The wrapper does not fall back: a tensor off the card raises."""
    x, norm = _stream(1, 4, 4, 768)
    with pytest.raises(ValueError, match="on a card"):
        nk.residual_norm(x, norm.weight, norm.bias, norm.eps, 3)


@pytest.mark.parametrize("window", [3, 0])
def test_the_operators_export(window):
    """torch.export of a module that calls the wrapper at both entry points
    records both operators (tracing runs only the fakes), with the outputs'
    layouts and types."""

    class Pass(torch.nn.Module):
        def forward(self, x, weight, bias, branch):
            normed = nk.residual_norm(x, weight, bias, 1e-6, window)
            x2, normed2 = nk.residual_norm(x, weight, bias, 1e-6, window,
                                           branch=branch)
            return normed, x2, normed2

    x = torch.zeros(2, 4, 5, 768)
    args = (x, torch.ones(768), torch.zeros(768),
            torch.zeros(nk.layout(2, 4, 5, 768, window),
                        dtype=torch.bfloat16))
    program = torch.export.export(Pass(), args)
    targets = [str(node.target) for node in program.graph.nodes]
    assert "tee_optical_flow.layer_norm_cast.default" in targets, targets
    assert "tee_optical_flow.add_layer_norm_cast.default" in targets
    outs = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    metas = [o.meta["val"] for o in outs]
    assert [tuple(m.shape) for m in metas] == [
        nk.layout(2, 4, 5, 768, window), (2, 4, 5, 768), (2, 4, 5, 768)]
    assert [m.dtype for m in metas] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16]


# --- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, H, W, C, window): vit_h's and vit_b's micro-batch of 4 frames, 64x64
# tokens, in a windowed block (windows of 14, padded to 70x70) and a
# global one
CARD_SHAPES = {"vit_h_window": (4, 64, 64, 1280, 14),
               "vit_h_global": (4, 64, 64, 1280, 0),
               "vit_b_window": (4, 64, 64, 768, 14),
               "vit_b_global": (4, 64, 64, 768, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_kernel_matches_the_plain_version(card, name):
    """Both entry points: the kernel's bits are ``emulate``'s; against the
    plain version on the card, the residual bit-equal and the bfloat16
    tokens at least BF16_EQUAL equal, never more than a step apart (the
    shares are printed)."""
    b, h, w, c, window = CARD_SHAPES[name]
    x, norm = _stream(b, h, w, c)
    branch = _branch(b, h, w, c, window)
    x, branch, norm = x.to(card), branch.to(card), norm.to(card)
    with torch.no_grad():
        got1 = nk.residual_norm(x, norm.weight, norm.bias, norm.eps, window)
        got_x, got2 = nk.residual_norm(x, norm.weight, norm.bias, norm.eps,
                                       window, branch=branch)
        ref1 = ie.residual_norm_plain(x, norm, window)
        ref_x, ref2 = ie.residual_norm_plain(x, norm, window, branch)
        emu1 = emulate(x, norm, window)
        emu_x, emu2 = emulate(x, norm, window, branch)
    torch.cuda.synchronize()
    assert torch.equal(got1.cpu(), emu1) and torch.equal(got2.cpu(), emu2)
    assert torch.equal(got_x, ref_x) and torch.equal(got_x.cpu(), emu_x)
    for entry, got, ref in (("LN1", got1, ref1), ("add+LN2", got2, ref2)):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        equal, steps = _bf16_agreement(got, ref)
        print(f"{name} {entry}: {equal:.6%} equal to the plain version, "
              f"at most {steps:g} step apart")
        assert equal >= BF16_EQUAL and steps <= 1, (equal, steps)


def _vit_b_encoder(dtype, device, seed=0):
    """vit_b's encoder at 1024 (64x64 tokens: windows of 14 padded to
    70x70, global blocks 2, 5, 8, 11) with seeded weights: dense and conv
    weights at 1/sqrt(fan-in), biases and the position embedding at 0.1,
    norms about 1 and 0, position tables at 2 / sqrt(hd)."""
    g = torch.Generator().manual_seed(seed)
    enc = ie.ImageEncoderViT(img_size=1024, embed_dim=768, depth=12,
                             num_heads=12, global_attn_indexes=(2, 5, 8, 11),
                             window_size=14, dtype=dtype)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if "norm" in name or "neck.1" in name or "neck.3" in name:
                p.copy_(name.endswith("weight") + 0.2 * noise)
            elif "rel_pos" in name:
                p.copy_(noise * 2.0 / math.sqrt(64))
            elif p.ndim == 1 or name == "pos_embed":
                p.copy_(noise * 0.1)
            else:
                p.copy_(noise / math.sqrt(p[0].numel()))
    return enc.to(device)


@pytest.mark.cuda
def test_vit_b_encoder_with_the_kernel_against_the_plain_blocks(
        card, monkeypatch):
    """A bfloat16 vit_b encoder on the card (attention kernel in both),
    its blocks fused and plain, each against the float32 encoder: the
    fused error at most ERR_RATIO times the plain one, max and mean; 24
    launches of the kernel (two a block)."""
    images = torch.randn((1, 3, 1024, 1024),
                         generator=torch.Generator().manual_seed(3)).to(card)
    with torch.no_grad():
        ref = _vit_b_encoder(torch.float32, card)(images).double()
        enc = _vit_b_encoder(torch.bfloat16, card)
        before = get_counters().get("launches.residual_norm", 0)
        fused = enc(images).double()
        launches = get_counters()["launches.residual_norm"] - before
        monkeypatch.setattr(ie.Block, "takes_kernel", lambda self, x: False)
        plain = enc(images).double()
    assert launches == 24
    err = ((fused - ref).abs().max(), (fused - ref).abs().mean())
    base = ((plain - ref).abs().max(), (plain - ref).abs().mean())
    print(f"vit_b encoder: fused max/mean {float(err[0]):.4g} "
          f"{float(err[1]):.4g}, plain {float(base[0]):.4g} "
          f"{float(base[1]):.4g}")
    assert err[0] <= ERR_RATIO * base[0] and err[1] <= ERR_RATIO * base[1]


@pytest.mark.cuda
def test_block_dispatch_on_the_card(card):
    """A bfloat16 block under no_grad takes the kernel (two launches a
    call, one a wrapper call); the same block recording gradients, and a
    float32 block, take the plain sequence."""
    x = _stream(1, 9, 11, 768)[0].to(card)

    def launches(blk, grad):
        before = get_counters().get("launches.residual_norm", 0)
        with torch.set_grad_enabled(grad):
            blk(x)
        return get_counters().get("launches.residual_norm", 0) - before

    bf16 = _block(768, 7).to(card)
    assert launches(bf16, False) == 2
    assert launches(bf16, True) == 0
    assert launches(_block(768, 7, torch.float32).to(card), False) == 0


@pytest.mark.cuda
def test_an_unsupported_width_raises(card):
    x, norm = _stream(1, 4, 4, 512)
    x, norm = x.to(card), norm.to(card)
    with pytest.raises(ValueError, match="width 512"):
        nk.residual_norm(x, norm.weight, norm.bias, norm.eps, 0)
