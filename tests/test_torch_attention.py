"""ViT-Det's relative-position attention kernel (csrc/relpos_attention.cu,
ops/attention_kernels.py) and the choice between it and the plain version
(models/image_encoder.RelPosAttention).

On the CPU: which calls take the kernel (a bfloat16 module on a card with
no gradient asked for) and which the plain version (a CPU tensor, a
float32 module, a call that needs gradients), with the wrapper replaced by
one that fails, so a wrong choice shows; the geometry rule; and the
kernel's arithmetic (key tiles of 64, online softmax, P rounded to
bfloat16 unnormalised, the row sum over the rounded values) written out in
PyTorch, held to the same accuracy bound as the kernel on the card.

On the card (marked ``cuda``; skipped without one, decided inside the
``card`` fixture): the kernel against the plain version at vit_h's and
vit_b's global and windowed shapes, the depth attention's 4 tokens, a
ragged 7x9 grid and two more grids, one for each geometry, q, k and v
taken by strides from a real ``qkv`` projection and
the weights drawn as the SAM cell draws them
(the SAM cell's ``sam_clip.draw_state``: tables at 2 / sqrt(hd);
``_module``). This file imports no JAX; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_attention.py -q

Accuracy: both versions are held to a float32 attention of the same
bfloat16 q, k, v and the float32 bias of the JAX package's einsums
(scores, softmax and sum in float32, no rounding; ``_float32_attention``,
which shares no code with the bias projections that feed the kernel).
Both round P and the output to bfloat16, at different points: the plain
version rounds the normalised softmax, the kernel the
unnormalised exp(s - running max) and divides by the sum of the rounded
values at the end, and the two products accumulate in different orders.
So the kernel's error is not the plain version's bit for bit, but comes
from the same two roundings: its max-abs and mean-abs errors must be at
most ``ERR_RATIO`` (1.25) times the plain version's. The written-out
arithmetic reads 0.60-0.68 of the plain version's max-abs error and
0.76-0.85 of its mean (CPU, the shapes below at fewer heads); the kernel
on an H100 0.55-0.84 and 0.80-0.84 at vit_h's and vit_b's global and
windowed shapes.
"""

import math
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from tee_optical_flow_torch.models import image_encoder as ie
from tee_optical_flow_torch.ops import attention_kernels as ak
from tee_optical_flow_torch.utils.tracing import get_counters

ERR_RATIO = 1.25
# the tables' spread as the SAM cell draws them (sam_clip.draw_state):
# REL_POS_SPREAD / sqrt(hd); dense weights at 1/sqrt(fan-in), biases 0.1
REL_POS_SPREAD, ATTN_BIAS_SPREAD = 2.0, 0.1


def _module(heads, hd, h, w, dtype, device, seed=0):
    """A RelPosAttention on an h x w grid with its weights drawn as the SAM
    cell draws a checkpoint: dense weights at 1/sqrt(fan-in), biases at
    ATTN_BIAS_SPREAD, tables at REL_POS_SPREAD / sqrt(hd)."""
    from tee_optical_flow_torch.models.image_encoder import RelPosAttention

    gen = torch.Generator().manual_seed(seed)
    m = RelPosAttention(heads * hd, heads, input_size=(h, w), dtype=dtype)
    with torch.no_grad():
        for lin in (m.qkv, m.proj):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             / math.sqrt(lin.weight.shape[1]))
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen)
                           * ATTN_BIAS_SPREAD)
        for t in (m.rel_pos_h, m.rel_pos_w):
            t.copy_(torch.randn(t.shape, generator=gen)
                    * REL_POS_SPREAD / math.sqrt(hd))
    return m.to(device)


def _qkv(m, b, h, w, seed=1):
    """The module's qkv projection of (b, h, w, dim) standard normal tokens
    (what the block's LayerNorm hands it), reshaped as its forward does:
    (b, N, 3, heads, hd)."""
    from tee_optical_flow_torch.models.common import linear

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, m.num_heads * m.head_dim), generator=gen)
    return linear(x.to(m.qkv.weight.device), m.qkv, m.dtype).reshape(
        b, h * w, 3, m.num_heads, m.head_dim)


def _float32_attention(m, qkv, h, w):
    """The attention of the module's bfloat16 qkv (B, N, 3, heads, hd) in
    float32 with no rounding, (B, N, heads, hd): the bias from the JAX
    package's einsums over the float32 queries and tables (not from the
    module's ``_bias_terms``, which feeds the kernel), the scores, softmax
    and weighted sum in float32."""
    from tee_optical_flow_torch.models.image_encoder import rel_pos_embed

    q, k, v = (t.to(torch.float32) for t in qkv.permute(2, 0, 3, 1, 4))
    b, heads, n, hd = q.shape
    qr = q.reshape(b, heads, h, w, hd)
    bias_h = torch.einsum("byhwc,hkc->byhwk", qr,
                          rel_pos_embed(m.rel_pos_h, h, h))
    bias_w = torch.einsum("byhwc,wkc->byhwk", qr,
                          rel_pos_embed(m.rel_pos_w, w, w))
    s = torch.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
    s += (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n)
    return torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2)


def _written_out(m, qkv, h, w):
    """The kernel's arithmetic in PyTorch: key tiles of KEY_TILE, online
    softmax in float32, P rounded to bfloat16 before the product, the row
    sum over the rounded values, the output divided at the end and
    rounded to bfloat16: (B, N, heads, hd)."""
    q, k, v = (t.to(torch.float32) for t in qkv.permute(2, 0, 3, 1, 4))
    b, heads, n, hd = q.shape
    bias_h, bias_w = m._bias_terms(qkv[:, :, 0], h, w)
    bias_h = bias_h.reshape(b, heads, n, h)
    bias_w = bias_w.reshape(b, heads, n, w)
    mx = torch.full((b, heads, n, 1), -math.inf)
    total = torch.zeros((b, heads, n, 1))
    acc = torch.zeros((b, heads, n, hd))
    j = torch.arange(n)
    for j0 in range(0, n, ak.KEY_TILE):
        keys = j[j0:j0 + ak.KEY_TILE]
        s = torch.matmul(q, k[..., keys, :].transpose(-2, -1)) \
            * (hd ** -0.5) + (bias_h[..., keys // w] + bias_w[..., keys % w])
        new = torch.maximum(mx, s.amax(-1, keepdim=True))
        scale = torch.exp(mx - new)
        p = torch.exp(s - new).to(torch.bfloat16).to(torch.float32)
        total = total * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + torch.matmul(p, v[..., keys, :])
        mx = new
    return (acc / total).to(torch.bfloat16).transpose(1, 2)


def _errors(got, ref):
    err = (got.to(torch.float64) - ref.to(torch.float64)).abs()
    return float(err.max()), float(err.mean())


def _plain(m, qkv, h, w):
    """The plain version's bfloat16 output, (B, N, heads, hd)."""
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    return m._attend(q, k, v, h, w).transpose(1, 2).to(torch.bfloat16)


# (B, heads, h, w, hd): the shapes of the card tests, at fewer images and
# heads so that the CPU runs them in seconds
WRITTEN_OUT = {"global": (1, 2, 64, 64, 80), "window": (4, 4, 14, 14, 80),
               "vit_b": (1, 2, 64, 64, 64),
               "vit_b_window": (4, 4, 14, 14, 64),
               "depth": (64, 2, 2, 2, 80), "ragged": (2, 2, 7, 9, 80)}


@pytest.mark.parametrize("name", list(WRITTEN_OUT))
def test_kernel_arithmetic_within_the_plain_error(name):
    """The kernel's arithmetic written out errs against the float32
    attention by at most ERR_RATIO times the plain version's error, max
    and mean: the bound the card tests hold the kernel to."""
    b, heads, h, w, hd = WRITTEN_OUT[name]
    m = _module(heads, hd, h, w, torch.bfloat16, "cpu")
    with torch.no_grad():
        qkv = _qkv(m, b, h, w)
        ref = _float32_attention(m, qkv, h, w)
        plain = _errors(_plain(m, qkv, h, w), ref)
        got = _errors(_written_out(m, qkv, h, w), ref)
    assert got[0] <= ERR_RATIO * plain[0], (got, plain)
    assert got[1] <= ERR_RATIO * plain[1], (got, plain)


@pytest.mark.parametrize("b, heads, h, w, hd", [
    (3, 4, 7, 9, 80), (2, 2, 14, 14, 64), (1, 2, 64, 64, 80)])
def test_bias_projections_are_the_einsums(b, heads, h, w, hd):
    """The bias projections (one float32 copy of q, two batched products
    read by strides) are the JAX package's einsums over the float32
    queries and tables, within 1e-6 of their largest magnitude (a library
    may sum in another order for other strides)."""
    m = _module(heads, hd, h, w, torch.bfloat16, "cpu")
    with torch.no_grad():
        qkv = _qkv(m, b, h, w)
        got = m._bias_terms(qkv[:, :, 0], h, w)
        qr = qkv[:, :, 0].to(torch.float32).reshape(b, h, w, heads, hd)
        qr = qr.permute(0, 3, 1, 2, 4)
        ref = (torch.einsum("byhwc,hkc->byhwk", qr,
                            ie.rel_pos_embed(m.rel_pos_h, h, h)),
               torch.einsum("byhwc,wkc->byhwk", qr,
                            ie.rel_pos_embed(m.rel_pos_w, w, w)))
    for x, y in zip(got, ref):
        assert x.shape == y.shape == (b, heads, h, w, x.shape[-1])
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max())


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel's wrapper was called")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_cpu_calls_take_the_plain_version(monkeypatch, dtype, grad):
    """On the CPU, in either type, with or without gradients, the module's
    output is the plain version's and the wrapper is never called."""
    monkeypatch.setattr(ak, "rel_pos_attention", _refuse)
    h, w = 7, 9
    m = _module(2, 16, h, w, dtype, "cpu")
    x = torch.randn(2, h, w, 32)
    with torch.set_grad_enabled(grad):
        got = m(x)
        qkv = ie.linear(x, m.qkv, dtype).reshape(2, h * w, 3, 2, 16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = m._attend(q, k, v, h, w).to(dtype).transpose(1, 2)
        ref = ie.linear(out.reshape(2, h, w, 32), m.proj, dtype)
    assert torch.equal(got, ref)
    assert got.requires_grad == grad


def test_vitdet_encoder_on_the_cpu_never_calls_the_kernel(monkeypatch):
    """A whole small ViT-Det encoder (windowed and global blocks, the depth
    branch) in bfloat16 under no_grad on the CPU runs without the
    wrapper."""
    monkeypatch.setattr(ak, "rel_pos_attention", _refuse)
    enc = ie.ImageEncoderViT(img_size=64, embed_dim=32, depth=2, num_heads=2,
                             out_chans=16, window_size=3,
                             global_attn_indexes=(1,), thd=True, chunk=4,
                             dtype=torch.bfloat16)
    with torch.no_grad():
        out = enc(torch.randn(4, 3, 64, 64))
    assert out.shape == (4, 16, 4, 4) and torch.isfinite(out).all()


# (module type, gradients on, weights frozen, qkv needs grad, tensor on a
# card) -> takes the kernel
TAKES_KERNEL = {
    "bf16 no_grad": ((torch.bfloat16, False, False, False, True), True),
    "bf16 grad, frozen": ((torch.bfloat16, True, True, False, True), True),
    "bf16 grad": ((torch.bfloat16, True, False, False, True), False),
    "bf16 grad, qkv grad": ((torch.bfloat16, True, True, True, True), False),
    "float32 no_grad": ((torch.float32, False, False, False, True), False),
    "cpu bf16 no_grad": ((torch.bfloat16, False, False, False, False),
                         False),
}


@pytest.mark.parametrize("case", list(TAKES_KERNEL))
def test_the_kernel_is_taken_where_the_input_allows(case):
    """takes_kernel: a card tensor, a bfloat16 module and no gradient to
    record (grad off, or nothing that needs one) take the kernel; a
    float32 module, a call that records gradients and a CPU tensor take
    the plain version."""
    (dtype, grad, frozen, qkv_grad, on_card), expected = TAKES_KERNEL[case]
    m = _module(2, 16, 4, 4, dtype, "cpu").requires_grad_(not frozen)
    qkv = (types.SimpleNamespace(device=torch.device("cuda"),
                                 requires_grad=qkv_grad) if on_card
           else torch.zeros(1, 16, 3, 2, 16, dtype=torch.bfloat16))
    with torch.set_grad_enabled(grad):
        assert m.takes_kernel(qkv) is expected


@pytest.mark.parametrize("w, expected", [
    (2, (8, 1, False)), (14, (8, 1, False)), (9, (8, 1, False)),
    (64, (4, 2, True)), (40, (8, 1, False)), (192, (4, 2, True)),
    (128, (4, 2, True))])
def test_attention_geometry(w, expected):
    """Key tiles within a grid row: 4 warps of two row tiles; else 8 of
    one."""
    assert ak.attention_geometry(w) == expected


def test_a_cpu_tensor_given_to_the_wrapper_raises():
    """The wrapper does not fall back: a tensor off the card raises."""
    qkv = torch.zeros(1, 4, 3, 2, 80, dtype=torch.bfloat16)
    qh = torch.zeros(1, 2, 4, 2)
    with pytest.raises(ValueError, match="on a card"):
        ak.rel_pos_attention(qkv, qh, qh, 2, 2, 80 ** -0.5)


def test_the_wrapper_traces_to_its_operator_without_data():
    """torch.export traces with fake tensors, which hold no data: the
    wrapper reads none, and its operator's fake gives the output
    (B, N, heads, hd) in bfloat16 on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        qkv = torch.empty(2, 63, 3, 4, 80, dtype=torch.bfloat16,
                          device="cuda")
        qh = torch.empty(2, 4, 7, 9, 7, device="cuda")
        qw = torch.empty(2, 4, 7, 9, 9, device="cuda")
        out = ak.rel_pos_attention(qkv, qh, qw, 7, 9, 80 ** -0.5)
        assert out.shape == (2, 63, 4, 80)
        assert out.dtype == torch.bfloat16 and out.device.type == "cuda"


def test_the_operator_exports():
    """torch.export of a module that calls the wrapper records the
    operator in its graph (tracing runs only the fake)."""

    class Attend(torch.nn.Module):
        def forward(self, qkv, qh, qw):
            return ak.rel_pos_attention(qkv, qh, qw, 7, 9, 80 ** -0.5)

    args = (torch.zeros(2, 63, 3, 4, 80, dtype=torch.bfloat16),
            torch.zeros(2, 4, 7, 9, 7), torch.zeros(2, 4, 7, 9, 9))
    program = torch.export.export(Attend(), args)
    targets = [str(node.target) for node in program.graph.nodes]
    assert "tee_optical_flow.rel_pos_attention.default" in targets, targets


def test_the_first_call_imports_no_compiler():
    """A process's first call of the operator costs no import of
    torch._dynamo (torch.library.custom_op's wrapper imported it at its
    first call: seconds of every run's set-up). Run in a fresh
    interpreter: the test process may hold it already."""
    code = (
        "import sys, torch\n"
        "from tee_optical_flow_torch.ops import attention_kernels as ak\n"
        "qkv = torch.zeros(1, 4, 3, 2, 80, dtype=torch.bfloat16)\n"
        "qh = torch.zeros(1, 2, 2, 2, 2)\n"
        "try:\n"
        "    ak.rel_pos_attention(qkv, qh, qh, 2, 2, 0.1)\n"
        "except ValueError:\n"
        "    pass\n"
        "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False", out.stdout + out.stderr


# --- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, heads, h, w, hd): vit_h's global block on a micro-batch of 4, its
# windowed blocks (4 frames x 25 windows of 14x14), vit_b's head width at
# its global and windowed shapes (the windowed one runs 8 of vit_b's 12
# blocks and 20 of vit_l's 24), the depth attention's 4 tokens on a 2x2
# grid (the batch is frames x tokens), a ragged 7x9 grid; and two grids
# that move each geometry (attention_geometry) off the served shapes:
# 16x64 (key tiles within a grid row, 16 rows) and 40x40 (tiles across
# grid rows at 1,600 tokens: vit_h's global block at a 640 image)
CARD_SHAPES = {"vit_h_global": (4, 16, 64, 64, 80),
               "vit_h_window": (100, 16, 14, 14, 80),
               "vit_b_global": (4, 12, 64, 64, 64),
               "vit_b_window": (100, 12, 14, 14, 64),
               "depth": (1024, 16, 2, 2, 80),
               "ragged": (3, 16, 7, 9, 80),
               "rows_16x64": (4, 16, 16, 64, 80),
               "global_40x40": (4, 16, 40, 40, 80)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_kernel_matches_the_plain_version(card, name):
    b, heads, h, w, hd = CARD_SHAPES[name]
    m = _module(heads, hd, h, w, torch.bfloat16, card)
    with torch.no_grad():
        qkv = _qkv(m, b, h, w)
        got = m._attend_kernel(qkv, h, w)
        assert got.shape == (b, h * w, heads, hd)
        assert got.dtype == torch.bfloat16
        ref = _float32_attention(m, qkv, h, w)
        plain = _errors(_plain(m, qkv, h, w), ref)
        err = _errors(got, ref)
    assert err[0] <= ERR_RATIO * plain[0], (err, plain)
    assert err[1] <= ERR_RATIO * plain[1], (err, plain)


@pytest.mark.cuda
def test_launch_counter_counts_one_a_call(card):
    b, heads, h, w, hd = CARD_SHAPES["ragged"]
    m = _module(heads, hd, h, w, torch.bfloat16, card)
    with torch.no_grad():
        qkv = _qkv(m, b, h, w)
        before = get_counters().get("launches.rel_pos_attention", 0)
        for _ in range(3):
            m._attend_kernel(qkv, h, w)
        torch.cuda.synchronize()
    assert get_counters()["launches.rel_pos_attention"] - before == 3


@pytest.mark.cuda
def test_module_dispatch_on_the_card(card):
    """A bfloat16 module under no_grad takes the kernel (one launch a
    call); the same module recording gradients, and a float32 module,
    take the plain version."""
    h, w = 7, 9
    x = torch.randn(2, h, w, 16 * 80, device=card)

    def launches(m, grad):
        before = get_counters().get("launches.rel_pos_attention", 0)
        with torch.set_grad_enabled(grad):
            m(x)
        return get_counters().get("launches.rel_pos_attention", 0) - before

    bf16 = _module(16, 80, h, w, torch.bfloat16, card)
    assert launches(bf16, False) == 1
    assert launches(bf16, True) == 0
    assert launches(_module(16, 80, h, w, torch.float32, card), False) == 0


@pytest.mark.cuda
def test_an_unsupported_head_width_raises(card):
    h, w = 4, 4
    m = _module(4, 32, h, w, torch.bfloat16, card)
    with torch.no_grad(), pytest.raises(ValueError, match="head width 32"):
        m(torch.randn(1, h, w, 128, device=card))


@pytest.mark.cuda
def test_a_geometry_the_library_does_not_build_raises(card):
    """The default library builds only attention_geometry's two pairs; any
    other is refused at the launch, not run."""
    b, heads, h, w, hd = CARD_SHAPES["rows_16x64"]
    m = _module(heads, hd, h, w, torch.bfloat16, card)
    with torch.no_grad():
        qkv = _qkv(m, b, h, w)
        args = (qkv, *m._bias_terms(qkv[:, :, 0], h, w), h, w, hd ** -0.5)
        for geometry in ((8, 1, True), (4, 2, False)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                ak._launch(*args, geometry)
