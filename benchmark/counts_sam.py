"""The SAM cell's arithmetic: the floating-point operations of one forward
of SAM with the ViT-Det encoder, counted from its shapes, and the least
time of a global attention block's work on one H100.

Operations are counted as ``torch.utils.flop_counter.FlopCounterMode``
counts them (two a multiply-add of every matrix product, batched product,
einsum and convolution; nothing for norms, softmax, GELU or additions),
so that ``benchmark/tests/test_bench_counts_sam.py`` can hold this count
to the counter at a small size. A windowed block's two projections run on
the windows' padded tokens, as the encoder partitions before them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 989.4 TFLOP/s of dense
bfloat16 products on the tensor cores (accumulating in float32), 3.35 TB/s
of HBM.
"""

from __future__ import annotations

import math

BF16_DENSE_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def _attention_flops(batch: int, heads: int, tokens: int, h: int, w: int,
                     head_dim: int) -> int:
    """Scores, weighted sum and the decomposed relative-position bias of
    one attention over ``tokens`` = h * w tokens."""
    return (4 * batch * heads * tokens * tokens * head_dim
            + 2 * batch * heads * tokens * (h + w) * head_dim)


def encoder_flops(model: dict, batch: int) -> int:
    """The ViT-Det image encoder on ``batch`` images."""
    c, heads = model["embed_dim"], model["num_heads"]
    hd, ws = c // heads, model["window_size"]
    grid = model["image_size"] // model["patch_size"]
    n = grid * grid
    mlp = int(c * model["mlp_ratio"])
    out = model["out_chans"]
    nw = math.ceil(grid / ws)
    padded = nw * nw * ws * ws
    total = 2 * batch * n * 3 * model["patch_size"] ** 2 * c
    for i in range(model["depth"]):
        if i in model["global_attn_indexes"]:
            total += 2 * batch * n * c * 4 * c  # qkv and proj
            total += _attention_flops(batch, heads, n, grid, grid, hd)
        else:
            total += 2 * batch * padded * c * 4 * c
            total += nw * nw * _attention_flops(batch, heads, ws * ws, ws, ws,
                                                hd)
        total += 2 * batch * n * c * mlp * 2
    total += 2 * batch * n * c * out + 2 * batch * n * out * out * 9
    return total


def decoder_flops(model: dict, batch: int) -> int:
    """The no-prompt prompt encoder's dense position embedding and the mask
    decoder (two-way transformer of depth 2, 8 heads, MLP 2048, the
    cross-attentions at half width, the upscaling, the hypernetwork MLPs,
    the masks' product and the IoU head) on ``batch`` images."""
    c = model["out_chans"]
    grid = model["image_size"] // model["patch_size"]
    n = grid * grid
    k = model["num_classes"] + 1  # mask tokens
    t = 1 + k  # the IoU token and the mask tokens
    ci = c // 2
    pe = 2 * n * 2 * (c // 2)

    def cross(queries, keys):
        # q from the queries, k and v from the keys, scores, sum, out
        return 2 * batch * (queries * c * ci + 2 * keys * c * ci
                            + 2 * queries * keys * ci + queries * ci * c)

    self_attn = 2 * batch * (4 * t * c * c + 2 * t * t * c)
    layer = (self_attn + cross(t, n) + 2 * batch * t * c * 2048 * 2
             + cross(n, t))
    transformer = 2 * layer + cross(t, n)
    up = 2 * batch * n * c * (c // 4) * 4 \
        + 2 * batch * 4 * n * (c // 4) * (c // 8) * 4
    hyper = 2 * batch * k * (c * c + c * c + c * (c // 8))
    masks = 2 * batch * k * (c // 8) * 16 * n
    iou = 2 * batch * (c * 256 + 256 * 256 + 256 * k)
    return pe + transformer + up + hyper + masks + iou


def forward_flops(model: dict, batch: int) -> int:
    return encoder_flops(model, batch) + decoder_flops(model, batch)


def flop_per_frame(model: dict) -> float:
    """One frame's share of a micro-batch's forward."""
    b = model["micro_batch"]
    return forward_flops(model, b) / b


def global_attn_least_s(model: dict) -> float:
    """Least seconds of one global block's attention on one micro-batch,
    from q, k and v to the weighted sum: the larger of its operations at
    the dense bfloat16 peak (bfloat16 products accumulated in float32,
    which the tensor cores give exactly) and its bytes at the HBM rate
    (q, k, v and the weighted sum in bfloat16, the two float32 tables)."""
    c, heads = model["embed_dim"], model["num_heads"]
    hd = c // heads
    grid = model["image_size"] // model["patch_size"]
    b, n = model["micro_batch"], grid * grid
    ops = _attention_flops(b, heads, n, grid, grid, hd)
    nbytes = 4 * b * n * c * 2 + 2 * (2 * grid - 1) * hd * 4
    return max(ops / BF16_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S)
