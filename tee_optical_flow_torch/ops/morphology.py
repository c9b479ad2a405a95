"""Binary morphology over whole clips (the JAX package's ops/morphology.py).

Every op runs batched over the frame axis, on the device the masks lie on:

  * connected components by neighbour-min label propagation run until no
    label changes: passes of ``LABEL_ROUNDS_PER_PASS`` rounds up to the
    first pass that changes nothing, at most H*W rounds. Rounds only lower
    labels, so that pass is the fixed point, and the labels are exact for
    any component. The JAX package runs a fixed 2*(H+W) rounds: where
    those converge, the labels are its bits; where they do not, the fills
    and size filters here equal scipy's and the JAX package's do not. On a
    card the passes run in ``csrc/labelling.cu``, many rounds per launch;
    on the CPU in the plain loop;
  * component sizes by scatter-adds keyed by root label;
  * fill-holes as border reachability on the complement;
  * the temporal moving-average mask as a cumsum (reference :90-111);
  * per-frame largest-component centroids and label-1 areas for the
    analysis (reference analysis.py:18-86, cardiac_cycle_detection.py:
    161-172), from one labelling of the whole stack.

Connectivity conventions match the reference's defaults: ``label`` uses
8-connectivity (skimage 2-D default), ``remove_small_objects`` and
``binary_fill_holes`` use 4-connectivity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tracing import count, count_sync, trace_stage
from .cuda_lib import check_launch, launch_context, load_library, ptr


def _neighbor_min(ids: torch.Tensor, big: int, connectivity: int
                  ) -> torch.Tensor:
    """Min of each pixel's neighbourhood labels (cross or 3x3); ids is
    (N, H, W)."""
    p = F.pad(ids, (1, 1, 1, 1), value=big)
    up = p[:, :-2, 1:-1]
    down = p[:, 2:, 1:-1]
    left = p[:, 1:-1, :-2]
    right = p[:, 1:-1, 2:]
    m = torch.minimum(torch.minimum(up, down), torch.minimum(left, right))
    if connectivity == 2:
        ul = p[:, :-2, :-2]
        ur = p[:, :-2, 2:]
        dl = p[:, 2:, :-2]
        dr = p[:, 2:, 2:]
        m = torch.minimum(m, torch.minimum(torch.minimum(ul, ur),
                                           torch.minimum(dl, dr)))
    return torch.minimum(ids, m)


# rounds a pass: csrc/labelling.cu's LB_R, which the card's passes run,
# and the unit in which the plain loop looks for a change
LABEL_ROUNDS_PER_PASS = 8
# passes the card runs between two reads of their flags: each read is one
# host wait; passes after the quiet one return at once on the card
LABEL_PASSES_PER_READ = 32


def _label_plain(mask: torch.Tensor, connectivity: int):
    """The plain labelling loop and the rounds it ran: passes of
    ``LABEL_ROUNDS_PER_PASS`` rounds until a pass changes no id, at most
    H*W rounds in all."""
    n, h, w = mask.shape
    big = h * w
    lin = torch.arange(big, dtype=torch.int32,
                       device=mask.device).reshape(1, h, w)
    ids = torch.where(mask, lin, big)
    rounds = 0
    if n == 0:
        return ids, rounds
    while rounds < big:
        before = ids
        for _ in range(min(LABEL_ROUNDS_PER_PASS, big - rounds)):
            ids = torch.where(mask, _neighbor_min(ids, big, connectivity),
                              big)
            rounds += 1
        if torch.equal(ids, before):
            break
    return ids, rounds


def connected_components_plain(mask: torch.Tensor, connectivity: int = 2
                               ) -> torch.Tensor:
    """The plain version of the labelling kernel: neighbour-min
    propagation over a (N, H, W) boolean mask, each round a few PyTorch
    operations (the JAX package's ``lax.fori_loop`` round), in passes of
    ``LABEL_ROUNDS_PER_PASS`` rounds up to the first pass that changes
    nothing. Returns (N, H, W) int32 ids as ``connected_components``
    does."""
    return _label_plain(mask, connectivity)[0]


def _label_on_card(mask: torch.Tensor, connectivity: int, lib=None):
    """``labelling_group`` of ``csrc/labelling.cu`` (of ``lib``, the
    kernel library by default) on the current stream, and the rounds it
    ran: groups of ``LABEL_PASSES_PER_READ`` pass launches, the ids
    ping-ponging between two stacks, each group's flags read back (one
    host wait) until a pass is quiet or H*W rounds have run. Counts the
    pass launches in ``labelling_passes``."""
    n, h, w = mask.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"connected_components: {h}x{w} frames hold more "
                         "ids than int32 has")
    mask = mask.contiguous()
    bufs = [torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
            for _ in range(2)]
    if mask.numel() == 0:
        return bufs[0], 0
    lib = lib or load_library()
    r = LABEL_ROUNDS_PER_PASS
    total = -(-h * w // r)
    flags = torch.zeros(total, dtype=torch.int32, device=mask.device)
    done, quiet = 0, total - 1
    with launch_context(mask.device) as stream:
        while done < total:
            group = min(LABEL_PASSES_PER_READ, total - done)
            check_launch("labelling_group", lib.labelling_group(
                ptr(mask), ptr(bufs[0]), ptr(bufs[1]), ptr(flags), n, h, w,
                connectivity, done, group, stream))
            count("labelling_passes", group)
            seen = flags[done:done + group].cpu()  # waits for the group
            count_sync(mask.device)
            quiet_passes = torch.nonzero(seen == 0)
            if len(quiet_passes):
                quiet = done + int(quiet_passes[0])
                break
            done += group
    count("launches.connected_components")
    return bufs[quiet % 2], min((quiet + 1) * r, h * w)


def connected_components(mask: torch.Tensor, connectivity: int = 2
                         ) -> torch.Tensor:
    """Label a (H, W) or (N, H, W) boolean mask, each frame on its own.

    Returns int32 of the same shape: for foreground pixels, the linear
    index (within its frame) of the component's root, its first pixel in
    scan order; background pixels hold ``H*W``.

    On a CUDA tensor this launches the labelling kernel of
    ``csrc/labelling.cu`` (counted in ``launches.connected_components``);
    on a CPU tensor it runs the plain loop. Both run the same passes up
    to the first quiet one, give the same bits and add the rounds they
    ran to ``labelling_rounds``. Any other device raises."""
    squeeze = mask.ndim == 2
    mask = mask.to(torch.bool)
    if squeeze:
        mask = mask[None]
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError("connected_components runs on the CPU or a CUDA "
                         f"card, not on {mask.device}")
    with trace_stage("labelling"):
        if mask.device.type == "cpu":
            ids, rounds = _label_plain(mask, connectivity)
        else:
            ids, rounds = _label_on_card(mask, connectivity)
    count("labelling_rounds", rounds)
    return ids[0] if squeeze else ids


def component_sizes(ids: torch.Tensor) -> torch.Tensor:
    """Pixel count per root label; shape (..., H*W + 1), slot -1 =
    background."""
    h, w = ids.shape[-2:]
    flat = ids.reshape(-1, h * w).to(torch.int64)
    sizes = torch.zeros((flat.shape[0], h * w + 1), dtype=torch.int32,
                        device=ids.device)
    sizes.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    return sizes.reshape(ids.shape[:-2] + (h * w + 1,))


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] per frame: table (N, H*W+1), ids (N, H, W)."""
    n, h, w = ids.shape
    flat = ids.reshape(n, h * w).to(torch.int64)
    return torch.gather(table, 1, flat).reshape(n, h, w)


def remove_small_objects(mask: torch.Tensor, min_size: int = 64,
                         connectivity: int = 1) -> torch.Tensor:
    """Drop components smaller than ``min_size`` pixels (skimage semantics:
    strictly-smaller components are removed). (H, W) or (N, H, W)."""
    squeeze = mask.ndim == 2
    mask = mask.to(torch.bool)
    if squeeze:
        mask = mask[None]
    ids = connected_components(mask, connectivity=connectivity)
    keep = mask & (_lookup(component_sizes(ids), ids) >= min_size)
    return keep[0] if squeeze else keep


def binary_fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill background regions not reachable from the border (scipy
    default cross structuring element = 4-connectivity). (H, W) or
    (N, H, W)."""
    squeeze = mask.ndim == 2
    mask = mask.to(torch.bool)
    if squeeze:
        mask = mask[None]
    n, h, w = mask.shape
    big = h * w
    comp = connected_components(~mask, connectivity=1)
    border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    outside_roots = torch.where(border & ~mask, comp, big).reshape(n, big)
    outside = torch.zeros((n, big + 1), dtype=torch.bool, device=mask.device)
    outside.scatter_(1, outside_roots.to(torch.int64), True)
    # background slot must not leak "outside" onto foreground lookups
    outside[:, big] = False
    reachable = _lookup(outside, comp)
    filled = mask | (~mask & ~reachable)
    return filled[0] if squeeze else filled


def moving_avg_mask(arr: torch.Tensor, n: int = 4, threshold: float = 0.49
                    ) -> torch.Tensor:
    """Temporal moving-average binarisation over the frame axis.

    Exact translation of the reference's padding + cumsum-window trick
    (calculate_optical_flow.py:90-111): prepend the first frame once,
    append the last frame twice, window-``n`` mean, threshold.
    """
    ext = torch.cat([arr[:1], arr, arr[-1:], arr[-1:]], dim=0).to(
        torch.float32)
    csum = torch.cumsum(ext, dim=0)
    windowed = csum[n - 1:] - torch.cat(
        [torch.zeros_like(csum[:1]), csum[:-n]], dim=0)
    return (windowed / n) > threshold


def clean_binary_stack(mask_stack: torch.Tensor, min_size: int = 500
                       ) -> torch.Tensor:
    """fill_holes + remove_small_objects per frame, batched over the clip
    (reference clean_mask inner loop, calculate_optical_flow.py:163-167)."""
    return remove_small_objects(binary_fill_holes(mask_stack),
                                min_size=min_size, connectivity=1)


def _as_stack(mask: torch.Tensor):
    """(N, H, W) bool view of a (H, W) or (N, H, W) mask, and whether it
    was one frame."""
    squeeze = mask.ndim == 2
    mask = mask.to(torch.bool)
    return (mask[None] if squeeze else mask), squeeze


def component_areas_and_centroids(mask: torch.Tensor):
    """(area, centroid_row, centroid_col, valid) of the *largest* component
    (reference find_correct_centroid, analysis.py:18-36), per frame of a
    (H, W) or (N, H, W) mask.

    The largest component is the first root label of the largest size
    (argmax's first hit, as in the JAX package); the centroid is the
    float32 sum of its row (column) indices over its pixel count.
    ``valid`` is False for an empty mask; callers apply the reference's
    carry-forward policy on host.
    """
    mask, squeeze = _as_stack(mask)
    n, h, w = mask.shape
    big = h * w
    ids = connected_components(mask, connectivity=2)
    sizes = component_sizes(ids)
    sizes[:, big] = 0
    root = torch.argmax(sizes, dim=1)
    area = torch.gather(sizes, 1, root[:, None])[:, 0]
    sel = (ids == root[:, None, None].to(ids.dtype)) & mask
    cnt = torch.clamp_min(sel.sum(dim=(1, 2)), 1)
    rows = torch.arange(h, dtype=torch.float32,
                        device=mask.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32,
                        device=mask.device)[None, :].expand(h, w)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    crow = torch.where(sel, rows, zero).sum(dim=(1, 2)) / cnt
    ccol = torch.where(sel, cols, zero).sum(dim=(1, 2)) / cnt
    valid = mask.any(dim=2).any(dim=1)
    if squeeze:
        return area[0], crow[0], ccol[0], valid[0]
    return area, crow, ccol, valid


def label_first_area(mask: torch.Tensor):
    """Area of the component containing the first foreground pixel in scan
    order, i.e. skimage label 1, whose area the reference's AreaDetector
    reads via ``props[0].area`` (cardiac_cycle_detection.py:161-172), per
    frame of a (H, W) or (N, H, W) mask. Returns (area, valid)."""
    mask, squeeze = _as_stack(mask)
    n, h, w = mask.shape
    big = h * w
    ids = connected_components(mask, connectivity=2)
    # smallest root label == first-scanned component
    first_root = ids.reshape(n, big).min(dim=1).values
    sizes = component_sizes(ids)
    area = torch.gather(sizes, 1, torch.clamp(first_root, 0, big)[:, None]
                        .to(torch.int64))[:, 0]
    area = torch.where(first_root < big, area, torch.zeros_like(area))
    valid = mask.any(dim=2).any(dim=1)
    return (area[0], valid[0]) if squeeze else (area, valid)


def largest_centroid_series(mask_stack: torch.Tensor):
    """Per-frame largest-component centroids over a (N, H, W) stack.
    Returns (centroids (N, 2) as (row, col), areas (N,), valid (N,))."""
    area, crow, ccol, valid = component_areas_and_centroids(mask_stack)
    return torch.stack([crow, ccol], dim=1), area, valid


def first_area_series(mask_stack: torch.Tensor):
    """Per-frame skimage-label-1 areas over a (N, H, W) stack: (areas,
    valid)."""
    return label_first_area(mask_stack)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """Flatten a boolean tensor and pack 8 pixels per byte (big-endian bit
    order, numpy ``packbits``-compatible), on its device. Pair with
    :func:`unpack_mask_bits`: moving packed masks to the host moves 8x
    fewer bytes."""
    flat = mask.to(torch.uint8).reshape(-1)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                           device=flat.device)  # pageable upload: waits
    count_sync(flat.device)
    return (flat.reshape(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)


def unpack_mask_bits(packed, shape) -> np.ndarray:
    """Host-side inverse of :func:`pack_mask_bits` -> bool ndarray."""
    if isinstance(packed, torch.Tensor):
        count_sync(packed.device)
        packed = packed.cpu().numpy()
    flat = np.unpackbits(np.asarray(packed), count=int(np.prod(shape)))
    return flat.astype(bool).reshape(shape)
