"""Plain clip masks: the yardstick the clip cells' masks are held to.

The semantics of the program's ``flow/segment.py`` (``predict_movie_thres``,
the Otsu path) and of the reference system it ports (skimage ``threshold_otsu``, scipy
``binary_fill_holes``, skimage ``remove_small_objects``, the temporal
moving average of calculate_optical_flow.py:90-111), written with plain
PyTorch operations. The Otsu threshold is a frozen copy of the program's
float32 arithmetic (another summation order can move a near-tie by one
bin). Connected components are labelled by neighbour-min propagation run
until no label changes, which is exact for any component, where the
program runs a fixed number of rounds. Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# rounds of propagation between two looks for a change
_ROUNDS_PER_CHECK = 64


def otsu_thresholds(frames: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """(N, H, W) -> (N,) thresholds: 256 bins over [min, max], the first
    bin centre that maximises the inter-class variance."""
    x = frames.reshape(frames.shape[0], -1)
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    bucket = torch.clamp(((x - lo) / span * nbins).to(torch.int64),
                         0, nbins - 1)
    hist = torch.zeros((x.shape[0], nbins), dtype=x.dtype, device=x.device)
    hist.scatter_add_(1, bucket, torch.ones_like(x))
    ar = torch.arange(nbins, dtype=x.dtype, device=x.device)
    centers = lo + (ar + 0.5) * span / nbins
    w1 = torch.cumsum(hist, dim=1)
    w2 = w1[:, -1:] - w1
    s1 = torch.cumsum(hist * centers, dim=1)
    mu1 = s1 / torch.clamp_min(w1, 1e-12)
    mu2 = (s1[:, -1:] - s1) / torch.clamp_min(w2, 1e-12)
    variance12 = w1 * w2 * (mu1 - mu2) ** 2
    variance12[:, -1] = -1.0
    idx = torch.argmax(variance12, dim=1, keepdim=True)
    return torch.gather(centers, 1, idx)[:, 0]


def propagate(ids: torch.Tensor, mask: torch.Tensor, connectivity: int
              ) -> torch.Tensor:
    """One round: each foreground pixel takes the least label of itself
    and its neighbours (the cross, or with ``connectivity`` 2 the 3x3
    square); background pixels hold H*W."""
    big = mask.shape[1] * mask.shape[2]
    p = F.pad(ids, (1, 1, 1, 1), value=big)
    m = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                      torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
    if connectivity == 2:
        m = torch.minimum(m, torch.minimum(
            torch.minimum(p[:, :-2, :-2], p[:, :-2, 2:]),
            torch.minimum(p[:, 2:, :-2], p[:, 2:, 2:])))
    return torch.where(mask, torch.minimum(ids, m), big)


def first_labels(mask: torch.Tensor) -> torch.Tensor:
    """Each foreground pixel's own scan-order index, background H*W."""
    n, h, w = mask.shape
    lin = torch.arange(h * w, dtype=torch.int64,
                       device=mask.device).reshape(1, h, w)
    return torch.where(mask, lin, h * w)


def label(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """(N, H, W) bool -> int64 labels: each foreground pixel holds the
    scan-order index of its component's first pixel, background H*W.
    ``connectivity`` 1 is the cross, 2 the 3x3 square."""
    ids = first_labels(mask)
    while True:
        before = ids
        for _ in range(_ROUNDS_PER_CHECK):
            ids = propagate(ids, mask, connectivity)
        if torch.equal(ids, before):
            return ids


def _per_label(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    n, h, w = ids.shape
    return torch.gather(table, 1, ids.reshape(n, h * w)).reshape(n, h, w)


def remove_small_objects(mask: torch.Tensor, min_size: int) -> torch.Tensor:
    """Drop 4-connected components of fewer than ``min_size`` pixels."""
    n, h, w = mask.shape
    ids = label(mask, 1)
    sizes = torch.zeros((n, h * w + 1), dtype=torch.int64,
                        device=mask.device)
    flat = ids.reshape(n, h * w)
    sizes.scatter_add_(1, flat, torch.ones_like(flat))
    return mask & (_per_label(sizes, ids) >= min_size)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill the background that no 4-connected path joins to the border."""
    n, h, w = mask.shape
    big = h * w
    comp = label(~mask, 1)
    border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    roots = torch.where(border & ~mask, comp, big).reshape(n, big)
    outside = torch.zeros((n, big + 1), dtype=torch.bool, device=mask.device)
    outside.scatter_(1, roots, True)
    outside[:, big] = False
    return mask | (~mask & ~_per_label(outside, comp))


def moving_average(arr: torch.Tensor, n: int, threshold: float
                   ) -> torch.Tensor:
    """The first frame prepended once, the last appended twice, a window-n
    mean over the frame axis, thresholded."""
    ext = torch.cat([arr[:1], arr, arr[-1:], arr[-1:]]).to(torch.float32)
    csum = torch.cumsum(ext, dim=0)
    windowed = csum[n - 1:] - torch.cat([torch.zeros_like(csum[:1]),
                                         csum[:-n]])
    return (windowed / n) > threshold


def clean(mask: torch.Tensor, min_size: int) -> torch.Tensor:
    return remove_small_objects(fill_holes(mask), min_size)


def otsu_masks(gray: torch.Tensor, flow_cfg: dict) -> dict:
    """(N, H, W) luma -> {"otsu": (N, H, W) bool}: per-frame Otsu, then
    fill and remove, then the moving average."""
    raw = gray > otsu_thresholds(gray)[:, None, None]
    avg = moving_average(clean(raw, flow_cfg["min_mask_size"]),
                         flow_cfg["moving_avg_window"],
                         flow_cfg["moving_avg_threshold"])
    return {"otsu": avg}

