"""The labelling kernel's pass schedule, emulated on the CPU and held to the
plain labelling (``connected_components`` on a CPU tensor).

``csrc/labelling.cu``'s ``labelling_group`` runs passes of R rounds of
neighbour-min propagation, one launch each, and the host
(``ops/morphology._label_on_card``) launches them in groups of k, reading
the group's flags after each, until a pass changes no id (at most H*W
rounds). A pass loads an extended tile of EW x EH ids (its output tile and
a halo of R pixels on every side, pixels outside the image at big = H*W;
the first pass builds the ids from the mask), runs up to R Jacobi rounds on
it, where a missing neighbour at the extended tile's edge reads as the
pixel itself and a pixel whose id is big keeps it, writes only its output
tile (the region whose values are right shrinks by a pixel a round), and
sets its flag when that tile changed. Pass p ping-pongs from buffer (p - 1)
% 2 into p % 2; a pass whose predecessor is quiet does nothing, and the
labels are in the quiet pass's buffer. The kernel takes the 3x3 minimum as
the column minimum of the row minimums, with each clamped at the tile's
edge: the same as the minimum over the edge-replicated square computed
here.

The emulation follows that schedule at the kernel's own geometry (read
from the source) and at a scaled-down one a few pixels wide, and must be
bit-equal to the plain labelling, rounds included, for both
connectivities, 2-D and 3-D masks, shapes that are a multiple of neither
tile side, frames narrower than the halo, empty and full masks, and a
serpentine that needs more than 2*(H+W) rounds (the JAX package's fixed
count): the schedule keeps the plain loop's rounds pass for pass, not
merely its fixed point. A halo one pixel short must differ on the
serpentine after one pass. A mask that needs more than 2*(H+W) rounds is
filled and size-filtered as scipy.ndimage does it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tee_optical_flow_torch
from chip_smoke import labelling_schedule, rounds_needed
from tee_optical_flow_torch.ops import morphology as mo
from tee_optical_flow_torch.utils.tracing import get_counters

torch.set_num_threads(1)


def _source_geometry():
    """(R, EW, EH) as csrc/labelling.cu defines them by default."""
    src = (Path(tee_optical_flow_torch.__file__).parent / "csrc"
           / "labelling.cu").read_text()
    return tuple(int(re.search(rf"#define {name} (\d+)", src).group(1))
                 for name in ("LB_R", "LB_EW", "LB_EH"))


# (rounds per pass, extended width, extended height, halo): the kernel's,
# and a scaled-down one whose output tiles are 4 x 3 pixels
GEOMETRIES = {"kernel": _source_geometry() + (_source_geometry()[0],),
              "small": (3, 10, 9, 3)}


def _tile_round(t, big, connectivity):
    """One Jacobi round on a batch of extended tiles (T, EH, EW): the
    least id over the cross or the square, the tile's edge replicated;
    ids equal to big stay big."""
    eh, ew = t.shape[1:]
    rows = torch.arange(-1, eh + 1).clamp(0, eh - 1)
    cols = torch.arange(-1, ew + 1).clamp(0, ew - 1)
    p = t[:, rows][:, :, cols]
    m = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                      torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
    if connectivity == 2:
        m = torch.minimum(m, torch.minimum(
            torch.minimum(p[:, :-2, :-2], p[:, :-2, 2:]),
            torch.minimum(p[:, 2:, :-2], p[:, 2:, 2:])))
    return torch.where(t < big, torch.minimum(t, m), big)


def _pass(src, dst, rounds, geometry, connectivity):
    """One launch: every extended tile of src (N, H, W) through ``rounds``
    rounds, its output tile written into dst; whether any output tile
    changed."""
    _, ew, eh, halo = geometry
    n, h, w = src.shape
    big = h * w
    tw, th = ew - 2 * halo, eh - 2 * halo
    tiles_x, tiles_y = math.ceil(w / tw), math.ceil(h / th)
    padded = F.pad(src, (halo, tiles_x * tw + halo - w,
                         halo, tiles_y * th + halo - h), value=big)
    tiles = padded.unfold(1, eh, th).unfold(2, ew, tw).reshape(-1, eh, ew)
    for _ in range(rounds):
        tiles = _tile_round(tiles, big, connectivity)
    inner = tiles[:, halo:eh - halo, halo:ew - halo]
    whole = inner.reshape(n, tiles_y, tiles_x, th, tw).permute(
        0, 1, 3, 2, 4).reshape(n, tiles_y * th, tiles_x * tw)
    dst.copy_(whole[:, :h, :w])
    return not torch.equal(dst, src)


def emulate(mask, geometry, connectivity, max_passes=None):
    """labelling_group's schedule, as _label_on_card drives it, on a (N,
    H, W) boolean mask: (the labels, the rounds run). ``max_passes`` stops
    after that many passes, quiet or not."""
    r = geometry[0]
    n, h, w = mask.shape
    big = h * w
    total = math.ceil(big / r)
    # stale values in both buffers: a tile left unwritten shows
    bufs = [torch.full((n, h, w), -7, dtype=torch.int32),
            torch.full((n, h, w), -9, dtype=torch.int32)]
    flags = [0] * total
    lin = torch.arange(big, dtype=torch.int32).reshape(1, h, w)
    first = torch.where(mask, lin, big)  # the first pass reads the mask
    done, quiet = 0, total - 1
    while done < total:
        group = min(mo.LABEL_PASSES_PER_READ, total - done)
        for p in range(done, done + group):
            if p > 0 and not flags[p - 1]:
                continue  # past the fixed point: the launch returns
            src = first if p == 0 else bufs[(p - 1) % 2]
            rounds = min(r, big - p * r)
            flags[p] = int(_pass(src, bufs[p % 2], rounds, geometry,
                                 connectivity))
            if max_passes is not None and p + 1 == max_passes:
                return bufs[p % 2], (p + 1) * r
        still = [p for p in range(done, done + group) if not flags[p]]
        if still:
            quiet = still[0]
            break
        done += group
    return bufs[quiet % 2], min((quiet + 1) * r, big)


def serpentine(h, w):
    """Corridors on the even rows joined at alternate ends: one component
    whose first pixel's id has to travel about h*w/2 pixels."""
    m = np.zeros((h, w), bool)
    m[0::2] = True
    for k, row in enumerate(range(1, h, 2)):
        m[row, w - 1 if k % 2 == 0 else 0] = True
    return torch.from_numpy(m)


def _random(shape, density, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(size=shape) < density)


def _cases(geometry):
    """name -> (N, H, W) or (H, W) mask; the shapes are a multiple of
    neither tile side and span more than one tile in both directions."""
    r, ew, eh, halo = GEOMETRIES[geometry]
    tw, th = ew - 2 * halo, eh - 2 * halo
    h, w = max(th + 1, 10), max(tw + 1, 15)
    return {
        "ragged": _random((2, h, w), 0.6),
        "ragged_2d": _random((h, w), 0.5, seed=1),
        "sparse": _random((1, h, w), 0.35, seed=2),
        "narrow_h": _random((3, max(1, halo // 2), w), 0.7, seed=3),
        "narrow_w": _random((2, h, max(1, halo - 1)), 0.7, seed=4),
        "tiny": _random((1, 1, 2), 1.0),
        "empty": torch.zeros((1, h, w), dtype=torch.bool),
        "full": torch.ones((1, h, w), dtype=torch.bool),
        "serpentine": serpentine(h, w)[None],
    }


CASES = [(g, c) for g in GEOMETRIES for c in _cases("small")]


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("geometry,case", CASES)
def test_schedule_matches_plain(geometry, case, connectivity):
    mask = _cases(geometry)[case]
    ref = mo.connected_components(mask, connectivity)
    stack = mask if mask.ndim == 3 else mask[None]
    r = GEOMETRIES[geometry][0]
    got, rounds = emulate(stack, GEOMETRIES[geometry], connectivity)
    assert torch.equal(got if mask.ndim == 3 else got[0], ref)
    assert rounds == labelling_schedule(rounds_needed(stack, connectivity),
                                        *stack.shape[1:], r)[0]
    if r == mo.LABEL_ROUNDS_PER_PASS:
        assert rounds == mo._label_plain(stack, connectivity)[1]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_cases_cover_the_schedule(geometry):
    """The cases reach what they are named for: several tiles, frames
    narrower than the halo, and a serpentine that needs more than
    2*(H+W) rounds (the JAX package's fixed count, after which its ids are
    not yet the fixed point), which the labelling runs to its end: every
    pass up to the first quiet one, counted from a plain count of the
    rounds needed and R."""
    r, ew, eh, halo = GEOMETRIES[geometry]
    cases = _cases(geometry)
    _, h, w = cases["ragged"].shape
    assert h % (eh - 2 * halo) and w % (ew - 2 * halo)
    assert h > eh - 2 * halo and w > ew - 2 * halo
    assert cases["narrow_h"].shape[1] < halo
    assert cases["narrow_w"].shape[2] < halo
    snake = cases["serpentine"]
    for connectivity in (1, 2):
        needed = rounds_needed(snake, connectivity)
        assert needed > 2 * (h + w), connectivity
        before = get_counters().get("labelling_rounds", 0)
        ids = mo.connected_components(snake, connectivity)
        ran = get_counters()["labelling_rounds"] - before
        assert ran == labelling_schedule(needed, h, w)[0]
        assert ran == (math.ceil(needed / mo.LABEL_ROUNDS_PER_PASS) + 1) \
            * mo.LABEL_ROUNDS_PER_PASS
        more = torch.where(snake, mo._neighbor_min(ids, h * w, connectivity),
                           h * w)
        assert torch.equal(more, ids), connectivity
        fixed = torch.where(snake, torch.arange(h * w, dtype=torch.int32)
                            .reshape(1, h, w), h * w)
        for _ in range(2 * (h + w)):
            fixed = torch.where(snake, mo._neighbor_min(fixed, h * w,
                                                        connectivity), h * w)
        assert not torch.equal(fixed, ids), connectivity
    # the emulated schedule's R is the plain loop's
    assert GEOMETRIES["kernel"][0] == mo.LABEL_ROUNDS_PER_PASS


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_halo_one_short_differs(geometry, connectivity):
    """R rounds a pass on the same output tiles with a halo of R - 1: their
    edges miss a neighbour's id, and the serpentine shows it after the
    first pass."""
    r, ew, eh, halo = GEOMETRIES[geometry]
    snake = _cases(geometry)["serpentine"]
    _, h, w = snake.shape
    big = h * w
    ref = torch.where(snake, torch.arange(big, dtype=torch.int32).reshape(
        1, h, w), big)
    for _ in range(r):
        ref = torch.where(snake, mo._neighbor_min(ref, big, connectivity),
                          big)
    one, _ = emulate(snake, (r, ew, eh, halo), connectivity, max_passes=1)
    assert torch.equal(one, ref)
    short, _ = emulate(snake, (r, ew - 2, eh - 2, halo - 1), connectivity,
                       max_passes=1)
    assert not torch.equal(short, ref)


def test_cpu_labelling_counts_rounds_not_launches():
    """A CPU tensor takes the plain loop: it adds the rounds it ran (every
    pass up to the first quiet one, from a plain count of the rounds
    needed and R), and no call of the kernel's wrapper."""
    before = get_counters()
    mask = _random((2, 9, 13), 0.5)
    ids = mo.connected_components(mask, 1)
    after = get_counters()
    assert torch.equal(ids, mo.connected_components_plain(mask, 1))
    needed = rounds_needed(mask, 1)
    assert after.get("labelling_rounds", 0) \
        - before.get("labelling_rounds", 0) \
        == labelling_schedule(needed, 9, 13)[0] \
        == (math.ceil(needed / mo.LABEL_ROUNDS_PER_PASS) + 1) \
        * mo.LABEL_ROUNDS_PER_PASS
    assert after.get("launches.connected_components", 0) \
        == before.get("launches.connected_components", 0)


def deep_masks(h, w):
    """Two (H, W) masks whose labellings need more than 2*(H+W) rounds: a
    wall around a serpentine corridor of background that reaches the
    border through one gap (the fill must see the whole corridor as
    outside), and a serpentine of foreground inside an empty frame (the
    size filter must count it as one component)."""
    inner = serpentine(h - 2, w - 2).numpy()
    corridor = np.ones((h, w), bool)
    corridor[1:-1, 1:-1] = ~inner
    corridor[1, 0] = False
    snake = np.zeros((h, w), bool)
    snake[1:-1, 1:-1] = inner
    return torch.from_numpy(np.stack([corridor, snake]))


def scipy_clean(masks, min_size):
    """scipy.ndimage's fill and 4-connected size filter, frame by frame."""
    from scipy import ndimage

    cross = ndimage.generate_binary_structure(2, 1)
    out = []
    for frame in masks.numpy():
        filled = ndimage.binary_fill_holes(frame, structure=cross)
        comp, _ = ndimage.label(filled, structure=cross)
        sizes = np.bincount(comp.ravel())
        sizes[0] = 0
        out.append(filled & (sizes[comp] >= min_size))
    return torch.from_numpy(np.stack(out))


def test_deep_masks_fill_and_filter_as_scipy():
    """Masks that need more than 2*(H+W) rounds are filled and
    size-filtered as scipy.ndimage does it (the JAX package's fixed rounds
    fill the corridor's far end and split the serpentine)."""
    h, w = 21, 30
    masks = deep_masks(h, w)
    assert rounds_needed(~masks[:1], 1) > 2 * (h + w)
    assert rounds_needed(masks[1:], 1) > 2 * (h + w)
    min_size = int(masks[1].sum()) - 5
    got = mo.clean_binary_stack(masks, min_size=min_size)
    assert torch.equal(got, scipy_clean(masks, min_size))
    assert got[1].sum() == masks[1].sum()
    assert not got[0][1:-1, 1:-1][~masks[0][1:-1, 1:-1]].any()


def test_other_devices_raise():
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        mo.connected_components(torch.zeros((4, 5), dtype=torch.bool,
                                            device="meta"))
