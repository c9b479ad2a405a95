"""Probes behind the open questions of PERF.md: readings that no run of a
cell makes, but that the benchmark's choices rest on. Each prints one
JSON line per reading and appends it to ``--out``.

    python3 -m benchmark.probes rounds --traffic clip480 --seeds 1,2
    python3 -m benchmark.probes fill --traffic clip480 --seeds 1,2
    python3 -m benchmark.probes pairing --seeds 0,1,2,3,4

``rounds``: for each clip of a seed's pool, the rounds of neighbour-min
propagation that each labelling of the Otsu path needs before no label
changes (the fill's labelling of the background, the size filter's of
the filled masks; both 4-connected), beside the 2*(H+W) rounds that the
program's labelling runs.

``fill``: the program's masks of a clip as the RVIO_2class path makes
them (its vit_t segmentor in bfloat16, random weights from the program's
own ``build_sam_vit_t(seed=...)``, then ``clean_mask_device``), against a
second witness on the host (scipy.ndimage: the same moving average,
``binary_fill_holes`` and a 4-connected size filter); with the rounds
that the fill's labelling of each label needs.

``pairing``: rows of ``train.data.batch_iterator`` over PNG pairs whose
mask is a function of its own image (written to a temporary directory):
how many rows' masks carry their image's flip and rotation.

``rounds`` and ``fill`` take the card by default (``--device cpu`` for a
small traffic); ``pairing`` runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def rounds_needed(mask, connectivity: int = 1) -> int:
    """Rounds of propagation after which no label of the (N, H, W) mask
    changes any more."""
    import torch

    from .reference.masks import first_labels, propagate

    ids = first_labels(mask)
    rounds = 0
    while True:
        nxt = propagate(ids, mask, connectivity)
        if torch.equal(nxt, ids):
            return rounds
        ids = nxt
        rounds += 1


def otsu_rounds(frames, flow_cfg: dict) -> dict:
    """The rounds that each labelling of the Otsu path needs on one clip
    of (N, H, W) uint8 frames."""
    import torch

    from .reference import masks as ref_masks

    gray = frames.to(torch.float32) / 255.0
    raw = gray > ref_masks.otsu_thresholds(gray)[:, None, None]
    h, w = raw.shape[1:]
    return {"fill": rounds_needed(~raw),
            "size_filter": rounds_needed(ref_masks.fill_holes(raw)),
            "program_rounds": 2 * (h + w)}


def scipy_clean(labels: np.ndarray, value: int, flow_cfg: dict
                ) -> np.ndarray:
    """The second witness: a label's moving average, then per frame
    scipy's binary_fill_holes and a 4-connected size filter."""
    from scipy import ndimage

    n = flow_cfg["moving_avg_window"]
    arr = (labels == value).astype(np.float32)
    ext = np.concatenate([arr[:1], arr, arr[-1:], arr[-1:]])
    csum = np.cumsum(ext, axis=0)
    windowed = csum[n - 1:] - np.concatenate([np.zeros_like(csum[:1]),
                                              csum[:-n]])
    avg = windowed / n > flow_cfg["moving_avg_threshold"]
    out = np.zeros_like(avg)
    cross = ndimage.generate_binary_structure(2, 1)
    for k, frame in enumerate(avg):
        filled = ndimage.binary_fill_holes(frame, structure=cross)
        comp, _ = ndimage.label(filled, structure=cross)
        sizes = np.bincount(comp.ravel())
        sizes[0] = 0
        out[k] = filled & (sizes[comp] >= flow_cfg["min_mask_size"])
    return out


def fill_readings(frames, seg, flow_cfg: dict) -> dict:
    """For one clip: per label of RVIO_2class, the mask pixels where the
    program's cleaning differs from scipy's, and the rounds that the
    fill's labelling of the label's moving average needs."""
    from tee_optical_flow_torch.config import OpticalFlowCalculationConfig
    from tee_optical_flow_torch.flow.segment import LABEL_MAPS, \
        clean_mask_device

    from .reference import masks as ref_masks

    h, w = frames.shape[1:]
    labels = seg.labels_device(frames, (h, w))
    got = clean_mask_device(
        labels, "RVIO_2class",
        config=OpticalFlowCalculationConfig.from_dict(flow_cfg),
        device=labels.device)
    host = labels.cpu().numpy()
    out = {"program_rounds": 2 * (h + w)}
    for name, value in LABEL_MAPS["RVIO_2class"].items():
        witness = scipy_clean(host, value, flow_cfg)
        avg = ref_masks.moving_average(labels == value,
                                       flow_cfg["moving_avg_window"],
                                       flow_cfg["moving_avg_threshold"])
        out[name] = {
            "diff_px": int((got[name].cpu().numpy() != witness).sum()),
            "fill_rounds": rounds_needed(~avg),
            "label_px": int((host == value).sum())}
    return out


def pairing_readings(seed: int, rows: int = 8, size: int = 64,
                     out_size: int = 16, batch: int = 4) -> dict:
    """Rows of ``batch_iterator`` whose mask is its own image's, over one
    epoch of ``rows`` PNG pairs: each image is its mask's labels times
    80 in grey, so the image read back names the mask it must carry."""
    from PIL import Image

    from tee_optical_flow_torch.train.data import (
        IMAGENET_MEAN, IMAGENET_STD, PublicDataset, batch_iterator)

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "list.csv"), "w") as f:
            for r in range(rows):
                # an L-shaped label field: no flip or rotation maps it to
                # itself
                m = np.zeros((size, size), np.uint8)
                a, b = (int(v) for v in rng.integers(8, size // 2, 2))
                m[a:, :b] = 1
                m[:a // 2, b:] = 2
                Image.fromarray(m).save(os.path.join(tmp, f"m{r}.png"))
                Image.fromarray(np.repeat((m * 80)[..., None], 3, -1)).save(
                    os.path.join(tmp, f"i{r}.png"))
                f.write(f"i{r}.png,m{r}.png\n")
        ds = PublicDataset(tmp, tmp, os.path.join(tmp, "list.csv"),
                           phase="train", image_size=size, out_size=out_size,
                           seed=seed)
        step = size // out_size
        matched = total = 0
        for imgs, masks in batch_iterator(ds, batch, seed=seed):
            grey = (imgs * IMAGENET_STD + IMAGENET_MEAN)[..., 0] * 255.0
            want = np.rint(grey / 80.0).astype(np.int32)[:, ::step, ::step]
            matched += int((want == masks).all(axis=(1, 2)).sum())
            total += len(masks)
        # the second witness: one __getitem__ per row
        single = 0
        for r in range(rows):
            one = ds[r]
            grey = (one["image"] * IMAGENET_STD
                    + IMAGENET_MEAN)[..., 0] * 255.0
            single += int(np.array_equal(
                np.rint(grey / 80.0).astype(np.int32)[::step, ::step],
                one["mask"]))
    return {"rows_matched": matched, "rows": total,
            "getitem_matched": single}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("probe", choices=("rounds", "fill", "pairing"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--traffic", default="clip480")
    p.add_argument("--config", default="otsu-tvl1",
                   help="the configuration whose flow settings clean the "
                   "masks")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from . import harness, inputs

    seeds = [int(s) for s in args.seeds.split(",")]
    flow_cfg = harness.load_json("configs", args.config)["flow"]
    traffic = harness.load_json("traffic", args.traffic)
    seg = None
    if args.probe == "fill":
        import torch

        from tee_optical_flow_torch.models.registry import build_sam_vit_t
        from tee_optical_flow_torch.models.sam import make_clip_segmentor

    for seed in seeds:
        if args.probe == "pairing":
            records = [dict(pairing_readings(seed), seed=seed)]
        else:
            clips = inputs.echo_clips(
                seed, traffic["pool"], traffic["frames"], traffic["height"],
                traffic["width"], amplitudes=traffic["amplitudes"],
                period=traffic["period_frames"], device=args.device)
            if args.probe == "fill":
                seg = make_clip_segmentor(build_sam_vit_t(
                    num_classes=3, dtype=torch.bfloat16, seed=seed,
                    device=args.device), micro_batch=4)
            records = []
            for j, frames in enumerate(clips):
                got = (otsu_rounds(frames, flow_cfg) if seg is None
                       else fill_readings(frames, seg, flow_cfg))
                records.append(dict(got, seed=seed, clip=j,
                                    traffic=args.traffic))
        for record in records:
            print(json.dumps(record), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
