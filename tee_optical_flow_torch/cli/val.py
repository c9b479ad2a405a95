"""Held-out evaluation CLI: per-class IoU and Dice (the JAX package's
cli/val.py).

    python -m tee_optical_flow_torch.cli.val --dir_checkpoint run \\
        --img_folder imgs --mask_folder masks --img_list test.csv \\
        [--device cpu]

Parity with reference finetune-SAM/val_finetune_noprompt.py:114-130: the
run's args.json rebuilds the exact model, its checkpoint_best.pth loads
into it, and a CSV-listed split is evaluated. Prints one JSON line
{"iou": [...], "dice": [...]}, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate a SAM checkpoint")
    parser.add_argument("--dir_checkpoint", type=str, required=True)
    parser.add_argument("--img_folder", type=str, required=True)
    parser.add_argument("--mask_folder", type=str, required=True)
    parser.add_argument("--img_list", type=str, required=True)
    parser.add_argument("-b", "--batch_size", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the evaluation runs")
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    with open(os.path.join(args.dir_checkpoint, "args.json")) as f:
        run_args = json.load(f)
    arch = run_args.get("arch", "vit_t")
    num_cls = int(run_args.get("num_cls", 2))
    image_size = int(run_args.get("image_size", 1024))
    out_size = int(run_args.get("out_size", 256))

    from ..models.registry import sam_model_registry
    from ..train.checkpoint import model_kwargs_of_run
    from ..train.data import PublicDataset, batch_iterator
    from ..train.eval import evaluate_model

    model = sam_model_registry[arch](
        num_classes=num_cls,
        checkpoint=os.path.join(args.dir_checkpoint, "checkpoint_best.pth"),
        image_size=image_size, device=args.device,
        **model_kwargs_of_run(run_args))
    ds = PublicDataset(args.img_folder, args.mask_folder, args.img_list,
                       phase="val", image_size=image_size, out_size=out_size)
    result = evaluate_model(
        model,
        batch_iterator(ds, args.batch_size, shuffle=False, drop_last=False),
        num_cls)
    print(json.dumps({"iou": result["iou"].tolist(),
                      "dice": result["dice"].tolist()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
