"""Fine-tuning CLI (the JAX package's cli/train.py).

    python -m tee_optical_flow_torch.cli.train --dir_checkpoint run \
        --img_folder imgs --mask_folder masks --train_img_list train.csv \
        --val_img_list val.csv --num_cls 3 [--device cpu]

Parity with reference finetune-SAM/SingleGPU_train_finetune_noprompt.py
__main__ (:194-214) and the cfg.py flag schema (:3-77). Same flags as the
JAX CLI, plus ``--device`` (``cuda`` by default, ``cpu``). Writes
``args.json`` and the best-DSC ``checkpoint_best.pth`` into
``--dir_checkpoint``, which ``cli.process --checkpoint_dir`` then serves.
``--data_axis`` or ``--model_axis`` above 1 (training on several cards)
raise NotImplementedError: ROADMAP.md, queue 1, item 6.
"""

from __future__ import annotations

import argparse
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Fine-tune SAM on TEE data")
    parser.add_argument("--arch", type=str, default="vit_t",
                        choices=["vit_t", "vit_b", "vit_l", "vit_h"])
    parser.add_argument("--finetune_type", type=str, default="vanilla",
                        choices=["vanilla", "adapter", "lora"])
    parser.add_argument("--num_cls", type=int, default=9)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("-b", "--batch_size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--image_size", type=int, default=1024)
    parser.add_argument("--out_size", type=int, default=256)
    parser.add_argument("--warmup_period", type=int, default=200)
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument("--if_update_encoder", action="store_true", default=True)
    parser.add_argument("--freeze_encoder", action="store_true")
    parser.add_argument("--lora_rank", type=int, default=4)
    # PEFT placement flags (reference cfg.py:59-67). Adapters: which
    # encoder blocks/stages get them and whether the mask decoder does.
    # LoRA: whether encoder/decoder get factors, and which encoder blocks
    # ([] = every block, the reference's documented semantics); unlike the
    # reference, leaving BOTH lora flags off keeps factors everywhere
    # instead of silently training nothing.
    parser.add_argument("--if_encoder_adapter", action="store_true")
    parser.add_argument("--encoder_adapter_depths", type=int, nargs="*",
                        default=[0, 1, 10, 11],
                        help="block indices (vit_b/l/h) or stage indices "
                             "0-3 (vit_t) that get adapters")
    parser.add_argument("--if_mask_decoder_adapter", action="store_true")
    parser.add_argument("--if_encoder_lora_layer", action="store_true")
    parser.add_argument("--if_decoder_lora_layer", action="store_true")
    parser.add_argument("--encoder_lora_layer", type=int, nargs="*",
                        default=[])
    parser.add_argument("--sam_ckpt", type=str, default=None,
                        help="torch .pth (mobile_sam.pt or fine-tuned) to "
                             "convert as initialization")
    parser.add_argument("--dir_checkpoint", type=str, required=True)
    parser.add_argument("--img_folder", type=str, required=True)
    parser.add_argument("--mask_folder", type=str, required=True)
    parser.add_argument("--train_img_list", type=str, required=True)
    parser.add_argument("--val_img_list", type=str, required=True)
    parser.add_argument("--targets", type=str, default="multi_all")
    parser.add_argument("--prompt_type", type=str, default=None,
                        choices=[None, "point", "box"],
                        help="prompted fine-tuning (the reference's "
                             "train_finetune_box variant)")
    # several cards are not ported yet: values above 1 raise
    parser.add_argument("--data_axis", type=int, default=None)
    parser.add_argument("--model_axis", type=int, default=1)
    parser.add_argument("--layer_lr_decay", type=float, default=1.0,
                        help="TinyViT per-block lr decay rate (reference "
                             "tiny_vit_sam.py:655-687 uses 0.8); 1.0 = off")
    parser.add_argument("--grad_accum", type=int, default=1)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the run trains")
    return parser


def main(argv=None) -> int:
    """Run the CLI; returns 0."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ..config import TrainConfig
    from ..core import resolve_device
    from ..models.registry import sam_model_registry
    from ..train.data import PublicDataset, batch_iterator
    from ..train.loop import train_model
    from ..utils import safe_makedir

    if (args.data_axis or 1) > 1 or args.model_axis > 1:
        raise NotImplementedError(
            f"--data_axis {args.data_axis} --model_axis {args.model_axis}: "
            "training on several cards is not ported yet: ROADMAP.md, "
            "queue 1, item 6")
    device = resolve_device(args.device)
    cfg = TrainConfig(
        arch=args.arch, finetune_type=args.finetune_type,
        num_cls=args.num_cls, image_size=args.image_size,
        out_size=args.out_size, epochs=args.epochs, b=args.batch_size,
        lr=args.lr, warmup=not args.no_warmup,
        warmup_period=args.warmup_period, lora_rank=args.lora_rank,
        lora_layers=args.encoder_lora_layer or None,
        if_encoder_lora_layer=args.if_encoder_lora_layer,
        if_decoder_lora_layer=args.if_decoder_lora_layer,
        if_encoder_adapter=args.if_encoder_adapter,
        encoder_adapter_depths=list(args.encoder_adapter_depths),
        if_mask_decoder_adapter=args.if_mask_decoder_adapter,
        if_update_encoder=not args.freeze_encoder,
        dir_checkpoint=args.dir_checkpoint, targets=args.targets,
        layer_lr_decay=args.layer_lr_decay,
        mesh_data_axis=args.data_axis, grad_accum=args.grad_accum,
        remat=args.remat, seed=args.seed)
    safe_makedir(cfg.dir_checkpoint)
    cfg.to_json(os.path.join(cfg.dir_checkpoint, "args.json"))

    build_kwargs = {}
    if args.finetune_type == "adapter":
        # without any adapter placement the trainable set would be empty
        if not (args.if_encoder_adapter or args.if_mask_decoder_adapter):
            raise SystemExit(
                "finetune_type=adapter needs --if_encoder_adapter and/or "
                "--if_mask_decoder_adapter (otherwise no adapter modules "
                "exist and nothing would train)")
        if args.if_encoder_adapter:
            build_kwargs["adapter_stages"] = tuple(
                args.encoder_adapter_depths)
        build_kwargs["use_decoder_adapter"] = args.if_mask_decoder_adapter

    model = sam_model_registry[args.arch](
        num_classes=args.num_cls, image_size=args.image_size,
        checkpoint=args.sam_ckpt, seed=args.seed, device=device,
        **build_kwargs)

    lora_params = None
    if args.finetune_type == "lora":
        from ..models.lora import init_lora

        # either placement flag -> honour exactly (reference cfg.py:65-67);
        # neither -> factors everywhere
        any_flag = args.if_encoder_lora_layer or args.if_decoder_lora_layer
        lora_params = init_lora(
            model, rank=args.lora_rank, seed=args.seed,
            encoder=args.if_encoder_lora_layer or not any_flag,
            decoder=args.if_decoder_lora_layer or not any_flag,
            encoder_layers=args.encoder_lora_layer)

    train_ds = PublicDataset(args.img_folder, args.mask_folder,
                             args.train_img_list, phase="train",
                             image_size=args.image_size,
                             out_size=args.out_size,
                             targets=args.targets).filter_empty()
    val_ds = PublicDataset(args.img_folder, args.mask_folder,
                           args.val_img_list, phase="val",
                           image_size=args.image_size, out_size=args.out_size,
                           targets=args.targets)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)

    result = train_model(
        model,
        train_batches=lambda: batch_iterator(train_ds, args.batch_size),
        val_batches=lambda: batch_iterator(val_ds, args.batch_size,
                                           shuffle=False, drop_last=False),
        cfg=cfg, steps_per_epoch=steps_per_epoch, lora_params=lora_params)
    logging.getLogger(__name__).info("best DSC: %.4f", result["best_dsc"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
