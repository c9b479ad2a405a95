"""Flow-production CLI: DICOM folder -> HDF5 clips (the JAX package's
cli/process.py).

Parity with reference optical_flow/calculate_optical_flow.py:699-739 (same
flags: nchunks/dcm_folder/save_folder/waveform_folder/checkpoint_dir/arch/
verbose/recalculate; per-chunk output directories) plus the JAX package's
mode/of_algo/saliency/WASE toggles, ``--config`` and
``--compilation_cache_dir``. One flag is the port's own: ``--device``
(``cuda`` by default; ``cpu`` runs every kernel's plain version).

Usage:
    python -m tee_optical_flow_torch.cli.process --dcm_folder d \\
        --save_folder s --nchunks 1 [--mode otsu|RVIO_2class|A4C] \\
        [--of_algo TVL1|deepflow] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Process DICOM files and calculate optical flow")
    parser.add_argument("--nchunks", type=int, default=1)
    parser.add_argument("--dcm_folder", type=str, required=True)
    parser.add_argument("--save_folder", type=str, required=True)
    parser.add_argument("--waveform_folder", type=str, default=None)
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="Dir with checkpoint_best.pth + args.json "
                             "(required for SAM modes)")
    parser.add_argument("--arch", type=str, default="vit_t")
    parser.add_argument("--mode", type=str, default="RVIO_2class",
                        choices=["otsu", "RVIO_2class", "A4C", "MouseRV_A4C"])
    parser.add_argument("--of_algo", type=str, default="TVL1",
                        choices=["TVL1", "deepflow"])
    parser.add_argument("--bkgd_comp", type=str, default="none",
                        choices=["none", "WASE"])
    parser.add_argument("--saliency", action="store_true",
                        help="use fine-grained saliency as the flow input")
    parser.add_argument("--flipLR", action="store_true")
    parser.add_argument("--include_waveforms", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--recalculate", action="store_true")
    parser.add_argument("--config", type=str, default=None,
                        help="PipelineConfig JSON (config.py): supplies "
                             "mode/of_algo/saliency/WASE/waveforms/solver "
                             "knobs and the device policy; CLI flags that "
                             "differ from their parser defaults override "
                             "the file")
    parser.add_argument("--compilation_cache_dir", type=str, default=None,
                        help="where the CUDA kernel library is built and "
                             "kept: a later run pointed at the same "
                             "directory skips nvcc "
                             "(DeviceConfig.compilation_cache_dir)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the run computes; cpu runs the "
                             "kernels' plain PyTorch versions")
    return parser


def _apply_pipeline_config(args, parser):
    """Load ``--config`` (a PipelineConfig JSON), validate it, and fold it
    into ``args``: any flag left at its parser default takes the file's
    value. Returns the loaded PipelineConfig (or None)."""
    from ..config import PipelineConfig, validate_pipeline_config

    if args.config is None:
        return None
    cfg = PipelineConfig.from_json(args.config)
    validate_pipeline_config(cfg)
    file_values = {
        "mode": cfg.mode,
        "of_algo": "TVL1" if cfg.of_algo == "tvl1" else "deepflow",
        "saliency": not cfg.no_saliency,
        "bkgd_comp": "WASE" if cfg.wase else "none",
        "include_waveforms": cfg.include_waveforms,
    }
    for name, value in file_values.items():
        if getattr(args, name) == parser.get_default(name):
            setattr(args, name, value)
    return cfg


def load_segmentor(checkpoint_dir: str, arch: str = "vit_t",
                   model_dtype: str = "bfloat16", data_axis=None,
                   device=None):
    """Rebuild the segmentor from a run directory (args.json +
    checkpoint_best.pth), mirroring reference _load_segmentor_model
    (calculate_optical_flow.py:662-696): ``num_cls`` and ``arch`` from
    args.json, the reference torch checkpoint through
    ``models/registry``, on ``device`` (``cuda`` unless the caller asks
    for ``cpu``), computing in ``model_dtype``, in micro-batches of 4.
    Without a checkpoint the weights are the registry's seeded random
    ones, as in the JAX package. A directory written by the port's
    trainer (``cli.train``) serves as it is: args.json's adapter
    placement rebuilds an adapter run's model, and a LoRA run's factors
    are merged on load (models/convert.load_torch_checkpoint). The
    segmentor runs at the registry's image size (1024), as the JAX
    package's does, whatever size the run trained at.

    ``arch`` (vit_t, or the ViT-Det vit_b/l/h) comes from args.json when
    it says. ``model_dtype="int8"`` builds the model in bfloat16 and
    serves it with int8 weights (``make_clip_segmentor(weights_int8=
    True)``, models/quantize.py).

    ``data_axis > 1`` serves the frames data-parallel over a
    ``make_mesh(data_axis=data_axis, model_axis=1)`` mesh of the cards
    (of the one CPU device with ``device="cpu"``), in micro-batches of 4
    rounded up to a multiple of ``data_axis``; fewer devices than
    ``data_axis`` raise ShardingError, as the JAX package does.

    Refused with NotImplementedError: an orbax ``checkpoint_best/``
    snapshot of the JAX trainer with no ``.pth`` (orbax needs JAX; the
    port's trainer writes torch files)."""
    import torch

    from ..exceptions import ConfigurationError
    from ..models.registry import sam_model_registry
    from ..models.sam import make_clip_segmentor

    from ..train.checkpoint import model_kwargs_of_run

    num_cls = 9
    run_args = {}
    args_path = os.path.join(checkpoint_dir, "args.json")
    if os.path.exists(args_path):
        with open(args_path) as f:
            run_args = json.load(f)
        num_cls = int(run_args.get("num_cls", num_cls))
        arch = run_args.get("arch", arch)

    if model_dtype not in ("float32", "bfloat16", "int8"):
        raise ConfigurationError(
            f"model_dtype must be one of float32/bfloat16/int8, "
            f"got {model_dtype!r}")
    mesh = None
    if data_axis and data_axis > 1:
        from ..core import resolve_device
        from ..parallel.mesh import make_mesh

        cpu = resolve_device(device).type == "cpu"
        mesh = make_mesh(data_axis=data_axis, model_axis=1,
                         devices=["cpu"] if cpu else None)
    torch_ckpt = os.path.join(checkpoint_dir, "checkpoint_best.pth")
    if not os.path.exists(torch_ckpt):
        if os.path.isdir(os.path.join(checkpoint_dir, "checkpoint_best")):
            raise NotImplementedError(
                f"{checkpoint_dir} holds an orbax checkpoint_best/ snapshot "
                "of the JAX trainer and no checkpoint_best.pth: reading "
                "orbax needs JAX, which the port does not import. The "
                "port's trainer (ROADMAP.md, queue 1, item 8) writes "
                "checkpoint_best.pth: train with cli.train, or convert the "
                "snapshot with the JAX package")
        logger.warning("no checkpoint_best.pth in %s: the segmentor has "
                       "seeded random weights", checkpoint_dir)
        torch_ckpt = None

    dtype = torch.float32 if model_dtype == "float32" else torch.bfloat16
    model = sam_model_registry[arch](num_classes=num_cls,
                                     checkpoint=torch_ckpt, dtype=dtype,
                                     device=device,
                                     **model_kwargs_of_run(run_args))
    # a sharded segmentor needs a micro-batch divisible by the data axis
    kw = {} if mesh is None else dict(mesh=mesh)
    mb = 4 if mesh is None else -(-4 // data_axis) * data_axis
    if model_dtype == "int8":
        kw["weights_int8"] = True
    return make_clip_segmentor(model, micro_batch=mb, **kw)


def main(argv=None, *, _save_fn=None) -> int:
    """Run the CLI; returns 1 when any file failed, else 0. ``_save_fn``
    goes through process_folder to process_video (see its docstring): a
    check can capture what would be written where h5py is absent."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    parser = build_parser()
    args = parser.parse_args(argv)
    pipeline_cfg = _apply_pipeline_config(args, parser)

    from ..core import enable_compilation_cache, resolve_device
    from ..flow.pipeline import process_folder
    from ..utils import get_stage_report
    from ..utils.tracing import get_counters

    device = resolve_device(args.device)
    cache_dir = args.compilation_cache_dir
    if cache_dir is None and pipeline_cfg is not None:
        cache_dir = pipeline_cfg.device.compilation_cache_dir
    if cache_dir:
        enable_compilation_cache(cache_dir)

    segmentor = None
    if args.mode != "otsu":
        if args.checkpoint_dir is None:
            raise SystemExit("--checkpoint_dir is required for SAM modes")
        dev = pipeline_cfg.device if pipeline_cfg is not None else None
        segmentor = load_segmentor(
            args.checkpoint_dir, args.arch,
            model_dtype=dev.model_dtype if dev else "bfloat16",
            data_axis=dev.data_axis if dev else None, device=device)

    extra = {}
    if pipeline_cfg is not None:
        extra["config"] = pipeline_cfg.flow
        if pipeline_cfg.save_mask_subset is not None:
            extra["save_mask_subset"] = pipeline_cfg.save_mask_subset
    if _save_fn is not None:
        extra["_save_fn"] = _save_fn

    all_errors = []
    for chunk_index in range(args.nchunks):
        save_folder = os.path.join(args.save_folder, f"chunk{chunk_index}")
        errors = process_folder(
            args.dcm_folder, save_folder, segmentor,
            nchunks=args.nchunks, chunk_index=chunk_index,
            recalculate=args.recalculate, verbose=args.verbose,
            mode=args.mode, bkgd_comp=args.bkgd_comp, flipLR=args.flipLR,
            no_saliency=not args.saliency, OF_algo=args.of_algo,
            include_waveforms=args.include_waveforms,
            waveform_folder=args.waveform_folder, device=device, **extra)
        all_errors.extend(errors)

    report = get_stage_report()
    if report:
        logger.info("stage timings (total, self s): %s; counters: %s",
                    {k: (round(v["total_s"], 2), round(v["self_s"], 2))
                     for k, v in report.items()}, get_counters())
    if all_errors:
        logger.warning("%d files failed", len(all_errors))
    return 1 if all_errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
