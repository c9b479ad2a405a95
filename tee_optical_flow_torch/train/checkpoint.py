"""Checkpoint persistence: the best-DSC snapshot, the run config and the
resume snapshot (the JAX package's train/checkpoint.py, with torch files
in place of its orbax snapshots).

Parity with the reference's artifacts: ``checkpoint_best.pth`` per run
(SingleGPU_train_finetune_noprompt.py:181-185) and ``args.json``
(:202-206), so that inference rebuilds the exact model
(calculate_optical_flow.py:673-693; the port's
``cli.process.load_segmentor``). ``checkpoint_best.pth`` is the model's
state dict under the reference torch keys; a LoRA run's is
``{"model": <base state dict>, "lora": <factors>, "heads_by_dim": ...}``,
which ``models/convert.load_torch_checkpoint`` merges on load. The resume
snapshot is ``train_state.pt`` (model, LoRA factors, optimizer,
scheduler, accumulation and torch RNG state) with ``train_progress.json``
(epoch, iteration) beside it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..config import TrainConfig
from ..utils import safe_makedir


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(dir_checkpoint: str, model: torch.nn.Module,
                    cfg: Optional[TrainConfig] = None,
                    lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                    heads_by_dim: Optional[Dict[int, int]] = None,
                    name: str = "checkpoint_best.pth") -> str:
    """Write ``model``'s state dict (with ``lora``'s factors, if any) as
    ``name`` and ``cfg`` as ``args.json``; returns the checkpoint path."""
    safe_makedir(dir_checkpoint)
    path = os.path.abspath(os.path.join(dir_checkpoint, name))
    state: Any = _cpu(dict(model.state_dict()))
    if lora is not None:
        state = {"model": state, "lora": _cpu(lora)}
        if heads_by_dim is not None:
            state["heads_by_dim"] = dict(heads_by_dim)
    torch.save(state, path)
    if cfg is not None:
        cfg.to_json(os.path.join(dir_checkpoint, "args.json"))
    return path


def load_run_config(dir_checkpoint: str) -> TrainConfig:
    """Rebuild the TrainConfig of a run (the reference reads args.json
    back as a Namespace, calculate_optical_flow.py:679-687)."""
    with open(os.path.join(dir_checkpoint, "args.json")) as f:
        return TrainConfig.from_dict(json.load(f))


def model_kwargs_of_run(run_args: Dict[str, Any]) -> Dict[str, Any]:
    """The registry builder's keyword arguments that an adapter run's
    args.json fixes beside ``num_cls`` and ``arch``: the adapter placement
    (vit_t stages, decoder); {} for other runs."""
    kw: Dict[str, Any] = {}
    if run_args.get("finetune_type") == "adapter":
        if run_args.get("if_encoder_adapter"):
            kw["adapter_stages"] = tuple(
                run_args.get("encoder_adapter_depths") or ())
        kw["use_decoder_adapter"] = bool(
            run_args.get("if_mask_decoder_adapter"))
    return kw


def save_train_state(dir_checkpoint: str, state: Dict[str, Any], epoch: int,
                     iter_num: int, name: str = "train_state.pt") -> str:
    """Mid-run resume snapshot including the optimizer state (a capability
    the reference lacks: its epoch_ini flag is unused, cfg.py:32).
    ``state`` is the trainer's dict of state dicts."""
    safe_makedir(dir_checkpoint)
    path = os.path.abspath(os.path.join(dir_checkpoint, name))
    torch.save(_cpu(state), path)
    with open(os.path.join(dir_checkpoint, "train_progress.json"), "w") as f:
        json.dump({"epoch": epoch, "iter_num": iter_num}, f)
    return path


def load_train_state(dir_checkpoint: str, name: str = "train_state.pt"):
    """(state, epoch, iter_num) saved by save_train_state."""
    path = os.path.abspath(os.path.join(dir_checkpoint, name))
    state = torch.load(path, map_location="cpu", weights_only=False)
    progress = {"epoch": 0, "iter_num": 0}
    ppath = os.path.join(dir_checkpoint, "train_progress.json")
    if os.path.exists(ppath):
        with open(ppath) as f:
            progress = json.load(f)
    return state, int(progress["epoch"]), int(progress["iter_num"])
