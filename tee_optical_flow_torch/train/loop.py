"""SAM fine-tuning loop: AdamW with warmup -> poly and layer decay, on one
card (the JAX package's train/loop.py).

Parity with reference SingleGPU_train_finetune_noprompt.py:45-190: AdamW
(betas (0.9, 0.999), eps 1e-8, weight decay ``cfg.weight_decay``), Dice +
CE loss, eval every ``eval_interval`` epochs with dice_coeff_multi_class,
the best-DSC checkpoint, the 20-stale-epoch early stop, and the
tensorboard scalars info/lr, info/total_loss, info/loss_ce,
info/loss_dice, eval/loss and eval/dice.

The JAX package's parameter-tree partitions become ``requires_grad`` and
the optimizer's parameter list:
  vanilla   everything trains (the encoder optionally frozen)
  adapter   only parameters of an ``*Adapter*`` module train
  lora      only the LoRA factors train; the train step runs the model on
            base + delta weights (models/lora.merge_lora) through
            ``torch.func.functional_call``.
Frozen parameters are outside the optimizer, so they get no weight decay,
as in optax, where only the trainable tree enters the transform.

``TrainOptimizer`` is the JAX package's ``optax.adamw(schedule)``, chained
with the layer-decay scale and wrapped in ``optax.MultiSteps(k)`` when
``grad_accum = k > 1``: ``torch.optim.AdamW`` with one parameter group
per layer-decay scale (the scale is the group's lr factor), a ``LambdaLR``
stepping the schedule once per applied update, and gradients averaged
over k micro-steps (MultiSteps' running mean) before each update.

The train step normalises the encoder's batch norms by the batch
(models/common.Conv2d_BN) and commits their running statistics once after
the backward; with ``remat`` the forward runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), whose
recompute leaves the statistics as they were.

Training on several cards (the JAX package's ('data', 'model') mesh) is
not ported yet: ``mesh_data_axis > 1`` or a mesh raises.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..config import TrainConfig
from ..core import resolve_device
from ..models.common import commit_batch_stats
from ..models.lora import merge_lora
from ..utils import safe_makedir
from .losses import combined_loss, dice_coeff_multi_class
from .schedule import tinyvit_lr_scale_for_name, warmup_poly_schedule

logger = logging.getLogger(__name__)

_MULTI_CARD = ("training on several cards (the JAX package's ('data', "
               "'model') mesh, DDP here) is not ported yet: ROADMAP.md, "
               "queue 1, item 6")


# ---------------------------------------------------------------------------
# parameter partitioning (freeze policies)
# ---------------------------------------------------------------------------

# the reference TinyViT's classifier head: SAM never runs it (the JAX
# package's model does not hold it), so it never trains
_UNUSED = ("image_encoder.norm_head.", "image_encoder.head.")


def trainable_predicate(finetune_type: str, if_update_encoder: bool
                        ) -> Callable[[str], bool]:
    """name -> whether the model parameter ``name`` trains."""
    if finetune_type not in ("vanilla", "adapter", "lora"):
        raise ValueError(f"unknown finetune_type {finetune_type}")

    def pred(name: str) -> bool:
        if name.startswith(_UNUSED):
            return False
        if finetune_type == "adapter":
            return "adapter" in name.lower()
        if finetune_type == "vanilla":
            return if_update_encoder or not name.startswith("image_encoder.")
        return False  # lora: the base weights are all frozen

    return pred


def partition_params(model: nn.Module, pred: Callable[[str], bool]):
    """Set ``requires_grad`` by ``pred``; returns (trainable, frozen) as
    lists of (name, parameter)."""
    trainable, frozen = [], []
    for name, p in model.named_parameters():
        keep = bool(pred(name))
        p.requires_grad_(keep)
        (trainable if keep else frozen).append((name, p))
    return trainable, frozen


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainConfigRuntime:
    """Resolved runtime bundle built from a TrainConfig."""

    cfg: TrainConfig
    device: torch.device
    schedule: Callable[[int], float]


def build_runtime(cfg: TrainConfig, steps_per_epoch: int, device=None,
                  mesh=None) -> TrainConfigRuntime:
    if mesh is not None or (cfg.mesh_data_axis or 1) > 1:
        raise NotImplementedError(_MULTI_CARD)
    max_iters = cfg.epochs * max(steps_per_epoch, 1)
    schedule = (warmup_poly_schedule(cfg.lr, cfg.warmup_period, max_iters,
                                     cfg.poly_power)
                if cfg.warmup else (lambda step: cfg.lr))
    return TrainConfigRuntime(cfg=cfg, device=resolve_device(device),
                              schedule=schedule)


class TrainOptimizer:
    """AdamW + schedule + layer decay + gradient accumulation over named
    parameters (see the module docstring). ``step()`` reads each
    parameter's ``.grad``: it returns True when it applied an update,
    False on an accumulating micro-step."""

    def __init__(self, named_params: List[Tuple[str, torch.Tensor]],
                 runtime: TrainConfigRuntime) -> None:
        cfg = runtime.cfg
        groups: Dict[float, List[torch.Tensor]] = {}
        for name, p in named_params:
            scale = (tinyvit_lr_scale_for_name(name, cfg.layer_lr_decay)
                     if cfg.layer_lr_decay != 1.0 else 1.0)
            groups.setdefault(scale, []).append(p)
        self.params = [p for _, p in named_params]
        # each group's lr is its scale; the LambdaLR factor is the
        # schedule, so a group steps at scale * schedule(count)
        self.opt = torch.optim.AdamW(
            [{"params": ps, "lr": scale} for scale, ps in groups.items()],
            lr=1.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda count: runtime.schedule(count))
        self.k = max(int(cfg.grad_accum), 1)
        self.mini_step = 0
        self.acc: List[Optional[torch.Tensor]] = [None] * len(self.params)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> bool:
        if self.k > 1:
            n = self.mini_step
            for i, p in enumerate(self.params):
                if p.grad is None:
                    continue
                acc = self.acc[i]
                if acc is None:
                    acc = torch.zeros_like(p.grad)
                # MultiSteps' running mean: acc + (g - acc) / (n + 1)
                self.acc[i] = acc + (p.grad - acc) / (n + 1)
            self.mini_step += 1
            if self.mini_step < self.k:
                self.zero_grad()
                return False
            for p, acc in zip(self.params, self.acc):
                p.grad = acc
            self.acc = [None] * len(self.params)
            self.mini_step = 0
        self.opt.step()
        self.sched.step()
        self.zero_grad()
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.opt.state_dict(),
                "scheduler": self.sched.state_dict(),
                "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["optimizer"])
        self.sched.load_state_dict(state["scheduler"])
        self.mini_step = int(state["mini_step"])
        self.acc = [None if a is None else a.to(p.device)
                    for a, p in zip(state["acc"], self.params)]


# ---------------------------------------------------------------------------
# train / eval steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """What a train step reads and moves: the model (its frozen and
    trainable parameters and its batch statistics), the LoRA factors of a
    LoRA run, the trainable (name, tensor) list and the optimizer."""

    model: nn.Module
    lora: Optional[Dict[str, Dict[str, torch.Tensor]]]
    trainable: List[Tuple[str, torch.Tensor]]
    optimizer: TrainOptimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "lora": self.lora,
                "optimizer": self.optimizer.state_dict(),
                "generator": torch.get_rng_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        if self.lora is not None:
            with torch.no_grad():
                for site, fac in self.lora.items():
                    for k, t in fac.items():
                        t.copy_(state["lora"][site][k])
        self.optimizer.load_state_dict(state["optimizer"])
        torch.set_rng_state(state["generator"])


def _to_device(images, labels, boxes, device):
    """Host NHWC images -> NCHW on the device; labels as int64."""
    x = torch.as_tensor(np.asarray(images)).to(device)
    x = x.permute(0, 3, 1, 2).contiguous()
    y = torch.as_tensor(np.asarray(labels)).to(device).long()
    if boxes is not None:
        boxes = torch.as_tensor(np.asarray(boxes), dtype=torch.float32
                                ).to(device)
    return x, y, boxes


def _forward(model, lora, heads_by_dim, images, boxes, train: bool):
    kw = dict(boxes=boxes, multimask_output=True, train=train)
    if lora is None:
        return model(images, **kw)
    merged = merge_lora(dict(model.named_parameters()), lora, heads_by_dim)
    return torch.func.functional_call(model, merged, (images,), kw)


def make_train_step(model: nn.Module, runtime: TrainConfigRuntime, *,
                    finetune_type: str = "vanilla",
                    if_update_encoder: bool = True,
                    heads_by_dim: Optional[Dict[int, int]] = None,
                    remat: bool = False):
    """Returns (init_state, train_step).

    ``init_state(lora_params=None) -> TrainState`` partitions the model's
    parameters (LoRA: ``lora_params`` from models/lora.init_lora) and
    builds the optimizer; it raises ValueError when the policy selects no
    parameter. ``train_step(state, images, labels, boxes=None)`` takes
    host batches (images (B, S, S, 3) normalised, labels (B, out, out)
    int, and for box-prompted fine-tuning boxes (B, 4) in pixels of the
    S x S image, the reference's SingleGPU_train_finetune_box), runs the
    forward and backward, commits the batch statistics, steps the
    optimizer and returns the detached metrics {total_loss, loss_dice,
    loss_ce}. ``train_step.loss_and_grads`` does the same without the
    optimizer step and returns (metrics, {name: grad})."""
    device = runtime.device

    def loss_fn(state, images, labels, boxes):
        def fwd(x, b):
            return _forward(state.model, state.lora, heads_by_dim, x, b,
                            True)[0]

        if remat:
            logits = torch.utils.checkpoint.checkpoint(
                fwd, images, boxes, use_reentrant=False)
        else:
            logits = fwd(images, boxes)
        return combined_loss(logits, labels)

    def backward(state, images, labels, boxes):
        x, y, b = _to_device(images, labels, boxes, device)
        total, ld, lc = loss_fn(state, x, y, b)
        total.backward()
        commit_batch_stats(state.model)
        return {"total_loss": total.detach(), "loss_dice": ld.detach(),
                "loss_ce": lc.detach()}

    def train_step(state: TrainState, images, labels, boxes=None):
        metrics = backward(state, images, labels, boxes)
        state.optimizer.step()
        return metrics

    def loss_and_grads(state: TrainState, images, labels, boxes=None):
        state.optimizer.zero_grad()
        metrics = backward(state, images, labels, boxes)
        grads = {n: p.grad.detach().clone() for n, p in state.trainable
                 if p.grad is not None}
        state.optimizer.zero_grad()
        return metrics, grads

    train_step.loss_and_grads = loss_and_grads

    def init_state(lora_params=None) -> TrainState:
        pred = trainable_predicate(finetune_type, if_update_encoder)
        trainable, _ = partition_params(model, pred)
        if finetune_type == "lora":
            trainable = [(f"lora/{site}/{k}", t)
                         for site, fac in (lora_params or {}).items()
                         for k, t in fac.items()]
        if not trainable:
            raise ValueError(
                f"finetune_type={finetune_type!r} selected ZERO trainable "
                "parameters — for 'adapter' the model must be built with "
                "adapter modules (adapter_stages/use_decoder_adapter), for "
                "'lora' pass init_lora factors")
        return TrainState(model=model,
                          lora=lora_params if finetune_type == "lora"
                          else None,
                          trainable=trainable,
                          optimizer=TrainOptimizer(trainable, runtime))

    return init_state, train_step


def make_eval_step(model: nn.Module, runtime: TrainConfigRuntime,
                   num_cls: int, finetune_type: str = "vanilla",
                   heads_by_dim: Optional[Dict[int, int]] = None):
    """``eval_step(state, images, labels) -> (total_loss, dsc)``: the
    model on the running statistics (``train=False``), no gradients."""
    device = runtime.device

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels):
        x, y, _ = _to_device(images, labels, None, device)
        logits, _ = _forward(state.model, state.lora, heads_by_dim, x, None,
                             False)
        total, _, _ = combined_loss(logits, y)
        pred = torch.argmax(logits, dim=1)
        return total, dice_coeff_multi_class(pred, y, num_cls)

    return eval_step


# ---------------------------------------------------------------------------
# the full loop
# ---------------------------------------------------------------------------

def _writer(cfg: TrainConfig):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.warning("tensorboardX unavailable — no tensorboard scalars "
                       "will be written")
        return None
    safe_makedir(os.path.join(cfg.dir_checkpoint, "log"))
    return SummaryWriter(os.path.join(cfg.dir_checkpoint, "log"))


def train_model(model: nn.Module, train_batches: Callable[[], Iterable],
                val_batches: Callable[[], Iterable], cfg: TrainConfig,
                steps_per_epoch: int, lora_params=None,
                heads_by_dim: Optional[Dict[int, int]] = None,
                writer=None, mesh=None, resume: bool = False,
                save_state_every: int = 0) -> Dict[str, Any]:
    """Run the fine-tuning loop on the model's device.
    ``train_batches``/``val_batches`` are callables returning fresh
    iterators of (images, labels) numpy batches per epoch. Returns
    {'model', 'lora', 'best_dsc', 'history'}. With ``resume`` the run
    continues from ``dir_checkpoint/train_state.pt`` where it exists;
    ``save_state_every`` writes it every that many epochs."""
    from .checkpoint import load_train_state, save_checkpoint, save_train_state

    device = next(model.parameters()).device
    runtime = build_runtime(cfg, steps_per_epoch, device, mesh)
    init_state, train_step = make_train_step(
        model, runtime, finetune_type=cfg.finetune_type,
        if_update_encoder=cfg.if_update_encoder, heads_by_dim=heads_by_dim,
        remat=cfg.remat)
    eval_step = make_eval_step(model, runtime, cfg.num_cls,
                               finetune_type=cfg.finetune_type,
                               heads_by_dim=heads_by_dim)
    state = init_state(lora_params)

    start_epoch = 0
    iter_num = 0
    if resume and os.path.exists(os.path.join(cfg.dir_checkpoint,
                                              "train_state.pt")):
        snapshot, start_epoch, iter_num = load_train_state(cfg.dir_checkpoint)
        state.load_state_dict(snapshot)
        logger.info("resumed from epoch %d (iter %d)", start_epoch, iter_num)

    if writer is None:
        writer = _writer(cfg)

    best_dsc = -1.0
    last_update_epoch = start_epoch
    history = []
    for epoch in range(start_epoch, cfg.epochs):
        epoch_loss = 0.0
        nsteps = 0
        t0 = time.perf_counter()
        for images, labels in train_batches():
            metrics = train_step(state, images, labels)
            epoch_loss += float(metrics["total_loss"])
            nsteps += 1
            iter_num += 1
            if writer is not None:
                writer.add_scalar("info/lr", float(runtime.schedule(iter_num)),
                                  iter_num)
                for key in ("total_loss", "loss_ce", "loss_dice"):
                    writer.add_scalar(f"info/{key}", float(metrics[key]),
                                      iter_num)
        train_loss = epoch_loss / max(nsteps, 1)
        logger.info("Epoch %d | train loss %.4f | %.1fs", epoch, train_loss,
                    time.perf_counter() - t0)

        if epoch % cfg.eval_interval == 0:
            eval_loss = 0.0
            dsc = 0.0
            n = 0
            for images, labels in val_batches():
                loss, d = eval_step(state, images, labels)
                eval_loss += float(loss)
                dsc += float(d)
                n += 1
            eval_loss /= max(n, 1)
            dsc /= max(n, 1)
            if writer is not None:
                writer.add_scalar("eval/loss", eval_loss, epoch)
                writer.add_scalar("eval/dice", dsc, epoch)
            logger.info("Eval Epoch %d | val loss %.4f | dsc %.4f",
                        epoch, eval_loss, dsc)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "eval_loss": eval_loss, "dice": dsc})
            if dsc > best_dsc:
                best_dsc = dsc
                last_update_epoch = epoch
                save_checkpoint(cfg.dir_checkpoint, model, cfg,
                                lora=state.lora, heads_by_dim=heads_by_dim)
            elif (epoch - last_update_epoch) > cfg.early_stop_patience:
                logger.info("Training finished (early stop at epoch %d)",
                            epoch)
                break

        if save_state_every and (epoch + 1) % save_state_every == 0:
            save_train_state(cfg.dir_checkpoint, state.state_dict(),
                             epoch + 1, iter_num)

    if writer is not None:
        writer.close()
    return {"model": model, "lora": state.lora, "best_dsc": best_dsc,
            "history": history}
