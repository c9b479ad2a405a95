"""A few train steps of one rank of a mesh, for comparing a mesh's steps
with the one-process step on the same global batches.

    parallel.launch.launch(run_steps, (specs,), devices=[...])

runs ``run_steps(specs)`` on every rank; ``run_steps(specs)`` in one
process with ``spec["devices"]`` of one entry is the reference. Each
spec of the list ``specs`` is a dict:

  model        ``{"arch": "vit_t", ...}`` (registry.build_sam_vit_t's
               keyword arguments) or ``{"arch": "tinyvit", "tinyvit":
               {...}, "sam": {...}}`` (a ``Sam`` over a ``TinyViT`` of
               those keyword arguments: the tests' small model)
  weights      path of a torch file holding {"model": state dict,
               "lora": LoRA factors or None}
  batches      path of a torch file holding {"train": [(images, labels,
               boxes), ...], "eval": (images, labels)} (numpy)
  boxes        True: the train steps take the boxes (else None)
  cfg          TrainConfig keyword arguments
  policy       make_train_step's finetune_type, if_update_encoder,
               heads_by_dim, remat
  mesh         (data, model); devices: the mesh's devices, row-major
  shard        True: split weights with sam_param_shardings
  steps        how many train steps to take (batches cycled)
  timed        how many more steps to time (0: none)
  light        True: leave out "params" and "snapshot" (and the reload)

Products and convolutions run in float32 (TF32 off).

It returns, for each spec, {"grads": the first step's gradients (on
``train[0]``; whole tensors), "stats": the running statistics after that
step, "losses": each step's total loss, "params": the trainable
parameters after the steps (whole), "snapshot": the
TrainState.state_dict() after them (whole), "reloaded": whether loading
it back (each rank taking its blocks, as a resume does) gave the model's
and the optimizer's state again bit for bit, "eval": (loss, dsc) on
``eval``, "batchnorms": how many batch norms the model has,
"cross_replica": how many of them are cross-replica ones, "split": the
names of the tensors split over the model axis, "ms": the median ms per
timed step (CUDA events on a card), "tally": parallel/collectives.TALLY
over one step, "max_memory_gb": the card's peak allocation, "backend":
the process group's backend ("" in one process)}.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..models.common import BatchNorm2d, CrossReplicaBatchNorm2d
from ..parallel import collectives
from ..parallel.mesh import make_mesh
from ..parallel.shardings import gather_tensor, sam_param_shardings
from . import loop


def _build(spec_model: Dict[str, Any]):
    from ..models.registry import build_sam_vit_t
    from ..models.sam import Sam
    from ..models.tinyvit import TinyViT

    kw = dict(spec_model)
    arch = kw.pop("arch")
    if arch == "vit_t":
        return build_sam_vit_t(device="cpu", **kw)
    return Sam(TinyViT(**kw["tinyvit"]), **kw["sam"])


def _median_ms(fn, reps: int, device: torch.device) -> float:
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _equal(a, b) -> bool:
    """Whether two state dicts hold the same keys and bit-equal tensors."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    return a == b


def run_steps(specs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """This rank's part of the comparisons (see the module docstring)."""
    return [_run(spec) for spec in specs]


def _run(spec: Dict[str, Any]) -> Dict[str, Any]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = torch.load(spec["weights"], weights_only=False)
    data = torch.load(spec["batches"], weights_only=False)
    n, m = spec["mesh"]
    mesh = make_mesh(n, m, devices=spec["devices"])
    model = _build(spec["model"])
    model.load_state_dict(weights["model"], strict=True)
    cfg = TrainConfig(**spec["cfg"])
    runtime = loop.build_runtime(cfg, spec["steps"], mesh=mesh)
    model.to(runtime.device)
    lora = weights.get("lora")
    if lora is not None:
        lora = {site: {k: v.to(runtime.device).requires_grad_(True)
                       for k, v in fac.items()}
                for site, fac in copy.deepcopy(lora).items()}
    policy = dict(spec["policy"])
    init, step = loop.make_train_step(
        model, runtime, param_sharding_fn=(sam_param_shardings
                                           if spec.get("shard") else None),
        **policy)
    state = init(lora)
    layout = getattr(model, "shard_layout", {})
    train = [(x, y, b if spec.get("boxes") else None)
             for x, y, b in data["train"]]

    def whole(name, t):
        return gather_tensor(t, layout.get(name)).detach().cpu().clone()

    metrics, local = step.loss_and_grads(state, *train[0])
    grads = {k: whole(k, v) for k, v in local.items()}
    stats = {k: v.detach().cpu().clone() for k, v in model.named_buffers()
             if "running_" in k}
    # the first step goes on from these gradients, as train_step would
    for name, p in state.trainable:
        p.grad = local.get(name)
    state.optimizer.step()
    losses = [float(metrics["total_loss"])] + [
        float(step(state, *train[k % len(train)])["total_loss"])
        for k in range(1, spec["steps"])]
    params = snapshot = reloaded = None
    if not spec.get("light"):
        params = {k: whole(k, v) for k, v in state.trainable}
        snapshot = state.state_dict()
        state.load_state_dict(snapshot)
        reloaded = _equal(state.state_dict(), snapshot)
    eval_loss, dsc = loop.make_eval_step(
        model, runtime, cfg.num_cls, finetune_type=policy.get(
            "finetune_type", "vanilla"),
        heads_by_dim=policy.get("heads_by_dim"))(state, *data["eval"])
    out = {"grads": grads, "losses": losses, "stats": stats,
           "params": params, "eval": (float(eval_loss), float(dsc)),
           "snapshot": snapshot, "reloaded": reloaded,
           "batchnorms": sum(isinstance(x, BatchNorm2d)
                             for x in model.modules()),
           "cross_replica": sum(isinstance(x, CrossReplicaBatchNorm2d)
                                for x in model.modules()),
           "split": sorted(layout),
           "backend": (dist.get_backend() if dist.is_initialized() else ""),
           "ms": None, "tally": None, "max_memory_gb": None}
    if spec.get("timed"):
        cuda = runtime.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        collectives.reset_tally()
        step(state, *train[0])
        out["tally"] = copy.deepcopy(collectives.TALLY)
        out["ms"] = _median_ms(lambda: step(state, *train[0]),
                               spec["timed"], runtime.device)
        if cuda:
            out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out
