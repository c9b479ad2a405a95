"""Start one process per mesh entry (port only: the JAX package's mesh is
single-controller).

    results = launch(fn, (arg, ...), devices=["cuda:0", "cuda:1"])

runs ``fn(*args)`` in ``len(devices)`` processes started with
``torch.multiprocessing`` (``spawn``), rank r on ``devices[r]`` (see
parallel/mesh.py for the rank <-> (data, model) map), inside a
``torch.distributed`` process group whose backend follows the devices
(``mesh.backend_for``: nccl when every rank has a card of its own, gloo
otherwise); it returns the ranks' return values in rank order. The ranks
meet through a file store in a temporary directory, so launches that run
at the same time never race for a port. ``fn`` must be importable by
name (a module-level function), and so must its arguments.

A rank that raises or dies makes ``launch`` raise LaunchError (the other
ranks are terminated); ranks still running after ``timeout`` seconds are
killed and LaunchError raised. Under ``torchrun`` (RANK and WORLD_SIZE
set) ``launch`` joins that process group, spawns nothing, and returns
this rank's value alone.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import initialize_distributed

logger = logging.getLogger(__name__)


class LaunchError(RuntimeError):
    """A rank failed, died or hung."""


def _set_device(device: str, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    d = torch.device(device)
    if d.type == "cuda":
        torch.cuda.set_device(d)


def _rank_main(rank: int, world: int, init_method: str,
               devices: List[str], fn: Callable, args: tuple, outdir: str,
               threads: Optional[int]) -> None:
    _set_device(devices[rank], threads)
    initialize_distributed(num_processes=world, process_id=rank,
                           devices=devices, init_method=init_method)
    try:
        out = fn(*args)
        tmp = os.path.join(outdir, f"rank{rank}.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple = (), *, devices: Sequence,
           timeout: float = 1800.0, threads: Optional[int] = None
           ) -> List[Any]:
    """``fn(*args)`` on one rank per device (see the module docstring).
    ``threads`` sets each spawned rank's ``torch.set_num_threads`` (by
    default, ranks on the CPU share its cores)."""
    devices = [str(d) for d in devices]
    world = len(devices)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        env_world = int(os.environ["WORLD_SIZE"])
        if env_world != world:
            raise LaunchError(f"torchrun started {env_world} ranks for a "
                              f"mesh of {world} entries")
        rank = int(os.environ["RANK"])
        _set_device(devices[rank], threads)
        if not dist.is_initialized():
            initialize_distributed(num_processes=world, process_id=rank,
                                   devices=devices, init_method="env://")
        return [fn(*args)]
    if world == 1:
        _set_device(devices[0], threads)
        return [fn(*args)]
    from .mesh import backend_for

    if threads is None and all(d == "cpu" for d in devices):
        threads = max(1, (os.cpu_count() or 1) // world)
    logger.info("launch: %d ranks on %s over %s", world, devices,
                backend_for(devices))
    mp = torch.multiprocessing
    with tempfile.TemporaryDirectory(prefix="tee_launch_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(world, init_method, devices, fn, tuple(args),
                              tmp, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        if p.is_alive():
                            p.kill()
                        p.join()
                    raise LaunchError(
                        f"ranks still running after {timeout:.0f} s: "
                        "killed")
        except mp.ProcessRaisedException as e:
            raise LaunchError(f"a rank raised:\n{e}") from None
        except mp.ProcessExitedException as e:
            raise LaunchError(f"a rank died: {e}") from None
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
