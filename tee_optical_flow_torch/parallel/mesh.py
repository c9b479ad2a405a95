"""The device mesh and the cohort's work split (the JAX package's
parallel/mesh.py).

The JAX package's mesh is single-controller: one process drives every
device of a ``jax.sharding.Mesh``, and XLA partitions a program over its
('data', 'model') axes. The port keeps that shape without XLA: a
``Mesh`` is a ('data', 'model') grid of ``torch.device``s inside one
process, and the code that runs on it (``flow/pipeline.
compute_clip_flow_sharded``, ``models/sam.make_clip_segmentor(mesh=)``)
splits its leading axis over the data axis and runs each chunk on its
device. No process group is needed for that; ``initialize_distributed``
is the multi-host bring-up only.

Unlike a JAX mesh, a mesh here may name one device more than once: torch
has one CPU device, and ``["cpu"] * 8`` is how the tests stand in for the
JAX package's 8-device CPU mesh. On one card, ``["cuda:0", "cuda:0"]``
runs two shards one after the other.

The embarrassingly-parallel cohort sharding (nchunks file splits,
calculate_optical_flow.py:266-269) maps to ``host_shard_list``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exceptions import ShardingError

AXIS_NAMES = ("data", "model")


class Mesh:
    """A ('data', 'model') grid of torch devices: ``devices`` is the
    (data, model) object array, ``shape`` the dict {'data': n, 'model':
    m}, as a JAX mesh's. Work split over the data axis runs on
    ``data_devices``, the first device of each data row (the model axis
    holds replicas: nothing in the port shards weights yet)."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXIS_NAMES, devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


@dataclass(frozen=True)
class NamedSharding:
    """How an array lies on a mesh: ``spec`` names the mesh axis each
    leading dimension is split over (None: whole), as JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``; () is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def _cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass the devices (for example "
            "['cpu'] * 8) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    """``d`` as a torch.device; a card without an index is the current
    one, so that it compares equal to the device a tensor reports."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(data_axis: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'model') mesh over ``devices`` (every card by
    default; without a card, raise)."""
    devices = [_device(d) for d in
               (devices if devices is not None else _cards())]
    n = len(devices)
    if data_axis is None:
        if n % model_axis:
            raise ShardingError(
                f"{n} devices not divisible by model_axis={model_axis}")
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ShardingError(
            f"mesh {data_axis}x{model_axis} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data_axis, model_axis))


def batch_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (batch/frame) axis over 'data'."""
    return NamedSharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _shard(mesh: Mesh, x) -> Tuple[torch.Tensor, ...]:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    n = mesh.shape["data"]
    if t.ndim == 0 or t.shape[0] % n:
        raise ValueError(
            f"sharding {batch_sharding(mesh, max(t.ndim, 1)).spec} of a "
            f"{tuple(t.shape)} array needs a leading dimension divisible "
            f"by the data axis ({n})")
    return tuple(c.to(d) for c, d in zip(t.chunk(n), mesh.data_devices))


def shard_batch(mesh: Mesh, batch: Any):
    """Split every array of a batch pytree (dicts, lists and tuples of
    tensors or numpy arrays) along its leading axis over the data axis:
    each leaf becomes a tuple of ``mesh.shape['data']`` chunks, chunk k on
    ``mesh.data_devices[k]``. Padding is the caller's job: a leading
    dimension not divisible by the data axis raises ValueError, as the JAX
    package's ``device_put`` does."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return _shard(mesh, batch)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> None:
    """Multi-host bring-up (the gloo init_process_group equivalent):
    ``torch.distributed`` over ``tcp://{coordinator_address}`` (host:port)
    with ``num_processes`` ranks, this one ``process_id``; nccl on the
    cards, gloo when ``device`` is the CPU. No-op for single-process
    runs."""
    if num_processes is None or num_processes <= 1:
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    torch.distributed.init_process_group(
        backend="gloo" if cpu else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def host_shard_list(items: Sequence, nchunks: int, chunk_index: int) -> List:
    """Deterministic nchunks split of a work list (the reference's batch-job
    sharding pattern); no in-band communication."""
    arr = np.array_split(np.asarray(list(items), dtype=object), nchunks)
    if chunk_index >= len(arr):
        return []
    return list(arr[chunk_index])
