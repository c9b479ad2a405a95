"""The device mesh and the cohort's work split (the JAX package's
parallel/mesh.py).

The JAX package's mesh is single-controller: one process drives every
device of a ``jax.sharding.Mesh``, and XLA partitions a program over its
('data', 'model') axes. The port keeps that shape without XLA: a
``Mesh`` is a ('data', 'model') grid of ``torch.device``s inside one
process, and the code that runs on it (``flow/pipeline.
compute_clip_flow_sharded``, ``models/sam.make_clip_segmentor(mesh=)``)
splits its leading axis over the data axis and runs each chunk on its
device. No process group is needed for that.

Training on a mesh runs one process per mesh entry instead
(``torch.distributed``, started by ``parallel/launch.py``): rank r is
entry r of ``mesh.devices.ravel()``, row-major, so its data index is
r // m and its model index r % m on a data x m mesh. ``process_mesh``
gives a rank its place and the groups of its two axes;
``initialize_distributed`` starts the process group, with nccl when every
rank has a card of its own and gloo on the CPU or when a card is named
more than once (nccl refuses two ranks on one card).

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
    ``data_devices``, the first device of each data row (in one process
    the model axis holds replicas; the trainer's ranks shard weights over
    it: parallel/shardings.py)."""

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


def backend_for(devices: Sequence) -> str:
    """nccl when every device is a card and no card is named twice, else
    gloo (the CPU, or several ranks on one card)."""
    devs = [torch.device(d) for d in devices]
    cards = {d.index or 0 for d in devs if d.type == "cuda"}
    return "nccl" if len(cards) == len(devs) else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, devices: Optional[Sequence] = None,
                           init_method: Optional[str] = None
                           ) -> Optional[str]:
    """Start ``torch.distributed`` with ``num_processes`` ranks, this one
    ``process_id``, over ``tcp://{coordinator_address}`` (host:port) or
    ``init_method`` (for example ``file://...``). The backend is
    ``backend_for(devices)`` when the mesh's ``devices`` are given, else
    gloo when ``device`` is the CPU and nccl otherwise; it is chosen once
    and returned. No-op (returns None) for single-process runs, as in
    the JAX package."""
    if num_processes is None or num_processes <= 1:
        return None
    if devices is not None:
        backend = backend_for(devices)
    else:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    torch.distributed.init_process_group(
        backend=backend,
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return backend


@dataclass
class ProcessMesh:
    """This process's place on a mesh of processes: its ``rank``, its
    ``data`` and ``model`` indices, its ``device`` (the mesh entry of its
    rank) and the groups of the ranks that share its model index
    (``data_group``: the data axis) and its data index
    (``model_group``); a group is None where its axis has size 1."""

    mesh: Mesh
    rank: int
    data: int
    model: int
    device: torch.device
    data_group: Any
    model_group: Any

    @property
    def n_data(self) -> int:
        return self.mesh.shape["data"]

    @property
    def n_model(self) -> int:
        return self.mesh.shape["model"]


_GROUPS: Dict[Tuple[int, int, int], Tuple[List[Any], List[Any]]] = {}


def _axis_groups(n: int, m: int):
    """(model groups by data index, data groups by model index), each made
    once per process group and mesh shape; every rank makes every group in
    the same order, as ``new_group`` requires."""
    dist = torch.distributed
    key = (id(dist.group.WORLD), n, m)
    if key not in _GROUPS:
        model_groups = [dist.new_group([d * m + j for j in range(m)])
                        if m > 1 else None for d in range(n)]
        data_groups = [dist.new_group([d * m + j for d in range(n)])
                       if n > 1 else None for j in range(m)]
        _GROUPS[key] = (model_groups, data_groups)
    return _GROUPS[key]


def process_mesh(mesh: Mesh) -> Optional[ProcessMesh]:
    """This rank's ``ProcessMesh`` on ``mesh``; None for a one-entry mesh.
    A mesh of more entries needs an initialised process group of as many
    ranks (``parallel/launch.launch`` or ``torchrun``), else
    ShardingError."""
    n, m = mesh.shape["data"], mesh.shape["model"]
    if n * m == 1:
        return None
    dist = torch.distributed
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != n * m:
        raise ShardingError(
            f"a {n}x{m} mesh trains with one process per entry: start "
            f"{n * m} ranks with tee_optical_flow_torch.parallel.launch."
            f"launch (or torchrun); this process group has {world}")
    rank = dist.get_rank()
    model_groups, data_groups = _axis_groups(n, m)
    return ProcessMesh(mesh=mesh, rank=rank, data=rank // m, model=rank % m,
                       device=_device(mesh.devices.ravel()[rank]),
                       data_group=data_groups[rank % m],
                       model_group=model_groups[rank // m])


def host_shard_list(items: Sequence, nchunks: int, chunk_index: int) -> List:
    """Deterministic nchunks split of a work list (the reference's batch-job
    sharding pattern); no in-band communication."""
    arr = np.array_split(np.asarray(list(items), dtype=object), nchunks)
    if chunk_index >= len(arr):
        return []
    return list(arr[chunk_index])
