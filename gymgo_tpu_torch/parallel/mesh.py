"""Device meshes for env-sharded stepping and learning on ``torch.distributed``
(counterpart of ``gymgo_tpu.parallel.mesh``).

A ``Mesh`` is an array of ``torch.device`` entries with named axes, and the
rank of the process that owns each entry.  The ``env`` axis shards the env
batch: pure data parallel, since a Go step has no cross-env communication, so
the sharded step makes no collective.  An optional ``model`` axis serves the
learner's tensor-parallel rule (``models.az_net.param_shardings``).

A device may repeat: ``make_mesh(devices=[torch.device("cpu")] * 8)`` is the
counterpart of JAX's 8 virtual CPU devices, ``[cuda:0] * 4`` four logical
shards of one card.  Across processes each rank owns a contiguous block of
the entries, so the ranks' rows follow each other in rank order.

Env shard ``i`` owns rows ``[i * B / E, (i + 1) * B / E)`` of a batch of B
envs over an env axis of size E, and lives on the first device of its index
along the env axis (the entries of other axes hold replicas, which step
nothing).  A batch on a mesh takes one of two forms: the global tensor, of
which each shard takes its rows (a view when it lies on the shard's device
already), or the list of the shards this process owns, in shard order
(``shard_states``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gymgo_tpu_torch.core.state import resolve_device
from gymgo_tpu_torch.utils.faulttol import chunk_seed

__all__ = [
    "ENV_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "Sharding",
    "make_mesh",
    "local_mesh",
    "env_sharding",
    "replicated",
    "shard_states",
    "fold_env_keys",
    "initialize_distributed",
    "process_index",
    "process_count",
    "all_reduce_sum",
    "all_gather_rows",
]

ENV_AXIS = "env"
MODEL_AXIS = "model"


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object ndarray of ``torch.device``, one axis per name in
    ``axis_names``; ``ranks``: an int ndarray of the same shape, the rank that
    owns each entry."""

    devices: np.ndarray
    axis_names: tuple
    ranks: np.ndarray

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _env_rows(self, array):
        if ENV_AXIS not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {ENV_AXIS!r} axis")
        axis = self.axis_names.index(ENV_AXIS)
        return np.moveaxis(array, axis, 0).reshape(self.shape[ENV_AXIS], -1)

    def env_shards(self) -> list:
        """``(device, rank)`` of each env shard, in shard order."""
        return list(zip(self._env_rows(self.devices)[:, 0], self._env_rows(self.ranks)[:, 0].tolist()))

    def local_shards(self) -> list:
        """``(shard index, device)`` of each env shard this process owns."""
        me = process_index()
        return [(i, dev) for i, (dev, rank) in enumerate(self.env_shards()) if rank == me]

    @property
    def is_local(self) -> bool:
        """Whether this process owns every entry (no other rank takes part)."""
        return bool((self.ranks == process_index()).all())

    def rows(self, index: int, batch: int) -> slice:
        """The rows env shard ``index`` owns of a global batch of ``batch``."""
        n = self.shape[ENV_AXIS]
        if batch % n != 0:
            raise ValueError(f"batch_size {batch} not divisible by env axis {n}")
        per = batch // n
        return slice(index * per, (index + 1) * per)

    def global_batch(self, local) -> int:
        """The global env count of ``local``: a global tensor, or the list of
        this process's (equal) shards."""
        if isinstance(local, list):
            return local[0].shape[0] * self.shape[ENV_AXIS]
        return local.shape[0]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on ``mesh``: ``spec`` names the mesh axis each leading
    dim is split over, ``None`` or a missing entry replicating it (a
    ``PartitionSpec``)."""

    mesh: Mesh
    spec: tuple

    def shard_rows(self, batch: int) -> list:
        """The rows each env shard holds, in shard order: its own block when
        the leading dim is split over the env axis, every row otherwise."""
        n = self.mesh.shape[ENV_AXIS]
        if self.spec[:1] == (ENV_AXIS,):
            return [self.mesh.rows(i, batch) for i in range(n)]
        return [slice(0, batch)] * n


def _default_local_devices() -> list:
    """The CUDA devices this process shards over: its own card when the
    process group runs NCCL (one card per rank), every visible card else."""
    resolve_device("cuda")
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (ENV_AXIS,),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over ``devices``, the global list in rank order, split evenly
    into one contiguous block per rank.

    The default is this process's CUDA devices times the world size (every
    rank holding the same devices).  With the default single axis, all
    entries shard the env batch; pass ``axis_sizes=(n_env, n_model)`` and
    ``axis_names=("env", "model")`` for an actor-learner layout."""
    world = process_count()
    if devices is None:
        devices = _default_local_devices() * world
    devices = [torch.device(d) for d in devices]
    if not devices or len(devices) % world != 0:
        raise ValueError(f"{len(devices)} devices do not split over {world} processes")
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    ranks = np.repeat(np.arange(world), len(devices) // world)
    return Mesh(arr.reshape(tuple(axis_sizes)), axis_names, ranks.reshape(tuple(axis_sizes)))


def local_mesh(device) -> Mesh:
    """A one-entry env mesh on ``device``, owned by this process alone."""
    arr = np.empty(1, dtype=object)
    arr[0] = torch.device(device)
    return Mesh(arr, (ENV_AXIS,), np.array([process_index()]))


def env_sharding(mesh: Mesh, ndim: int = 4) -> Sharding:
    """Split the leading (env batch) dim over the env axis; replicate the rest."""
    return Sharding(mesh, (ENV_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_states(states: torch.Tensor, mesh: Mesh) -> list:
    """The env shards of the full batch ``states`` that this process owns,
    each on its device, in shard order.  Every process passes the same full
    ``states``; a batch that does not divide over the env axis raises
    ``ValueError``."""
    return [states[mesh.rows(i, states.shape[0])].to(dev).contiguous() for i, dev in mesh.local_shards()]


def fold_env_keys(seed: int, batch_size: int) -> torch.Tensor:
    """Per-env 63-bit seeds, int64 ``(batch_size,)``, each from ``seed`` and
    the env's *global* index alone (``utils.faulttol.chunk_seed``'s mixing),
    so a shard's seeds do not depend on how the batch is sharded."""
    return torch.tensor([chunk_seed(seed, i) for i in range(batch_size)], dtype=torch.int64)


def _backend(device_type: str, num_processes: int, process_id: int, environ=os.environ):
    """``(backend, card)`` for a rank: ``("nccl", i)`` when ``device_type`` is
    CUDA and each rank on this host has a card of its own (the rank then binds
    card ``i``), else ``("gloo", None)``.

    The ranks on this host are ``LOCAL_WORLD_SIZE`` and this rank's place
    among them ``LOCAL_RANK``, as ``torchrun`` sets them; without them every
    rank runs on this host and its place is ``process_id``."""
    local = int(environ.get("LOCAL_WORLD_SIZE", num_processes))
    local_rank = int(environ.get("LOCAL_RANK", process_id))
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and dist.is_nccl_available() and cards >= local:
        return "nccl", local_rank % cards
    return "gloo", None


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    device="cuda",
    timeout_s: float = 120.0,
) -> str:
    """Join the default process group (the ``jax.distributed.initialize``
    passthrough): ``coordinator_address`` is ``host:port`` of rank 0 (or a
    ``tcp://`` URL).  Returns the backend.

    NCCL runs only when ``device`` is CUDA and each rank on this host has a
    card of its own (``_backend``: a run across machines gives each host's
    rank count in ``LOCAL_WORLD_SIZE``); otherwise gloo, which also takes
    several ranks on one card (NCCL refuses them).  A rank whose peer never
    arrives, or dies, fails after ``timeout_s``."""
    backend, card = _backend(resolve_device(device).type, num_processes, process_id)
    if card is not None:
        torch.cuda.set_device(card)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def _collective_copy(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` where ``group``'s backend takes it: the host for gloo
    (whose CUDA support depends on its build; a CUDA tensor goes through
    pinned memory), this rank's card for NCCL."""
    if dist.get_backend(group) == "gloo":
        if not x.is_cuda:
            return x.clone()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x)
    return x.to(torch.device("cuda", torch.cuda.current_device()), copy=True)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group when None),
    on ``x``'s device; ``x`` itself is left as it was."""
    buf = _collective_copy(x, group)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's equal-sized ``x`` concatenated on dim 0 in rank order,
    on ``x``'s device."""
    src = _collective_copy(x.contiguous(), group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)
