"""Mesh construction: the one place axis names are decided (the port of
``repro.launch.mesh``).

``MeshSpec`` is the axis-name contract in code: the coloring core's 1D
``workers`` mesh and the 2D ``batch × shard`` serving mesh come from a
spec, so ``core.comm.shard_axis_of`` and the callers agree on what each
axis means.  ``build`` makes a ``torch.distributed`` ``DeviceMesh`` over
the ranks of an initialised world, one rank per device: one graph shard
per rank, as the reference's ``shard_map`` puts one per device.

A world is joined with ``init_world``: NCCL on CUDA (one GPU per rank),
gloo only when the caller asks for the CPU.  A multi-GPU run starts one
process per GPU::

    torchrun --nproc-per-node=4 my_script.py   # calls init_world(), then
                                               # MeshSpec.worker(4).build()

The LM's layouts (``production``, ``local``, ``lm``) build the same way,
on ``data × model`` (and ``pod``): the LM then stores its leaves as this
rank's shards under ``plan_for_mesh`` of the mesh, and ``set_mesh`` (the
reference's ``compat.set_mesh``) makes a built mesh the ambient one that
the model's layers gather their weights on (``parallel.shard``).

Functions, not module constants: importing this module touches no
process group and no device.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.core.comm import AXIS, BATCH_AXIS, batch_axis_size
from repro_torch.parallel.shard import current_mesh, set_mesh  # noqa: F401


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh geometry: parallel ``shape`` / ``axes`` tuples.

    The spec is hashable and touches no device; ``build()`` makes the
    ``DeviceMesh``.  The classmethods are the repo's layouts: call sites
    do not invent axis names.
    """

    shape: tuple
    axes: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes} "
                             "differ in length")

    @classmethod
    def worker(cls, n_workers: int) -> "MeshSpec":
        """Flat 1-axis coloring mesh: every rank is one graph shard."""
        return cls((n_workers,), (AXIS,))

    @classmethod
    def coloring(cls, n_workers: int, batch: int = 1) -> "MeshSpec":
        """2D ``batch × shard`` coloring mesh (``batch=1`` is bitwise the
        1-axis path per shard; ``batch > 1`` splits the lanes of the
        batched pipeline over the batch axis)."""
        return cls((batch, n_workers), (BATCH_AXIS, AXIS))

    @classmethod
    def production(cls, *, multi_pod: bool = False) -> "MeshSpec":
        if multi_pod:
            return cls((2, 16, 16), ("pod", "data", "model"))
        return cls((16, 16), ("data", "model"))

    @classmethod
    def local(cls) -> "MeshSpec":
        """Degenerate 1-device smoke mesh (both axes size 1)."""
        return cls((1, 1), ("data", "model"))

    @classmethod
    def lm(cls, data: int, model: int, pod: int = 1) -> "MeshSpec":
        """An LM layout of ``pod × data × model`` ranks (no ``pod`` axis
        when ``pod`` is 1)."""
        if pod > 1:
            return cls((pod, data, model), ("pod", "data", "model"))
        return cls((data, model), ("data", "model"))

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    def build(self, device_type: str | None = None):
        """The ``DeviceMesh`` of this spec over the initialised world
        (``init_world``), whose size must be ``n_devices``.
        ``device_type`` defaults to ``"cuda"`` (raises without a GPU);
        ``"cpu"`` builds it over gloo ranks."""
        device_type = "cuda" if device_type is None else device_type
        if not dist.is_initialized():
            raise RuntimeError("no process group is initialised; call "
                               "launch.mesh.init_world first")
        if dist.get_world_size() != self.n_devices:
            raise ValueError(f"mesh {self.shape} needs {self.n_devices} ranks, "
                             f"the world has {dist.get_world_size()}")
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; build the mesh with "
                               "device_type='cpu' on gloo ranks")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, tuple(int(s) for s in self.shape),
                                mesh_dim_names=tuple(self.axes))


def init_world(backend: str | None = None, init_method: str | None = None, *,
               rank: int | None = None, world_size: int | None = None,
               timeout_s: float | None = None) -> torch.device:
    """Join this process to its world and return its device.

    ``backend`` defaults to NCCL, which needs a GPU (raises without one):
    the rank takes GPU ``LOCAL_RANK`` (else ``rank`` modulo the GPU
    count).  ``backend="gloo"`` runs the rank on the CPU.  ``rank`` and
    ``world_size`` default to ``$RANK`` / ``$WORLD_SIZE`` (torchrun sets
    them; else 0 and 1); ``init_method`` to ``env://`` (torchrun's
    rendezvous), a ``file://`` path also works without a network.
    """
    backend = "nccl" if backend is None else backend
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a GPU and CUDA is not available; "
                               "pass backend='gloo' to run the ranks on the "
                               "CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    timeout = (None if timeout_s is None
               else datetime.timedelta(seconds=timeout_s))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    return device


def make_worker_mesh(n_workers: int | None = None,
                     device_type: str | None = None):
    """Flat 1-axis coloring mesh (default: every rank of the world)."""
    n = n_workers or dist.get_world_size()
    return MeshSpec.worker(n).build(device_type)


def make_coloring_mesh(n_workers: int | None = None, batch: int = 1,
                       device_type: str | None = None):
    """2D ``(batch, workers)`` coloring mesh of ``batch × n_workers``
    ranks; ``batch`` splits the lanes of ``color_many_sharded`` and of the
    serving engines, and a solo graph is replicated over it."""
    n = n_workers or dist.get_world_size() // batch
    return MeshSpec.coloring(n, batch).build(device_type)


def make_local_mesh(device_type: str | None = None):
    """Degenerate one-rank mesh (both axes size 1)."""
    return MeshSpec.local().build(device_type)


def engine_lanes(mesh, lanes: int) -> int:
    """Lanes a serving engine on ``mesh`` (a ``DeviceMesh``, a
    ``MeshSpec`` or ``None``) allocates: ``lanes`` rounded up to a multiple
    of the batch axis, whose ranks split them; ``None`` and 1D meshes keep
    it (at least 1)."""
    lanes = max(1, int(lanes))
    if mesh is None:
        return lanes
    b = batch_axis_size(mesh)
    return -(-lanes // b) * b
