"""Device meshes: the LM substrate's (data, model) mesh and the data mesh
of sharded serving.

The LM mesh (:class:`LMMesh`, :func:`make_production_mesh`,
:func:`make_host_mesh`, :func:`make_mesh`) wraps a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, one process
per device as ``torch.distributed`` runs (the JAX package drives every
device of a host from one process).  It exposes ``axis_names`` and a
``shape`` mapping, which is all the sharding rules read, and its
``device_mesh`` carries the DTensors: on a ``("pod", "data", "model")``
mesh that one has a single dim of pod x data ranks, pod outer, beside
'model' (``parallel/sharding.mesh_dims``), and the named mesh over the
same ranks gives the coordinates and each axis's process group.  The
caller sets up the process
group first (``torch.distributed.init_process_group`` with its store,
world size and rank); a CUDA mesh needs the NCCL backend and one card per
process, a CPU mesh gloo.  The dry run's mesh runs over a fake process
group (:func:`fake_world`: any world size, this process its rank 0, no
device behind the other ranks): its collectives return at once and move
nothing, and its mesh is CPU-typed whatever device is asked for, because
the dry run's tensors are fake (shapes only).  :class:`AbstractMesh` has
names and sizes only (no process group): the rules run on it for a mesh
that does not exist on this host, such as the 256-chip production mesh.

The reservoir is frozen and replicated (the paper's premise), so a serving
mesh carries no model axis — just ``n_shards`` data shards, shard ``k`` on
``devices[k]``.  Unlike the JAX package's ``jax.sharding.Mesh``, a device
may appear more than once: that is how N shards share one card (or the
CPU, in the tests), this package's counterpart of
``--xla_force_host_platform_device_count``.  Shards that share a device
run one after another on it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.device import resolve_device

__all__ = ["AbstractMesh", "DataMesh", "LMMesh", "fake_world",
           "local_devices", "make_data_mesh", "make_host_mesh", "make_mesh",
           "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (the port's
    ``jax.sharding.AbstractMesh(axis_sizes, axis_names)``)."""

    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError("one size per axis name")
        object.__setattr__(self, "axis_sizes",
                           tuple(int(n) for n in self.axis_sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """A named ``DeviceMesh`` over this process group (one rank per
    device); ``axis_names`` and ``shape`` as the rules read them.

    ``device_mesh`` carries the DTensors: one dim per named axis, but
    'pod' and 'data' one dim together, pod outer (``sharding.mesh_dims``).
    Where the two differ, ``axis_mesh`` has one dim per named axis over
    the same ranks in the same order: the names, sizes, coordinates and
    the process group of each axis are read from it.  ``axis_mesh`` is
    ``None`` when the DTensor mesh is the named one (no 'pod')."""

    device_mesh: object
    axis_mesh: object = None

    @property
    def _named(self):
        return self.device_mesh if self.axis_mesh is None else self.axis_mesh

    @property
    def axis_names(self) -> tuple:
        return tuple(self._named.mesh_dim_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._named.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        if self.device_mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_mesh.device_type)

    def coordinate(self) -> dict:
        """This rank's index along each named axis."""
        return dict(zip(self.axis_names, self._named.get_coordinate()))

    def axis_group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``."""
        return self._named.get_group(axis)


def _lm_mesh(device_type: str, shape: tuple, axis_names: tuple,
             ranks=None) -> LMMesh:
    """The named mesh and, where 'pod' and 'data' share a DTensor mesh
    dim, the DTensor mesh beside it, both row-major over the same ranks:
    rank ``r`` at the same place in both.  ``ranks`` (an array of the
    mesh's shape) builds it over some ranks of the world, which every
    rank of the world must then call; ``None`` takes every rank."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.parallel.sharding import mesh_dim_sizes, mesh_dims

    names = tuple(axis_names)

    def mesh(sizes, dim_names):
        if ranks is None:
            return init_device_mesh(device_type, tuple(sizes),
                                    mesh_dim_names=dim_names)
        return DeviceMesh(device_type, torch.as_tensor(ranks).reshape(sizes),
                          mesh_dim_names=dim_names)

    named = mesh(shape, names)
    abstract = AbstractMesh(tuple(shape), names)
    dims = mesh_dims(abstract)
    if len(dims) == len(names):
        return LMMesh(named)
    merged = mesh(mesh_dim_sizes(abstract), tuple("_".join(g) for g in dims))
    return LMMesh(merged, named)


def make_mesh(shape: tuple, axis_names: tuple, device=None) -> LMMesh:
    """An :class:`LMMesh` of ``shape`` over the initialised process group,
    whose world size must equal the mesh's size.  ``device`` picks the
    device type (``None`` = ``cuda``, raising without one): a CUDA mesh
    needs the NCCL backend and sets each rank's card to its local rank
    (the rank modulo the visible cards), a CPU mesh runs on gloo.  Over a
    fake process group (:func:`fake_world`) the mesh is CPU-typed and
    ``device`` is not read."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh runs over a process group: call "
            "torch.distributed.init_process_group(backend, init_method=, "
            "world_size=, rank=) in every rank first")
    size = math.prod(shape)
    if dist.get_world_size() != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks, the "
                         f"process group has {dist.get_world_size()}")
    backend = dist.get_backend()
    if backend == "fake":
        return _lm_mesh("cpu", shape, axis_names)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"a CUDA mesh runs on NCCL, the process "
                               f"group's backend is {backend}")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif backend != "gloo":
        raise RuntimeError(f"a CPU mesh runs on gloo, the process group's "
                           f"backend is {backend}")
    return _lm_mesh(dev.type, shape, axis_names)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks for the dry run, this
    process its rank 0 (no other rank exists: collectives return at once
    with outputs of the right shape and move nothing), destroyed on exit.
    A process holds one group at a time: the dry run runs each cell of
    another mesh size in a process of its own."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_group(device=None):
    """A process group of one rank for a mesh of this process alone, such
    as :func:`make_host_mesh`'s with one card: NCCL for a CUDA ``device``
    (the default), gloo for the CPU, over a file store in a temporary
    directory, destroyed on exit.  A group that is open already is used
    as it is and left open."""
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LMMesh:
    """The assignment's target: 16x16 = 256 chips/pod; 2 pods multi-pod.
    Raises unless the process group holds 256 (512) ranks (the dry run's
    :func:`fake_world` does); the rules on this mesh without the ranks
    take ``AbstractMesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device=None) -> LMMesh:
    """``(n, 1)`` ``("data", "model")`` mesh over this host: ``n`` is every
    visible CUDA device (the default; raises without one), one rank each,
    or with ``device="cpu"`` the process group's ranks."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n, 1), ("data", "model"), dev)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D ``('data',)`` mesh: one device per shard, in shard order."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a data mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> tuple:
        return ("data",)

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}


def local_devices(device=None) -> list:
    """The devices of one type on this host: every visible CUDA device
    (the default; raises without one, as :func:`resolve_device` does), or
    ``[cpu]``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_data_mesh(n_shards: int | None = None, devices=None) -> DataMesh:
    """1-D ``('data',)`` mesh for batch-axis sharded serving: ``n_shards``
    data shards over the first ``n_shards`` of ``devices`` (all of them
    by default; ``local_devices()`` when no list is given).  ``devices``
    pins an explicit device list, which is how the elastic path builds
    the shrunk mesh from the survivors; it may repeat a device."""
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_shards is not None:
        if len(devices) < n_shards:
            raise ValueError(f"need {n_shards} devices, have {len(devices)}")
        devices = devices[:n_shards]
    return DataMesh(tuple(devices))
