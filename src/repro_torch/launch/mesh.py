"""The data mesh of sharded serving: an ordered list of devices.

The reservoir is frozen and replicated (the paper's premise), so a serving
mesh carries no model axis — just ``n_shards`` data shards, shard ``k`` on
``devices[k]``.  Unlike the JAX package's ``jax.sharding.Mesh``, a device
may appear more than once: that is how N shards share one card (or the
CPU, in the tests), this package's counterpart of
``--xla_force_host_platform_device_count``.  Shards that share a device
run one after another on it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["DataMesh", "local_devices", "make_data_mesh"]


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
