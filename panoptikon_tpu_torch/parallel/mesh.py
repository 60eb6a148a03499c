"""Device meshes for the sharded index — the port of
``panoptikon_tpu/parallel/mesh.py``.

The corpus axis of an embedding space is sharded over the mesh's ``shard``
axis; queries are replicated, or split over ``replica`` on a 2-D serving
mesh. A :class:`Mesh` is a NumPy grid of ``torch.device``s with axis names;
each of its entries holds one shard (a separate slab of device memory), so
one device may appear more than once: four shards on one card are four
slabs, each scanned by its own launch. :func:`devices` is the port's
``jax.devices()``: the list :func:`set_devices` installed, else every CUDA
device of the process, else none (a CPU caller names its devices, as the
tests do with ``set_devices([cpu] * 8)``).

Across processes (``multihost.initialize``) a mesh spans every process's
devices in process order; each entry also records its process, and only
this process's entries hold tensors (``index/sharded.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"
DATA_AXIS = "data"
MODEL_AXIS = "model"


# Multi-host serving layout (panoptikon_tpu_torch.parallel.multihost):
# "replica" lays one full corpus replica per process (the shard merge stays
# inside the process); "shard" spans one global corpus across every device
# of every process. Selected at server startup from
# [parallel].multihost_layout.
_MULTIHOST_LAYOUT = "replica"

# The installed device list (None: every CUDA device of the process).
_DEVICES: Optional[list] = None


def set_multihost_layout(layout: str) -> None:
    global _MULTIHOST_LAYOUT
    if layout not in ("replica", "shard"):
        raise ValueError(f"unknown multihost layout {layout!r}")
    _MULTIHOST_LAYOUT = layout


def set_devices(devs: Optional[list]) -> None:
    """Install the devices :func:`devices` returns (None: back to every
    CUDA device). A device may repeat: each entry is one shard."""
    global _DEVICES
    _DEVICES = None if devs is None else [_named(d) for d in devs]


def _named(dev) -> torch.device:
    """``dev`` with its ordinal: a bare ``cuda`` is ``cuda:0``, as
    ``device.device`` names it."""
    dev = torch.device(dev)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


def devices() -> list:
    """This process's devices: the list :func:`set_devices` installed, else
    ``cuda:0`` … ``cuda:N-1``, else ``[]`` — never the CPU unasked."""
    if _DEVICES is not None:
        return list(_DEVICES)
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(eq=False)
class Mesh:
    """A grid of devices with named axes. ``processes``, where given, is the
    rank of the process that owns each entry (the same shape); without it
    every entry is this process's."""

    devices: np.ndarray
    axis_names: tuple
    processes: Optional[np.ndarray] = field(default=None)

    def __post_init__(self):
        grid = np.empty(np.shape(self.devices), dtype=object)
        for pos, dev in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            grid[pos] = torch.device(dev)
        self.devices = grid
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-D grid for axes {self.axis_names}")
        if self.processes is not None:
            self.processes = np.asarray(self.processes, dtype=np.int64)
            if self.processes.shape != grid.shape:
                raise ValueError("processes must have the grid's shape")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _grid(devices, shape=None) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid if shape is None else grid.reshape(shape)


def index_mesh(devs=None) -> Mesh:
    """Serving mesh for corpus sharding: 1-D over every device in a
    single-process runtime; across processes, the configured replica or
    shard layout (multihost.py)."""
    from panoptikon_tpu_torch.parallel import multihost

    if devs is None and multihost.process_count() > 1:
        if _MULTIHOST_LAYOUT == "replica":
            return multihost.hosts_replica_mesh()
        return multihost.hosts_shard_mesh()
    devs = devices() if devs is None else devs
    return Mesh(_grid(devs), (SHARD_AXIS,))


def serving_mesh(replicas: int, devs=None) -> Mesh:
    """2-D ``replica × shard`` serving mesh: the corpus shards over
    ``shard`` and replicates over ``replica``; a query batch splits over
    ``replica``, so QPS scales with the replicas while each shard's memory
    stays fixed."""
    devs = devices() if devs is None else devs
    n = len(devs)
    if n % replicas != 0:
        raise ValueError(f"{replicas} replicas do not divide {n} devices")
    return Mesh(_grid(devs, (replicas, n // replicas)), (REPLICA_AXIS, SHARD_AXIS))


def num_shards(mesh: Mesh) -> int:
    return mesh.shape.get(SHARD_AXIS, 0)


def serving_shards() -> int:
    """The shards an executor scans a space over: the index mesh's once a
    device list was installed (:func:`set_devices`; the server installs its
    ``--device`` list), else 1. Without an installed list an executor runs
    on its own device alone, however many CUDA devices the process sees."""
    return num_shards(index_mesh()) if _DEVICES is not None else 1
