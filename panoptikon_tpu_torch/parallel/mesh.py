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
this process's entries hold tensors (``index/sharded.py``,
``parallel/train.py``).

:func:`train_mesh` is the ``data × model`` mesh of training. A
:class:`Placement` is the port's ``NamedSharding``: a mesh and a spec, one
entry a tensor axis (None, a mesh axis name, or a :class:`Split`), saying
which block of a tensor each mesh entry holds (:func:`corpus_sharding`,
:func:`replicated`, ``models.clip.param_shard_rules``).
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
    # Across processes, this process's gloo group along each axis
    # (``multihost.axis_groups``; train_mesh joins them).
    groups: dict = field(default_factory=dict)

    def __post_init__(self):
        grid = np.empty(np.shape(self.devices), dtype=object)
        for pos, dev in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            grid[pos] = _named(dev)
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


def train_mesh(data: Optional[int] = None, model: int = 1, devs=None) -> Mesh:
    """2-D ``data × model`` mesh for encoder training: the batch splits over
    ``data``, the block linears over ``model`` (``parallel/train.py``). An
    entry may repeat a device. Without ``devs``: :func:`devices` in one
    process (never the CPU unasked); across processes every process's
    devices in process order, one entry a process, with the gloo group of
    each axis joined here (every process calls this at the same point)."""
    from panoptikon_tpu_torch.parallel import multihost

    procs = None
    if devs is None and multihost.process_count() > 1:
        devs, procs = multihost.global_devices()
    devs = devices() if devs is None else devs
    n = len(devs)
    if not n:
        raise ValueError("a train mesh needs devices: none installed and no CUDA device")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    mesh = Mesh(_grid(devs, (data, model)), (DATA_AXIS, MODEL_AXIS),
                None if procs is None else np.asarray(procs).reshape(data, model))
    if procs is not None:
        mesh.groups = multihost.axis_groups(mesh)
    return mesh


def local_entries(mesh: Mesh) -> list:
    """(coordinates by axis name, device) of each entry this process holds,
    in grid order: every entry without ``processes``."""
    from panoptikon_tpu_torch.parallel import multihost

    rank = multihost.process_index()
    out = []
    for pos, dev in np.ndenumerate(mesh.devices):
        if mesh.processes is None or int(mesh.processes[pos]) == rank:
            out.append((dict(zip(mesh.axis_names, pos)), dev))
    return out


@dataclass(frozen=True)
class Split:
    """A tensor axis split over mesh axis ``axis`` inside each of ``parts``
    equal parts: entry c holds block c of every part, the parts in order.
    ``parts`` 3 splits a fused q | k | v axis per head."""

    axis: str
    parts: int = 1


@dataclass(frozen=True, eq=False)
class Placement:
    """Which block of a tensor each mesh entry holds: ``spec`` gives each
    leading tensor axis None (whole), a mesh axis name (contiguous blocks)
    or a :class:`Split`; axes past the spec are whole. At most one tensor
    axis is split."""

    mesh: Mesh
    spec: tuple = ()

    def _split(self):
        splits = [(dim, e if isinstance(e, Split) else Split(e))
                  for dim, e in enumerate(self.spec) if e is not None]
        if len(splits) > 1:
            raise ValueError(f"spec {self.spec} splits more than one axis")
        if splits and splits[0][1].axis not in self.mesh.axis_names:
            raise ValueError(f"spec {self.spec}: no axis {splits[0][1].axis!r} in "
                             f"{self.mesh.axis_names}")
        return splits[0] if splits else (None, None)

    def block(self, tensor: torch.Tensor, coords: dict) -> torch.Tensor:
        """The block of ``tensor`` the entry at ``coords`` holds (a view
        unless the split has several parts)."""
        dim, split = self._split()
        if split is None:
            return tensor
        n = self.mesh.shape[split.axis]
        if tensor.shape[dim] % (n * split.parts):
            raise ValueError(f"axis {dim} of {tuple(tensor.shape)} does not split into "
                             f"{split.parts} parts of {n} blocks")
        c = coords[split.axis]
        blocks = [part.chunk(n, dim=dim)[c] for part in tensor.chunk(split.parts, dim=dim)]
        return blocks[0] if split.parts == 1 else torch.cat(blocks, dim=dim)

    def assemble(self, block_of) -> torch.Tensor:
        """The whole tensor from ``block_of(coords)``, the block of each
        entry (coordinate 0 on the axes the spec does not split), on the
        first block's device: the inverse of :meth:`block`."""
        dim, split = self._split()
        zero = dict.fromkeys(self.mesh.axis_names, 0)
        if split is None:
            return block_of(zero)
        blocks = [block_of({**zero, split.axis: c}) for c in range(self.mesh.shape[split.axis])]
        dev = blocks[0].device
        parts = [torch.cat([b.chunk(split.parts, dim=dim)[j].to(dev) for b in blocks], dim=dim)
                 for j in range(split.parts)]
        return torch.cat(parts, dim=dim)


def corpus_sharding(mesh: Mesh) -> Placement:
    """Rows sharded over the mesh; feature axis replicated."""
    return Placement(mesh, (SHARD_AXIS, None))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def num_shards(mesh: Mesh) -> int:
    return mesh.shape.get(SHARD_AXIS, 0)


def serving_shards() -> int:
    """The shards an executor scans a space over: the index mesh's once a
    device list was installed (:func:`set_devices`; the server installs its
    ``--device`` list), else 1. Without an installed list an executor runs
    on its own device alone, however many CUDA devices the process sees."""
    return num_shards(index_mesh()) if _DEVICES is not None else 1
