"""Multi-process runtime: initialization and mesh layout — the port of
``panoptikon_tpu/parallel/multihost.py``.

Every process runs the same program; ``torch.distributed`` over gloo joins
them, and the serving mesh lays ``replica`` over processes and ``shard``
over each process's devices, so the per-query top-k merge stays inside a
process (``hosts_replica_mesh``), or spans one corpus over every device of
every process (``hosts_shard_mesh``). Only candidates cross processes:
(Q, k) values and slots a shard, kilobytes, which gloo moves through host
memory on the CPU and on the card alike (NCCL refuses two ranks on one GPU,
so gloo is also the one backend a one-card run can test). A training mesh
(``mesh.train_mesh``) across processes holds one entry a process and joins
a gloo group along each of its axes (:func:`axis_groups`), over which
``parallel/train.py`` sums and gathers activations and gradients.

``initialize()`` is a no-op without a coordinator, as the reference's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from panoptikon_tpu_torch.parallel.mesh import REPLICA_AXIS, SHARD_AXIS, Mesh, devices


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-process runtime when configured; no-op otherwise.

    Configuration comes from the arguments or torchrun's variables
    (``MASTER_ADDR`` with ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
    ``coordinator`` is ``host:port``. Returns True when a process group was
    initialized (gloo, ``tcp://coordinator``)."""
    import torch.distributed as dist

    if not coordinator and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "0"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "-1"))
    if num_processes < 1 or process_id < 0:
        raise ValueError(
            f"a coordinator needs the process count and this process's id, got "
            f"num_processes={num_processes} process_id={process_id}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id,
    )
    return True


def process_count() -> int:
    """The processes of the runtime (1 without one): ``jax.process_count()``."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a runtime): ``jax.process_index()``."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def global_devices() -> tuple[list, list]:
    """Every process's devices in process order, and each one's process.
    Every process holds as many devices as this one (the reference's
    ``len(jax.devices()) // process_count()``); a remote entry carries this
    process's device of the same position as its label."""
    local = devices()
    n_proc = process_count()
    return local * n_proc, [p for p in range(n_proc) for _ in local]


def axis_groups(mesh: Mesh) -> dict:
    """This process's gloo group along each axis of ``mesh``, a mesh across
    processes with one entry a process: for every axis, one group a line
    of entries along it, created in grid order by every process (as
    ``torch.distributed.new_group`` requires); the groups of this process's
    lines are returned by axis name."""
    import torch.distributed as dist

    procs = mesh.processes
    if procs is None or len(np.unique(procs)) != procs.size or procs.size != process_count():
        raise ValueError("a mesh across processes needs exactly one entry a process")
    rank = process_index()
    groups = {}
    for axis, name in enumerate(mesh.axis_names):
        lines = np.moveaxis(procs, axis, -1).reshape(-1, procs.shape[axis])
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend="gloo")
            if rank in line:
                groups[name] = group
    return groups


def hosts_replica_mesh() -> Mesh:
    """``replica × shard`` with replica == process count: each process holds
    one full corpus replica sharded over its own devices. The shard merge
    stays inside a process; only the query split and the (Q/R, k) results
    cross processes."""
    devs, procs = global_devices()
    n_proc = process_count()
    per_host = len(devs) // n_proc
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n_proc, per_host), (REPLICA_AXIS, SHARD_AXIS),
                np.asarray(procs).reshape(n_proc, per_host))


def hosts_shard_mesh() -> Mesh:
    """1-D global shard mesh across every device of every process — for a
    corpus too large for one process's devices. The top-k merge gathers
    (k · shards) candidates a query across processes once a batch."""
    devs, procs = global_devices()
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid, (SHARD_AXIS,), np.asarray(procs))
