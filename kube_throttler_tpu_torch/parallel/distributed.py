"""Multi-process runtime: process bring-up and the hybrid grid.

The reference scales out through the Kubernetes API server's watch
protocol (SURVEY §5 — its only "distributed backend"). The JAX package
adds ``jax.distributed``: every host runs the same control-plane shard and
the device data plane spans all chips. The port's counterpart is
``torch.distributed``: the **pods** axis is the data-parallel axis and
spans the processes; the **throttles** axis stays inside each process.
The step's pods-axis sum of [T_loc,R] used partials then crosses
processes once per tick (``all_reduce`` over the pods group), and the
throttles-axis sum of [P_loc,4] counts stays in the process.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .mesh import PODS, THROTTLES, Grid, Split, make_mesh

logger = logging.getLogger(__name__)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Bring up ``torch.distributed`` for multi-process operation.

    Arguments fall back to ``KT_TPU_COORDINATOR`` (``host:port``, or an
    init URL such as ``tcp://…`` or ``file://…``) / ``KT_TPU_NUM_PROCESSES``
    / ``KT_TPU_PROCESS_ID``. With no configuration at all,
    ``KT_TPU_AUTO_DISTRIBUTED=1`` opts into ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as torchrun sets them); the
    un-opted default is a no-op, so single-process callers share the entry
    point without waiting for a coordinator that does not exist.

    The backend is NCCL for ``device`` on CUDA (``None`` means CUDA and
    raises without it) and gloo on the CPU, unless ``backend`` names
    another; nothing switches backends on its own. Returns True iff a
    multi-process runtime is up.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("KT_TPU_COORDINATOR")
    env_np = os.environ.get("KT_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("KT_TPU_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes in (None, 1):
        if os.environ.get("KT_TPU_AUTO_DISTRIBUTED") != "1":
            return False  # single-process; nothing to do
        init_method = "env://"
    elif coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator address")
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    logger.info("torch.distributed up (%s): process %d/%d", backend,
                dist.get_rank(), dist.get_world_size())
    return True


def hybrid_mesh(
    ici_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Grid:
    """("pods","throttles") grid spanning all processes.

    Multi-process: the pods axis is the processes × this process's pods
    factor, and the throttles axis stays inside each process. ``ici_shape``
    fixes this process's (pods, throttles) factorization, by default the
    whole local set of slots on throttles. Slots are chosen as
    ``make_mesh`` chooses them. Single-process: ``make_mesh``.
    """
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(shape=ici_shape, device=device, devices=devices)
    if ici_shape is None:
        if devices is not None:
            local = len(devices)
        elif resolve_device(device).type == "cuda":
            local = torch.cuda.device_count()
        else:
            local = 1
        ici_shape = (1, local)
    grid = make_mesh(shape=ici_shape, device=device, devices=devices)
    return Grid(grid.devices, world=dist.get_world_size(), rank=dist.get_rank(),
                pods_group=dist.group.WORLD)


def shard_global_array(grid: Grid, spec: Split, local_data) -> Tuple[torch.Tensor, ...]:
    """This process's tiles of a global array, one per slot (pods-major),
    each on its slot. ``local_data`` is the whole array in a single
    process; across processes, this process's slice of it along the pods
    axis (its pod rows), so no process holds the global tensor."""
    data = (local_data if isinstance(local_data, torch.Tensor)
            else torch.from_numpy(np.array(local_data)))
    return tuple(
        spec.tile(data, {PODS: (i, grid.dp), THROTTLES: (j, grid.tp)}, grid.slot(i, j))
        for i, j in grid.slots()
    )
