"""The ("pods", "throttles") device grid of the full tick, and how each
operand lies on it.

The JAX package lays the tick over a 2-D device ``Mesh`` and runs one
``shard_map`` program per device. The port's grid is the same layout held
by one process: a dp × tp array of torch devices, one slot per tile. A
slot's program is the tile's torch ops and kernel launches on the slot's
device; an all-reduce is an integer add of tile partials moved to one
slot. Slots may repeat a device, so several tiles can time-share one card
(or the CPU, the counterpart of the JAX tests' forced host devices).
Across processes (``distributed.hybrid_mesh``) the pods axis spans the
processes and its sums finish with ``all_reduce`` over ``pods_group``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .. import resolve_device

PODS, THROTTLES = "pods", "throttles"


@dataclass(frozen=True)
class Grid:
    """A ("pods", "throttles") grid: ``devices[i][j]`` is the slot of pod
    tile i and throttle tile j of this process. ``world``/``rank`` place
    this process's pod tiles on a pods axis that spans processes
    (``pods_group`` sums over it); a single-process grid has world 1."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    world: int = 1
    rank: int = 0
    pods_group: Any = None

    @property
    def dp(self) -> int:
        """Pod tiles held by this process."""
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {PODS: self.dp * self.world, THROTTLES: self.tp}

    def slot(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    def slots(self):
        """Every (i, j) of this process, pods-major."""
        return [(i, j) for i in range(self.dp) for j in range(self.tp)]


@dataclass(frozen=True)
class Split:
    """How an operand's leading dims lie on a grid: ``dims[d]`` names the
    grid axis that splits dim d into equal tiles, or ``None`` for a whole
    dim (the JAX ``PartitionSpec``). ``Split()`` is replicated."""

    dims: Tuple[Optional[str], ...] = ()

    def tile(self, x: torch.Tensor, coords: Dict[str, Tuple[int, int]],
             device: torch.device) -> torch.Tensor:
        """This slot's tile of ``x`` on ``device``; ``coords`` maps an axis
        to (this slot's index, the axis's size). A tile is a contiguous
        copy where a slice is not one (the kernels take no strides); it
        is never written."""
        for d, axis in enumerate(self.dims):
            if axis is not None:
                k, n = coords[axis]
                size = x.shape[d] // n
                x = x.narrow(d, k * size, size)
        return x.contiguous().to(device)


def _factor(n: int) -> Tuple[int, int]:
    """The largest factor pair of n, pods-major (the JAX package's rule:
    pod count dominates throttle count at every BASELINE config)."""
    t = 1
    for cand in range(int(n**0.5), 0, -1):
        if n % cand == 0:
            t = cand
            break
    return (n // t, t)


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    device=None,
    devices: Optional[Sequence] = None,
) -> Grid:
    """A ("pods", "throttles") grid over n slots (default: the product of
    ``shape`` if given, else every visible card on CUDA, 1 on the CPU),
    ``shape`` defaulting to the largest factor pair, pods-major.

    Slots: ``devices`` if given (n of them, repeats allowed, so tiles may
    time-share one card); else n slots on the CPU when ``device`` is the
    CPU; else the first n CUDA cards (``device=None`` means CUDA and raises
    without it)."""
    if devices is not None:
        pool = [torch.device(d) for d in devices]
        default_n = len(pool)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            pool = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
            default_n = len(pool)
        else:
            pool, default_n = None, 1
    n = n_devices or (shape[0] * shape[1] if shape else default_n)
    if pool is None:
        pool = [dev] * n
    if n > len(pool):
        raise ValueError(f"requested {n} devices but only {len(pool)} are visible")
    if shape is not None and shape[0] * shape[1] != n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {shape[0] * shape[1]} devices, "
            f"got {n} (visible: {len(pool)}); pass a shape whose product "
            "matches the device count, or omit it"
        )
    dp, tp = tuple(shape) if shape is not None else _factor(n)
    return Grid(tuple(tuple(pool[i * tp + j] for j in range(tp)) for i in range(dp)))


def mesh_shardings(grid: Grid):
    """How the step's operand groups lie on ``grid``: (pod rows [P,...],
    throttle rows [T,...], mask tiles [P,T], replicated) — the JAX
    package's four ``NamedSharding``s. ``grid`` is taken for the JAX
    signature; a ``Split`` names axes, not devices."""
    del grid
    return Split((PODS,)), Split((THROTTLES,)), Split((PODS, THROTTLES)), Split()
