"""The ("pods", "throttles") device grid of the full tick.

The JAX package lays the tick over a 2-D device ``Mesh``. The port runs it
on one device so far: ``make_mesh`` builds a 1×1 ``Grid`` on one device,
and any larger grid raises until the multi-GPU form lands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import resolve_device


@dataclass(frozen=True)
class Grid:
    """A ("pods", "throttles") grid of ``dp`` × ``tp`` devices; ``device``
    is the one device of a 1×1 grid."""

    dp: int
    tp: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"pods": self.dp, "throttles": self.tp}


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    device=None,
) -> Grid:
    """A ("pods", "throttles") grid over ``n_devices`` devices (default 1)
    on ``device`` (``None`` → CUDA, raising without it). Only 1×1 runs."""
    n = 1 if n_devices is None else n_devices
    if shape is not None and shape[0] * shape[1] != n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {shape[0] * shape[1]} devices, "
            f"got {n}; pass a shape whose product matches the device count, "
            "or omit it"
        )
    if n != 1:
        raise NotImplementedError(
            f"a {n}-device grid {tuple(shape) if shape else ''}: "
            "ROADMAP queue 1 item 9"
        )
    return Grid(1, 1, resolve_device(device))
