"""Grid scale-out: grid construction and the full update step in its
single-device, grid-sharded and ring forms.

The workload's parallel axes are #pods and #throttles (this system has no
sequence, pipeline or expert structure), laid on a 2-D grid:

- ``pods`` axis      — data-parallel over the pod batch (rows of the check
  matrix and of the selector mask);
- ``throttles`` axis — throttle state split into tiles (columns of the
  mask; thresholds, used and reserved rows).

Cross-tile traffic is two sums per step: the used partials over the pods
axis and the per-pod verdict counts over the throttles axis. Resource
dims stay whole.

``ring.py`` keeps throttle tiles resident and rotates pod blocks around a
1-D ring. ``distributed.py`` brings up ``torch.distributed`` and lays the
pods axis over the processes, the throttles axis inside each.
"""

from .distributed import hybrid_mesh, init_distributed, shard_global_array  # noqa: F401
from .mesh import Grid, Split, make_mesh, mesh_shardings  # noqa: F401
from .ring import Ring, make_ring_mesh, ring_full_update  # noqa: F401
from .sharded import (  # noqa: F401
    full_update_step,
    full_update_step_gather,
    sharded_apply_deltas,
    sharded_full_update,
    sharded_full_update_gather,
)
