"""The full update step (the fused reconcile + PreFilter tick) and its
device grid.

The workload's parallel axes are #pods and #throttles; the JAX package maps
them onto a 2-D ("pods", "throttles") device mesh with two all-reduces per
step. The port runs the single-device step on a 1×1 grid; the sharded and
ring forms are ROADMAP queue 1 item 9.
"""

from .mesh import Grid, make_mesh  # noqa: F401
from .sharded import full_update_step, full_update_step_gather  # noqa: F401
