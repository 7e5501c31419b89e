"""One rank of a multi-process grid step, for ``tests/test_torch_distributed.py``:

    python tests/torch_dist_child.py RANK WORLD INIT_METHOD ROUTE IN_PATH OUT_PATH

Loads the whole step's inputs (``torch.save``d by the test), brings up
``torch.distributed`` on gloo through ``init_distributed``, lays a
``hybrid_mesh`` of (2, 2) CPU slots in this process (the pods axis spans
the processes), runs the sharded step over this rank's half of the pods
and saves its six outputs. Imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kube_throttler_tpu_torch.ops.schema import PodBatch  # noqa: E402
from kube_throttler_tpu_torch.parallel import (  # noqa: E402
    hybrid_mesh,
    init_distributed,
    sharded_full_update,
    sharded_full_update_gather,
)


def main(rank: str, world: str, init: str, route: str, inp: str, out: str) -> int:
    rank, world = int(rank), int(world)
    sched, pods, x, counted, *rest = torch.load(inp, weights_only=False)
    assert init_distributed(init, world, rank, device="cpu")
    assert dist.get_backend() == "gloo"
    try:
        grid = hybrid_mesh(ici_shape=(2, 2), devices=["cpu"] * 4)
        assert grid.shape == {"pods": 2 * world, "throttles": 2} and grid.rank == rank
        n = counted.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        mine = PodBatch(valid=pods.valid[rows], req=pods.req[rows],
                        req_present=pods.req_present[rows])
        build = sharded_full_update if route == "dense" else sharded_full_update_gather
        outs = build(grid)(sched, mine, x[rows], counted[rows], *rest)
        torch.save(tuple(outs), out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:7]))
