"""Ring-rotation full sweep — the ring-attention / context-parallel
pattern mapped onto the (pods × throttles) check matrix.

The alternative to ``sharded.py``'s 2-D grid for when the throttle-side
state dominates memory: a 1-D ring of n slots where

- slot d *permanently owns* throttle tile d (thresholds, override
  schedule, reservations, used accumulators) and its mask columns
  ``mask[:, T_d]`` — throttle state never moves;
- pod blocks ([P/n] requests, validity, counted) *rotate* around the ring:
  a hop moves each block from its slot to the next one, so hop s delivers
  to slot d the block owned by slot (d − s) mod n;
- sweep 1 accumulates each tile's ``used`` from every visiting block (the
  chunked masked column sums, so no [P/n, T/n, R] temporary);
- thresholds and throttled flags are then computed tile-locally;
- sweep 2 rotates the blocks again, now carrying [P/n, 4] count
  accumulators; each slot classifies the visiting block against its tile
  (``check_dense``, once per hop per slot), and after n hops the counts
  arrive home complete.

As in the JAX package, the ring is one program over a single-controller
mesh; here the process walks the slots in turn. Outputs match
``sharded_full_update``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..ops.overrides import OverrideSchedule
from ..ops.schema import PodBatch
from .mesh import Split, make_mesh
from .sharded import (
    DENSE,
    _cat,
    _classify_counts,
    _derived_state,
    _gate,
    _used_sums,
    place,
    to_device,
    uniform_pods_specs,
    uniform_sched_specs,
)

AXIS = "ring"


@dataclass(frozen=True)
class Ring:
    """A 1-D ("ring",) mesh: slot d is ``devices[d]`` (repeats allowed)."""

    devices: Tuple[torch.device, ...]
    axis_names = (AXIS,)

    @property
    def n(self) -> int:
        return len(self.devices)


def make_ring_mesh(n_devices: Optional[int] = None, device=None,
                   devices: Optional[Sequence] = None) -> Ring:
    """1-D ("ring",) mesh over n slots, chosen as ``make_mesh`` chooses
    them."""
    grid = make_mesh(n_devices, device=device, devices=devices)
    return Ring(tuple(d for row in grid.devices for d in row))


def _rotate(blocks, ring: Ring):
    """One hop: slot d receives slot d − 1's block."""
    n = ring.n
    return [tuple(to_device(x, ring.devices[d]) for x in blocks[(d - 1) % n])
            for d in range(n)]


def ring_full_update(ring: Ring, *, on_equal: bool = False, step3_on_equal: bool = True):
    """The full tick over ``ring``: a callable with ``full_update_step``'s
    arguments (``sched, pods, mask, counted, res_cnt, res_cnt_p, res_req,
    res_req_p, thr_valid, now_ns``) and outputs."""
    if not isinstance(ring, Ring):
        raise TypeError(f"ring mesh must have a single '{AXIS}' axis, got {ring!r}")
    n = ring.n

    def sweep(sched: OverrideSchedule, pods: PodBatch, mask: torch.Tensor,
              counted: torch.Tensor, res_cnt, res_cnt_p, res_req, res_req_p,
              thr_valid, now_ns):
        P, T = mask.shape
        if P % n or T % n:
            raise ValueError(f"a ring of {n} does not divide {P} pods and {T} throttles")
        p_loc, t_loc = P // n, T // n
        split, cols_split = Split((AXIS,)), Split((None, AXIS))
        sched_specs, pods_specs = uniform_sched_specs(split), uniform_pods_specs(split)
        coords = [{AXIS: (d, n)} for d in range(n)]
        dev = ring.devices
        mask_cols = [cols_split.tile(mask, coords[d], dev[d]) for d in range(n)]  # [P, T/n]
        own = [(place(pods, pods_specs, coords[d], dev[d]),
                split.tile(counted, coords[d], dev[d])) for d in range(n)]

        def rows(d, s):
            """Slot d's mask rows of the block visiting at hop s."""
            origin = (d - s) % n
            return mask_cols[d][origin * p_loc:(origin + 1) * p_loc]

        # sweep 1: each resident tile sums every visiting block's pods
        used = [None] * n
        blk = own
        for s in range(n):
            for d in range(n):
                bpods, bcounted = blk[d]
                part = _used_sums(DENSE, bpods, rows(d, s), bcounted, t_loc)
                used[d] = part if used[d] is None else tuple(
                    a + b for a, b in zip(used[d], part))
            if s < n - 1:  # the n-th hop would only ship the blocks home
                blk = _rotate(blk, ring)

        # tile-local: thresholds at now, reconcile's throttled flags
        states, flags = [], []
        for d in range(n):
            res = [split.tile(a, coords[d], dev[d])
                   for a in (res_cnt, res_cnt_p, res_req, res_req_p, thr_valid)]
            state, st_cnt, st_req = _derived_state(
                place(sched, sched_specs, coords[d], dev[d]), now_ns.to(dev[d]),
                *used[d], *res)
            states.append(state)
            flags.append((st_cnt, st_req))

        # sweep 2: blocks travel with their count accumulators (starting
        # from the resident originals, not shipped back from sweep 1)
        blk = [(bpods, torch.zeros((p_loc, 4), dtype=torch.int32, device=dev[d]))
               for d, (bpods, _) in enumerate(own)]
        for s in range(n):
            for d in range(n):
                bpods, bcounts = blk[d]
                blk[d] = (bpods, bcounts + _classify_counts(
                    DENSE, states[d], bpods, rows(d, s), on_equal, step3_on_equal))
            blk = _rotate(blk, ring)

        home = dev[0]
        counts = _cat([c for _, c in blk], home)  # home, complete over all tiles
        return (
            counts, _gate(counts),
            _cat([u[0] for u in used], home), _cat([u[1] for u in used], home),
            _cat([f[0] for f in flags], home), _cat([f[1] for f in flags], home),
        )

    return sweep
