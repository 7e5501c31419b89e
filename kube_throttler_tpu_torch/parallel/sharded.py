"""The full update step — single-device and grid-sharded forms.

One "step" is a complete system tick: resolve every throttle's
time-varying threshold, re-aggregate ``used`` from the pod set, recompute
the throttled flags, and classify every pod × throttle admission cell —
a full reconcile pass fused with a full PreFilter sweep.

- ``full_update_step`` is the dense form over the [P,T] selector mask:
  the chunked masked column sums of ``ops/aggregate.py``, then the dense
  route of the batch check (``precompute_check_state`` → the
  hand-written ``check_dense`` kernel → ``statuses_to_compact``).
- ``full_update_step_gather`` is the sparse form over the [P,K] matched
  cols: an int64 scatter-add of the used sums and ``check_pods_gather``
  (the hand-written ``check_gather`` kernel).
  No [P,T] tensor exists anywhere.

``sharded_full_update[_gather]`` run the same body per tile of a
("pods","throttles") ``Grid``: slot (i, j) holds pod tile i, throttle tile
j and (dense form) the [P/dp, T/tp] mask tile. The only cross-tile traffic
is the JAX package's two psums, here integer adds of tile partials moved
to one slot:

- the used partials over the **pods** axis (each pod tile's sums for the
  slot's throttle tile), finished by ``all_reduce`` over the grid's
  ``pods_group`` when the pods axis spans processes;
- the per-pod class counts over the **throttles** axis.

Integer adds are exact in any order and wrap as XLA's do, so the tiled
step is bit for bit the JAX ``shard_map`` program. The single-device forms
are that body on one tile.
"""

from __future__ import annotations

from dataclasses import fields
from functools import partial

import torch

from ..ops import check_dense as _check_dense
from ..ops.aggregate import aggregate_used, apply_pod_deltas_batched, throttled_flags
from ..ops.check import (
    CHECK_ACTIVE,
    CHECK_INSUFFICIENT,
    CHECK_POD_EXCEEDS,
    check_pods_gather,
    statuses_to_compact,
)
from ..ops.fastcheck import precompute_check_state
from ..ops.overrides import OverrideSchedule, calculate_thresholds
from ..ops.schema import PodBatch, ThrottleState
from .mesh import PODS, THROTTLES, Grid, Split

DENSE, GATHER = "dense", "gather"


def uniform_sched_specs(spec: Split) -> OverrideSchedule:
    """OverrideSchedule of splits with every field on ``spec``. Shared by
    every grid form (2-D dense, 2-D sparse, ring), so a field added to
    OverrideSchedule is placed everywhere or nowhere, never forgotten in
    one of them."""
    return OverrideSchedule(**{f.name: spec for f in fields(OverrideSchedule)})


def uniform_pods_specs(spec: Split) -> PodBatch:
    """PodBatch of splits with every field on ``spec``."""
    return PodBatch(**{f.name: spec for f in fields(PodBatch)})


def place(values, specs, coords, device):
    """Dataclass ``values`` with each field tiled by the same field of
    ``specs`` for the slot at ``coords`` on ``device``."""
    return type(values)(**{
        f.name: getattr(specs, f.name).tile(getattr(values, f.name), coords, device)
        for f in fields(values)
    })


def to_device(x, device):
    """A tensor, or a dataclass of tensors, on ``device`` (the hop of a
    tile from one slot to another; no copy when it is there already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(**{f.name: getattr(x, f.name).to(device) for f in fields(x)})


def _add(parts, device):
    """The sum of tile partials, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def _cat(parts, device):
    """Tiles laid end to end along dim 0, on ``device``."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def _gate(counts: torch.Tensor) -> torch.Tensor:
    """PreFilter's gate from per-pod class counts: no active, insufficient
    or exceeds throttle (plugin.go:177-180)."""
    return (
        counts[:, CHECK_ACTIVE] + counts[:, CHECK_INSUFFICIENT] + counts[:, CHECK_POD_EXCEEDS]
    ) == 0


def _derived_state(sched, now_ns, used_cnt, used_req, contrib,
                   res_cnt, res_cnt_present, res_req, res_req_present, thr_valid):
    """The throttle state the tick classifies against: thresholds resolved
    at ``now_ns``, the fresh used sums, and the throttled flags derived
    from both (reconcile's onEqual=True compare). Returns (state, st_cnt,
    st_req)."""
    thr_cnt, thr_cnt_present, thr_req, thr_req_present = calculate_thresholds(
        sched, now_ns
    )
    used_cnt_present = used_cnt > 0
    used_req_present = contrib > 0
    st_cnt, st_req, st_req_flag_present = throttled_flags(
        thr_cnt, thr_cnt_present, thr_req, thr_req_present,
        used_cnt, used_cnt_present, used_req, used_req_present,
    )
    state = ThrottleState(
        valid=thr_valid,
        thr_cnt=thr_cnt,
        thr_cnt_present=thr_cnt_present,
        thr_req=thr_req,
        thr_req_present=thr_req_present,
        used_cnt=used_cnt,
        used_cnt_present=used_cnt_present,
        used_req=used_req,
        used_req_present=used_req_present,
        res_cnt=res_cnt,
        res_cnt_present=res_cnt_present,
        res_req=res_req,
        res_req_present=res_req_present,
        st_cnt_throttled=st_cnt,
        st_req_throttled=st_req,
        st_req_flag_present=st_req_flag_present,
    )
    return state, st_cnt, st_req


def used_from_cols(pods: PodBatch, cols: torch.Tensor, counted: torch.Tensor, T: int):
    """The sparse used aggregation: exact int64 scatter-adds of every
    counted pod's (count, requests, presence) into its matched cols.

    A slot that does not count (a -1 pad, an id outside [0, T), an
    uncounted or invalid pod) is routed to a spare row of its own pod,
    T + p, and the spare rows are sliced off: the JAX package's
    ``mode="drop"``, without every dropped add contending for one address.
    The requests scatter one resource dim at a time, so the per-slot
    source is an int64[P·K] column, not an int64[P·K,R] matrix.

    Returns (used_cnt int64[T], used_req int64[T,R], contrib int32[T,R]).
    """
    P, K = cols.shape
    R = pods.req.shape[1]
    dev = cols.device
    slot = (cols >= 0) & (cols < T) & (counted & pods.valid)[:, None]  # [P,K]
    spare = T + torch.arange(P, device=dev)[:, None]
    tgt = torch.where(slot, cols.long(), spare).reshape(-1)
    n = T + P
    used_cnt = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, tgt, torch.ones(P * K, dtype=torch.int64, device=dev)
    )[:T]
    acc_req = torch.zeros((R, n), dtype=torch.int64, device=dev)
    acc_ctb = torch.zeros((R, n), dtype=torch.int32, device=dev)
    present = pods.req_present.to(torch.int32)
    for r in range(R):
        acc_req[r].index_add_(0, tgt, pods.req[:, r, None].expand(P, K).reshape(-1))
        acc_ctb[r].index_add_(0, tgt, present[:, r, None].expand(P, K).reshape(-1))
    return used_cnt, acc_req[:, :T].T.contiguous(), acc_ctb[:, :T].T.contiguous()


def rebase_cols(cols: torch.Tensor, offset: int, t_loc: int) -> torch.Tensor:
    """Global col ids → ids of the throttle tile [offset, offset + t_loc);
    a slot outside the tile (a pad, another tile's col, a col >= T) becomes
    a -1 pad, so each global col is counted by exactly one tile."""
    local = (cols >= offset) & (cols < offset + t_loc)
    return torch.where(local, cols - offset, -1).to(cols.dtype)


def _used_sums(route: str, pods: PodBatch, x: torch.Tensor, counted: torch.Tensor, T: int):
    """One tile's used partial: (used_cnt, used_req, contrib) of its pods
    over its T throttles, from the mask tile or the (rebased) cols."""
    if route == DENSE:
        return aggregate_used(pods, x, counted)
    return used_from_cols(pods, x, counted, T)


def _classify_counts(route: str, state: ThrottleState, pods: PodBatch, x: torch.Tensor,
                     on_equal: bool, step3_on_equal: bool) -> torch.Tensor:
    """One tile's per-pod class counts int32[P,4]: the dense route's
    ``check_dense`` kernel over the mask tile, or the ``check_gather``
    kernels over the cols."""
    if route == DENSE:
        statuses = _check_dense.check_dense(
            precompute_check_state(state), pods, x,
            on_equal=on_equal, step3_on_equal=step3_on_equal,
        )
        return statuses_to_compact(statuses)[0]
    return check_pods_gather(state, pods, x, on_equal=on_equal,
                             step3_on_equal=step3_on_equal)[0]


def _pods_psum(grid: Grid, parts, device):
    """The pods-axis sum of one throttle tile's partials: the local tiles'
    add, then ``all_reduce`` over the processes of the pods axis."""
    total = _add(parts, device)
    if grid.world > 1:
        import torch.distributed as dist

        if len(parts) == 1:
            total = total.clone()  # all_reduce writes in place
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=grid.pods_group)
    return total


def grid_step(grid: Grid, route: str, rebase: bool, on_equal: bool, step3_on_equal: bool,
              sched: OverrideSchedule, pods: PodBatch, x: torch.Tensor,
              counted: torch.Tensor, res_cnt: torch.Tensor, res_cnt_present: torch.Tensor,
              res_req: torch.Tensor, res_req_present: torch.Tensor,
              thr_valid: torch.Tensor, now_ns: torch.Tensor):
    """The step over ``grid``: ``x`` is the bool[P,T] mask (``DENSE``) or
    the int32[P,K] global-id cols (``GATHER``, rebased per throttle tile
    when ``rebase``). Pod-side inputs are this process's pods, split over
    its dp pod tiles; throttle-side inputs split over tp throttle tiles.

    Returns (counts int32[P,4], schedulable bool[P], used_cnt int64[T],
    used_req int64[T,R], st_cnt bool[T], st_req bool[T,R]) on slot (0, 0):
    per-pod for this process's pods, per-throttle for all T."""
    dp, tp = grid.dp, grid.tp
    P, T = counted.shape[0], thr_valid.shape[0]
    if P % dp or T % tp:
        raise ValueError(f"grid ({dp},{tp}) does not divide {P} pods and {T} throttles")
    t_loc = T // tp
    pod_split, thr_split = Split((PODS,)), Split((THROTTLES,))
    x_split = Split((PODS, THROTTLES)) if route == DENSE else pod_split
    sched_specs, pods_specs = uniform_sched_specs(thr_split), uniform_pods_specs(pod_split)
    home = grid.slot(0, 0)

    tiles = {}
    for i, j in grid.slots():
        dev, coords = grid.slot(i, j), {PODS: (i, dp), THROTTLES: (j, tp)}
        xt = x_split.tile(x, coords, dev)
        if route == GATHER and rebase:
            xt = rebase_cols(xt, j * t_loc, t_loc)
        tiles[i, j] = (place(pods, pods_specs, coords, dev), xt,
                       pod_split.tile(counted, coords, dev))

    # the pods-axis psum of the used partials, then each throttle tile's
    # derived state on the tile's first slot
    states, used, flags = [], [], []
    for j in range(tp):
        dev, coords = grid.slot(0, j), {PODS: (0, dp), THROTTLES: (j, tp)}
        parts = [_used_sums(route, *tiles[i, j], t_loc) for i in range(dp)]
        sums = [_pods_psum(grid, [p[k] for p in parts], dev) for k in range(3)]
        res = [thr_split.tile(a, coords, dev)
               for a in (res_cnt, res_cnt_present, res_req, res_req_present, thr_valid)]
        state, st_cnt, st_req = _derived_state(
            place(sched, sched_specs, coords, dev), now_ns.to(dev), *sums, *res)
        states.append(state)
        used.append(sums[:2])
        flags.append((st_cnt, st_req))

    # every slot classifies its pod tile against its throttle tile; the
    # throttles-axis psum of the counts, then the gate from the global counts
    counts = []
    for i in range(dp):
        per_tile = []
        for j in range(tp):
            tpods, xt, _ = tiles[i, j]
            per_tile.append(_classify_counts(route, to_device(states[j], grid.slot(i, j)),
                                             tpods, xt, on_equal, step3_on_equal))
        counts.append(_add(per_tile, grid.slot(i, 0)))
    counts = _cat(counts, home)
    return (
        counts, _gate(counts),
        _cat([u[0] for u in used], home), _cat([u[1] for u in used], home),
        _cat([f[0] for f in flags], home), _cat([f[1] for f in flags], home),
    )


def _one_tile(x: torch.Tensor) -> Grid:
    return Grid(((x.device,),))


def full_update_step(
    sched: OverrideSchedule,
    pods: PodBatch,
    mask: torch.Tensor,  # bool[P,T]
    counted: torch.Tensor,  # bool[P] — running pods that count into used
    res_cnt: torch.Tensor,
    res_cnt_present: torch.Tensor,
    res_req: torch.Tensor,
    res_req_present: torch.Tensor,
    thr_valid: torch.Tensor,  # bool[T]
    now_ns: torch.Tensor,  # 0-d int64
    *,
    on_equal: bool = False,
    step3_on_equal: bool = True,
):
    """One full tick over the dense [P,T] mask.

    Returns (counts int32[P,4], schedulable bool[P],
             used_cnt int64[T], used_req int64[T,R],
             st_cnt bool[T], st_req bool[T,R]).
    """
    return grid_step(_one_tile(mask), DENSE, False, on_equal, step3_on_equal,
                     sched, pods, mask, counted, res_cnt, res_cnt_present, res_req,
                     res_req_present, thr_valid, now_ns)


def full_update_step_gather(
    sched: OverrideSchedule,
    pods: PodBatch,
    cols: torch.Tensor,  # int32[P,K] matched throttle cols per pod, -1 pads
    counted: torch.Tensor,  # bool[P]
    res_cnt: torch.Tensor,
    res_cnt_present: torch.Tensor,
    res_req: torch.Tensor,
    res_req_present: torch.Tensor,
    thr_valid: torch.Tensor,  # bool[T]
    now_ns: torch.Tensor,  # 0-d int64
    *,
    on_equal: bool = False,
    step3_on_equal: bool = True,
):
    """The SPARSE tick: the same fused reconcile+classify as
    ``full_update_step``, driven by the [P,K] matched-cols companion
    instead of the dense [P,T] mask — O(P·K·R) work. A col at or past T
    adds no used sum and is classified against row T − 1, as the JAX
    package's single-device form does. Returns the same tuple as
    ``full_update_step``."""
    return grid_step(_one_tile(cols), GATHER, False, on_equal, step3_on_equal,
                     sched, pods, cols, counted, res_cnt, res_cnt_present, res_req,
                     res_req_present, thr_valid, now_ns)


def sharded_full_update(grid: Grid, *, on_equal: bool = False, step3_on_equal: bool = True):
    """The dense step over ``grid``: a callable with ``full_update_step``'s
    arguments (the mask in third place) and outputs. Slot (i, j) runs the
    chunked column sums and ``check_dense`` over its [P/dp, T/tp] mask
    tile."""
    return partial(grid_step, grid, DENSE, False, on_equal, step3_on_equal)


def sharded_full_update_gather(grid: Grid, *, on_equal: bool = False,
                               step3_on_equal: bool = True):
    """The sparse step over ``grid``: a callable with
    ``full_update_step_gather``'s arguments and outputs. Cols carry global
    ids; each throttle tile rebases them (``rebase_cols``), so a col at or
    past T is a pad on every tile and yields no verdict and no used sum,
    as in the JAX package's ``shard_map`` form (unlike its single-device
    form). Slot (i, j) runs the scatter of its pod tile's sums and the
    ``check_gather`` pack and check at the tile's shapes."""
    return partial(grid_step, grid, GATHER, True, on_equal, step3_on_equal)


def sharded_apply_deltas(grid: Grid):
    """Streaming reconcile over the grid's throttle tiles: a callable
    ``(used_cnt[T], used_req[T,R], contrib[T,R], ids[N,K], sign[N,K],
    pod_req[N,R], pod_present[N,R]) → (used_cnt, used_req, contrib)``.

    The deltas are replicated; throttle tile j (on slot (0, j)) rebases the
    global ids into its rows and drops every id outside them, a negative
    one included (the single-device ``apply_pod_deltas_batched`` counts a
    negative id from the end, as the JAX package's does; its sharded form
    drops it). No collective: each id lands in at most one tile."""

    def apply(used_cnt, used_req, contrib, ids, sign, pod_req, pod_present):
        T = used_cnt.shape[0]
        if T % grid.tp:
            raise ValueError(f"grid tp={grid.tp} does not divide {T} throttles")
        t_loc = T // grid.tp
        split, out = Split((THROTTLES,)), []
        for j in range(grid.tp):
            dev, coords = grid.slot(0, j), {PODS: (0, grid.dp), THROTTLES: (j, grid.tp)}
            ids_j = ids.to(dev)
            off = j * t_loc
            local = torch.where((ids_j >= off) & (ids_j < off + t_loc), ids_j - off, t_loc)
            out.append(apply_pod_deltas_batched(
                *(split.tile(a, coords, dev) for a in (used_cnt, used_req, contrib)),
                local.to(ids.dtype), sign.to(dev), pod_req.to(dev), pod_present.to(dev),
            ))
        home = grid.slot(0, 0)
        return tuple(_cat([o[k] for o in out], home) for k in range(3))

    return apply
