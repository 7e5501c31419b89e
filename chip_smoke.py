#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kube_throttler_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's main path from ``csrc/`` (into
the ignored ``build/kernels/``; beside them, each source once more with
``-Xptxas -v`` for each instantiation's registers, shared memory and
spills, and their SASS instruction counts),
holds each kernel against its plain PyTorch version on the card
(``check_dense``: every onEqual/step-3 variant, both R routes, a throttle
count past 65,535 blocks of 32; ``check_gather``: its pack's records byte
for byte against the plain pack, and its check, every variant and both
output forms, against the plain version over the state's planes and the
one over the plain records, at K in {4, 32, 64, 2048} × R in {3, 8, 16, 20},
at R = 33 and 40 and at 131072 × 32 × 8, with int64 extremes, pads and
cols >= T), drives the
main path — ``KubeThrottler.pre_filter_batch`` over 100,000 bound pods,
10,000 Throttles and 8 ClusterThrottles, the Throttle kind through
``check_gather`` and the ClusterThrottle kind through ``check_dense`` —
and checks its verdicts against the host oracle. The coalescer's
``check_pods_multi`` over 256 stored pods, forced onto the device route
(one ``check_gather`` launch per kind), must equal its host route. Then
it drives the reconcile tick, ``full_tick_sharded`` on a 1×1 grid, over
the same cluster: its verdicts must equal ``pre_filter_batch``'s and its
used counts the written statuses, before and after 1,000 Throttles gain
override windows, and a dense tick at full width must equal the sparse
one. Then the multi-device tick (``[grid]``): ``full_tick_sharded`` over
grids of 4 slots that all lie on the card, at (2, 2), (1, 4) and (4, 1)
and once with ``dense_mesh``, each equal to the 1×1 tick with dp·tp
launches of each of its kernels; the ring of 4 slots over the Throttle
kind's dense operands, equal to the 1×1 dense step; the delta apply over
4 throttle tiles, equal to the single-device apply with negative ids
dropped; a 4-card grid refused on this one-card host; and two ranks, child
processes of this script (``--grid-rank``) on the card, each over half
the pods, whose outputs equal the 1×1 step's (NCCL first, then gloo).
Then, on the same cluster: one
``gang_check_groups`` over 256 pending gangs (a quarter in an accelerator
class) must equal the sequential host oracle for every gang; the
``victim_select`` kernel must equal its plain version at five (N, M) cells
and a sixth drawn from the int64 extremes, three caps each; and one
``maybe_preempt_gang`` must launch it once,
evict the host oracle's victims and let the gang admit. One more
``pre_filter_batch`` runs under ``utils.tracing.device_trace``
(``torch.profiler``): whether the card's activity is traced, and its idle
share of the call. Last, the daemon: a cluster of its own (20,000 pods,
2,000 Throttles and 8 ClusterThrottles by the main path's seed rule),
answered in process by the plain path on the CPU and written as a
``--data-dir`` with the port's journal and snapshot code, is served by ``python -m
kube_throttler_tpu_torch.cli serve`` on the card; its HTTP
batch (every verdict), tick and 200 single-pod answers must equal the
in-process ones, ``/metrics`` must show the breaker closed and each batch
kernel launched, and after a SIGTERM restart the same answers and a
reservation must come back; then the embedded scheduler (``--nodes 4``)
must bind the same pods through a preemption on the card as under
``--no-device``. Then ``[tools]``: the port's memory smoke and its two
profiling tools (``tools/{memsmoke,profile_batch,profile_reconcile}_torch.py``)
each a child process on the card at the reference tools' defaults, each
exiting 0, the profiled warm batch launching ``check_dense`` and
``check_gather``. Last, the sharded fleet: an ``AdmissionFront`` in this
process over a ``ShardSupervisor``'s 4 worker processes on the card
serves the main path's cluster; every batch verdict, 200 single-pod
answers and a two-phase reserve must equal the in-process ones, each
worker must report the card and its ``check_gather`` and ``check_dense``
launches, and a SIGKILLed worker must come back on the card with every
verdict; then ``serve --shards 4`` as a child process must answer an HTTP
batch over a smaller cluster as the in-process plugin does and leave no
worker after SIGTERM. Last, the scenario engine's storms on the card, each
in a child interpreter of this script (``--scenario-child``), at the
corpus's own topologies and seed 0: ``relist_storm`` and ``bad_day``
through the remote-mode stack without the verdict cache (every verdict of
the serving plugin's batch equal to an oracle plugin's, and 200 host spot
checks; the serving plugin's batch launches ``check_gather``), the
preemption storm (its correctness gates; its cycles launch
``victim_select``) and the sharded bad day on 4 workers (verdicts per pod,
the killed worker's recovery; after the storm this script reads each
worker's launches and sends the fleet one batch, held against a host
oracle, that launches ``check_gather`` on the workers); every gate is
printed with its bound, and the latency gates are recorded, not enforced.
Last, the main path with the analyzer's three runtime twins armed
(``[armed]``), in a child interpreter of this script (``--armed-child``)
with ``KT_LOCK_ASSERT=1 KT_RACE_DETECT=1 KT_EPOCH_ASSERT=1
KT_VERDICT_CACHE=0``: the daemon phase's cluster (a fifth of the main
path's, by the same seed rule) on the card, its reconcile
workers running and a churn thread adding and deleting pods, through 3
``pre_filter_batch``, a tick, 200 single-pod PreFilters (each twice, the
second a verdict-cache hit that the epoch assassin recomputes), a
``gang_check_groups`` and a ``maybe_preempt_gang``; every kernel must
launch in it, and no lock-order or lock-assertion error, uncaught thread
exception, race report or stale verdict may occur; then, the churn
stopped, one more batch is held against the host oracle. Then
``[props]``: the port's property strategies (``tests/torch_props.py``)
under Hypothesis, derandomized, through every kernel on the card, each
drawn input held against the kernel's plain version (single cells also
against the ordered 4-state oracle, victim problems also against the
sequential host oracle), over a grid of state shapes with int64
extremes, gather cols past both ends and victim problems on each of the
kernel's routes. Last, ``[soak]``: the differential soak's churn
(``tests/torch_soak.py``) per seed, its device stack on the card and its
host stack on the CPU, without the verdict cache, every checkpoint also
holding the two stacks' ``pre_filter_batch`` equal. Last,
``[deployed]``: the port as an operator installs it, the package copied
as its wheel holds it into ``build/deployed-smoke/site`` and every child
run there with that folder alone on ``PYTHONPATH`` and a fresh ``HOME``
and ``XDG_CACHE_HOME``, over 2,000 pods, 200 Throttles and 8
ClusterThrottles: (a) ``serve --kubeconfig --config`` (deploy/gpu/deployment.yaml's
command) against a ``MockApiServer`` in this process, its batch, 200
single-pod PreFilters and tick equal to an in-process plugin's, both batch
kernels launched (its ``/metrics``), the three libraries built into the
user cache and nothing new in the install tree but bytecode and the native
engine; (b) the same daemon after ``python -m kube_throttler_tpu_torch.kernels
--prebuild`` with no ``nvcc`` reachable, the same answers and an empty
cache; (c) the TCP fleet of deploy/gpu/sharded-fleet.yaml on loopback (2
workers on the card, a front that dials both), equal answers, each
worker's ``stats`` on the card with its launches growing, and a worker
SIGKILLed and restarted on its port until every verdict is back. One line per
phase; then one ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent or when the
script is not inside a checkout of the repository; exits non-zero on any
build failure, launch failure, mismatch or main-path check that fails.
Everything runs in this one process (plus ``nvidia-smi``, six ``nvcc``
processes started together — one per kernel source and one ``-Xptxas -v``
report per source — ``cuobjdump`` for the instruction counts, the grid
phase's two ranks per backend tried, each in a session of its own that is
killed whole on failure or at its deadline, and the
four daemons of the daemon phase, one at a time, each stopped by SIGTERM
or killed on failure; the tools phase's three children, one at a time,
each in a session of its own that is killed whole past its deadline; the shards phase's 4 workers (5 with the SIGKILLed
one's replacement), stopped with their supervisor, and its sharded daemon
with its 4 workers, stopped by SIGTERM; the scenarios phase's four child
interpreters, one at a time, each in a session of its own that is killed
whole if it outlives its deadline, with the sharded run's workers and the
bad day's failover children under it; and the armed phase's child
interpreter, in a session of its own that is killed whole if it outlives
its deadline; the deployed phase's children, one at a time but for the
fleet's front and its 2 workers: a probe of the install, the two daemons,
each stopped by SIGTERM or killed on failure, ``--prebuild`` with its
three ``nvcc``, and the workers, killed with SIGKILL at the end or on
failure).
"""

from __future__ import annotations

import json
import os
import pickle
import random
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PORT = "kube_throttler_tpu_torch"

SEED = 0
# the served stack of the repository's bench (100k pods × 10k Throttles in
# 500 label groups) plus 8 ClusterThrottles, each selecting every 8th group
N_PODS, N_THROTTLES, GROUPS, N_CLUSTER = 100_000, 10_000, 500, 8
N_CALLS = 5
N_TICKS = 5
# the tick's phases (plugin tracer), printed per call
TICK_PHASES = ("full_tick", "tick_snapshot", "tick_encode", "tick_device")
ORACLE_SAMPLE = 2_000
# kernel-vs-plain shapes (P, T, R): ragged, the main path's dense shape,
# wide, the widest register route (R = 16), the shared-memory route (R = 20)
COMPARE_SHAPES = ((37, 19, 3), (131072, 16, 8), (8192, 10240, 8), (8192, 300, 16),
                  (8192, 300, 20))
# every (on_equal, step3_on_equal) pair: one kernel instantiation each
VARIANTS = ((False, True), (True, True), (False, False), (True, False))
# more throttle columns than a grid.y of 65,535 tiles of 32 could hold
WIDE_T_SHAPE = (4, 2_200_000, 8)
# the three variants of the kernel's geometry timed against each other:
# (label, _launch_shape keywords); the first is the wrapper's default
DESIGN_VARIANTS = (
    ("bt64", {}),
    ("bt256", {"bt_max": 256}),
    ("bt256_long_strips", {"bt_max": 256, "target_blocks": 132 * 8}),
)
# the bench's dense-sweep shape (bench.py bench_pallas_sweep), timed only
SWEEP_SHAPE = (131072, 10240, 8)
# the gang phase: GANGS pending groups of GANG_SIZE members on the main
# path's cluster, a quarter of them in GANG_CLASS
GANGS, GANG_SIZE, GANG_CLASS, GANG_CALLS, GANG_PREFILTER_SAMPLE = 256, 8, "h100", 3, 16
# victim_select held against its plain version: (candidates N, deficit dims
# M), each with caps 0, 1 and N / 2; then one cell drawn from EXTREMES, with
# negative contributions, so that the subtraction wraps
VICTIM_CELLS = ((1, 1), (40, 8), (4096, 64), (65536, 256), (1024, 2500))
VICTIM_EXTREMES_CELL = (4096, 256)
# the preemption phase's policy (tests/test_policy.py's) and label group: one
# whose Throttles and ClusterThrottle are roomy and that no earlier phase edits
PREEMPT_POLICY = {"name": "smoke", "preemptionEnabled": True, "minPriorityGap": 1}
PREEMPT_GROUP = 1
# the embedded scheduler's policy: PREEMPT_POLICY with a floor between one
# group's preemption cycles (docs/policy.md's anti-thrash knob). A cycle
# reads its deficits from the throttles' published status.used, which drops
# the evicted pods one reconcile later; without the floor, a retry inside
# that lag evicts a second set of victims for the same deficit.
SCHEDULER_POLICY = dict(PREEMPT_POLICY, preemptCooldownSeconds=10)
# check_gather held against its plain version beyond the card tests' cells
# (tests/torch_gather_cases.py): the tick's shape, 131072 pods × K = 32 ×
# tcap 16384 × R = 8
GATHER_TICK_CELL = (131072, 32, 16384, 8)
# the coalescer phase: stored pods per check_pods_multi call
COALESCE_PODS = 256
# the daemon phase: a daemon's deadline from spawn to ready, its batch
# calls, the stored pods of its single-pod check, and the label group whose
# roomy Throttles and ClusterThrottle the fill pod's reservation fills
DAEMON_DEADLINE_S = 600.0
DAEMON_ROOT = HERE / "build" / "daemon-smoke"
DAEMON_BATCH_CALLS = 1
DAEMON_SINGLE_PODS = 200
FILL_GROUP = 9
# the daemon phase's cluster (pods, Throttles, label groups,
# ClusterThrottles) from cluster_objects with the main path's seed: a fifth
# of the main path's pods and Throttles over a fifth of its groups, so each
# group keeps its 200 pods and 20 Throttles. The daemon's startup replays
# every object into its mirror one at a time (PERF.md §5), so this depth
# sets most of the phase's length. The answers the daemon must give come
# from an in-process plugin on the CPU, whose wrappers run their plain
# versions: no kernel of the card's is on both sides of the comparison
DAEMON_CLUSTER = (20_000, 2_000, 100, N_CLUSTER)
# the tools phase: the port's developer tools, each a child process on the
# card at its reference defaults (the reference tools' argv), under
# TOOLS_DEADLINE_S each, without the verdict cache (a batch under 50,000
# pods dedupes on the host and reaches no kernel)
TOOLS = (
    ("memsmoke", ("tools/memsmoke_torch.py",)),
    ("profile_batch", ("tools/profile_batch_torch.py", "10000", "1000")),
    ("profile_reconcile", ("tools/profile_reconcile_torch.py", "2000", "200", "2000")),
)
TOOLS_DEADLINE_S = 300.0
TOOLS_ROOT = HERE / "build" / "tools-smoke"
# the shards phase: worker processes of the sharded fleet, all on the one
# card; its batch calls; the deadline of a fleet's start and of each wait;
# and the CLI leg's smaller cluster (pods, Throttles, label groups,
# ClusterThrottles), posted over HTTP
SHARDS = 4
SHARDS_BATCH_CALLS = 1
SHARDS_DEADLINE_S = 600.0
SHARDS_ROOT = HERE / "build" / "shards-smoke"
CLI_SHARDS_CLUSTER = (1_000, 100, 50, 2)
# the scenarios phase: the scenario engine's storms at the corpus's own
# topologies and seed 0, each run in a fresh interpreter (a child of this
# script), as the engine's CLI runs them: (run, runner). Every child runs
# without the verdict cache (KT_VERDICT_CACHE=0), as the shards phase's
# workers do: at corpus scale the cache's dedupe answers a batch on the
# host, one check per pod fingerprint, and launches no kernel.
SCENARIO_RUNS = (
    ("relist_storm", "engine"),
    ("bad_day", "engine"),
    ("preempt_storm", "preemption"),
    ("sharded_bad_day", "sharded"),
)
SCENARIO_SHARDS = 4
SCENARIO_DEADLINE_S = 600.0
SCENARIO_ROOT = HERE / "build" / "scenarios-smoke"
SCENARIO_REPORT = "SCENARIO_REPORT "
# the gates that decide the smoke (the verdicts and the storm's correctness);
# every other gate (flip_p99, flip_p50, ingest_sustain, recovery, pace,
# churn, failover) is printed with its bound and recorded, not enforced here
PREEMPT_CORRECTNESS_GATES = ("admitted", "no_half_gangs", "victim_order", "oracle")
# the grid phase: the main path's cluster ticked over grids of GRID_SLOTS
# slots that all lie on the one card (tiles time-share it), at each shape
# of GRID_SHAPES; the ring over RING_SLOTS slots; the sharded delta apply
# over DELTA_EVENTS churn events of DELTA_SLOTS matched throttles each, ids
# drawn from [-T, T]; and GRID_RANKS processes on the card, each holding
# its share of the pods, NCCL tried first (deadline GRID_NCCL_DEADLINE_S),
# then gloo
GRID_SLOTS = 4
GRID_SHAPES = ((2, 2), (1, 4), (4, 1))
RING_SLOTS = 4
DELTA_EVENTS, DELTA_SLOTS = 4096, 8
GRID_RANKS = 2
GRID_ROOT = HERE / "build" / "grid-smoke"
GRID_NCCL_DEADLINE_S = 60.0
GRID_RANK_DEADLINE_S = 120.0
# the armed phase: a child interpreter of this script (``--armed-child``)
# with the analyzer's three runtime twins armed — instrumented locks that
# raise on an order inversion or a bad hold, the lockset race detector
# and the verdict-coherence assassin, all three armed at import — builds
# ARMED_CLUSTER (pods, Throttles, label groups, ClusterThrottles) on the
# card and drives the main path while a churn thread applies pod
# ADDED/DELETED events through the store: ARMED_BATCHES pre_filter_batch
# calls, one tick, single-pod PreFilters (each twice, the second a
# verdict-cache hit that the assassin shadow-checks), one
# gang_check_groups and one maybe_preempt_gang. The churn's pods lie in the
# label groups ≡ ARMED_CHURN_MOD (mod N_CLUSTER), under ClusterThrottle
# c{ARMED_CHURN_MOD}; the preempted group is not one of them. ARMED_SINGLE
# "quiet" probes lie outside them, so nothing moves their state between
# the two calls, and their repeat must agree. ARMED_SINGLE "churned" probes
# lie in them, and each churned group's first Throttle is set, before the
# churn starts, to its used cpu + 300m, so the churn's pods flip those
# probes' verdicts, and ARMED_CHURNED_GAP_S lies between their two calls:
# the churn moves their epochs in between, so a repeat may differ there,
# and a covered mutation that skipped its bump would show as a hit the
# assassin finds stale.
ARMED_ENV = {"KT_LOCK_ASSERT": "1", "KT_RACE_DETECT": "1", "KT_EPOCH_ASSERT": "1",
             "KT_VERDICT_CACHE": "0"}
# the armed child's cluster: the daemon phase's fifth of the main path
# (the main path itself runs at full width, unarmed)
ARMED_CLUSTER = DAEMON_CLUSTER
ARMED_BATCHES, ARMED_SINGLE, ARMED_CHURN_MOD = 3, 200, 0
ARMED_CHURNED_GAP_S = 0.02
ARMED_DEADLINE_S = 600.0
ARMED_ROOT = HERE / "build" / "armed-smoke"
ARMED_REPORT = "ARMED_REPORT "
# the props phase: Hypothesis properties over the port's property strategies
# (tests/torch_props.py), run on the card with derandomize=True, database=None
# and deadline=None, each with its max_examples: (property, kernel, examples)
PROPS = (
    ("single_cell", "check_dense", 200),
    ("dense_states", "check_dense", 100),
    ("gather_states", "check_gather", 200),
    ("victim_problems", "victim_select", 150),
    ("victim_padding", "victim_select", 50),
    ("victim_warp", "victim_select", 24),
    ("victim_ring", "victim_select", 24),
    ("victim_wide_regs", "victim_select", 24),
    ("victim_wide_smem", "victim_select", 24),
    ("victim_wide_device", "victim_select", 24),
)
PROPS_BUDGET_S = 60.0
# the soak phase: the differential soak's churn (tests/torch_soak.py) with the
# device stack on the card and the host stack on the CPU, without the verdict
# cache: its pinned seeds, then 4 onward, SOAK_MAX_SEEDS in all, cut to fit
# SOAK_BUDGET_S (the pinned seeds always run)
SOAK_MAX_SEEDS = 32
SOAK_BUDGET_S = 90.0
# the deployed phase: the port as an operator installs it (``Install``: the
# package copied as its wheel holds it, children run with it alone on
# PYTHONPATH) over cluster_objects(*DEPLOYED_CLUSTER): the remote-mode daemon
# of deploy/gpu/deployment.yaml, the same daemon on prebuilt kernels with no nvcc,
# and the TCP fleet of deploy/gpu/sharded-fleet.yaml with DEPLOYED_SHARDS workers;
# DEPLOYED_SINGLE single-pod PreFilters each, every wait bounded by
# DEPLOYED_DEADLINE_S
DEPLOYED_CLUSTER = (2_000, 200, 50, N_CLUSTER)
DEPLOYED_SINGLE = 200
DEPLOYED_SHARDS = 2
DEPLOYED_DEADLINE_S = 300.0
DEPLOYED_ROOT = HERE / "build" / "deployed-smoke"
# the launch counters every kernel wrapper keeps (metrics.kernel_launch_counts)
KERNEL_COUNTERS = ("check_dense", "check_gather", "pack_gather_rows", "victim_select")
# kernel instantiations ptxas must report per source (check_gather: 8
# checks and the pack)
PTXAS_INSTANTIATIONS = {"check_dense": 12, "check_gather": 9, "victim_select": 9}
EXTREMES = [0, 1, -1, 2**31, -(2**31), 2**32, -(2**32), 2**62, -(2**62),
            2**63 - 1, -(2**63), 123456789012345, -987654321098765]

# H100 SXM published peaks. HBM3 bandwidth: NVIDIA data sheet. The kernel's
# compares are integer ops, issued on the INT32 pipe: 64 INT32 lanes per SM
# (half the 128 FP32 lanes; NVIDIA H100 Tensor Core GPU Architecture
# whitepaper), one op per lane per clock, 132 SMs at the 1.98 GHz boost
# clock behind the data sheet's 67 TFLOP/s FP32 (= 132 × 128 × 2 × 1.98 G).
H100_BYTES_PER_S = 3.35e12
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 16.7e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


PHASE_MARKS: list = []


def mark(phase: str) -> None:
    """Note where a part of ``run`` starts; the ``[phases]`` line gives
    each part's seconds, up to the next mark."""
    PHASE_MARKS.append((phase, time.perf_counter()))


def phase_seconds() -> dict:
    ends = [t for _, t in PHASE_MARKS[1:]] + [time.perf_counter()]
    return {name: round(end - t, 3) for (name, t), end in zip(PHASE_MARKS, ends)}


# --------------------------------------------------------------- inputs


def synth_arrays(rng: np.random.Generator, P: int, T: int, R: int):
    """Seeded host arrays for one ThrottleState, PodBatch and [P,T] mask.
    Odd resource dims carry values past 2^32 (memory-like quantities) so
    the high words of the int64 compares matter."""
    scale = np.where(np.arange(R) % 2 == 1, 2**33, 1).astype(np.int64)
    u = lambda *s: rng.random(s)  # noqa: E731
    state = dict(
        valid=u(T) < 0.9,
        thr_cnt=rng.integers(0, 60, T), thr_cnt_present=u(T) < 0.5,
        thr_req=rng.integers(0, 2000, (T, R)) * scale, thr_req_present=u(T, R) < 0.7,
        used_cnt=rng.integers(0, 60, T), used_cnt_present=u(T) < 0.8,
        used_req=rng.integers(0, 2200, (T, R)) * scale, used_req_present=u(T, R) < 0.8,
        res_cnt=rng.integers(0, 3, T), res_cnt_present=u(T) < 0.3,
        res_req=rng.integers(0, 200, (T, R)) * scale, res_req_present=u(T, R) < 0.3,
        st_cnt_throttled=u(T) < 0.03, st_req_throttled=u(T, R) < 0.05,
        st_req_flag_present=u(T, R) < 0.5,
    )
    pods = dict(
        valid=u(P) < 0.95,
        req=rng.integers(0, 1000, (P, R)) * scale,
        req_present=u(P, R) < 0.7,
    )
    return state, pods, u(P, T) < 0.5


def device_inputs(state, pods, mask, device):
    """The port's tensors from host arrays, through the state carry-across."""
    import torch

    from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state
    from kube_throttler_tpu_torch.ops.schema import (
        pod_batch_from_arrays,
        throttle_state_from_arrays,
    )

    pre = precompute_check_state(throttle_state_from_arrays(state, device=device))
    return pre, pod_batch_from_arrays(pods, device=device), torch.from_numpy(mask).to(device)


def extremes_inputs(device):
    """13 × 13 cells whose steps 1 and 4 reduce to raw s64 compares at the
    int64 extremes (pod i requests EXTREMES[i]; throttle j has threshold
    and residual EXTREMES[j])."""
    import torch

    from kube_throttler_tpu_torch.ops.schema import (
        check_precomp_from_arrays,
        pod_batch_from_arrays,
    )

    n = len(EXTREMES)
    v = np.array(EXTREMES, dtype=np.int64)[:, None]
    t, f = np.ones(n, bool), np.zeros(n, bool)
    fr = np.zeros((n, 1), bool)
    pre = check_precomp_from_arrays(dict(
        valid=t, thr_req=v, thr_req_present=np.ones((n, 1), bool), exceeds_cnt=f,
        st_cnt=f, st_req=fr, sat_cnt_ge=f, sat_cnt_gt=f, sat_req_ge=fr, sat_req_gt=fr,
        resid=v.copy(), over_cnt_ge=f, over_cnt_gt=f,
    ), device=device)
    pods = pod_batch_from_arrays(
        dict(valid=t, req=v.copy(), req_present=np.ones((n, 1), bool)), device=device
    )
    return pre, pods, torch.ones((n, n), dtype=torch.bool, device=device)


def gather_cases():
    """``tests/torch_gather_cases.py`` of this checkout, loaded by its path:
    an installed package named ``tests`` would shadow the repo's directory,
    which has no ``__init__.py``."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_gather_cases.py"
    spec = importlib.util.spec_from_file_location("torch_gather_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gather_inputs(seed: int, P: int, K: int, T: int, R: int, device, extremes: bool = False):
    """(state, pods, cols) on ``device`` for the gather check, from the
    generator the card tests use (``tests/torch_gather_cases.py``): a
    seeded [T] state, [P] pods and [P,K] cols with -1 pads, some cols of T
    and T + 3 (a JAX gather clamps them to row T - 1), invalid rows and
    pods; with ``extremes`` every int64 plane drawn from the int64
    extremes, so used + res + pod wraps."""
    import torch

    from kube_throttler_tpu_torch.ops.schema import (
        pod_batch_from_arrays,
        throttle_state_from_arrays,
    )
    state, pods, cols = gather_cases().gather_arrays(np.random.default_rng(seed), P, K, T, R,
                                                     extremes)
    return (throttle_state_from_arrays(state, device=device),
            pod_batch_from_arrays(pods, device=device), torch.from_numpy(cols).to(device))


# --------------------------------------------------------------- measures


def compare(pre, pods, mask, on_equal: bool, step3: bool, got=None):
    """(mismatching cells, max |kernel - plain|, per-status counts) of the
    kernel (``got``, else a ``check_dense`` call) against its plain version
    on the same device tensors."""
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd

    if got is None:
        got = cd.check_dense(pre, pods, mask, on_equal=on_equal, step3_on_equal=step3)
    want = cd.check_dense_reference(pre, pods, mask, on_equal, step3)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    counts = torch.bincount((want.flatten().to(torch.int64) + 1), minlength=5).tolist()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0, counts


def compare_gather(state, pods, cols, on_equal: bool, step3: bool):
    """(mismatching outputs, max |kernel - plain|, per-status counts) of the
    check_gather kernels on the same device tensors: the pack kernel's
    records against the plain pack's (int64 words that differ), and both
    forms of the wrapper (pack and check) against the plain version over
    the state's planes, whose statuses the plain version over the plain
    records must also give."""
    import torch

    from kube_throttler_tpu_torch.ops import check_gather as cg

    R = state.thr_req.shape[1]
    want_pack = cg.pack_gather_rows_reference(state)
    got_pack = cg.pack_gather_rows(state)
    got_s = cg.check_gather(state, pods, cols, on_equal, step3, statuses=True)
    got_c, got_b = cg.check_gather(state, pods, cols, on_equal, step3)
    want_s = cg.check_gather_reference(state, pods, cols, on_equal, step3, statuses=True)
    want_c, want_b = cg.check_gather_reference(state, pods, cols, on_equal, step3)
    plain_packed = cg.check_packed_reference(want_pack, pods, cols, R, on_equal, step3,
                                             statuses=True)
    bad = (int((got_s != want_s).sum()) + int((got_c != want_c).sum())
           + int((got_b != want_b).sum()) + int((got_pack != want_pack).sum())
           + int((plain_packed != want_s).sum()))
    bad += sum(g.dtype != w.dtype for g, w in ((got_s, want_s), (got_c, want_c), (got_b, want_b),
                                               (got_pack, want_pack)))
    err = 0
    for g, w in ((got_s, want_s), (got_c, want_c)):
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    counts = torch.bincount(want_s.flatten().to(torch.int64) + 1, minlength=5).tolist()
    return bad, err, counts


def gather_bound(state, pods, cols):
    """Least time of the gather check's counts form on these inputs, as a
    dict (the keys of ``dense_bound``), counting only what this run's data
    needs. Bytes, each read or written once: cols; the pods' valid flags and
    presence planes, and a request only where it is present; the valid flag
    of each row that a valid pod's col names; the count side of each such
    valid row (3 int64, 4 bool planes); the 3 int64 and 5 bool planes of
    each (row, dim) that a live slot's pod requests nonzero (a dim the pod
    does not request cannot change its status); counts and schedulable.
    Operations: per live slot (col >= 0, row valid, pod valid) the count
    side's two s64 adds and three compares, and per live slot and dim the
    pod requests nonzero, two s64 adds and three compares; an s64 op is two
    32-bit ones."""
    import torch

    P, K = cols.shape
    T, R = state.thr_req.shape
    c = cols.long().clamp(0, T - 1)
    named = (cols >= 0) & pods.valid[:, None]  # [P,K]
    live = named & state.valid[c]
    nz = pods.req_present & (pods.req != 0)  # [P,R]
    pairs = torch.zeros((T, R), dtype=torch.bool, device=cols.device)
    for r in range(R):
        pairs[c[live & nz[:, r, None]], r] = True
    rows = int(torch.unique(c[named]).numel())
    live_rows = int(torch.unique(c[live]).numel())
    n_pairs = int(pairs.sum())
    nbytes = (P * K * 4 + P * (1 + R) + 8 * int(pods.req_present.sum())
              + rows + live_rows * (3 * 8 + 4) + n_pairs * (3 * 8 + 5) + P * 17)
    ops = int((live.sum(1) * (1 + nz.sum(1))).sum()) * 5 * 2
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "bytes": nbytes, "int32_ops": ops,
            "rows": rows, "row_dims": n_pairs}


def gather_live(state, pods, cols):
    """{live_slots, live_dims}: the slots the check classifies (col >= 0,
    row valid, pod valid) and their (slot, dim) pairs the pod requests
    nonzero; each live slot reads a record's header sector, and each such
    pair whose threshold is present a dim slot's sector."""
    c = cols.long().clamp(0, state.valid.shape[0] - 1)
    live = (cols >= 0) & pods.valid[:, None] & state.valid[c]
    nz = (pods.req_present & (pods.req != 0)).sum(1, keepdim=True)
    return {"live_slots": int(live.sum()), "live_dims": int((live.long() * nz).sum())}


def gather_bare(state, pods, cols, statuses: bool):
    """(pack, check, packed): closures making the bare ``kt_pack_gather_rows``
    and ``kt_check_gather`` calls of one form with their arguments built
    once, and the buffer the pack writes (packed once here, so the check
    alone can be timed). Launches of them are not counted."""
    import torch

    from kube_throttler_tpu_torch.ops import check_gather as cg

    lib = cg.load_library()
    P, K = cols.shape
    T, R = state.thr_req.shape
    shape = cg._launch_shape(P, T)
    dev = cols.device
    packed = torch.empty((T, cg.record_layout(R).words), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    pack_args = cg.pack_args(state, packed, shape, stream)
    check(lib.kt_pack_gather_rows(*pack_args) == 0, "bare kt_pack_gather_rows launch failed")
    args = cg.launch_args(packed, pods, cols, *cg._outputs(P, K, dev, statuses), False, True,
                          shape, stream)
    check(lib.kt_check_gather(*args) == 0, "bare kt_check_gather launch failed")
    return (lambda: lib.kt_pack_gather_rows(*pack_args)), (lambda: lib.kt_check_gather(*args)), packed


def cuda_ms(fn, iters: int, flush_bytes: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events.
    With ``flush_bytes`` each timed call starts after a write of that many
    bytes, evicting the 50 MB L2 as a real caller would find it."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda") if flush_bytes else None
    total = 0.0
    if flush is None:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def device_only_ms(fn, iters: int, flush_bytes: int = 64 << 20) -> float:
    """Mean device time of ``fn`` alone, by CUDA events: like ``cuda_ms``
    with the L2 flushed, but the card spins (``torch.cuda._sleep``) before
    the start event, so the host's time to enqueue ``fn`` never shows as
    idle time between the events."""
    import torch

    for _ in range(2):
        fn()
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)  # ~0.1 ms at 1.98 GHz: longer than any enqueue here
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bare_launch(lib, pre, pods, mask, on_equal, step3, shape=None):
    """(launch, out): a closure that makes the bare ``kt_check_dense`` call
    with its arguments built once (geometry ``shape``, else the wrapper's),
    and the output it writes. Launches of it are not counted."""
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd

    P, R = pods.req.shape
    out = torch.empty(mask.shape, dtype=torch.int8, device=mask.device)
    shape = shape or cd._launch_shape(P, mask.shape[1], R)
    args = cd.launch_args(pre, pods, mask, out, on_equal, step3, shape)
    check(lib.kt_check_dense(*args) == 0, "bare kt_check_dense launch failed")
    return (lambda: lib.kt_check_dense(*args)), out


def kernel_only_ms(lib, pre, pods, mask, on_equal, step3, iters, flush_bytes=0,
                   shape=None) -> float:
    """Device time of the bare ``kt_check_dense`` call, its arguments built
    once outside the timed region (what ``check_dense`` adds on top is its
    operand checks and the output's allocation)."""
    launch, _ = bare_launch(lib, pre, pods, mask, on_equal, step3, shape)
    return cuda_ms(launch, iters, flush_bytes)


def dense_bound(pre, pods, mask, chunk: int = 16384):
    """Least time of the dense check on these inputs, as a dict: ``bytes_ms``
    (each input read once, the int8 output written once, over HBM
    bandwidth), ``ops_ms`` (the integer operations this data needs over the
    INT32 issue rate), ``bound_ms`` the larger, ``bound_by`` which one.

    Operations: a cell needs compares only where it is affected (mask set,
    pod valid, throttle valid), and there only for each dim where the pod
    request is present and nonzero and the threshold is present. Each such
    (cell, dim) takes two s64 compares (step 1 against the threshold, step 4
    against the residual), each a pair of 32-bit ISETPs."""
    P, R = pods.req.shape
    T = mask.shape[1]
    nbytes = (
        P * R * 8 + P * R + P          # pod req, pod nonzero flags, pod valid
        + T * R * (8 + 8 + 3) + 5 * T  # threshold, residual, 3 dim planes, count flags
        + P * T                        # mask
        + P * T                        # int8 statuses out
    )
    pod_live = pods.req_present & (pods.req != 0) & pods.valid[:, None]  # [P,R]
    thr_live = pre.thr_req_present & pre.valid[:, None]                  # [T,R]
    gated = 0
    for a in range(0, P, chunk):
        m = mask[a:a + chunk]
        for r in range(R):
            gated += int((m & pod_live[a:a + chunk, r, None] & thr_live[None, :, r]).sum())
    ops = gated * 2 * 2
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "ops_ms": t_ops, "int32_ops": ops,
    }


def start_ptxas_report(name: str):
    """Start ``nvcc -Xptxas -v`` on ``csrc/<name>.cu`` with the loader's
    flags, into a scratch library under ``build/kernels/``; returns
    (process, scratch path, expected instantiations)."""
    from kube_throttler_tpu_torch import kernels

    out_dir = kernels.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"ptxas-report-{name}-{os.getpid()}.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
           str(kernels.CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, PTXAS_INSTANTIATIONS[name]


def finish_ptxas_report(proc, out, expected: int):
    """[{kernel, registers, static_smem, stack, spill_stores, spill_loads}]
    for each kernel instantiation in ptxas' report."""
    text, _ = proc.communicate(timeout=600)
    out.unlink(missing_ok=True)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{text[-2000:]}")
    info, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            current = info.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current.update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            current.update(registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0)
    rows = [{"kernel": instantiation(m), **f} for m, f in info.items()
            if instantiation(m) and "registers" in f]
    check(len(rows) == expected,
          f"ptxas reported {len(rows)} of {expected} kernel instantiations")
    return sorted(rows, key=lambda r: r["kernel"])


def instantiation(mangled: str):
    """``reg<on_equal=0,step3_on_equal=1,RB=8>`` (check_dense),
    ``gather<on_equal=0,step3_on_equal=1,statuses=0>`` or
    ``pack_gather_rows`` (check_gather) or
    ``victim<KREG=8,C=1,ring=1>`` (victim_select) for a kernel's mangled name,
    None for any other symbol."""
    k = re.search(r"check_dense_(reg|smem)ILb([01])ELb([01])E(?:Li(\d+)E)?", mangled)
    if k is not None:
        route, oe, s3, rb = k.groups()
        return f"{route}<on_equal={oe},step3_on_equal={s3}" + (f",RB={rb}>" if rb else ">")
    k = re.search(r"check_gather_kernelILb([01])ELb([01])ELb([01])E", mangled)
    if k is not None:
        oe, s3, st = k.groups()
        return f"gather<on_equal={oe},step3_on_equal={s3},statuses={st}>"
    if "pack_gather_rows_kernel" in mangled:
        return "pack_gather_rows"
    k = re.search(r"victim_select_kernelILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if k is not None:
        return "victim<KREG={},C={},ring={}>".format(*k.groups())
    return None


def sass_counts(library: str):
    """{instantiation: {sass_instructions, sass_ldg, sass_bra, sass_loop}}
    from ``cuobjdump -sass`` of the loaded library (NOPs left out;
    ``sass_loop`` is the longest backward branch's span in instructions:
    one step of the pod-strip loop); {} where the toolkit has no
    ``cuobjdump``."""
    from kube_throttler_tpu_torch import kernels

    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    proc = subprocess.run([str(tool), "-sass", library], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-2000:]}")
    counts, current = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(instantiation(m.group(1)) or m.group(1), Counter())
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*(\S*)",
                      line)
        if m and current is not None and m.group(2) != "NOP":
            addr, op, target = int(m.group(1), 16), m.group(2), m.group(4).rstrip(";")
            current["sass_instructions"] += 1
            current["sass_ldg"] += op == "LDG"
            current["sass_bra"] += op == "BRA"
            if op == "BRA" and target.startswith("0x") and int(target, 16) < addr:
                span = (addr - int(target, 16)) // 16 + 1
                current["sass_loop"] = max(current["sass_loop"], span)
    return {k: dict(v) for k, v in counts.items()}


# --------------------------------------------------------------- main path


def cluster_objects(n_pods, n_throttles, groups, n_cluster, seed):
    """The main path's cluster as the port's objects: the namespace, the
    Throttles, the ClusterThrottles and the pods. Throttle i selects label
    group ``g{i % groups}``; its threshold blocks every 5th (cpu) or 7th
    (pod count) group in its last two tiers and is roomy otherwise.
    ClusterThrottle j selects the groups ≡ j (mod n_cluster) and takes one
    of four threshold shapes so all four statuses occur: cpu 300m (exceeds
    / active), roomy (not-throttled), used + 300m cpu (insufficient /
    not-throttled), and a pod count below its pod count (active)."""
    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.api.types import (
        ClusterThrottle, ClusterThrottleSelector, ClusterThrottleSelectorTerm,
        ClusterThrottleSpec, LabelSelector, ResourceAmount, Throttle,
        ThrottleSelector, ThrottleSelectorTerm, ThrottleSpec,
    )

    rng = random.Random(seed)
    pod_plan = [(rng.randrange(groups), rng.randrange(1, 8) * 100) for _ in range(n_pods)]
    cl_cpu = [0] * n_cluster
    cl_cnt = [0] * n_cluster
    for g, cpu in pod_plan:
        cl_cpu[g % n_cluster] += cpu
        cl_cnt[g % n_cluster] += 1

    roomy = ResourceAmount.of(pod=10**6, requests={"cpu": "100000"})
    tiers = max(n_throttles // groups, 1)
    throttles = []
    for i in range(n_throttles):
        g, tier = i % groups, i // groups
        if tier == tiers - 1 and g % 5 == 0:
            threshold = ResourceAmount.of(requests={"cpu": "10"})
        elif tier == tiers - 2 and g % 7 == 0:
            threshold = ResourceAmount.of(pod=50)
        else:
            threshold = roomy
        throttles.append(Throttle(
            name=f"t{i}",
            spec=ThrottleSpec(
                throttler_name="kube-throttler", threshold=threshold,
                selector=ThrottleSelector(selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"grp": f"g{g}"})),
                )),
            ),
        ))
    cluster_throttles = []
    for j in range(n_cluster):
        shape = j % 4
        if shape == 0:
            threshold = ResourceAmount.of(requests={"cpu": "300m"})
        elif shape == 1:
            threshold = roomy
        elif shape == 2:
            threshold = ResourceAmount.of(requests={"cpu": f"{cl_cpu[j] + 300}m"})
        else:
            threshold = ResourceAmount.of(pod=max(cl_cnt[j] // 2, 1))
        cluster_throttles.append(ClusterThrottle(
            name=f"c{j}",
            spec=ClusterThrottleSpec(
                throttler_name="kube-throttler", threshold=threshold,
                selector=ClusterThrottleSelector(selector_terms=(
                    ClusterThrottleSelectorTerm(
                        pod_selector=LabelSelector(match_labels={"mod": f"m{j}"})
                    ),
                )),
            ),
        ))
    pods = [
        make_pod(
            f"p{i}", labels={"grp": f"g{g}", "mod": f"m{g % n_cluster}"},
            requests={"cpu": f"{cpu}m"}, node_name="node-1", phase="Running",
        )
        for i, (g, cpu) in enumerate(pod_plan)
    ]
    return Namespace("default"), throttles, cluster_throttles, pods


def load_cluster(store, objects) -> None:
    """Create ``cluster_objects``' objects in ``store``: the namespace, each
    Throttle and ClusterThrottle, then the pods in batches of 10,000."""
    namespace, throttles, cluster_throttles, pods = objects
    store.create_namespace(namespace)
    for t in throttles:
        store.create_throttle(t)
    for t in cluster_throttles:
        store.create_cluster_throttle(t)
    for i in range(0, len(pods), 10_000):
        for res in store.apply_events([("create", "Pod", p) for p in pods[i:i + 10_000]]):
            if isinstance(res, Exception):
                raise res


def build_cluster(device, n_pods, n_throttles, groups, n_cluster, seed):
    """The served stack, from the port alone: store → device mirror →
    controllers, over ``cluster_objects``."""
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, use_device=True, device=device,
    )
    load_cluster(store, cluster_objects(n_pods, n_throttles, groups, n_cluster, seed))
    return plugin


def drive_main_path(plugin, calls: int, sample: int, seed: int):
    """run_pending_once, prewarm, then ``calls`` × pre_filter_batch with
    the kernels' launch counts zeroed just before and read just after."""
    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops import check_gather as cg
    from kube_throttler_tpu_torch.utils.gchygiene import freeze_startup_heap

    dm = plugin.device_manager
    t0 = time.perf_counter()
    n_rec = plugin.run_pending_once()
    t_rec = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_warm = dm.prewarm()
    t_warm = time.perf_counter() - t0
    # the daemon's last pre-serving step (as the bench's served stack
    # takes it): freeze the startup heap so full GCs stay out of the calls
    frozen = freeze_startup_heap()
    say("main-path", reconciled=n_rec, reconcile_s=f"{t_rec:.3f}",
        prewarm_dispatches=n_warm, prewarm_s=f"{t_warm:.3f}", gc_frozen=frozen)

    def split(phase):
        return phase_total(plugin, phase)

    per_call, routes, out = [], [], None
    cd.launches = cg.launches = cg.pack_launches = 0
    for _ in range(calls):
        d0, m0, l0 = split("batch_dispatch"), split("batch_merge"), cd.launches
        x0, g0, k0 = split("batch_dedupe"), cg.launches, cg.pack_launches
        t0 = time.perf_counter()
        out = plugin.pre_filter_batch()
        dt = time.perf_counter() - t0
        d1, m1, x1 = split("batch_dispatch"), split("batch_merge"), split("batch_dedupe")
        per_call.append((dt, d1[0] - d0[0], m1[0] - m0[0], d1[1] - d0[1],
                         cd.launches - l0, x1[0] - x0[0], cg.launches - g0,
                         cg.pack_launches - k0))
        routes.append(dict(dm.last_batch_routes))
    launches, gather_launches, pack_launches = cd.launches, cg.launches, cg.pack_launches

    n_probe, mismatches, tally, cl_tally = oracle_check(plugin, out, sample, seed)
    shapes = {
        kind: {"pods": ks.pcap, "throttles": ks.tcap, "dims": ks.R, "cols_K": ks._cols_K}
        for kind, ks in (("throttle", dm.throttle), ("clusterthrottle", dm.clusterthrottle))
    }
    return dict(
        shapes=shapes, per_call=per_call, routes=routes, launches=launches,
        gather_launches=gather_launches, pack_launches=pack_launches,
        breaker=dm.breaker_state(), n_verdicts=len(out["schedulable"]),
        errors=len(out["errors"]), oracle_n=n_probe, oracle_mismatches=mismatches,
        tally=tally, cluster_tally=cl_tally, verdicts=out["schedulable"],
    )


def oracle_check(plugin, out, sample: int, seed: int):
    """(pods probed, verdicts differing, tally, ClusterThrottle tally): a
    seeded sample of the stored pods, each checked by the host oracle
    (the controllers' ``check_throttled``) against the batch's verdict in
    ``out``."""
    pods = plugin.listers.pods.list()
    rng = random.Random(seed + 1)
    probe = rng.sample(pods, min(sample, len(pods)))
    mismatches = 0
    tally = {"schedulable": 0, "exceeds": 0, "active": 0, "insufficient": 0}
    cl_tally = dict(tally)
    for pod in probe:
        ta, ti, te, _ = plugin.throttle_ctr.check_throttled(pod, False)
        ca, ci, ce, _ = plugin.cluster_throttle_ctr.check_throttled(pod, False)
        want = not (ta or ti or te or ca or ci or ce)
        mismatches += out["schedulable"].get(pod.key) is not want
        tally["schedulable"] += want
        for name, lst in (("exceeds", te or ce), ("active", ta or ca), ("insufficient", ti or ci)):
            tally[name] += bool(lst)
        cl_tally["exceeds"] += bool(ce)
        cl_tally["active"] += bool(ca) and not ce
        cl_tally["insufficient"] += bool(ci) and not (ce or ca)
        cl_tally["schedulable"] += not (ce or ca or ci)
    return len(probe), mismatches, tally, cl_tally


def phase_total(plugin, phase):
    """(seconds, count) the plugin's tracer has summed for ``phase``."""
    snap = plugin.tracer.snapshot(phase)
    return (snap["sum"], snap["count"]) if snap else (0.0, 0)


def written_used(store):
    """{kind: {throttle key: written status.used pod count}}."""
    return {
        kind: {t.key: t.status.used.resource_counts or 0 for t in lister()}
        for kind, lister in (("throttle", store.list_throttles),
                             ("clusterthrottle", store.list_cluster_throttles))
    }


def tick_once(plugin, label: str, verdicts):
    """One ``plugin.full_tick_sharded(1)``, its phase split, check_dense
    and check_gather launches and peak device memory on a line; fails
    unless it ran on the 1×1 grid, launched both kernels, agrees with
    ``verdicts`` for every pod and with the written used counts of every
    throttle."""
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops import check_gather as cg

    before = {ph: phase_total(plugin, ph)[0] for ph in TICK_PHASES}
    l0, g0, k0 = cd.launches, cg.launches, cg.pack_launches
    torch.cuda.reset_peak_memory_stats()
    out = plugin.full_tick_sharded(1)
    launched, gathered, packed = cd.launches - l0, cg.launches - g0, cg.pack_launches - k0
    peak = torch.cuda.max_memory_allocated()
    split = {f"{ph}_ms": f"{(phase_total(plugin, ph)[0] - before[ph]) * 1e3:.3f}"
             for ph in TICK_PHASES}
    routes = plugin.device_manager.last_tick
    say("tick", call=label, **split, check_dense_launches=launched,
        check_gather_launches=gathered, pack_launches=packed, mesh=json.dumps(out["mesh"]),
        max_memory_allocated=peak, routes=json.dumps(routes, sort_keys=True))
    check(out["mesh"] == [1, 1], f"tick {label} ran on mesh {out['mesh']}")
    check(launched >= 1, f"check_dense was not launched in tick {label}")
    check(gathered >= 1, f"check_gather was not launched in sparse tick {label}")
    check(packed == gathered, f"{packed} packs for {gathered} check_gather launches in {label}")
    check(routes["throttle"]["route"] == "sparse" and routes["clusterthrottle"]["route"] == "dense",
          f"unexpected tick routes {routes}")
    check(out["errors"] == [] and len(out["schedulable"]) == N_PODS, "tick verdicts missing")
    check(out["schedulable"] == verdicts, f"tick {label} disagrees with pre_filter_batch")
    check(out["used"] == written_used(plugin.store),
          f"tick {label} used disagrees with the written statuses")
    return out, launched


def edit_overrides(plugin, every: int = 10, offset: int = 3):
    """Every ``every``-th Throttle (t3, t13, ...: groups that no
    Throttle's own threshold blocks, unlike t0's) gains two
    temporaryThresholdOverrides: an expired window (roomy), then a window
    active now whose pod count of 1 throttles any group with a running
    pod. Returns the count edited."""
    from dataclasses import replace
    from datetime import datetime, timedelta, timezone

    from kube_throttler_tpu_torch.api.types import ResourceAmount, TemporaryThresholdOverride

    now = datetime.now(timezone.utc)
    rfc = lambda dt: dt.strftime("%Y-%m-%dT%H:%M:%SZ")  # noqa: E731
    windows = (
        TemporaryThresholdOverride(begin=rfc(now - timedelta(hours=3)),
                                   end=rfc(now - timedelta(hours=2)),
                                   threshold=ResourceAmount.of(pod=10**6)),
        TemporaryThresholdOverride(begin=rfc(now - timedelta(hours=1)),
                                   end=rfc(now + timedelta(hours=1)),
                                   threshold=ResourceAmount.of(pod=1)),
    )
    store = plugin.store
    edited = 0
    for thr in store.list_throttles():
        if int(thr.name[1:]) % every == offset:
            store.update_throttle_spec(
                replace(thr, spec=replace(thr.spec, temporary_threshold_overrides=windows))
            )
            edited += 1
    return edited


def drive_tick(plugin, verdicts, calls: int):
    """The reconcile tick over the main path's cluster: ``calls`` ticks
    with the kernel count zeroed just before and read just after, the
    override edit and a tick after it, and one dense tick at full width
    against a sparse one. Returns the numbers the kernels line reports."""
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops import check_gather as cg
    from kube_throttler_tpu_torch.parallel import make_mesh

    dm = plugin.device_manager
    cd.launches = cg.launches = cg.pack_launches = 0
    for i in range(calls):
        tick_once(plugin, str(i), verdicts)
    launches, gather_launches, pack_launches = cd.launches, cg.launches, cg.pack_launches

    t0 = time.perf_counter()
    edited = edit_overrides(plugin)
    n_rec = plugin.run_pending_once()
    t_edit = time.perf_counter() - t0
    after = plugin.pre_filter_batch()["schedulable"]
    changed = sum(after[k] != v for k, v in verdicts.items())
    tick, _ = tick_once(plugin, "after-overrides", after)
    overrides = dm.last_tick["throttle"]["overrides"]
    say("tick-overrides", throttles_edited=edited, reconciled=n_rec,
        edit_and_reconcile_s=f"{t_edit:.3f}", verdicts_changed=changed,
        schedulable=sum(after.values()), override_capacity=overrides)
    check(edited == N_THROTTLES // 10, f"{edited} Throttles edited")
    check(changed >= 1, "the override edit changed no verdict")
    check(overrides >= 2, f"the tick encoded O = {overrides} overrides")

    grid = make_mesh(device=dm.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    l0 = cd.launches
    t0 = time.perf_counter()
    dense = dm.full_tick_sharded(grid, dense_mesh=True)
    t_dense = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated()
    dense_launches = cd.launches - l0
    dense_routes = dm.last_tick
    sparse = dm.full_tick_sharded(grid)
    same = all(
        np.array_equal(dense[k][i], sparse[k][i]) for k in sparse for i in (0, 1, 3, 4)
    ) and all(dense[k][2] == sparse[k][2] and dense[k][5] == sparse[k][5] for k in sparse)
    shapes = {k: list(dense[k][0].shape[:1]) + list(dense[k][4].shape) for k in dense}
    say("tick-dense", seconds=f"{t_dense:.3f}", max_memory_allocated=dense_peak,
        check_dense_launches=dense_launches, equal_to_sparse=same,
        routes=json.dumps(dense_routes, sort_keys=True), pods_throttles_dims=json.dumps(shapes))
    check(all(r["route"] == "dense" for r in dense_routes.values()), "dense tick took the sparse route")
    check(dense_launches == 2, f"the dense tick launched check_dense {dense_launches} times")
    check(same, "the dense tick disagrees with the sparse tick")
    return dict(launches=launches, gather_launches=gather_launches, pack_launches=pack_launches,
                dense_launches=dense_launches, dense_s=t_dense, dense_peak=dense_peak,
                gather=time_tick_parts(dm))


def step_args(dm, kind: str, dense: bool, now=None):
    """One kind's full update step operands, derived from the mirror as
    ``full_tick_sharded`` derives them: ``(sched, pods, cols or mask,
    counted, res_cnt, res_cnt_present, res_req, res_req_present,
    thr_valid, now_ns)``, and the snapshot's throttle capacity."""
    from datetime import datetime, timezone

    import torch

    from kube_throttler_tpu_torch.ops.overrides import _datetime_to_ns

    with dm._lock:  # noqa: SLF001 — the snapshot full_tick_sharded takes
        snap = dm._tick_snapshot_locked(dm._kind(kind), dense_mesh=dense)
    sched = dm._tick_encode(snap)
    dev = dm.device
    res = tuple(torch.from_numpy(a).to(dev) for a in snap["res"])
    thr_valid = torch.from_numpy(snap["thr_valid"]).to(dev)
    now_ns = torch.tensor(int(_datetime_to_ns(now or datetime.now(timezone.utc))), device=dev)
    x = snap["mask"] if dense else snap["cols"]
    return (sched, snap["pods"], x, snap["counted"], *res, thr_valid, now_ns), snap["tcap"]


def tick_inputs(dm):
    """The Throttle kind's sparse tick operands, derived from the mirror as
    ``full_tick_sharded`` derives them: (sched, now_ns, pods, cols,
    counted, T, res, thr_valid, thr, used_cnt, used_req, contrib, state),
    ``state`` being the ThrottleState that the tick's check_gather reads."""
    from kube_throttler_tpu_torch.ops.overrides import calculate_thresholds
    from kube_throttler_tpu_torch.parallel import sharded

    (sched, pods, cols, counted, *res, thr_valid, now_ns), T = step_args(dm, "throttle", False)
    res = tuple(res)
    thr = calculate_thresholds(sched, now_ns)
    used_cnt, used_req, contrib = sharded.used_from_cols(pods, cols, counted, T)
    state, _, _ = sharded._derived_state(sched, now_ns, used_cnt, used_req, contrib,
                                         *res, thr_valid)
    return (sched, now_ns, pods, cols, counted, T, res, thr_valid, thr, used_cnt, used_req,
            contrib, state)


def time_tick_parts(dm):
    """CUDA-event times of the Throttle kind's sparse tick parts at the
    main path's own state (L2 flushed before each timed call), with
    check_gather held against its plain version on that state first; the
    wrapper's time of both forms (pack and check, as the main path calls
    them) and, beside it, each kernel's device time alone (``device_only_ms`` of
    the bare calls, the check over records packed once), the live slots and
    (slot, dim) pairs, and the records' bytes. Returns check_gather's
    numbers for the kernels line."""
    from kube_throttler_tpu_torch.ops import check_gather as cg
    from kube_throttler_tpu_torch.ops.aggregate import throttled_flags
    from kube_throttler_tpu_torch.ops.check import check_pods_gather
    from kube_throttler_tpu_torch.ops.overrides import calculate_thresholds
    from kube_throttler_tpu_torch.parallel import sharded

    (sched, now_ns, pods, cols, counted, T, res, thr_valid, thr, used_cnt, used_req, contrib,
     state) = tick_inputs(dm)
    bad, err, status_counts = compare_gather(state, pods, cols, False, True)
    check(bad == 0, "check_gather disagrees with its plain version at the tick's state")
    flush = 64 << 20
    parts = {
        "calculate_thresholds_ms": cuda_ms(lambda: calculate_thresholds(sched, now_ns), 20, flush),
        "used_scatter_ms": cuda_ms(lambda: sharded.used_from_cols(pods, cols, counted, T), 20,
                                   flush),
        "throttled_flags_ms": cuda_ms(lambda: throttled_flags(
            *thr, used_cnt, used_cnt > 0, used_req, contrib > 0), 20, flush),
        "check_pods_gather_ms": cuda_ms(lambda: check_pods_gather(
            state, pods, cols, on_equal=False, step3_on_equal=True), 50, flush),
        "check_gather_statuses_ms": cuda_ms(lambda: cg.check_gather(
            state, pods, cols, False, True, statuses=True), 50, flush),
        "plain_ms": cuda_ms(lambda: cg.check_gather_reference(state, pods, cols, False, True),
                            20, flush),
        "full_update_step_gather_ms": cuda_ms(lambda: sharded.full_update_step_gather(
            sched, pods, cols, counted, *res, thr_valid, now_ns), 20, flush),
    }
    pack, check_counts, packed = gather_bare(state, pods, cols, statuses=False)
    _, check_statuses, _ = gather_bare(state, pods, cols, statuses=True)
    # the wrapper's calls again, the host's enqueue hidden: pack and check on the card
    parts["check_pods_gather_device_ms"] = device_only_ms(lambda: check_pods_gather(
        state, pods, cols, on_equal=False, step3_on_equal=True), 50, flush)
    parts["check_gather_statuses_device_ms"] = device_only_ms(lambda: cg.check_gather(
        state, pods, cols, False, True, statuses=True), 50, flush)
    parts["pack_ms"] = device_only_ms(pack, 50, flush)
    parts["kernel_only_ms"] = device_only_ms(check_counts, 50, flush)
    parts["statuses_kernel_only_ms"] = device_only_ms(check_statuses, 50, flush)
    P, K = cols.shape
    R = pods.req.shape[1]
    bound = gather_bound(state, pods, cols)
    live = gather_live(state, pods, cols)
    packed_bytes = packed.numel() * 8
    # the pack reads each plane once: 3 int64 and 5 bool planes of [T] and of [T,R]
    pack_read_bytes = T * (1 + R) * (3 * 8 + 5)
    parts["check_pods_gather_bound_ms"] = bound["bound_ms"]
    say("time", route="throttle-tick", shape=f"{P}x{K}x{R} (T={T}, "
        f"O={sched.ov_valid.shape[1]}, rows={bound['rows']}, row_dims={bound['row_dims']})",
        **{k: f"{v:.5f}" for k, v in parts.items()}, bound_by=bound["bound_by"],
        bytes_ms=f"{bound['bytes_ms']:.5f}", ops_ms=f"{bound['ops_ms']:.5f}",
        bound_bytes=bound["bytes"], **live, packed_bytes=packed_bytes,
        pack_read_bytes=pack_read_bytes, record=json.dumps(cg.record_layout(R)._asdict()),
        kernel_vs_plain_mismatches=bad, status_counts=status_counts, l2="flushed")
    return dict(ms=parts["check_pods_gather_ms"], statuses_ms=parts["check_gather_statuses_ms"],
                plain_ms=parts["plain_ms"], step_ms=parts["full_update_step_gather_ms"],
                device_ms=parts["check_pods_gather_device_ms"],
                statuses_device_ms=parts["check_gather_statuses_device_ms"],
                pack_ms=parts["pack_ms"], kernel_only_ms=parts["kernel_only_ms"],
                statuses_kernel_only_ms=parts["statuses_kernel_only_ms"],
                packed_bytes=packed_bytes, **live,
                shape=[P, K, T, R], err=err, mismatches=bad, **bound)


# --------------------------------------------------------------- grid


def kernel_counts() -> dict:
    """The grid path's wrapper counts: check_dense, and check_gather's
    checks and packs."""
    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops import check_gather as cg

    return {"check_dense": cd.launches, "check_gather": cg.launches,
            "pack_gather_rows": cg.pack_launches}


def same_tick(got: dict, want: dict) -> bool:
    """Two ``full_tick_sharded`` results agree: counts, schedulable,
    used_cnt and used_req (dtypes too), row and col maps, both kinds."""
    return set(got) == set(want) and all(
        got[k][2] == want[k][2] and got[k][5] == want[k][5] and all(
            got[k][i].dtype == want[k][i].dtype and np.array_equal(got[k][i], want[k][i])
            for i in (0, 1, 3, 4))
        for k in want)


def same_outputs(got, want) -> bool:
    """Two steps' six outputs agree: dtypes, shapes and values."""
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and bool((g.cpu() == w.cpu()).all())
        for g, w in zip(got, want))


def grid_tick(plugin, grid, label: str, want: dict, now, dense: bool = False) -> dict:
    """One ``full_tick_sharded`` over ``grid``: its wall ms and tracer
    split, each kernel's launches against what a dp × tp tick must launch,
    peak device memory, on a ``[grid]`` line; fails unless it ≡ ``want``."""
    import torch

    dm = plugin.device_manager
    dp, tp = grid.dp, grid.tp
    before = {ph: phase_total(plugin, ph)[0] for ph in TICK_PHASES[1:]}
    k0 = kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = dm.full_tick_sharded(grid, now=now, dense_mesh=dense)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = {k: v - k0[k] for k, v in kernel_counts().items()}
    routes = {k: v["route"] for k, v in dm.last_tick.items()}
    # a dp × tp tick: dp·tp check_gather packs and checks for a sparse kind,
    # dp·tp check_dense launches for a dense one
    n_dense = sum(r == "dense" for r in routes.values())
    expect = {"check_dense": n_dense * dp * tp,
              "check_gather": (2 - n_dense) * dp * tp,
              "pack_gather_rows": (2 - n_dense) * dp * tp}
    equal = same_tick(out, want)
    split = {f"{ph}_ms": f"{(phase_total(plugin, ph)[0] - before[ph]) * 1e3:.3f}"
             for ph in TICK_PHASES[1:]}
    say("grid", tick=label, mesh=json.dumps([dp, tp]), slots=json.dumps(
        sorted({str(d) for row in grid.devices for d in row})), wall_ms=f"{wall * 1e3:.3f}",
        **split, launches=json.dumps(launched), expected_launches=json.dumps(expect),
        max_memory_allocated=peak, routes=json.dumps(routes, sort_keys=True),
        equal_to_1x1=equal)
    check(routes == ({"throttle": "dense", "clusterthrottle": "dense"} if dense
                     else {"throttle": "sparse", "clusterthrottle": "dense"}),
          f"grid tick {label} took routes {routes}")
    check(launched == expect, f"grid tick {label} launched {launched}, not {expect}")
    check(equal, f"grid tick {label} disagrees with the 1x1 tick")
    return dict(wall_ms=wall * 1e3, launches=launched, peak=peak)


def rank_children(inp: Path, backend: str, device: str, deadline_s: float) -> dict:
    """GRID_RANKS children of this script (``--grid-rank``), each in a
    session of its own, meeting through a ``file://`` rendezvous; all are
    killed whole when one fails or the deadline passes. ``backend`` ""
    leaves the choice to ``init_distributed`` (NCCL on the card)."""
    import signal

    tag = backend or "default"
    init = f"file://{GRID_ROOT / f'rendezvous-{tag}'}"
    env = {**os.environ, "PYTHONPATH": str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    outs = [GRID_ROOT / f"out{r}-{tag}.pt" for r in range(GRID_RANKS)]
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(GRID_RANKS):
            log = GRID_ROOT / f"rank{r}-{tag}.log"
            logs.append(log)
            with open(log, "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "chip_smoke.py"), "--grid-rank", str(r),
                     str(GRID_RANKS), init, backend, device, str(inp), str(outs[r])],
                    stdout=err, stderr=subprocess.STDOUT, env=env, start_new_session=True,
                ))
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs) and time.monotonic() < end:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one rank failed: the other would wait for it
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    tails = [log.read_text(errors="replace").strip().splitlines()[-3:] for log in logs]
    return dict(rcs=[p.returncode for p in procs], seconds=time.perf_counter() - t0,
                tails=tails, outs=outs)


def drive_ranks(dm, now) -> dict:
    """The two-rank leg: the Throttle kind's sparse step operands saved
    once, GRID_RANKS children each running the sparse grid step over its
    share of the pods (a (1, 2) grid of slots on the card each, the pods
    axis spanning the processes), their outputs laid end to end ≡ the 1×1
    step's. NCCL first; if it refuses two ranks on one card, gloo,
    passed explicitly."""
    import torch

    from kube_throttler_tpu_torch.parallel import full_update_step_gather

    args, _ = step_args(dm, "throttle", False, now)
    want = full_update_step_gather(*args)
    inp = GRID_ROOT / "inputs.pt"
    torch.save(args, inp)
    attempts = {}
    for backend, deadline in (("", GRID_NCCL_DEADLINE_S), ("gloo", GRID_RANK_DEADLINE_S)):
        r = rank_children(inp, backend, str(dm.device), deadline)
        name = backend or "nccl"
        attempts[name] = r
        if all(rc == 0 for rc in r["rcs"]):
            outs = [torch.load(o, weights_only=False) for o in r["outs"]]
            got = (torch.cat([o["outs"][0] for o in outs]), torch.cat([o["outs"][1] for o in outs]),
                   *outs[0]["outs"][2:])
            equal = same_outputs(got, want) and all(
                same_outputs(o["outs"][2:], outs[0]["outs"][2:]) for o in outs)
            say("grid", step="ranks", backend=outs[0]["backend"], ranks=GRID_RANKS,
                mesh=json.dumps(outs[0]["mesh"]), seconds=f"{r['seconds']:.3f}",
                rank_step_ms=json.dumps([round(o["ms"], 3) for o in outs]),
                rank_launches=json.dumps([o["launches"] for o in outs]),
                equal_to_1x1=equal,
                nccl=repr(attempts["nccl"]["tails"]) if name == "gloo" else "'used'")
            check(equal, f"the {GRID_RANKS} {name} ranks disagree with the 1x1 step")
            for o in outs:
                check(o["launches"]["check_gather"] == 2 and o["launches"]["pack_gather_rows"] == 2,
                      f"a rank launched {o['launches']}, not 2 packs and 2 checks")
            return dict(backend=outs[0]["backend"], launches=[o["launches"] for o in outs],
                        nccl_tails=attempts["nccl"]["tails"], seconds=r["seconds"])
        say("grid", step="ranks-refused", backend=name, rcs=json.dumps(r["rcs"]),
            seconds=f"{r['seconds']:.3f}", tails=repr(r["tails"]))
    check(False, "no backend ran the ranks")


def grid_rank_child(rank: str, world: str, init: str, backend: str, device: str, inp: str,
                    out: str) -> int:
    """One rank of the ``[grid]`` phase's multi-process leg, in this fresh
    interpreter: ``init_distributed`` (``backend`` "" = its own choice),
    a ``hybrid_mesh`` of (1, 2) slots on the card, the sparse grid step over
    this rank's share of the pods; saves the outputs, this process's
    kernel launches, the backend and the step's ms."""
    import torch
    import torch.distributed as dist

    from kube_throttler_tpu_torch.ops.schema import PodBatch
    from kube_throttler_tpu_torch.parallel import (
        hybrid_mesh,
        init_distributed,
        sharded_full_update_gather,
    )

    rank, world = int(rank), int(world)
    sched, pods, cols, counted, *rest = torch.load(inp, map_location=device, weights_only=False)
    reset_launches()
    init_distributed(init, world, rank, device=device, backend=backend or None)
    try:
        grid = hybrid_mesh(ici_shape=(1, 2), devices=[device] * 2)
        n = counted.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        mine = PodBatch(valid=pods.valid[rows], req=pods.req[rows],
                        req_present=pods.req_present[rows])
        t0 = time.perf_counter()
        outs = sharded_full_update_gather(grid)(sched, mine, cols[rows], counted[rows], *rest)
        outs[0].cpu()  # waits for the device
        ms = (time.perf_counter() - t0) * 1e3
        torch.save(dict(outs=[o.cpu() for o in outs], launches=kernel_counts(), ms=ms,
                        backend=dist.get_backend(), mesh=[grid.shape["pods"], grid.shape["throttles"]]),
                   out)
    finally:
        dist.destroy_process_group()
    return 0


def drive_grid(plugin, card_name: str) -> dict:
    """The ``[grid]`` phase over the main path's cluster: the 1×1 tick, then
    ``full_tick_sharded`` over GRID_SLOTS slots on the card at each of
    GRID_SHAPES and once with ``dense_mesh`` (≡ the 1×1 dense tick); the
    ring over the Throttle kind's dense operands (≡ the 1×1 dense step);
    the sharded delta apply (≡ the single-device apply with negative ids
    dropped); the plugin's visible-count refusal; the ranks. Launch counts
    are set to 0 just before and read just after. Returns the launches and
    what the kernels line reports."""
    from datetime import datetime, timezone

    import torch

    from kube_throttler_tpu_torch.ops.aggregate import apply_pod_deltas_batched
    from kube_throttler_tpu_torch.parallel import (
        full_update_step,
        make_mesh,
        make_ring_mesh,
        ring_full_update,
        sharded,
        sharded_apply_deltas,
    )

    dm = plugin.device_manager
    card = dm.device
    now = datetime.now(timezone.utc)
    shutil.rmtree(GRID_ROOT, ignore_errors=True)
    GRID_ROOT.mkdir(parents=True)
    reset_launches()
    # the 1×1 ticks the grids are held against, each timed on a second run
    single = make_mesh(device=card)
    one = dm.full_tick_sharded(single, now=now)
    ticks = {"1x1": grid_tick(plugin, single, "1x1", one, now)}
    for shape in GRID_SHAPES:
        label = "x".join(map(str, shape))
        grid = make_mesh(GRID_SLOTS, shape, devices=[card] * GRID_SLOTS)
        ticks[label] = grid_tick(plugin, grid, label, one, now)
    one_dense = dm.full_tick_sharded(single, now=now, dense_mesh=True)
    ticks["1x1-dense"] = grid_tick(plugin, single, "1x1-dense", one_dense, now, dense=True)
    grid = make_mesh(GRID_SLOTS, (2, 2), devices=[card] * GRID_SLOTS)
    ticks["2x2-dense"] = grid_tick(plugin, grid, "2x2-dense", one_dense, now, dense=True)
    del one_dense

    # the ring over the Throttle kind's dense operands ≡ the 1×1 dense step
    args, T = step_args(dm, "throttle", True, now)
    want = full_update_step(*args)
    k0 = kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = ring_full_update(make_ring_mesh(RING_SLOTS, devices=[card] * RING_SLOTS))(*args)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    ring_launches = kernel_counts()["check_dense"] - k0["check_dense"]
    equal = same_outputs(got, want)
    say("grid", step="ring", slots=RING_SLOTS,
        shape=f"{args[2].shape[0]}x{T}x{args[1].req.shape[1]}",
        wall_ms=f"{ring_ms:.3f}", check_dense_launches=ring_launches,
        expected=RING_SLOTS ** 2, max_memory_allocated=torch.cuda.max_memory_allocated(),
        equal_to_1x1_dense=equal)
    check(ring_launches == RING_SLOTS ** 2, f"the ring launched check_dense {ring_launches} times")
    check(equal, "the ring disagrees with the 1x1 dense step")
    del args, want, got
    torch.cuda.empty_cache()

    # the sharded delta apply over the tick's own used sums
    sargs, T = step_args(dm, "throttle", False, now)
    sched, pods, cols, counted = sargs[:4]
    base = sharded.used_from_cols(pods, cols, counted, T)
    R = pods.req.shape[1]
    g = torch.Generator(device=card).manual_seed(SEED)
    shape = (DELTA_EVENTS, DELTA_SLOTS)
    ids = torch.randint(-T, T + 1, shape, generator=g, device=card, dtype=torch.int32)
    sign = torch.randint(-1, 2, shape, generator=g, device=card, dtype=torch.int64)
    pod_req = torch.randint(0, 2**40, (DELTA_EVENTS, R), generator=g, device=card,
                            dtype=torch.int64)
    present = torch.rand((DELTA_EVENTS, R), generator=g, device=card) < 0.7
    want = apply_pod_deltas_batched(*base, torch.where(ids < 0, T, ids), sign, pod_req, present)
    counted_from_end = apply_pod_deltas_batched(*base, ids, sign, pod_req, present)
    t0 = time.perf_counter()
    got = sharded_apply_deltas(make_mesh(GRID_SLOTS, (1, GRID_SLOTS),
                                         devices=[card] * GRID_SLOTS))(
        *base, ids, sign, pod_req, present)
    torch.cuda.synchronize()
    delta_ms = (time.perf_counter() - t0) * 1e3
    equal = same_outputs(got, want)
    negatives = int((ids < 0).sum())
    say("grid", step="deltas", mesh=json.dumps([1, GRID_SLOTS]), events=DELTA_EVENTS,
        slots_per_event=DELTA_SLOTS, negative_ids=negatives, wall_ms=f"{delta_ms:.3f}",
        equal_to_single_with_negatives_dropped=equal,
        differs_from_negatives_counted_from_end=not same_outputs(got, counted_from_end))
    check(negatives > 0 and equal, "the sharded delta apply disagrees with the single-device one")
    del base, want, got, counted_from_end

    # more slots than visible cards: refused by the plugin's surface
    try:
        plugin.full_tick_sharded(GRID_SLOTS, (2, 2))
        refused = None
    except ValueError as e:
        refused = str(e)
    say("grid", step="visible-count", refused=repr(refused))
    check(refused is not None and "visible" in refused,
          "a 4-card grid on a one-card host was not refused")

    ranks = drive_ranks(dm, now)
    launches = kernel_counts()
    say("grid", step="summary", launches=json.dumps(launches),
        rank_launches=json.dumps(ranks["launches"]), backend=ranks["backend"],
        card=repr(card_name))
    shutil.rmtree(GRID_ROOT, ignore_errors=True)
    return dict(launches=launches, ticks=ticks, ring_ms=ring_ms, delta_ms=delta_ms,
                ranks=ranks)


def drive_coalesce(plugin, seed: int):
    """The ``[coalesce]`` phase: ``check_pods_multi`` over COALESCE_PODS
    stored pods per kind, on the device route (forced) against the host
    route, with the check_gather launch count read around each device
    call: one launch per kind per call."""
    from kube_throttler_tpu_torch.ops import check_gather as cg

    dm = plugin.device_manager
    pods = random.Random(seed).sample(plugin.listers.pods.list(), COALESCE_PODS)
    forced = dm._single_check_device  # noqa: SLF001 — the route's switch
    out = {}
    try:
        for kind in ("throttle", "clusterthrottle"):
            dm._single_check_device = False
            t0 = time.perf_counter()
            host = dm.check_pods_multi(pods, kind)
            t_host = time.perf_counter() - t0
            dm._single_check_device = True
            l0, k0 = cg.launches, cg.pack_launches
            t0 = time.perf_counter()
            device = dm.check_pods_multi(pods, kind)
            t_dev = time.perf_counter() - t0
            launched, packed = cg.launches - l0, cg.pack_launches - k0
            same = device == host
            affected = sum(len(r) for r in host)
            say("coalesce", kind=kind, pods=len(pods), equal_to_host=same,
                check_gather_launches=launched, pack_launches=packed,
                host_ms=f"{t_host * 1e3:.3f}",
                device_ms=f"{t_dev * 1e3:.3f}", affected_slots=affected,
                blocked=sum(any(v != "not-throttled" for v in r.values()) for r in host))
            check(same, f"check_pods_multi on the device route disagrees with the host ({kind})")
            check(launched == 1 and packed == 1,
                  f"check_gather launched {launched} times, its pack {packed}, for one {kind} call")
            check(affected > 0, f"no {kind} matched any of the sampled pods")
            out[kind] = launched
    finally:
        dm._single_check_device = forced
    return out


# --------------------------------------------------------------- gang admission


def add_accel_classes(plugin):
    """The Throttles of the label groups ≡ 7 mod 10 (1,000 of them) gain an
    ``accelClassThresholds`` entry for ``GANG_CLASS``: 1 cpu (tighter than
    the group's running pods) where the group's tens digit is even, roomy
    where it is odd. Returns the count edited."""
    from dataclasses import replace

    from kube_throttler_tpu_torch.api.types import AccelClassThreshold, ResourceAmount

    tight = ResourceAmount.of(requests={"cpu": "1"})
    roomy = ResourceAmount.of(pod=10**6, requests={"cpu": "100000"})
    store = plugin.store
    edited = 0
    for thr in store.list_throttles():
        g = int(thr.name[1:]) % GROUPS
        if g % 10 == 7:
            entry = AccelClassThreshold(GANG_CLASS, tight if (g // 10) % 2 == 0 else roomy)
            store.update_throttle_spec(
                replace(thr, spec=replace(thr.spec, accel_class_thresholds=(entry,)))
            )
            edited += 1
    return edited


def build_gangs(plugin, seed: int, n_groups: int = GROUPS):
    """GANGS groups of GANG_SIZE pending members. A gang's members share
    one label group (so each matches its ~20 Throttles and its
    ClusterThrottle) and one cpu request of 10-50m. A quarter of the gangs
    carry ``GANG_CLASS`` and draw their label group from the classed ones;
    the rest draw from all. The first half of each gang's members is
    stored as Pending, the second half is not stored. Returns
    ``[(group key, members, accel class or None)]``."""
    from kube_throttler_tpu_torch.api.pod import make_pod

    rng = random.Random(seed)
    classed = [g for g in range(n_groups) if g % 10 == 7]
    groups, stored = [], []
    for k in range(GANGS):
        cls = GANG_CLASS if k % 4 == 0 else None
        g = rng.choice(classed) if cls else rng.randrange(n_groups)
        cpu = rng.choice((10, 20, 30, 40, 50))
        members = [
            make_pod(f"gang{k}-{r}", labels={"grp": f"g{g}", "mod": f"m{g % N_CLUSTER}"},
                     requests={"cpu": f"{cpu}m"}, group=f"gang{k}", group_size=GANG_SIZE,
                     accel_class=cls)
            for r in range(GANG_SIZE)
        ]
        stored += [("create", "Pod", pod) for pod in members[: GANG_SIZE // 2]]
        groups.append((f"default/gang{k}", members, cls))
    for res in plugin.store.apply_events(stored):
        if isinstance(res, Exception):
            raise res
    return groups


def drive_gang(plugin, seed: int):
    """The ``[gang]`` phase: the accel-class edit and reconcile, then one
    ``gang_check_groups`` over every gang, held against the sequential
    host oracle for every gang, and ``pre_filter_gang`` on 16 of them
    against the batched verdict. Prints the call's wall time (encode
    included) and peak device memory, and the CUDA-event time of its
    ``gang_check_both`` on the operands it built."""
    import torch

    from kube_throttler_tpu_torch.engine.gang import sequential_gang_check
    from kube_throttler_tpu_torch.ops import gang_check as gc

    dm = plugin.device_manager
    t0 = time.perf_counter()
    edited = add_accel_classes(plugin)
    n_rec = plugin.run_pending_once()
    groups = build_gangs(plugin, seed)
    plugin.run_pending_once()
    t_setup = time.perf_counter() - t0

    captured = []
    real = gc.gang_check_both

    def capture(*args, **kwargs):
        captured.append((args, kwargs))
        return real(*args, **kwargs)

    wall = []
    gc.gang_check_both = capture
    try:
        for _ in range(GANG_CALLS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = dm.gang_check_groups(groups)
            wall.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
    finally:
        gc.gang_check_both = real
    args, kwargs = captured[-1]
    device_ms = cuda_ms(lambda: real(*args, **kwargs), 10)

    kinds = (("throttle", plugin.throttle_ctr, False),
             ("clusterthrottle", plugin.cluster_throttle_ctr, False))
    t0 = time.perf_counter()
    oracle = {gk: sequential_gang_check(members, kinds)[0] for gk, members, _ in groups}
    t_oracle = time.perf_counter() - t0
    mismatches = sum(out[gk]["ok"] is not oracle[gk] for gk, _, _ in groups)
    sample = random.Random(seed + 3).sample(groups, GANG_PREFILTER_SAMPLE)
    prefilter_mismatches = sum(
        plugin.pre_filter_gang(gk, members).is_success() is not out[gk]["ok"]
        for gk, members, _ in sample
    )
    fit = sum(v["ok"] for v in out.values())
    classed_fit = sum(out[gk]["ok"] for gk, _, cls in groups if cls)
    a = args[0]
    say("gang", groups=len(groups), members=sum(len(m) for _, m, _ in groups),
        throttles_classed=edited, reconciled=n_rec, setup_s=f"{t_setup:.3f}",
        dispatch_ms=json.dumps([round(w * 1e3, 3) for w in wall]),
        gang_check_both_ms=f"{device_ms:.5f}", max_memory_allocated=peak,
        padded_N_K_T_R=json.dumps([*a["cols"].shape, a["thr_valid"].shape[0],
                                   a["pod_req"].shape[1]]),
        fit=fit, rejected=len(groups) - fit, classed_fit=classed_fit,
        oracle_mismatches=mismatches, oracle_s=f"{t_oracle:.3f}",
        prefilter_sample=len(sample), prefilter_mismatches=prefilter_mismatches,
        breaker=dm.breaker_state())
    check(edited == N_THROTTLES // 10, f"{edited} Throttles classed")
    check(len(out) == GANGS, f"gang_check_groups answered {len(out)} of {GANGS} gangs")
    check(mismatches == 0, f"{mismatches} gang verdicts disagree with the host oracle")
    check(prefilter_mismatches == 0, "pre_filter_gang disagrees with the batched verdict")
    check(fit >= GANGS // 10 and len(groups) - fit >= GANGS // 10,
          f"{fit} of {GANGS} gangs fit: the phase needs >= 10 % of each outcome")
    check(dm.breaker_state() == "closed", f"breaker is {dm.breaker_state()}")
    return dict(wall=wall, device_ms=device_ms, peak=peak, fit=fit)


# --------------------------------------------------------------- victim selection


def victim_problem(rng: np.random.Generator, N: int, M: int, extremes: bool = False):
    """A seeded ranked problem: contrib 90 % zeros, the rest up to 2^40
    milli-units; each deficit a random share of its column's sum (so the
    walk runs deep), a tenth of the dims already met (<= 0). With
    ``extremes`` every value is drawn from EXTREMES (half the contributions
    zero, about half of the rest negative), so that ``remaining - row``
    wraps and negative rows reopen met dims."""
    if extremes:
        ext = np.array(EXTREMES, dtype=np.int64)
        contrib = rng.choice(ext, (N, M))
        contrib[rng.random((N, M)) < 0.5] = 0
        return contrib, rng.choice(ext, M)
    contrib = rng.integers(0, 2**40, (N, M), dtype=np.int64)
    contrib[rng.random((N, M)) < 0.9] = 0
    share = rng.uniform(0.2, 0.8, M)
    deficit = (contrib.sum(0) * share).astype(np.int64)
    deficit[rng.random(M) < 0.1] *= -1
    if N == 1:
        contrib[0, 0], deficit[0] = 5, 3
    return contrib, deficit


def once_ms(fn):
    """(result, device ms) of one call of ``fn``, by CUDA events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def victim_bound(contrib, deficit, cap: int, selected, ok: bool):
    """The least time of this walk, as a dict: the rows it needs (up to the
    take that closed every deficit or reached the cap, else all N), each
    read once with the deficit, and the outputs written once, over HBM
    bandwidth; its operations (per needed row and dim an s64 compare of
    contrib and of remaining and their AND, and per take and dim an s64
    subtraction; an s64 op is two 32-bit ones) over the INT32 issue rate."""
    N, M = contrib.shape
    takes = np.nonzero(selected)[0]
    stopped = ok or (cap > 0 and takes.size >= cap)
    rows = (int(takes[-1]) + 1 if takes.size else 0) if stopped else N
    nbytes = rows * M * 8 + M * 8 + N + 1 + M * 8
    ops = rows * M * (2 * 2 + 1) + takes.size * M * 2
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "rows_walked": rows, "takes": int(takes.size)}


def victim_geometry(M: int):
    """The kernel's route and block geometry for M (``_launch_shape``)."""
    from kube_throttler_tpu_torch.ops import victim_select as vsel

    return vsel._launch_shape(M)._asdict()


def graph_ms(fn, calls: int, reps: int = 3) -> float:
    """Mean device time of one ``fn`` call with no host time between the
    kernels: ``calls`` calls captured in one CUDA graph, replayed ``reps``
    times, by CUDA events. ``fn`` launches on the current stream only."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a warm call off the stream being captured
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * calls)


def compare_victim(contrib, deficit, cap: int, iters: int):
    """Kernel against its plain version on the same card tensors: (equal
    bit for bit, max |remaining difference|, wrapper ms, kernel-only ms,
    plain ms, bound, the kernel's outputs). The wrapper's ms is over
    back-to-back calls, host time included where the host is the slower;
    the kernel's alone is ``graph_ms`` of the same call. Only the public
    wrapper and plain version are called, so ``victim_timing.py`` times
    another checkout's port with this function."""
    import torch

    from kube_throttler_tpu_torch.ops import victim_select as vsel

    c = torch.from_numpy(contrib).cuda()
    d = torch.from_numpy(deficit).cuda()
    got = vsel.victim_select(c, d, cap)
    want, plain_ms = once_ms(lambda: vsel.victim_select_reference(c, d, cap))
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    err = int((got[2] - want[2]).abs().max()) if deficit.size else 0
    k_ms = cuda_ms(lambda: vsel.victim_select(c, d, cap), iters)
    only_ms = graph_ms(lambda: vsel.victim_select(c, d, cap), iters)
    bound = victim_bound(contrib, deficit, cap, want[0].cpu().numpy(), bool(want[1]))
    return same, err, k_ms, only_ms, plain_ms, bound, got


def drive_victim_cells(seed: int):
    """The ``[victim]`` phase: the kernel against its plain version at every
    cell of VICTIM_CELLS and cap, then at the EXTREMES cell. Returns
    per-cell rows for the kernels line, the total mismatches and the
    largest error."""
    rng = np.random.default_rng(seed)
    rows, mismatches, max_err = [], 0, 0
    cells = [(N, M, False) for N, M in VICTIM_CELLS] + [(*VICTIM_EXTREMES_CELL, True)]
    for N, M, extremes in cells:
        contrib, deficit = victim_problem(rng, N, M, extremes)
        geometry = victim_geometry(M)
        for cap in sorted({0, 1, N // 2}):
            iters = 5 if N * M > 10**6 else 20
            same, err, k_ms, bare_ms, p_ms, bound, _ = compare_victim(contrib, deficit, cap,
                                                                      iters)
            mismatches += not same
            max_err = max(max_err, err)
            walked = bound["rows_walked"]
            ns_row = k_ms * 1e6 / walked if walked else None
            row = {"N": N, "M": M, "cap": cap, "extremes": extremes, "ms": k_ms,
                   "kernel_only_ms": bare_ms, "plain_ms": p_ms, "ns_per_row": ns_row, **bound,
                   "geometry": geometry}
            rows.append(row)
            say("victim", N=N, M=M, cap=cap, extremes=extremes, equal=same,
                kernel_ms=f"{k_ms:.5f}", kernel_only_ms=f"{bare_ms:.5f}", plain_ms=f"{p_ms:.3f}",
                bound_ms=f"{bound['bound_ms']:.6f}", bound_by=bound["bound_by"],
                rows_walked=walked, takes=bound["takes"],
                ns_per_row="-" if ns_row is None else f"{ns_row:.2f}",
                route=geometry["route"], geometry=json.dumps(geometry))
            check(same, f"victim_select disagrees with its plain version at {N}x{M} cap {cap}")
    return rows, mismatches, max_err


# --------------------------------------------------------------- preemption


def drive_preempt(plugin, group: int):
    """The ``[preempt]`` phase, last because it evicts pods: a preemption
    policy, Throttle ``t{group}`` set to 300m above its used cpu, a
    priority-5 gang of GANG_SIZE × 100m in that label group rejected for
    capacity, then ``maybe_preempt_gang`` with the kernel count zeroed just
    before and read just after. The evicted pods must be the host oracle's
    victims on the same ranked problem, and after a reconcile the gang
    must admit. Returns the numbers the kernels line reports."""
    from dataclasses import replace

    from kube_throttler_tpu_torch.api.pod import make_pod, priority_of
    from kube_throttler_tpu_torch.api.types import ResourceAmount
    from kube_throttler_tpu_torch.ops import victim_select as vsel
    from kube_throttler_tpu_torch.policy.preempt import _next_pow2
    from kube_throttler_tpu_torch.policy.victims import (
        build_selection_problem, compute_gang_deficits, sequential_victim_select,
    )
    from kube_throttler_tpu_torch.quantity import to_milli

    store, coord = plugin.store, plugin.preempt
    plugin.set_policy_specs([dict(PREEMPT_POLICY)])
    thr = store.get_throttle("default", f"t{group}")
    used = to_milli(thr.status.used.resource_requests["cpu"])
    store.update_throttle_spec(replace(thr, spec=replace(
        thr.spec, threshold=ResourceAmount.of(requests={"cpu": f"{used + 300}m"}))))
    plugin.run_pending_once()
    gang = [make_pod(f"hi-{r}", labels={"grp": f"g{group}", "mod": f"m{group % N_CLUSTER}"},
                     requests={"cpu": "100m"}, group="hi", group_size=GANG_SIZE, priority=5)
            for r in range(GANG_SIZE)]
    before = plugin.pre_filter_gang("default/hi", gang)
    check(not before.is_success(), "the priority-5 gang was not rejected before preemption")

    # the oracle's victims on the ranked problem the cycle will build
    spec = plugin.policy.active()
    deficits = compute_gang_deficits(gang, coord.kind_controllers)
    units = coord._gather_units(deficits, {p.key for p in gang},  # noqa: SLF001
                                max(map(priority_of, gang)), spec)
    _dims, deficit, contrib = build_selection_problem(deficits, units)
    ok_s, sel_s, _ = sequential_victim_select(deficit, contrib, spec.max_victims_per_cycle)
    want = sorted(p.key for i in sel_s for p in units[i].pods)

    live0 = {p.key for p in store.list_pods("default")}
    vsel.launches = 0
    t0 = time.perf_counter()
    evicted = plugin.maybe_preempt_gang("default/hi", gang)
    t_cycle = time.perf_counter() - t0
    launches = vsel.launches
    gone = sorted(live0 - {p.key for p in store.list_pods("default")})
    plugin.run_pending_once()
    after = plugin.pre_filter_gang("default/hi", gang)
    N, M = contrib.shape
    say("preempt", group=f"g{group}", deficit_m=json.dumps(deficit.tolist()),
        candidates=N, deficit_dims=M, N_x_M=N * M, padded=json.dumps(
            [_next_pow2(max(N, 1)), _next_pow2(max(M, 1), lo=4)]),
        cycle_s=f"{t_cycle:.4f}", evicted=len(gone), victims_equal_oracle=gone == want,
        victim_select_launches=launches, rejected_before=before.reasons[:1],
        admitted_after=after.is_success(), breaker=plugin.device_manager.breaker_state())
    check(evicted is True and len(gone) > 0, "maybe_preempt_gang evicted nothing")
    check(ok_s and gone == want, f"evicted {gone}, the oracle's victims are {want}")
    check(launches == 1, f"victim_select launched {launches} times in the cycle")
    check(N >= 100, f"only {N} candidates in the cycle")
    check(after.is_success(), f"the gang does not admit after preemption: {after.reasons}")

    # the kernel at the shape the cycle gave it, against its plain version
    Np, Mp = _next_pow2(max(N, 1)), _next_pow2(max(M, 1), lo=4)
    contrib_p = np.zeros((Np, Mp), dtype=np.int64)
    contrib_p[:N, :M] = contrib
    deficit_p = np.zeros(Mp, dtype=np.int64)
    deficit_p[:M] = deficit
    same, err, k_ms, bare_ms, p_ms, bound, _ = compare_victim(contrib_p, deficit_p,
                                                              spec.max_victims_per_cycle, 50)
    check(same, "victim_select disagrees with its plain version on the preemption path")
    say("preempt-kernel", shape=json.dumps([Np, Mp]), equal=same, kernel_ms=f"{k_ms:.5f}",
        kernel_only_ms=f"{bare_ms:.5f}", plain_ms=f"{p_ms:.3f}",
        bound_ms=f"{bound['bound_ms']:.8f}",
        rows_walked=bound["rows_walked"], geometry=json.dumps(victim_geometry(Mp)))
    return dict(launches=launches, same=same, err=err, ms=k_ms, kernel_only_ms=bare_ms,
                plain_ms=p_ms, bound=bound, shape=[Np, Mp], candidates=N,
                geometry=victim_geometry(Mp))


# --------------------------------------------------------------- trace


def trace_batch(plugin, log_dir: Path) -> dict:
    """One more ``pre_filter_batch`` under ``utils.tracing.device_trace``:
    whether the profiler's CUDA activity (CUPTI) works on this machine,
    and the share of the call's wall time the card was busy, from the
    union of the trace's kernel, copy and memset intervals."""
    from kube_throttler_tpu_torch.utils.tracing import device_trace

    shutil.rmtree(log_dir, ignore_errors=True)
    with device_trace(str(log_dir)):
        t0 = time.perf_counter()
        plugin.pre_filter_batch()
        wall_us = (time.perf_counter() - t0) * 1e6
    files = sorted(log_dir.glob("trace-*.json"))
    if not files:
        say("trace", written=False, cupti=False)
        return {"written": False, "cupti": False}
    events = json.loads(files[-1].read_text()).get("traceEvents", [])
    gpu = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for start, stop in gpu:
        busy += max(stop - max(start, end), 0.0)
        end = max(end, stop)
    by_kernel = Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            by_kernel[e["name"][:80]] += e.get("dur", 0)
    out = {"written": True, "cupti": bool(gpu), "gpu_events": len(gpu),
           "device_busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
           "idle_share": 1.0 - busy / wall_us,
           "top_kernels_us": dict(by_kernel.most_common(6)),
           "trace_bytes": files[-1].stat().st_size}
    say("trace", **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in out.items()})
    return out


# --------------------------------------------------------------- daemon


def write_data_dir(path: Path, store) -> dict:
    """The cluster in ``store`` (statuses included) as a daemon's
    ``--data-dir``, written with the port's own journal and snapshot code:
    every object created through a journaled store, then a snapshot
    anchored at the journal's end. Returns what was written."""
    from kube_throttler_tpu_torch.engine.journal import attach
    from kube_throttler_tpu_torch.engine.recovery import JOURNAL_FILE
    from kube_throttler_tpu_torch.engine.snapshot import SnapshotManager
    from kube_throttler_tpu_torch.engine.store import Store

    t0 = time.perf_counter()
    path.mkdir(parents=True)
    copy = Store()
    journal = attach(copy, str(path / JOURNAL_FILE))
    try:
        for ns in store.list_namespaces():
            copy.create_namespace(ns)
        ops = ([("create", "Throttle", t) for t in store.list_throttles()]
               + [("create", "ClusterThrottle", t) for t in store.list_cluster_throttles()]
               + [("create", "Pod", p) for p in store.list_pods()])
        for i in range(0, len(ops), 10_000):
            for res in copy.apply_events(ops[i:i + 10_000]):
                if isinstance(res, Exception):
                    raise res
        snapshots = SnapshotManager(str(path), copy)
        snapshots.journal = journal
        snap = snapshots.write(reason="smoke")
    finally:
        journal.close()
    check(snap is not None, "the data dir's snapshot was not written")
    return dict(objects=len(ops) + len(store.list_namespaces()),
                journal_bytes=(path / JOURNAL_FILE).stat().st_size,
                snapshot_bytes=Path(snap).stat().st_size,
                seconds=time.perf_counter() - t0)


def status_json(status) -> dict:
    """A framework Status in the HTTP surface's form (``server.py``)."""
    return {"code": status.code.value, "reasons": list(status.reasons)}


def fill_pods():
    """Two pods of label group FILL_GROUP, neither stored: ``fill`` asks
    for the whole cpu threshold of the group's roomy Throttles and
    ClusterThrottle, so reserving it fills them; ``probe`` (100m) is
    schedulable before that reservation and blocked after it."""
    from kube_throttler_tpu_torch.api.pod import make_pod
    from kube_throttler_tpu_torch.api.serialization import object_to_dict

    labels = {"grp": f"g{FILL_GROUP}", "mod": f"m{FILL_GROUP % N_CLUSTER}"}
    fill = make_pod("daemon-fill", labels=labels, requests={"cpu": "100000"})
    probe = make_pod("daemon-probe", labels=labels, requests={"cpu": "100m"})
    return object_to_dict(fill), object_to_dict(probe)


def inprocess_answers(plugin, seed: int) -> dict:
    """The in-process answers the daemon must give, on the state its data
    dir holds: the tick; PreFilter of DAEMON_SINGLE_PODS seeded stored
    pods; the probe's PreFilter, the fill pod's Reserve and the probe's
    PreFilter again; then, with the fill pod reserved, the batch and the
    tick. The fill pod is unreserved after, so the in-process state is as
    before."""
    from kube_throttler_tpu_torch.api.serialization import object_from_dict

    store = plugin.store
    tick = plugin.full_tick_sharded(1)
    keys = sorted(random.Random(seed).sample(
        sorted(p.key for p in store.list_pods()), DAEMON_SINGLE_PODS))
    pods = {k: store.get_pod(*k.split("/", 1)) for k in keys}
    answers = {k: status_json(plugin.pre_filter(pods[k])) for k in keys}
    fill, probe = (object_from_dict(d) for d in fill_pods())
    before = status_json(plugin.pre_filter(probe))
    reserved = status_json(plugin.reserve(fill))
    after = status_json(plugin.pre_filter(probe))
    verdicts_reserved = plugin.pre_filter_batch()["schedulable"]
    tick_reserved = plugin.full_tick_sharded(1)
    plugin.unreserve(fill)
    check(before["code"] == "Success", f"the probe pod is blocked before the fill: {before}")
    check(reserved["code"] == "Success", f"the fill pod's reserve failed: {reserved}")
    check(after["code"] != "Success", "the fill pod's reservation does not block the probe")
    check(status_json(plugin.pre_filter(probe)) == before, "unreserve did not restore the probe")
    return dict(keys=keys, answers=answers, before=before, reserved=reserved, after=after,
                tick=tick, verdicts_reserved=verdicts_reserved, tick_reserved=tick_reserved)


class Daemon:
    """``python -m kube_throttler_tpu_torch.cli serve`` as a child process
    of this smoke: its output drained by a thread (and echoed to a log
    file), its port read from the serving line."""

    def __init__(self, args, log: Path, deadline_s: float, env=None, cwd=None):
        import queue
        import threading

        self.log = log
        if cwd is None:
            env = {**os.environ, **(env or {})}
            env["PYTHONPATH"] = str(HERE) + os.pathsep + env.get("PYTHONPATH", "")
            cwd, named = HERE, ["--name", "kube-throttler", "--target-scheduler-name",
                                "my-scheduler"]
        else:
            # an installed package (``Install``): ``env`` is whole, and the
            # names come from ``--config`` as in the manifests
            named = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{PORT}.cli", "serve", *named, "--host", "127.0.0.1",
             "--port", "0", *args],
            cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        self.lines: "queue.Queue[str]" = queue.Queue()
        self.seen: list = []
        self.arrivals: list = []  # (seconds since spawn, line), as read
        self.reader = threading.Thread(target=self._drain, daemon=True)
        self.reader.start()
        try:
            m = self.wait_for(r"serving on [\d.]+:(\d+)", deadline_s)
            self.port = int(m.group(1))
            while True:
                try:
                    if self.get("/readyz")[0] == 200:
                        break
                except OSError:
                    pass
                check(time.perf_counter() - self.t0 < deadline_s, "the daemon never became ready")
                time.sleep(0.1)
        except BaseException:
            self.kill()
            raise
        self.ready_s = time.perf_counter() - self.t0

    def _drain(self) -> None:
        with open(self.log, "a") as f:
            for line in self.proc.stdout:
                self.arrivals.append((time.perf_counter() - self.t0, line))
                f.write(line)
                self.lines.put(line)

    def wait_for(self, pattern: str, deadline_s: float):
        import queue

        while True:
            left = deadline_s - (time.perf_counter() - self.t0)
            if left <= 0 or (self.proc.poll() is not None and self.lines.empty()):
                tail = "".join(self.seen[-20:])
                raise SmokeFailure(f"daemon: {pattern!r} not seen (rc {self.proc.poll()}):\n{tail}")
            try:
                line = self.lines.get(timeout=min(left, 0.5))
            except queue.Empty:
                continue
            self.seen.append(line)
            m = re.search(pattern, line)
            if m:
                return m

    def line(self, pattern: str) -> str:
        """The first line printed so far that matches ``pattern``."""
        import queue

        while True:
            try:
                self.seen.append(self.lines.get_nowait())
            except queue.Empty:
                break
        return next((x.strip() for x in self.seen if re.search(pattern, x)), "")

    def startup(self) -> dict:
        """Seconds of each startup step, from the arrival of the lines the
        CLI prints or logs as it ends each one: interpreter and imports,
        recovery (its own report), the plugin's build (the informers'
        cache-sync replay into the device mirror and the controllers),
        prewarm, the recovery's reservation restore and reconcile through
        the heap freeze to the serving line, then /readyz."""
        def at(pattern: str) -> float:
            return next(t for t, x in self.arrivals if re.search(pattern, x))

        rec = re.search(r"journal events in ([\d.]+)s", self.line(r"^recovery: mode="))
        recovery_s = float(rec.group(1))
        t_rec, t_ctl = at(r"^recovery: mode="), at(r"Started ClusterThrottleController")
        t_warm, t_serve = at(r"prewarmed"), at(r"serving on")
        return {"imports": t_rec - recovery_s, "recovery": recovery_s,
                "plugin_build": t_ctl - t_rec, "prewarm": t_warm - t_ctl,
                "restore_to_serving": t_serve - t_warm, "serving_to_ready": self.ready_s - t_serve,
                "total": self.ready_s}

    def call(self, method: str, path: str, body=None, timeout: float = 300.0):
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                raw, code = resp.read(), resp.status
        except urllib.error.HTTPError as e:
            raw, code = e.read(), e.code
        try:
            return code, json.loads(raw)
        except ValueError:
            return code, raw.decode()

    def get(self, path: str):
        return self.call("GET", path)

    def post(self, path: str, body=None):
        return self.call("POST", path, {} if body is None else body)

    def stop(self, timeout_s: float = 300.0) -> float:
        """SIGTERM, then wait for the exit; fails unless it exits with 0.
        Returns the seconds the shutdown took."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()
            raise SmokeFailure("the daemon did not exit after SIGTERM")
        self.reader.join(60.0)  # its last lines, the final snapshot's included
        check(rc == 0, f"the daemon exited with {rc}")
        return time.perf_counter() - t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def scrape(daemon: Daemon) -> dict:
    """The /metrics numbers the device route shows: the breaker's state
    (None without a device), the tracer's observation count per phase and
    each kernel's launches."""
    code, text = daemon.get("/metrics")
    check(code == 200, f"/metrics answered {code}")
    breaker = re.search(r"^kube_throttler_device_breaker_state (\S+)$", text, re.M)

    def family(name: str, label: str) -> dict:
        return {m.group(1): int(float(m.group(2))) for m in re.finditer(
            rf'^{name}\{{{label}="([^"]+)"\}} (\S+)$', text, re.M)}

    return {"breaker": float(breaker.group(1)) if breaker else None,
            "phases": family("kube_throttler_phase_duration_seconds_count", "phase"),
            "launches": family("kube_throttler_kernel_launches", "kernel")}


def grown(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def daemon_reads(daemon: Daemon, single: dict, label: str, reserved: bool) -> dict:
    """The daemon's batch calls, its tick and (``reserved``: the fill pod
    is already reserved) the probe's PreFilter; printed and returned."""
    out = {"batch": [], "batch_ms": []}
    for i in range(DAEMON_BATCH_CALLS):
        t0 = time.perf_counter()
        code, body = daemon.post("/v1/prefilter-batch")
        out["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        check(code == 200, f"/v1/prefilter-batch answered {code}: {str(body)[:300]}")
        out["batch"].append(body)
        say("daemon", step=f"{label}-batch", call=i, wall_ms=f"{out['batch_ms'][-1]:.3f}",
            verdicts=len(body["schedulable"]), errors=len(body["errors"]))
    t0 = time.perf_counter()
    code, out["tick"] = daemon.post("/v1/tick", {"devices": 1})
    out["tick_ms"] = (time.perf_counter() - t0) * 1e3
    check(code == 200, f"/v1/tick answered {code}: {str(out['tick'])[:300]}")
    _, probe = fill_pods()
    out["probe"] = daemon.post("/v1/prefilter", probe)[1]
    say("daemon", step=f"{label}-tick", wall_ms=f"{out['tick_ms']:.3f}",
        mesh=json.dumps(out["tick"]["mesh"]), verdicts=len(out["tick"]["schedulable"]),
        probe=out["probe"]["code"])
    want_probe = single["after"] if reserved else single["before"]
    check(out["probe"] == want_probe, f"{label}: the probe's PreFilter {out['probe']}")
    return out


def check_reads(reads: dict, verdicts: dict, tick: dict, label: str) -> None:
    for body in reads["batch"]:
        check(body["errors"] == [] and len(body["schedulable"]) == len(verdicts),
              f"{label}: batch verdicts missing")
        diff = sum(body["schedulable"].get(k) is not v for k, v in verdicts.items())
        check(diff == 0, f"{label}: {diff} HTTP batch verdicts differ from the in-process ones")
    got = reads["tick"]
    check(got["mesh"] == [1, 1] and got["errors"] == [], f"{label}: tick {got['mesh']}")
    check(got["schedulable"] == tick["schedulable"],
          f"{label}: the HTTP tick's verdicts differ from the in-process tick's")
    check(got["used"] == tick["used"],
          f"{label}: the HTTP tick's used counts differ from the in-process tick's")


def scheduler_manifests():
    """The embedded scheduler's cluster, in three stages. Stage 1: Throttle
    ``t-a`` (400m) saturated by four running 100m pods of group a (a
    priority-0 gang of two, then two priority-1 singles), ``t-b`` (3 pods)
    and ClusterThrottle ``c-b`` (4 pods) over three pods of group b, and
    ``t-c`` (1 cpu) over a gang of three 300m pods. Stage 2, once those
    are bound: two more pods of group b, which the full ``t-b`` blocks.
    Stage 3: a priority-5 gang of two 100m pods of group a, which ``t-a``
    admits only after preemption evicts 200m of lower-priority work.

    Group b's two extra pods come only after its first three are bound
    and counted: a reservation stays until the controller has written the
    pod into ``status.used`` and then released it, and a pod checked in
    the few ms between the two sees the bound pod twice and waits
    (``controllers/base.py``, on either route). Sent together, five pods
    for three places went to whichever the loop checked outside that
    window."""
    from kube_throttler_tpu_torch.api.pod import make_pod
    from kube_throttler_tpu_torch.api.serialization import object_to_dict

    def throttle(name, grp, **threshold):
        return {"kind": "Throttle", "metadata": {"name": name, "namespace": "default"},
                "spec": {"throttlerName": "kube-throttler", "threshold": threshold,
                         "selector": {"selectorTerms": [
                             {"podSelector": {"matchLabels": {"grp": grp}}}]}}}

    def pod(name, grp, cpu, **kw):
        d = object_to_dict(make_pod(name, labels={"grp": grp}, requests={"cpu": cpu}, **kw))
        d["kind"] = "Pod"
        return d

    stage1 = [
        throttle("t-a", "a", resourceRequests={"cpu": "400m"}),
        throttle("t-b", "b", resourceCounts={"pod": 3}),
        throttle("t-c", "c", resourceRequests={"cpu": "1"}),
        {"kind": "ClusterThrottle", "metadata": {"name": "c-b"},
         "spec": {"throttlerName": "kube-throttler", "threshold": {"resourceCounts": {"pod": 4}},
                  "selector": {"selectorTerms": [
                      {"podSelector": {"matchLabels": {"grp": "b"}}}]}}},
    ]
    stage1 += [pod(f"vg{i}", "a", "100m", priority=0, group="victims", group_size=2)
               for i in range(2)]
    stage1 += [pod(f"vs{i}", "a", "100m", priority=1) for i in range(2)]
    stage1 += [pod(f"b{i}", "b", "200m") for i in range(3)]
    stage1 += [pod(f"cg{i}", "c", "300m", group="cgang", group_size=3) for i in range(3)]
    stage2 = [pod(f"b{i}", "b", "200m") for i in range(3, 5)]
    stage3 = [pod(f"hi-r{i}", "a", "100m", priority=5, group="hi", group_size=2)
              for i in range(2)]
    return stage1, stage2, stage3


def scheduler_settle(daemon: Daemon, want_bound=(), timeout_s: float = 120.0,
                     quiet_s: float = 6.0):
    """{pod key: node} of the daemon's pods once every key of
    ``want_bound`` is bound and nothing changed for ``quiet_s`` (longer
    than the scheduler's 5 s backoff cap)."""
    t0 = time.perf_counter()
    last, since = None, time.perf_counter()
    while True:
        code, pods = daemon.get("/v1/pods")
        check(code == 200, f"/v1/pods answered {code}")
        cur = {p["key"]: p["nodeName"] for p in pods}
        now = time.perf_counter()
        if cur != last:
            last, since = cur, now
        if all(cur.get(k) for k in want_bound) and now - since >= quiet_s:
            return cur
        check(now - t0 < timeout_s, f"the embedded scheduler did not settle: {cur}")
        time.sleep(0.2)


def drive_scheduler_daemon(root: Path, device: bool) -> dict:
    """The embedded scheduler (``--nodes 4``) of a small daemon, on the card
    or under ``--no-device``: each stage applied, then settled. Returns the
    bound pods, the evicted ones and the /metrics reading."""
    stage1, stage2, stage3 = scheduler_manifests()
    config = root / "scheduler-config.yaml"
    # JSON is YAML: the plugin args with a preemption policy
    config.write_text(json.dumps({"name": "kube-throttler", "targetSchedulerName": "my-scheduler",
                                  "policies": [dict(SCHEDULER_POLICY)]}))
    label = "device" if device else "no-device"
    args = ["--config", str(config), "--nodes", "4",
            "--node-allocatable", "cpu=8,memory=32Gi"]
    args += [] if device else ["--no-device"]
    daemon = Daemon(args, root / f"scheduler-{label}.log", DAEMON_DEADLINE_S)
    try:
        running = ["default/vg0", "default/vg1", "default/vs0", "default/vs1", "default/cg0",
                   "default/b0", "default/b1", "default/b2"]
        for d in stage1:
            check(daemon.post("/v1/objects", d)[0] == 200, f"applying {d['metadata']['name']}")
        scheduler_settle(daemon, running)
        for d in stage2:
            check(daemon.post("/v1/objects", d)[0] == 200, f"applying {d['metadata']['name']}")
        first = scheduler_settle(daemon, running)
        for d in stage3:
            check(daemon.post("/v1/objects", d)[0] == 200, f"applying {d['metadata']['name']}")
        final = scheduler_settle(daemon, ["default/hi-r0", "default/hi-r1"])
        metrics = scrape(daemon)
        daemon.stop()
    finally:
        daemon.kill()
    bound = sorted(k for k, node in final.items() if node)
    evicted = sorted(set(first) - set(final))
    say("daemon", step=f"scheduler-{label}", ready_s=f"{daemon.ready_s:.3f}",
        bound=json.dumps(bound), evicted=json.dumps(evicted),
        pending=json.dumps(sorted(k for k, node in final.items() if not node)),
        breaker=metrics["breaker"], kernel_launches=json.dumps(metrics["launches"]),
        prewarm=repr(daemon.line(r"prewarmed")))
    return dict(bound=bound, evicted=evicted, metrics=metrics)


def daemon_cluster(root: Path) -> dict:
    """The ``[daemon]`` phase's cluster: ``cluster_objects(*DAEMON_CLUSTER,
    SEED)`` served in process on the CPU (statuses reconciled), so that
    the wrappers run their plain versions; its batch verdicts and the
    in-process answers the daemon must give (``inprocess_answers``),
    written as the daemon's data dir ``root/data``. Prints one ``[daemon]
    step=cluster`` line."""
    cluster = DAEMON_CLUSTER
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    plugin = build_cluster("cpu", *cluster, SEED)
    try:
        plugin.run_pending_once()
        verdicts = plugin.pre_filter_batch()["schedulable"]
        single = inprocess_answers(plugin, SEED + 8)
        written = write_data_dir(root / "data", plugin.store)
    finally:
        plugin.stop()
    check(len(verdicts) == cluster[0], f"{len(verdicts)} in-process verdicts for {cluster[0]} pods")
    say("daemon", step="cluster", cluster=json.dumps(list(cluster)), device="cpu",
        objects=written["objects"],
        journal_bytes=written["journal_bytes"], snapshot_bytes=written["snapshot_bytes"],
        schedulable=sum(verdicts.values()), seconds=f"{time.perf_counter() - t0:.3f}")
    return dict(verdicts=verdicts, single=single, written=written)


def drive_daemon(data_dir: Path, single: dict, verdicts: dict) -> dict:
    """The ``[daemon]`` phase: ``serve --data-dir`` over the daemon's
    cluster (``daemon_cluster``) on the card, without the verdict cache so
    that its batch reaches the kernels; its HTTP batch, tick and
    single-pod answers held against the in-process ones; /metrics read; a
    SIGTERM restart on the same dir; then the embedded scheduler on the
    card against ``--no-device``."""
    root = data_dir.parent
    recovery_re = r"^recovery: mode="
    no_cache = {"KT_VERDICT_CACHE": "0"}
    daemon = Daemon(["--data-dir", str(data_dir)], root / "daemon.log", DAEMON_DEADLINE_S,
                    env=no_cache)
    try:
        say("daemon", step="start", spawn_to_ready_s=f"{daemon.ready_s:.3f}",
            startup_s=json.dumps(daemon.startup()),
            recovery=repr(daemon.line(recovery_re)), prewarm=repr(daemon.line(r"prewarmed")))
        check(daemon.line(r"device=cuda"), "the daemon does not serve on the card")
        m0 = scrape(daemon)
        # the single-pod path, against the in-process answers
        differ = sum(daemon.post("/v1/prefilter", {"podKey": k})[1] != single["answers"][k]
                     for k in single["keys"])
        reads = daemon_reads(daemon, single, "first", reserved=False)
        fill, _ = fill_pods()
        reserved = daemon.post("/v1/reserve", fill)[1]
        _, probe = fill_pods()
        after = daemon.post("/v1/prefilter", probe)[1]
        say("daemon", step="single-pod", pods=len(single["keys"]), differ=differ,
            reserve=reserved["code"], probe_after=after["code"])
        check(differ == 0, f"{differ} single-pod PreFilter answers differ from the in-process ones")
        check(reserved == single["reserved"] and after == single["after"],
              f"the fill pod's reserve {reserved} / the probe after it {after}")
        check_reads(reads, verdicts, single["tick"], "first")
        m1 = scrape(daemon)
        grew = grown(m1["phases"], m0["phases"])
        launched = grown(m1["launches"], m0["launches"])
        say("daemon", step="metrics", breaker_state=m1["breaker"],
            batch_dispatch=grew.get("batch_dispatch"), tick_device=grew.get("tick_device"),
            kernel_launches=json.dumps(launched, sort_keys=True))
        check(m1["breaker"] == 0, f"the device breaker is in state {m1['breaker']}")
        check(grew.get("batch_dispatch", 0) >= DAEMON_BATCH_CALLS
              and grew.get("tick_device", 0) >= 1,
              f"the device phases were not observed: {grew}")
        # each batch call and the tick launch both batch kernels once at least
        for name in ("check_dense", "check_gather"):
            check(launched.get(name, 0) >= DAEMON_BATCH_CALLS + 1,
                  f"{name} launched {launched.get(name)} times in the daemon's calls")
        check(launched.get("pack_gather_rows") == launched.get("check_gather"),
              "the daemon's check_gather launches and packs differ")
        stop_s = daemon.stop()
        shutdown = daemon.line(r"written \(shutdown")
        say("daemon", step="sigterm", exit_code=0, shutdown_s=f"{stop_s:.3f}",
            snapshot=repr(shutdown))
        check(shutdown, "the daemon wrote no final snapshot")
    finally:
        daemon.kill()

    daemon = Daemon(["--data-dir", str(data_dir)], root / "daemon.log", DAEMON_DEADLINE_S,
                    env=no_cache)
    try:
        say("daemon", step="restart", spawn_to_ready_s=f"{daemon.ready_s:.3f}",
            startup_s=json.dumps(daemon.startup()),
            recovery=repr(daemon.line(recovery_re)), prewarm=repr(daemon.line(r"prewarmed")))
        again = daemon_reads(daemon, single, "restart", reserved=True)
        # the fill pod's reservation came back from the data dir
        check_reads(again, single["verdicts_reserved"], single["tick_reserved"], "restart")
        check(scrape(daemon)["breaker"] == 0, "the device breaker opened after the restart")
        daemon.stop()
    finally:
        daemon.kill()

    on_card = drive_scheduler_daemon(root, device=True)
    host = drive_scheduler_daemon(root, device=False)
    check(on_card["metrics"]["breaker"] == 0, "the scheduler daemon's breaker opened")
    check(on_card["bound"] == host["bound"] and on_card["evicted"] == host["evicted"],
          "the embedded scheduler's bound set differs from --no-device's: "
          f"bound {on_card['bound']} against {host['bound']}, "
          f"evicted {on_card['evicted']} against {host['evicted']}")
    check(len(on_card["evicted"]) == 2 and "default/hi-r0" in on_card["bound"],
          f"the high-priority gang did not preempt: {on_card}")
    check(on_card["metrics"]["launches"].get("victim_select", 0) >= 1,
          "the scheduler daemon's preemption did not launch victim_select")
    return dict(launches=launched, scheduler_launches=on_card["metrics"]["launches"])


# --------------------------------------------------------------- shards


def compute_apps() -> list:
    """``nvidia-smi``'s compute processes: one line per CUDA context on the
    card. Where the card's machine runs in a PID namespace of its own,
    every line can read the same pid, so the phase counts the lines."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return [x.strip() for x in proc.stdout.splitlines() if x.strip()]


def workers_of(pid: int) -> list:
    """The pids of ``pid``'s live shard worker processes (from ``/proc``;
    the shared-memory lane's resource tracker is a child too)."""
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rpartition(")")[2].split()
            cmdline = (stat.parent / "cmdline").read_bytes()
        except OSError:
            continue
        if (int(fields[1]) == pid and fields[0] != "Z"
                and f"{PORT}.sharding.worker".encode() in cmdline):
            out.append(int(stat.parent.name))
    return sorted(out)


def alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rpartition(")")[2].split()[0]
    except OSError:
        return False
    return state != "Z"


def normalized(status: dict) -> tuple:
    """A status's code and its reasons, the throttle names of each sorted
    and the reasons sorted: the scatter front composes one reason per shard
    and kind, so its order of names is not the single process's."""
    reasons = []
    for r in status["reasons"]:
        head, _, names = r.partition("=")
        reasons.append(f"{head}={','.join(sorted(names.split(',')))}")
    return status["code"], sorted(reasons)


def verdicts_differ(out: dict, want: dict) -> int:
    """How many of ``want``'s verdicts a batch result misses or gets wrong,
    plus every verdict it has beyond them and every error."""
    got = out["schedulable"]
    return (sum(got.get(k) is not v for k, v in want.items())
            + len(got.keys() - want.keys()) + len(out["errors"]))


@contextmanager
def stderr_to(path: Path):
    """Point file descriptor 2 at ``path`` while the block runs, so the
    worker processes spawned in it (and respawned while it runs) log there
    and not over this smoke's output."""
    sys.stderr.flush()
    saved = os.dup(2)
    try:
        with open(path, "a") as f:
            os.dup2(f.fileno(), 2)
            yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def shard_stats(front) -> dict:
    """Each worker's ``stats`` answer: its device, kernel launches and
    objects; a worker that does not answer fails the phase."""
    shards = front.stats()["shards"]
    for sid, st in shards.items():
        check(st.get("alive"), f"shard {sid} did not answer stats: {st}")
    return shards


def check_shard_launches(before: dict, after: dict, calls: int) -> dict:
    """Each worker's kernel launches over ``calls`` batch calls: check_gather
    (with its pack) at least once a call on a shard holding Throttles,
    check_dense at least once a call on one holding ClusterThrottles."""
    per_shard = {}
    for sid, st in after.items():
        grew_by = grown(st["kernel_launches"], before[sid]["kernel_launches"])
        per_shard[sid] = dict(grew_by, throttles=st["objects"]["throttles"],
                              clusterthrottles=st["objects"]["clusterthrottles"],
                              pods=st["objects"]["pods"], device=st["device"])
        check(st["device"].startswith("cuda"), f"shard {sid} runs on {st['device']}")
        if st["objects"]["throttles"]:
            check(grew_by["check_gather"] >= calls,
                  f"shard {sid} launched check_gather {grew_by['check_gather']} times")
            check(grew_by["pack_gather_rows"] == grew_by["check_gather"],
                  f"shard {sid}'s check_gather launches and packs differ")
        if st["objects"]["clusterthrottles"]:
            check(grew_by["check_dense"] >= calls,
                  f"shard {sid} launched check_dense {grew_by['check_dense']} times")
    return per_shard


def drive_shards(verdicts: dict, single: dict) -> dict:
    """The ``[shards]`` phase: an ``AdmissionFront`` in this process over a
    ``ShardSupervisor``'s SHARDS worker processes on the card, serving the
    main path's cluster (loaded through the front's store). Every batch
    verdict, 200 single-pod answers and a two-phase reserve are held
    against the in-process plugin's; each worker's stats show its device
    and its kernels' launches; one worker is SIGKILLed, restarted on the
    card and resynced, and every verdict must come back."""
    import signal

    from kube_throttler_tpu_torch.api.serialization import object_from_dict
    from kube_throttler_tpu_torch.sharding.front import AdmissionFront
    from kube_throttler_tpu_torch.sharding.supervisor import ShardSupervisor

    SHARDS_ROOT.mkdir(parents=True, exist_ok=True)
    log = SHARDS_ROOT / "workers.log"
    own = len(compute_apps())
    env = {**os.environ, "KT_VERDICT_CACHE": "0", "KT_SHARD_QUIET": "1",
           "PYTHONPATH": str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    front = AdmissionFront(SHARDS)
    sup = ShardSupervisor(front, device="cuda", env=env)
    out = {}
    try:
        with stderr_to(log):
            t0 = time.perf_counter()
            sup.start(ready_timeout=SHARDS_DEADLINE_S)
            start_s = time.perf_counter() - t0
            apps = compute_apps()
            say("shards", step="start", workers=SHARDS, spawn_to_ready_s=f"{start_s:.3f}",
                compute_apps=len(apps), before=own, nvidia_smi=json.dumps(apps))
            check(len(apps) == own + SHARDS,
                  f"{len(apps)} CUDA contexts on the card, {own} before {SHARDS} workers")

            t0 = time.perf_counter()
            load_cluster(front.store, cluster_objects(N_PODS, N_THROTTLES, GROUPS, N_CLUSTER, SEED))
            routed_s = time.perf_counter() - t0
            check(front.drain(timeout=SHARDS_DEADLINE_S), "the shards did not drain the cluster")
            load_s = time.perf_counter() - t0
            before = shard_stats(front)
            say("shards", step="load", objects=len(front.store.list_pods())
                + len(front.store.list_throttles()) + len(front.store.list_cluster_throttles()) + 1,
                routed_s=f"{routed_s:.3f}", load_and_drain_s=f"{load_s:.3f}",
                per_shard=json.dumps({sid: st["objects"] for sid, st in before.items()}))

            per_call = []
            for i in range(SHARDS_BATCH_CALLS):
                t0 = time.perf_counter()
                got = front.pre_filter_batch()
                per_call.append((time.perf_counter() - t0) * 1e3)
                bad = verdicts_differ(got, verdicts)
                say("shards", step="pre_filter_batch", call=i, ms=f"{per_call[-1]:.3f}",
                    verdicts=len(got["schedulable"]), errors=len(got["errors"]), differ=bad)
                check(bad == 0, f"{bad} of the fleet's batch verdicts differ from the in-process ones")
            after = shard_stats(front)
            launches = check_shard_launches(before, after, SHARDS_BATCH_CALLS)
            say("shards", step="launches", calls=SHARDS_BATCH_CALLS,
                per_shard=json.dumps(launches, sort_keys=True))
            # where a scattered call's time goes: each shard's RPC alone (its
            # batch, the pickled answer over the socket), one at a time
            alone, answer_bytes = {}, {}
            for sid in range(SHARDS):
                t0 = time.perf_counter()
                got = front.shards[sid].request(
                    "pre_filter_batch", None, timeout=front.deadline_for("pre_filter_batch"))
                alone[sid] = round((time.perf_counter() - t0) * 1e3, 3)
                answer_bytes[sid] = len(pickle.dumps(got, protocol=pickle.HIGHEST_PROTOCOL))
            # and the front's own listing of every stored pod, which its
            # merge walks to fill in the pods no shard holds
            t0 = time.perf_counter()
            listed = len(front.store.list_pods())
            list_ms = (time.perf_counter() - t0) * 1e3
            say("shards", step="split", shard_rpc_alone_ms=json.dumps(alone),
                answer_bytes=json.dumps(answer_bytes), front_list_pods_ms=f"{list_ms:.3f}",
                listed=listed, scattered_ms=json.dumps([round(x, 3) for x in per_call]))

            # single-pod answers and a two-phase reserve, against the in-process ones
            exact = differ = 0
            for k in single["keys"]:
                got = status_json(front.pre_filter(front.store.get_pod(*k.split("/", 1))))
                exact += got == single["answers"][k]
                differ += normalized(got) != normalized(single["answers"][k])
            fill, probe = (object_from_dict(d) for d in fill_pods())
            probe_before = status_json(front.pre_filter(probe))
            reserved = status_json(front.reserve(fill))
            probe_after = status_json(front.pre_filter(probe))
            bad_reserved = verdicts_differ(front.pre_filter_batch(), single["verdicts_reserved"])
            front.unreserve(fill)
            probe_restored = status_json(front.pre_filter(probe))
            aborts = front.stats()["two_phase_aborts"]
            say("shards", step="single-pod", pods=len(single["keys"]), exact=exact, differ=differ,
                reserve=reserved["code"], probe_before=probe_before["code"],
                probe_after=probe_after["code"], reserved_batch_differ=bad_reserved,
                probe_restored=probe_restored["code"], two_phase_aborts=aborts)
            check(differ == 0, f"{differ} single-pod answers differ from the in-process ones")
            check(normalized(probe_before) == normalized(single["before"])
                  and reserved == single["reserved"]
                  and normalized(probe_after) == normalized(single["after"]),
                  f"the fill pod's reserve {reserved}, the probe {probe_before} / {probe_after}")
            check(bad_reserved == 0,
                  f"{bad_reserved} batch verdicts with the fill pod reserved differ")
            check(probe_restored == probe_before and aborts == 0,
                  f"unreserve left the probe at {probe_restored}; {aborts} aborts")

            # a worker SIGKILLed: restarted on the card, resynced, converged
            victim = front.owner_of("Throttle", f"default/t{FILL_GROUP}")
            killed = sup.shard_proc(victim)
            t0 = time.perf_counter()
            os.kill(killed.pid, signal.SIGKILL)
            while True:
                fresh = sup.shard_proc(victim)
                if (sup.restart_counts()[victim] >= 1 and fresh is not None
                        and fresh is not killed and front._shards_health()[0] == "ok"):
                    break
                check(time.perf_counter() - t0 < SHARDS_DEADLINE_S,
                      f"shard {victim} did not come back after its SIGKILL")
                time.sleep(0.1)
            restarted_s = time.perf_counter() - t0
            check(front.drain(timeout=SHARDS_DEADLINE_S), "the fleet did not drain after the restart")
            polls = 0
            while True:
                polls += 1
                bad = verdicts_differ(front.pre_filter_batch(), verdicts)
                if bad == 0:
                    break
                check(time.perf_counter() - t0 < SHARDS_DEADLINE_S,
                      f"{bad} verdicts still differ after shard {victim}'s restart")
                time.sleep(1.0)
            converged_s = time.perf_counter() - t0
            # one more call on the converged fleet: every worker, the
            # restarted one included, launches its kernels for it
            mid = shard_stats(front)
            bad = verdicts_differ(front.pre_filter_batch(), verdicts)
            revived = check_shard_launches(mid, shard_stats(front), 1)
            apps = compute_apps()
            restarts = sup.restart_counts()
            say("shards", step="sigkill", shard=victim, restarted_s=f"{restarted_s:.3f}",
                kill_to_convergence_s=f"{converged_s:.3f}", batch_polls=polls, differ=bad,
                compute_apps=len(apps), restarts=json.dumps(restarts),
                launches=json.dumps(revived[victim], sort_keys=True))
            check(bad == 0, f"{bad} verdicts differ on the converged fleet")
            check(len(apps) == own + SHARDS, f"{len(apps)} CUDA contexts after the restart")
            check(restarts == {sid: int(sid == victim) for sid in range(SHARDS)},
                  f"unexpected worker restarts {restarts}")
            out = dict(start_s=start_s, load_s=load_s, per_call_ms=per_call, launches=launches,
                       converged_s=converged_s)
    except BaseException:
        print("[shards] worker log tail:\n" + "".join(
            log.read_text(errors="replace").splitlines(keepends=True)[-40:]), flush=True)
        raise
    finally:
        sup.stop()
        front.stop()
    left = len(compute_apps())
    say("shards", step="stop", compute_apps=left)
    check(left == own, f"{left - own} CUDA contexts outlived the fleet's stop")
    return out


def drive_shards_cli() -> dict:
    """The ``[shards]`` phase's CLI leg: ``kube-throttler-gpu serve --shards
    SHARDS`` as a child process on the card, a smaller cluster posted to
    ``/v1/objects``; its HTTP batch must equal the in-process plugin's on
    the same objects, and SIGTERM must stop it and every worker."""
    from kube_throttler_tpu_torch.api.serialization import object_to_dict
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    objects = cluster_objects(*CLI_SHARDS_CLUSTER, SEED + 9)
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, use_device=True, device="cuda",
    )
    try:
        load_cluster(store, objects)
        plugin.run_pending_once()
        want = plugin.pre_filter_batch()
    finally:
        plugin.stop()
    namespace, throttles, cluster_throttles, pods = objects
    docs = [object_to_dict(o) for o in [namespace, *throttles, *cluster_throttles, *pods]]

    own = len(compute_apps())
    daemon = Daemon(["--shards", str(SHARDS), "--device", "cuda"], SHARDS_ROOT / "cli.log",
                    SHARDS_DEADLINE_S, env={"KT_VERDICT_CACHE": "0"})
    try:
        apps = compute_apps()
        workers = workers_of(daemon.proc.pid)
        say("shards", step="cli-start", spawn_to_ready_s=f"{daemon.ready_s:.3f}",
            serving=repr(daemon.line(r"serving on")), workers=len(workers),
            compute_apps=len(apps), before=own)
        check(daemon.line(rf"shards={SHARDS}, device=cuda"), "the sharded daemon is not on the card")
        check(len(workers) == SHARDS, f"the sharded daemon runs {len(workers)} workers")
        check(len(apps) == own + SHARDS,
              f"{len(apps)} CUDA contexts with the sharded daemon up, {own} before it")
        t0 = time.perf_counter()
        for doc in docs:
            code, body = daemon.post("/v1/objects", doc)
            check(code == 200, f"/v1/objects answered {code}: {body}")
        posted_s = time.perf_counter() - t0
        # settled: the statuses the shards push back stand still
        last, stable = None, 0
        while stable < 3:
            check(time.perf_counter() - t0 < SHARDS_DEADLINE_S, "the sharded daemon never settled")
            cur = [daemon.get(path)[1] for path in ("/v1/throttles", "/v1/clusterthrottles")]
            for items in cur:
                for item in items:
                    item["status"]["calculatedThreshold"].pop("calculatedAt", None)
            stable = stable + 1 if cur == last else 0
            last = cur
            time.sleep(0.5)
        t1 = time.perf_counter()
        code, got = daemon.post("/v1/prefilter-batch")
        batch_ms = (time.perf_counter() - t1) * 1e3
        check(code == 200, f"/v1/prefilter-batch answered {code}")
        bad = verdicts_differ(got, want["schedulable"])
        say("shards", step="cli-batch", objects=len(docs), posted_s=f"{posted_s:.3f}",
            settled_s=f"{t1 - t0:.3f}", batch_ms=f"{batch_ms:.3f}",
            verdicts=len(got["schedulable"]), schedulable=sum(got["schedulable"].values()),
            differ=bad)
        check(bad == 0, f"{bad} HTTP batch verdicts of the sharded daemon differ")
        check(0 < sum(got["schedulable"].values()) < len(pods), "the CLI cluster is one-sided")
        stop_s = daemon.stop()
    finally:
        daemon.kill()
    left = [pid for pid in workers if alive(pid)]
    apps_after = len(compute_apps())
    say("shards", step="cli-sigterm", exit_code=0, shutdown_s=f"{stop_s:.3f}",
        workers_left=len(left), compute_apps=apps_after)
    check(not left and apps_after == own, f"workers {left} outlived the daemon's SIGTERM")
    return dict(ready_s=daemon.ready_s, batch_ms=batch_ms)


# --------------------------------------------------------------- scenarios


def reset_launches() -> None:
    """Every kernel wrapper's launch count in this process to 0."""
    from kube_throttler_tpu_torch.ops import check_dense, check_gather, victim_select

    check_dense.launches = check_gather.launches = check_gather.pack_launches = 0
    victim_select.launches = 0


def scenario_child(label: str, workdir: str) -> int:
    """One run of the ``[scenarios]`` phase, in this fresh interpreter, on
    the card: the port's runner with ``device="cuda"``, the launch counts
    set to 0 just before it and read at its parts. Prints one line,
    ``SCENARIO_REPORT {...}``: the gates, the wall seconds, the devices,
    the kernels' launches and what the checks read.

    Engine runs: every plugin batch is counted (its plugin, device and
    launches), and the counts are read as the verdict sweep starts, so the
    storm, the serving plugin's batch and the oracle's batch stand apart.
    Preemption: the counts are read before its closing oracle sweep. The
    sharded bad day: the workers' ``stats`` are read when the fleet is up,
    and again when the runner stops it; before that stop this script sends
    the fleet one batch and holds it against a host oracle."""
    import torch

    from kube_throttler_tpu_torch.metrics import kernel_launch_counts
    from kube_throttler_tpu_torch.plugin import KubeThrottler
    from kube_throttler_tpu_torch.scenarios import engine, preemption, sharded
    from kube_throttler_tpu_torch.scenarios.corpus import get_scenario

    runner = dict(SCENARIO_RUNS)[label]
    out = {"run": label, "runner": runner, "card": torch.cuda.get_device_name(0)}
    if runner == "engine":
        serving = {}
        batches = out["batches"] = []
        batch = KubeThrottler.pre_filter_batch

        def counted_batch(self, *args, **kwargs):
            before = kernel_launch_counts()
            try:
                return batch(self, *args, **kwargs)
            finally:
                batches.append({
                    "plugin": "serving" if self is serving.get("plugin") else "oracle",
                    "device": str(self.device_manager.device),
                    "launches": grown(kernel_launch_counts(), before)})

        sweep = engine._Engine.verdict_sweep

        def counted_sweep(self):
            out["launches_before_sweep"] = kernel_launch_counts()
            out["batches_before_sweep"] = len(batches)
            serving["plugin"] = self.plugin
            out["devices"] = {"engine": str(self.device),
                              "serving": str(self.plugin.device_manager.device)}
            return sweep(self)

        KubeThrottler.pre_filter_batch = counted_batch
        engine._Engine.verdict_sweep = counted_sweep
    elif runner == "preemption":
        # the storm's own launches, apart from its closing oracle sweep's
        # (the kernel held against the sequential oracle)
        oracle_sweep = preemption._oracle_sweep

        def counted_oracle_sweep(*args, **kwargs):
            out["launches_before_oracle_sweep"] = kernel_launch_counts()
            return oracle_sweep(*args, **kwargs)

        preemption._oracle_sweep = counted_oracle_sweep
    else:
        build = sharded._build_stack

        def counted_build(*args, **kwargs):
            front, supervisor = build(*args, **kwargs)
            out["workers_at_start"] = front.stats()["shards"]
            stop = supervisor.stop

            def stop_after_fleet_batch():
                try:
                    out["workers_after_storm"] = front.stats()["shards"]
                    out["fleet_batch"] = fleet_batch(front)
                    out["workers"] = front.stats()["shards"]
                except Exception as e:  # noqa: BLE001 — reported, fails the phase
                    out["fleet_error"] = repr(e)
                finally:
                    stop()

            supervisor.stop = stop_after_fleet_batch
            return front, supervisor

        sharded._build_stack = counted_build
    reset_launches()
    t0 = time.perf_counter()
    if runner == "engine":
        report = engine.run_scenario(get_scenario(label), SEED, workdir, device="cuda")
    elif runner == "preemption":
        report = preemption.run_preemption_storm(SEED, device="cuda")
    else:
        report = sharded.run_sharded_bad_day(n_shards=SCENARIO_SHARDS, seed=SEED, device="cuda")
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = kernel_launch_counts()
    out["gates"] = report["gates"]
    if runner == "engine":
        m = report["measurements"]
        out["pass"] = report["all_pass"]
        out["measurements"] = {k: m.get(k) for k in (
            "flip_lag_p50_ms", "flip_lag_p99_ms", "flip_samples", "flip_crossings",
            "lag_p99_ms", "events_per_sec", "pace_frac", "ops_applied", "restarts",
            "recovery_s", "wrong_verdicts", "verdicts_checked", "spot_checked")}
        for b in batches:
            out["devices"][f"{b['plugin']}-batch"] = b["device"]
    elif runner == "preemption":
        out["pass"] = report["ok"]
        out["measurements"] = {k: report.get(k) for k in (
            "groups", "residents_per_group", "waves", "admitted_gangs", "expected_gangs",
            "victims_total", "evicted_unique", "reevicted", "churn_frac")}
        out["devices"] = {"plugin": report["device"]}
    else:
        out["pass"] = report["pass"]
        out["measurements"] = {k: report.get(k) for k in (
            "pace_hz", "host_cores", "undersubscribed", "events", "dropped")}
        out["devices"] = {f"shard-{sid}": w.get("device")
                          for sid, w in out.get("workers", {}).items()}
    print(SCENARIO_REPORT + json.dumps(out, default=str), flush=True)
    return 0


def fleet_batch(front) -> dict:
    """One ``pre_filter_batch`` through the sharded fleet after the storm,
    held against a host oracle plugin over the front's objects."""
    import tools.harness_torch as H
    from kube_throttler_tpu_torch.api.pod import Namespace
    from kube_throttler_tpu_torch.engine.store import Store

    store = Store()
    store.create_namespace(Namespace("default"))
    for thr in front.store.list_throttles():
        store.create_throttle(thr)
    for pod in front.store.list_pods():
        store.create_pod(pod)
    oracle = H.build_plugin(store)
    try:
        oracle.run_pending_once()
        want = oracle.pre_filter_batch()["schedulable"]
    finally:
        oracle.stop()
    t0 = time.perf_counter()
    got = front.pre_filter_batch()
    return {"ms": (time.perf_counter() - t0) * 1e3, "checked": len(want),
            "differ": verdicts_differ(got, want)}


def worker_launches(s: dict) -> dict:
    """The sharded run's launches per worker, in the storm (from the fleet's
    start to the end of the replay; a worker restarted in it counts from
    its restart, its own prewarm included, and is marked) and in this
    script's fleet batch after it."""
    restarts = {str(k): v for k, v in s["gates"]["recovery"]["restarts"].items()}
    per = {}
    for sid, end in s["workers"].items():
        mid = s["workers_after_storm"][sid]
        start = s["workers_at_start"].get(sid, {})
        restarted = restarts.get(str(sid), 0) > 0
        check(end.get("alive") and mid.get("alive"), f"shard {sid} answered no stats: {end}")
        per[f"shard-{sid}"] = {
            "storm": grown(mid["kernel_launches"],
                           {} if restarted else start["kernel_launches"]),
            "fleet_batch": grown(end["kernel_launches"], mid["kernel_launches"]),
            "restarted": restarted,
        }
    return per


def check_scenario(s: dict) -> dict:
    """The ``[scenarios]`` checks of one run: zero wrong verdicts, the
    storm's correctness gates, the sharded recovery, every plugin and
    worker on the card, and the path's kernels launched. Returns the run's
    launches per kernel, by part of the run."""
    label, runner, gates = s["run"], s["runner"], s["gates"]
    for key, dev in s["devices"].items():
        check(str(dev).startswith("cuda"), f"{label}: {key} runs on {dev}")
    parts = {}
    if runner == "engine":
        check(gates["verdicts"]["pass"] and s["measurements"]["wrong_verdicts"] == 0,
              f"{label}: wrong verdicts {gates['verdicts']}")
        sweep = s["batches"][s["batches_before_sweep"]:]
        check([b["plugin"] for b in sweep] == ["serving", "oracle"],
              f"{label}: the verdict sweep's batches were {sweep}")
        parts["storm"] = s["launches_before_sweep"]
        parts["serving_batch"], parts["oracle_batch"] = (b["launches"] for b in sweep)
        served = parts["storm"]["check_gather"] + parts["serving_batch"]["check_gather"]
        check(served >= 1, f"{label}: the serving plugin launched no check_gather: {parts}")
        total = s["launches"]
        check(total["pack_gather_rows"] == total["check_gather"],
              f"{label}: check_gather launches and packs differ: {total}")
    elif runner == "preemption":
        for name in PREEMPT_CORRECTNESS_GATES:
            check(gates.get(name) is True, f"{label}: gate {name} is {gates.get(name)}")
        parts["storm"] = s["launches_before_oracle_sweep"]
        parts["oracle_sweep"] = grown(s["launches"], parts["storm"])
        check(parts["storm"]["victim_select"] >= 1,
              f"{label}: the storm's cycles launched no victim_select")
    else:
        check("fleet_error" not in s, f"{label}: the fleet batch failed: {s.get('fleet_error')}")
        check(gates["verdicts"]["pass"], f"{label}: wrong verdicts {gates['verdicts']}")
        check(gates["recovery"]["pass"], f"{label}: recovery failed {gates['recovery']}")
        fb = s["fleet_batch"]
        check(fb["differ"] == 0, f"{label}: {fb['differ']} of the fleet batch's verdicts differ")
        per = worker_launches(s)
        for part in ("storm", "fleet_batch"):
            parts[part] = {name: sum(w[part].get(name, 0) for w in per.values())
                           for name in KERNEL_COUNTERS}
        check(parts["fleet_batch"]["check_gather"] >= 1,
              f"{label}: no worker launched check_gather: {per}")
        parts["per_worker"] = per
    return parts


def gate_value(g) -> tuple:
    """A gate's (passed, value, bound), whichever runner wrote it."""
    if isinstance(g, bool):
        return g, None, None
    value = g.get("value", {k: v for k, v in g.items()
                            if k not in ("pass", "bound", "bound_ms", "bound_s")})
    return g["pass"], value, g.get("bound", g.get("bound_ms", g.get("bound_s")))


def drive_scenarios(card: str) -> dict:
    """The ``[scenarios]`` phase: each run of SCENARIO_RUNS in a child
    interpreter (``chip_smoke.py --scenario-child RUN DIR``, its own session,
    its stderr under SCENARIO_ROOT); a child that exits non-zero, outlives
    SCENARIO_DEADLINE_S or writes no report fails the phase."""
    import signal

    shutil.rmtree(SCENARIO_ROOT, ignore_errors=True)
    results = {}
    for label, runner in SCENARIO_RUNS:
        wd = SCENARIO_ROOT / label
        wd.mkdir(parents=True)
        env = {**os.environ, "KT_VERDICT_CACHE": "0",
               "PYTHONPATH": str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", "")}
        log = SCENARIO_ROOT / f"{label}.log"
        t0 = time.perf_counter()
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), "--scenario-child", label, str(wd)],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env, start_new_session=True,
            )
            try:
                stdout, _ = proc.communicate(timeout=SCENARIO_DEADLINE_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                stdout, _ = proc.communicate()
        child_s = time.perf_counter() - t0
        lines = [x for x in stdout.splitlines() if x.startswith(SCENARIO_REPORT)]
        if proc.returncode != 0 or not lines:
            print(f"[scenarios] {label} log tail:\n" + "".join(
                log.read_text(errors="replace").splitlines(keepends=True)[-40:]), flush=True)
            check(False, f"scenario run {label} exited {proc.returncode} "
                         f"with {'a' if lines else 'no'} report")
        s = json.loads(lines[-1][len(SCENARIO_REPORT):])
        for name, g in s["gates"].items():
            passed, value, bound = gate_value(g)
            note = g.get("note") if isinstance(g, dict) else None
            say("scenarios", run=label, gate=name, passed=passed,
                value=json.dumps(value, default=str), bound=json.dumps(bound, default=str),
                **({"note": repr(note)} if note else {}))
        launches = check_scenario(s)
        say("scenarios", run=label, step="summary", all_pass=s["pass"],
            wall_s=f"{s['wall_s']:.3f}", child_s=f"{child_s:.3f}",
            measurements=json.dumps(s["measurements"], default=str),
            devices=json.dumps(s["devices"]), launches=json.dumps(launches),
            **({"fleet_batch": json.dumps(s["fleet_batch"])} if "fleet_batch" in s else {}),
            card=repr(card))
        results[label] = dict(launches=launches, wall_s=s["wall_s"], gates=s["gates"])
    shutil.rmtree(SCENARIO_ROOT, ignore_errors=True)
    return results


# --------------------------------------------------------------- armed


class Churn:
    """A thread that applies pod ADDED/DELETED events through ``store``:
    Running pods of the label groups ≡ ARMED_CHURN_MOD (mod n_cluster),
    each deleted WINDOW creations after it was added, and the rest deleted
    when it stops. ``errors`` holds what an event or the loop raised."""

    WINDOW = 32

    def __init__(self, store, groups: int, n_cluster: int):
        import threading

        self.store = store
        self.groups = [g for g in range(groups) if g % n_cluster == ARMED_CHURN_MOD]
        self.n_cluster = n_cluster
        self.added = self.deleted = 0
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="armed-churn", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=120)
        check(not self._thread.is_alive(), "the churn thread did not stop")

    def _apply(self, ops) -> None:
        for res in self.store.apply_events(ops):
            if isinstance(res, Exception):
                self.errors.append(repr(res))

    def _run(self) -> None:
        from collections import deque

        from kube_throttler_tpu_torch.api.pod import make_pod

        rng = random.Random(SEED + 9)
        live = deque()
        try:
            while not self._stop.is_set():
                g = rng.choice(self.groups)
                pod = make_pod(f"churn-{self.added}",
                               labels={"grp": f"g{g}", "mod": f"m{g % self.n_cluster}"},
                               requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
                               node_name="node-1", phase="Running")
                self._apply([("create", "Pod", pod)])
                self.added += 1
                live.append(pod.key)
                if len(live) > self.WINDOW:
                    self._apply([("delete", "Pod", live.popleft())])
                    self.deleted += 1
                time.sleep(0.002)
            self._apply([("delete", "Pod", key) for key in live])
            self.deleted += len(live)
        except Exception as e:  # noqa: BLE001 — reported, fails the phase
            self.errors.append(repr(e))


def settle(plugin, quiet_s: float = 1.0, deadline_s: float = 120.0) -> float:
    """Wait until both controllers' work queues have been empty, with no
    key in process, for ``quiet_s``; returns the seconds waited."""

    def busy(q) -> bool:
        with q._lock:  # noqa: SLF001 — the queue has no idle probe of its own
            return bool(len(q) or q._processing)  # noqa: SLF001

    t0 = quiet = time.perf_counter()
    while True:
        now = time.perf_counter()
        if any(busy(c.workqueue) for c in (plugin.throttle_ctr, plugin.cluster_throttle_ctr)):
            quiet = now
        elif now - quiet >= quiet_s:
            return now - t0
        check(now - t0 < deadline_s, "the reconcile queues did not settle")
        time.sleep(0.05)


@contextmanager
def thread_errors():
    """Every uncaught exception of a thread while the block runs; the
    hook is undone on exit."""
    import threading

    errors = []
    hook = threading.excepthook
    threading.excepthook = lambda a: errors.append(
        f"{a.thread.name if a.thread else '?'}: {a.exc_type.__name__}: {a.exc_value}"[:4000])
    try:
        yield errors
    finally:
        threading.excepthook = hook


def armed_child(n_pods: int, n_throttles: int, groups: int, n_cluster: int,
                device: str = "cuda") -> int:
    """The ``[armed]`` phase, in this fresh interpreter whose environment
    arms the runtime twins (ARMED_ENV): the cluster on ``device``, its
    reconcile workers started, then the phase's calls (ARMED_CLUSTER's
    comment) under the churn, the launch counts set to 0 just before
    them. Then the churn stops, the queues settle, and one more
    ``pre_filter_batch`` is held against the host oracle on that final
    state. Prints ``ARMED_REPORT {...}``: the shape, the seconds, each
    kernel's launches, every lock-order, lock-assertion or hold-budget
    violation raised in any thread (``lockorder.reports()``, caught or
    not), every uncaught thread exception, the race reports and the
    assassin's reports made since it started, its checks, the oracle
    comparison. The tests rehearse it on the CPU (``device="cpu"``)."""
    from kube_throttler_tpu_torch.utils import epochassert, lockorder, racedetect

    races0, stale0, locks0 = racedetect.reports(), epochassert.reports(), lockorder.reports()
    with thread_errors() as uncaught:
        out = armed_phase(n_pods, n_throttles, groups, n_cluster, device)
    out["lock_errors"] = [e[:4000] for e in lockorder.reports()[len(locks0):]]
    out["thread_errors"] = uncaught
    out["race_reports"] = [r.render() for r in racedetect.reports()
                           if not any(r is b for b in races0)]
    out["race_waivers_fired"] = sorted(racedetect.fired_waivers())
    out["stale_verdicts"] = epochassert.reports()[len(stale0):]
    print(ARMED_REPORT + json.dumps(out, default=str), flush=True)
    return 0


def armed_phase(n_pods: int, n_throttles: int, groups: int, n_cluster: int, device: str) -> dict:
    """What ``armed_child`` drives and measures, as a dict."""
    from dataclasses import replace

    import torch

    from kube_throttler_tpu_torch.api.pod import make_pod
    from kube_throttler_tpu_torch.api.types import ResourceAmount
    from kube_throttler_tpu_torch.engine.verdictcache import VerdictCache
    from kube_throttler_tpu_torch.metrics import kernel_launch_counts
    from kube_throttler_tpu_torch.quantity import to_milli
    from kube_throttler_tpu_torch.utils import epochassert, lockorder, racedetect

    armed = {"lock_assert": lockorder.lock_assert_enabled(), "race_detect": racedetect.enabled(),
             "epoch_assert": epochassert.enabled()}
    check(all(armed.values()), f"the runtime twins are not armed: {armed}")
    out = {"card": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "armed": armed, "cluster": [n_pods, n_throttles, groups, n_cluster]}
    t0 = time.perf_counter()
    plugin = build_cluster(device, n_pods, n_throttles, groups, n_cluster, SEED)
    out["build_s"] = time.perf_counter() - t0
    store, dm = plugin.store, plugin.device_manager
    out["main_lock"] = type(dm._lock).__name__  # noqa: SLF001
    check("Instrumented" in out["main_lock"], f"the mirror's lock is a {out['main_lock']}")
    t0 = time.perf_counter()
    plugin.run_pending_once()
    dm.prewarm()
    plugin.throttle_ctr.start()
    plugin.cluster_throttle_ctr.start()
    out["settle_s"] = time.perf_counter() - t0

    churn = Churn(store, groups, n_cluster)
    # each churned group's first Throttle at its used cpu + 300m, so the
    # churn's pods flip its verdicts (ARMED_CLUSTER's comment)
    for g in churn.groups:
        thr = store.get_throttle("default", f"t{g}")
        used = to_milli(thr.status.used.resource_requests.get("cpu", "0"))
        store.update_throttle_spec(replace(thr, spec=replace(
            thr.spec, threshold=ResourceAmount.of(requests={"cpu": f"{used + 300}m"}))))
    out["near_throttles"] = len(churn.groups)
    reset_launches()
    t_phase = time.perf_counter()
    churn.start()
    try:
        # the batches, on a moving state: every pod answered, no error
        batches = out["batches"] = []
        for _ in range(ARMED_BATCHES):
            t0 = time.perf_counter()
            res = plugin.pre_filter_batch()
            batches.append({"ms": (time.perf_counter() - t0) * 1e3,
                            "verdicts": len(res["schedulable"]), "errors": len(res["errors"]),
                            "routes": dict(dm.last_batch_routes)})
        t0 = time.perf_counter()
        tick = plugin.full_tick_sharded(1)
        out["tick"] = {"ms": (time.perf_counter() - t0) * 1e3, "mesh": tick["mesh"],
                       "verdicts": len(tick["schedulable"]), "errors": len(tick["errors"])}

        # single-pod PreFilters, each twice: the second is a hit of a
        # verdict cache attached for this step, which the assassin
        # shadow-recomputes (every hit: sample 1); the quiet probes first,
        # then the churned (ARMED_CLUSTER's comment)
        rng = random.Random(SEED + 10)
        stored = [p for p in plugin.listers.pods.list() if not p.name.startswith("churn-")]
        churned = f"m{ARMED_CHURN_MOD}"
        probe_sets = {
            "quiet": rng.sample([p for p in stored if p.labels.get("mod") != churned],
                                ARMED_SINGLE),
            "churned": rng.sample([p for p in stored if p.labels.get("mod") == churned],
                                  ARMED_SINGLE),
        }
        plugin.verdict_cache = VerdictCache(capacity=65536)
        epochassert.set_sample(1)
        out["single"] = {}
        for name, probes in probe_sets.items():
            hits0, misses0 = plugin.verdict_cache.stats()[:2]
            stale0 = len(epochassert.reports())
            differ = moved = 0
            t0 = time.perf_counter()
            for pod in probes:
                fp = dm.verdict_fingerprint(pod)
                first = plugin.pre_filter(pod)
                if name == "churned":
                    time.sleep(ARMED_CHURNED_GAP_S)  # the churn moves on
                second = plugin.pre_filter(pod)
                differ += (first.code, sorted(first.reasons)) != (second.code, sorted(second.reasons))
                moved += dm.verdict_fingerprint(pod) != fp
            hits, misses = plugin.verdict_cache.stats()[:2]
            out["single"][name] = {
                "pods": len(probes), "ms": (time.perf_counter() - t0) * 1e3,
                "cache_hits": hits - hits0, "cache_misses": misses - misses0,
                "epoch_moved": moved, "repeat_differs": differ,
                "stale_verdicts": len(epochassert.reports()) - stale0}
        plugin.verdict_cache = None

        t0 = time.perf_counter()
        gangs = build_gangs(plugin, SEED + 4, n_groups=groups)
        answered = dm.gang_check_groups(gangs)
        out["gang"] = {"gangs": len(gangs), "answered": len(answered),
                       "fit": sum(v["ok"] for v in answered.values()),
                       "ms": (time.perf_counter() - t0) * 1e3}

        # a rejected priority-5 gang in PREEMPT_GROUP's label group, then a cycle
        plugin.set_policy_specs([dict(PREEMPT_POLICY)])
        thr = store.get_throttle("default", f"t{PREEMPT_GROUP}")
        used = to_milli(thr.status.used.resource_requests["cpu"])
        store.update_throttle_spec(replace(thr, spec=replace(
            thr.spec, threshold=ResourceAmount.of(requests={"cpu": f"{used + 300}m"}))))
        gang = [make_pod(f"hi-{r}", labels={"grp": f"g{PREEMPT_GROUP}",
                                            "mod": f"m{PREEMPT_GROUP % n_cluster}"},
                         requests={"cpu": "100m"}, group="hi", group_size=GANG_SIZE,
                         priority=5)
                for r in range(GANG_SIZE)]
        deadline = time.perf_counter() + 60
        while plugin.pre_filter_gang("default/hi", gang).is_success():
            check(time.perf_counter() < deadline, "the priority-5 gang was never rejected")
            plugin.run_pending_once()
            time.sleep(0.05)
        t0 = time.perf_counter()
        evicted = plugin.maybe_preempt_gang("default/hi", gang)
        out["preempt"] = {"evicted": evicted, "ms": (time.perf_counter() - t0) * 1e3}
    finally:
        churn.stop()
    out["phase_s"] = time.perf_counter() - t_phase
    out["churn"] = {"added": churn.added, "deleted": churn.deleted, "errors": churn.errors}

    # the oracle on the final state: the churn's pods all deleted, the
    # reconciles settled
    out["settle_after_s"] = settle(plugin)
    t0 = time.perf_counter()
    final = plugin.pre_filter_batch()
    n_probe, mismatches, tally, _ = oracle_check(plugin, final, ORACLE_SAMPLE, SEED + 11)
    out["final"] = {"ms": (time.perf_counter() - t0) * 1e3, "verdicts": len(final["schedulable"]),
                    "errors": len(final["errors"]), "pods": len(plugin.listers.pods.list()),
                    "oracle_sample": n_probe, "oracle_mismatches": mismatches, "tally": tally,
                    "routes": dict(dm.last_batch_routes), "breaker": dm.breaker_state()}
    out["launches"] = kernel_launch_counts()
    plugin.stop()
    return out


def drive_armed(card: str) -> dict:
    """The ``[armed]`` phase: ``chip_smoke.py --armed-child`` over
    ARMED_CLUSTER in a child interpreter (its own session, ARMED_ENV, its
    stderr in ARMED_ROOT/armed.log, killed whole past ARMED_DEADLINE_S).
    Prints each race report on lines of its own, then one ``[armed]``
    line; fails unless every kernel of the path launched in the phase and
    nothing was reported."""
    import signal

    shutil.rmtree(ARMED_ROOT, ignore_errors=True)
    ARMED_ROOT.mkdir(parents=True)
    env = {**os.environ, **ARMED_ENV,
           "PYTHONPATH": str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    log = ARMED_ROOT / "armed.log"
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--armed-child",
             *map(str, ARMED_CLUSTER)],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env, start_new_session=True,
        )
        try:
            stdout, _ = proc.communicate(timeout=ARMED_DEADLINE_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            stdout, _ = proc.communicate()
    child_s = time.perf_counter() - t0
    lines = [x for x in stdout.splitlines() if x.startswith(ARMED_REPORT)]
    if proc.returncode != 0 or not lines:
        print("[armed] log tail:\n" + "".join(
            log.read_text(errors="replace").splitlines(keepends=True)[-60:]), flush=True)
        check(False, f"the armed child exited {proc.returncode} "
                     f"with {'a' if lines else 'no'} report")
    s = json.loads(lines[-1][len(ARMED_REPORT):])
    for r in s["race_reports"]:
        print("[armed] race report:\n" + r, flush=True)
    for e in s["lock_errors"] + s["thread_errors"] + s["stale_verdicts"]:
        print("[armed] error: " + e, flush=True)
    launches = s["launches"]
    say("armed", cluster=json.dumps(s["cluster"]), build_s=f"{s['build_s']:.3f}",
        settle_s=f"{s['settle_s']:.3f}", phase_s=f"{s['phase_s']:.3f}",
        settle_after_s=f"{s['settle_after_s']:.3f}", child_s=f"{child_s:.3f}",
        launches=json.dumps(launches), lock_violations=len(s["lock_errors"]),
        thread_errors=len(s["thread_errors"]), race_reports=len(s["race_reports"]),
        race_waivers_fired=json.dumps(s["race_waivers_fired"]),
        stale_verdicts=len(s["stale_verdicts"]),
        stale_quiet=s["single"]["quiet"]["stale_verdicts"],
        stale_churned=s["single"]["churned"]["stale_verdicts"],
        epoch_checks_quiet=s["single"]["quiet"]["cache_hits"],
        epoch_checks_churned=s["single"]["churned"]["cache_hits"],
        repeat_differs_churned=s["single"]["churned"]["repeat_differs"],
        oracle_sample=s["final"]["oracle_sample"],
        oracle_mismatches=s["final"]["oracle_mismatches"],
        batches=json.dumps(s["batches"]), tick=json.dumps(s["tick"]),
        single=json.dumps(s["single"]), gang=json.dumps(s["gang"]),
        preempt=json.dumps(s["preempt"]), churn=json.dumps(s["churn"]),
        final=json.dumps(s["final"]), main_lock=s["main_lock"], card=repr(card))
    for name in KERNEL_COUNTERS:
        check(launches[name] > 0, f"{name} was not launched in the armed phase")
    check(not s["lock_errors"], f"{len(s['lock_errors'])} lock-order or lock-assertion errors")
    check(not s["thread_errors"], f"{len(s['thread_errors'])} uncaught thread exceptions")
    check(not s["race_reports"], f"{len(s['race_reports'])} unwaived race reports")
    check(not s["stale_verdicts"], f"{len(s['stale_verdicts'])} stale verdicts")
    check(not s["churn"]["errors"], f"the churn failed: {s['churn']['errors'][:3]}")
    check(s["churn"]["added"] > 0 and s["churn"]["added"] == s["churn"]["deleted"],
          f"the churn added {s['churn']['added']} and deleted {s['churn']['deleted']} pods")
    n_pods = s["cluster"][0]
    for b in s["batches"] + [s["tick"], s["final"]]:
        check(b["verdicts"] >= n_pods and b["errors"] == 0, f"armed verdicts missing: {b}")
    check(s["tick"]["mesh"] == [1, 1], f"the armed tick ran on mesh {s['tick']['mesh']}")
    quiet, churned = s["single"]["quiet"], s["single"]["churned"]
    check(quiet["repeat_differs"] == 0 and quiet["cache_hits"] > 0,
          f"quiet single-pod PreFilters: {quiet}")
    check(churned["epoch_moved"] > 0 and churned["stale_verdicts"] == 0,
          f"churned single-pod PreFilters: {churned}")
    check(s["gang"]["answered"] == s["gang"]["gangs"], f"gang_check_groups: {s['gang']}")
    check(s["preempt"]["evicted"] is True, "the armed maybe_preempt_gang evicted nothing")
    check(s["final"]["oracle_sample"] >= 2000 and s["final"]["oracle_mismatches"] == 0,
          f"{s['final']['oracle_mismatches']} final batch verdicts differ from the host oracle")
    check(s["final"]["breaker"] == "closed", f"breaker is {s['final']['breaker']}")
    shutil.rmtree(ARMED_ROOT, ignore_errors=True)
    return dict(launches=launches, build_s=s["build_s"], phase_s=s["phase_s"], child_s=child_s)


def property_helpers():
    """``tests/torch_props.py`` and ``tests/torch_soak.py`` of this
    checkout, imported with ``tests/`` on ``sys.path`` (they import its
    ``torch_gather_cases`` by name); neither imports pytest's conftest."""
    tests = str(HERE / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_props
    import torch_soak

    return torch_props, torch_soak


def run_property(name: str, strategy, body, max_examples: int) -> dict:
    """Hypothesis over ``strategy`` (derandomized, no database, no
    deadline): ``body(*drawn)`` returns what differed, and any difference
    fails the example, so Hypothesis shrinks it. → examples run (valid
    ones), mismatching examples, launches and seconds; on a failure the
    failing example is printed in full and the smoke fails."""
    from hypothesis import given, settings

    from kube_throttler_tpu_torch.metrics import kernel_launch_counts

    seen = {"examples": 0, "mismatches": 0, "failing": None}

    @settings(max_examples=max_examples, derandomize=True, database=None, deadline=None)
    @given(strategy)
    def prop(drawn):
        bad = body(*drawn)
        seen["examples"] += 1
        if bad:
            seen["mismatches"] += 1
            seen["failing"] = (drawn, bad)
            raise AssertionError("; ".join(bad))

    before, t0 = kernel_launch_counts(), time.perf_counter()
    try:
        prop()
    except Exception as e:
        if seen["failing"] is not None:
            drawn, bad = seen["failing"]
            say("props", property=name, failing_example=repr(drawn), differs=json.dumps(bad))
        raise SmokeFailure(f"[props] {name}: {type(e).__name__}: {e}") from e
    after = kernel_launch_counts()
    return dict(examples=seen["examples"], mismatches=seen["mismatches"],
                seconds=time.perf_counter() - t0,
                launches={k: after[k] - before[k] for k in after})


def drive_props(device: str = "cuda") -> dict:
    """The ``[props]`` phase: each property of PROPS through the kernels on
    ``device``, each drawn input held against the kernel's plain version
    (and the single cell against the ordered 4-state oracle, the victim
    problems against the sequential host oracle). One line per property
    and one per kernel: examples, mismatches (must be 0), launches (must
    be > 0 on the card); the victim problems must reach each route of the
    kernel's launch shape (M <= 64, 64 < M <= 7256, and past 7256 with
    remaining's spill in registers, shared and device memory); the phase
    must end within PROPS_BUDGET_S."""
    from hypothesis import strategies as st

    tp, _ = property_helpers()
    routes: Counter = Counter()

    def victim_routes(contrib, deficit, cap, route):
        launched = tp.victim_route(contrib.shape[1])
        routes[launched] += 1
        bad = [] if launched == route else [f"drawn for {route}, launched {launched}"]
        return bad + tp.victim_mismatches(contrib, deficit, cap, device)

    bodies = {
        "single_cell": (st.tuples(tp.amounts(), tp.amounts(), tp.amounts(), tp.pod_requests(),
                                  st.booleans(), st.booleans()),
                        lambda *a: tp.single_cell_mismatches(*a, device)),
        "dense_states": (st.tuples(tp.clusters()), lambda c: tp.dense_mismatches(c, device)),
        "gather_states": (st.tuples(tp.clusters()), lambda c: tp.gather_mismatches(c, device)),
        "victim_problems": (st.tuples(tp.problems()),
                            lambda p: tp.victim_mismatches(*p, device)),
        "victim_padding": (st.tuples(tp.problems(), st.integers(min_value=0, max_value=8)),
                           lambda p, pad: tp.victim_padding_mismatches(*p, pad, device)),
        **{f"victim_{route}": (tp.wide_problems(route), victim_routes)
           for route in tp.VICTIM_ROUTES},
    }
    t0 = time.perf_counter()
    per_kernel: dict = {}
    for name, kernel, examples in PROPS:
        strategy, body = bodies[name]
        r = run_property(name, strategy, body, examples)
        say("props", property=name, kernel=kernel, examples=r["examples"],
            mismatches=r["mismatches"], seconds=f"{r['seconds']:.3f}",
            launches=json.dumps(r["launches"]))
        k = per_kernel.setdefault(kernel, {"examples": 0, "mismatches": 0,
                                           "launches": Counter()})
        k["examples"] += r["examples"]
        k["mismatches"] += r["mismatches"]
        k["launches"].update(r["launches"])
    seconds = time.perf_counter() - t0
    out = {}
    for kernel, k in per_kernel.items():
        own = ("check_gather", "pack_gather_rows") if kernel == "check_gather" else (kernel,)
        launches = {name: k["launches"][name] for name in own}
        say("props", kernel=kernel, examples=k["examples"], mismatches=k["mismatches"],
            launches=json.dumps(launches),
            **({"victim_routes": json.dumps(dict(routes))} if kernel == "victim_select" else {}))
        check(k["mismatches"] == 0, f"[props] {kernel} disagreed on {k['mismatches']} examples")
        if device == "cuda":
            for name, n in launches.items():
                check(n > 0, f"[props] {name} was not launched")
        out[kernel] = dict(examples=k["examples"], launches=launches)
    check(set(routes) == set(tp.VICTIM_ROUTES), f"[props] victim routes drawn: {dict(routes)}")
    say("props", step="summary", seconds=f"{seconds:.3f}", budget_s=PROPS_BUDGET_S)
    check(seconds <= PROPS_BUDGET_S, f"[props] took {seconds:.1f} s of {PROPS_BUDGET_S} s")
    return dict(kernels=out, seconds=seconds)


def soak_seeds() -> list:
    """The pinned seeds, then 4 onward: SOAK_MAX_SEEDS in all."""
    _, ts = property_helpers()
    rest = (s for s in range(4, 10 * SOAK_MAX_SEEDS) if s not in ts.PINNED_SEEDS)
    return (list(ts.PINNED_SEEDS) + list(rest))[:SOAK_MAX_SEEDS]


def drive_soak(device: str = "cuda") -> dict:
    """The ``[soak]`` phase: the differential soak's churn per seed with the
    device stack on ``device`` and the host stack on the CPU, without the
    verdict cache (so that every batch reaches the kernels); at every
    checkpoint each pod's ``pre_filter`` and each (Cluster)Throttle's
    status must agree, and the device stack's ``pre_filter_batch`` over
    all pods must equal the host stack's. Seeds past the pinned ones are
    cut, with the cut printed, once the next would cross SOAK_BUDGET_S. A
    divergence ends the phase: its line counts it and the smoke fails."""
    import logging

    from kube_throttler_tpu_torch.metrics import kernel_launch_counts

    _, ts = property_helpers()
    seeds = soak_seeds()
    saved = os.environ.get("KT_VERDICT_CACHE")
    os.environ["KT_VERDICT_CACHE"] = "0"
    # the stacks log every pod of a namespace not created yet, as the
    # reference does; the soak compares outcomes, not logs
    logging.disable(logging.CRITICAL)
    before, t0 = kernel_launch_counts(), time.perf_counter()
    ran, checkpoints, slowest, diverged = [], 0, 0.0, []
    try:
        for seed in seeds:
            elapsed = time.perf_counter() - t0
            if seed not in ts.PINNED_SEEDS and elapsed + slowest > SOAK_BUDGET_S:
                break
            s0 = time.perf_counter()
            stacks = (ts._stack(True, device), ts._stack(False, "cpu"))
            try:
                checkpoints += ts.checkpoints(ts.churn(seed, stacks, batch=True))
            except AssertionError as e:
                diverged.append((seed, repr(e)))
                break
            finally:
                for _, plugin, _ in stacks:
                    plugin.stop()
            ran.append(seed)
            slowest = max(slowest, time.perf_counter() - s0)
    finally:
        logging.disable(logging.NOTSET)
        if saved is None:
            os.environ.pop("KT_VERDICT_CACHE", None)
        else:
            os.environ["KT_VERDICT_CACHE"] = saved
    seconds = time.perf_counter() - t0
    after = kernel_launch_counts()
    launches = {k: after[k] - before[k] for k in ("check_gather", "pack_gather_rows",
                                                   "check_dense")}
    cut = [s for s in seeds if s not in ran and s not in dict(diverged)]
    say("soak", seeds_run=len(ran), seeds=json.dumps(ran), checkpoints=checkpoints,
        mismatches=len(diverged), launches=json.dumps(launches), seconds=f"{seconds:.3f}",
        budget_s=SOAK_BUDGET_S, cut=len(cut), cut_seeds=json.dumps(cut))
    if diverged:
        seed, what = diverged[0]
        raise SmokeFailure(f"[soak] seed {seed} diverged: {what}")
    check(set(ts.PINNED_SEEDS) <= set(ran), "[soak] a pinned seed did not run")
    if device == "cuda":
        for name, n in launches.items():
            check(n > 0, f"[soak] {name} was not launched")
    return dict(seeds=ran, checkpoints=checkpoints, launches=launches, seconds=seconds, cut=cut)


# --------------------------------------------------------------- deployed


def package_files(pkg: Path) -> list:
    """The package's files as its wheel holds them, as paths relative to
    the package's parent: everything but what is built where it runs
    (bytecode, the prebuilt ``_kernels/`` and any ``.so``)."""
    return sorted(
        str(p.relative_to(pkg.parent)) for p in pkg.rglob("*")
        if p.is_file() and p.suffix not in (".so", ".pyc")
        and not {"__pycache__", "_kernels"} & set(p.relative_to(pkg).parts)
    )


class Install:
    """The port as an operator installs it: the package copied into
    ``root/site`` as its wheel holds it (``package_files``), with no
    ``build/`` or ``pyproject.toml`` beside it. Its children run in
    ``root`` with ``root/site`` alone on ``PYTHONPATH``, a fresh ``HOME``
    and ``XDG_CACHE_HOME`` and the verdict cache off; ``runtime=True``
    also takes every ``nvcc`` out of reach, as in the image's runtime
    stage."""

    def __init__(self, root: Path):
        shutil.rmtree(root, ignore_errors=True)
        self.root, self.site = root, root / "site"
        self.home, self.cache = root / "home", root / "cache"
        self.no_cuda = root / "no-cuda"
        for d in (self.site, self.home, self.cache, self.no_cuda):
            d.mkdir(parents=True)
        self.files = package_files(HERE / PORT)
        for rel in self.files:
            (self.site / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(HERE / rel, self.site / rel)
        self.kernel_cache = self.cache / "kube-throttler-gpu" / "kernels"
        self.prebuilt = self.site / PORT / "_kernels"

    def env(self, runtime: bool = False, **extra) -> dict:
        env = {**os.environ, "PYTHONPATH": str(self.site), "HOME": str(self.home),
               "XDG_CACHE_HOME": str(self.cache), "KT_VERDICT_CACHE": "0", **extra}
        if runtime:
            env["CUDA_HOME"] = str(self.no_cuda)
            env["PATH"] = os.pathsep.join(
                d for d in env.get("PATH", "").split(os.pathsep)
                if d and not (Path(d) / "nvcc").exists())
            check(shutil.which("nvcc", path=env["PATH"]) is None, "nvcc is still on PATH")
        return env

    def run(self, *args, runtime: bool = False, timeout: float = 300.0) -> str:
        """``python args`` in the install's environment; its stdout, or a
        failure with its output."""
        proc = subprocess.run([sys.executable, *args], cwd=str(self.root),
                              env=self.env(runtime), capture_output=True, text=True,
                              timeout=timeout)
        check(proc.returncode == 0,
              f"{' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-2000:]}")
        return proc.stdout

    def listing(self) -> set:
        return {str(p.relative_to(self.site)) for p in self.site.rglob("*") if p.is_file()}

    def added(self, before: set) -> list:
        """Files of the install tree that are not in ``before`` and are
        neither bytecode nor the native selector engine: that one, the
        package's own loader builds into its folder when it is writable,
        as the JAX package's does."""
        return sorted(
            f for f in self.listing() - before
            if "__pycache__" not in Path(f).parts and Path(f).name != "_ktnative.so")

    def cached_kernels(self) -> list:
        return sorted(p.name for p in self.kernel_cache.glob("*.so"))


def deploy_config(root: Path) -> Path:
    """``config.yaml`` of ``deploy/config.yaml``'s ConfigMap, written under
    ``root``: the file the manifests mount at /etc/kube-throttler."""
    import yaml

    with open(HERE / "deploy" / "config.yaml") as f:
        doc = yaml.safe_load(f)
    path = root / "config.yaml"
    path.write_text(doc["data"]["config.yaml"])
    return path


def status_view(store) -> dict:
    """{kind: {key: (used, throttled)}} of a store's throttles."""
    return {
        "throttles": {t.key: (t.status.used.to_dict(), t.status.throttled.to_dict())
                      for t in store.list_throttles()},
        "clusterthrottles": {t.name: (t.status.used.to_dict(), t.status.throttled.to_dict())
                             for t in store.list_cluster_throttles()},
    }


def served_status_view(daemon: Daemon) -> dict:
    """``status_view`` of what a daemon's ``/v1/throttles`` and
    ``/v1/clusterthrottles`` serve."""
    view = {}
    for kind in ("throttles", "clusterthrottles"):
        code, items = daemon.get(f"/v1/{kind}")
        check(code == 200, f"/v1/{kind} answered {code}")
        view[kind] = {
            "/".join(filter(None, (i["metadata"].get("namespace"), i["metadata"]["name"]))):
            (i["status"]["used"], i["status"]["throttled"]) for i in items}
    return view


def wait_statuses(daemon: Daemon, want: dict, deadline_s: float) -> float:
    """Seconds until the daemon serves the in-process statuses ``want``:
    its reconcile (or its shards') has caught up with the cluster."""
    t0 = time.perf_counter()
    while True:
        got = served_status_view(daemon)
        if got == want:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > deadline_s:
            bad = sum(got[k].get(n) != v for k in want for n, v in want[k].items())
            raise SmokeFailure(f"{bad} served statuses never reached the in-process ones")
        time.sleep(0.25)


def deployed_reference(objects, device: str, seed: int) -> dict:
    """The in-process plugin's answers on ``objects``: every batch verdict,
    DEPLOYED_SINGLE seeded single-pod PreFilters, one tick, and the
    statuses its reconcile wrote."""
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    store = Store()
    # without the verdict cache, as the install's children run: the batch
    # takes the device routes at this size
    cache_env = os.environ.get("KT_VERDICT_CACHE")
    os.environ["KT_VERDICT_CACHE"] = "0"
    try:
        plugin = KubeThrottler(
            decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
            store, use_device=True, device=device,
        )
    finally:
        if cache_env is None:
            del os.environ["KT_VERDICT_CACHE"]
        else:
            os.environ["KT_VERDICT_CACHE"] = cache_env
    try:
        load_cluster(store, objects)
        plugin.run_pending_once()
        verdicts = plugin.pre_filter_batch()["schedulable"]
        routes = dict(plugin.device_manager.last_batch_routes)
        keys = sorted(random.Random(seed).sample(
            sorted(p.key for p in store.list_pods()), DEPLOYED_SINGLE))
        answers = {k: status_json(plugin.pre_filter(store.get_pod(*k.split("/", 1))))
                   for k in keys}
        tick = plugin.full_tick_sharded(1)
        statuses = status_view(store)
    finally:
        plugin.stop()
    check(0 < sum(verdicts.values()) < len(verdicts), "the deployed cluster is one-sided")
    check(routes == {"throttle": "sparse", "clusterthrottle": "dense"},
          f"the deployed cluster's batch took the routes {routes}")
    return dict(verdicts=verdicts, keys=keys, answers=answers, tick=tick, statuses=statuses,
                routes=routes)


def deployed_daemon(inst: Install, kubeconfig: Path, config: Path, ref: dict, device: str,
                    label: str, runtime: bool = False) -> dict:
    """``serve --kubeconfig --config`` from the install (deploy/gpu/deployment.yaml's
    command): once its statuses are the in-process ones, 1 HTTP batch, the
    DEPLOYED_SINGLE PreFilters and 1 tick, each equal to ``ref``; the
    kernel launches its ``/metrics`` shows over them, returned."""
    args = ["--kubeconfig", str(kubeconfig), "--config", str(config)]
    if device != "cuda":
        args += ["--device", device]
    t_start = time.perf_counter()
    daemon = Daemon(args, inst.root / f"{label}.log", DEPLOYED_DEADLINE_S,
                    env=inst.env(runtime), cwd=inst.root)
    try:
        check(daemon.line(rf"device={device}"), f"the installed daemon does not serve on {device}")
        settle_s = wait_statuses(daemon, ref["statuses"], DEPLOYED_DEADLINE_S)
        m0 = scrape(daemon)
        t0 = time.perf_counter()
        code, batch = daemon.post("/v1/prefilter-batch")
        batch_ms = (time.perf_counter() - t0) * 1e3
        check(code == 200, f"/v1/prefilter-batch answered {code}: {str(batch)[:300]}")
        batch_differ = verdicts_differ(batch, ref["verdicts"])
        single_differ = sum(daemon.post("/v1/prefilter", {"podKey": k})[1] != ref["answers"][k]
                            for k in ref["keys"])
        code, tick = daemon.post("/v1/tick", {"devices": 1})
        check(code == 200, f"/v1/tick answered {code}: {str(tick)[:300]}")
        tick_same = (tick["schedulable"] == ref["tick"]["schedulable"]
                     and tick["used"] == ref["tick"]["used"] and tick["errors"] == [])
        m1 = scrape(daemon)
        launched = grown(m1["launches"], m0["launches"])
        daemon.stop()
    finally:
        daemon.kill()
    prewarmed = next((t for t, x in daemon.arrivals if "prewarmed" in x), -1.0)
    say("deployed", part=label, seconds=f"{time.perf_counter() - t_start:.3f}",
        spawn_to_ready_s=f"{daemon.ready_s:.3f}", prewarmed_at_s=f"{prewarmed:.3f}",
        settle_s=f"{settle_s:.3f}", batch_ms=f"{batch_ms:.3f}",
        verdicts=len(batch["schedulable"]), batch_differ=batch_differ,
        single_pods=len(ref["keys"]), single_differ=single_differ, tick_same=tick_same,
        launches=json.dumps(launched, sort_keys=True),
        launches_total=json.dumps(m1["launches"], sort_keys=True), breaker=m1["breaker"],
        serving=repr(daemon.line(r"serving on")))
    check(batch_differ == 0, f"{label}: {batch_differ} batch verdicts differ")
    check(single_differ == 0, f"{label}: {single_differ} single-pod answers differ")
    check(tick_same, f"{label}: the tick differs from the in-process tick")
    if device == "cuda":
        check(m1["breaker"] == 0, f"{label}: the device breaker is in state {m1['breaker']}")
        for name in ("check_dense", "check_gather"):
            check(launched.get(name, 0) >= 1,
                  f"{label}: {name} launched {launched.get(name)} times")
    return launched


class Worker:
    """``python -m kube_throttler_tpu_torch.sharding.worker --listen`` from
    the install, one shard of deploy/gpu/sharded-fleet.yaml's StatefulSet
    (its data dir under the install's folder), started at once; ``wait``
    returns once it has written its bound address to its port file."""

    def __init__(self, inst: Install, sid: int, port: int, env: dict, device: str):
        self.inst, self.sid = inst, sid
        self.port_file = inst.root / f"shard-{sid}.port"
        self.port_file.unlink(missing_ok=True)
        self.log = inst.root / f"shard-{sid}.log"
        argv = [sys.executable, "-m", f"{PORT}.sharding.worker", "--shard-id", str(sid),
                "--shards", str(DEPLOYED_SHARDS), "--listen", f"127.0.0.1:{port}",
                "--port-file", str(self.port_file), "--data-dir", str(inst.root / f"shard-{sid}")]
        if device != "cuda":
            argv += ["--device", device]
        self.t0 = time.perf_counter()
        with open(self.log, "a") as out:
            self.proc = subprocess.Popen(argv, cwd=str(inst.root), env=env, stdout=out,
                                         stderr=subprocess.STDOUT, start_new_session=True)

    def wait(self) -> "Worker":
        while not self.port_file.exists():
            if (self.proc.poll() is not None
                    or time.perf_counter() - self.t0 > DEPLOYED_DEADLINE_S):
                self.kill()
                tail = "".join(self.log.read_text(errors="replace").splitlines(True)[-30:])
                raise SmokeFailure(
                    f"shard {self.sid} never listened (rc {self.proc.poll()}):\n{tail}")
            time.sleep(0.1)
        self.port = int(self.port_file.read_text().strip().rpartition(":")[2])
        self.ready_s = time.perf_counter() - self.t0
        return self

    def kill(self, sig=None) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL if sig is None else sig)
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def worker_stats(port: int, key: str) -> dict:
    """A worker's ``stats`` RPC, dialed on a lane of its own. The first
    request goes at epoch 0; once the front has resynced the worker that
    is stale, and the refusal carries the worker's epoch, at which the
    second request is answered. A probe moves no epoch and subscribes to
    nothing; it adds one to the worker's refused frames."""
    import socket
    import threading

    from kube_throttler_tpu_torch.sharding.ipc import read_frame, send_frame

    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        rfile, lock, epoch = sock.makefile("rb"), threading.Lock(), 0
        for rid in (1, 2):
            send_frame(sock, lock, "req", rid, ("stats", None), epoch=epoch, key=key)
            frame = read_frame(rfile, key=key)
            check(frame is not None and frame[:2] == ("res", rid),
                  f"the worker on {port} did not answer stats")
            (ok, body), epoch = frame[2], frame[3]
            if ok:
                return body
            check(rid == 1 and "FencedError" in str(body), f"stats refused: {body}")
    raise AssertionError("unreachable")


def post_objects(daemon: Daemon, objects) -> None:
    """``cluster_objects``' objects POSTed to ``/v1/objects``, eight at a
    time: the namespace, the throttles, then the pods."""
    from kube_throttler_tpu_torch.api.serialization import object_to_dict

    namespace, throttles, cluster_throttles, pods = objects

    def post(obj):
        code, body = daemon.post("/v1/objects", object_to_dict(obj))
        check(code == 200, f"/v1/objects answered {code}: {body}")

    post(namespace)
    with ThreadPoolExecutor(8) as pool:
        for group in (throttles + cluster_throttles, pods):
            list(pool.map(post, group))


def fleet_singles(front: Daemon, ref: dict) -> int:
    """How many of the DEPLOYED_SINGLE PreFilters the front answers
    otherwise than the in-process plugin (reasons compared as sets of
    throttle names: the front composes one reason per shard)."""
    return sum(normalized(front.post("/v1/prefilter", {"podKey": k})[1])
               != normalized(ref["answers"][k]) for k in ref["keys"])


def deployed_fleet(inst: Install, config: Path, objects, ref: dict, device: str,
                   runtime: bool) -> dict:
    """deploy/gpu/sharded-fleet.yaml on loopback, from the install: DEPLOYED_SHARDS
    workers serving ``--listen`` and a front dialing each with
    ``--shard-transport=tcp``, all three holding one ``KT_SHARD_AUTH_KEY``.
    The objects are POSTed to the front; once its statuses are the
    in-process ones, 1 batch and the single-pod PreFilters must equal the
    in-process answers and each worker's ``stats`` must show its device
    (and on the card its launches growing). Then worker 1 is SIGKILLed and
    restarted on its port, and the batch is polled until every verdict is
    back."""
    import secrets

    t_start = time.perf_counter()
    key = secrets.token_hex(32)
    env = inst.env(runtime, KT_SHARD_AUTH_KEY=key)
    workers = [Worker(inst, sid, 0, env, device) for sid in range(DEPLOYED_SHARDS)]
    front = None
    try:
        for w in workers:
            w.wait()
        front = Daemon(["--config", str(config), f"--shards={DEPLOYED_SHARDS}",
                        "--shard-transport=tcp", "--shard-rpc-deadline=5.0",
                        *(f"--shard-connect={w.sid}=127.0.0.1:{w.port}" for w in workers)],
                       inst.root / "front.log", DEPLOYED_DEADLINE_S, env=env, cwd=inst.root)
        check(front.line(r"device=remote"), "the front resolved a device of its own")
        t0 = time.perf_counter()
        post_objects(front, objects)
        posted_s = time.perf_counter() - t0
        settle_s = wait_statuses(front, ref["statuses"], DEPLOYED_DEADLINE_S)
        s0 = {w.sid: worker_stats(w.port, key) for w in workers}
        t1 = time.perf_counter()
        code, batch = front.post("/v1/prefilter-batch")
        batch_ms = (time.perf_counter() - t1) * 1e3
        check(code == 200, f"the front's batch answered {code}: {str(batch)[:300]}")
        batch_differ = verdicts_differ(batch, ref["verdicts"])
        single_differ = fleet_singles(front, ref)
        s1 = {w.sid: worker_stats(w.port, key) for w in workers}
        for sid, st in s1.items():
            check(st["device"].startswith(device), f"shard {sid} runs on {st['device']}")
        launched = check_shard_launches(s0, s1, 1) if device == "cuda" else {}
        say("deployed", part="fleet", workers=DEPLOYED_SHARDS,
            worker_ready_s=json.dumps([round(w.ready_s, 3) for w in workers]),
            front_ready_s=f"{front.ready_s:.3f}", objects=sum(map(len, objects[1:])) + 1,
            posted_s=f"{posted_s:.3f}", settle_s=f"{settle_s:.3f}", batch_ms=f"{batch_ms:.3f}",
            verdicts=len(batch["schedulable"]), batch_differ=batch_differ,
            single_pods=len(ref["keys"]), single_differ=single_differ,
            devices=json.dumps({sid: st["device"] for sid, st in s1.items()}),
            launches=json.dumps(launched, sort_keys=True),
            serving=repr(front.line(r"serving on")))
        check(batch_differ == 0, f"{batch_differ} of the fleet's batch verdicts differ")
        check(single_differ == 0, f"{single_differ} of the fleet's single-pod answers differ")

        # worker 1 SIGKILLed and restarted on its port: the front redials,
        # bumps the epoch and resyncs it
        port = workers[1].port
        t_kill = time.perf_counter()
        workers[1].kill()
        workers[1] = Worker(inst, 1, port, env, device).wait()
        polls = over_admitting = 0
        while True:
            code, body = front.post("/v1/prefilter-batch")
            polls += 1
            if code == 200:
                got = body["schedulable"]
                over_admitting += any(got.get(k) is True and not v
                                      for k, v in ref["verdicts"].items())
                if verdicts_differ(body, ref["verdicts"]) == 0:
                    break
            check(time.perf_counter() - t_kill < DEPLOYED_DEADLINE_S,
                  "the fleet's verdicts never came back after the worker's restart")
            time.sleep(0.25)
        back_s = time.perf_counter() - t_kill
        single_after = fleet_singles(front, ref)
        s2 = worker_stats(port, key)
        say("deployed", part="fleet-sigkill", shard=1, kill_to_back_s=f"{back_s:.3f}",
            fleet_s=f"{time.perf_counter() - t_start:.3f}",
            restart_ready_s=f"{workers[1].ready_s:.3f}", batch_polls=polls,
            over_admitting_polls=over_admitting, single_differ=single_after,
            device=s2["device"], epoch=s2["wire_epoch"],
            launches=json.dumps(s2["kernel_launches"], sort_keys=True))
        check(single_after == 0, f"{single_after} single-pod answers differ after the restart")
        check(s2["device"].startswith(device), f"the restarted shard runs on {s2['device']}")
        if device == "cuda":
            check(s2["kernel_launches"]["check_gather"] >= 1,
                  "the restarted shard launched no check_gather")
        front.stop()
    finally:
        if front is not None:
            front.kill()
        for w in workers:
            w.kill()
    return dict(launches=launched, kill_to_back_s=back_s)


def drive_deployed(card: str, device: str = "cuda", cluster=None, root=None) -> dict:
    """The ``[deployed]`` phase: the install (its package and kernel folder
    as a child sees them), then (a) the remote-mode daemon of
    deploy/gpu/deployment.yaml against a ``MockApiServer`` in this process
    holding ``cluster_objects(*cluster)``, with the install tree's listing
    before and after and the kernel cache it built; on the card (b) the
    same daemon after ``--prebuild`` with no ``nvcc`` reachable; and (c)
    the TCP fleet. Every answer is held against an in-process plugin on
    ``device``."""
    from kube_throttler_tpu_torch import kernels
    from kube_throttler_tpu_torch.client.mockserver import MockApiServer
    from kube_throttler_tpu_torch.engine.store import Store

    cluster = cluster or DEPLOYED_CLUSTER
    root = root or DEPLOYED_ROOT
    inst = Install(root)
    before = inst.listing()
    config = deploy_config(root)
    package, kernel_dir = inst.run(
        "-c", f"import {PORT} as p, {PORT}.kernels as k; print(p.__file__); print(k.build_dir())"
    ).split()
    say("deployed", part="install", files=len(inst.files), package=package,
        kernel_dir=kernel_dir, build_beside=(inst.site / "build").exists(), card=repr(card))
    check(Path(package).is_relative_to(inst.site), f"the child imported {package}")
    check(Path(kernel_dir) == inst.kernel_cache, f"the installed kernel folder is {kernel_dir}")
    want = sorted(kernels.library_name(name) for name in kernels.names())

    t0 = time.perf_counter()
    objects = cluster_objects(*cluster, SEED + 10)
    ref = deployed_reference(objects, device, SEED + 11)
    server = MockApiServer(Store())
    load_cluster(server.store, objects)
    server.start()
    kubeconfig = root / "kubeconfig.yaml"
    kubeconfig.write_text(
        f"clusters:\n- name: smoke\n  cluster: {{server: \"{server.url}\"}}\n"
        "contexts:\n- name: smoke\n  context: {cluster: smoke}\ncurrent-context: smoke\n")
    say("deployed", part="cluster", pods=cluster[0], throttles=cluster[1], groups=cluster[2],
        clusterthrottles=cluster[3], schedulable=sum(ref["verdicts"].values()),
        routes=json.dumps(ref["routes"], sort_keys=True),
        seconds=f"{time.perf_counter() - t0:.3f}")
    launches = {}
    try:
        launches["remote-daemon"] = deployed_daemon(inst, kubeconfig, config, ref, device,
                                                    "remote-daemon")
        added, cached = inst.added(before), inst.cached_kernels()
        native = sorted(f for f in inst.listing() - before if Path(f).name == "_ktnative.so")
        say("deployed", part="install-tree", new_files=json.dumps(added),
            native_engine=json.dumps(native), kernel_cache=json.dumps(cached),
            note=repr("the native engine builds into its package folder when that is "
                      "writable, as the JAX package's does"))
        check(not added, f"the daemon wrote into the install tree: {added[:5]}")
        if device == "cuda":
            check(cached == want, f"the kernel cache holds {cached}, not {want}")
            # (b) the image's runtime: libraries prebuilt into the package,
            # the cache emptied, no nvcc
            t0 = time.perf_counter()
            out = inst.run("-m", f"{PORT}.kernels", "--prebuild").split()
            prebuild_s = time.perf_counter() - t0
            check(sorted(Path(p).name for p in out) == want
                  and all(Path(p).parent == inst.prebuilt for p in out),
                  f"--prebuild wrote {out}")
            shutil.rmtree(inst.kernel_cache)
            launches["prebuilt-daemon"] = deployed_daemon(
                inst, kubeconfig, config, ref, device, "prebuilt-daemon", runtime=True)
            say("deployed", part="prebuilt", prebuild_s=f"{prebuild_s:.3f}",
                prebuilt=json.dumps(sorted(
                p.name for p in inst.prebuilt.glob("*.so"))),
                kernel_cache=json.dumps(inst.cached_kernels()),
                nvcc=repr(shutil.which("nvcc", path=inst.env(True)["PATH"])))
            check(inst.cached_kernels() == [], "the runtime daemon built into its cache")
        fleet = deployed_fleet(inst, config, objects, ref, device, runtime=device == "cuda")
        launches["fleet"] = fleet["launches"]
    finally:
        server.stop()
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, kill_to_back_s=fleet["kill_to_back_s"])


# --------------------------------------------------------------- phases


# --------------------------------------------------------------- tools


def tool_figures(name: str, stdout: str) -> dict:
    """What a tool of TOOLS printed, as figures: memsmoke's heap objects,
    RSS and device bytes per pod; profile_batch's warm and profiled
    batches (``split`` lines: ms, tracer phases, launches); profile_reconcile's
    drain (keys, keys/s and its ``split``). ``launches`` sums each kernel's
    launches over the calls the tool measured."""
    splits = {s["call"]: s for s in (json.loads(x[len("split "):])
                                     for x in stdout.splitlines() if x.startswith("split "))}
    launches = Counter()
    for split in splits.values():
        launches.update(split["launches"])
    fig = {"launches": dict(launches), **splits}
    if name == "memsmoke":
        m = re.search(r"— ([\d.]+) heap objects/pod \(bound [\d.]+\), (\d+) B RSS/pod", stdout)
        check(m is not None, "memsmoke printed no per-pod figures")
        d = re.search(r": (-?\d+) B allocated/pod", stdout)
        fig.update(heap_objects_per_pod=float(m.group(1)), rss_bytes_per_pod=int(m.group(2)),
                   device_bytes_per_pod=int(d.group(1)) if d else None)
    elif name == "profile_batch":
        check(set(splits) == {"warm", "profiled"}, f"profile_batch printed splits {sorted(splits)}")
    elif name == "profile_reconcile":
        m = re.search(r"^drained (\d+) keys in [\d.]+s \(([\d,]+) keys/s\)", stdout, re.M)
        check(m is not None and "drain" in splits, "profile_reconcile printed no drain")
        fig.update(keys=int(m.group(1)), keys_per_s=int(m.group(2).replace(",", "")))
    return fig


def drive_tools(card: str, device: str = "cuda") -> dict:
    """The ``[tools]`` phase: each of TOOLS (name, argv from the
    checkout's root) as a child process with ``--device device``, one at a
    time, in a session of its own, without the verdict cache, its output
    in ``TOOLS_ROOT/<name>.log``, killed whole past TOOLS_DEADLINE_S. One
    ``[tools]`` line each: exit code, wall seconds and ``tool_figures``.
    Fails on a non-zero exit (the log's tail printed) and, on the card,
    unless profile_batch's warm batch launched check_dense and
    check_gather."""
    import signal

    root = TOOLS_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "KT_VERDICT_CACHE": "0",
           "PYTHONPATH": str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = {}
    for name, argv in TOOLS:
        log = root / f"{name}.log"
        t0 = time.perf_counter()
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, *argv, "--device", device], cwd=str(HERE),
                stdout=subprocess.PIPE, stderr=err, text=True, env=env, start_new_session=True,
            )
            try:
                stdout, _ = proc.communicate(timeout=TOOLS_DEADLINE_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                stdout, _ = proc.communicate()
        wall_s = time.perf_counter() - t0
        with open(log, "a") as f:
            f.write(stdout)
        if proc.returncode != 0:
            print(f"[tools] {name} log tail:\n" + "".join(
                log.read_text(errors="replace").splitlines(keepends=True)[-40:]), flush=True)
            check(False, f"the tool {name} exited {proc.returncode} after {wall_s:.1f} s")
        fig = tool_figures(name, stdout)
        say("tools", tool=name, exit_code=0, wall_s=f"{wall_s:.3f}", device=device,
            **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in fig.items()},
            card=repr(card))
        out[name] = dict(fig, wall_s=wall_s)
    if device == "cuda" and "profile_batch" in out:
        warm = out["profile_batch"]["warm"]["launches"]
        for kernel in ("check_dense", "check_gather"):
            check(warm[kernel] >= 1, f"profile_batch's warm batch launched {kernel} "
                                     f"{warm[kernel]} times")
    launches = Counter()
    for fig in out.values():
        launches.update(fig["launches"])
    return dict(tools=out, launches={k: launches.get(k, 0) for k in KERNEL_COUNTERS})


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def run() -> int:
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.ops import check_gather as cg
    from kube_throttler_tpu_torch.ops import victim_select as vsel
    from kube_throttler_tpu_torch.ops.check import statuses_to_compact
    from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state
    from kube_throttler_tpu_torch.ops.schema import (
        pod_batch_from_arrays,
        throttle_state_from_arrays,
    )

    mark("build")
    card = card_line()
    say("card", nvidia_smi=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], devices=torch.cuda.device_count())

    t0 = time.perf_counter()
    # every kernel's nvcc and the ptxas reports', all started together
    ptxas = [start_ptxas_report(name) for name in PTXAS_INSTANTIATIONS]
    try:
        with ThreadPoolExecutor(2) as pool:
            builds = {"victim_select": pool.submit(vsel.load_library),
                      "check_gather": pool.submit(cg.load_library)}
            lib = cd.load_library()
            say("build", kernel="check_dense", seconds=f"{time.perf_counter() - t0:.2f}",
                library=lib._name)
            libs = {"check_dense": lib}
            for name, fut in builds.items():
                libs[name] = fut.result()
                say("build", kernel=name, seconds=f"{time.perf_counter() - t0:.2f}",
                    library=libs[name]._name)
        ptxas_rows = []
        for name, report in zip(PTXAS_INSTANTIATIONS, ptxas):
            rows = finish_ptxas_report(*report)
            sass = sass_counts(libs[name]._name)
            for row in rows:
                row.update(sass.get(row["kernel"], {}))
            ptxas_rows += rows
    finally:
        for proc, _, _ in ptxas:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    say("ptxas", seconds=f"{time.perf_counter() - t0:.2f}", kernels=json.dumps(ptxas_rows))

    mark("compare")
    # -- kernel against its plain version: every variant at every shape
    max_err = mismatches = 0
    rng = np.random.default_rng(SEED)
    cases = [("extremes", extremes_inputs("cuda"))]
    for P, T, R in COMPARE_SHAPES + (WIDE_T_SHAPE,):
        cases.append((f"{P}x{T}x{R}", device_inputs(*synth_arrays(rng, P, T, R), "cuda")))
    for label, (pre, pods, mask) in cases:
        geometry = cd._launch_shape(*mask.shape, pods.req.shape[1])
        for on_equal, step3 in VARIANTS:
            bad, err, counts = compare(pre, pods, mask, on_equal, step3)
            max_err, mismatches = max(max_err, err), mismatches + bad
            say("compare", shape=label, on_equal=on_equal, step3_on_equal=step3,
                mismatches=bad, status_counts=counts, geometry=json.dumps(geometry._asdict()))
            check(bad == 0, f"check_dense disagrees with its plain version at {label}")
    del cases

    # -- check_gather against its plain version: every cell, variant and form
    g_err = g_bad = 0
    # the card tests' cells and seeds (tests/test_torch_cuda.py), then the tick's
    cases_mod = gather_cases()
    gcases = [("extremes", (500, 16, 40, 3), 9, True)] + [
        ("x".join(map(str, cell)), cell, seed, False)
        for cell, seed in [cases_mod.gather_cell(K, R, card=True)
                           for K, R in cases_mod.LADDER + cases_mod.WIDE]
        + [(GATHER_TICK_CELL, SEED + 6)]]
    for label, (P, K, T, R), seed, ext in gcases:
        case = gather_inputs(seed, P, K, T, R, "cuda", extremes=ext)
        for on_equal, step3 in VARIANTS:
            bad, err, counts = compare_gather(*case, on_equal, step3)
            g_err, g_bad = max(g_err, err), g_bad + bad
            say("compare-gather", shape=label, on_equal=on_equal, step3_on_equal=step3,
                mismatches=bad, status_counts=counts,
                geometry=json.dumps(cg._launch_shape(P, T)._asdict()),
                record=json.dumps(cg.record_layout(R)._asdict()))
            check(bad == 0, f"check_gather disagrees with its plain version at {label}")
    del case
    torch.cuda.empty_cache()

    mark("main-path")
    # -- the full-width main path
    t0 = time.perf_counter()
    plugin = build_cluster("cuda", N_PODS, N_THROTTLES, GROUPS, N_CLUSTER, SEED)
    say("setup", pods=N_PODS, throttles=N_THROTTLES, groups=GROUPS,
        clusterthrottles=N_CLUSTER, seconds=f"{time.perf_counter() - t0:.1f}")
    try:
        res = drive_main_path(plugin, N_CALLS, ORACLE_SAMPLE, SEED)
        for i, (dt, disp, merge, nd, nl, dedupe, ng, npk) in enumerate(res["per_call"]):
            say("pre_filter_batch", call=i, ms=f"{dt * 1e3:.3f}",
                batch_dedupe_ms=f"{dedupe * 1e3:.3f}",
                batch_dispatch_ms=f"{disp * 1e3:.3f}", batch_merge_ms=f"{merge * 1e3:.3f}",
                check_dense_launches=nl, check_gather_launches=ng, pack_launches=npk,
                routes=json.dumps(res["routes"][i], sort_keys=True))
            check(nd == 1, "pre_filter_batch did not take the device batch path")
            check(nl >= 1, f"check_dense was not launched in call {i}")
            check(ng >= 1, f"check_gather was not launched in call {i}")
            check(npk == ng, f"{npk} packs for {ng} check_gather launches in call {i}")
        say("main-path-checks", shapes=json.dumps(res["shapes"], sort_keys=True),
            check_dense_launches=res["launches"], check_gather_launches=res["gather_launches"],
            pack_launches=res["pack_launches"],
            breaker=res["breaker"],
            verdicts=res["n_verdicts"], errors=res["errors"],
            oracle_sample=res["oracle_n"], oracle_mismatches=res["oracle_mismatches"],
            tally=json.dumps(res["tally"]), clusterthrottle_tally=json.dumps(res["cluster_tally"]))
        for r in res["routes"]:
            check(r == {"throttle": "sparse", "clusterthrottle": "dense"},
                  f"unexpected batch routes {r}")
        check(res["launches"] >= N_CALLS, "check_dense was not launched on every call")
        check(res["gather_launches"] >= N_CALLS, "check_gather was not launched on every call")
        check(res["pack_launches"] == res["gather_launches"],
              "the batch calls' check_gather launches and packs differ")
        check(res["breaker"] == "closed", f"breaker is {res['breaker']}")
        check(res["n_verdicts"] == N_PODS and res["errors"] == 0, "verdicts missing")
        check(res["oracle_n"] >= 2000 and res["oracle_mismatches"] == 0,
              "batch verdicts disagree with the host oracle")
        check(all(res["cluster_tally"][k] > 0 for k in res["cluster_tally"]),
              "the ClusterThrottle kind did not produce all four outcomes")
        verdicts = res["verdicts"]

        mark("answers")
        # -- the in-process answers the sharded fleet must give on this cluster
        single = inprocess_answers(plugin, SEED + 8)

        mark("trace")
        trace_batch(plugin, HERE / "build" / "traces")

        mark("main-path-compare")
        # -- kernel times at the shape the main path gave it (its own data)
        dm = plugin.device_manager
        ks = dm.clusterthrottle
        with dm._lock:  # noqa: SLF001 — the handle grab check_batch_all does
            state = ks.device_state()
            pods, mask = ks.device_pods(need_mask=True)
        pre = precompute_check_state(state)
        bad, err, _ = compare(pre, pods, mask, False, False)
        check(bad == 0, "check_dense disagrees with its plain version on the main path")
        max_err, mismatches = max(max_err, err), mismatches + bad
        # check_gather on the Throttle kind's written state, as dispatched
        with dm._lock:  # noqa: SLF001
            t_state = dm.throttle.device_state()
            t_pods, _ = dm.throttle.device_pods(need_mask=False)
            t_cols = dm.throttle.device_cols()
        bad, err, _ = compare_gather(t_state, t_pods, t_cols, False, True)
        check(bad == 0, "check_gather disagrees with its plain version on the main path")
        g_err, g_bad = max(g_err, err), g_bad + bad
        del t_state, t_pods, t_cols

        mark("coalesce")
        # -- the coalescer's device route (check_pods_multi) ≡ its host route
        coalesce = drive_coalesce(plugin, SEED + 7)

        mark("tick")
        # -- the reconcile tick over the same cluster
        tick = drive_tick(plugin, res.pop("verdicts"), N_TICKS)
        check(tick["launches"] >= N_TICKS, "check_dense was not launched on every tick")
        check(tick["gather_launches"] >= N_TICKS, "check_gather was not launched on every tick")
        check(tick["pack_launches"] == tick["gather_launches"],
              "the tick's check_gather launches and packs differ")
        g_err, g_bad = max(g_err, tick["gather"]["err"]), g_bad + tick["gather"]["mismatches"]

        mark("grid")
        # -- the multi-device tick: grids and a ring of slots on the card, ranks
        grid = drive_grid(plugin, card)

        mark("gang-victim-preempt")
        # -- gang admission, victim selection and preemption, same cluster
        drive_gang(plugin, SEED + 4)
        victim_rows, victim_bad, victim_err = drive_victim_cells(SEED + 5)
        preempt = drive_preempt(plugin, PREEMPT_GROUP)
    finally:
        plugin.stop()
    mark("timing")
    P, R = pods.req.shape
    T = mask.shape[1]
    flush = 64 << 20
    k_ms = cuda_ms(lambda: cd.check_dense(pre, pods, mask, False, False), 50, flush)
    launch_ms = kernel_only_ms(lib, pre, pods, mask, False, False, 50, flush)
    p_ms = cuda_ms(lambda: cd.check_dense_reference(pre, pods, mask, False, False), 20, flush)
    bound = dense_bound(pre, pods, mask)
    say("time", shape=f"{P}x{T}x{R}", check_dense_ms=f"{k_ms:.5f}",
        kernel_only_ms=f"{launch_ms:.5f}", plain_ms=f"{p_ms:.5f}",
        bound_ms=f"{bound['bound_ms']:.5f}", bound_by=bound["bound_by"],
        bytes_ms=f"{bound['bytes_ms']:.5f}", ops_ms=f"{bound['ops_ms']:.5f}", l2="flushed")
    # the ClusterThrottle kind's whole dense route as _dispatch_batch_check
    # runs it, and its parts beside the kernel
    pre_ms = cuda_ms(lambda: precompute_check_state(state), 50, flush)
    statuses = cd.check_dense(pre, pods, mask, False, False)
    compact_ms = cuda_ms(lambda: statuses_to_compact(statuses), 50, flush)
    route_ms = cuda_ms(lambda: statuses_to_compact(cd.check_dense(
        precompute_check_state(state), pods, mask, False, False)), 50, flush)
    say("time", route="clusterthrottle-dense", shape=f"{P}x{T}x{R}",
        route_ms=f"{route_ms:.5f}", precompute_check_state_ms=f"{pre_ms:.5f}",
        check_dense_ms=f"{k_ms:.5f}", statuses_to_compact_ms=f"{compact_ms:.5f}", l2="flushed")

    # the dense sweep: a real [T,R] state, P pod rows, a random mask made
    # on the card (1.3 G cells)
    SP, ST, SR = SWEEP_SHAPE
    srng = np.random.default_rng(SEED + 2)
    s_pre = precompute_check_state(
        throttle_state_from_arrays(synth_arrays(srng, 1, ST, SR)[0], device="cuda")
    )
    s_pods = pod_batch_from_arrays(synth_arrays(srng, SP, 1, SR)[1], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    s_mask = torch.randint(0, 2, (SP, ST), dtype=torch.uint8, device="cuda", generator=g).bool()
    s_ms = cuda_ms(lambda: cd.check_dense(s_pre, s_pods, s_mask, False, True), 10)
    s_launch_ms = kernel_only_ms(lib, s_pre, s_pods, s_mask, False, True, 10)
    s_bound = dense_bound(s_pre, s_pods, s_mask)
    say("time", shape=f"{SP}x{ST}x{SR}", check_dense_ms=f"{s_ms:.4f}",
        kernel_only_ms=f"{s_launch_ms:.4f}", bound_ms=f"{s_bound['bound_ms']:.4f}",
        bound_by=s_bound["bound_by"], bytes_ms=f"{s_bound['bytes_ms']:.4f}",
        ops_ms=f"{s_bound['ops_ms']:.4f}", l2="exceeded")

    # -- the design's variants, bare, at both timed shapes; each is first
    # held against the plain version at the main path's state and at a
    # wide shape
    w_pre, w_pods, w_mask = device_inputs(*synth_arrays(rng, 8192, ST, SR), "cuda")
    variants = []
    for label, knobs in DESIGN_VARIANTS:
        for args in ((pre, pods, mask, False, False), (w_pre, w_pods, w_mask, False, True)):
            shape = cd._launch_shape(*args[2].shape, args[1].req.shape[1], **knobs)
            _, out = bare_launch(lib, *args, shape=shape)
            bad, _, _ = compare(*args, got=out)
            check(bad == 0, f"variant {label} disagrees with its plain version")
        main_shape = cd._launch_shape(P, T, R, **knobs)
        sweep_shape = cd._launch_shape(SP, ST, SR, **knobs)
        v = {
            "variant": label, "knobs": knobs,
            "main_ms": kernel_only_ms(lib, pre, pods, mask, False, False, 50, flush,
                                      shape=main_shape),
            "sweep_ms": kernel_only_ms(lib, s_pre, s_pods, s_mask, False, True, 10,
                                       shape=sweep_shape),
            "main_geometry": main_shape._asdict(),
            "sweep_geometry": sweep_shape._asdict(),
        }
        variants.append(v)
        say("variant", **{k: json.dumps(x) if isinstance(x, dict) else x for k, x in v.items()})

    mark("daemon")
    # -- the daemon over a cluster of its own, then the embedded scheduler
    del s_mask, s_pre, s_pods, w_pre, w_pods, w_mask
    torch.cuda.empty_cache()
    try:
        served = daemon_cluster(DAEMON_ROOT)
        daemon = drive_daemon(DAEMON_ROOT / "data", served["single"], served["verdicts"])
    finally:
        shutil.rmtree(DAEMON_ROOT, ignore_errors=True)

    mark("tools")
    # -- the port's memory smoke and profiling tools, each a child on the card
    tools = drive_tools(card)

    mark("shards")
    # -- the sharded fleet on the card, in process and through the CLI
    shutil.rmtree(SHARDS_ROOT, ignore_errors=True)
    shards = drive_shards(verdicts, single)
    shards_cli = drive_shards_cli()
    shutil.rmtree(SHARDS_ROOT, ignore_errors=True)
    shard_launches = {
        name: sum(per[name] for per in shards["launches"].values())
        for name in KERNEL_COUNTERS
    }
    say("shards", step="summary", spawn_to_ready_s=f"{shards['start_s']:.3f}",
        load_and_drain_s=f"{shards['load_s']:.3f}",
        batch_ms=json.dumps([round(x, 3) for x in shards["per_call_ms"]]),
        kill_to_convergence_s=f"{shards['converged_s']:.3f}",
        cli_spawn_to_ready_s=f"{shards_cli['ready_s']:.3f}",
        cli_batch_ms=f"{shards_cli['batch_ms']:.3f}", launches=json.dumps(shard_launches))

    mark("scenarios")
    # -- the scenario engine's storms on the card, each in a fresh interpreter
    scenarios = drive_scenarios(card)
    # per kernel, run and part of the run (the storm; the serving plugin's,
    # the oracle's or the fleet's batch after it; the oracle sweep)
    scenario_launches = {
        name: {run: {part: n[name] for part, n in r["launches"].items() if part != "per_worker"}
               for run, r in scenarios.items()}
        for name in KERNEL_COUNTERS
    }
    say("scenarios", step="summary", launches=json.dumps(scenario_launches),
        wall_s=json.dumps({run: round(r["wall_s"], 3) for run, r in scenarios.items()}))

    mark("armed")
    # -- the main path with the analyzer's runtime twins armed, in a fresh
    # interpreter
    armed = drive_armed(card)

    mark("props")
    # -- the property tests' strategies through every kernel on the card
    props = drive_props()

    mark("soak")
    # -- the differential soak, its device stack on the card
    soak = drive_soak()

    mark("deployed")
    # -- the port as an operator installs and deploys it
    deployed = drive_deployed(card)
    deployed_launches = {name: deployed["launches"]["remote-daemon"].get(name, 0)
                         + deployed["launches"]["prebuilt-daemon"].get(name, 0)
                         + sum(s.get(name, 0) for s in deployed["launches"]["fleet"].values())
                         for name in KERNEL_COUNTERS}

    say("phases", seconds=json.dumps(phase_seconds()))

    kernels = {"kernels": [{
        "name": "check_dense",
        "route": "cuda",
        "source": f"{PORT}/csrc/check_dense.cu",
        "replaces": "kube_throttler_tpu/ops/pallas_check.py:194",
        "launches": res["launches"],
        "tick_launches": tick["launches"],
        "dense_tick_launches": tick["dense_launches"],
        "grid_launches": grid["launches"]["check_dense"],
        "daemon_launches": daemon["launches"]["check_dense"],
        "shards_launches": shard_launches["check_dense"],
        "scenarios_launches": scenario_launches["check_dense"],
        "armed_launches": armed["launches"]["check_dense"],
        "props_launches": props["kernels"]["check_dense"]["launches"]["check_dense"],
        "props_examples": props["kernels"]["check_dense"]["examples"],
        "soak_launches": soak["launches"]["check_dense"],
        "deployed_launches": deployed_launches["check_dense"],
        "tools_launches": tools["launches"]["check_dense"],
        "max_abs_err": max_err,
        "mismatches": mismatches,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": None,
        "shape": [P, T, R],
        "kernel_only_ms": launch_ms,
        "bytes_ms": bound["bytes_ms"],
        "ops_ms": bound["ops_ms"],
        "dense_route_ms": route_ms,
        "sweep": {"shape": list(SWEEP_SHAPE), "ms": s_ms, "kernel_only_ms": s_launch_ms,
                  **s_bound},
        "variants": variants,
        "ptxas": ptxas_rows,
    }, {
        "name": "victim_select",
        "route": "cuda",
        "source": f"{PORT}/csrc/victim_select.cu",
        "replaces": "kube_throttler_tpu/ops/victim_select.py:44",
        "launches": preempt["launches"],
        "daemon_launches": daemon["scheduler_launches"]["victim_select"],
        "shards_launches": shard_launches["victim_select"],
        "scenarios_launches": scenario_launches["victim_select"],
        "armed_launches": armed["launches"]["victim_select"],
        "props_launches": props["kernels"]["victim_select"]["launches"]["victim_select"],
        "props_examples": props["kernels"]["victim_select"]["examples"],
        "deployed_launches": deployed_launches["victim_select"],
        "max_abs_err": max(victim_err, preempt["err"]),
        "mismatches": victim_bad + (not preempt["same"]),
        "ms": preempt["ms"],
        "plain_ms": preempt["plain_ms"],
        "bound_ms": preempt["bound"]["bound_ms"],
        "bound_by": preempt["bound"]["bound_by"],
        "library_ms": None,
        "shape": preempt["shape"],
        "kernel_only_ms": preempt["kernel_only_ms"],
        "geometry": preempt["geometry"],
        "rows_walked": preempt["bound"]["rows_walked"],
        "cells": victim_rows,
    }, {
        "name": "check_gather",
        "route": "cuda",
        "source": f"{PORT}/csrc/check_gather.cu",
        "replaces": "kube_throttler_tpu/ops/check.py:228",
        "launches": res["gather_launches"],
        "tick_launches": tick["gather_launches"],
        "grid_launches": grid["launches"]["check_gather"],
        "grid_pack_launches": grid["launches"]["pack_gather_rows"],
        "grid_rank_launches": [r["check_gather"] for r in grid["ranks"]["launches"]],
        "daemon_launches": daemon["launches"]["check_gather"],
        "shards_launches": shard_launches["check_gather"],
        "shards_pack_launches": shard_launches["pack_gather_rows"],
        "scenarios_launches": scenario_launches["check_gather"],
        "scenarios_pack_launches": scenario_launches["pack_gather_rows"],
        "armed_launches": armed["launches"]["check_gather"],
        "armed_pack_launches": armed["launches"]["pack_gather_rows"],
        "props_launches": props["kernels"]["check_gather"]["launches"]["check_gather"],
        "props_pack_launches": props["kernels"]["check_gather"]["launches"]["pack_gather_rows"],
        "props_examples": props["kernels"]["check_gather"]["examples"],
        "soak_launches": soak["launches"]["check_gather"],
        "soak_pack_launches": soak["launches"]["pack_gather_rows"],
        "deployed_launches": deployed_launches["check_gather"],
        "tools_launches": tools["launches"]["check_gather"],
        "deployed_pack_launches": deployed_launches["pack_gather_rows"],
        "pack_launches": res["pack_launches"],
        "tick_pack_launches": tick["pack_launches"],
        "coalesce_launches": coalesce,
        "max_abs_err": g_err,
        "mismatches": g_bad,
        "ms": tick["gather"]["ms"],
        "plain_ms": tick["gather"]["plain_ms"],
        "bound_ms": tick["gather"]["bound_ms"],
        "bound_by": tick["gather"]["bound_by"],
        "library_ms": None,
        "shape": tick["gather"]["shape"],
        "statuses_ms": tick["gather"]["statuses_ms"],
        "device_ms": tick["gather"]["device_ms"],
        "statuses_device_ms": tick["gather"]["statuses_device_ms"],
        "kernel_only_ms": tick["gather"]["kernel_only_ms"],
        "statuses_kernel_only_ms": tick["gather"]["statuses_kernel_only_ms"],
        "pack_ms": tick["gather"]["pack_ms"],
        "packed_bytes": tick["gather"]["packed_bytes"],
        "live_slots": tick["gather"]["live_slots"],
        "live_dims": tick["gather"]["live_dims"],
        "bytes_ms": tick["gather"]["bytes_ms"],
        "ops_ms": tick["gather"]["ops_ms"],
        "full_update_step_gather_ms": tick["gather"]["step_ms"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main() -> int:
    if not (HERE / PORT / "__init__.py").is_file():
        print(f"chip_smoke: no {PORT}/ beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the card",
              file=sys.stderr)
        return 2
    try:
        if sys.argv[1:2] == ["--scenario-child"]:
            return scenario_child(*sys.argv[2:4])
        if sys.argv[1:2] == ["--grid-rank"]:
            return grid_rank_child(*sys.argv[2:9])
        if sys.argv[1:2] == ["--armed-child"]:
            return armed_child(*map(int, sys.argv[2:6]))
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
