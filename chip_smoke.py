#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kube_throttler_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port's main path from ``csrc/`` (into
the ignored ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card, drives the main path —
``KubeThrottler.pre_filter_batch`` over 100,000 bound pods, 10,000
Throttles and 8 ClusterThrottles — and checks its verdicts against the
host oracle. One line per phase; then one ``{"kernels": [...]}`` JSON
line, the card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent or when the
script is not inside a checkout of the repository; exits non-zero on any
build failure, launch failure, mismatch or main-path check that fails.
Everything runs in this one process (plus ``nvidia-smi`` and ``nvcc``).
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PORT = "kube_throttler_tpu_torch"

SEED = 0
# the served stack of the repository's bench (100k pods × 10k Throttles in
# 500 label groups) plus 8 ClusterThrottles, each selecting every 8th group
N_PODS, N_THROTTLES, GROUPS, N_CLUSTER = 100_000, 10_000, 500, 8
N_CALLS = 5
ORACLE_SAMPLE = 2_000
# kernel-vs-plain shapes (P, T, R): ragged, the main path's dense shape, wide
COMPARE_SHAPES = ((37, 19, 3), (131072, 16, 8), (8192, 10240, 8))
# the bench's dense-sweep shape (bench.py bench_pallas_sweep), timed only
SWEEP_SHAPE = (131072, 10240, 8)
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


# --------------------------------------------------------------- measures


def compare(pre, pods, mask, on_equal: bool, step3: bool):
    """(mismatching cells, max |kernel - plain|, per-status counts) of the
    kernel against its plain version on the same device tensors."""
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd

    got = cd.check_dense(pre, pods, mask, on_equal=on_equal, step3_on_equal=step3)
    want = cd.check_dense_reference(pre, pods, mask, on_equal, step3)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    counts = torch.bincount((want.flatten().to(torch.int64) + 1), minlength=5).tolist()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0, counts


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


def kernel_only_ms(lib, pre, pods, mask, on_equal, step3, iters, flush_bytes=0) -> float:
    """Device time of the bare ``kt_check_dense`` launch, its variant
    planes prepared once outside the timed region (the wrapper's torch
    prep ops are what ``check_dense`` adds on top)."""
    import torch

    from kube_throttler_tpu_torch.ops import check_dense as cd

    out = torch.empty(mask.shape, dtype=torch.int8, device=mask.device)
    planes, args = cd.kernel_args(pre, pods, mask, out, on_equal, step3)
    check(lib.kt_check_dense(*args) == 0, "bare kt_check_dense launch failed")
    ms = cuda_ms(lambda: lib.kt_check_dense(*args), iters, flush_bytes)
    del planes
    return ms


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


# --------------------------------------------------------------- main path


def build_cluster(device, n_pods, n_throttles, groups, n_cluster, seed):
    """The served stack, from the port alone: store → device mirror →
    controllers. Throttle i selects label group ``g{i % groups}``; its
    threshold blocks every 5th (cpu) or 7th (pod count) group in its last
    two tiers and is roomy otherwise. ClusterThrottle j selects the groups
    ≡ j (mod n_cluster) and takes one of four threshold shapes so all four
    statuses occur: cpu 300m (exceeds / active), roomy (not-throttled),
    used + 300m cpu (insufficient / not-throttled), and a pod count below
    its pod count (active)."""
    from dataclasses import replace

    from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
    from kube_throttler_tpu_torch.api.types import (
        ClusterThrottle, ClusterThrottleSelector, ClusterThrottleSelectorTerm,
        ClusterThrottleSpec, LabelSelector, ResourceAmount, Throttle,
        ThrottleSelector, ThrottleSelectorTerm, ThrottleSpec,
    )
    from kube_throttler_tpu_torch.engine.store import Store
    from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

    rng = random.Random(seed)
    pod_plan = [(rng.randrange(groups), rng.randrange(1, 8) * 100) for _ in range(n_pods)]
    cl_cpu = [0] * n_cluster
    cl_cnt = [0] * n_cluster
    for g, cpu in pod_plan:
        cl_cpu[g % n_cluster] += cpu
        cl_cnt[g % n_cluster] += 1

    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args({"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}),
        store, use_device=True, device=device,
    )
    store.create_namespace(Namespace("default"))
    roomy = ResourceAmount.of(pod=10**6, requests={"cpu": "100000"})
    tiers = max(n_throttles // groups, 1)
    for i in range(n_throttles):
        g, tier = i % groups, i // groups
        if tier == tiers - 1 and g % 5 == 0:
            threshold = ResourceAmount.of(requests={"cpu": "10"})
        elif tier == tiers - 2 and g % 7 == 0:
            threshold = ResourceAmount.of(pod=50)
        else:
            threshold = roomy
        store.create_throttle(Throttle(
            name=f"t{i}",
            spec=ThrottleSpec(
                throttler_name="kube-throttler", threshold=threshold,
                selector=ThrottleSelector(selector_terms=(
                    ThrottleSelectorTerm(LabelSelector(match_labels={"grp": f"g{g}"})),
                )),
            ),
        ))
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
        store.create_cluster_throttle(ClusterThrottle(
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
    chunk = []
    for i, (g, cpu) in enumerate(pod_plan):
        pod = make_pod(
            f"p{i}", labels={"grp": f"g{g}", "mod": f"m{g % n_cluster}"},
            requests={"cpu": f"{cpu}m"}, node_name="node-1", phase="Running",
        )
        chunk.append(("create", "Pod", pod))
        if len(chunk) == 10_000 or i == n_pods - 1:
            for res in store.apply_events(chunk):
                if isinstance(res, Exception):
                    raise res
            chunk = []
    return plugin


def drive_main_path(plugin, calls: int, sample: int, seed: int):
    """run_pending_once, prewarm, then ``calls`` × pre_filter_batch with
    the kernel launch count zeroed just before and read just after."""
    from kube_throttler_tpu_torch.ops import check_dense as cd
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
        snap = plugin.tracer.snapshot(phase)
        return (snap["sum"], snap["count"]) if snap else (0.0, 0)

    per_call, routes, out = [], [], None
    cd.launches = 0
    for _ in range(calls):
        d0, m0, l0 = split("batch_dispatch"), split("batch_merge"), cd.launches
        x0 = split("batch_dedupe")
        t0 = time.perf_counter()
        out = plugin.pre_filter_batch()
        dt = time.perf_counter() - t0
        d1, m1, x1 = split("batch_dispatch"), split("batch_merge"), split("batch_dedupe")
        per_call.append((dt, d1[0] - d0[0], m1[0] - m0[0], d1[1] - d0[1],
                         cd.launches - l0, x1[0] - x0[0]))
        routes.append(dict(dm.last_batch_routes))
    launches = cd.launches

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
    shapes = {
        kind: {"pods": ks.pcap, "throttles": ks.tcap, "dims": ks.R, "cols_K": ks._cols_K}
        for kind, ks in (("throttle", dm.throttle), ("clusterthrottle", dm.clusterthrottle))
    }
    return dict(
        shapes=shapes, per_call=per_call, routes=routes, launches=launches,
        breaker=dm.breaker_state(), n_verdicts=len(out["schedulable"]),
        errors=len(out["errors"]), oracle_n=len(probe), oracle_mismatches=mismatches,
        tally=tally, cluster_tally=cl_tally,
    )


# --------------------------------------------------------------- phases


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
    from kube_throttler_tpu_torch.ops.fastcheck import precompute_check_state
    from kube_throttler_tpu_torch.ops.schema import (
        pod_batch_from_arrays,
        throttle_state_from_arrays,
    )

    card = card_line()
    say("card", nvidia_smi=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], devices=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = cd.load_library()
    say("build", kernel="check_dense", seconds=f"{time.perf_counter() - t0:.2f}", library=lib._name)

    # -- kernel against its plain version, both kinds × both on_equal
    max_err = mismatches = 0
    rng = np.random.default_rng(SEED)
    cases = [("extremes", extremes_inputs("cuda"))]
    for P, T, R in COMPARE_SHAPES:
        cases.append((f"{P}x{T}x{R}", device_inputs(*synth_arrays(rng, P, T, R), "cuda")))
    for label, (pre, pods, mask) in cases:
        for kind in ("throttle", "clusterthrottle"):
            for on_equal in (False, True):
                step3 = True if kind == "throttle" else on_equal
                bad, err, counts = compare(pre, pods, mask, on_equal, step3)
                max_err, mismatches = max(max_err, err), mismatches + bad
                say("compare", shape=label, kind=kind, on_equal=on_equal,
                    mismatches=bad, status_counts=counts)
                check(bad == 0, f"check_dense disagrees with its plain version at {label}")
    del cases

    # -- the full-width main path
    t0 = time.perf_counter()
    plugin = build_cluster("cuda", N_PODS, N_THROTTLES, GROUPS, N_CLUSTER, SEED)
    say("setup", pods=N_PODS, throttles=N_THROTTLES, groups=GROUPS,
        clusterthrottles=N_CLUSTER, seconds=f"{time.perf_counter() - t0:.1f}")
    try:
        res = drive_main_path(plugin, N_CALLS, ORACLE_SAMPLE, SEED)
        for i, (dt, disp, merge, nd, nl, dedupe) in enumerate(res["per_call"]):
            say("pre_filter_batch", call=i, ms=f"{dt * 1e3:.3f}",
                batch_dedupe_ms=f"{dedupe * 1e3:.3f}",
                batch_dispatch_ms=f"{disp * 1e3:.3f}", batch_merge_ms=f"{merge * 1e3:.3f}",
                check_dense_launches=nl, routes=json.dumps(res["routes"][i], sort_keys=True))
            check(nd == 1, "pre_filter_batch did not take the device batch path")
            check(nl >= 1, f"check_dense was not launched in call {i}")
        say("main-path-checks", shapes=json.dumps(res["shapes"], sort_keys=True),
            check_dense_launches=res["launches"], breaker=res["breaker"],
            verdicts=res["n_verdicts"], errors=res["errors"],
            oracle_sample=res["oracle_n"], oracle_mismatches=res["oracle_mismatches"],
            tally=json.dumps(res["tally"]), clusterthrottle_tally=json.dumps(res["cluster_tally"]))
        for r in res["routes"]:
            check(r == {"throttle": "sparse", "clusterthrottle": "dense"},
                  f"unexpected batch routes {r}")
        check(res["launches"] >= N_CALLS, "check_dense was not launched on every call")
        check(res["breaker"] == "closed", f"breaker is {res['breaker']}")
        check(res["n_verdicts"] == N_PODS and res["errors"] == 0, "verdicts missing")
        check(res["oracle_n"] >= 2000 and res["oracle_mismatches"] == 0,
              "batch verdicts disagree with the host oracle")
        check(all(res["cluster_tally"][k] > 0 for k in res["cluster_tally"]),
              "the ClusterThrottle kind did not produce all four outcomes")

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
    finally:
        plugin.stop()
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

    kernels = {"kernels": [{
        "name": "check_dense",
        "route": "cuda",
        "source": f"{PORT}/csrc/check_dense.cu",
        "replaces": "kube_throttler_tpu/ops/pallas_check.py:194",
        "launches": res["launches"],
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
        "sweep": {"shape": list(SWEEP_SHAPE), "ms": s_ms, "kernel_only_ms": s_launch_ms,
                  **s_bound},
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
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
