"""Port parity: the fused reconcile + PreFilter tick of the port
(``device="cpu"``) ≡ the JAX package's.

- ``full_update_step`` (dense) and ``full_update_step_gather`` (sparse) ≡
  the JAX functions on the same seeded inputs, for every (on_equal,
  step3_on_equal) pair.
- ``DeviceStateManager.full_tick_sharded`` on the port's 1×1 grid ≡ the JAX
  tick on a 1×1 mesh and on the 8-device (4, 2) mesh of the test conftest,
  on one store built from the same manifests by each package, with the
  sparse route and with ``dense_mesh=True``; and ``KubeThrottler``'s dict ≡
  the JAX plugin's.
- On a static store the tick ≡ ``check_batch_all`` and its ``used`` ≡ the
  written ``status.used``; an active override is resolved; a tick racing
  store churn reads one coherent snapshot; the snapshot's device handles
  are never written after the lock is released.
- A grid whose shape, slots or capacities do not fit raises,
  ``device=None`` raises without CUDA, and a kernel fault reaches the
  caller. (The grids larger than 1×1 are held in
  ``tests/test_torch_sharded_tick.py``.)
"""

import random
import threading
from dataclasses import replace
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import kube_throttler_tpu.ops.overrides as jov
import kube_throttler_tpu.ops.schema as jschema
import kube_throttler_tpu.parallel.sharded as jsharded
import kube_throttler_tpu_torch.api.types as ttypes
import kube_throttler_tpu_torch.engine.store as tstore
import kube_throttler_tpu_torch.ops.overrides as tov
import kube_throttler_tpu_torch.ops.schema as tschema
import kube_throttler_tpu_torch.parallel.sharded as tsharded
import kube_throttler_tpu_torch.plugin as tplugin
from kube_throttler_tpu.parallel import make_mesh as jmake_mesh
from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.parallel import Grid, make_mesh
from tests.test_torch_ops import _assert_same
from tests.test_torch_overrides import NOW, both, plan_specs
from tests.test_torch_prefilter_batch import T0, _stacks

CPU = "cpu"
VARIANTS = [(False, True), (True, True), (False, False), (True, False)]
KINDS = ("throttle", "clusterthrottle")


def grid():
    return make_mesh(1, (1, 1), device=CPU)


# ------------------------------------------------------------ step parity


def step_inputs(seed, P=40, T=24, R=None):
    """Seeded inputs of one step in both packages' forms: (JAX args, port
    args, mask, cols), the schedule from ``plan_specs``."""
    js, ts = both(plan_specs(seed=seed, n=T, max_overrides=3))
    R = R or ts.spec_req.shape[1]
    rng = np.random.default_rng(seed)
    pods = dict(
        valid=rng.random(P) < 0.9,
        req=rng.integers(0, 120, (P, R)) * np.where(np.arange(R) % 2, 2**30, 1),
        req_present=rng.random((P, R)) < 0.7,
    )
    mask = rng.random((P, T)) < 0.15
    mask[:, T - 3:] = False  # unoccupied columns
    counted = (rng.random(P) < 0.7) & pods["valid"]  # as the device mirror keeps it
    res = (
        rng.integers(0, 3, T), rng.random(T) < 0.3,
        rng.integers(0, 300, (T, R)), rng.random((T, R)) < 0.3,
    )
    thr_valid = mask.any(axis=0) | (rng.random(T) < 0.5)
    K = max(int(mask.sum(1).max()), 1) + 2
    cols = np.full((P, K), -1, dtype=np.int32)
    for p in range(P):
        hit = np.flatnonzero(mask[p])
        cols[p, : hit.size] = hit
    now = int(jov._datetime_to_ns(NOW + timedelta(minutes=int(rng.integers(-60, 60)))))
    jargs = (js, jschema.PodBatch(**pods), counted, *res, thr_valid, np.int64(now))
    targs = (
        ts, tschema.pod_batch_from_arrays(pods, device=CPU), torch.from_numpy(counted),
        *(torch.from_numpy(np.array(a)) for a in res), torch.from_numpy(thr_valid),
        torch.tensor(now, dtype=torch.int64),
    )
    return jargs, targs, mask, cols


def _insert(args, x):
    """Step args with the mask or cols in third place."""
    return (*args[:2], x, *args[2:])


NAMES = ("counts", "schedulable", "used_cnt", "used_req", "st_cnt", "st_req")


@pytest.mark.parametrize("on_equal,step3", VARIANTS)
def test_full_update_step_matches_jax(on_equal, step3):
    jargs, targs, mask, _ = step_inputs(4)
    want = jsharded.full_update_step(*_insert(jargs, mask), on_equal=on_equal,
                                     step3_on_equal=step3)
    got = tsharded.full_update_step(*_insert(targs, torch.from_numpy(mask)),
                                    on_equal=on_equal, step3_on_equal=step3)
    for name, g, w in zip(NAMES, got, want):
        _assert_same(g, w, name)
    assert (np.asarray(want[0]).sum(0) > 0).all(), "expected all 4 classes"


@pytest.mark.parametrize("on_equal,step3", VARIANTS)
def test_full_update_step_gather_matches_jax(on_equal, step3):
    jargs, targs, mask, cols = step_inputs(8)
    want = jsharded.full_update_step_gather(*_insert(jargs, cols), on_equal=on_equal,
                                            step3_on_equal=step3)
    got = tsharded.full_update_step_gather(*_insert(targs, torch.from_numpy(cols)),
                                           on_equal=on_equal, step3_on_equal=step3)
    for name, g, w in zip(NAMES, got, want):
        _assert_same(g, w, name)
    assert (np.asarray(want[0]).sum(0) > 0).all(), "expected all 4 classes"
    # the sparse and the dense form of the port agree on the same matches
    dense = tsharded.full_update_step(*_insert(targs, torch.from_numpy(mask)),
                                      on_equal=on_equal, step3_on_equal=step3)
    for name, g, d in zip(NAMES, got, dense):
        assert torch.equal(g, d), name


def test_used_from_cols_drops_every_slot_that_does_not_count():
    """Pads (-1), ids at or past T and uncounted or invalid pods add
    nothing; repeated slots of one pod each add (as the JAX scatter does)."""
    T = 6
    cols = torch.tensor([[0, 2, -1, 6], [2, 2, 9, -1], [1, -1, -1, -1], [3, 4, 5, 0]],
                        dtype=torch.int32)
    pods = tschema.pod_batch_from_arrays(dict(
        valid=np.array([True, True, True, False]),
        req=np.array([[5, 2**50], [7, 1], [11, 0], [13, 13]], dtype=np.int64),
        req_present=np.array([[True, True], [True, False], [True, True], [True, True]]),
    ), device=CPU)
    counted = torch.tensor([True, True, False, True])
    cnt, req, ctb = tsharded.used_from_cols(pods, cols, counted, T)
    assert cnt.tolist() == [1, 0, 3, 0, 0, 0]
    assert req.tolist() == [[5, 2**50], [0, 0], [5 + 7 + 7, 2**50 + 2], [0, 0], [0, 0], [0, 0]]
    assert ctb.tolist() == [[1, 1], [0, 0], [3, 1], [0, 0], [0, 0], [0, 0]]
    assert (cnt.dtype, req.dtype, ctb.dtype) == (torch.int64, torch.int64, torch.int32)


@pytest.mark.parametrize("cells", [1, 50, 10**9])
def test_compact_in_row_blocks_matches_one_block(monkeypatch, cells):
    """``statuses_to_compact`` bounds its int32 temporaries by compacting
    blocks of rows; any block size gives the one-block result and JAX's."""
    from kube_throttler_tpu.ops.check import statuses_to_compact as jcompact
    from kube_throttler_tpu_torch.ops import classify

    statuses = np.random.default_rng(9).integers(-1, 4, (37, 11)).astype(np.int8)
    want = jcompact(statuses)
    monkeypatch.setattr(classify, "_COMPACT_CHUNK_CELLS", cells)
    got = classify.statuses_to_compact(torch.from_numpy(statuses))
    for name, g, w in zip(("counts", "schedulable"), got, want):
        _assert_same(g, w, name)


# ------------------------------------------------------------ the tick


def _assert_tick_same(got, want, label):
    assert set(got) == set(want) == set(KINDS)
    for kind in KINDS:
        g, w = got[kind], want[kind]
        assert g[2] == w[2], f"{label} {kind} row_map"
        assert g[5] == w[5], f"{label} {kind} col_map"
        for name, i in (("counts", 0), ("schedulable", 1), ("used_cnt", 3), ("used_req", 4)):
            a, b = g[i], np.asarray(w[i])
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (label, kind, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {kind} {name}")


@pytest.mark.parametrize("on_equal", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_tick_matches_jax_on_one_and_eight_devices(monkeypatch, dense, on_equal):
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    ref, port = _stacks()
    got = port.device_manager.full_tick_sharded(grid(), on_equal=on_equal, now=T0,
                                                dense_mesh=dense)
    routes = {kind: "dense" if dense or kind == "clusterthrottle" else "sparse"
              for kind in KINDS}
    assert {k: v["route"] for k, v in port.device_manager.last_tick.items()} == routes
    assert port.device_manager.last_tick["throttle"]["overrides"] >= 1
    for shape in ((1, 1), (4, 2)):
        want = ref.device_manager.full_tick_sharded(
            jmake_mesh(shape[0] * shape[1], shape), on_equal=on_equal, now=T0,
            dense_mesh=dense,
        )
        _assert_tick_same(got, want, f"mesh {shape}")
    counts = got["throttle"][0][sorted(got["throttle"][2].values())]
    assert (counts.sum(axis=0)[:3] > 0).all(), "expected not-throttled, active, insufficient"


def test_plugin_tick_matches_jax(monkeypatch):
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    ref, port = _stacks()
    got = port.full_tick_sharded()
    want = ref.full_tick_sharded(1, (1, 1))
    assert got == want
    assert got["mesh"] == [1, 1] and got["errors"] == []
    assert set(got["schedulable"].values()) == {True, False}
    assert port.full_tick_sharded(1, [1, 1]) == got
    assert port.tracer.snapshot("full_tick")["count"] == 2
    for phase in ("tick_snapshot", "tick_encode", "tick_device"):
        assert port.tracer.snapshot(phase)["count"] >= 2, phase


# ------------------------------------------------------------ port stores


def port_stack():
    store = tstore.Store()
    plugin = tplugin.KubeThrottler(
        tplugin.decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store, use_device=True, start_workers=False, device=CPU,
    )
    store.create_namespace(Namespace("default"))
    return store, plugin


def throttle(name, group, pod_cap=None, cpu=None, overrides=()):
    return ttypes.Throttle(
        name=name,
        spec=ttypes.ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=ttypes.ResourceAmount.of(
                pod=pod_cap, requests={"cpu": cpu} if cpu else None
            ),
            temporary_threshold_overrides=overrides,
            selector=ttypes.ThrottleSelector(selector_terms=(
                ttypes.ThrottleSelectorTerm(
                    pod_selector=ttypes.LabelSelector(match_labels={"grp": group})
                ),
            )),
        ),
    )


def add_pod(store, name, rng, groups=8, running=True):
    store.create_pod(make_pod(
        name, labels={"grp": f"g{rng.randrange(groups)}"},
        requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
        node_name="node-1" if running else "", phase="Running" if running else "Pending",
    ))


def populate(store, rng, n_thr=24, n_pods=96, groups=8):
    """Wide-open, tight-cpu and pod-count Throttles over ``groups`` label
    groups, running pods, and one guaranteed 'insufficient' cell (used 800m
    of 1000m, plus a pending 300m pod)."""
    for i in range(n_thr):
        g = f"g{i % groups}"
        if i % 3 == 0:
            store.create_throttle(throttle(f"t{i}", g, cpu="100"))
        elif i % 3 == 1:
            store.create_throttle(throttle(f"t{i}", g, cpu=f"{i % 5 + 1}00m"))
        else:
            store.create_throttle(throttle(f"t{i}", g, pod_cap=i % 7 + 1))
    for i in range(n_pods):
        add_pod(store, f"p{i}", rng, groups)
    store.create_throttle(throttle("t-ins", "gins", cpu="1000m"))
    store.create_pod(make_pod("p-ins-run", labels={"grp": "gins"}, requests={"cpu": "800m"},
                              node_name="node-1", phase="Running"))
    store.create_pod(make_pod("p-ins-pending", labels={"grp": "gins"},
                              requests={"cpu": "300m"}))


@pytest.mark.parametrize("dense", [False, True])
def test_tick_matches_written_statuses_on_static_store(dense):
    store, plugin = port_stack()
    populate(store, random.Random(0), n_thr=96, n_pods=200)
    plugin.run_pending_once()  # statuses converge
    dm = plugin.device_manager
    tick = dm.full_tick_sharded(grid(), on_equal=False, dense_mesh=dense)
    written = dm.check_batch_all(False)
    assert dm.last_tick["throttle"]["route"] == ("dense" if dense else "sparse")
    for kind in KINDS:
        counts_t, ok_t, rows_t, used_cnt, used_req, col_map = tick[kind]
        counts_d, ok_d, rows_d = written[kind]
        assert rows_t == rows_d
        rows = sorted(rows_t.values())
        np.testing.assert_array_equal(counts_t[rows], counts_d.numpy()[rows])
        np.testing.assert_array_equal(ok_t[rows], ok_d.numpy()[rows])
        for col, key in col_map.items():
            ns, _, name = key.partition("/")
            thr = store.get_throttle(ns, name)
            assert int(used_cnt[col]) == (thr.status.used.resource_counts or 0), key
    counts = tick["throttle"][0][sorted(tick["throttle"][2].values())]
    assert (counts.sum(axis=0) > 0).all(), "expected all 4 classes"
    plugin.stop()


def rfc(dt):
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def test_active_override_resolved_at_a_fixed_now():
    """Spec cpu=100m would throttle the 200m pod; an override active at
    ``now`` lifts it to 10 CPUs. With the window moved into the past the
    same pod is blocked."""
    store, plugin = port_stack()
    now = datetime(2026, 6, 1, 12, tzinfo=timezone.utc)
    ov = ttypes.TemporaryThresholdOverride(
        begin=rfc(now - timedelta(hours=1)), end=rfc(now + timedelta(hours=1)),
        threshold=ttypes.ResourceAmount.of(requests={"cpu": "10"}),
    )
    store.create_throttle(throttle("t0", "g0", cpu="100m", overrides=(ov,)))
    store.create_pod(make_pod("p-running", labels={"grp": "g0"}, requests={"cpu": "200m"},
                              node_name="node-1", phase="Running"))
    store.create_pod(make_pod("p-pending", labels={"grp": "g0"}, requests={"cpu": "200m"}))
    plugin.run_pending_once()
    dm = plugin.device_manager
    _, ok, rows, used_cnt, _, col_map = dm.full_tick_sharded(grid(), now=now)["throttle"]
    assert bool(ok[rows["default/p-pending"]])
    (col,) = [c for c, k in col_map.items() if k == "default/t0"]
    assert int(used_cnt[col]) == 1  # only the Running pod counts
    # at the window's end (inclusive) the override still holds; 1 s later not
    end = now + timedelta(hours=1)
    assert bool(dm.full_tick_sharded(grid(), now=end)["throttle"][1][rows["default/p-pending"]])
    late = dm.full_tick_sharded(grid(), now=end + timedelta(seconds=1))["throttle"]
    assert not bool(late[1][rows["default/p-pending"]])

    past = replace(ov, begin=rfc(now - timedelta(hours=3)), end=rfc(now - timedelta(hours=2)))
    cur = store.get_throttle("default", "t0")
    store.update_throttle(
        replace(cur, spec=replace(cur.spec, temporary_threshold_overrides=(past,)))
    )
    plugin.run_pending_once()
    _, ok, rows, *_ = dm.full_tick_sharded(grid(), now=now)["throttle"]
    assert not bool(ok[rows["default/p-pending"]])
    plugin.stop()


def test_tick_races_live_churn():
    """Ticks run while another thread creates and deletes pods: no tick
    fails, and every verdict map covers the never-deleted pods with one
    row per pod (a torn snapshot could alias rows)."""
    store, plugin = port_stack()
    rng = random.Random(3)
    populate(store, rng, n_thr=12, n_pods=40)
    plugin.run_pending_once()
    dm = plugin.device_manager
    dm.full_tick_sharded(grid())
    stable = {p.key for p in store.list_pods()}  # never deleted below
    errors, results = [], []
    started = threading.Event()

    def churner():
        started.wait(10)
        try:
            for i in range(300):
                add_pod(store, f"churn{i}", rng)
                if i % 3 == 0 and i:
                    store.delete_pod("default", f"churn{i - 1}")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=churner)
    t.start()
    try:
        started.set()
        while t.is_alive() or len(results) < 3:
            results.append(dm.full_tick_sharded(grid()))
            if len(results) > 50:
                break
    finally:
        t.join(60)
    assert not t.is_alive() and not errors, errors
    assert len(results) >= 3
    for out in results:
        for kind in KINDS:
            _, ok, rows, *_ = out[kind]
            assert stable <= set(rows), "tick lost stable pods"
            vals = list(rows.values())
            assert max(vals) < len(ok)
            assert len(set(vals)) == len(vals), "aliased rows"
    plugin.stop()


def test_snapshot_handles_are_not_written_after_the_lock():
    """ROADMAP hazard (d): the tick's device handles, grabbed under the
    lock, stay unchanged while a writer thread updates the rows they
    cover (copy-on-write)."""
    store, plugin = port_stack()
    rng = random.Random(4)
    populate(store, rng, n_thr=96, n_pods=200)
    plugin.run_pending_once()
    dm = plugin.device_manager
    with dm._lock:
        snap = dm._tick_snapshot_locked(dm.throttle, dense_mesh=False)
    assert snap["cols"] is not None
    handles = {k: snap[k] for k in ("cols", "counted")}
    handles.update(req=snap["pods"].req, valid=snap["pods"].valid)
    before = {k: v.clone() for k, v in handles.items()}

    def writer():
        for i in range(60):
            pod = store.get_pod("default", f"p{i}")
            store.update_pod(replace(pod, labels={"grp": "g7"}))
            store.delete_pod("default", f"p{i + 100}")
            add_pod(store, f"new{i}", rng)

    t = threading.Thread(target=writer)
    t.start()
    t.join(60)
    assert not t.is_alive()
    with dm._lock:
        fresh = dm._tick_snapshot_locked(dm.throttle, dense_mesh=False)
    assert not torch.equal(fresh["cols"], before["cols"])  # the rows did change
    for k, v in handles.items():
        assert torch.equal(v, before[k]), k
    plugin.stop()


# ------------------------------------------------------------ refusals


def test_grid_larger_than_one_device_raises(monkeypatch):
    """The refusals that remain for a grid: a shape that does not match
    its slot count, more slots than visible cards, a slot on another
    device type than the manager's, a grid over several processes, and
    capacities the shape does not divide. Each raises ``ValueError`` and
    runs nothing."""
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(4, (4, 2), device=CPU)
    with pytest.raises(ValueError, match="requested 4 devices but only 2 are visible"):
        make_mesh(4, devices=[CPU, CPU])
    store, plugin = port_stack()
    populate(store, random.Random(7), n_thr=12, n_pods=40)
    plugin.run_pending_once()
    dm = plugin.device_manager
    with pytest.raises(ValueError, match="needs 8 devices"):
        plugin.full_tick_sharded(4, (4, 2))
    with pytest.raises(ValueError, match="not the manager's device type"):
        dm.full_tick_sharded(make_mesh(2, devices=[CPU, "meta"]))
    with pytest.raises(ValueError, match="runs in one process"):
        dm.full_tick_sharded(Grid(grid().devices, world=2, rank=1))
    with pytest.raises(ValueError, match="must divide padded capacities"):
        dm.full_tick_sharded(make_mesh(3, (3, 1), device=CPU))
    assert dm.last_tick == {}, "a refused tick ran"
    plugin.stop()
    # on CUDA the slots are cards: more than are visible is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 4 devices but only 1 are visible"):
        make_mesh(4, (2, 2), device="cuda")
    assert make_mesh(device="cuda").devices == ((torch.device("cuda", 0),),)


def test_grid_needs_an_explicit_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    assert make_mesh(device=CPU).shape == {"pods": 1, "throttles": 1}


@pytest.mark.parametrize("failure", ["kernel_launch", "device_outage"])
def test_tick_failures_reach_the_caller(monkeypatch, failure):
    """No fallback: a kernel that does not launch, or any other device
    failure, raises out of the tick; nothing is served from the host and
    the breaker stays closed."""
    from kube_throttler_tpu_torch.ops import check_dense as cd

    store, plugin = port_stack()
    populate(store, random.Random(6), n_thr=12, n_pods=40)
    plugin.run_pending_once()
    exc = (cd.KernelLaunchError("check_dense kernel launch failed: cudaError 9")
           if failure == "kernel_launch" else RuntimeError("device lost"))

    def failing(*args, **kwargs):
        raise exc

    monkeypatch.setattr(cd, "check_dense", failing)
    with pytest.raises(type(exc), match=str(exc)):
        plugin.full_tick_sharded()
    assert plugin.device_manager.breaker_state() == "closed"
    plugin.stop()
