"""Port copy of ``tests/test_sharded_tick.py``: the LIVE multi-device
serving path — ``DeviceStateManager.full_tick_sharded`` /
``plugin.full_tick_sharded`` / ``POST /v1/tick`` — on the port's (4, 2)
grid of CPU slots, every plugin on ``device="cpu"``.

On a static (fully reconciled) store the fused tick's classification must
agree cell-for-cell with the written-status check (check_batch_all), and
its recomputed ``used`` must equal the written ``status.used``. Beside the
copy: the port's grid ticks ≡ the JAX package's on the same mesh shape, on
one store built from the same manifests by each package, sparse and
``dense_mesh=True``; and the sparse grid step with cols at or past T ≡ the
JAX package's 4 × 2 ``shard_map`` step, where such a col is a pad; a
kernel fault on one tile reaches the caller.
"""

import random
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from kube_throttler_tpu_torch.api.pod import Namespace, make_pod
from kube_throttler_tpu_torch.api.types import (
    LabelSelector,
    ResourceAmount,
    TemporaryThresholdOverride,
    Throttle,
    ThrottleSelector,
    ThrottleSelectorTerm,
    ThrottleSpec,
)
from kube_throttler_tpu_torch.engine.store import Store
from kube_throttler_tpu_torch.parallel import make_mesh
from kube_throttler_tpu_torch.plugin import KubeThrottler, decode_plugin_args

CPU = "cpu"


def rfc(dt):
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


def _throttle(name, groups=8, i=0, pod_cap=None, cpu=None, overrides=()):
    threshold = ResourceAmount.of(
        pod=pod_cap, requests={"cpu": cpu} if cpu else None
    )
    return Throttle(
        name=name,
        spec=ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=threshold,
            temporary_threshold_overrides=overrides,
            selector=ThrottleSelector(
                selector_terms=(
                    ThrottleSelectorTerm(
                        pod_selector=LabelSelector(
                            match_labels={"grp": f"g{i % groups}"}
                        )
                    ),
                )
            ),
        ),
    )


@pytest.fixture()
def stack():
    store = Store()
    plugin = KubeThrottler(
        decode_plugin_args(
            {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
        ),
        store,
        use_device=True,
        start_workers=False,
        device=CPU,
    )
    store.create_namespace(Namespace("default"))
    return store, plugin


def _populate(store, rng, n_thr=24, n_pods=96, groups=8):
    for i in range(n_thr):
        kind = i % 3
        if kind == 0:
            thr = _throttle(f"t{i}", groups, i, cpu="100")  # wide open
        elif kind == 1:
            thr = _throttle(f"t{i}", groups, i, cpu=f"{(i % 5 + 1)}00m")  # tight
        else:
            thr = _throttle(f"t{i}", groups, i, pod_cap=(i % 7) + 1)
        store.create_throttle(thr)
    for i in range(n_pods):
        store.create_pod(
            make_pod(
                f"p{i}",
                labels={"grp": f"g{rng.randrange(groups)}"},
                requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
                node_name="node-1",
                phase="Running",
            )
        )
    # a guaranteed 'insufficient' cell on a dedicated group: used 800m of
    # 1000m, plus a pending 300m pod (alone ≤ threshold, used+pod over it)
    ins = _throttle("t-ins", 1, 0, cpu="1000m")
    ins_sel = ThrottleSelector(
        selector_terms=(
            ThrottleSelectorTerm(
                pod_selector=LabelSelector(match_labels={"grp": "gins"})
            ),
        )
    )
    from dataclasses import replace as _replace

    store.create_throttle(_replace(ins, spec=_replace(ins.spec, selector=ins_sel)))
    store.create_pod(
        make_pod(
            "p-ins-run",
            labels={"grp": "gins"},
            requests={"cpu": "800m"},
            node_name="node-1",
            phase="Running",
        )
    )
    store.create_pod(
        make_pod("p-ins-pending", labels={"grp": "gins"}, requests={"cpu": "300m"})
    )


class TestFullTickSharded:
    def test_matches_dense_check_on_static_store(self, stack):
        store, plugin = stack
        _populate(store, random.Random(0))
        plugin.run_pending_once()  # statuses converge (single-threaded)

        mesh = make_mesh(8, (4, 2), device=CPU)
        tick = plugin.device_manager.full_tick_sharded(mesh, on_equal=False)
        dense = plugin.device_manager.check_batch_all(False)

        for kind in ("throttle", "clusterthrottle"):
            counts_t, ok_t, rows_t, used_cnt, used_req, col_map = tick[kind]
            counts_d, ok_d, rows_d = dense[kind]
            assert rows_t == rows_d
            rows = sorted(rows_t.values())
            np.testing.assert_array_equal(
                np.asarray(counts_t)[rows], np.asarray(counts_d)[rows]
            )
            np.testing.assert_array_equal(
                np.asarray(ok_t)[rows], np.asarray(ok_d)[rows]
            )
            # recomputed used == written status.used
            for col, key in col_map.items():
                ns, _, name = key.partition("/")
                thr = store.get_throttle(ns, name)
                want = thr.status.used.resource_counts or 0
                assert int(used_cnt[col]) == want, key

        # the scenario must be non-degenerate: all verdict classes appear
        counts = np.asarray(tick["throttle"][0])
        rows = sorted(tick["throttle"][2].values())
        assert (counts[rows].sum(axis=0) > 0).all(), "expected all 4 classes"

    def test_single_device_mesh(self, stack):
        store, plugin = stack
        _populate(store, random.Random(1), n_thr=8, n_pods=24)
        plugin.run_pending_once()
        tick = plugin.device_manager.full_tick_sharded(make_mesh(1, (1, 1), device=CPU))
        dense = plugin.device_manager.check_batch_all(False)
        for kind in ("throttle", "clusterthrottle"):
            _, ok_t, rows, *_ = tick[kind]
            _, ok_d, _ = dense[kind]
            idx = sorted(rows.values())
            np.testing.assert_array_equal(
                np.asarray(ok_t)[idx], np.asarray(ok_d)[idx]
            )

    def test_sparse_single_device_matches_sharded_mesh(self, stack):
        """The 1×1-mesh tick routes through the sparse [P,K] gather step
        (full_update_step_gather — no [P,T] tensor at all); its counts,
        verdicts, and recomputed used must match the dense 8-device
        shard_map program cell-for-cell."""
        store, plugin = stack
        # sized for sparse eligibility: ~12 matches/pod pads to the K=16
        # rung, which needs tcap ≥ 128 (the K*4 < tcap ladder policy)
        _populate(store, random.Random(2), n_thr=96, n_pods=200, groups=8)
        plugin.run_pending_once()
        dm = plugin.device_manager

        t1 = dm.full_tick_sharded(make_mesh(1, (1, 1), device=CPU))
        # the scenario must actually exercise the sparse path: enough
        # throttles that the [P,K] companion is the chosen batch shape
        with dm._lock:
            dm.throttle.device_pods(need_mask=False)
            assert dm.throttle.device_cols() is not None, (
                "test state too small: cols ladder opted out, sparse tick "
                "not exercised"
            )
        t8 = dm.full_tick_sharded(make_mesh(8, (4, 2), device=CPU))

        for kind in ("throttle", "clusterthrottle"):
            counts_1, ok_1, rows_1, used_cnt_1, used_req_1, cols_1 = t1[kind]
            counts_8, ok_8, rows_8, used_cnt_8, used_req_8, cols_8 = t8[kind]
            assert rows_1 == rows_8
            rows = sorted(rows_1.values())
            np.testing.assert_array_equal(
                np.asarray(counts_1)[rows], np.asarray(counts_8)[rows]
            )
            np.testing.assert_array_equal(
                np.asarray(ok_1)[rows], np.asarray(ok_8)[rows]
            )
            cols = sorted(cols_1)
            np.testing.assert_array_equal(
                np.asarray(used_cnt_1)[cols], np.asarray(used_cnt_8)[cols]
            )
            np.testing.assert_array_equal(
                np.asarray(used_req_1)[cols], np.asarray(used_req_8)[cols]
            )

    def test_sparse_sharded_matches_dense_sharded(self, stack):
        """The multi-chip SPARSE tick (sharded_full_update_gather: [P,K]
        global-id cols rebased per throttle tile, two psums) must match
        the dense [P/dp,T/tp] shard_map program cell-for-cell on the same
        8-device mesh — counts, verdicts, and recomputed used."""
        store, plugin = stack
        _populate(store, random.Random(5), n_thr=96, n_pods=200, groups=8)
        # _populate creates only namespaced Throttles; the cluster kind
        # needs its own population large enough for cols eligibility or
        # its half of this parity loop would silently run dense-vs-dense
        from kube_throttler_tpu_torch.api.types import (
            ClusterThrottle,
            ClusterThrottleSelector,
            ClusterThrottleSelectorTerm,
            ClusterThrottleSpec,
        )

        for i in range(96):
            store.create_cluster_throttle(
                ClusterThrottle(
                    name=f"ct{i}",
                    spec=ClusterThrottleSpec(
                        throttler_name="kube-throttler",
                        threshold=ResourceAmount.of(
                            pod=(i % 7) + 1,
                            requests={"cpu": f"{(i % 5 + 1)}00m"},
                        ),
                        selector=ClusterThrottleSelector(
                            selector_terms=(
                                ClusterThrottleSelectorTerm(
                                    pod_selector=LabelSelector(
                                        match_labels={"grp": f"g{i % 8}"}
                                    ),
                                ),
                            )
                        ),
                    ),
                )
            )
        plugin.run_pending_once()
        dm = plugin.device_manager

        mesh = make_mesh(8, (4, 2), device=CPU)
        sparse = dm.full_tick_sharded(mesh)
        with dm._lock:
            for ks in (dm.throttle, dm.clusterthrottle):
                ks.device_pods(need_mask=False)
                assert ks.device_cols() is not None, (
                    f"test state too small: {ks.kind} cols ladder opted out, "
                    "sparse-sharded tick not exercised for that kind"
                )
        dense = dm.full_tick_sharded(mesh, dense_mesh=True)

        for kind in ("throttle", "clusterthrottle"):
            counts_s, ok_s, rows_s, used_cnt_s, used_req_s, cols_s = sparse[kind]
            counts_d, ok_d, rows_d, used_cnt_d, used_req_d, cols_d = dense[kind]
            assert rows_s == rows_d
            rows = sorted(rows_s.values())
            np.testing.assert_array_equal(
                np.asarray(counts_s)[rows], np.asarray(counts_d)[rows]
            )
            np.testing.assert_array_equal(
                np.asarray(ok_s)[rows], np.asarray(ok_d)[rows]
            )
            cols = sorted(cols_s)
            np.testing.assert_array_equal(
                np.asarray(used_cnt_s)[cols], np.asarray(used_cnt_d)[cols]
            )
            np.testing.assert_array_equal(
                np.asarray(used_req_s)[cols], np.asarray(used_req_d)[cols]
            )

    def test_active_override_resolved_on_device(self, stack):
        """An active temporary override must shape the tick's thresholds:
        spec cpu=100m would throttle the 200m pod, but the active override
        lifts it to 10 CPUs — the tick must classify it schedulable."""
        store, plugin = stack
        now = datetime.now(timezone.utc)
        ov = TemporaryThresholdOverride(
            begin=rfc(now - timedelta(hours=1)),
            end=rfc(now + timedelta(hours=1)),
            threshold=ResourceAmount.of(requests={"cpu": "10"}),
        )
        store.create_throttle(_throttle("t0", 1, 0, cpu="100m", overrides=(ov,)))
        store.create_pod(
            make_pod(
                "p-running",
                labels={"grp": "g0"},
                requests={"cpu": "200m"},
                node_name="node-1",
                phase="Running",
            )
        )
        store.create_pod(make_pod("p-pending", labels={"grp": "g0"}, requests={"cpu": "200m"}))
        plugin.run_pending_once()
        tick = plugin.device_manager.full_tick_sharded(make_mesh(8, (4, 2), device=CPU), now=now)
        _, ok, rows, used_cnt, _, col_map = tick["throttle"]
        assert bool(np.asarray(ok)[rows["default/p-pending"]])
        (col,) = [c for c, k in col_map.items() if k == "default/t0"]
        assert int(used_cnt[col]) == 1  # only the Running pod counts

        # without the override (past window) the same pod is blocked
        ov2 = TemporaryThresholdOverride(
            begin=rfc(now - timedelta(hours=3)),
            end=rfc(now - timedelta(hours=2)),
            threshold=ResourceAmount.of(requests={"cpu": "10"}),
        )
        from dataclasses import replace

        cur = store.get_throttle("default", "t0")
        store.update_throttle(
            replace(cur, spec=replace(cur.spec, temporary_threshold_overrides=(ov2,)))
        )
        plugin.run_pending_once()
        tick = plugin.device_manager.full_tick_sharded(make_mesh(8, (4, 2), device=CPU), now=now)
        _, ok, rows, *_ = tick["throttle"]
        assert not bool(np.asarray(ok)[rows["default/p-pending"]])

    def test_tick_races_live_churn(self, stack):
        """full_tick_sharded snapshots under the main lock while store
        events mutate rows/columns concurrently: ticks must never crash and
        every verdict map must cover exactly the pods of SOME point in the
        event stream (keys are a superset of never-deleted pods)."""
        import threading

        store, plugin = stack
        rng = random.Random(3)
        _populate(store, rng, n_thr=12, n_pods=40)
        plugin.run_pending_once()
        mesh = make_mesh(8, (4, 2), device=CPU)
        # compile the shard_map programs BEFORE the race window, so the
        # churn genuinely overlaps snapshot/tick work rather than one
        # multi-second first-call compilation
        plugin.device_manager.full_tick_sharded(mesh, on_equal=False)
        stable = {p.key for p in store.list_pods()}  # never deleted below

        errors = []
        results = []
        started = threading.Event()

        def churner():
            started.wait(10)
            try:
                for i in range(300):
                    store.create_pod(
                        make_pod(
                            f"churn{i}",
                            labels={"grp": f"g{rng.randrange(8)}"},
                            requests={"cpu": f"{rng.randrange(1, 8) * 100}m"},
                            node_name="node-1",
                            phase="Running",
                        )
                    )
                    if i % 3 == 0 and i:
                        store.delete_pod("default", f"churn{i - 1}")
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=churner)
        t.start()
        try:
            started.set()
            ticks = 0
            while t.is_alive() or ticks < 3:  # guaranteed overlap while alive
                out = plugin.device_manager.full_tick_sharded(mesh, on_equal=False)
                results.append(out)
                ticks += 1
                if ticks > 50:
                    break
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            t.join()
        assert not errors, errors
        assert len(results) >= 3
        for out in results:
            for kind in ("throttle", "clusterthrottle"):
                _, ok, rows, *_ = out[kind]
                assert stable <= set(rows), "tick lost stable pods"
                # snapshot coherence: rows index into the verdict array,
                # one row per pod (a torn snapshot could alias rows)
                vals = list(rows.values())
                assert max(vals) < len(ok)
                assert len(set(vals)) == len(vals), "aliased mask rows"

    def test_plugin_surface_and_http(self, stack):
        store, plugin = stack
        _populate(store, random.Random(2), n_thr=8, n_pods=24)
        plugin.run_pending_once()
        out = plugin.full_tick_sharded(8, (4, 2))
        assert out["mesh"] == [4, 2]
        assert set(out["schedulable"]) == {p.key for p in store.list_pods()}
        batch = plugin.pre_filter_batch()
        assert out["schedulable"] == batch["schedulable"]
        assert out["used"]["throttle"], "per-throttle used counts exposed"

        # over the wire: POST /v1/tick
        import json
        from http.client import HTTPConnection

        from kube_throttler_tpu_torch.server import ThrottlerHTTPServer

        server = ThrottlerHTTPServer(plugin, port=0)
        server.start()
        try:
            conn = HTTPConnection("127.0.0.1", server.port, timeout=30)
            conn.request(
                "POST",
                "/v1/tick",
                json.dumps({"devices": 8, "shape": [4, 2]}),
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            wire = json.loads(resp.read())
            assert resp.status == 200
            assert wire["mesh"] == [4, 2]
            assert wire["schedulable"] == {
                k: bool(v) for k, v in out["schedulable"].items()
            }
        finally:
            server.stop()


# ------------------------------------------------------------ against JAX


KINDS = ("throttle", "clusterthrottle")


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8), (8, 1)])
@pytest.mark.parametrize("dense", [False, True])
def test_grid_tick_matches_jax_on_the_same_mesh(monkeypatch, shape, dense):
    """The port's tick on a ``shape`` grid of CPU slots ≡ the JAX tick on
    the same mesh shape, every output and dtype; the Throttle kind takes
    the sparse grid step unless ``dense_mesh``."""
    import jax

    from kube_throttler_tpu.parallel import make_mesh as jmake_mesh
    from tests.test_torch_prefilter_batch import T0, _stacks
    from tests.test_torch_tick import _assert_tick_same

    assert len(jax.devices()) == 8
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    ref, port = _stacks()
    got = port.device_manager.full_tick_sharded(make_mesh(8, shape, device=CPU), now=T0,
                                                dense_mesh=dense)
    want = ref.device_manager.full_tick_sharded(jmake_mesh(8, shape), now=T0,
                                                dense_mesh=dense)
    _assert_tick_same(got, want, f"mesh {shape}")
    routes = {k: v["route"] for k, v in port.device_manager.last_tick.items()}
    assert routes == {"throttle": "dense" if dense else "sparse", "clusterthrottle": "dense"}
    ref.stop()
    port.stop()


def test_sparse_grid_step_drops_cols_at_or_past_t_as_jax_shard_map():
    """A gather col at or past T: JAX's single-device step clamps it to row
    T - 1 and counts a verdict; its ``shard_map`` step rebases it into a
    pad on every tile, so it yields no verdict and no used sum. The port's
    grid step ≡ the latter on a 4 × 2 mesh, its 1×1 step ≡ the former."""
    import torch

    import kube_throttler_tpu.parallel.sharded as jsharded
    from kube_throttler_tpu.parallel import make_mesh as jmake_mesh
    from kube_throttler_tpu_torch.parallel import sharded as tsharded
    from tests.test_torch_parallel import assert_outputs
    from tests.test_torch_tick import _insert, step_inputs

    jargs, targs, _, cols = step_inputs(11)
    T = targs[-2].shape[0]
    # row T - 1, which a clamped col reads, is a live throttle
    valid = np.asarray(jargs[-2]).copy()
    valid[T - 1] = True
    jargs = (*jargs[:-2], valid, jargs[-1])
    targs = (*targs[:-2], torch.from_numpy(valid.copy()), targs[-1])
    rng = np.random.default_rng(11)
    far = rng.random(cols.shape) < 0.2
    cols = np.where(far, rng.integers(T, 2 * T, cols.shape), cols).astype(np.int32)
    tcols = torch.from_numpy(cols)
    for on_equal, step3 in ((False, True), (True, False)):
        kw = dict(on_equal=on_equal, step3_on_equal=step3)
        want = jsharded.sharded_full_update_gather(jmake_mesh(8, (4, 2)), **kw)(
            *_insert(jargs, cols))
        got = tsharded.sharded_full_update_gather(make_mesh(8, (4, 2), device=CPU), **kw)(
            *_insert(targs, tcols))
        assert_outputs(got, want, "4x2")
        single_want = jsharded.full_update_step_gather(*_insert(jargs, cols), **kw)
        single = tsharded.full_update_step_gather(*_insert(targs, tcols), **kw)
        assert_outputs(single, single_want, "1x1")
        assert not np.array_equal(np.asarray(want[0]), np.asarray(single_want[0])), (
            "the far cols changed no count: the two forms were not told apart"
        )


@pytest.mark.parametrize("kernel", ["check_dense", "check_gather"])
def test_kernel_fault_on_a_tile_reaches_the_caller(stack, monkeypatch, kernel):
    """No fallback on a grid: a kernel that fails to launch on its third
    tile raises ``KernelLaunchError`` out of the tick; nothing is served
    from the host and the breaker stays closed."""
    from kube_throttler_tpu_torch.ops import check_dense as cd
    from kube_throttler_tpu_torch.parallel import sharded as tsharded

    store, plugin = stack
    _populate(store, random.Random(6), n_thr=96, n_pods=200)
    plugin.run_pending_once()
    target = (cd, "check_dense") if kernel == "check_dense" else (tsharded, "check_pods_gather")
    real, calls = getattr(*target), []

    def third_fails(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise cd.KernelLaunchError(f"{kernel} kernel launch failed: cudaError 9")
        return real(*args, **kwargs)

    monkeypatch.setattr(*target, third_fails)
    with pytest.raises(cd.KernelLaunchError, match="cudaError 9"):
        plugin.full_tick_sharded(8, (4, 2))
    assert len(calls) == 3
    assert plugin.device_manager.breaker_state() == "closed"
