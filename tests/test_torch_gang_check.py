"""Gang admission in the port (``device="cpu"``) ≡ the JAX package.

- ``ops/gang_check.py``: ``_gang_classify``/``gang_check``/
  ``gang_check_both`` on seeded raw arrays (-1 pads, invalid members,
  invalid columns, padded groups, A = 3 classes) ≡ the JAX functions, bit
  for bit and dtype for dtype.
- ``DeviceStateManager.gang_check_groups`` and ``plugin.pre_filter_gang``:
  the 40 seeded scenarios of ``tests/test_gang.py::TestKernelOracleSeeded``
  built once through each package, against the reference's verdict and
  the sequential oracle; the ``TestGangAdmission`` cases; and a hypothesis
  twin of ``tests/test_gang_property.py``.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import kube_throttler_tpu.api.pod as jpod
import kube_throttler_tpu.api.types as jtypes
import kube_throttler_tpu.engine.store as jstore
import kube_throttler_tpu.plugin as jplugin
import kube_throttler_tpu_torch.api.pod as tpod
import kube_throttler_tpu_torch.api.types as ttypes
import kube_throttler_tpu_torch.engine.store as tstore
import kube_throttler_tpu_torch.plugin as tplugin
from kube_throttler_tpu.ops import gang_check as jgc
from kube_throttler_tpu_torch.engine.gang import sequential_gang_check
from kube_throttler_tpu_torch.ops import gang_check as tgc

ARGS = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler"}
# each package's own api modules, so one scenario builds both stores
PKGS = {
    "ref": (jpod, jtypes, jstore, jplugin, {}),
    "port": (tpod, ttypes, tstore, tplugin, {"device": "cpu"}),
}


# ----------------------------------------------------- raw-array parity


def _kind_arrays(rng, N, K, T, R, A):
    big = np.where(np.arange(R) % 2 == 1, 2**33, 1).astype(np.int64)
    cols = rng.integers(0, T, (N, K)).astype(np.int32)
    cols[rng.random((N, K)) < 0.3] = -1  # pads
    return dict(
        cols=cols,
        thr_valid=rng.random(T) < 0.85,
        cls_cnt=rng.integers(0, 16, (A, T)).astype(np.int64),
        cls_cnt_present=rng.random((A, T)) < 0.5,
        cls_req=rng.integers(0, 8000, (A, T, R)) * big,
        cls_req_present=rng.random((A, T, R)) < 0.6,
        st_cnt_throttled=rng.random(T) < 0.03,
        st_req_flag_present=rng.random((T, R)) < 0.5,
        st_req_throttled=rng.random((T, R)) < 0.05,
        au_cnt=rng.integers(0, 4, T).astype(np.int64),
        au_req=rng.integers(0, 1500, (T, R)) * big,
    )


def _problem(seed, N=24, K=4, T=24, R=4, A=3, G=16, n_groups=11):
    rng = np.random.default_rng(seed)
    big = np.where(np.arange(R) % 2 == 1, 2**33, 1).astype(np.int64)
    members = dict(
        pod_req=rng.integers(0, 800, (N, R)) * big,
        pod_present=rng.random((N, R)) < 0.7,
        member_valid=rng.random(N) < 0.85,
        gid=rng.integers(0, G, N).astype(np.int32),
    )
    gclass = rng.integers(0, A, G).astype(np.int32)
    gvalid = np.arange(G) < n_groups  # padded groups past n_groups
    kinds = [dict(members, **_kind_arrays(rng, N, K, T, R, A)) for _ in range(2)]
    return kinds, gclass, gvalid, G


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax(d):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in d.items()}


OUT_DTYPES = (torch.bool, torch.bool, torch.bool, torch.bool)


@pytest.mark.parametrize("seed", range(6))
def test_gang_check_both_matches_jax(seed):
    import jax.numpy as jnp

    kinds, gclass, gvalid, G = _problem(seed)
    want_ok, want = jgc.gang_check_both(_jax(kinds[0]), _jax(kinds[1]), jnp.asarray(gclass),
                                        jnp.asarray(gvalid), num_groups=G)
    got_ok, got = tgc.gang_check_both(_torch(kinds[0]), _torch(kinds[1]),
                                      torch.from_numpy(gclass), torch.from_numpy(gvalid),
                                      num_groups=G)
    assert got_ok.dtype == torch.bool
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    for g_kind, w_kind in zip(got, want):
        for g, w, dt in zip(g_kind, w_kind, OUT_DTYPES):
            assert g.dtype == dt and np.asarray(w).dtype == np.bool_
            assert np.array_equal(g.numpy(), np.asarray(w))
    # every seed reaches both outcomes among its real groups
    assert set(got_ok.numpy()[gvalid].tolist()) == {True, False}


def test_gang_check_single_kind_and_edge_slots():
    """``gang_check`` alone, with a member whose every slot is a pad, a
    member matched only to invalid columns, an invalid member, and a group
    with no members: each is inert exactly as in JAX."""
    import jax.numpy as jnp

    kinds, gclass, gvalid, G = _problem(7, N=16, K=4, T=8, R=3, G=8, n_groups=8)
    k = dict(kinds[0])
    k["cols"] = k["cols"].copy()
    k["cols"][0] = -1
    k["thr_valid"] = k["thr_valid"].copy()
    k["thr_valid"][3] = False
    k["cols"][1] = 3
    k["member_valid"] = k["member_valid"].copy()
    k["member_valid"][2] = False
    k["gid"] = np.where(k["gid"] == 5, 6, k["gid"]).astype(np.int32)  # group 5 empty
    args = ("pod_req", "pod_present", "member_valid", "cols", "gid", "thr_valid", "cls_cnt",
            "cls_cnt_present", "cls_req", "cls_req_present", "st_cnt_throttled",
            "st_req_flag_present", "st_req_throttled", "au_cnt", "au_req")
    jw = _jax(k)
    tw = _torch(k)
    want = jgc.gang_check(*(jw[a] for a in args), jnp.asarray(gclass), jnp.asarray(gvalid),
                          num_groups=G)
    got = tgc.gang_check(*(tw[a] for a in args), torch.from_numpy(gclass),
                         torch.from_numpy(gvalid), num_groups=G)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and np.array_equal(g.numpy(), np.asarray(w))
    assert bool(got[0][5])  # the empty group fits


@pytest.mark.parametrize("past", [0, 3])
def test_gang_check_cols_at_or_past_t_match_jax(past):
    """Fault (h): cols of T, T + 3 and -1 in both kinds. JAX's gathers clamp
    a col >= T to row T - 1 and its scatters drop it; the port raised
    IndexError before."""
    import jax.numpy as jnp

    kinds, gclass, gvalid, G = _problem(0)
    T = kinds[0]["thr_valid"].shape[0]
    for k in kinds:
        k["cols"] = k["cols"].copy()
        k["cols"][::3, 0] = T + past
        k["cols"][1::3, 1] = T + 3
        k["cols"][2::3, 2] = -1
        k["thr_valid"] = k["thr_valid"].copy()
        k["thr_valid"][T - 1] = True
    want_ok, want = jgc.gang_check_both(_jax(kinds[0]), _jax(kinds[1]), jnp.asarray(gclass),
                                        jnp.asarray(gvalid), num_groups=G)
    got_ok, got = tgc.gang_check_both(_torch(kinds[0]), _torch(kinds[1]),
                                      torch.from_numpy(gclass), torch.from_numpy(gvalid),
                                      num_groups=G)
    assert got_ok.dtype == torch.bool
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    for g_kind, w_kind in zip(got, want):
        for g, w, dt in zip(g_kind, w_kind, OUT_DTYPES):
            assert g.dtype == dt and np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ store-level parity


def _throttle(types, name, threshold, accel=(), labels=None, used=None):
    status = {}
    if used is not None:
        status["status"] = types.ThrottleStatus(
            used=used, throttled=threshold.is_throttled(used, True)
        )
    return types.Throttle(
        name=name,
        spec=types.ThrottleSpec(
            throttler_name="kube-throttler",
            threshold=threshold,
            accel_class_thresholds=tuple(accel),
            selector=types.ThrottleSelector(selector_terms=(
                types.ThrottleSelectorTerm(types.LabelSelector(
                    match_labels={"throttle": name} if labels is None else labels)),
            )),
        ),
        **status,
    )


def _plugin(pkg, use_device=True):
    _pod, _types, store_mod, plugin_mod, device = PKGS[pkg]
    store = store_mod.Store()
    store.create_namespace(_pod.Namespace("default"))
    plugin = plugin_mod.KubeThrottler(plugin_mod.decode_plugin_args(ARGS), store,
                                      use_device=use_device, **device)
    return store, plugin


def _member(pod_mod, name, group, size, cpu="100m", labels=None, **kw):
    return pod_mod.make_pod(name, labels=labels or {"throttle": "t1"},
                            requests={"cpu": cpu}, group=group, group_size=size, **kw)


def _oracle(plugin, members):
    return sequential_gang_check(members, (
        ("throttle", plugin.throttle_ctr, False),
        ("clusterthrottle", plugin.cluster_throttle_ctr, False),
    ))


def _seeded_scenario(case_rng, pkg):
    """One scenario of ``TestKernelOracleSeeded`` drawn from ``case_rng``
    (a copy per package, so both draw the same values) and built through
    ``pkg``'s own modules."""
    pod_mod, types, *_ = PKGS[pkg]
    rng = case_rng

    def amount():
        cnt = rng.choice([None, 0, 1, 2, 3, 5])
        cpu = rng.choice([None, 0, 500, 1000, 2500])
        return types.ResourceAmount.of(
            pod=cnt, requests={"cpu": f"{cpu}m"} if cpu is not None else None
        )

    store, plugin = _plugin(pkg)
    for j in range(rng.randint(1, 3)):
        threshold, used = amount(), amount()
        accel = tuple(types.AccelClassThreshold(cls, amount())
                      for cls in ("v5e",) if rng.random() < 0.4)
        grp = rng.choice(["g0", "g1", "*"])
        store.create_throttle(_throttle(types, f"t{j}", threshold, accel,
                                        labels={} if grp == "*" else {"grp": grp}, used=used))
    if rng.random() < 0.5:
        plugin.reserve(pod_mod.make_pod(
            "filler", labels={"grp": rng.choice(["g0", "g1"])},
            requests={"cpu": f"{rng.randint(0, 1500)}m"},
        ))
    accel_cls = rng.choice([None, "v5e"])
    members = [
        pod_mod.make_pod(
            f"m{i}", labels={"grp": rng.choice(["g0", "g1"])},
            requests={"cpu": f"{rng.choice([0, 250, 800, 1500])}m"},
            group="job", group_size=4, accel_class=accel_cls,
        )
        for i in range(rng.randint(1, 5))
    ]
    return plugin, members, accel_cls


def _normalize(verdict):
    return {"ok": verdict["ok"], "kinds": {
        k: dict(v, blocked=sorted(v["blocked"])) for k, v in verdict["kinds"].items()
    }}


def test_seeded_scenarios_match_reference_and_oracle():
    """The 40 seeded scenarios of ``tests/test_gang.py::
    TestKernelOracleSeeded``: the port's ``gang_check_groups`` ≡ the
    reference's (verdict and per-kind detail) ≡ the sequential oracle, and
    ``pre_filter_gang`` gives the reference's status code and reasons."""
    rng = random.Random(20260804)
    seen = set()
    for case in range(40):
        state = rng.getstate()
        built = {}
        for pkg in ("ref", "port"):
            rng.setstate(state)
            built[pkg] = _seeded_scenario(rng, pkg)
        (ref, ref_members, accel), (port, port_members, _) = built["ref"], built["port"]
        group = [("default/job", port_members, accel)]
        got = port.device_manager.gang_check_groups(group)["default/job"]
        want = ref.device_manager.gang_check_groups(
            [("default/job", ref_members, accel)])["default/job"]
        assert _normalize(got) == _normalize(want), f"case {case}"
        oracle_ok, blocked = _oracle(port, port_members)
        assert got["ok"] == oracle_ok, f"case {case}: {got} oracle blocked={blocked}"
        st_p = port.pre_filter_gang("default/job", port_members)
        st_r = ref.pre_filter_gang("default/job", ref_members)
        assert (st_p.code.name, st_p.reasons) == (st_r.code.name, st_r.reasons), f"case {case}"
        assert port.device_manager.breaker_state() == "closed"
        seen.add(got["ok"])
        ref.stop()
        port.stop()
    assert seen == {True, False}


@pytest.mark.parametrize("n,cap,want", [(3, 4, True), (5, 4, False), (4, 4, True)])
@pytest.mark.parametrize("use_device", [True, False])
def test_device_and_host_verdicts_agree(n, cap, want, use_device):
    """``TestGangAdmission.test_device_and_host_verdicts_agree``: fits,
    all-or-nothing reject, exact fit (onEqual=False admission)."""
    pod_mod, types, *_ = PKGS["port"]
    store, plugin = _plugin("port", use_device=use_device)
    store.create_throttle(_throttle(types, "t1", types.ResourceAmount.of(pod=cap)))
    pods = [_member(pod_mod, f"m{i}", "job", n) for i in range(n)]
    st = plugin.pre_filter_gang("default/job", pods)
    assert st.is_success() is want, st.reasons
    plugin.stop()


def test_partial_fit_rejects_whole_group():
    pod_mod, types, *_ = PKGS["port"]
    store, plugin = _plugin("port")
    store.create_throttle(_throttle(types, "t1", types.ResourceAmount.of(pod=2)))
    pods = [_member(pod_mod, f"m{i}", "job", 5) for i in range(5)]
    st = plugin.pre_filter_gang("default/job", pods)
    assert not st.is_success()
    assert "gang:throttle[group-insufficient]=default/t1" in st.reasons
    assert plugin.pre_filter(pods[0]).is_success()
    plugin.stop()


def test_accel_class_threshold_resolves_per_pod_check():
    pod_mod, types, *_ = PKGS["port"]
    store, plugin = _plugin("port")
    store.create_throttle(_throttle(
        types, "t1", types.ResourceAmount.of(pod=10),
        accel=[types.AccelClassThreshold("v5e", types.ResourceAmount.of(pod=0))],
    ))
    base_pod = pod_mod.make_pod("p", labels={"throttle": "t1"})
    accel_pod = pod_mod.make_pod("q", labels={"throttle": "t1"}, accel_class="v5e")
    assert plugin.pre_filter(base_pod).is_success()
    st = plugin.pre_filter(accel_pod)
    assert not st.is_success()
    assert "pod-requests-exceeds-threshold" in ";".join(st.reasons)
    plugin.stop()


def test_gang_accel_class_uses_class_threshold():
    """A v5p gang of 3 under a v5p threshold of 2 pods is rejected on the
    device route; the same gang without the class rides the base 8."""
    pod_mod, types, *_ = PKGS["port"]
    store, plugin = _plugin("port")
    store.create_throttle(_throttle(
        types, "t1", types.ResourceAmount.of(pod=8),
        accel=[types.AccelClassThreshold("v5p", types.ResourceAmount.of(pod=2))],
    ))
    pods = [_member(pod_mod, f"m{i}", "job", 3, accel_class="v5p") for i in range(3)]
    st = plugin.pre_filter_gang("default/job", pods)
    assert not st.is_success()
    plain = [_member(pod_mod, f"n{i}", "job2", 3) for i in range(3)]
    assert plugin.pre_filter_gang("default/job2", plain).is_success()
    both = plugin.device_manager.gang_check_groups(
        [("default/job", pods, "v5p"), ("default/job2", plain, None)])
    assert [both[k]["ok"] for k in ("default/job", "default/job2")] == [False, True]
    plugin.stop()


def test_many_groups_in_one_call_match_the_reference():
    """Many groups, two accel classes, stored and not-yet-stored members,
    in one ``gang_check_groups`` call ≡ the reference's call."""
    rng = random.Random(11)
    plan = []
    for g in range(9):
        cls = [None, "v5e", "v5p"][g % 3]
        plan.append((g, cls, [(rng.randrange(4), rng.choice([100, 300, 700]), rng.random() < 0.5)
                              for _ in range(rng.randint(1, 6))]))
    out = {}
    for pkg in ("ref", "port"):
        pod_mod, types, *_ = PKGS[pkg]
        store, plugin = _plugin(pkg)
        for t in range(4):
            store.create_throttle(_throttle(
                types, f"t{t}", types.ResourceAmount.of(pod=4, requests={"cpu": "1200m"}),
                accel=[types.AccelClassThreshold("v5e", types.ResourceAmount.of(pod=1))],
                labels={"grp": f"g{t}"},
            ))
        groups = []
        for g, cls, specs in plan:
            members = []
            for i, (grp, cpu, stored) in enumerate(specs):
                pod = pod_mod.make_pod(f"j{g}-{i}", labels={"grp": f"g{grp}"},
                                       requests={"cpu": f"{cpu}m"}, group=f"j{g}",
                                       group_size=len(specs), accel_class=cls)
                if stored:
                    store.create_pod(pod)
                members.append(pod)
            groups.append((f"default/j{g}", members, cls))
        plugin.run_pending_once()
        out[pkg] = {k: _normalize(v) for k, v in
                    plugin.device_manager.gang_check_groups(groups).items()}
        plugin.stop()
    assert out["port"] == out["ref"]
    assert {v["ok"] for v in out["port"].values()} == {True, False}


# ------------------------------------------------------ hypothesis twin


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

GROUPS = ("g0", "g1")
ACCEL_CLASSES = (None, "v5e", "v5p")


@st.composite
def _amounts(draw, max_pod=6):
    cnt = draw(st.one_of(st.none(), st.integers(min_value=0, max_value=max_pod)))
    cpu = draw(st.one_of(st.none(), st.integers(min_value=0, max_value=4000)))
    return cnt, cpu


@st.composite
def _scenarios(draw):
    throttles = []
    for _ in range(draw(st.integers(1, 3))):
        threshold, used = draw(_amounts()), draw(_amounts())
        accel = [(cls, draw(_amounts())) for cls in ("v5e", "v5p") if draw(st.booleans())]
        throttles.append((threshold, used, accel, draw(st.sampled_from(GROUPS + ("*",)))))
    members = [(f"m{i}", draw(st.sampled_from(GROUPS)), draw(st.integers(0, 2000)))
               for i in range(draw(st.integers(1, 5)))]
    filler = ((draw(st.sampled_from(GROUPS)), draw(st.integers(0, 1500)))
              if draw(st.booleans()) else None)
    return throttles, members, draw(st.sampled_from(ACCEL_CLASSES)), filler


def _assert_rollback_invisible(pod_mod, plugin, members, n_throttles):
    """reserve → rollback of the gang leaves the reservation ledger, the
    published ``st_*`` planes and a probe pod's verdict as they were."""
    dm = plugin.device_manager

    def reservations():
        out = {}
        for i in range(n_throttles):
            amt, keys = plugin.throttle_ctr.cache.reserved_resource_amount(f"default/t{i}")
            out[i] = (amt, frozenset(keys))
        return out

    res_before, flags_before = reservations(), dm.published_flags()
    probe = pod_mod.make_pod("probe", labels={"grp": "g0"}, requests={"cpu": "500m"})
    verdict_before = plugin.pre_filter(probe).code
    assert plugin.reserve_gang("default/job", members).is_success()
    plugin.unreserve_gang("default/job")
    assert reservations() == res_before
    assert dm.published_flags() == flags_before
    assert plugin.pre_filter(probe).code == verdict_before
    assert plugin.gang.pending_groups() == 0


@given(_scenarios())
@settings(max_examples=40, deadline=None)
def test_hypothesis_gang_check_equals_oracle_and_reference(scenario):
    """``tests/test_gang_property.py``'s property on the port: the batched
    verdict ≡ the sequential oracle and ≡ the reference's batched call, and
    a reserve → rollback cycle of the gang is invisible."""
    throttles, member_specs, accel, filler = scenario
    verdicts = {}
    for pkg in ("ref", "port"):
        pod_mod, types, *_ = PKGS[pkg]
        amt = lambda a: types.ResourceAmount.of(  # noqa: E731
            pod=a[0], requests={"cpu": f"{a[1]}m"} if a[1] is not None else None)
        store, plugin = _plugin(pkg)
        try:
            for i, (threshold, used, acc, grp) in enumerate(throttles):
                store.create_throttle(_throttle(
                    types, f"t{i}", amt(threshold),
                    [types.AccelClassThreshold(c, amt(a)) for c, a in acc],
                    labels={} if grp == "*" else {"grp": grp}, used=amt(used),
                ))
            if filler is not None:
                plugin.reserve(pod_mod.make_pod("filler", labels={"grp": filler[0]},
                                                requests={"cpu": f"{filler[1]}m"}))
            members = [pod_mod.make_pod(name, labels={"grp": grp}, requests={"cpu": f"{cpu}m"},
                                        group="job", group_size=len(member_specs),
                                        accel_class=accel)
                       for name, grp, cpu in member_specs]
            out = plugin.device_manager.gang_check_groups([("default/job", members, accel)])
            verdicts[pkg] = _normalize(out["default/job"])
            if pkg == "port":
                assert out["default/job"]["ok"] == _oracle(plugin, members)[0]
                _assert_rollback_invisible(pod_mod, plugin, members, len(throttles))
        finally:
            plugin.stop()
    assert verdicts["port"] == verdicts["ref"]
