"""Victim selection in the port (``device="cpu"``) ≡ the JAX package.

- ``ops/victim_select.py``'s plain version (what the wrapper computes on
  CPU tensors) ≡ JAX ``victim_select`` ≡ ``sequential_victim_select`` on
  the 40 seeded problems of ``tests/test_policy.py::
  TestKernelOracleSeeded``, the padding-inert case, and a hypothesis twin
  of ``tests/test_victim_property.py``: selected set, verdict and
  remaining deficits, dtypes included.
- ``PreemptionCoordinator._select`` on a ``device="cpu"`` manager ≡ the
  reference's, padded the same way.
- A preemption cycle through ``plugin.maybe_preempt_gang`` (the residents
  of ``tests/test_policy.py::TestGangPreemption``, without the scheduler)
  evicts the same victims as the reference's, and the gang then admits.
- A ``KernelLaunchError`` from the kernel propagates out of
  ``maybe_preempt_gang``; the host oracle is never served instead.
- The kernel's launch geometry and C signature, checked without a card.
"""

from __future__ import annotations

import ctypes
import random
import re
from pathlib import Path

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
from kube_throttler_tpu.ops.victim_select import victim_select as jax_victim_select
from kube_throttler_tpu_torch.ops import victim_select as vs
from kube_throttler_tpu_torch.ops.check_dense import KernelLaunchError
from kube_throttler_tpu_torch.policy.victims import sequential_victim_select

# by its own name (pytest puts tests/ on the path)
from torch_gather_cases import EXTREMES

PKGS = {
    "ref": (jpod, jtypes, jstore, jplugin, {}),
    "port": (tpod, ttypes, tstore, tplugin, {"device": "cpu"}),
}
PREEMPT_POLICY = {
    "name": "test",
    "preemptionEnabled": True,
    "minPriorityGap": 1,
    "classWeights": [{"accelClass": "gold", "weight": 2.0}],
}


def _seeded_problems():
    """The 40 problems of ``tests/test_policy.py::TestKernelOracleSeeded``,
    drawn in its order from its seed."""
    rng = random.Random(20260805)
    out = []
    for _ in range(40):
        n = rng.randint(1, 40)
        m = rng.randint(1, 8)
        cap = rng.choice([0, 0, rng.randint(1, n)])
        contrib = np.array(
            [[rng.choice([0, 0, 0, 1, 2, 5, 100, 333, 1000]) for _ in range(m)]
             for _ in range(n)], dtype=np.int64,
        )
        deficit = np.array([rng.choice([0, 1, 4, 250, 900, 2000]) for _ in range(m)],
                           dtype=np.int64)
        out.append((contrib, deficit, cap))
    return out


PROBLEMS = _seeded_problems()


def _port(contrib, deficit, cap):
    sel, ok, rem = vs.victim_select(torch.from_numpy(contrib), torch.from_numpy(deficit),
                                    max_victims=cap)
    assert sel.dtype == torch.bool and ok.dtype == torch.bool and ok.dim() == 0
    assert rem.dtype == torch.int64 and sel.shape == (contrib.shape[0],)
    return bool(ok), np.nonzero(sel.numpy())[0].tolist(), rem.numpy()


def _jax(contrib, deficit, cap):
    sel, ok, rem = jax_victim_select(contrib, deficit, max_victims=cap)
    return bool(np.asarray(ok)), np.nonzero(np.asarray(sel))[0].tolist(), np.asarray(rem)


@pytest.mark.parametrize("case", range(len(PROBLEMS)))
def test_seeded_problems_match_jax_and_oracle(case):
    contrib, deficit, cap = PROBLEMS[case]
    before = vs.launches
    got = _port(contrib, deficit, cap)
    assert vs.launches == before  # CPU tensors: the plain version, no launch
    want = _jax(contrib, deficit, cap)
    ok_s, sel_s, rem_s = sequential_victim_select(deficit, contrib, max_victims=cap)
    assert got[:2] == want[:2] == (ok_s, sel_s)
    assert got[2].tolist() == want[2].tolist() == rem_s.tolist()


def test_seeded_problems_reach_every_outcome():
    outcomes = {(ok, bool(sel)) for ok, sel, _ in (_port(*p) for p in PROBLEMS)}
    assert outcomes >= {(True, True), (False, True)}


def test_padded_rows_and_dims_are_inert():
    deficit = np.array([5, 0, 0, 0], dtype=np.int64)
    contrib = np.zeros((8, 4), dtype=np.int64)
    contrib[2, 0] = 5
    assert _port(contrib, deficit, 0)[:2] == _jax(contrib, deficit, 0)[:2] == (True, [2])


def test_int64_extremes_stay_exact():
    """Values past 2^40 milli-units: the subtraction stays exact int64."""
    big = 2**40
    contrib = np.array([[big + 1, 0], [0, 3], [big, 2**62]], dtype=np.int64)
    deficit = np.array([2 * big, 2**62 - 1], dtype=np.int64)
    for cap in (0, 1, 2):
        got, want = _port(contrib, deficit, cap), _jax(contrib, deficit, cap)
        assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist()


def test_negative_contribution_reopens_a_met_dim():
    """A taken row with a negative contribution raises a met dim above 0
    again, and a later row is taken for it: the walk does not assume that
    remaining only falls."""
    contrib = np.array([[6, 0], [-7, 4], [0, 9], [6, 0], [5, 5]], dtype=np.int64)
    deficit = np.array([5, 3], dtype=np.int64)
    for cap in (0, 1, 2, 3):
        got, want = _port(contrib, deficit, cap), _jax(contrib, deficit, cap)
        assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist()
        assert got[:2] == sequential_victim_select(deficit, contrib, cap)[:2]
    # row 1 reopens dim 0 (-1 - -7 = 6); row 3 closes it again; row 4 finds nothing open
    assert _port(contrib, deficit, 0)[:2] == (True, [0, 1, 3])


def test_subtraction_wraps_past_int64_range():
    """``remaining - row`` wraps as two's complement past +2^63 and past
    -2^63, as JAX subtracts int64; a wrap can reopen a met dim."""
    lo, hi = -(2**63), 2**63 - 1
    contrib = np.array([[lo + 1, 1], [hi, 1], [0, 1]], dtype=np.int64)
    deficit = np.array([2**62, 3], dtype=np.int64)
    # row 0: 2^62 - (-2^63 + 1) wraps to -2^62 - 1; row 1: -2^62 - 1 - (2^63 - 1)
    # wraps to 2^62, reopening dim 0
    for cap in (0, 1, 2):
        got, want = _port(contrib, deficit, cap), _jax(contrib, deficit, cap)
        assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist()
    assert _port(contrib, deficit, 0)[2].tolist() == [2**62, 0]
    assert _port(contrib, deficit, 1)[2].tolist() == [-(2**62) - 1, 2]


@pytest.mark.parametrize("seed", range(6))
def test_extremes_with_negative_contributions_match_jax(seed):
    """Seeded problems drawn from the int64 extremes, signs mixed, so the
    subtraction wraps and negative rows reopen dims."""
    rng = np.random.default_rng(seed)
    n, m = 48, 1 + seed
    ext = np.array(EXTREMES, dtype=np.int64)
    contrib = rng.choice(ext, (n, m))
    contrib[rng.random((n, m)) < 0.3] = 0
    deficit = rng.choice(ext, m)
    for cap in (0, 1, n // 3):
        got, want = _port(contrib, deficit, cap), _jax(contrib, deficit, cap)
        assert got[:2] == want[:2] and got[2].tolist() == want[2].tolist()
        assert got[:2] == sequential_victim_select(deficit, contrib, cap)[:2]


# ------------------------------------------------------ hypothesis twin

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

_amounts = st.sampled_from([0, 0, 1, 2, 5, 100, 333, 1000])
_deficits = st.sampled_from([0, 1, 4, 250, 900, 2000])


@st.composite
def _problems(draw):
    n = draw(st.integers(min_value=1, max_value=32))
    m = draw(st.integers(min_value=1, max_value=6))
    contrib = np.array([[draw(_amounts) for _ in range(m)] for _ in range(n)], dtype=np.int64)
    deficit = np.array([draw(_deficits) for _ in range(m)], dtype=np.int64)
    return contrib, deficit, draw(st.sampled_from([0, 0, 1, 2, n]))


@settings(max_examples=60, deadline=None)
@given(_problems())
def test_hypothesis_plain_equals_oracle_and_jax(problem):
    contrib, deficit, cap = problem
    ok_s, sel_s, rem_s = sequential_victim_select(deficit, contrib, max_victims=cap)
    got = _port(contrib, deficit, cap)
    assert got[:2] == (ok_s, sel_s) and got[2].tolist() == rem_s.tolist()
    assert got[:2] == _jax(contrib, deficit, cap)[:2]


@settings(max_examples=25, deadline=None)
@given(_problems(), st.integers(min_value=0, max_value=8))
def test_hypothesis_padding_is_inert(problem, pad):
    contrib, deficit, cap = problem
    n, m = contrib.shape
    contrib_p = np.zeros((n + pad, m + pad), dtype=np.int64)
    contrib_p[:n, :m] = contrib
    deficit_p = np.zeros(m + pad, dtype=np.int64)
    deficit_p[:m] = deficit
    assert _port(contrib, deficit, cap)[:2] == _port(contrib_p, deficit_p, cap)[:2]


# ----------------------------------------------- the coordinator's route


def _stack(pkg):
    pod_mod, types, store_mod, plugin_mod, device = PKGS[pkg]
    store = store_mod.Store()
    store.create_namespace(pod_mod.Namespace("default"))
    config = {"name": "kube-throttler", "targetSchedulerName": "my-scheduler",
              "policies": [dict(PREEMPT_POLICY)]}
    plugin = plugin_mod.KubeThrottler(plugin_mod.decode_plugin_args(config), store,
                                      use_device=True, **device)
    return store, plugin


@pytest.mark.parametrize("device_route", [True, False])
def test_select_matches_reference(monkeypatch, device_route):
    """``_select`` pads, moves the problem to the manager's device and
    calls the port's ``victim_select`` (or, with ``KT_PREEMPT_DEVICE=0``,
    the host oracle), answering as the reference's ``_select`` does."""
    if not device_route:
        monkeypatch.setenv("KT_PREEMPT_DEVICE", "0")
    _, ref = _stack("ref")
    _, port = _stack("port")
    calls = []
    real = vs.victim_select

    def spy(contrib, deficit, max_victims=0):
        calls.append((tuple(contrib.shape), contrib.device.type))
        return real(contrib, deficit, max_victims=max_victims)

    monkeypatch.setattr(vs, "victim_select", spy)
    for contrib, deficit, cap in PROBLEMS[:12]:
        got = port.preempt._select(deficit, contrib, cap)
        want = ref.preempt._select(deficit, contrib, cap)
        assert (got[0], [int(i) for i in got[1]]) == (want[0], [int(i) for i in want[1]])
    if device_route:
        assert len(calls) == 12
        assert all(dev == "cpu" and n >= 8 and m >= 4 for (n, m), dev in calls)
    else:
        assert calls == []
    ref.stop()
    port.stop()


def _throttle(types, name, cpu_m, labels):
    return types.Throttle(name=name, spec=types.ThrottleSpec(
        throttler_name="kube-throttler",
        threshold=types.ResourceAmount.of(requests={"cpu": f"{cpu_m}m"}),
        selector=types.ThrottleSelector(selector_terms=(
            types.ThrottleSelectorTerm(types.LabelSelector(match_labels=labels)),
        )),
    ))


def _residents(pkg):
    """``TestGangPreemption._residents``: one 400m throttle saturated by 4
    running 100m pods, a gang of two at priority 0 and two singles at
    priority 1, reconciled; plus the pending priority-5 gang of two."""
    pod_mod, types, *_ = PKGS[pkg]
    store, plugin = _stack(pkg)
    store.create_throttle(_throttle(types, "t1", 400, {"grp": "a"}))
    for i in range(2):
        store.create_pod(pod_mod.make_pod(
            f"vg{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
            node_name="node-1", phase="Running", priority=0, group="victims", group_size=2,
        ))
    for i in range(2):
        store.create_pod(pod_mod.make_pod(
            f"vs{i}", labels={"grp": "a"}, requests={"cpu": "100m"},
            node_name="node-1", phase="Running", priority=1,
        ))
    plugin.run_pending_once()
    gang = [pod_mod.make_pod(f"hi-r{r}", labels={"grp": "a"}, requests={"cpu": "100m"},
                             group="hi", group_size=2, priority=5) for r in range(2)]
    for pod in gang:
        store.create_pod(pod)
    plugin.run_pending_once()
    return store, plugin, gang


def test_preemption_cycle_matches_reference(monkeypatch):
    calls = []
    real = vs.victim_select

    def spy(contrib, deficit, max_victims=0):
        calls.append(tuple(contrib.shape))
        return real(contrib, deficit, max_victims=max_victims)

    monkeypatch.setattr(vs, "victim_select", spy)
    out = {}
    for pkg in ("ref", "port"):
        store, plugin, gang = _residents(pkg)
        assert not plugin.pre_filter_gang("default/hi", gang).is_success()
        assert plugin.maybe_preempt_gang("default/hi", gang) is True
        live = sorted(p.key for p in store.list_pods("default"))
        plugin.run_pending_once()
        st = plugin.pre_filter_gang("default/hi", gang)
        out[pkg] = (live, plugin.preempt.victims_total, st.code.name, st.reasons)
        if pkg == "port":
            assert plugin.device_manager.breaker_state() == "closed"
        plugin.stop()
    assert out["port"] == out["ref"]
    live, victims, code, _ = out["port"]
    assert victims == 2 and code == "SUCCESS"
    assert "default/vg0" not in live and "default/vg1" not in live  # the whole gang
    assert calls == [(8, 4)]  # the port's cycle went through victim_select once


def test_kernel_launch_error_propagates(monkeypatch):
    """A failed launch raises out of ``maybe_preempt_gang``: no host oracle
    answers in its place and nothing is evicted."""
    import kube_throttler_tpu_torch.policy.preempt as preempt_mod

    def failing(contrib, deficit, max_victims=0):
        raise KernelLaunchError("victim_select kernel launch failed: cudaError 9")

    oracle_calls = []

    def oracle(*args, **kwargs):
        oracle_calls.append(args)
        return sequential_victim_select(*args, **kwargs)

    monkeypatch.setattr(vs, "victim_select", failing)
    monkeypatch.setattr(preempt_mod, "sequential_victim_select", oracle)
    store, plugin, gang = _residents("port")
    with pytest.raises(KernelLaunchError, match="cudaError 9"):
        plugin.maybe_preempt_gang("default/hi", gang)
    assert oracle_calls == []
    assert len(store.list_pods("default")) == 6
    assert plugin.preempt.victims_total == 0
    assert plugin.device_manager.breaker_state() == "closed"
    plugin.stop()


def test_other_cycle_failures_still_return_false(monkeypatch):
    """Any other exception of the cycle is logged and answered ``False``,
    as in the reference."""

    def failing(contrib, deficit, max_victims=0):
        raise RuntimeError("boom")

    monkeypatch.setattr(vs, "victim_select", failing)
    store, plugin, gang = _residents("port")
    assert plugin.maybe_preempt_gang("default/hi", gang) is False
    assert len(store.list_pods("default")) == 6
    plugin.stop()


# ------------------------------------------ the kernel's plumbing (no card)


@pytest.mark.parametrize("M", [1, 31, 32, 33, 1024, 1025, 2500, 7256, 7257, 29056, 29057,
                               30000, 37216, 37217, 10**6])
def test_launch_shape_within_cuda_limits(M):
    """The route by shape: the ring while two stages of two rows fit in
    shared memory, else the wide route; every byte of shared memory within
    Hopper's 232,448, chunk rows even (each bulk copy starts 16-byte
    aligned) and whole row groups, remaining in registers or beside them."""
    shape = vs._launch_shape(M)
    assert shape.route == ("ring" if M <= 7256 else "wide")
    assert shape.consumers in (1, 8) and shape.threads <= 1024
    assert shape.reg_cols in (1, 2, 4, 8, 16, 32)
    reg = 32 * shape.consumers * shape.reg_cols
    ext = max(0, M - reg)
    if shape.route == "ring":
        assert shape.threads == 32 * (shape.consumers + 1)  # the producer warp
        assert shape.group_rows == (4 if shape.reg_cols <= 8 else 1)
        for rows in (shape.head_rows, shape.chunk_rows):
            assert rows >= 2 and rows % 2 == 0 and rows % shape.group_rows == 0
        # the first chunk: two groups (the first decided after one small copy)
        assert shape.head_rows == min(shape.chunk_rows, 2 * max(2, shape.group_rows))
        assert 2 <= shape.stages <= 8
        assert shape.stage_bytes % 128 == 0 and shape.stage_bytes >= shape.chunk_rows * M * 8
        assert ext == 0 and shape.remaining_in == "registers"
        assert shape.smem == 256 + shape.stages * shape.stage_bytes
    else:
        assert shape.threads == 32 * shape.consumers == 256 and shape.reg_cols == 32
        assert shape.stages == shape.head_rows == shape.chunk_rows == 0
        assert shape.remaining_in == ("registers" if ext == 0 else "registers+shared"
                                      if 256 + 8 * ext <= 232448 else "registers+device")
        assert shape.smem == 256 + (8 * ext if shape.remaining_in == "registers+shared" else 0)
    assert shape.smem <= 232448


@pytest.mark.parametrize("M", [1, 32, 33, 64, 65, 256, 257, 2500, 4096, 4097, 7256])
def test_launch_shape_consumers(M):
    """One consumer warp up to 64 columns, else eight, and the fewest
    register columns (a power of two) that hold a lane's share: the pairs
    the kernel is instantiated for."""
    shape = vs._launch_shape(M)
    assert shape.consumers == (1 if M <= 64 else 8)
    lanes = 32 * shape.consumers
    assert lanes * shape.reg_cols >= M and (shape.reg_cols == 1 or lanes * shape.reg_cols // 2 < M)
    assert (shape.consumers, shape.reg_cols) in {(1, 1), (1, 2)} | {(8, k) for k in
                                                                     (1, 2, 4, 8, 16, 32)}


def test_c_signature_matches_the_wrapper(monkeypatch):
    """``kt_victim_select``'s parameters in ``csrc/victim_select.cu``: five
    pointers, nine ints, the stream — the ``argtypes`` the wrapper sets,
    in the order ``launch_args`` gives them."""
    src = (Path(vs.__file__).resolve().parent.parent / "csrc" / "victim_select.cu").read_text()
    sig = re.search(r'extern "C" int kt_victim_select\((.*?)\)\s*\{', src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert kinds == ["ptr"] * 5 + ["int"] * 9 + ["ptr"]
    names = [re.split(r"[\s*]+", p)[-1] for p in params]
    assert names == ["contrib", "deficit", "selected", "ok", "remaining", "N", "M", "cap",
                     "consumers", "reg_cols", "stages", "head_rows", "chunk_rows", "smem",
                     "stream"]
    assert [a is ctypes.c_void_p for a in vs.ARGTYPES] == [k == "ptr" for k in kinds]

    class Stream:
        cuda_stream = 777

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    N, M = 3, 5
    ops = [torch.zeros((N, M), dtype=torch.int64), torch.zeros(M, dtype=torch.int64),
           torch.zeros(N, dtype=torch.bool), torch.zeros((), dtype=torch.bool),
           torch.zeros(M, dtype=torch.int64)]
    shape = vs._launch_shape(M)._replace(consumers=2, reg_cols=3, stages=4, head_rows=5,
                                         chunk_rows=6, smem=999)
    args = vs.launch_args(*ops, 7, shape)
    assert dict(zip(names, args)) == {
        "contrib": ops[0].data_ptr(), "deficit": ops[1].data_ptr(),
        "selected": ops[2].data_ptr(), "ok": ops[3].data_ptr(),
        "remaining": ops[4].data_ptr(), "N": N, "M": M, "cap": 7, "consumers": 2,
        "reg_cols": 3, "stages": 4, "head_rows": 5, "chunk_rows": 6, "smem": 999,
        "stream": 777}


def test_wrapper_refuses_other_devices():
    meta = torch.empty((2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        vs.victim_select(meta, torch.empty(2, dtype=torch.int64, device="meta"))
