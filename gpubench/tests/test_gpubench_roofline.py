"""The roofline's byte and operation counts and the trace's union and
idle arithmetic, on states and traces small enough to count by hand;
and a run without a card, which fails and prints no result."""

from __future__ import annotations

import subprocess
import sys
from datetime import datetime, timezone

import numpy as np
import pytest

from gpubench import roofline, spans, trace
from gpubench.reference import semantics as S
from gpubench.run import RunRecord
from gpubench.tests.tiny import ROOT


def _two_pods_one_throttle():
    """ns-0 holds p0 (cpu 100m, memory 1Gi) and p1 (cpu 200m), both
    Running; Throttle t0 (pod 10, cpu 1) selects both; no
    ClusterThrottle."""
    ns = S.Namespaces(["ns-0"], {})
    pods = S.Pods(names=["p0", "p1"], ns=np.array([0, 0]), labels={},
                  req=np.array([[100, 2**30 * 1000], [200, 0]]),
                  present=np.array([[True, True], [True, False]]),
                  counted=np.array([True, True]), alive=np.array([True, True]))
    thr = S.Threshold(cnt=10, cnt_p=True, req=np.array([1000, 0]), req_p=np.array([True, False]))
    t = S.ThrottleSet("throttle", ["ns-0/t0"], np.array([0]), [[S.Selector()]], [thr], [[]])
    c = S.ThrottleSet("clusterthrottle", [], np.zeros(0, np.int64), [], [], [])
    now = datetime.now(timezone.utc)
    return [S.kind_state(t, pods, ns, now), S.kind_state(c, pods, ns, now)], pods


def test_check_work_by_hand():
    states, pods = _two_pods_one_throttle()
    # pods 3 dims x 8 B; 2 pairs x 4 B; threshold 2 members x 8 B; used count
    # and 2 dims x 8 B; 2 flag bytes; 2 verdict bytes
    assert roofline.check_work(states, pods) == (24 + 8 + 16 + 24 + 2 + 2, 4 * 3 + 4 * 2)


def test_least_time_takes_the_larger_bound():
    card = "NVIDIA H100 80GB HBM3"
    assert roofline.least_s(3.35e12, 0, card) == pytest.approx(1.0)
    assert roofline.least_s(0, 1.979e15 * 2, card) == pytest.approx(2.0)
    assert roofline.least_s(1, 1, "some other card") is None


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_trace_union_and_idle_by_hand():
    events = [
        _x("gpubench.window", 0, 100, "user_annotation"),
        _x("gpubench.triage", 0, 100, "user_annotation"),
        _x("aten::foo", 30, 20, "cpu_op"),
        _x("k1", 10, 10, "kernel"),
        _x("Memcpy HtoD", 15, 15, "gpu_memcpy"),
        _x("k1", 50, 10, "kernel"),
        _x("Memset", 95, 15, "gpu_memset"),
        _x("k2", 200, 10, "kernel"),  # outside the window
    ]
    out = trace.reduce_events(events)
    assert out["busy_s"] == pytest.approx(35e-6)  # [10,30] + [50,60] + [95,100]
    assert out["trace_window_s"] == pytest.approx(100e-6)
    assert dict(out["device_ops"]) == pytest.approx(
        {"k1": 20e-6, "Memcpy HtoD": 15e-6, "Memset": 5e-6})
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"triage:python": 45e-6, "triage:aten::foo": 20e-6})


def test_union_merges_overlaps_once():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_share_readers():
    rec = RunRecord(calls=4, trace={"busy_s": 0.002, "window_s": 1.0})
    rec.least_s_per_unit = 1e-6
    assert spans.idle_pct(rec) == pytest.approx(99.8)
    assert spans.roofline_pct(rec) == pytest.approx(100 * 1e-6 / 0.0005)
    assert spans.roofline_pct(RunRecord(calls=4)) is None  # no trace: nothing to read
    rec.spans = {"a": (0.3, 3), "c": (0.05, 2)}
    assert spans.mean_ms(rec, "a") == pytest.approx(100.0)
    assert spans.mean_ms(rec, "c") == pytest.approx(25.0)
    assert spans.mean_ms(rec, "missing") is None


def test_a_run_without_a_card_fails_and_prints_nothing():
    res = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "throttles-100k.triage",
         "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_an_idle_gap_is_split_where_annotations_change():
    events = [
        _x("gpubench.window", 0, 100, "user_annotation"),
        _x("gpubench.triage", 0, 100, "user_annotation"),
        _x("batch_dedupe", 10, 30, "user_annotation"),
        _x("batch_merge", 40, 60, "user_annotation"),
        _x("k", 90, 5, "kernel"),
    ]
    out = trace.reduce_events(events)
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"triage:python": 10e-6, "batch_dedupe:python": 30e-6, "batch_merge:python": 55e-6})
