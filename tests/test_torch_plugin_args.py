"""Plugin-args decoding table tests (reference plugin_args.go:29-60).

The duration grammar mirrors Go ``time.ParseDuration`` exactly: the
reference's args decode through ``fwkruntime.DecodeInto`` → ParseDuration,
which rejects trailing garbage and unit-less numbers — config typos fail
loudly instead of silently truncating.
"""

from datetime import timedelta

import pytest

from kube_throttler_tpu_torch.plugin.args import (
    DEFAULT_RECONCILE_TEMPORARY_THRESHOLD_INTERVAL,
    _parse_go_duration,
    decode_plugin_args,
)
from torch_race_gate import race_gate  # noqa: E402,F401  (autouse: the port's race gate)


# (input, expected seconds) — the accept table matches Go's ParseDuration
ACCEPT = [
    ("0", 0.0),
    ("+0", 0.0),
    ("-0", 0.0),
    ("15s", 15.0),
    ("500ms", 0.5),
    ("1m30s", 90.0),
    ("1.5h", 5400.0),
    (".5s", 0.5),
    ("2.s", 2.0),
    ("1h2m3s", 3723.0),
    ("100ns", 1e-7),
    ("250us", 0.00025),
    ("250µs", 0.00025),  # U+00B5 micro sign
    ("250μs", 0.00025),  # U+03BC greek mu
    ("-1m", -60.0),
    ("+2s", 2.0),
    ("1m1m", 120.0),  # repeated units are legal in Go
]

REJECT = [
    "",
    "garbage",
    "15sgarbage",  # trailing garbage must fail
    "15",  # unit required (only bare "0" is exempt)
    "s",
    ".s",
    "-",
    "+",
    "1d",  # Go has no day unit
    "1.2.3s",
    "15s ",  # whitespace is not part of the grammar
    " 15s",
    "0x1s",
]


@pytest.mark.parametrize("text,seconds", ACCEPT)
def test_go_duration_accepts(text, seconds):
    assert _parse_go_duration(text) == pytest.approx(
        timedelta(seconds=seconds), abs=timedelta(microseconds=1)
    )


@pytest.mark.parametrize("text", REJECT)
def test_go_duration_rejects(text):
    with pytest.raises(ValueError):
        _parse_go_duration(text)


def test_decode_requires_name_and_target():
    with pytest.raises(ValueError, match="Name"):
        decode_plugin_args({"targetSchedulerName": "sched"})
    with pytest.raises(ValueError, match="TargetSchedulerName"):
        decode_plugin_args({"name": "kt"})


def test_decode_interval_default_and_parse():
    base = {"name": "kt", "targetSchedulerName": "sched"}
    assert (
        decode_plugin_args(base).reconcile_temporary_threshold_interval
        == DEFAULT_RECONCILE_TEMPORARY_THRESHOLD_INTERVAL
    )
    got = decode_plugin_args(
        {**base, "reconcileTemporaryThresholdInterval": "1m30s"}
    )
    assert got.reconcile_temporary_threshold_interval == timedelta(seconds=90)


def test_decode_negative_interval_rejected():
    # the parser is faithful to Go (sign parses), but a negative resync
    # interval would busy-loop the workqueue — decode must refuse it
    base = {"name": "kt", "targetSchedulerName": "sched"}
    with pytest.raises(ValueError, match="negative"):
        decode_plugin_args(
            {**base, "reconcileTemporaryThresholdInterval": "-15s"}
        )


def test_decode_interval_garbage_fails_loudly():
    base = {"name": "kt", "targetSchedulerName": "sched"}
    with pytest.raises(ValueError, match="invalid duration"):
        decode_plugin_args(
            {**base, "reconcileTemporaryThresholdInterval": "15sgarbage"}
        )


def test_decode_threadiness_typo_compat_key():
    # the Go struct tag is the "controllerThrediness" typo — SURVEY §2.3 quirk
    got = decode_plugin_args(
        {"name": "kt", "targetSchedulerName": "s", "controllerThrediness": 3}
    )
    assert got.controller_threadiness == 3


# ------------------------------------------------- serving-knob parse paths
# The gen-4 envguard sweep's regression pins: every env/CLI knob on the
# serving surface must fail LOUDLY (CLI usage error, ValueError)
# or fall back to its documented default — never configure a dead or
# fail-open gate from a typo.


class TestServingKnobParsing:
    def test_positive_seconds_accepts_and_rejects(self):
        import argparse

        from kube_throttler_tpu_torch.cli import _positive_seconds

        finite = _positive_seconds(allow_inf=False)
        assert finite("30") == 30.0
        assert finite("0.5") == 0.5
        for bad in ("nan", "-1", "0", "inf", "soon"):
            with pytest.raises(argparse.ArgumentTypeError):
                finite(bad)
        lag = _positive_seconds(allow_inf=True)
        assert lag("inf") == float("inf")  # explicit "never refuse"
        for bad in ("nan", "-3", "0"):
            with pytest.raises(argparse.ArgumentTypeError):
                lag(bad)

    @pytest.mark.parametrize(
        "flag,val",
        [
            ("--replica-max-lag", "nan"),
            ("--replica-max-lag", "-2"),
            ("--shard-rpc-deadline", "nan"),
            ("--shard-rpc-deadline", "inf"),
            ("--shard-rpc-deadline", "0"),
        ],
    )
    def test_cli_rejects_degenerate_durations(self, flag, val):
        from kube_throttler_tpu_torch.cli import main

        with pytest.raises(SystemExit) as ei:
            main(["serve", "--name", "kt", "--target-scheduler-name", "s",
                  flag, val])
        assert ei.value.code == 2  # argparse usage error, pre-serve

    def test_replica_gate_rejects_nan_and_nonpositive(self):
        # admit() refuses on `lag > max_lag_s`; NaN makes that comparison
        # always-False — i.e. a stale replica SERVES forever (fail-open)
        from kube_throttler_tpu_torch.engine.replication import ReplicaGate

        for bad in (float("nan"), 0.0, -5.0):
            with pytest.raises(ValueError, match="positive"):
                ReplicaGate(object(), max_lag_s=bad)

    def test_replica_gate_allows_explicit_inf(self):
        from kube_throttler_tpu_torch.engine.replication import ReplicaGate

        gate = ReplicaGate(object(), max_lag_s=float("inf"))
        assert gate.max_lag_s == float("inf")

    def test_verdict_cache_size_malformed_falls_back_plugin(self, monkeypatch):
        from kube_throttler_tpu_torch.api.pod import Namespace
        from kube_throttler_tpu_torch.engine.store import Store
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        monkeypatch.setenv("KT_VERDICT_CACHE_SIZE", "lots")
        store = Store()
        plugin = KubeThrottler(
            decode_plugin_args({"name": "kt", "targetSchedulerName": "s"}),
            store, use_device=True, start_workers=False, device="cpu",
        )
        assert plugin.verdict_cache is not None
        assert plugin.verdict_cache.capacity == 65536  # documented default

    def test_verdict_cache_size_malformed_falls_back_front(self, monkeypatch):
        from kube_throttler_tpu_torch.sharding.front import AdmissionFront

        monkeypatch.setenv("KT_VERDICT_CACHE_SIZE", "64k")
        front = AdmissionFront(1)
        try:
            if front.verdict_cache is not None:  # arena-gated on this host
                assert front.verdict_cache.capacity == 65536
        finally:
            front.stop()

    def test_verdict_cache_env_disable(self, monkeypatch):
        from kube_throttler_tpu_torch.engine.store import Store
        from kube_throttler_tpu_torch.plugin import KubeThrottler

        monkeypatch.setenv("KT_VERDICT_CACHE", "0")
        plugin = KubeThrottler(
            decode_plugin_args({"name": "kt", "targetSchedulerName": "s"}),
            Store(), use_device=True, start_workers=False, device="cpu",
        )
        assert plugin.verdict_cache is None


class TestAuthKeyResolution:
    def test_env_key_stripped_and_encoded(self, monkeypatch):
        from kube_throttler_tpu_torch.sharding.ipc import load_auth_key

        monkeypatch.setenv("KT_SHARD_AUTH_KEY", "  hunter2\n")
        assert load_auth_key() == b"hunter2"

    def test_blank_env_means_unauthenticated(self, monkeypatch):
        from kube_throttler_tpu_torch.sharding.ipc import load_auth_key

        monkeypatch.setenv("KT_SHARD_AUTH_KEY", "   \n")
        assert load_auth_key() is None
        monkeypatch.delenv("KT_SHARD_AUTH_KEY")
        assert load_auth_key() is None

    def test_key_file_wins_over_env(self, monkeypatch, tmp_path):
        from kube_throttler_tpu_torch.sharding.ipc import load_auth_key

        monkeypatch.setenv("KT_SHARD_AUTH_KEY", "env-key")
        p = tmp_path / "key"
        p.write_bytes(b"file-key\n")
        assert load_auth_key(str(p)) == b"file-key"

    def test_empty_key_file_fails_loudly(self, tmp_path):
        # an empty mounted Secret must NOT silently degrade the fleet to
        # unauthenticated frames
        from kube_throttler_tpu_torch.sharding.ipc import load_auth_key

        p = tmp_path / "key"
        p.write_bytes(b"  \n")
        with pytest.raises(ValueError, match="empty"):
            load_auth_key(str(p))
