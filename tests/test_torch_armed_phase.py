"""The chip smoke's ``[armed]`` phase rehearsed on the CPU at a small size:
``chip_smoke.armed_child`` in this process (the suite arms the three
runtime twins, as the phase's child interpreter is armed on the card)
drives the batches, the tick, the single-pod PreFilters with their
shadow-checked cache hits, the gang check and a preemption cycle under
the churn thread, and holds the final batch against the host oracle.
Nothing it records may be an error; on the CPU the wrappers run their
plain versions, so no kernel launch is counted."""

import json
from pathlib import Path

import pytest

from kube_throttler_tpu_torch.utils import epochassert

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.setenv("KT_VERDICT_CACHE", "0")
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    yield chip_smoke
    epochassert.reset()  # the phase shadow-checks every hit (sample 1)


def test_armed_phase_on_the_cpu(chip_smoke, capsys):
    P, T, G, C = 2_000, 200, 50, 8
    assert chip_smoke.armed_child(P, T, G, C, device="cpu") == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith(chip_smoke.ARMED_REPORT)]
    assert len(lines) == 1
    s = json.loads(lines[0][len(chip_smoke.ARMED_REPORT):])
    assert s["armed"] == {"lock_assert": True, "race_detect": True, "epoch_assert": True}
    assert s["main_lock"] == "_InstrumentedLock"
    assert s["lock_errors"] == [] and s["thread_errors"] == []
    assert s["race_reports"] == [] and s["stale_verdicts"] == []
    assert s["launches"] == dict.fromkeys(chip_smoke.KERNEL_COUNTERS, 0)
    assert len(s["batches"]) == chip_smoke.ARMED_BATCHES
    for b in s["batches"] + [s["tick"], s["final"]]:
        assert b["verdicts"] >= P and b["errors"] == 0, b
    for b in s["batches"] + [s["final"]]:
        assert b["routes"] == {"throttle": "sparse", "clusterthrottle": "dense"}
    assert s["tick"]["mesh"] == [1, 1]
    quiet, churned = s["single"]["quiet"], s["single"]["churned"]
    assert quiet["pods"] == churned["pods"] == chip_smoke.ARMED_SINGLE
    assert quiet["cache_hits"] > 0 and quiet["repeat_differs"] == 0
    assert quiet["stale_verdicts"] == churned["stale_verdicts"] == 0
    assert churned["cache_hits"] > 0 and churned["epoch_moved"] > 0
    assert s["near_throttles"] == len(range(0, G, C))
    assert s["gang"]["answered"] == s["gang"]["gangs"] == chip_smoke.GANGS
    assert s["preempt"]["evicted"] is True
    assert s["churn"]["errors"] == [] and s["churn"]["added"] == s["churn"]["deleted"] > 0
    final = s["final"]
    assert final["oracle_sample"] == chip_smoke.ORACLE_SAMPLE
    assert final["oracle_mismatches"] == 0 and final["breaker"] == "closed"
    # every churned pod is gone again: the stored pods are the cluster's,
    # the gangs' stored members, less the preemption's victims
    assert final["pods"] < P + chip_smoke.GANGS * chip_smoke.GANG_SIZE // 2


def test_a_caught_lock_violation_is_reported(chip_smoke):
    """A worker loop that catches and logs a lock violation still leaves
    it in ``lockorder.reports()``, which the phase reads."""
    import threading

    from kube_throttler_tpu_torch.utils import lockorder

    assert lockorder.lock_assert_enabled()
    before = lockorder.reports()
    lock = lockorder.make_lock("test_torch_armed_phase.planted")

    def worker():
        with lock:
            try:
                lock.acquire()  # a non-reentrant lock re-taken by its holder
            except lockorder.LockOrderViolation:
                pass  # a worker loop that logs and goes on

    t = threading.Thread(target=worker, name="planted")
    t.start()
    t.join()
    new = lockorder.reports()[len(before):]
    assert len(new) == 1
    assert new[0].startswith("LockOrderViolation: non-reentrant lock "
                             "'test_torch_armed_phase.planted' re-acquired by its holder")


def test_thread_errors_records_an_uncaught_exception_and_undoes_its_hook(chip_smoke):
    import threading

    hook = threading.excepthook
    with chip_smoke.thread_errors() as errors:
        t = threading.Thread(target=lambda: 1 / 0, name="planted")
        t.start()
        t.join()
    assert errors == ["planted: ZeroDivisionError: division by zero"]
    assert threading.excepthook is hook
