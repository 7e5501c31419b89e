"""The port's analyzer held against the JAX package's over the port.

Both analyzers run every checker the port shares with the JAX package
over ``kube_throttler_tpu_torch/``, with the port's waiver files, and
must report the same findings (baseline-waived ones included) and the
same dead waivers. Eleven of the shared checkers are copies; ``blocking``
and ``dtype`` were taught torch, and over the port their torch rules find
nothing, so there too the two agree. A torch finding would show here as
one the JAX package's analyzer cannot see. The fixture trees of
``tests/test_torch_analysis_checkers.py`` are held equal the same way.

One carve-out, for the port only: the port's ``blocking`` checker also
sees a hold taken by an explicit ``.acquire()`` up to its ``.release()``,
and a call through a local receiver (``ks = self._kind(k);
ks.apply_agg_work(...)``). The JAX package's checker has neither rule,
so the waivers of the holds that only those rules find
(``PORT_ONLY_BLOCKING``) are dead to it and live to the port.
"""

import pytest

from kube_throttler_tpu.analysis import run_checks as reference_run_checks
from kube_throttler_tpu.analysis.core import load_package as reference_load_package
from kube_throttler_tpu_torch.analysis import (
    CHECKERS,
    DEFAULT_ALLOWLIST,
    DEFAULT_BLOCKING_ALLOWLIST,
    DEFAULT_DEADLINE_ALLOWLIST,
    DEFAULT_EPOCH_ALLOWLIST,
    PACKAGE_ROOT,
    run_checks,
)
from kube_throttler_tpu_torch.analysis.core import load_package
from tests.test_torch_analysis_checkers import as_reference, rows

PATHS = dict(
    allowlist_path=DEFAULT_ALLOWLIST,
    blocking_allowlist_path=DEFAULT_BLOCKING_ALLOWLIST,
    epoch_allowlist_path=DEFAULT_EPOCH_ALLOWLIST,
    deadline_allowlist_path=DEFAULT_DEADLINE_ALLOWLIST,
)


# (lock node, descriptor) pairs that only the port's acquire/release and
# local-receiver rules of ``blocking`` find over the port, each waived in
# ``analysis_waivers/blocking_allow.txt``
PORT_ONLY_BLOCKING = {
    ("engine.devicestate.DeviceStateManager._agg_locks", "torch:.cpu()"),
    ("engine.devicestate.DeviceStateManager._agg_locks", "torch:.numpy()"),
    ("engine.store.Store._lock", "torch:.cpu()"),
    ("engine.store.Store._lock", "torch:.numpy()"),
    ("sharding.supervisor.ShardSupervisor._rescale_busy", ".request()"),
    ("sharding.supervisor.ShardSupervisor._rescale_busy", "open()"),
    ("sharding.supervisor.ShardSupervisor._rescale_busy", "proc.wait()"),
    ("sharding.supervisor.ShardSupervisor._rescale_busy", "sleep()"),
    ("sharding.supervisor.ShardSupervisor._rescale_busy", "subprocess.Popen()"),
}


@pytest.fixture(scope="module")
def both_over_the_port():
    """(port, reference): each analyzer's findings over the port, by
    checker, and its dead waivers."""
    out = []
    for run, load in ((run_checks, load_package), (reference_run_checks, reference_load_package)):
        stale = {}
        found = run(load(PACKAGE_ROOT), CHECKERS, stale_allow_out=stale, **PATHS)
        by_checker = {c: [f for f in found if f.checker == c] for c in CHECKERS}
        out.append((by_checker, stale))
    return out


def test_the_jax_analyzer_has_every_checker_of_the_ports():
    from kube_throttler_tpu.analysis import CHECKERS as REFERENCE_CHECKERS

    assert set(CHECKERS) < set(REFERENCE_CHECKERS)
    assert set(REFERENCE_CHECKERS) - set(CHECKERS) == {"purity", "donation", "retrace"}


@pytest.mark.parametrize("checker", CHECKERS)
def test_both_analyzers_agree_over_the_port(both_over_the_port, checker):
    (port, port_stale), (ref, ref_stale) = both_over_the_port
    assert rows(port[checker], as_reference) == rows(ref[checker]), (
        "\n".join(f.render() for f in port[checker]),
        "\n".join(f.render() for f in ref[checker]),
    )
    ref_dead = ref_stale.get(checker)
    if checker == "blocking":
        ref_dead = [p for p in ref_dead if p not in PORT_ONLY_BLOCKING]
    assert port_stale.get(checker) == ref_dead


def test_the_port_only_blocking_holds_are_live_to_the_port_alone(both_over_the_port):
    """Every carved-out waiver is dead to the JAX package's checker and
    matches a finding of the port's: the carve-out hides nothing else."""
    (_, port_stale), (_, ref_stale) = both_over_the_port
    assert PORT_ONLY_BLOCKING <= set(ref_stale["blocking"])
    assert not PORT_ONLY_BLOCKING & set(port_stale["blocking"])


def test_the_agreement_is_not_empty(both_over_the_port):
    """The baseline's guarded and taint waivers are findings both see."""
    (port, _), _ = both_over_the_port
    assert port["guarded"] and port["taint"]
