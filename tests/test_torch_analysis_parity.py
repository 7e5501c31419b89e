"""The port's analyzer held against the JAX package's over the port.

Both analyzers run every checker the port shares with the JAX package
over ``kube_throttler_tpu_torch/``, with the port's waiver files, and
must report the same findings (baseline-waived ones included) and the
same dead waivers. Eleven of the shared checkers are copies; ``blocking``
and ``dtype`` were taught torch, and over the port their torch rules find
nothing, so there too the two agree. A torch finding would show here as
one the JAX package's analyzer cannot see. The fixture trees of
``tests/test_torch_analysis_checkers.py`` are held equal the same way.
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
    assert port_stale.get(checker) == ref_stale.get(checker)


def test_the_agreement_is_not_empty(both_over_the_port):
    """The baseline's guarded and taint waivers are findings both see."""
    (port, _), _ = both_over_the_port
    assert port["guarded"] and port["taint"]
