"""The race gate of the port's thread-heavy test files.

The suite arms the lockset race detector (``KT_RACE_DETECT=1``) for both
packages, and the session gate reads only the JAX package's detector; the
port's detector (``kube_throttler_tpu_torch/utils/racedetect.py``) records
its reports in a list of its own. A test file imports :func:`race_gate`
and the module-scoped autouse fixture fails the file (an error at the
teardown of its last test) when that list grew while it ran, printing
each report. Planted-race fixtures isolate themselves through
``racedetect.capture()``, so a report left in the list came from the
port's code under a real test. A benign race is waived in
``kube_throttler_tpu_torch/analysis_waivers/race_allow.txt``.

Usage, in a test module::

    from torch_race_gate import race_gate  # noqa: F401  (autouse)
"""

from __future__ import annotations

import pytest

from kube_throttler_tpu_torch.utils import racedetect


def new_reports(before):
    """The port's race reports that are not in ``before``."""
    return [r for r in racedetect.reports() if not any(r is b for b in before)]


@pytest.fixture(scope="module", autouse=True)
def race_gate():
    before = racedetect.reports()
    yield
    if not racedetect.enabled():
        return
    new = new_reports(before)
    if new:
        pytest.fail(
            f"{len(new)} unwaived lockset race report(s) of the port — fix, or "
            "waive in kube_throttler_tpu_torch/analysis_waivers/race_allow.txt "
            "with a justification:\n" + "\n".join(r.render() for r in new),
            pytrace=False,
        )
