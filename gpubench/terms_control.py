"""The control of a configuration whose stated guarantee is OR-ed selector
terms (``"control": "first_term_only"``): ``gpubench.control`` with every
throttle matched by its first term alone, the step that dropping OR-ed
terms would tempt.

    python3 -m gpubench.terms_control --workload <cell> --seconds <s> --seeds <n> ...

Arguments and output lines are ``gpubench.control``'s, whose ``main`` runs
here with each cell's driver judging ``first_term_only`` against the
cluster cut to first terms. The reference's own controls
(``ignore_overrides``) pass through unchanged.
"""

from __future__ import annotations

import dataclasses
import sys
import types

from gpubench import control, run

FIRST_TERM_ONLY = "first_term_only"


def first_term_only(cluster):
    """``cluster`` with every throttle of both kinds keeping its first
    selector term only; the pods and namespaces are shared, not copied."""

    def cut(ts):
        return dataclasses.replace(ts, terms=[terms[:1] for terms in ts.terms])

    return dataclasses.replace(cluster, throttles=cut(cluster.throttles),
                               cluster_throttles=cut(cluster.cluster_throttles))


def with_control(driver_module) -> types.SimpleNamespace:
    """A driver module whose ``Driver`` judges ``first_term_only`` against
    the cut cluster and every other control as ``driver_module``'s does."""

    class Driver(driver_module.Driver):
        def check(self, control=None):
            if control != FIRST_TERM_ONLY:
                return super().check(control=control)
            whole = self.cluster
            self.cluster = first_term_only(whole)
            try:
                return super().check()
            finally:
                self.cluster = whole

    return types.SimpleNamespace(Driver=Driver)


def main(argv=None) -> int:
    plain = run.resolve_cell

    def resolve_cell(name, root=run.PKG.parent):
        cell = plain(name, root)
        cell.driver = with_control(cell.driver)
        return cell

    run.resolve_cell = resolve_cell
    try:
        return control.main(argv)
    finally:
        run.resolve_cell = plain


if __name__ == "__main__":
    sys.exit(main())
