"""Least time of a ``pre_filter_batch`` call's work
(gpubench.roofline.check_work) over the card's busy time a call, %
(kernels)."""

from gpubench import spans

SPANS = ()


def read(rec):
    return spans.roofline_pct(rec)
