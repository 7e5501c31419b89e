"""Share of the traced window in which the card ran nothing, % (device)."""

from gpubench import spans

SPANS = ()


def read(rec):
    return spans.idle_pct(rec)
