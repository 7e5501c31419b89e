"""Mean ``batch_dispatch`` span of a ``pre_filter_batch`` call, ms (device
mirror; the span synchronises the card)."""

from gpubench import spans

SPANS = ("batch_dispatch",)


def read(rec):
    return spans.mean_ms(rec, "batch_dispatch")
