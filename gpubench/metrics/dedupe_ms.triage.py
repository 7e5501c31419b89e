"""Mean ``batch_dedupe`` span of a ``pre_filter_batch`` call, ms (plugin)."""

from gpubench import spans

SPANS = ("batch_dedupe",)


def read(rec):
    return spans.mean_ms(rec, "batch_dedupe")
