"""Mean ``batch_merge`` span of a ``pre_filter_batch`` call, ms (plugin)."""

from gpubench import spans

SPANS = ("batch_merge",)


def read(rec):
    return spans.mean_ms(rec, "batch_merge")
