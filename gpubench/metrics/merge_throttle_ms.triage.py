"""Mean ``merge_throttle`` span of a ``pre_filter_batch`` call, ms
(plugin: the Throttle kind's pass of the merge, its row-index gather and
the verdict dict's build; nested in ``batch_merge``)."""

from gpubench import spans

SPANS = ("merge_throttle",)


def read(rec):
    return spans.mean_ms(rec, "merge_throttle")
