"""Mean ``merge_clusterthrottle`` span of a ``pre_filter_batch`` call, ms
(plugin: the ClusterThrottle kind's pass of the merge, its row-index
gather, flips and subset probe; nested in ``batch_merge``)."""

from gpubench import spans

SPANS = ("merge_clusterthrottle",)


def read(rec):
    return spans.mean_ms(rec, "merge_clusterthrottle")
