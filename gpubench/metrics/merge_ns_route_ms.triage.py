"""Mean ``merge_ns_route`` span of a ``pre_filter_batch`` call, ms
(plugin: the merge's routing of pods of unknown namespaces to errors,
one walk over every verdict key; nested in ``batch_merge``)."""

from gpubench import spans

SPANS = ("merge_ns_route",)


def read(rec):
    return spans.mean_ms(rec, "merge_ns_route")
