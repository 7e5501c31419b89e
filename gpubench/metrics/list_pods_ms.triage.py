"""Mean ``list_pods`` span of a ``pre_filter_batch`` call, ms (informer:
the dedupe probe's listing of every pod, each materialised from the
store; nested in ``batch_dedupe``)."""

from gpubench import spans

SPANS = ("list_pods",)


def read(rec):
    return spans.mean_ms(rec, "list_pods")
