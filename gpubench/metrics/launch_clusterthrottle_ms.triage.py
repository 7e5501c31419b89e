"""Mean ``launch_clusterthrottle`` span of a ``pre_filter_batch`` call, ms
(device mirror: the host's side of the ClusterThrottle kind's batch
check in ``check_batch_all``, its kernels enqueued; nested in
``batch_dispatch``, which synchronises the card)."""

from gpubench import spans

SPANS = ("launch_clusterthrottle",)


def read(rec):
    return spans.mean_ms(rec, "launch_clusterthrottle")
