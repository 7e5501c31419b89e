"""Mean ``batch_handles`` span of a ``pre_filter_batch`` call, ms (device
mirror: the lock wait and both kinds' handle grabs in ``check_batch_all``,
nested in ``batch_dispatch``)."""

from gpubench import spans

SPANS = ("batch_handles",)


def read(rec):
    return spans.mean_ms(rec, "batch_handles")
