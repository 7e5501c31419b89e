"""The CPython collector's pauses, all generations, per ``pre_filter_batch``
call, ms (runtime). The program's tracer reads them as ``gc_gen0``..
``gc_gen2``; a program without that accounting, or a window without a
collection, gives nothing."""

SPANS = ("gc_gen0", "gc_gen1", "gc_gen2")


def read(rec):
    sums = [rec.spans.get(phase, (0.0, 0)) for phase in SPANS]
    if not rec.calls or not sum(count for _, count in sums):
        return None
    return sum(total for total, _ in sums) / rec.calls * 1e3
