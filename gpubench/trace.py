"""The device trace of a window, reduced to what the metrics read.

``torch.profiler`` records the window (CUPTI for the card's activity,
the host's operators and the harness's ``gpubench.*`` annotations beside
it, on one time base). From its Chrome trace this module takes:

- ``busy_s``: the union of the card's kernel, copy and memset intervals
  inside the window annotation, so overlapping work counts once;
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the card's idle time inside the window, summed by what
  the host was doing then (the innermost annotation: the harness's step,
  or the program's tracer span, which a traced run also marks in the
  profiler; and the innermost host operator if one was running, else
  ``python``), the ten largest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start_profiler(cuda: bool):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    return prof


class _Both:
    """A program span that is also a profiler annotation."""

    __slots__ = ("span", "note")

    def __init__(self, span, note):
        self.span, self.note = span, note

    def __enter__(self):
        self.note.__enter__()
        self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        self.note.__exit__(*exc)


def annotate_spans(plugin) -> None:
    """Mark each of the plugin's tracer spans in the profiler too, so
    idle gaps can be named by the program phase they fall in. The spans
    time and count as before; only traced runs do this."""
    import torch

    tracer = plugin.tracer
    plain = tracer.trace
    tracer.trace = lambda phase: _Both(plain(phase), torch.profiler.record_function(phase))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals: overlapping or touching ones become one."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(merged, lo: float, hi: float):
    """The idle intervals of ``[lo, hi]`` between ``merged`` busy ones."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _innermost(events, starts, t: float, lookback: int = 256):
    """Name of the latest-starting event of ``events`` (sorted by start,
    ``starts`` their starts) that covers ``t``: for nested intervals, the
    innermost. None if none of the ``lookback`` latest before ``t`` does."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def reduce_events(events: List[dict]) -> Dict[str, object]:
    """busy, device ops and idle gaps (all in seconds) of a Chrome trace's
    events; the window is the ``gpubench.window`` annotation."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == "gpubench.window"]
    if not window:
        raise ValueError("the trace holds no gpubench.window annotation")
    lo = float(window[0]["ts"])
    hi = lo + float(window[0].get("dur", 0))
    dev, ops = [], Counter()
    notes, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        end = s + float(e.get("dur", 0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            if end > lo and s < hi:
                dev.append((s, end))
                ops[e.get("name", "?")[:96]] += min(end, hi) - max(s, lo)
        elif cat == "user_annotation" and e.get("name") != "gpubench.window":
            notes.append((s, end, e.get("name", "?").removeprefix("gpubench.")))
        elif cat == "cpu_op":
            host.append((s, end, e.get("name", "?")))
    merged = union(clip(dev, lo, hi))
    busy_us = sum(e - s for s, e in merged)
    notes.sort()
    host.sort()
    note_starts, host_starts = [n[0] for n in notes], [h[0] for h in host]
    edges = sorted({t for s, e, _ in notes for t in (s, e)})
    idle = Counter()
    for s, e in gaps(merged, lo, hi):
        # split the gap where an annotation starts or ends, so each part
        # is named by what the host was doing then
        cuts = edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)]
        for a, b in zip([s] + cuts, cuts + [e]):
            mid = (a + b) / 2
            label = _innermost(notes, note_starts, mid) or "window"
            label += ":" + (_innermost(host, host_starts, mid) or "python")
            idle[label] += b - a
    return {
        "busy_s": busy_us * 1e-6,
        "trace_window_s": (hi - lo) * 1e-6,
        "device_ops": [[n, us * 1e-6] for n, us in ops.most_common(10)],
        "idle_gaps": [[n, us * 1e-6] for n, us in idle.most_common(10)],
        "device_events": len(dev),
    }


def read_profile(prof, window_s: float) -> Dict[str, object]:
    """The stopped profiler's trace, reduced; ``window_s`` is the window's
    length on the host's clock. The trace file is written under TMPDIR
    and removed."""
    fd, path = tempfile.mkstemp(prefix="gpubench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = reduce_events(events)
    out["window_s"] = window_s
    return out
