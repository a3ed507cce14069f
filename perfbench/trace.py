"""Reduces a ``torch.profiler`` trace of the traced sub-window to what the
per-layer readers take: device time by kernel name, the device's busy
time as the union of its kernel and copy intervals on the timeline, and
the idle gaps, each named by the benchmark's host span it fell in.

The sub-window runs from the first of the benchmark's spans inside
``perfbench.subwindow`` (the first batch's fetch) to the end of that span,
which waits for the device; device intervals are clipped to it.  The profiler can
lose a few records of a CUDA graph's replay (about one in a hundred), so
sums may read short by that share.
"""

from __future__ import annotations

import bisect
import dataclasses

SUBWINDOW = "perfbench.subwindow"
SPAN_PREFIX = "perfbench."
TOP = 10


@dataclasses.dataclass
class Summary:
    kernels: dict           # name -> [device seconds, records]
    busy_s: float
    window_s: float
    gaps: list              # the longest [(host span, seconds)]
    records: int


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps(intervals, lo, hi):
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def summarize(prof) -> Summary | None:
    """The sub-window's summary, None if the trace holds no device work."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == SUBWINDOW]
    if not window:
        return None
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len(SPAN_PREFIX):]) for e in events
                   if e.device_type != DeviceType.CUDA
                   and e.name.startswith(SPAN_PREFIX) and e.name != SUBWINDOW)
    if not spans:
        return None
    # from the first fetch (not the profiler's own start) to the end of
    # the sub-window, which waits for the device
    lo, hi = spans[0][0], window[0].time_range.end
    device = []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # GPU-side user annotations (the optimizer's range) overlap
            # the kernels they annotate
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith(("Optimizer.", SPAN_PREFIX)):
                continue
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                device.append((a, b, e.name))
    if not device:
        return None
    kernels = {}
    for a, b, name in device:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    intervals = [(a, b) for a, b, _ in device]
    busy = _union(intervals) * 1e-6
    starts = [s0 for s0, _, _ in spans]
    gaps = []
    longest = sorted(_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
    for a, b in longest[:TOP]:
        # the benchmark's spans do not nest: the last one to start at or
        # before the gap holds it, if it has not ended
        i = bisect.bisect_right(starts, a) - 1
        where = "outside the benchmark's spans"
        if i >= 0 and a < spans[i][1]:
            where = spans[i][2]
        gaps.append((where, (b - a) * 1e-6))
    return Summary(kernels=kernels, busy_s=busy, window_s=(hi - lo) * 1e-6,
                   gaps=gaps, records=len(device))


def breakdown(summary: Summary) -> dict:
    ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
            "idle_gaps": [[name, s] for name, s in summary.gaps[:TOP]]}
