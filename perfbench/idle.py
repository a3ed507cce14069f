"""Each idle interval of the traced sub-window put down to the host.

``trace.summarize`` finds where the device was idle; this module says why.
The device record that ends an idle interval was launched by a call into
the CUDA API on the host (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...), which the profiler's
correlation id links to it:

- **starved**: that call began after the interval began: the host was
  late.  The interval goes to the innermost program span (``pgtt.*``, the
  port's ``_counters.span``) open on the main thread at the interval's
  start, else to the benchmark's span (``perfbench.*``) open there, else to
  "outside the benchmark's spans";
- **queued**: the work had been launched before the interval began: a
  bubble on the device's side, such as the gap between two nodes of one
  graph replay, which fusing kernels could reclaim;
- **unattributed**: no launch call was found for the record (the profiler
  lost it), or no record ends the interval (the sub-window's tail).

The classes partition the idle time: the starved seconds by span, the
queued and the unattributed sum to ``window_s − busy_s`` of
``trace.summarize`` on the same events, whose sub-window and device
intervals this module takes as that function does.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

from perfbench import trace

PROGRAM_PREFIX = "pgtt."
OUTSIDE = "outside the benchmark's spans"
# a call into the CUDA API: cuda... (runtime) or cu... (the lower level)
LAUNCH = re.compile(r"cu(da)?[A-Z]")


@dataclasses.dataclass
class Idle:
    idle_by_span: dict      # span -> starved seconds
    queued_s: float
    unattributed_s: float
    gaps: list              # the longest [(name, seconds)]

    @property
    def idle_s(self) -> float:
        return (sum(self.idle_by_span.values()) + self.queued_s
                + self.unattributed_s)

    def starved_s(self, prefix: str) -> float:
        """Starved seconds under the spans whose names start with
        ``prefix`` (``loader.``, ``step.``)."""
        return sum(s for name, s in self.idle_by_span.items()
                   if name.startswith(prefix))


def _is_annotation(e) -> bool:
    # as trace.summarize skips them: ranges on the device's timeline that
    # overlap the kernels they annotate
    return getattr(e, "is_user_annotation", False) or e.name.startswith(
        ("Optimizer.", trace.SPAN_PREFIX))


def _innermost(spans, points):
    """For each of the sorted ``points``, the name of the innermost of the
    nested ``spans`` ([(start, end, name)] sorted by start) open there, or
    None."""
    out, stack, j = [], [], 0
    for t in points:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(prof) -> Idle | None:
    """The sub-window's idle time by cause, None where ``trace.summarize``
    reads nothing."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == trace.SUBWINDOW]
    if not window:
        return None
    main = getattr(window[0], "thread", 0)
    bench, program, launched, device = [], [], {}, []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not _is_annotation(e):
                device.append((a, b, getattr(e, "id", None)))
        elif e.name.startswith(trace.SPAN_PREFIX):
            if e.name != trace.SUBWINDOW:
                bench.append((a, b, e.name[len(trace.SPAN_PREFIX):]))
        elif e.name.startswith(PROGRAM_PREFIX):
            if getattr(e, "thread", 0) == main:
                program.append((a, b, e.name[len(PROGRAM_PREFIX):]))
        elif LAUNCH.match(e.name) and getattr(e, "id", None) is not None:
            launched[e.id] = min(a, launched.get(e.id, a))
    if not bench:
        return None
    bench.sort()
    program.sort()
    lo, hi = bench[0][0], window[0].time_range.end
    intervals, ending = [], {}
    for a, b, i in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            intervals.append((a, b))
            ending.setdefault(a, []).append(i)
    if not intervals:
        return None
    gaps = trace._gaps(intervals, lo, hi)
    inner = _innermost(program, [a for a, _ in gaps])
    starts = [s for s, _, _ in bench]
    by_span, queued, unattributed, named = {}, 0.0, 0.0, []
    for (a, b), span in zip(gaps, inner):
        secs = (b - a) * 1e-6
        # the benchmark's spans do not nest: the last one to start at or
        # before the gap holds it, if it has not ended
        k = bisect.bisect_right(starts, a) - 1
        outer = bench[k][2] if k >= 0 and a < bench[k][1] else None
        calls = [launched[i] for i in ending.get(b, ()) if i in launched]
        name = "/".join(n for n in (outer, span) if n) or OUTSIDE
        if not calls:
            unattributed += secs
            name += " (unattributed)"
        elif min(calls) > a:
            key = span or outer or OUTSIDE
            by_span[key] = by_span.get(key, 0.0) + secs
        else:
            queued += secs
            name += " (queued)"
        named.append((name, secs))
    named.sort(key=lambda g: -g[1])
    return Idle(idle_by_span=by_span, queued_s=queued,
                unattributed_s=unattributed, gaps=named[:trace.TOP])
