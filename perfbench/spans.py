"""The program's spans set against the traced window's device intervals:
the card's idle time put down to the host work it waited on.

The program records its spans while a profiler runs
(`pwn_tpu_torch.utils.profiling.recorded()`: name, native thread, start
and end in epoch nanoseconds, the clock of the profiler's events).
`idle_by_span` takes the idle gaps between the merged device intervals,
as `Trace.idle_gaps` does (the window's edges are left out), and splits
each by the innermost span covering each instant on the thread that
issues the card's work, the process's main thread: {span name: idle ns},
with None for idle under no span.  Spans of other threads are not
attributed.  The join is made once a trace.  A program without the
recorder, one that recorded nothing, or one whose store overflowed and
dropped spans (their idle would land in no span) gives None.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict

from perfbench.trace import _merge

_JOINS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def program_record():
    """The program's `recorded()` spans and counts, or None where the
    program has no recorder or recorded nothing."""
    try:
        from pwn_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    return rec if rec.spans or rec.counts else None


def innermost(spans):
    """[(start, end, name)] of one thread's nested spans [(name, start,
    end)] cut into pieces that do not overlap, each instant under the
    innermost span covering it, in time order; instants under no span are
    in no piece."""
    pieces = []
    stack = []            # [name, end] of the spans open at `at`
    at = None
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            n, end = stack.pop()
            if end > at:
                pieces.append((at, end, n))
                at = end
        if stack and s > at:
            pieces.append((at, s, stack[-1][0]))
        stack.append([name, min(e, stack[-1][1]) if stack else e])
        at = s
    while stack:
        n, end = stack.pop()
        if end > at:
            pieces.append((at, end, n))
            at = end
    return pieces


def gaps(trace):
    """[(start, end)] ns of the card's idle gaps between device intervals."""
    merged = _merge([(s, e) for _, s, e in trace.device])
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def attribute(gap_list, pieces) -> dict:
    """Idle ns of each gap split by the pieces that overlap it: {name:
    ns}, None for the part under no piece.  Both lists in time order,
    neither overlapping itself."""
    by = defaultdict(int)
    j = 0
    for gs, ge in gap_list:
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        covered = 0
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            lo, hi = max(gs, pieces[k][0]), min(ge, pieces[k][1])
            if hi > lo:
                by[pieces[k][2]] += hi - lo
                covered += hi - lo
            k += 1
        by[None] += (ge - gs) - covered
    return dict(by)


def idle_by_span(trace, spans, thread: int) -> dict:
    """{span name or None: idle ns} of `trace`, by `spans` ([Span]) of
    `thread`, open spans left out."""
    mine = [(sp.name, sp.start_ns, sp.end_ns) for sp in spans
            if sp.thread == thread and sp.end_ns is not None]
    return attribute(gaps(trace), innermost(mine))


def idle_ns(run, names=None, other_than=None):
    """Idle ns of the run's traced window under the innermost spans named
    in `names`, or, with `other_than`, under every span not named there
    and under none; None where there is no trace, no recorded span, or a
    span was dropped."""
    if run.trace is None:
        return None
    if run.trace not in _JOINS:
        rec = program_record()
        _JOINS[run.trace] = None if rec is None or not rec.spans \
            or rec.dropped else idle_by_span(
                run.trace, rec.spans, threading.main_thread().native_id)
    by = _JOINS[run.trace]
    if by is None:
        return None
    if other_than is not None:
        return sum(v for k, v in by.items() if k not in other_than)
    return sum(by.get(n, 0) for n in names)


def window_share(run, names=None, other_than=None):
    """`idle_ns` as a % of the traced window."""
    ns = idle_ns(run, names, other_than)
    if ns is None or run.trace.window_s <= 0:
        return None
    return 100.0 * ns * 1e-9 / run.trace.window_s


def per_step_ms(run, names=None, other_than=None):
    """`idle_ns` in ms a step the traced window completed."""
    ns = idle_ns(run, names, other_than)
    steps = run.counts.get("steps")
    if ns is None or not steps:
        return None
    return ns * 1e-6 / steps
