"""Tracing, profiling and debug-mode helpers (counterpart of
`pwn_tpu/utils/profiling.py`), on `torch.profiler` and autograd's anomaly
mode.

    PWN_TPU_PROFILE_DIR=/tmp/prof python -m pwn_tpu_torch.cli train-teacher ...
        -> a Chrome trace of steps 10..15 (host and device) in that dir,
           the program's spans among its events.

    PWN_TPU_DEBUG=1 -> torch.autograd.set_detect_anomaly(True): a NaN in a
        backward raises at the op that made it.

Spans and counters.  `span(name)` times a block of the program's host work
and `count(name, n)` adds to a counter, both only while a `torch.profiler`
session runs in the process (a benchmark's traced window, `StepProfiler`'s
steps): `recording()` is the one query that decides it.  With no session a
span costs that query and a shared no-op context, and a counter the query.
While recording, a span keeps (name, thread, start, end) in a bounded
store and also opens a `record_function` of its name, so the profiler's
own trace shows it.  Its timestamps are `time.time_ns()`, the epoch clock
on which the profiler stamps its events (`start_ns()` of a kineto event),
so spans can be set against device intervals directly.
`recorded()` reads the store without clearing it; `clear()` empties it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

PROFILE_DIR_ENV = "PWN_TPU_PROFILE_DIR"
DEBUG_ENV = "PWN_TPU_DEBUG"
_PROFILE_START_STEP = 10
_PROFILE_STOP_STEP = 15
# spans kept before new ones are dropped (and counted): a traced benchmark
# window records a few thousand
MAX_SPANS = 100_000


def apply_debug_flags() -> None:
    """Turn on autograd's anomaly detection when PWN_TPU_DEBUG is set."""
    if os.environ.get(DEBUG_ENV):
        torch.autograd.set_detect_anomaly(True)


def recording() -> bool:
    """Whether a `torch.profiler` session is running, in any thread of the
    process (torch's own process-wide flag, set while a profiler is on;
    `torch._C._autograd._profiler_enabled()` reads the calling thread's
    state only, so a worker thread would never record)."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """One recorded span.  `thread` is the native thread id; times are
    epoch nanoseconds, `end_ns` None while the span is still open.  Spans
    of one thread nest by time."""

    name: str
    thread: int
    start_ns: int
    end_ns: Optional[int]


class Recorded(NamedTuple):
    """The spans in the order they were entered, the counters, and the
    number of spans dropped past `MAX_SPANS`."""

    spans: List[Span]
    counts: Dict[str, float]
    dropped: int


_lock = threading.Lock()
_spans: list = []            # [name, thread, start, end]
_counts: Dict[str, float] = {}
_dropped = 0


def _admit(name: str) -> Optional[list]:
    global _dropped
    with _lock:
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
            return None
        entry = [name, threading.get_native_id(), 0, None]
        _spans.append(entry)
        return entry


class _Open:
    """A span being recorded: enters a `record_function` of its name and
    stamps its entry in the store (None when dropped)."""

    __slots__ = ("name", "entry", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.entry = _admit(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.entry is not None:
            self.entry[2] = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.rf.__exit__(*exc)
        if self.entry is not None:
            self.entry[3] = end


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager timing its block as span `name` while
    `recording()`; otherwise a shared no-op."""
    if not recording():
        return _OFF
    return _Open(name)


def count(name: str, n: float = 1) -> None:
    """Add `n` to counter `name` while `recording()`."""
    if recording():
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def recorded() -> Recorded:
    with _lock:
        return Recorded([Span(*e) for e in _spans], dict(_counts), _dropped)


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _counts.clear()
        _dropped = 0


class StepProfiler:
    """Captures a profiler trace of steps 10..15 when PWN_TPU_PROFILE_DIR is
    set; does nothing otherwise."""

    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir or os.environ.get(PROFILE_DIR_ENV)
        self._prof = None

    def step(self, step: int) -> None:
        if not self.logdir:
            return
        if step == _PROFILE_START_STEP and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= _PROFILE_STOP_STEP and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"[profiler] trace written to {path}")
