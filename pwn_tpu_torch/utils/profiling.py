"""Tracing, profiling and debug-mode helpers (counterpart of
`pwn_tpu/utils/profiling.py`), on `torch.profiler` and autograd's anomaly
mode.

    PWN_TPU_PROFILE_DIR=/tmp/prof python -m pwn_tpu_torch.cli train-teacher ...
        -> a Chrome trace of steps 10..15 (host and device) in that dir.

    PWN_TPU_DEBUG=1 -> torch.autograd.set_detect_anomaly(True): a NaN in a
        backward raises at the op that made it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

PROFILE_DIR_ENV = "PWN_TPU_PROFILE_DIR"
DEBUG_ENV = "PWN_TPU_DEBUG"
_PROFILE_START_STEP = 10
_PROFILE_STOP_STEP = 15


def apply_debug_flags() -> None:
    """Turn on autograd's anomaly detection when PWN_TPU_DEBUG is set."""
    if os.environ.get(DEBUG_ENV):
        torch.autograd.set_detect_anomaly(True)


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


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
