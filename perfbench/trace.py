"""The traced run: `torch.profiler` over the window, reduced to what the
per-layer readers take: each device operation's interval and name, the
union of those intervals (the card's busy seconds), and the CUDA call the
host was in when each idle gap began.

The profiler records CUDA activity only (kernels, copies, and the host's
CUDA runtime and driver calls), not the host's operators: recording every
operator costs the host tens of microseconds an op and, in a host-bound
cell, would read its own cost as idle time.  Busy time is the union of
device intervals over the traced window, so kernels that overlap are not
counted twice.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict


class Trace:
    """What a traced window left: `device` [(name, start_ns, end_ns)],
    `host` [(name, start_ns, end_ns)], `window_s` (host clock, from the
    profiler's start to its stop after a synchronize)."""

    def __init__(self, device, host, window_s: float):
        self.device = device
        self.host = host
        self.window_s = window_s
        self._merged = _merge([(s, e) for _, s, e in device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged) * 1e-9

    def kernel_s(self, patterns) -> float:
        """Summed device seconds of the operations whose name holds any of
        `patterns`."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in patterns)) * 1e-9

    def top_device_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for n, s, e in self.device:
            by[_short(n)] += e - s
        return [[n, v * 1e-9] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle seconds between device operations, summed by the innermost
        CUDA call the host was in when each gap began ("(host outside CUDA
        calls)": Python and the program's host work)."""
        gaps = [(a[1], b[0]) for a, b in zip(self._merged, self._merged[1:])
                if b[0] > a[1]]
        hosts = sorted(self.host, key=lambda h: h[1])
        by = defaultdict(int)
        heap: list = []
        i = 0
        for gs, ge in sorted(gaps):
            while i < len(hosts) and hosts[i][1] <= gs:
                heapq.heappush(heap, (-hosts[i][1], hosts[i][2],
                                      hosts[i][0]))
                i += 1
            while heap and heap[0][1] <= gs:
                heapq.heappop(heap)
            by[_short(heap[0][2]) if heap
               else "(host outside CUDA calls)"] += ge - gs
        return [[n, v * 1e-9] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Profiler:
    """Starts `torch.profiler` (CUDA activity only) and, at `stop`,
    synchronizes, stops it and returns the window's `Trace`."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> Trace:
        torch = self._torch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        device, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            s, d = ev.start_ns(), ev.duration_ns()
            row = (ev.name(), s, s + d)
            (device if ev.device_type() == cuda else host).append(row)
        return Trace(device, host, window_s)
