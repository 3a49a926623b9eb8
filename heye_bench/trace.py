"""The traced window: device operations from torch.profiler (CUDA
activity only), on the host's clock.

The profiler stamps events in Unix-epoch nanoseconds; the window notes
``time.time_ns()`` beside ``time.perf_counter()`` as it opens, which puts
each device operation on the clock of the harness's spans.  Busy time is
the union of the device operations' intervals within the window; each
idle gap is named by the innermost span, the harness's or the program's,
open on the host at its middle.
"""
from __future__ import annotations

import time
from collections import defaultdict


def short_name(name: str) -> str:
    """``void ns::kernel<...>(...)`` -> ``ns::kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    head = name[:cut].strip()
    return head[5:] if head.startswith("void ") else head


class Window:
    """``with Window() as w:`` profiles the device for the block; then
    ``w.events`` holds (start s, end s, name) of each device operation in
    the window on the host's ``perf_counter`` clock, and ``w.window_s``
    the window's length."""

    def __enter__(self) -> "Window":
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.epoch0 = time.time_ns()
        self.host0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._torch.cuda.synchronize()
        self.host1 = time.perf_counter()
        self._prof.__exit__(*exc)
        t = time.perf_counter()
        if exc[0] is None:
            self._read()
        self.stop_s = t - self.host1
        self.read_s = time.perf_counter() - t

    def _read(self) -> None:
        from torch.autograd import DeviceType
        h0, h1, e0 = self.host0, self.host1, self.epoch0
        self.window_s = h1 - h0
        ev = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = h0 + (e.start_ns() - e0) / 1e9
            t = s + e.duration_ns() / 1e9
            if t > h0 and s < h1:
                ev.append((max(s, h0), min(t, h1), e.name()))
        ev.sort()
        self.events = ev

    def busy(self) -> list:
        """The union of the device operations' intervals, in order."""
        out = []
        for s, e, _ in self.events:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def top_ops(self, k: int = 10) -> list:
        """Device seconds per operation, the largest first; an operation is
        named by its kernel's name up to its template or argument list."""
        by = defaultdict(float)
        for s, e, n in self.events:
            by[short_name(n)] += e - s
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_by_span(self, spans: list, default: str, k: int = 10) -> list:
        """Idle seconds per host span name, the largest first: each gap
        goes to the innermost of ``spans`` ((start, end, name) on the
        host's clock, nested or apart) open at its middle, or to
        ``default`` outside them all."""
        iv = self.busy()
        start = self.host0
        stop = self.host0 + self.window_s
        gaps = []
        prev = start
        for s, e in iv:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if stop > prev:
            gaps.append((prev, stop))
        order = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
        by = defaultdict(float)
        open_, j = [], 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while j < len(order) and order[j][0] <= mid:
                while open_ and open_[-1][1] < order[j][0]:
                    open_.pop()
                open_.append(order[j])
                j += 1
            while open_ and open_[-1][1] < mid:
                open_.pop()
            by[open_[-1][2] if open_ else default] += b - a
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:k]

    def kernel_device_s(self, match) -> float:
        return sum(e - s for s, e, n in self.events if match(n))
