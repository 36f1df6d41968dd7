"""Host spans of the benchmark's own calls, and the device trace of a
traced window.

:class:`Spans` records, on the host clock, each step the benchmark makes
into the program (``prefill``, ``decode``, ``stream``).

:class:`Tracer` runs ``torch.profiler`` with CUDA activity alone (kernels,
copies, sets and the runtime calls that launched them: recording every
CPU operator too swamps the profiler within a few seconds of decode) over
a window, exports its Chrome trace to a temporary file, reads it back and
deletes it.  A marker kernel launched at a known host time, right after
the profiler starts, puts the host spans on the trace's clock.
:class:`DeviceTrace` holds what the readers need: the device operations
with their times, the host time of each kernel's launching call, and the
spans as ranges.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep


class Spans:
    def __init__(self):
        self.spans = []  # (label, request index, t0, t1) on the host clock
        self.request = None

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter()
        yield
        self.spans.append((label, self.request, t0, time.perf_counter()))


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    ts: float  # µs, the trace's clock
    dur: float  # µs
    corr: Optional[int]


@dataclasses.dataclass
class Range:
    label: str
    request: int
    ts: float
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


class DeviceTrace:
    """The traced window's device operations and the benchmark's spans as
    ranges; times in µs on the trace's clock.  ``spans`` are host spans
    (``Spans.spans``) and ``marker_host`` the host time at which the marker
    kernel was launched; without a marker in the trace there are no
    ranges."""

    def __init__(self, events: list, spans=(), marker_host: float = None):
        self.ops, self.ranges, launch = [], [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            if cat in DEVICE_CATS:
                self.ops.append(Op(e.get("name", ""), cat, float(e["ts"]), float(e.get("dur", 0.0)),
                                   args.get("correlation")))
            elif cat == "cuda_runtime" and "correlation" in args:
                launch[args["correlation"]] = float(e["ts"])
        self.ops.sort(key=lambda o: o.ts)
        self.launch = launch  # correlation id -> host time of the launching call
        marks = [launch[o.corr] for o in self.ops if MARKER in o.name and o.corr in launch]
        if marks and marker_host is not None:
            offset = marks[0] - marker_host * 1e6
            self.ranges = sorted((Range(label, -1 if req is None else req, t0 * 1e6 + offset, (t1 - t0) * 1e6)
                                  for label, req, t0, t1 in spans), key=lambda r: r.ts)

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o.cat == "kernel"]

    def window(self) -> tuple:
        """(start, end) of the traced window: the first range's start to the
        last range's end."""
        if not self.ranges:
            return None
        return self.ranges[0].ts, max(r.end for r in self.ranges)

    def busy_intervals(self) -> list:
        """Device operations merged into disjoint busy intervals, clipped to
        the window."""
        w = self.window()
        if w is None:
            return []
        merged = []
        for o in self.ops:
            a, b = max(o.ts, w[0]), min(o.ts + o.dur, w[1])
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        w = self.window()
        return 0.0 if w is None else (w[1] - w[0]) * 1e-6

    def in_ranges(self, label: str) -> list:
        """[(range, kernels launched inside it)] for each ``label`` range, by
        the host time of each kernel's launching call."""
        rs = [r for r in self.ranges if r.label == label]
        out = [[] for _ in rs]
        starts = [r.ts for r in rs]
        for k in self.kernels:
            t = self.launch.get(k.corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i].end:
                out[i].append(k)
        return list(zip(rs, out))

    def label_at(self, t: float) -> str:
        """The label of the innermost range covering ``t`` (``harness`` if none: the benchmark between requests)."""
        best = None
        for r in self.ranges:
            if r.ts > t:
                break
            if r.end >= t and (best is None or r.dur < best.dur):
                best = r
        return best.label if best else "harness"

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.dur
        return [[name, us * 1e-6] for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest idle gaps of the device inside the window, each
        named by what the host was doing at its middle."""
        w = self.window()
        if w is None:
            return []
        edges = [w[0]] + [x for iv in self.busy_intervals() for x in iv] + [w[1]]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self.label_at(t0 + g / 2), g * 1e-6] for g, t0 in gaps[:n]]


class Tracer:
    """``torch.profiler`` over a window: ``start()``, ``halt()`` at its end,
    and ``read()`` its :class:`DeviceTrace` once the measured window is
    over."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU])
        self.halted = False
        self.marker_host = None

    def start(self) -> None:
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize()
            self.marker_host = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def halt(self) -> None:
        """Stop recording (once); the trace is read later by :meth:`read`."""
        if not self.halted:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.halted = True

    def read(self, spans=()) -> DeviceTrace:
        """The trace, with ``spans`` (host spans) as its ranges."""
        self.halt()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return DeviceTrace(events, spans, self.marker_host)
