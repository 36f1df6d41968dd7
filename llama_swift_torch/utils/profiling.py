"""Profiling and introspection (the port's counterpart of
``llama_swift_tpu/utils/profiling.py``): the observability the reference
stubs out (ggml's ``GGML_PERF`` counters, ``ggml_graph_print``,
``ggml_graph_dump_dot``, ``ggml.c:9514-9750``).

* :func:`span` — a named stretch of the program's host time (``prefill``,
  ``decode.step``, …), recorded into the :class:`Recorder` installed on
  the calling thread.  ``LlamaRunner.run_events`` installs one for each
  request while the request's own code runs, and keeps its totals in
  ``stats["spans"]`` (and, while a ``torch.profiler`` records, every span
  in ``stats["timeline"]``).  With no recorder installed a span costs one
  attribute read.
* :func:`trace` — a ``torch.profiler`` trace of a region (CUDA activity on
  a card, CPU activity without one), exported as a Chrome trace (the JAX
  package's ``jax.profiler`` trace), with the program's spans of the
  region as a host track of its own on the trace's clock.
* :func:`graph_summary` — what a call costs: the port's kernel launches
  during the call (the ``ops.launch_counts()`` delta) and, on the card,
  the peak device memory.  It stands in for XLA's cost and memory analysis.
* :func:`dump_hlo` — the aten graph of a call, traced by
  ``torch.fx.experimental.proxy_tensor.make_fx`` on real tensors.  It stands
  in for XLA's HLO text.

The port's own kernels are ``ctypes`` calls that PyTorch does not see: they
leave no node in the aten graph (only the ``torch.empty`` of their outputs
does).  They show up in ``graph_summary``'s launch counts, and in a trace as
their CUDA kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

#: the exported trace's host track of program spans
PROGRAM_TRACK = "program spans"
_PROGRAM_TID = 0x7FFF0000

#: the trace regions open now, each a set of the recorders that kept a
#: timeline while it was open: process-wide, as the profiler is, since a
#: region's requests may record on other threads
_regions: list = []


class Recorder:
    """The spans of one request (or of one :func:`trace` region).

    ``spans``: ``{name: [count, seconds]}``, always kept.  ``timeline``:
    ``(name, parent index, t0, t1)`` on ``time.perf_counter()`` for each span
    opened while a ``torch.profiler`` records (``None`` until the first);
    the parent index is that of the innermost span open around it in the
    timeline, -1 for none."""

    __slots__ = ("spans", "timeline", "_open")

    def __init__(self):
        self.spans: dict = {}
        self.timeline = None
        self._open: list = []


class _Local(threading.local):
    recorder = None


_state = _Local()


class _Span:
    __slots__ = ("rec", "name", "t0", "at")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.at = rec, name, -1

    def __enter__(self):
        self.t0 = time.perf_counter()
        if _autograd_profiler._is_profiler_enabled:
            rec = self.rec
            tl = rec.timeline
            if tl is None:
                tl = rec.timeline = []
            for region in _regions:
                region.add(rec)
            self.at = len(tl)
            tl.append((self.name, rec._open[-1] if rec._open else -1, self.t0, None))
            rec._open.append(self.at)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        rec = self.rec
        tot = rec.spans.get(self.name)
        if tot is None:
            rec.spans[self.name] = [1, t1 - self.t0]
        else:
            tot[0] += 1
            tot[1] += t1 - self.t0
        if self.at >= 0:
            name, parent, t0, _ = rec.timeline[self.at]
            rec.timeline[self.at] = (name, parent, t0, t1)
            rec._open.pop()
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager recording ``name`` into the calling thread's
    recorder; the shared null context when none is installed.  A span
    must not enclose a ``yield``: it holds the program's own time."""
    rec = _state.recorder
    return _NULL if rec is None else _Span(rec, name)


def no_span(name: str):
    """:func:`span`'s stand-in where a caller records nothing."""
    return _NULL


def install(recorder):
    """Make ``recorder`` (or ``None``) the calling thread's recorder;
    returns the one it replaces, to be installed again after."""
    prev = _state.recorder
    _state.recorder = recorder
    return prev


def _marker_offset(events: list, marker_host: float, on_card: bool):
    """µs to add to ``perf_counter() * 1e6`` to land on the trace's clock:
    from the marker kernel's launching call on a card, from the marker
    annotation without one; ``None`` if the trace holds no marker."""
    if on_card:
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") == "cuda_runtime" and "correlation" in (e.get("args") or {})}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "") and corr in launch:
                return float(launch[corr]) - marker_host * 1e6
        return None
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "profiling.marker":
            return float(e["ts"]) - marker_host * 1e6
    return None


def _program_track(recorders, t_open: float, offset: float) -> list:
    """Chrome trace events of the recorders' timeline spans closed inside
    the region opened at host time ``t_open``, on one host track."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": _PROGRAM_TID, "args": {"name": PROGRAM_TRACK}}]
    for rec in recorders:
        tl = rec.timeline or []
        for name, parent, t0, t1 in tl:
            if t1 is None or t0 < t_open:
                continue
            out.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": _PROGRAM_TID,
                        "ts": t0 * 1e6 + offset, "dur": (t1 - t0) * 1e6,
                        "args": {"parent": tl[parent][0] if parent >= 0 else None}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region; its Chrome trace (viewable in Perfetto) is
    written to ``log_dir/trace-<pid>-<ns>.json`` when the region ends.

    On a card the profiler records CUDA activity alone (kernels, copies,
    sets and the runtime calls that launched them: recording every CPU
    operator too swamps it within a request); without one, CPU activity.
    The program's spans closed in the region (of the requests a runner
    serves in it, and of calls made in it outside any request) go into
    the trace as the host track ``program spans``, each with its parent's
    name; a marker launched as the region opens puts them on the trace's
    clock.  Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
    region_rec, recorders = Recorder(), set()
    prof.start()
    _regions.append(recorders)
    prev = install(region_rec)
    if on_card:
        torch.cuda.synchronize()
        marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
    else:
        marker_host = time.perf_counter()
        with torch.profiler.record_function("profiling.marker"):
            pass
    try:
        yield prof
    finally:
        install(prev)
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
        _regions.remove(recorders)
        path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        offset = _marker_offset(doc.get("traceEvents", []), marker_host, on_card)
        if offset is not None:
            doc.setdefault("traceEvents", []).extend(_program_track(recorders, marker_host, offset))
            with open(path, "w") as f:
                json.dump(doc, f)


def graph_summary(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return {"kernel_launches" (the
    port's kernels launched by the call, by wrapper), and on the card
    "peak_memory_bytes"}."""
    from .. import ops

    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    fn(*args, **kwargs)
    out = {"kernel_launches": {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}}
    if on_card:
        torch.cuda.synchronize()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def dump_hlo(fn, *args, optimized: bool = True, **kwargs) -> str:
    """The aten graph of ``fn(*args, **kwargs)`` as Python code
    (``torch.ops.aten.*`` calls); ``optimized`` drops its dead nodes, as
    XLA's optimized HLO has none."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(lambda *a: fn(*a, **kwargs), tracing_mode="real")(*args)
    if optimized:
        gm.graph.eliminate_dead_code()
        gm.recompile()
    return gm.code
