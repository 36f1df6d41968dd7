"""The program's own spans on the device trace's clock.

``LlamaRunner`` keeps, for a request that ran while the profiler recorded,
``stats["timeline"]``: each span of ``llama_swift_torch/utils/profiling``
as ``(name, parent index, t0, t1)`` on ``time.perf_counter()``, and
``stats["t_enter"]``, the moment its generator first ran.  That first run
happens inside the request's first harness ``prefill`` range, one generator
resume after the range opens, so the request's offset to the trace's clock
is that range's start minus ``t_enter``.

* :func:`spans` — every traced request's spans, as :class:`Span` on the
  trace's clock, each with the names of the spans around it (``path``);
* :func:`kernels_by_path` — each kernel with the path of the innermost
  program span open at its launch (by the host time of its launching call),
  and :func:`device_us`, their device time by span;
* :func:`idle_by_name` — the card's idle time inside the traced window,
  each instant given to the innermost program span open then, or to
  ``outside`` (the harness, and the runner between its spans).

A run of a program that keeps no timeline (or no trace) gives empty results.
"""

from __future__ import annotations

import bisect
import dataclasses

OUTSIDE = "outside"


@dataclasses.dataclass
class Span:
    name: str
    path: tuple  # the names from the outermost span down to this one
    ts: float  # µs, the trace's clock
    end: float


def offsets(run) -> dict:
    """{request index: µs to add to its ``perf_counter() * 1e6``} for each
    traced request whose counters hold a timeline."""
    if run.trace is None:
        return {}
    first = {}
    for r in run.trace.ranges:
        if r.label == "prefill" and r.request not in first:
            first[r.request] = r.ts
    out = {}
    for rec in run.records:
        st = rec.stats or {}
        if rec.traced and "timeline" in st and rec.index in first:
            out[rec.index] = first[rec.index] - st["t_enter"] * 1e6
    return out


def spans(run) -> list:
    """The traced requests' program spans, sorted by start."""
    off = offsets(run)
    out = []
    for rec in run.records:
        if rec.index not in off:
            continue
        tl = rec.stats["timeline"]
        paths = []
        for name, parent, t0, t1 in tl:
            paths.append((paths[parent] if parent >= 0 else ()) + (name,))
            if t1 is not None:
                out.append(Span(name, paths[-1], t0 * 1e6 + off[rec.index], t1 * 1e6 + off[rec.index]))
    out.sort(key=lambda s: (s.ts, -s.end))
    return out


def innermost(span_list: list) -> list:
    """Disjoint ``(t0, t1, path)`` pieces of time, each with the path of the
    innermost span open there; ``span_list`` sorted by start, nested (a span
    that outlasts the one around it is cut at its end)."""
    pieces, stack = [], []  # stack: (end, path)
    t = None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, path = stack.pop()
            if end > t:
                pieces.append((t, end, path))
                t = end

    for s in span_list:
        close_until(s.ts)
        if stack and s.ts > t:
            pieces.append((t, s.ts, stack[-1][1]))
        t = s.ts
        stack.append((min(s.end, stack[-1][0]) if stack else s.end, s.path))
    close_until(float("inf"))
    return pieces


def _path_at(pieces: list, starts: list, t: float):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= pieces[i][1]:
        return pieces[i][2]
    return None


def kernels_by_path(run) -> list:
    """[(kernel, path of the innermost program span open at its launch, or
    ``None``)] for every kernel of the trace with a known launch."""
    if run.trace is None:
        return []
    pieces = innermost(spans(run))
    starts = [p[0] for p in pieces]
    out = []
    for k in run.trace.kernels:
        t = run.trace.launch.get(k.corr)
        if t is not None:
            out.append((k, _path_at(pieces, starts, t)))
    return out


def device_us(run, names: tuple) -> dict:
    """{name: device µs of the kernels launched in a ``name`` span or in a
    span inside one} for each of ``names``."""
    out = dict.fromkeys(names, 0.0)
    for k, path in kernels_by_path(run):
        for n in path or ():
            if n in out:
                out[n] += k.dur
    return out


def idle_by_name(run) -> dict:
    """{innermost span name or ``outside``: idle µs of the card in the traced
    window}; the values sum to the window's idle time."""
    trace = run.trace
    w = trace.window() if trace is not None else None
    if w is None:
        return {}
    edges = [w[0]] + [x for iv in trace.busy_intervals() for x in iv] + [w[1]]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    pieces = innermost(spans(run))
    out, j = {}, 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        t, k = a, j
        while t < b and k < len(pieces) and pieces[k][0] < b:
            p0, p1, path = pieces[k]
            if p0 > t:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (p0 - t)
                t = p0
            seg = min(p1, b) - t
            if seg > 0:
                out[path[-1]] = out.get(path[-1], 0.0) + seg
                t = min(p1, b)
            k += 1
        if t < b:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - t)
    return out


def lags(run, host_spans: list) -> list:
    """µs by which each traced request's ``t_enter`` trails the start of its
    first harness ``prefill`` span, from the harness's own host spans
    (``trace.Spans.spans``: label, request, t0, t1 on ``perf_counter()``)."""
    first = {}
    for label, req, t0, _ in host_spans:
        if label == "prefill" and req not in first:
            first[req] = t0
    return [(rec.stats["t_enter"] - first[rec.index]) * 1e6 for rec in run.records
            if rec.stats and "t_enter" in rec.stats and rec.index in first]


def coverage(run, label: str, names: tuple) -> tuple:
    """(kernels launched in the harness's ``label`` ranges, how many of them
    in a program span whose path holds one of ``names``, {innermost span or
    ``outside``: count} of the others): how well the program's spans cover
    the harness's ranges on the trace's clock."""
    if run.trace is None:
        return 0, 0, {}
    traced = set(offsets(run))
    pieces = innermost(spans(run))
    starts = [p[0] for p in pieces]
    total = inside = 0
    missed = {}
    for rng, ks in run.trace.in_ranges(label):
        if rng.request not in traced:
            continue
        for k in ks:
            total += 1
            path = _path_at(pieces, starts, run.trace.launch[k.corr])
            if path and any(n in path for n in names):
                inside += 1
            else:
                where = path[-1] if path else OUTSIDE
                missed[where] = missed.get(where, 0) + 1
    return total, inside, missed
