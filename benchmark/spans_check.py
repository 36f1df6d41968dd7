"""Checks a cell's program spans against the device trace, and times them.

    python3 -m benchmark.spans_check --workload <cell> --seed <n> --seconds <s>

One window of the cell as ``benchmark.run`` makes it with ``--trace 1``
(no ``correct``): then one JSON line with the lag of each traced request's
``t_enter`` behind its first harness ``prefill`` span (µs, host clock), the
kernels of the harness's ``decode`` and ``prefill`` ranges and how many of
them the program's spans hold (``decode.step``/``decode.sample``;
``cache``/``prefill``), the per-layer metrics, the card's idle time by
innermost program span (s), the runner's decode time a token in the traced
and in the untraced requests, its prefill time a request in the untraced
ones, and the cost of one span on the host (µs):
with no recorder, recording totals, and recording a timeline under the
profiler.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def span_cost_us(n: int = 200_000) -> dict:
    """µs a ``profiling.span`` costs entered and left in a loop: with no
    recorder, with one, and with one while a profiler records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llama_swift_torch.utils import profiling

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("decode.step"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = {"none": loop()}
    rec = profiling.Recorder()
    prev = profiling.install(rec)
    try:
        out["totals"] = loop()
        with profile(activities=[ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]):
            out["timeline"] = loop()
    finally:
        profiling.install(prev)
    return out


def window(cell: str, seed: int, seconds: float, device: str = "cuda", cfg: dict = None, mix: dict = None):
    """One traced window of ``cell``: its :class:`~benchmark.record.Run` and
    the harness's host spans of the traced requests."""
    from . import registry, traffic
    from .record import Run
    from .run import T_PROCESS, measure
    from .trace import Spans, Tracer

    bench = registry.benchmark()
    wl = registry.workload(cell, bench)
    cfg = cfg or registry.config(wl["config"])
    mix = mix or registry.traffic(wl["traffic"])
    counts, system = registry.counts(cfg["family"]), registry.system(cfg["family"])
    n_vocab = cfg["port"]["n_vocab"]
    session = system.Session(cfg, mix, seed, device=device)
    for req in traffic.warmup_requests(mix, session.bucket, seed, n_vocab):
        for _ in session.events(req, Spans().span):
            pass
    setup_s = time.perf_counter() - T_PROCESS
    records, spans, tracer = [], Spans(), Tracer()
    t_start, t_end, _ = measure(session, records, traffic.requests(mix, seed, n_vocab), seconds,
                                float(mix["trace_seconds"]), spans, tracer)
    traced = {r.index for r in records if r.traced}
    host_spans = [sp for sp in spans.spans if sp[1] in traced]
    run = Run(cfg=cfg, mix=mix, counts=counts, dims=counts.dims(cfg), t_start=t_start, t_end=t_end,
              setup_s=setup_s, records=records, trace=tracer.read(host_spans))
    session.release()
    return run, host_spans


def check(cell: str, seed: int, seconds: float, device: str = "cuda", cfg: dict = None, mix: dict = None) -> dict:
    import torch

    from . import program_spans, registry

    run, host_spans = window(cell, seed, seconds, device, cfg, mix)
    records = run.records
    traced = {r.index for r in records if r.traced}

    def ms_per_token(recs):
        toks = sum(r.stats["generated_tokens"] for r in recs)
        return sum(r.stats["t_decode_s"] for r in recs) / toks * 1e3 if toks else None

    finished = [r for r in records if r.finished and r.stats]
    untraced = [r for r in finished if not r.traced]
    decode = program_spans.coverage(run, "decode", ("decode.step", "decode.sample"))
    prefill = program_spans.coverage(run, "prefill", ("cache", "prefill"))
    lags = program_spans.lags(run, host_spans)
    metrics = {}
    for m in registry.metrics_of(cell, registry.benchmark(), True):
        metrics[m["name"]] = registry.metric(m["name"]).read(run)
    return {
        "cell": cell, "seed": seed, "traced_requests": len(traced),
        "timelines": sum(1 for r in finished if r.traced and "timeline" in r.stats),
        "lag_us": {"median": statistics.median(lags) if lags else None, "max": max(lags, default=None)},
        "decode_kernels": decode, "prefill_kernels": prefill, "metrics": metrics,
        "idle_s": {k: v * 1e-6 for k, v in sorted(program_spans.idle_by_name(run).items())},
        "window_s": run.trace.window_s(),
        "decode_ms_per_token": {"traced": ms_per_token([r for r in finished if r.traced]),
                                "untraced": ms_per_token(untraced)},
        "prefill_ms": statistics.fmean(r.stats["t_prefill_s"] * 1e3 for r in untraced) if untraced else None,
        "span_cost_us": span_cost_us(),
        "card": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(check(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
