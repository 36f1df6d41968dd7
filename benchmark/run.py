"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's model from the seed on the card and warms every
prefill bucket its traffic draws; then one client sends the mix's requests
one after another for ``--seconds`` (a closed loop); then the port's state
is freed and a sample of the served answers is held to the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit (also the last lines of standard error).

With ``--trace 1`` the profiler records the window's first whole requests
up to the mix's ``trace_seconds``; the per-layer metrics read that trace
and the runner's counters of the requests after it.

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), and if JAX or the JAX package is loaded once the window
has closed: checked as the window closes and again just before the result
is printed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "llama_swift_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> dict:
    """The card's name, power limit and clocks from nvidia-smi (empty if it
    cannot be read)."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(q.split(","), (s.strip() for s in out[0].split(",")))) if out else {}


def measure(session, records_out: list, requests, seconds: float, trace_seconds: float, spans, tracer):
    """The measured window: one client sends requests back to back until
    ``seconds`` have passed.  A token counts where it reaches the client
    inside the window; a request in flight at the close is left there.
    Returns (t_start, t_end, failed)."""
    from .record import Record

    failed = 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    stopped = tracer is None
    if tracer is not None:
        tracer.start()
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        req = next(requests)
        rec = Record(req.index, req.prompt_len, req.n_predict, req.greedy, now, traced=not stopped)
        records_out.append(rec)
        spans.request = req.index
        cut = False
        try:
            for kind, tid in session.events(req, spans.span):
                t = time.perf_counter()
                if t > t_end:
                    cut = True
                    break
                if kind == "echo":
                    rec.echo.append(tid)
                else:
                    rec.tokens.append(tid)
                    if rec.t_first is None:
                        rec.t_first = t
        except RuntimeError as e:
            print(f"[bench] {e}", file=sys.stderr)
            failed += 1
            continue
        if not cut and time.perf_counter() <= t_end:
            rec.t_done = time.perf_counter()
            rec.stats = session.stats()
        if not stopped and time.perf_counter() - t_start >= trace_seconds:
            tracer.halt()
            stopped = True
    spans.request = None
    return t_start, t_end, failed


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda", bench: dict = None,
             cfg: dict = None, mix: dict = None, limits: dict = None, log=None) -> dict:
    """One run of ``cell``: returns the result object (without printing).
    ``cfg``, ``mix`` and ``limits`` replace the cell's files (the tests'
    small models)."""
    import torch

    from . import check, registry, traffic
    from .record import Run
    from .trace import Spans, Tracer

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = bench or registry.benchmark()
    wl = registry.workload(cell, bench)
    cfg = cfg or registry.config(wl["config"])
    mix = mix or registry.traffic(wl["traffic"])
    fam = cfg["family"]
    counts, system, ref_mod = registry.counts(fam), registry.system(fam), registry.reference(fam)
    dims = counts.dims(cfg)
    n_vocab = cfg["port"]["n_vocab"]

    session = system.Session(cfg, mix, seed, device=device)
    for req in traffic.warmup_requests(mix, session.bucket, seed, n_vocab):
        for _ in session.events(req, Spans().span):
            pass
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_PROCESS
    log(f"[bench] set-up {setup_s:.3f} s")

    records, spans = [], Spans()
    tracer = Tracer() if trace else None
    prompts = {}

    def sent():
        for req in traffic.requests(mix, seed, n_vocab):
            prompts[req.index] = req.prompt
            yield req

    t_start, t_end, failed = measure(session, records, sent(), seconds, float(mix["trace_seconds"]), spans, tracer)
    traced = {r.index for r in records if r.traced}
    mem_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"[bench] loaded in the measuring process: {', '.join(bad)}")

    dev_trace = None
    if tracer is not None:
        t0 = time.perf_counter()
        dev_trace = tracer.read([sp for sp in spans.spans if sp[1] in traced])
        log(f"[bench] trace read in {time.perf_counter() - t0:.3f} s")

    session.release()
    del session
    gc.collect()

    t0 = time.perf_counter()
    recs = check.sample(records, mix, seed)
    values = check.exact_counts(records, prompts, failed)
    if recs:
        g = check.judged(ref_mod, cfg, seed, device, recs, prompts, mix["greedy_sampling"],
                          prefill_bf16=None if device != "cpu" else False)
        values.update(check.numbers(g["served"], g["baseline"]))
    if limits is None:
        try:
            limits = registry.limits(cell)
        except FileNotFoundError:
            limits = {}
    correct, shown = check.judge(values, limits)
    log(f"[bench] reference over {len(recs)} requests, {values.get('tokens', 0)} tokens, "
        f"in {time.perf_counter() - t0:.3f} s")

    run = Run(cfg=cfg, mix=mix, counts=counts, dims=dims, t_start=t_start, t_end=t_end, setup_s=setup_s,
              records=records, trace=dev_trace)
    metrics = {}
    for m in registry.metrics_of(cell, bench, trace):
        reader = registry.metric(m["name"])
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if device != "cpu":
        kind, count = torch.cuda.get_device_name(0), int(wl["chips"])
    else:
        kind, count = "cpu", 1
    result = {
        "correct": bool(correct),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind, "count": count,
                   "memory_peak_bytes": int(mem_peak)},
    }
    if dev_trace is not None:
        result["device"]["busy_s"] = dev_trace.busy_s()
        result["device"]["window_s"] = dev_trace.window_s()
        result["breakdown"] = {"device_ops": dev_trace.top_ops(), "idle_gaps": dev_trace.idle_gaps()}
    result["checks"] = shown
    result["_values"] = values
    result["_tokens"] = {"requests": len(records), "finished": sum(r.finished for r in records),
                         "prompt_tokens": sum(r.prompt_len for r in records),
                         "output_tokens": sum(len(r.tokens) for r in records)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import registry

    bench = registry.benchmark()
    wl = registry.workload(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"[bench] {args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    return report(result)


def report(result: dict, out=None, err=None) -> int:
    """Prints the readings beside their limits on standard error and the
    result as the last line of standard output; prints no result, and
    returns non-zero, if JAX or the JAX package has been loaded by then (the
    reference and the metric readers run after the window's own check)."""
    out, err = out or sys.stdout, err or sys.stderr
    bad = loaded_forbidden()
    if bad:
        print(f"[bench] loaded in the measuring process: {', '.join(bad)}; no result", file=err)
        return 3
    info = card_info() if result["device"]["platform"] == "gpu" else {}
    print(f"[bench] card {json.dumps(info)}", file=err)
    print(f"[bench] memory_peak_bytes {result['device']['memory_peak_bytes']} "
          f"requests {json.dumps(result.pop('_tokens'))}", file=err)
    values = result.pop("_values")
    print(f"[bench] readings {json.dumps(values)}", file=err)
    for name, c in result["checks"].items():
        print(f"[bench] check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
