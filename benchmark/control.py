"""Readings that set a cell's limits of ``correct``: the port's, on many
seeds, and the control's on the same requests.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --seconds 15 [--control 3] [--fault NAME]

For each seed, in one process: the cell's model from that seed, the cell's
traffic for ``--seconds`` (no warm-up: nothing here is timed), the sample
that a run compares, and the numbers of ``benchmark/check.py`` for the port;
for the first ``--control`` seeds also for the control (the reference in
bf16 in the port's place) on the same prompts and tokens.  With ``--fault``
the port runs with that fault planted (``benchmark/faults.py``).  One JSON line a
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from . import faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also read the control")
    ap.add_argument("--fault", choices=faults.FAULTS, help="plant this fault in the port and read its numbers")
    args = ap.parse_args(argv)

    import torch

    from . import check, registry, run
    from .trace import Spans

    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    wl = registry.workload(args.workload, bench)
    cfg, mix = registry.config(wl["config"]), registry.traffic(wl["traffic"])
    fam = cfg["family"]
    system, ref_mod = registry.system(fam), registry.reference(fam)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        session = system.Session(cfg, mix, seed)
        records, prompts = [], {}

        def sent():
            from . import traffic

            for req in traffic.requests(mix, seed, cfg["port"]["n_vocab"]):
                prompts[req.index] = req.prompt
                yield req

        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            _, _, failed = run.measure(session, records, sent(), args.seconds, 0.0, Spans(), None)
        session.release()
        del session
        gc.collect()
        recs = check.sample(records, mix, seed)
        g = check.judged(ref_mod, cfg, seed, "cuda", recs, prompts, mix["greedy_sampling"], control=k < args.control)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault, "requests": len(records),
                "sampled": len(recs),
                "exact": check.exact_counts(records, prompts, failed),
                "program": check.numbers(g["served"], g["baseline"])}
        if "control" in g:
            line["control"] = check.numbers(g["control"], g["baseline"])
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
