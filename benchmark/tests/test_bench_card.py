"""The control of ``correct`` on the card, at each cell's own size and
window: one seed of the port reads under the cell's limit, the bf16
reference in its place over it.  Needs a CUDA card (marked ``card``; skips
without one); run as ``python -m pytest benchmark/tests/test_bench_card.py
-q`` on the card."""

import gc

import pytest

from benchmark import check, registry, run, traffic
from benchmark.trace import Spans

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_port_passes(card, cell):
    wl = registry.workload(cell)
    cfg, mix = registry.config(wl["config"]), registry.traffic(wl["traffic"])
    limit = registry.limits(cell)["mean_gap_excess"]
    seed = 2**31 + 1919
    session = registry.system(cfg["family"]).Session(cfg, mix, seed)
    records, prompts = [], {}

    def sent():
        for req in traffic.requests(mix, seed, cfg["port"]["n_vocab"]):
            prompts[req.index] = req.prompt
            yield req

    run.measure(session, records, sent(), float(registry.benchmark()["run_seconds"]), 0.0, Spans(), None)
    session.release()
    del session
    gc.collect()
    recs = check.sample(records, mix, seed)
    g = check.judged(registry.reference(cfg["family"]), cfg, seed, "cuda", recs, prompts, mix["greedy_sampling"],
                      control=True)
    assert check.numbers(g["served"], g["baseline"])["mean_gap_excess"] <= limit
    assert check.numbers(g["control"], g["baseline"])["mean_gap_excess"] > limit
