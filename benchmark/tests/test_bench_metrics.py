import pytest

from benchmark import registry
from benchmark.record import Record, Run, percentile


def _run(records, t_start=0.0, t_end=10.0):
    cfg = registry.config("deepseek7b-q4_0")
    counts = registry.counts("llama")
    return Run(cfg=cfg, mix=registry.traffic("rag"), counts=counts, dims=counts.dims(cfg), t_start=t_start,
               t_end=t_end, setup_s=3.0, records=records)


def test_percentile_matches_statistics():
    import statistics

    v = [0.3, 1.2, 0.5, 0.9, 2.0, 0.1, 0.7, 0.4, 0.8, 1.5, 0.6]
    assert percentile(v, 90) == pytest.approx(statistics.quantiles(v, n=10, method="inclusive")[8])


def test_ttft_p90_over_all_requests_counts_unfinished():
    recs = [Record(i, 100, 20, False, t_send=float(i), t_first=float(i) + 0.2) for i in range(9)]
    # the tenth request got no token before the close at 10 s: it counts 10 − 9.5 s
    recs.append(Record(9, 100, 20, False, t_send=9.5))
    v = registry.metric("ttft_p90_s").read(_run(recs))
    assert v == pytest.approx(percentile([0.2] * 9 + [0.5], 90))
    assert v > 0.2  # not a median, and the unfinished request is in it


def test_ttft_is_a_tail_of_requests_not_of_pieces():
    # a request's token events (pieces) do not weigh in: one value a request
    recs = [Record(0, 100, 20, False, t_send=0.0, t_first=1.0, tokens=list(range(100))),
            Record(1, 100, 20, False, t_send=1.0, t_first=1.1, tokens=[1])]
    assert registry.metric("ttft_p90_s").read(_run(recs)) == pytest.approx(0.1 + 0.9 * 0.9)


def test_output_tok_s_counts_a_request_in_flight():
    done = Record(0, 10, 30, False, t_send=0.0, t_first=0.5, t_done=6.0, tokens=[5] * 30)
    flying = Record(1, 10, 60, False, t_send=6.0, t_first=7.0, tokens=[5] * 32)
    assert registry.metric("output_tok_s").read(_run([done, flying])) == pytest.approx(62 / 10.0)


def test_stats_metrics_skip_traced_requests():
    recs = [Record(0, 10, 4, False, 0.0, 0.1, 1.0, [1] * 4, traced=True,
                   stats={"t_decode_s": 10.0, "generated_tokens": 4, "t_prefill_s": 1.0}),
            Record(1, 10, 4, False, 1.0, 1.1, 2.0, [1] * 4,
                   stats={"t_decode_s": 0.004, "generated_tokens": 4, "t_prefill_s": 0.05})]
    run = _run(recs)
    assert registry.metric("decode_ms_per_token").read(run) == pytest.approx(1.0)
    assert registry.metric("prefill_ms").read(run) == pytest.approx(50.0)


def test_decode_mfu_counts_each_step_at_its_position():
    counts = registry.counts("llama")
    rec = Record(0, 100, 3, False, 0.0, 0.1, 1.0, [1] * 3, stats={"t_decode_s": 0.03, "generated_tokens": 3})
    run = _run([rec])
    bound = sum(counts.decode_step_bound_s(run.dims, n) for n in (99, 100, 101))
    assert registry.metric("decode_mfu").read(run) == pytest.approx(100 * bound / 0.03)


def test_trace_readers_read_nothing_without_a_trace():
    run = _run([Record(0, 10, 4, False, 0.0)])
    for name in ("launches_per_token", "megakernel_roofline", "dequant_roofline", "device_idle.chat",
                 "device_idle.rag"):
        assert registry.metric(name).read(run) is None
