"""The program's spans on the trace's clock (``benchmark/program_spans.py``)
and the readers of the metrics built on them, on a synthetic trace; the
lag of ``t_enter`` behind the harness's span in a tiny CPU run."""

import statistics

import pytest

from benchmark import program_spans, registry
from benchmark.record import Record, Run
from benchmark.tests import tiny
from benchmark.trace import DeviceTrace

# the harness's host spans (s); the marker puts them on the trace's clock unshifted
HARNESS = [("prefill", 0, 0.0, 100e-6), ("decode", 0, 200e-6, 500e-6), ("stream", 0, 600e-6, 610e-6)]
T_ENTER = 1000.0  # the program's host clock at its first statement: trace time 0


def _at(us):
    return T_ENTER + us * 1e-6


# (name, parent index, t0, t1): µs after t_enter, on the trace's clock
TIMELINE = [("cache", -1, 2, 8), ("prefill", -1, 8, 60), ("prefill.qkv", 1, 9, 15),
            ("prefill.attention", 1, 15, 40), ("prefill.ffn", 1, 40, 55), ("prefill.read", -1, 60, 95),
            ("decode.step", -1, 205, 290), ("decode.sample", -1, 290, 310), ("decode.step", -1, 310, 390),
            ("decode.read", -1, 390, 495)]


def _events():
    ev = []

    def kernel(name, corr, launch_ts, ts, dur):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}})

    kernel("at::cuda::(anonymous namespace)::spin_kernel(long)", 9, 1000, 1001, 0.5)
    kernel("void dequant_kernel<bf16>", 1, 10, 20, 30)  # prefill.qkv
    kernel("sm80_xmma_gemm_f32f32", 2, 20, 55, 20)  # prefill.attention
    kernel("nvjet_tss", 3, 45, 80, 10)  # prefill.ffn
    kernel("fused_layers_kernel", 4, 210, 220, 100)  # decode.step
    kernel("void at::native::sort", 5, 295, 330, 10)  # decode.sample
    kernel("fused_layers_kernel", 6, 320, 350, 100)  # decode.step
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 450, "dur": 20})
    return ev


def _stats(timeline=True):
    st = {"t_enter": T_ENTER, "generated_tokens": 2, "t_decode_s": 1e-3, "t_prefill_s": 1e-4,
          "spans": {"decode.step": [2, 165e-6], "decode.sample": [1, 20e-6]}}
    if timeline:
        st["timeline"] = [(n, p, _at(a), _at(b)) for n, p, a, b in TIMELINE]
    return st


def _run(timeline=True, trace=True, traced=True):
    cfg = registry.config("deepseek7b-q4_0")
    counts = registry.counts("llama")
    rec = Record(0, 50, 2, True, 0.0, t_done=1.0, stats=_stats(timeline), traced=traced)
    return Run(cfg=cfg, mix=dict(registry.traffic("chat"), device_chunk=32), counts=counts, dims=counts.dims(cfg),
               t_start=0, t_end=1, setup_s=1, records=[rec],
               trace=DeviceTrace(_events(), HARNESS, marker_host=1e-3) if trace else None)


def test_the_offset_is_recovered_from_the_first_prefill_range():
    run = _run()
    assert program_spans.offsets(run) == {0: pytest.approx(-T_ENTER * 1e6)}
    spans = program_spans.spans(run)
    assert [(s.name, s.ts, s.end) for s in spans][:3] == [
        ("cache", pytest.approx(2), pytest.approx(8)), ("prefill", pytest.approx(8), pytest.approx(60)),
        ("prefill.qkv", pytest.approx(9), pytest.approx(15))]
    assert spans[3].path == ("prefill", "prefill.attention")


def test_kernels_go_to_the_innermost_span():
    paths = {k.name: p for k, p in program_spans.kernels_by_path(_run())}
    assert paths["void dequant_kernel<bf16>"] == ("prefill", "prefill.qkv")
    assert paths["sm80_xmma_gemm_f32f32"] == ("prefill", "prefill.attention")
    assert paths["void at::native::sort"] == ("decode.sample",)
    assert paths["at::cuda::(anonymous namespace)::spin_kernel(long)"] is None  # before any span
    us = program_spans.device_us(_run(), ("prefill", "prefill.attention", "decode.step", "decode.sample"))
    assert us == {"prefill": 60, "prefill.attention": 20, "decode.step": 200, "decode.sample": 10}


def test_idle_goes_to_the_innermost_span_and_outside_gets_the_rest():
    run = _run()
    idle = program_spans.idle_by_name(run)
    assert idle == {"outside": pytest.approx(227), "cache": pytest.approx(6), "prefill": pytest.approx(1),
                    "prefill.qkv": pytest.approx(6), "prefill.attention": pytest.approx(5),
                    "prefill.ffn": pytest.approx(5), "prefill.read": pytest.approx(10),
                    "decode.step": pytest.approx(35), "decode.read": pytest.approx(25)}
    assert sum(idle.values()) == pytest.approx(run.trace.window_s() * 1e6 - run.trace.busy_s() * 1e6)
    program = registry.metric("device_idle_program.chat").read(run)
    assert program == pytest.approx(100 * 93 / 610)
    assert program <= registry.metric("device_idle.chat").read(run) == pytest.approx(100 * 320 / 610)


def test_innermost_cuts_a_span_at_the_end_of_the_one_around_it():
    S = program_spans.Span
    pieces = program_spans.innermost([S("a", ("a",), 0, 10), S("b", ("a", "b"), 2, 4), S("c", ("a", "c"), 6, 14),
                                      S("d", ("d",), 20, 30)])
    assert pieces == [(0, 2, ("a",)), (2, 4, ("a", "b")), (4, 6, ("a",)), (6, 10, ("a", "c")),
                      (20, 30, ("d",))]


def test_the_readers():
    run = _run()
    assert registry.metric("sampler_share").read(run) == pytest.approx(100 * 10 / 210)
    assert registry.metric("prefill_attention_share").read(run) == pytest.approx(100 * 20 / 60)
    assert program_spans.coverage(run, "decode", ("decode.step", "decode.sample")) == (3, 3, {})
    assert program_spans.coverage(run, "prefill", ("cache", "prefill")) == (3, 3, {})
    assert program_spans.coverage(run, "decode", ("decode.step",)) == (3, 2, {"decode.sample": 1})
    # the host time a token reads the untraced requests' span totals
    assert registry.metric("decode_host_ms_per_token").read(run) is None
    assert registry.metric("decode_host_ms_per_token").read(_run(traced=False)) == pytest.approx(185e-6 / 2 * 1e3)


@pytest.mark.parametrize("kind", ["no timeline", "no trace"])
def test_a_program_without_spans_reads_nothing(kind):
    """The parent program keeps no timeline and no span totals: each new
    reader reads nothing, and raises nothing."""
    run = _run(timeline=False) if kind == "no timeline" else _run(trace=False)
    if kind == "no timeline":
        del run.records[0].stats["spans"]
        run.records[0].traced = False
        assert registry.metric("decode_host_ms_per_token").read(run) is None
        run.records[0].traced = True
    for name in ("sampler_share", "prefill_attention_share", "device_idle_program.chat", "device_idle_program.rag"):
        assert registry.metric(name).read(run) is None
    assert program_spans.idle_by_name(run) == ({} if kind == "no trace" else {"outside": pytest.approx(320)})


def test_lags_from_the_harness_host_spans():
    host = [("prefill", 0, T_ENTER - 3e-6, T_ENTER + 1e-4), ("prefill", 0, T_ENTER + 2e-4, T_ENTER + 3e-4)]
    assert program_spans.lags(_run(), host) == [pytest.approx(3.0, abs=1e-3)]


def test_new_metrics_resolve_and_apply_only_to_their_cells():
    bench = registry.benchmark()
    chat, rag = "deepseek7b-q4_0.chat", "deepseek7b-q4_0.rag"
    new = {"decode_host_ms_per_token": chat, "sampler_share": chat, "prefill_attention_share": rag,
           "device_idle_program.chat": chat, "device_idle_program.rag": rag}
    for name, cell in new.items():
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [cell] and registry.metric(name).UNIT == entry["unit"]
        other = rag if cell == chat else chat
        assert name in {m["name"] for m in registry.metrics_of(cell, bench, True)}
        assert name not in {m["name"] for m in registry.metrics_of(other, bench, True)}
        assert name not in {m["name"] for m in registry.metrics_of(cell, bench, False)}
    assert registry.metric("device_idle_program.chat") is registry.metric("device_idle_program")


def test_t_enter_trails_the_harness_span_in_a_cpu_run(monkeypatch):
    """In a tiny run on the CPU, each request's ``t_enter`` comes within
    50 µs after the start of its first harness ``prefill`` span."""
    from benchmark import record, run, trace

    made, runs = [], []

    class Spans(trace.Spans):
        def __init__(self):
            super().__init__()
            made.append(self)

    class CapturedRun(record.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    monkeypatch.setattr(trace, "Spans", Spans)
    monkeypatch.setattr(record, "Run", CapturedRun)
    run.run_cell("deepseek7b-q4_0.chat", 2**31 + 11, 3.0, False, device="cpu", cfg=tiny.config(), mix=tiny.mix(),
                 limits=tiny.LIMITS, log=lambda *a: None)
    (r,) = runs
    host = [sp for s in made for sp in s.spans if sp[1] is not None]
    lags = program_spans.lags(r, host)
    assert len(lags) >= 2 and min(lags) >= 0
    assert statistics.median(lags) < 50


def test_spans_check_runs_on_the_cpu():
    from benchmark import spans_check

    out = spans_check.check("deepseek7b-q4_0.chat", 2**31 + 13, 4.0, device="cpu", cfg=tiny.config(),
                            mix=tiny.mix())
    assert out["timelines"] >= 1  # the profiler's flag is up under the harness's tracer
    assert out["decode_ms_per_token"]["untraced"] > 0 and out["prefill_ms"] > 0
    assert out["span_cost_us"]["none"] < out["span_cost_us"]["timeline"]
