"""The port's span recorder (llama_swift_torch/utils/profiling.py ``span``,
``Recorder``, ``install``), the spans ``LlamaRunner`` records for each
request in ``stats`` (device="cpu", a tiny Q4_0 file), and the program
track that ``profiling.trace`` writes into its Chrome trace."""

import dataclasses
import json
import os
import threading
import time

import pytest
import torch

from llama_swift_torch.config import GGMLType, ModelConfig, RunnerConfig, SamplingConfig
from llama_swift_torch.formats import ggml
from llama_swift_torch.formats.quant import Q4_0Tensor
from llama_swift_torch.models import llama as model_lib
from llama_swift_torch.runtime.events import EventKind
from llama_swift_torch.runtime.runner import LlamaRunner
from llama_swift_torch.utils import profiling

N_TOKENS = 6
TOP = ("tokenize", "cache", "prefill", "prefill.read", "decode.setup", "decode.step", "decode.sample",
       "decode.read")
PREFILL_CHILDREN = ("prefill.qkv", "prefill.attention", "prefill.ffn", "prefill.output")


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def recorder():
    rec = profiling.Recorder()
    prev = profiling.install(rec)
    yield rec
    profiling.install(prev)


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(ModelConfig.tiny(), ftype=GGMLType.Q4_0)


@pytest.fixture(scope="module")
def runner(tmp_path_factory, cfg):
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v)
               for k, v in model_lib.random_params(cfg, seed=3).items()}
    pieces = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(32, 127)]
    pieces += [f"<x{i}>".encode() for i in range(cfg.n_vocab - len(pieces))]
    path = str(tmp_path_factory.mktemp("spans") / "tiny-q4_0.bin")
    ggml.write_model_file(path, cfg, pieces, tensors)
    return LlamaRunner(path, n_ctx=64, prefill_bucket=8, device="cpu")


def _config(device_sampling=True, n_tokens=N_TOKENS, chunk=4):
    return RunnerConfig(num_tokens=n_tokens, device_sampling=device_sampling, device_chunk=chunk,
                        sampling=SamplingConfig(seed=5, top_k=4))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_span_without_a_recorder_is_the_shared_null_context():
    assert profiling._state.recorder is None
    a, b = profiling.span("prefill"), profiling.span("decode.step")
    assert a is b is profiling.no_span("anything")
    with a:
        pass


def test_nested_spans_total_by_name(recorder):
    for _ in range(3):
        with profiling.span("outer"):
            with profiling.span("inner"):
                time.sleep(1e-3)
    assert recorder.spans["outer"][0] == 3 and recorder.spans["inner"][0] == 3
    assert recorder.spans["inner"][1] >= 3e-3
    assert recorder.spans["outer"][1] >= recorder.spans["inner"][1]
    assert recorder.timeline is None  # no profiler records


def test_a_span_records_when_its_body_raises(recorder):
    with pytest.raises(ValueError):
        with profiling.span("failing"):
            raise ValueError("x")
    assert recorder.spans["failing"][0] == 1


def test_timeline_under_a_cpu_profiler_has_parents(recorder):
    with profiling.span("before"):
        pass
    with _cpu_profile():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    with profiling.span("after"):
        pass
    tl = recorder.timeline
    assert [(n, p) for n, p, _, _ in tl] == [("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    for name, parent, t0, t1 in tl:
        assert t0 <= t1
        if parent >= 0:
            assert tl[parent][2] <= t0 and t1 <= tl[parent][3]
    assert set(recorder.spans) == {"before", "a", "b", "c", "d", "e", "after"}


def test_the_recorder_is_the_installing_threads_own(recorder):
    seen = []

    def other():
        seen.append(profiling._state.recorder)
        with profiling.span("elsewhere"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == [None] and "elsewhere" not in recorder.spans
    assert profiling.install(None) is recorder
    assert profiling.install(recorder) is None


# ---------------------------------------------------------------------------
# the runner's spans
# ---------------------------------------------------------------------------


def test_runner_records_every_span_of_a_request(runner, cfg):
    events = list(runner.run_events("the rain in", _config()))
    assert events[-1].kind is EventKind.COMPLETED
    spans = runner.stats["spans"]
    assert set(spans) == set(TOP) | set(PREFILL_CHILDREN)
    assert spans["decode.step"][0] == spans["decode.sample"][0] == runner.stats["generated_tokens"] == N_TOKENS
    assert spans["decode.read"][0] == 2  # two chunks of 4 for 6 tokens
    assert spans["prefill"][0] == spans["prefill.output"][0] == 1
    for child in PREFILL_CHILDREN[:3]:
        assert spans[child][0] == cfg.n_layer
    assert sum(spans[c][1] for c in PREFILL_CHILDREN) <= spans["prefill"][1]
    assert "timeline" not in runner.stats


def test_runner_keeps_its_stats_keys(runner):
    list(runner.run_events("the rain", _config()))
    s = runner.stats
    first = s["request"]
    for key in ("t_load_s", "t_prefill_s", "t_decode_s", "generated_tokens", "prompt_tokens",
                "decode_tok_per_s"):
        assert key in s
    assert s["decode_tok_per_s"] == pytest.approx(s["generated_tokens"] / s["t_decode_s"])
    assert s["spans"]["prefill.read"][1] <= s["t_prefill_s"]
    assert s["spans"]["decode.read"][1] <= s["t_decode_s"]
    t = time.perf_counter()
    list(runner.run_events("the rain", _config()))
    assert s is runner.stats and runner.stats["request"] == first + 1
    assert runner.stats["t_enter"] >= t


def test_spans_hold_no_consumer_time(runner):
    """No span encloses a ``yield``: a consumer that sleeps between events
    adds nothing to the spans, whose top-level total stays within the time
    spent inside the generator."""
    gen = runner.run_events("the rain in", _config())
    inside = 0.0
    while True:
        t0 = time.perf_counter()
        ev = next(gen, None)
        inside += time.perf_counter() - t0
        if ev is None:
            break
        assert profiling._state.recorder is None  # removed while the consumer runs
        time.sleep(2e-3)
    spans = runner.stats["spans"]
    assert sum(spans[n][1] for n in TOP) <= inside


def test_a_closed_request_leaves_no_recorder(runner):
    gen = runner.run_events("the rain", _config())
    for ev in gen:
        if ev.kind is EventKind.OUTPUT_TOKEN:
            break
    gen.close()
    assert profiling._state.recorder is None
    assert runner.stats["spans"]["prefill"][0] == 1 and "decode.step" not in runner.stats["spans"]


def test_a_failed_request_leaves_no_recorder(tmp_path):
    r = LlamaRunner(str(tmp_path / "missing.bin"), device="cpu")
    events = list(r.run_events("x", _config()))
    assert events[-1].kind is EventKind.FAILED
    assert profiling._state.recorder is None and r.stats["spans"] == {}


def test_host_sampling_records_a_step_per_token_after_the_first(runner):
    list(runner.run_events("the rain in", _config(device_sampling=False)))
    spans = runner.stats["spans"]
    assert spans["decode.sample"][0] == N_TOKENS
    assert spans["decode.step"][0] == spans["decode.read"][0] == N_TOKENS - 1


def test_runner_timeline_only_while_a_profiler_records(runner):
    with _cpu_profile():
        list(runner.run_events("the rain in", _config()))
    tl = runner.stats["timeline"]
    names = [e[0] for e in tl]
    assert set(names) == set(TOP) | set(PREFILL_CHILDREN)
    for name, parent, t0, t1 in tl:
        assert runner.stats["t_enter"] <= t0 <= t1
        if name in PREFILL_CHILDREN:
            assert tl[parent][0] == "prefill"
        else:
            assert parent == -1
    list(runner.run_events("the rain in", _config()))
    assert "timeline" not in runner.stats


def test_batch_one_forward_records_nothing(runner, recorder):
    runner.ensure_loaded()
    c = runner.config
    cache = model_lib.init_cache(c, device="cpu")
    model_lib.decode_step(runner.params, torch.tensor(5), 0, cache, c)
    assert recorder.spans == {}
    model_lib.prefill(runner.params, torch.tensor([1, 5, 6, 7]), 0, cache, c)
    assert recorder.spans["prefill.attention"][0] == c.n_layer


# ---------------------------------------------------------------------------
# the exporter's program track
# ---------------------------------------------------------------------------


def _program_events(d):
    (name,) = os.listdir(d)
    with open(d / name) as f:
        events = json.load(f)["traceEvents"]
    track = [e for e in events if e.get("cat") == "program_span"]
    meta = [e for e in events if e.get("ph") == "M" and (e.get("args") or {}).get("name") == profiling.PROGRAM_TRACK]
    return track, meta


def test_trace_writes_the_requests_spans_as_a_track(runner, tmp_path):
    list(runner.run_events("warm", _config()))
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        list(runner.run_events("the rain in", _config()))
    track, meta = _program_events(d)
    assert len(meta) == 1 and all(e["tid"] == meta[0]["tid"] for e in track)
    assert {e["name"] for e in track} == set(TOP) | set(PREFILL_CHILDREN)
    (prefill,) = [e for e in track if e["name"] == "prefill"]
    for e in track:
        if e["name"] in PREFILL_CHILDREN:
            assert e["args"]["parent"] == "prefill"
            assert prefill["ts"] <= e["ts"] and e["ts"] + e["dur"] <= prefill["ts"] + prefill["dur"] + 1e-3
        else:
            assert e["args"]["parent"] is None
    steps = sorted(e["ts"] for e in track if e["name"] == "decode.step")
    assert len(steps) == N_TOKENS and prefill["ts"] + prefill["dur"] <= steps[0]


def test_trace_records_calls_outside_a_request(runner, tmp_path):
    runner.ensure_loaded()
    c = runner.config
    cache = model_lib.init_cache(c, device="cpu")
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        model_lib.prefill(runner.params, torch.tensor([1, 5, 6, 7]), 0, cache, c)
    assert profiling._state.recorder is None
    track, _ = _program_events(d)
    assert sorted({e["name"] for e in track}) == sorted(PREFILL_CHILDREN)
    assert sum(e["name"] == "prefill.qkv" for e in track) == c.n_layer
