import pytest

from benchmark import registry
from benchmark.record import Record, Run
from benchmark.trace import DeviceTrace


SPANS = [("prefill", 0, 0.0, 100e-6), ("decode", 0, 200e-6, 500e-6), ("stream", 0, 600e-6, 610e-6)]


def _trace(marker=True):
    """A trace whose marker kernel was launched at host time 1 ms: the
    host spans (seconds) land on the trace's clock (µs) unshifted."""
    return DeviceTrace(_events(marker), SPANS, marker_host=1e-3)


def _events(marker=True):
    ev = []

    def kernel(name, corr, launch_ts, ts, dur):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}})

    if marker:
        kernel("at::cuda::(anonymous namespace)::spin_kernel(long)", 9, 1000, 1001, 0.5)
    kernel("void dequant_kernel<bf16>", 1, 10, 20, 30)
    kernel("fused_layers_kernel", 2, 210, 220, 100)
    kernel("void at::native::sort", 3, 215, 330, 10)
    kernel("fused_layers_kernel", 4, 300, 350, 100)
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 450, "dur": 20})
    return ev


def test_ranges_kernels_busy_and_gaps():
    t = _trace()
    assert t.window() == (0, 610)
    assert t.busy_intervals() == [[20, 50], [220, 320], [330, 340], [350, 470]]
    assert t.busy_s() == pytest.approx(260e-6)
    ((r, ks),) = t.in_ranges("decode")
    assert r.request == 0 and [k.name for k in ks] == ["fused_layers_kernel", "void at::native::sort",
                                                       "fused_layers_kernel"]
    gaps = t.idle_gaps()
    assert gaps[0] == ["harness", pytest.approx(170e-6)]  # 50..220: after the prefill, before the decode
    assert t.top_ops(1) == [["fused_layers_kernel", pytest.approx(200e-6)]]


def test_no_marker_no_ranges():
    t = _trace(marker=False)
    assert t.window() is None and t.busy_s() == 0.0 and t.idle_gaps() == []


def test_trace_readers():
    cfg = registry.config("deepseek7b-q4_0")
    counts = registry.counts("llama")
    d = counts.dims(cfg)
    mix = dict(registry.traffic("chat"), device_chunk=32)
    rec = Record(0, 50, 2, True, 0.0)
    run = Run(cfg=cfg, mix=mix, counts=counts, dims=d, t_start=0, t_end=1, setup_s=1, records=[rec],
              trace=_trace())
    assert registry.metric("launches_per_token").read(run) == pytest.approx(3 / 2)
    bound = counts.megakernel_bound_s(d, 49) + counts.megakernel_bound_s(d, 50)
    assert registry.metric("megakernel_roofline").read(run) == pytest.approx(100 * bound / 200e-6)
    # one dequant launch is not a whole prefill's 4·L + 1: the reader reads nothing
    assert registry.metric("dequant_roofline").read(run) is None
    assert registry.metric("device_idle.chat").read(run) == pytest.approx(100 * (1 - 260 / 610))
