"""Profiling and introspection (the port's counterpart of
``llama_swift_tpu/utils/profiling.py``): the observability the reference
stubs out (ggml's ``GGML_PERF`` counters, ``ggml_graph_print``,
``ggml_graph_dump_dot``, ``ggml.c:9514-9750``).

* :func:`trace` — a ``torch.profiler`` trace of a region, CPU activity and,
  when a card is present, CUDA activity, exported as a Chrome trace (the
  JAX package's ``jax.profiler`` trace).
* :func:`graph_summary` — what a call costs: ``flops`` from
  ``torch.utils.flop_counter.FlopCounterMode``, the port's kernel launches
  during the call (the ``ops.launch_counts()`` delta) and, on the card, the
  peak device memory.  It stands in for XLA's cost and memory analysis.
* :func:`dump_hlo` — the aten graph of a call, traced by
  ``torch.fx.experimental.proxy_tensor.make_fx`` on real tensors.  It stands
  in for XLA's HLO text.
* :class:`StepTimer` — host-side tokens/s and TTFT accounting for a
  generation run, as in the JAX package.

The port's own kernels are ``ctypes`` calls that PyTorch does not see: they
count no flops and leave no node in the aten graph (only the ``torch.empty``
of their outputs does).  They show up in ``graph_summary``'s launch counts,
and in a trace as their CUDA kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region; its Chrome trace (viewable in Perfetto) is
    written to ``log_dir/trace-<pid>-<ns>.json`` when the region ends.
    Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def graph_summary(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return {"flops", "kernel_launches"
    (the port's kernels launched by the call, by wrapper), and on the card
    "peak_memory_bytes"}."""
    from torch.utils.flop_counter import FlopCounterMode

    from .. import ops

    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    out = {
        "flops": counter.get_total_flops(),
        "kernel_launches": {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]},
    }
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


class StepTimer:
    """tokens/s + TTFT accounting for a generation run."""

    def __init__(self):
        self.t_start: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last: Optional[float] = None
        self.decode_tokens = 0

    def start(self):
        self.t_start = time.perf_counter()
        return self

    def first_token(self):
        if self.t_first_token is None:
            self.t_first_token = time.perf_counter()

    def tick(self, n: int = 1):
        self.first_token()
        self.decode_tokens += n
        self.t_last = time.perf_counter()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_start is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_start

    @property
    def decode_tok_per_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_last is None:
            return None
        dt = self.t_last - self.t_first_token
        if dt <= 0 or self.decode_tokens <= 1:
            return None
        return (self.decode_tokens - 1) / dt

    def summary(self) -> dict:
        return {
            "ttft_s": self.ttft_s,
            "decode_tok_per_s": self.decode_tok_per_s,
            "decode_tokens": self.decode_tokens,
        }
