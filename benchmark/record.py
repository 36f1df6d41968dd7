"""What one run saw: each request's times and tokens, the window, the set-up
time and (with ``--trace 1``) the device trace.  The metric readers
(``benchmark/metrics/*.py``) read a :class:`Run`."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Record:
    index: int
    prompt_len: int
    n_predict: int
    greedy: bool
    t_send: float
    t_first: Optional[float] = None  # first generated token delivered
    t_done: Optional[float] = None  # every token delivered inside the window
    tokens: list = dataclasses.field(default_factory=list)  # generated ids delivered inside the window
    echo: list = dataclasses.field(default_factory=list)
    stats: Optional[dict] = None  # the runner's counters, once finished
    traced: bool = False

    @property
    def finished(self) -> bool:
        return self.t_done is not None

    def decode_n_pasts(self, chunk_start: int = 0, steps: int = None) -> range:
        """Positions of the decode steps: the first step evaluates the
        prompt's last position again (``n_past = prompt_len − 1``)."""
        n = self.n_predict if steps is None else steps
        first = self.prompt_len - 1 + chunk_start
        return range(first, first + n)


@dataclasses.dataclass
class Run:
    cfg: dict
    mix: dict
    counts: object  # benchmark.counts.<family>
    dims: object
    t_start: float
    t_end: float
    setup_s: float
    records: list
    trace: object = None  # trace.DeviceTrace of the traced window

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def untraced_finished(self) -> list:
        """Requests that finished inside the window outside the traced part:
        the ones whose runner counters stand for an untraced run."""
        return [r for r in self.records if r.finished and not r.traced and r.stats]

    def by_index(self) -> dict:
        return {r.index: r for r in self.records}


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0–100) by linear interpolation between the
    sorted values (numpy's default, ``statistics.quantiles``' inclusive)."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
