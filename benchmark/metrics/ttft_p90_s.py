"""The 90th percentile, over every request sent in the window, of the time
from sending it to its first generated token's event (the prompt's echo
and the first decode chunk included).  A request with no generated token
by the close counts with the time it has waited."""

from benchmark.record import percentile

UNIT = "s"


def read(run):
    return percentile([(r.t_first if r.t_first is not None else run.t_end) - r.t_send for r in run.records], 90)
