"""Share of the traced window in which no kernel, copy or set ran on the card
(the profiler's device intervals, merged).  One reader for each
``device_idle.<mix>`` entry: the quantity is split by the end-to-end metric
it moves."""

UNIT = "%"


def read(run):
    if run.trace is None or not run.trace.window_s():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
