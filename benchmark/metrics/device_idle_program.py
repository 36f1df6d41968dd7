"""Share of the traced window in which the card was idle while a program
span was open (``benchmark/program_spans.py``: each idle instant given to
the innermost span open then), over the window and busy intervals of
``device_idle``.  The rest of ``device_idle`` is the harness's time and
the runner's between its spans.  One reader for each
``device_idle_program.<mix>`` entry."""

UNIT = "%"


def read(run):
    from benchmark import program_spans

    if run.trace is None or not run.trace.window_s() or not program_spans.offsets(run):
        return None
    idle = program_spans.idle_by_name(run)
    program = sum(us for name, us in idle.items() if name != program_spans.OUTSIDE)
    return 100.0 * program * 1e-6 / run.trace.window_s()
