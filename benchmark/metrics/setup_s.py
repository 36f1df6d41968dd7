"""Process start to the first timed request: imports, the model made on the
card, the kernels' build on a checkout's first run, the warm-up."""

UNIT = "s"


def read(run):
    return run.setup_s
