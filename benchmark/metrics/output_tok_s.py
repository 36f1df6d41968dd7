"""Generated tokens delivered to the client inside the window, over the
window's seconds; tokens of a request still running at the close count."""

UNIT = "tokens/s"


def read(run):
    return sum(len(r.tokens) for r in run.records) / run.window_s
