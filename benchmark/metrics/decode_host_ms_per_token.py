"""The host's time a decoded token in the program's decode step: the
seconds in the runner's ``decode.step`` and ``decode.sample`` spans
(``stats["spans"]``: launching the forward and the sampler, never waiting
for the card) over ``generated_tokens``, summed over the requests that
finished in the window after the traced part.  Beside
``decode_ms_per_token``: the host sets the pace where the two meet."""

UNIT = "ms"


def read(run):
    recs = [r for r in run.untraced_finished() if "spans" in r.stats]
    toks = sum(r.stats["generated_tokens"] for r in recs)
    if not toks:
        return None
    s = sum(r.stats["spans"].get(name, (0, 0.0))[1] for r in recs for name in ("decode.step", "decode.sample"))
    return s / toks * 1e3
