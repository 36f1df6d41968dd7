"""The whole decode step's share of the card's peak: the least time the
decoded tokens' work takes (for each step, every Q4_0 weight byte read once,
the K/V of positions up to its ``n_past`` read once and the new row written,
or its operations at the int8 rate, whichever is longer:
``counts.decode_step_bound_s``) over the runner's decode time, over the
requests that finished in the window after the traced part."""

UNIT = "%"


def read(run):
    recs = run.untraced_finished()
    t = sum(r.stats["t_decode_s"] for r in recs)
    if not t:
        return None
    bound = sum(run.counts.decode_step_bound_s(run.dims, n) for r in recs for n in r.decode_n_pasts())
    return 100.0 * bound / t
