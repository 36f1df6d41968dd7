"""The runner's prefill time per request (``LlamaRunner.stats
["t_prefill_s"]``: the cache made, the padded prompt through every layer,
the last row's logits read back), over the requests that finished in the
window after the traced part."""

UNIT = "ms"


def read(run):
    recs = run.untraced_finished()
    return sum(r.stats["t_prefill_s"] for r in recs) / len(recs) * 1e3 if recs else None
