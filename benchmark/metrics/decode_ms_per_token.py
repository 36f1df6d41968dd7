"""The runner's decode time per generated token (``LlamaRunner.stats``:
``t_decode_s`` over ``generated_tokens``), summed over the requests that
finished in the window after the traced part."""

UNIT = "ms"


def read(run):
    recs = run.untraced_finished()
    toks = sum(r.stats["generated_tokens"] for r in recs)
    return sum(r.stats["t_decode_s"] for r in recs) / toks * 1e3 if toks else None
