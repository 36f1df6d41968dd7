"""Prefill's share of the card's bf16 peak: the FLOPs the prompts need (the
layers' products on the real prompt tokens, not the padding; causal
attention over each row's keys; the last row's output projection:
``counts.prefill_flops``) at 989 TFLOP/s, over the runner's prefill time,
over the requests that finished in the window after the traced part."""

from benchmark import peaks

UNIT = "%"


def read(run):
    recs = run.untraced_finished()
    t = sum(r.stats["t_prefill_s"] for r in recs)
    if not t:
        return None
    flops = sum(run.counts.prefill_flops(run.dims, r.prompt_len) for r in recs)
    return 100.0 * flops / peaks.BF16_FLOPS / t
