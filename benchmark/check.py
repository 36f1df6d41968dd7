"""``correct``: what the timed path served, held to the plain reference.

Once the window has closed and the port's state is freed, a sample of the
greedy requests that finished inside the window, drawn from the seed with
the longest of them in it, goes through the reference
(``benchmark/reference/<family>.py``): each request's prompt and served
tokens in one forward.  Greedy requests keep the mix's repeat penalty (top-k
1 takes the best logit after it), so the reference's logits at each
position take the same penalty, over the same last tokens, before they are
compared.  A served token's gap is how far the f32 reference's penalized
logit of it lies below the reference's best penalized logit at that
position.

The model's products take 4-bit activation codes, and a code flips where a
rounding difference carries its input across a quantization boundary;
the flip moves the next products by a whole step, which flips more codes.
So two sound f32 computations of the same tokens drift apart within a
layer or two: the reference's tokens and those of a second sound path
(the same reference computed in float64) disagree on ~80 % of the
positions at 30 layers, as the port's do, with gaps up to ~3 logits.
No single gap, and no gap of a sound run alone, tells a fault from that.
What a sound port shares with the second sound path is the mean of its
gaps; a lower precision, a stale cache or a wrong token raises it.  So:

* ``mean_gap_excess``: the mean gap of the served tokens minus the mean
  gap, at the same positions, of the tokens the second sound path puts
  first;
* ``echo_mismatches``, ``short_answers``, ``unknown_tokens``,
  ``failed_requests`` (exact, limit 0): a prompt echoed otherwise than sent,
  a finished request with fewer or more tokens than asked, a token event
  that is no piece of the vocabulary, a request that failed.

Each number's limit is in ``benchmark/limits/<workload>.json``.
:func:`judged` with ``control`` gives the control's readings: the
reference computed in bf16 in the port's place, the token it puts first at
each position judged by the f32 reference.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("mean_gap_excess",)
EXACT = ("echo_mismatches", "short_answers", "unknown_tokens", "failed_requests")


def sample(records: list, mix: dict, seed: int) -> list:
    """Finished greedy requests: the longest answer first, then others in a
    seeded order until ``check_tokens`` served tokens or
    ``check_max_requests`` requests."""
    done = [r for r in records if r.finished and r.greedy]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.tokens), r.index))
    rest = [done[i] for i in np.random.default_rng([int(seed) & (2**64 - 1), 7]).permutation(len(done) - 1) + 1]
    out, n = [done[0]], len(done[0].tokens)
    for r in rest:
        if n >= int(mix["check_tokens"]) or len(out) >= int(mix["check_max_requests"]):
            break
        out.append(r)
        n += len(r.tokens)
    return out


def sequences(ref_mod, recs: list, prompts: dict) -> list:
    """The reference's view of each sampled request: prompt then served
    tokens but the last; the first served token's logits sit at the
    prompt's last row; rows before it only a prefill computes."""
    seqs = []
    for r in recs:
        p = list(prompts[r.index])
        seqs.append(ref_mod.Sequence(p + r.tokens[:-1], len(p) - 1, len(p) - 1))
    return seqs


def gaps(logits: torch.Tensor, chosen) -> torch.Tensor:
    """Per position, how far the logit of the chosen token lies below the
    best logit."""
    chosen = torch.as_tensor(chosen, device=logits.device).long()
    return logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]


def penalized(logits: torch.Tensor, seq, penalty: float, last_n: int) -> torch.Tensor:
    """``logits`` ``[n, V]`` of a sequence's rows ``first..`` under the
    repeat penalty that a greedy request's sampler applies (temperature 1):
    an id among the ``last_n`` tokens before the row (the ring starts as
    ``last_n`` zeros, then the prompt and the served tokens) has its logit
    divided by ``penalty`` where it is not negative and multiplied by it
    where it is."""
    if last_n <= 0:
        return logits
    n = logits.shape[0]
    hist = torch.tensor([0] * last_n + list(seq.tokens), dtype=torch.int64, device=logits.device)
    rings = hist.unfold(0, last_n, 1)[seq.first + 1 : seq.first + 1 + n]
    hit = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device).scatter_(1, rings, True)
    return torch.where(hit, torch.where(logits < 0, logits * penalty, logits / penalty), logits)


def greedy_penalty(sampling: dict) -> tuple:
    """(penalty, last_n) of a mix's ``greedy_sampling``, which has to take
    the best logit (top-k 1)."""
    if int(sampling["top_k"]) != 1:
        raise ValueError("correct compares greedy tokens: greedy_sampling needs top_k 1")
    return float(sampling["repeat_penalty"]), int(sampling["repeat_last_n"])


def judged(ref_mod, cfg, seed, device, recs, prompts, sampling: dict, prefill_bf16=None,
           control: bool = False) -> dict:
    """Penalized gaps under the f32 reference, per request: ``served`` of the
    served tokens, ``baseline`` of the tokens the second sound path (the
    reference in float64) puts first, and with ``control`` ``control`` of
    the tokens the bf16 reference puts first.  ``sampling`` is the mix's
    ``greedy_sampling``."""
    penalty, last_n = greedy_penalty(sampling)
    seqs = sequences(ref_mod, recs, prompts)
    others = {"baseline": ref_mod.Reference(cfg, seed, device, dtype=torch.float64, prefill_bf16=prefill_bf16)}
    if control:
        others["control"] = ref_mod.Reference(cfg, seed, device, dtype=torch.bfloat16)
    chosen = {name: [penalized(lg, s, penalty, last_n).argmax(dim=-1) for lg, s in zip(r.logits(seqs), seqs)]
              for name, r in others.items()}
    ref = ref_mod.Reference(cfg, seed, device, prefill_bf16=prefill_bf16)
    out = {"served": [], **{name: [] for name in chosen}}
    for i, (r, s, lg) in enumerate(zip(recs, seqs, ref.logits(seqs))):
        lg = penalized(lg, s, penalty, last_n)
        out["served"].append(gaps(lg, r.tokens).cpu())
        for name, c in chosen.items():
            out[name].append(gaps(lg, c[i]).cpu())
        del lg
    return out


def numbers(served: list, baseline: list) -> dict:
    """The compared ``mean_gap_excess`` of ``served`` over ``baseline`` gaps,
    and readings beside it."""
    if not served:
        return {}
    g, b = torch.cat(served).double(), torch.cat(baseline).double()
    return {"mean_gap_excess": float(g.mean() - b.mean()), "mean_gap": float(g.mean()),
            "baseline_mean_gap": float(b.mean()), "widest_gap": float(g.max()),
            "baseline_widest_gap": float(b.max()), "mismatch_share": float((g > 0).double().mean()),
            "tokens": int(g.numel())}


def exact_counts(records: list, prompts: dict, failed: int) -> dict:
    fin = [r for r in records if r.finished]
    return {
        "echo_mismatches": sum(1 for r in records if r.echo != list(prompts[r.index])[: len(r.echo)]
                               or (r.finished and len(r.echo) != len(prompts[r.index]))),
        "short_answers": sum(1 for r in fin if len(r.tokens) != r.n_predict),
        "unknown_tokens": sum(1 for r in records for t in r.tokens if t < 0),
        "failed_requests": failed,
    }


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every exact count 0 and every
    number of ``limits`` at or under its limit; a number with no reading
    fails."""
    shown, ok = {}, True
    for name in EXACT:
        shown[name] = {"value": values.get(name), "limit": 0}
        ok = ok and values.get(name) == 0
    for name in NUMBERS:
        if name in limits:
            v = values.get(name)
            shown[name] = {"value": v, "limit": limits[name]}
            ok = ok and v is not None and v <= limits[name]
    if not any(n in limits for n in NUMBERS):
        ok = False
    return ok, shown
