"""The one traffic generator: a mix file's parameters and ``--seed`` in,
the cell's requests out.

Every seed draws the same set of sizes and differs only in their order and
in the prompts' token ids: each block of ``cycle`` requests takes the
``cycle`` evenly spaced prompt lengths of ``prompt_tokens`` and the ``cycle``
evenly spaced answer lengths of ``output_tokens``, each block in its own
seeded order.  Every ``greedy_every``-th request decodes greedily with the
mix's ``greedy_sampling`` (top-k 1, the defaults' repeat penalty kept, so
that its sampler does the same work), so that ``correct`` can hold its
tokens to the plain reference; the others sample with the mix's
``sampling``.

A prompt length counts the BOS token; a prompt's other ids are drawn from
``[3, n_vocab)``, past the special tokens.  The port has no EOS stop, so an
answer's length is its ``num_tokens``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

BOS = 1
FIRST_ID = 3


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: tuple  # token ids, BOS first
    n_predict: int
    greedy: bool
    sampler_seed: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


def grid(lo: int, hi: int, n: int) -> list:
    """``n`` evenly spaced whole lengths in ``[lo, hi]``: the midpoints of
    ``n`` equal strata."""
    return [lo + int(math.floor((hi - lo) * (i + 0.5) / n)) for i in range(n)]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def requests(mix: dict, seed: int, n_vocab: int) -> Iterator[Request]:
    """The cell's requests in the order the client sends them (endless)."""
    cycle = int(mix["cycle"])
    prompts, outputs = grid(*mix["prompt_tokens"], cycle), grid(*mix["output_tokens"], cycle)
    every = int(mix["greedy_every"])
    index = 0
    for block in range(2**31):
        order = _rng(seed, 1, block)
        p_order, o_order = order.permutation(cycle), order.permutation(cycle)
        for j in range(cycle):
            ids = _rng(seed, 2, index)
            n = prompts[p_order[j]]
            body = ids.integers(FIRST_ID, n_vocab, size=n - 1)
            yield Request(index=index, prompt=(BOS, *map(int, body)), n_predict=outputs[o_order[j]],
                          greedy=index % every == 0, sampler_seed=int(ids.integers(0, 2**31 - 1)))
            index += 1


def buckets(mix: dict, bucket: int) -> list:
    """The prefill buckets (prompt lengths padded up to a multiple of
    ``bucket``) that the mix's prompt lengths fall in, ascending."""
    return sorted({-(-p // bucket) * bucket for p in grid(*mix["prompt_tokens"], int(mix["cycle"]))})


def warmup_requests(mix: dict, bucket: int, seed: int, n_vocab: int) -> list:
    """One request for each prefill bucket the mix draws (the bucket's
    longest prompt that the mix can send) and a short answer; the first is
    greedy, the rest sample, so both sampler settings run once."""
    prompts = grid(*mix["prompt_tokens"], int(mix["cycle"]))
    out = []
    for k, b in enumerate(buckets(mix, bucket)):
        n = max(p for p in prompts if -(-p // bucket) * bucket == b)
        ids = _rng(seed, 3, k)
        out.append(Request(index=-1 - k, prompt=(BOS, *map(int, ids.integers(FIRST_ID, n_vocab, size=n - 1))),
                           n_predict=int(mix["warmup_output_tokens"]), greedy=k == 0,
                           sampler_seed=int(ids.integers(0, 2**31 - 1))))
    return out
