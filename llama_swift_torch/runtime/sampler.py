"""Token sampler — exact semantics of ``llama_sample_top_p_top_k``
(``Sources/cpp/utils.cpp:333-428``), the complete sampling stack of the
reference framework.

Pipeline (order matters, all in float64 like the reference's ``double``):

1. scale every logit by ``1/temp``;
2. CTRL-paper repetition penalty on tokens present in the last-n ring: if the
   *raw* logit < 0, multiply the scaled value by ``repeat_penalty``, else
   divide (``utils.cpp:364-370`` — note the penalty applies to the already
   temperature-scaled value);
3. top-k: keep the k largest (``std::partial_sort`` descending,
   ``utils.cpp:333-343``; ties broken here by lower id for determinism —
   the C++ comparator leaves tie order unspecified);
4. softmax over the survivors with max-subtraction (``:379-398``);
5. top-p: truncate at the first index where the cumulative probability
   reaches ``top_p`` (*inclusive*), renormalize (``:400-415``);
6. draw from the resulting categorical (``std::discrete_distribution``,
   ``:424-427``).

The default RNG is a counted numpy Generator: distribution parity with the
reference is the goal there, and is tested.  ``rng_impl="mt19937"`` draws
through the port's native sampler (``native/ggml_io.cpp``: a true
``std::mt19937`` and ``std::discrete_distribution``), the reference's RNG
stream; it falls back to the numpy Generator only when the native library
cannot build (no C++ compiler).

A copy of ``llama_swift_tpu/runtime/sampler.py``; the same seed draws the
same tokens in both packages, host sampler for host sampler.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np

from ..config import SamplingConfig


def sample_top_p_top_k(
    logits: np.ndarray,
    last_n_tokens: Sequence[int],
    *,
    repeat_penalty: float,
    top_k: int,
    top_p: float,
    temp: float,
    rng: np.random.Generator,
    return_probs: bool = False,
):
    """Sample one token id from ``logits [n_vocab] f32``."""
    logits = np.asarray(logits, dtype=np.float64)
    n = logits.shape[0]
    scale = 1.0 / float(temp)
    scaled = logits * scale
    if last_n_tokens:
        pen_ids = np.fromiter(
            (t for t in set(last_n_tokens) if 0 <= t < n), dtype=np.int64
        )
        if pen_ids.size:
            raw = logits[pen_ids]
            scaled[pen_ids] = np.where(
                raw < 0.0,
                scaled[pen_ids] * repeat_penalty,
                scaled[pen_ids] / repeat_penalty,
            )

    k = min(int(top_k), n)
    # descending by value; ties -> lower id (deterministic; C++ unspecified)
    order = np.lexsort((np.arange(n), -scaled))[:k]
    vals = scaled[order]

    maxl = vals[0] if k else -np.inf
    probs = np.exp(vals - maxl)
    probs /= probs.sum()

    if top_p < 1.0:
        cum = np.cumsum(probs)
        cut = int(np.searchsorted(cum, top_p, side="left")) + 1  # inclusive
        cut = min(cut, probs.shape[0])
        probs = probs[:cut] / cum[cut - 1]
        order = order[:cut]

    idx = rng.choice(probs.shape[0], p=probs / probs.sum())
    token = int(order[idx])
    if return_probs:
        return token, order, probs
    return token


@dataclasses.dataclass
class SamplerState:
    """Per-stream sampling state: the last-n ring buffer + RNG.

    The reference initializes the ring to ``repeat_last_n`` ZEROS
    (``LlamaPredictOperation.mm:827-829``) — so token id 0 is penalized until
    flushed; prompt tokens are pushed as they are consumed
    (``:884-885``) and sampled tokens after each draw (``:869-870``).
    Replicated exactly.
    """

    config: SamplingConfig
    rng: np.random.Generator = None  # type: ignore[assignment]
    ring: deque = None  # type: ignore[assignment]
    _native = None

    def __post_init__(self):
        seed = self.config.seed
        if seed is None or (isinstance(seed, int) and seed < 0):
            # reference: seed=-1 → mt19937((uint32)-1), i.e. fixed
            seed = 0xFFFFFFFF if seed == -1 else None
        if self.rng is None:
            self.rng = np.random.default_rng(seed)
        if self.config.rng_impl == "mt19937":
            from ..native import bindings as nb

            if nb.available():
                import secrets

                self._native = nb.NativeSampler(
                    seed if seed is not None else secrets.randbits(32)
                )
        if self.ring is None:
            self.ring = deque(
                [0] * self.config.repeat_last_n, maxlen=max(1, self.config.repeat_last_n)
            )

    def observe(self, token_id: int) -> None:
        """Push a consumed prompt token into the ring."""
        self.ring.append(token_id)

    def sample(self, logits: np.ndarray) -> int:
        c = self.config
        if self._native is not None:
            token = self._native.sample(
                np.asarray(logits, dtype=np.float32), list(self.ring),
                repeat_penalty=c.repeat_penalty, top_k=c.top_k, top_p=c.top_p,
                temp=c.temp,
            )
        else:
            token = sample_top_p_top_k(
                logits,
                list(self.ring),
                repeat_penalty=c.repeat_penalty,
                top_k=c.top_k,
                top_p=c.top_p,
                temp=c.temp,
                rng=self.rng,
            )
        self.ring.append(token)
        return token


def greedy(logits: np.ndarray) -> int:
    """Argmax decode (used by benches/ppl; not a reference mode — the
    reference always samples)."""
    return int(np.argmax(np.asarray(logits)))
