"""Perplexity evaluation harness (the port's counterpart of
``llama_swift_tpu/utils/perplexity.py``).

Protocol of llama.cpp's classic ``perplexity`` tool, so numbers are
comparable:

* tokenize the whole corpus; split it into non-overlapping windows of
  ``n_ctx`` tokens, each starting from BOS;
* one full-logits prefill per window; the NLL of the tokens in the second
  half of each window (positions n_ctx/2 .. n_ctx-1), conditioned on the
  first half, summed in float64;
* ppl = exp(mean NLL).

The model runs wherever its params live (the card, or the CPU with the
kernels' plain versions).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models import llama as model_lib
from ..tokenizer import BOS_TOKEN_ID


def window_nll(logits: torch.Tensor, targets: torch.Tensor, first_scored: int) -> float:
    """Σ −log p(target) over positions [first_scored-1, n-1) of one window:
    ``logits[i]`` predicts ``targets[i]``; log-softmax on the logits'
    device, one host read per window."""
    lp = torch.log_softmax(logits[first_scored - 1 :].float(), dim=-1)
    picked = lp.gather(-1, targets[first_scored - 1 :, None].long())[:, 0]
    return -float(picked.double().sum())


def perplexity(params, cfg: ModelConfig, token_ids: np.ndarray, *, progress=None,
               window_seconds: Optional[list] = None) -> dict:
    """Perplexity over ``token_ids`` with non-overlapping ``cfg.n_ctx``
    windows, scoring the second half of each.  ``window_seconds``, when
    given, collects each window's time (prefill and scoring, ended by the
    host read of its NLL).  Returns {"ppl", "nll", "n_scored"}."""
    n_ctx = cfg.n_ctx
    first_scored = n_ctx // 2
    ids = np.asarray(token_ids, dtype=np.int64)
    n_windows = len(ids) // n_ctx
    if n_windows == 0:
        raise ValueError(f"need at least n_ctx={n_ctx} tokens, got {len(ids)}")
    device = params["norm"].device
    total_nll, n_scored = 0.0, 0
    for w in range(n_windows):
        t0 = time.perf_counter()
        chunk = ids[w * n_ctx : (w + 1) * n_ctx].copy()
        chunk[0] = BOS_TOKEN_ID  # each window starts from BOS, llama.cpp-style
        cache = model_lib.init_cache(cfg, device=device)
        logits, _ = model_lib.prefill(params, torch.as_tensor(chunk, device=device), 0, cache, cfg)
        targets = torch.as_tensor(np.roll(chunk, -1), device=device)  # logits[i] predicts chunk[i+1]
        total_nll += window_nll(logits[: n_ctx - 1], targets[: n_ctx - 1], first_scored)
        n_scored += n_ctx - first_scored
        if window_seconds is not None:
            window_seconds.append(time.perf_counter() - t0)
        if progress:
            progress(w + 1, n_windows, math.exp(total_nll / n_scored))
    return {"ppl": math.exp(total_nll / n_scored), "nll": total_nll / n_scored, "n_scored": n_scored}
