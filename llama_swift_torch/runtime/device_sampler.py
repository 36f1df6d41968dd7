"""On-device sampling: ``llama_sample_top_p_top_k`` semantics as torch ops
(counterpart of ``llama_swift_tpu/runtime/device_sampler.py``).

The reference samples on the host between every ``llama_eval``
(``LlamaPredictOperation.mm:851-877`` → ``utils.cpp:333-428``).  Here the
pipeline runs on the logits' device, so :func:`sampled_decode_loop` chains
forward and sampling for N tokens with no device-to-host copy between them:

1. scale logits by 1/temp;
2. CTRL repetition penalty for ids in the last-n ring: scaled value ×penalty
   if the RAW logit < 0 else ÷penalty (``utils.cpp:364-370``);
3. top-k by a stable descending sort (ties → lower id, as ``lax.top_k``);
4. softmax with max-subtraction over the k survivors (``:379-398``);
5. top-p: keep indices whose PRECEDING cumulative mass is < top_p,
   renormalize (``:400-415``);
6. inverse-CDF categorical draw from one uniform.

The RNG is a ``torch.Generator`` on the device: a stream of its own, next to
JAX's threefry and the host sampler's numpy Generator — distributions agree,
streams do not.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, SamplingConfig


def topk_topp_probs(
    logits: torch.Tensor,  # [V] f32 raw logits
    ring: torch.Tensor,  # [R] int64 last-n token ids (id 0 counts — .mm:827)
    *,
    top_k: int,
    top_p: float,
    temp: float,
    repeat_penalty: float,
    penalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (ids [k], probs [k]) — the truncated, renormalized categorical
    the reference draws from; probs beyond the top-p cut are exact zeros."""
    v = logits.shape[0]
    logits = logits.float()
    scaled = logits / temp
    if penalize:
        in_ring = torch.zeros(v, dtype=torch.bool, device=logits.device)
        in_ring[ring.clamp(0, v - 1)] = True
        pen = torch.where(logits < 0.0, scaled * repeat_penalty, scaled / repeat_penalty)
        scaled = torch.where(in_ring, pen, scaled)
    k = min(int(top_k), v)
    vals, ids = torch.sort(scaled, descending=True, stable=True)
    vals, ids = vals[:k], ids[:k]
    e = torch.exp(vals - vals[0])
    probs = e / e.sum()
    keep = (torch.cumsum(probs, 0) - probs) < top_p
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    return ids, probs / probs.sum()


def sample_token(
    logits: torch.Tensor,  # [V] f32
    ring: torch.Tensor,  # [R] int64
    generator: torch.Generator,
    scfg: SamplingConfig,
) -> torch.Tensor:
    """Draw one token id (0-d int64 tensor on the logits' device)."""
    ids, probs = topk_topp_probs(
        logits, ring,
        top_k=scfg.top_k, top_p=scfg.top_p, temp=scfg.temp,
        repeat_penalty=scfg.repeat_penalty, penalize=scfg.repeat_last_n > 0,
    )
    u = torch.rand((), generator=generator, device=logits.device)
    cum = torch.cumsum(probs, 0)
    idx = (u * cum[-1] >= cum).sum().clamp_max(probs.shape[0] - 1)
    return ids.gather(0, idx.reshape(1)).reshape(())  # gather: no host sync


def init_ring(prompt_ids, repeat_last_n: int, device) -> tuple[torch.Tensor, int]:
    """Last-n ring after prompt consumption: ``repeat_last_n`` zeros
    (``LlamaPredictOperation.mm:827-829``) with the prompt pushed in order,
    oldest first; returns (ring, pos) with ``pos`` the next slot to
    overwrite."""
    r = max(1, int(repeat_last_n))
    buf = [0] * r + [int(t) for t in prompt_ids]
    return torch.tensor(buf[-r:], dtype=torch.int64, device=device), 0


def sampled_decode_loop(
    params,
    last_token: torch.Tensor,  # 0-d int64: token whose forward gives the next logits
    n_past: int,  # its position
    cache,
    ring: torch.Tensor,  # [R] int64, updated in place
    ring_pos: int,  # next ring slot to overwrite (oldest entry)
    generator: torch.Generator,
    n_steps: int,
    cfg: ModelConfig,
    scfg: SamplingConfig,
):
    """Generate ``n_steps`` tokens: forward + sampling per step, tokens kept
    on the device.  Returns (tokens ``[n_steps]``, cache, ring, ring_pos)."""
    from ..models import llama as model_lib

    r = ring.shape[0]
    token = last_token.reshape(1)
    toks = []
    for i in range(n_steps):
        logits, cache = model_lib.forward(params, token, n_past + i, cache, cfg)
        nxt = sample_token(logits[0], ring, generator, scfg)
        ring[ring_pos] = nxt
        ring_pos = (ring_pos + 1) % r
        token = nxt.reshape(1)
        toks.append(token)
    return torch.cat(toks), cache, ring, ring_pos
