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

The engine draws one token per slot in one call
(:func:`sample_tokens_batched`, the JAX engine's vmapped
``sample_token_dyn``): per-slot temp/top_p/penalty tensors and rings, a
shared top_k and penalize flag.

The RNG is a ``torch.Generator`` on the device: a stream of its own, next to
JAX's threefry and the host sampler's numpy Generator — distributions agree,
streams do not.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, SamplingConfig


def _per_row(v):
    """A per-slot parameter: a python float, or a ``[B]`` tensor made to
    broadcast against ``[B, V]``."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def topk_topp_probs_batched(
    logits: torch.Tensor,  # [B, V] raw logits
    rings: torch.Tensor,  # [B, R] int64 last-n token ids per slot
    *,
    top_k: int,
    top_p,
    temp,
    repeat_penalty,
    penalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (ids ``[B, k]``, probs ``[B, k]``): the truncated,
    renormalized categorical each slot draws from.  ``top_p``, ``temp`` and
    ``repeat_penalty`` are floats or ``[B]`` f32 tensors (per-slot values,
    as the JAX engine passes them under ``vmap``); ``top_k`` and
    ``penalize`` are shared."""
    b, v = logits.shape
    logits = logits.float()
    scaled = logits / _per_row(temp)
    if penalize:
        in_ring = torch.zeros((b, v), dtype=torch.bool, device=logits.device)
        in_ring.scatter_(1, rings.clamp(0, v - 1), True)
        rp = _per_row(repeat_penalty)
        pen = torch.where(logits < 0.0, scaled * rp, scaled / rp)
        scaled = torch.where(in_ring, pen, scaled)
    k = min(int(top_k), v)
    vals, ids = torch.sort(scaled, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    e = torch.exp(vals - vals[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    keep = (torch.cumsum(probs, -1) - probs) < _per_row(top_p)
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    return ids, probs / probs.sum(dim=-1, keepdim=True)


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
    ids, probs = topk_topp_probs_batched(
        logits[None], ring[None], top_k=top_k, top_p=top_p, temp=temp,
        repeat_penalty=repeat_penalty, penalize=penalize,
    )
    return ids[0], probs[0]


def _draw(ids: torch.Tensor, probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Inverse-CDF draw of one id per row of ``probs [B, k]``, one uniform
    each; stays on the device (gather, no host read)."""
    u = torch.rand((probs.shape[0], 1), generator=generator, device=probs.device)
    cum = torch.cumsum(probs, -1)
    idx = (u * cum[:, -1:] >= cum).sum(-1, keepdim=True).clamp_max(probs.shape[1] - 1)
    return ids.gather(1, idx)[:, 0]


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
    return _draw(ids[None], probs[None], generator).reshape(())


def sample_tokens_batched(
    logits: torch.Tensor,  # [B, V]
    rings: torch.Tensor,  # [B, R] int64
    generator: torch.Generator,
    *,
    top_k: int,
    penalize: bool,
    temps: torch.Tensor,  # [B] f32
    top_ps: torch.Tensor,  # [B] f32
    penalties: torch.Tensor,  # [B] f32
) -> torch.Tensor:
    """One draw per slot with the slot's own temp/top_p/penalty and ring
    (counterpart of ``sample_token_dyn`` as vmapped by the JAX engine's
    ``batched_decode_sampled``); returns ``[B]`` int64 on the device."""
    ids, probs = topk_topp_probs_batched(
        logits, rings, top_k=top_k, top_p=top_ps, temp=temps,
        repeat_penalty=penalties, penalize=penalize,
    )
    return _draw(ids, probs, generator)


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
