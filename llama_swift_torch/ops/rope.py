"""Rotary position embedding, adjacent-pair convention (counterpart of
``llama_swift_tpu/ops/rope.py``).

Matches ``ggml_compute_forward_rope_f32`` (``Sources/cpp/ggml.c:7076-7131``):
pairs are *adjacent* dims ``(2j, 2j+1)``, angle ``theta_j =
10000^(-2j/n_dims)``, rotation ``(x0 cos - x1 sin, x0 sin + x1 cos)`` at
position ``p``.  Keys are rotated once, before they enter the cache.
"""

from __future__ import annotations

import torch


def rope(x: torch.Tensor, positions: torch.Tensor, n_dims: int) -> torch.Tensor:
    """x ``[N, H, D]`` (positions along axis -3), positions ``[N]``; rotates
    the first ``n_dims`` head dims (the model passes the full head dim: the
    file's ``n_rot`` is ignored, ``LlamaPredictOperation.mm:528``)."""
    D = x.shape[-1]
    assert n_dims % 2 == 0 and n_dims <= D
    xr = x[..., :n_dims]
    x0 = xr[..., 0::2].float()
    x1 = xr[..., 1::2].float()
    inv_freq = torch.pow(
        torch.tensor(10000.0, dtype=torch.float32, device=x.device),
        -torch.arange(0, n_dims, 2, dtype=torch.float32, device=x.device) / float(n_dims),
    )
    ang = positions.float()[:, None] * inv_freq[None, :]  # [N, n_dims/2]
    ang = ang.unsqueeze(-2)  # broadcast over heads: [N, 1, n_dims/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    rot = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    rot = rot.reshape(xr.shape).to(x.dtype)
    if n_dims == D:
        return rot
    return torch.cat([rot, x[..., n_dims:]], dim=-1)
