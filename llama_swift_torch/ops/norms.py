"""Normalization ops (counterpart of ``llama_swift_tpu/ops/norms.py``).

The reference's ``ggml_norm`` is a *mean-centered* LayerNorm-style transform
without bias (eps=1e-5 hardcoded) — NOT RMSNorm (``Sources/cpp/ggml.c:5327-
5385``).  RMSNorm is also provided, selected by ``ModelConfig.norm_type``.
"""

from __future__ import annotations

import torch


def ggml_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``y = (x - mean) / sqrt(mean((x-mean)^2) + eps) * weight``, f32
    accumulation (the reference accumulates in f64; the difference is inside
    the parity tolerance)."""
    xf = x.float()
    centered = xf - xf.mean(dim=-1, keepdim=True)
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered / torch.sqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (later llama.cpp / LLaMA paper semantics)."""
    xf = x.float()
    y = xf / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def norm(x: torch.Tensor, weight: torch.Tensor, norm_type: str, eps: float = 1e-5) -> torch.Tensor:
    if norm_type == "layernorm":
        return ggml_norm(x, weight, eps)
    if norm_type == "rmsnorm":
        return rms_norm(x, weight, eps)
    raise ValueError(f"unknown norm_type {norm_type!r}")
