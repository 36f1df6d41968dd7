"""Decode attention: the flash-decode kernel's wrapper (``csrc/flash_decode.cu``),
its plain version, and the unfused reference.

Counterpart of ``llama_swift_tpu/ops/attention.py`` (``flash_decode_attention``,
``flash_decode_attention_stacked``, ``reference_decode_attention``).  The
kernel reads one layer of the stacked head-major cache ``[L, H, n_ctx, Dh]``
in place and only its keys ``j <= n_past``; the note at the top of the CUDA
source says what bounds it on the H100.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: keys per split of the kernel's first pass (``CHUNK`` in the CUDA source)
SPLIT = 64


def reference_decode_attention(q, keys, values, n_past: int) -> torch.Tensor:
    """Unfused reference: q ``[H, Dh]``, keys/values ``[H, n_ctx, Dh]``;
    attends slots ``j <= n_past``.  Returns ``[H, Dh]`` f32."""
    h, n_ctx, dh = keys.shape
    s = torch.einsum("hd,hjd->hj", q.float(), keys.float()) / math.sqrt(float(dh))
    j = torch.arange(n_ctx, device=keys.device)[None, :]
    s = torch.where(j <= n_past, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hj,hjd->hd", p, values.float())


def flash_decode_attention_plain(q, k_cache, v_cache, il: int, n_past: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: softmax attention of q over the
    live keys ``0..n_past`` of layer ``il`` (the same scaling as the kernel:
    scores times ``1/sqrt(Dh)``)."""
    dh = q.shape[-1]
    keys = k_cache[il, :, : n_past + 1].float()
    values = v_cache[il, :, : n_past + 1].float()
    s = torch.einsum("hd,hjd->hj", q.float(), keys) * (1.0 / math.sqrt(float(dh)))
    return torch.einsum("hj,hjd->hd", torch.softmax(s, dim=-1), values)


def flash_decode_attention(q, k_cache, v_cache, il: int, n_past: int) -> torch.Tensor:
    """Single-query attention of ``q [H, Dh]`` f32 over layer ``il`` of the
    stacked caches ``[L, H, n_ctx, Dh]`` (f32 or bf16), keys ``j <= n_past``.
    Returns ``[H, Dh]`` f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, il, n_past)
    L, H, n_ctx, dh = k_cache.shape
    if not (q.is_cuda and k_cache.device == q.device and v_cache.device == q.device):
        raise ValueError("flash_decode_attention: q and the caches must be on the same CUDA device")
    if q.dtype != torch.float32 or q.shape != (H, dh) or not q.is_contiguous():
        raise ValueError(f"flash_decode_attention: q must be contiguous float32 [{H}, {dh}]")
    if k_cache.dtype not in (torch.float32, torch.bfloat16) or v_cache.dtype != k_cache.dtype:
        raise ValueError("flash_decode_attention: caches must both be float32 or both bfloat16")
    if v_cache.shape != k_cache.shape or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode_attention: caches must be contiguous and of one shape")
    if dh % 32 or not 32 <= dh <= 1024:
        raise ValueError(f"flash_decode_attention: head dim {dh} must be a multiple of 32 in [32, 1024]")
    if not (0 <= il < L and 0 <= n_past < n_ctx):
        raise ValueError(f"flash_decode_attention: il={il}, n_past={n_past} out of range")
    n_keys = n_past + 1
    splits = -(-n_keys // SPLIT)
    part = torch.empty(H * splits * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode(
        q.data_ptr(), k_cache[il].data_ptr(), v_cache[il].data_ptr(),
        part.data_ptr(), out.data_ptr(), H, n_ctx, dh, n_keys,
        1.0 / math.sqrt(float(dh)), int(k_cache.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    build.check(code, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
