"""Q4_0 → dense dequantization for prefill: the wrapper of the CUDA kernel
``csrc/q4_dequant.cu`` and its plain version.

Counterpart of ``llama_swift_tpu/ops/q4_dequant_pallas.py``
(``q4v_dequant_pm`` / ``q4v_dequant_pm_stacked``) and of
``dequantize_q4_0_jnp`` in ``llama_swift_tpu/ops/quantized_matmul.py``.  The
dense matrix is in logical column order; the result is bit-identical to the
plain version (one f32 product per element, then round-to-nearest-even to
bf16 when asked).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import QK
from . import build
from .q4_matvec import Q4_0Weight, unpack_nibbles


def dequantize_q4_0(w: Q4_0Weight, dtype=torch.float32) -> torch.Tensor:
    """Plain unpack + dequantize of a Q4_0 weight ``[rows, in]``:
    ``(n − 8)·d`` (``ggml.c:650-687``)."""
    rows, in_dim = w.shape
    vals = unpack_nibbles(w.qs).float() - 8.0
    vals = vals.reshape(rows, in_dim // QK, QK) * w.d[:, :, None].float()
    return vals.reshape(rows, in_dim).to(dtype)


def q4_0_dequant(w: Q4_0Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ``[out, in]`` (bf16 or f32) from a Q4_0 weight.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if w.qs.device.type == "cpu":
        return dequantize_q4_0(w, dtype)
    out, in_dim = w.shape
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q4_0_dequant: dtype must be bfloat16 or float32, got {dtype}")
    if w.qs.dtype != torch.uint8 or w.qs.dim() != 2 or not w.qs.is_contiguous():
        raise ValueError("q4_0_dequant: qs must be contiguous uint8 [out, in/2]")
    if w.d.dtype != torch.float32 or w.d.shape != (out, in_dim // QK) or not w.d.is_contiguous():
        raise ValueError("q4_0_dequant: d must be contiguous float32 [out, in/32]")
    if w.d.device != w.qs.device or in_dim % QK:
        raise ValueError("q4_0_dequant: qs and d must share a device; in dim a multiple of 32")
    dense = torch.empty((out, in_dim), dtype=dtype, device=w.qs.device)
    code = build.lib("q4_dequant").q4_0_dequant(
        w.qs.data_ptr(), w.d.data_ptr(), dense.data_ptr(), out * (in_dim // QK),
        int(dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(w.qs.device).cuda_stream),
    )
    build.check(code, "q4_0_dequant")
    q4_0_dequant.launches += 1
    return dense


q4_0_dequant.launches = 0
