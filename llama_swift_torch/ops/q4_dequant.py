"""Q4_0 and Q4_1 → dense dequantization for prefill (and, for Q4_1, every
product of more than one row): the wrappers of the CUDA kernels in
``csrc/q4_dequant.cu`` and their plain versions.

Counterpart of ``llama_swift_tpu/ops/q4_dequant_pallas.py``
(``q4v_dequant_pm`` / ``q4v_dequant_pm_stacked``, ``is_q41`` False and True)
and of ``dequantize_q4_0_jnp`` / ``dequantize_q4_1_jnp`` in
``llama_swift_tpu/ops/quantized_matmul.py``.  The dense matrix is in logical
column order; the result is bit-identical to the plain version (Q4_0: one
f32 product per element; Q4_1: a product, then a sum, never fused; then
round-to-nearest-even to bf16 when asked).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import QK
from . import build
from .q4_matvec import Q4_0Weight, Q4_1Weight, unpack_nibbles


def dequantize_q4_0(w: Q4_0Weight, dtype=torch.float32) -> torch.Tensor:
    """Plain unpack + dequantize of a Q4_0 weight ``[rows, in]``:
    ``(n − 8)·d`` (``ggml.c:650-687``)."""
    rows, in_dim = w.shape
    vals = unpack_nibbles(w.qs).float() - 8.0
    vals = vals.reshape(rows, in_dim // QK, QK) * w.d[:, :, None].float()
    return vals.reshape(rows, in_dim).to(dtype)


def dequantize_q4_1(w: Q4_1Weight, dtype=torch.float32) -> torch.Tensor:
    """Plain unpack + dequantize of a Q4_1 weight ``[rows, in]``: ``n·d + m``
    (``ggml.c:689-717``), a product and then a sum, each rounded in f32."""
    rows, in_dim = w.shape
    vals = unpack_nibbles(w.qs).float().reshape(rows, in_dim // QK, QK)
    vals = vals * w.d[:, :, None] + w.m[:, :, None]
    return vals.reshape(rows, in_dim).to(dtype)


def _dequant(w, dtype, what: str) -> torch.Tensor:
    """Launch ``csrc/q4_dequant.cu``'s C function ``what`` over every block
    of ``w``."""
    out, in_dim = w.shape
    scales, name, shape, align = ((w.dm, "dm", (out, in_dim // QK, 2), 8) if isinstance(w, Q4_1Weight)
                                  else (w.d, "d", (out, in_dim // QK), 4))
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: dtype must be bfloat16 or float32, got {dtype}")
    if w.qs.dtype != torch.uint8 or w.qs.dim() != 2 or not w.qs.is_contiguous():
        raise ValueError(f"{what}: qs must be contiguous uint8 [out, in/2]")
    if scales.dtype != torch.float32 or scales.shape != shape or not scales.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous float32 {list(shape)}")
    if scales.device != w.qs.device or in_dim % QK:
        raise ValueError(f"{what}: qs and {name} must share a device; in dim a multiple of 32")
    if w.qs.data_ptr() % 4 or scales.data_ptr() % align:  # the kernel's 32-bit nibble loads, its scale loads
        raise ValueError(f"{what}: qs must be 4-byte and {name} {align}-byte aligned")
    dense = torch.empty((out, in_dim), dtype=dtype, device=w.qs.device)
    code = getattr(build.lib("q4_dequant"), what)(
        w.qs.data_ptr(), scales.data_ptr(), dense.data_ptr(), out * (in_dim // QK),
        int(dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(w.qs.device).cuda_stream),
    )
    build.check(code, what)
    return dense


def q4_0_dequant(w: Q4_0Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ``[out, in]`` (bf16 or f32) from a Q4_0 weight.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if w.qs.device.type == "cpu":
        return dequantize_q4_0(w, dtype)
    dense = _dequant(w, dtype, "q4_0_dequant")
    q4_0_dequant.launches += 1
    return dense


q4_0_dequant.launches = 0


def q4_1_dequant(w: Q4_1Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ``[out, in]`` (bf16 or f32) from a Q4_1 weight.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if w.qs.device.type == "cpu":
        return dequantize_q4_1(w, dtype)
    dense = _dequant(w, dtype, "q4_1_dequant")
    q4_1_dequant.launches += 1
    return dense


q4_1_dequant.launches = 0
