"""Q4_0 weights of the T layout and their product for 1–64 f32 activation
rows: the weight type, the wrapper of the CUDA kernel in
``csrc/q4_matmul_t.cu`` and its plain version.

Counterpart of ``llama_swift_tpu/ops/q4_matmul_pallas.py`` (``Q4_0TensorT``,
``q4_0_matmul_pallas`` and ``q4_0_matmul_pallas_stacked``, the phase-dequant
kernel ``_q4_0_phase_kernel``).  The JAX package picks the T layout for the
tensor-parallel path (``params_from_tensors(shard_pad > 1)`` on the
accelerator; the port's ``q4_layout="t"`` asks for it anywhere), and its
``linear`` sends every T product of 1–64 rows to the phase kernel: the
integer T kernels are
switched off there (``MAX_INT_KERNEL_ROWS = 0``, ``MAX_MULTI_ROWS_T = 0``),
so the port has no other T kernel on its path.

**Layout.**  :class:`Q4_0WeightT` keeps the logical bytes of
:class:`~.q4_matvec.Q4_0Weight` (nibbles ``[..., out, in/2]``, scales
``[..., out, in/32]``), without the TPU's ``[out/128, in/8, 128]`` tiling,
its 1024-multiple in-dim padding or its 128-row out granularity.  Only the
type differs: it tells ``linear`` to dispatch as the JAX package dispatches
``Q4_0TensorT``, and the Q4_0 dequant and the embedding gather read it as
they read any Q4_0 weight.  Because it subclasses ``Q4_0Weight``, every
``isinstance`` dispatch tests the T type first.

**Numerics.**  ``y = x · deq(W)ᵀ`` in f32, each weight ``(n − 8)·d`` with one
rounding; activations are fake-quantized by the caller when the model
quantizes them, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import QK
from . import build
from .q4_dequant import dequantize_q4_0
from .q4_matvec import Q4_0Weight, _check_weight, _check_x, _stream

#: rows above which the product dequantizes and multiplies instead
#: (``MAX_PHASE_KERNEL_ROWS`` of the TPU kernel)
MAX_PHASE_KERNEL_ROWS = 64


class Q4_0WeightT(Q4_0Weight):
    """A Q4_0 weight of the T layout ``[out, in]`` (or a stack ``[L, out, in]``):
    the logical bytes of :class:`Q4_0Weight`, dispatched as the JAX
    package's ``Q4_0TensorT``."""


def from_jax_t(qs4: np.ndarray, scales_t: np.ndarray, in_dim: int, out_dim: int, device="cpu") -> Q4_0WeightT:
    """JAX T-layout leaves → :class:`Q4_0WeightT`: ``qs4`` int32 ``[...,
    out/128, in_pad/8, 128]`` (lane ``ot·128 + l`` is row ``ot·128 + l``; a
    word holds logical bytes ``4j..4j+3`` little-endian) and ``scales_t`` f32
    ``[..., out/128, in_pad/32, 128]`` (``Q4_0TensorT.from_q4_0`` /
    ``to_q4_0``, ``q4_matmul_pallas.py:81-118``).  Keeps rows ``[0,
    out_dim)`` and columns ``[0, in_dim)``: the in-dim padding to a multiple
    of 1024 and any out-row padding beyond ``out_dim`` are dropped."""

    def untile(a):  # [..., ot, X, 128] -> [..., ot·128, X]
        a = np.swapaxes(np.asarray(a), -1, -2)
        return np.ascontiguousarray(a.reshape(*a.shape[:-3], a.shape[-3] * a.shape[-2], a.shape[-1]))

    qs = untile(np.asarray(qs4).view(np.uint32)).view(np.uint8)  # bytes in little-endian order
    d = untile(np.asarray(scales_t, dtype=np.float32))
    qs, d = qs[..., :out_dim, : in_dim // 2], d[..., :out_dim, : in_dim // QK]
    return Q4_0WeightT(
        torch.from_numpy(np.ascontiguousarray(qs)).to(device),
        torch.from_numpy(np.ascontiguousarray(d)).to(device),
    )


def q4_0_matmul_t_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y [N, out] = x [N, in] ·
    deq(W)ᵀ`` f32, the weight dequantized as ``(n − 8)·d``."""
    return torch.matmul(x.float(), dequantize_q4_0(w, torch.float32).t())


def q4_0_matmul_t(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [N, out] = x [N, in] · deq(W)ᵀ`` for 1 ≤ N ≤ 64 f32 rows (already
    fake-quantized by the caller when activations are quantized), streaming
    the packed weight once for all rows.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_matmul_t_plain(x, w)
    out, in_dim = w.shape
    _check_weight(w, x, "q4_0_matmul_t")
    n = x.shape[0] if x.dim() == 2 else 0
    _check_x(x, (n, in_dim), "q4_0_matmul_t")
    if not 1 <= n <= MAX_PHASE_KERNEL_ROWS:
        raise ValueError(f"q4_0_matmul_t: {n} rows, the kernel takes 1..{MAX_PHASE_KERNEL_ROWS}")
    y = torch.empty((n, out), dtype=torch.float32, device=x.device)
    code = build.lib("q4_matmul_t").q4_0_matmul_t(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, n, _stream(x))
    build.check(code, "q4_0_matmul_t")
    q4_0_matmul_t.launches += 1
    return y


q4_0_matmul_t.launches = 0

