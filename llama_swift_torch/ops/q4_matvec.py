"""Q4_0 matvec (batch 1) and multi-row matmul (2–32 rows): the port's device
layout, the plain versions and the wrappers of the CUDA kernels in
``csrc/q4_matvec.cu``.

Counterpart of ``llama_swift_tpu/ops/q4_vpu_pallas.py`` (``q4_0_vpu_matvec``,
``q4_0_vpu_matvec_stacked`` and ``q4_0_vpu_matmul_multi``).  The kernel notes
at the top of the CUDA source say what bounds each kernel on the H100 and
how the design answers.

**Layout.**  :class:`Q4_0Weight` keeps the ggml logical order: ``qs`` uint8
``[..., out, in/2]`` (byte j of a block holds elements 2j and 2j+1, low
nibble first) and ``d`` f32 ``[..., out, in/32]``.  No in-dim padding and no
lane permutation: the TPU's V layout existed for Mosaic's (8, 128) tiling.
Stacked layer weights carry a leading ``[L]`` axis; :meth:`Q4_0Weight.layer`
is a view, never a copy.

**Numerics.**  The activation is quantized per 32-block to integers in
[-7, 7] exactly as ``quantize_activations_q4_0_int`` does (``d = amax/7``,
``inv = 1/d``, ``trunc(x·inv ± 0.5)`` — half away from zero, never
``torch.round``'s half to even); block partials are exact integers and the
per-block term ``partial · (d_w·d_x)`` rounds as on the TPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import QK
from ..formats.quant import Q4_0Tensor
from . import build


@dataclasses.dataclass
class Q4_0Weight:
    """A Q4_0 weight ``[out, in]`` (or a stack ``[L, out, in]``) on a device."""

    qs: torch.Tensor  # uint8 [..., out, in/2]
    d: torch.Tensor  # float32 [..., out, in/32]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.qs.shape[-2], self.qs.shape[-1] * 2)

    def layer(self, il: int) -> "Q4_0Weight":
        """Layer ``il`` of a stacked weight, as views into the stack."""
        return Q4_0Weight(self.qs[il], self.d[il])

    @classmethod
    def from_q4_0(cls, w: Q4_0Tensor, device="cpu") -> "Q4_0Weight":
        return cls(
            qs=torch.from_numpy(np.ascontiguousarray(w.qs, dtype=np.uint8)).to(device),
            d=torch.from_numpy(np.ascontiguousarray(w.scales, dtype=np.float32)).to(device),
        )


def unpack_nibbles(qs: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., n]`` → uint8 ``[..., 2n]``, even elements from low
    nibbles (``ggml.c:664-666``)."""
    return torch.stack([qs & 0xF, qs >> 4], dim=-1).reshape(*qs.shape[:-1], -1)


def quantize_activations_q4_0_int(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[..., in]`` → (q f32 integer-valued ``[..., in]`` in [-7, 7], d_x
    ``[..., in/32]``); scalar reference semantics (``ggml.c:568-601``)."""
    xb = x.float().reshape(-1, QK)
    amax = xb.abs().amax(dim=-1)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar through
    # its reciprocal, and amax·(1/7) rounds exact ties otherwise than amax/7
    d = amax / torch.full_like(amax, 7.0)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    half = torch.where(xb >= 0, 0.5, -0.5)
    q = torch.trunc(xb * inv[:, None] + half)
    return q.reshape(x.shape), d.reshape(*x.shape[:-1], x.shape[-1] // QK)


def q4_0_block_partials(q: torch.Tensor, w: Q4_0Weight, rows: int = 4096) -> torch.Tensor:
    """Exact integer block dots ``Σ_i (n−8)·q`` → int32 ``[..., out, in/32]``
    for q ``[..., in]``.  Each block dot is a batched f32 product of 32
    integer terms of magnitude ≤ 56: every partial sum is an integer below
    2^24, so the f32 result is exact in any summation order.  Row chunks
    bound the temporaries."""
    out, in_dim = w.shape
    nb = in_dim // QK
    lead = q.shape[:-1]
    qb = q.float().reshape(-1, nb, QK).permute(1, 2, 0)  # [nb, 32, R]
    parts = []
    for r0 in range(0, out, rows):
        n = unpack_nibbles(w.qs[r0 : r0 + rows]).float() - 8.0  # [rows, in]
        n = n.reshape(-1, nb, QK).transpose(0, 1)  # [nb, rows, 32]
        parts.append(torch.bmm(n, qb).permute(2, 1, 0))  # [R, rows, nb]
    return torch.cat(parts, dim=1).to(torch.int32).reshape(*lead, out, nb)


def q4_0_matmul_multi_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of both kernels: ``y [B, out]`` f32 from ``x
    [B, in]``, each row quantized on its own, exact integer block partials,
    then ``Σ_b partial · (d_w · d_x)``."""
    q, dx = quantize_activations_q4_0_int(x)
    partials = q4_0_block_partials(q, w)  # [B, out, nb]
    return (partials.float() * (w.d[None] * dx[:, None, :])).sum(dim=-1)


def q4_0_matvec_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of the matvec: ``y [out]`` f32 from ``x [in]``."""
    return q4_0_matmul_multi_plain(x[None], w)[0]


def _check_weight(w: Q4_0Weight, x: torch.Tensor, what: str) -> None:
    out, in_dim = w.shape
    if not (x.is_cuda and w.qs.device == x.device and w.d.device == x.device):
        raise ValueError(f"{what}: x and the weight must be on the same CUDA device")
    if w.qs.dtype != torch.uint8 or w.qs.dim() != 2 or not w.qs.is_contiguous():
        raise ValueError(f"{what}: qs must be contiguous uint8 [out, in/2]")
    if w.d.dtype != torch.float32 or w.d.shape != (out, in_dim // QK) or not w.d.is_contiguous():
        raise ValueError(f"{what}: d must be contiguous float32 [out, in/32]")
    if in_dim % QK:
        raise ValueError(f"{what}: in dim {in_dim} is not a multiple of {QK}")


def q4_0_matvec(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [out] = W · x`` for one activation row ``x [in]`` f32 with the
    reference's int4×int4 dot.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_matvec_plain(x, w)
    out, in_dim = w.shape
    _check_weight(w, x, "q4_0_matvec")
    if x.dtype != torch.float32 or x.shape != (in_dim,) or not x.is_contiguous():
        raise ValueError(f"q4_0_matvec: x must be contiguous float32 [{in_dim}], got {x.dtype} {tuple(x.shape)}")
    nb = in_dim // QK
    xq = torch.empty(in_dim, dtype=torch.int8, device=x.device)
    qsum = torch.empty(nb, dtype=torch.int32, device=x.device)
    dx = torch.empty(nb, dtype=torch.float32, device=x.device)
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matvec(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), xq.data_ptr(),
        qsum.data_ptr(), dx.data_ptr(), y.data_ptr(), out, in_dim,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    build.check(code, "q4_0_matvec")
    q4_0_matvec.launches += 1
    return y


q4_0_matvec.launches = 0


#: rows the multi-row kernel accepts (``MAX_MULTI_ROWS`` of the TPU kernel)
MAX_MULTI_ROWS = 32


def q4_0_matmul_multi(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [B, out] = x [B, in] · Wᵀ`` for 2 ≤ B ≤ 32 activation rows f32,
    each row with the reference's int4×int4 dot, streaming the packed weight
    once for all rows.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_matmul_multi_plain(x, w)
    out, in_dim = w.shape
    _check_weight(w, x, "q4_0_matmul_multi")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != in_dim or not x.is_contiguous():
        raise ValueError(f"q4_0_matmul_multi: x must be contiguous float32 [B, {in_dim}], "
                         f"got {x.dtype} {tuple(x.shape)}")
    B = x.shape[0]
    if not 1 <= B <= MAX_MULTI_ROWS:
        raise ValueError(f"q4_0_matmul_multi: {B} rows, the kernel takes 1..{MAX_MULTI_ROWS}")
    nb = in_dim // QK
    xq = torch.empty((B, in_dim), dtype=torch.int8, device=x.device)
    qsum = torch.empty((B, nb), dtype=torch.int32, device=x.device)
    dx = torch.empty((B, nb), dtype=torch.float32, device=x.device)
    y = torch.empty((B, out), dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matmul_multi(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), xq.data_ptr(),
        qsum.data_ptr(), dx.data_ptr(), y.data_ptr(), out, in_dim, B,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    build.check(code, "q4_0_matmul_multi")
    q4_0_matmul_multi.launches += 1
    return y


q4_0_matmul_multi.launches = 0
