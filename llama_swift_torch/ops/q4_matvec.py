"""Batch-1 Q4_0 matvec: the port's device layout, its plain version and the
wrapper of the CUDA kernel ``csrc/q4_matvec.cu``.

Counterpart of ``llama_swift_tpu/ops/q4_vpu_pallas.py`` (``q4_0_vpu_matvec``
and ``q4_0_vpu_matvec_stacked``).  The kernel note at the top of the CUDA
source says what bounds it on the H100 and how the design answers.

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
    """x ``[in]`` → (q f32 integer-valued ``[in]`` in [-7, 7], d_x ``[in/32]``);
    scalar reference semantics (``ggml.c:568-601``)."""
    xb = x.float().reshape(-1, QK)
    amax = xb.abs().amax(dim=-1)
    d = amax / 7.0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    half = torch.where(xb >= 0, 0.5, -0.5)
    q = torch.trunc(xb * inv[:, None] + half)
    return q.reshape(-1), d


def q4_0_block_partials(q: torch.Tensor, w: Q4_0Weight, rows: int = 4096) -> torch.Tensor:
    """Exact integer block dots ``Σ_i (n−8)·q`` → int32 ``[out, in/32]``
    (row chunks bound the int32 temporaries)."""
    qi = q.to(torch.int32)
    out, in_dim = w.shape
    parts = []
    for r0 in range(0, out, rows):
        n = unpack_nibbles(w.qs[r0 : r0 + rows]).to(torch.int32) - 8
        parts.append((n * qi).reshape(n.shape[0], in_dim // QK, QK).sum(dim=-1, dtype=torch.int32))
    return torch.cat(parts)


def q4_0_matvec_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y [out]`` f32 from ``x [in]``."""
    q, dx = quantize_activations_q4_0_int(x)
    partials = q4_0_block_partials(q, w)
    return (partials.float() * (w.d * dx[None, :])).sum(dim=-1)


def q4_0_matvec(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [out] = W · x`` for one activation row ``x [in]`` f32 with the
    reference's int4×int4 dot.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_matvec_plain(x, w)
    out, in_dim = w.shape
    if not (x.is_cuda and w.qs.device == x.device and w.d.device == x.device):
        raise ValueError("q4_0_matvec: x and the weight must be on the same CUDA device")
    if x.dtype != torch.float32 or x.shape != (in_dim,) or not x.is_contiguous():
        raise ValueError(f"q4_0_matvec: x must be contiguous float32 [{in_dim}], got {x.dtype} {tuple(x.shape)}")
    if w.qs.dtype != torch.uint8 or w.qs.dim() != 2 or not w.qs.is_contiguous():
        raise ValueError("q4_0_matvec: qs must be contiguous uint8 [out, in/2]")
    if w.d.dtype != torch.float32 or w.d.shape != (out, in_dim // QK) or not w.d.is_contiguous():
        raise ValueError("q4_0_matvec: d must be contiguous float32 [out, in/32]")
    if in_dim % QK:
        raise ValueError(f"q4_0_matvec: in dim {in_dim} is not a multiple of {QK}")
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
