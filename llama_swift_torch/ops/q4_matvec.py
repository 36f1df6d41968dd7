"""Q4_0 matvec (batch 1), Q4_0 multi-row matmul (2–32 rows) and Q4_1 matvec
(batch 1): the port's device layouts, the plain versions and the wrappers of
the CUDA kernels in ``csrc/q4_matvec.cu``.

Counterpart of ``llama_swift_tpu/ops/q4_vpu_pallas.py`` (``q4_0_vpu_matvec``,
``q4_0_vpu_matvec_stacked``, ``q4_0_vpu_matmul_multi``, ``q4_1_vpu_matvec``
and ``q4_1_vpu_matvec_stacked``).  The kernel notes at the top of the CUDA
source say what bounds each kernel on the H100 and how the design answers.

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

**Q4_1.**  :class:`Q4_1Weight` keeps the same nibble bytes plus, per block,
the delta ``d`` and the min ``m`` side by side in ``dm [..., out, in/32, 2]``
(one 8-byte load a block, as ggml's ``block_q4_1``); ``d`` and ``m`` are
views of it.  A weight is ``n·d + m``.  The activation is quantized per
32-block as the runtime ``quantize_row_q4_1`` does (true min and max,
``d_x = (max − min)/15``, codes ``round((x − min)/d_x)`` in [0, 15]) into
``x̂ = q·d_x + m_x``, and ``y = Σ_b d_b·Σ_i n_i·x̂_i + m_b·Σ_i x̂_i``, the
TPU kernel's sum (``_vpu_core_q41``).  There is no Q4_1 multi-row kernel,
as in the JAX package: more than one row dequantizes.

**f32 activations** (``quantize_acts=False``, the model's
``quantize_activations=False``): the same three products on unquantized
rows, each with a kernel of its own and a launch counter of its own
(:func:`q4_0_matvec_f32`, :func:`q4_1_matvec_f32`,
:func:`q4_0_matmul_multi_f32`): Q4_0 ``y = Σ_b d_b·Σ_i (n_i − 8)·x_i``, Q4_1
``y = Σ_b d_b·Σ_i n_i·x_i + m_b·Σ_i x_i``.  The TPU kernels compute them with
``_prep_inputs*(quantize_acts=False)`` (``d_x = 1``, ``8·Σx`` as the
correction); the sums are equal up to reassociation.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import QK
from ..formats.quant import Q4_0Tensor, Q4_1Tensor
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
        """Layer ``il`` of a stacked weight, as views into the stack (of the
        same type: a T-layout weight stays one)."""
        return type(self)(self.qs[il], self.d[il])

    @classmethod
    def from_q4_0(cls, w: Q4_0Tensor, device="cpu") -> "Q4_0Weight":
        return cls(
            qs=torch.from_numpy(np.ascontiguousarray(w.qs, dtype=np.uint8)).to(device),
            d=torch.from_numpy(np.ascontiguousarray(w.scales, dtype=np.float32)).to(device),
        )


@dataclasses.dataclass
class Q4_1Weight:
    """A Q4_1 weight ``[out, in]`` (or a stack ``[L, out, in]``) on a device."""

    qs: torch.Tensor  # uint8 [..., out, in/2], the Q4_0 byte order
    dm: torch.Tensor  # float32 [..., out, in/32, 2]: each block's (d, m)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.qs.shape[-2], self.qs.shape[-1] * 2)

    @property
    def d(self) -> torch.Tensor:
        return self.dm[..., 0]

    @property
    def m(self) -> torch.Tensor:
        return self.dm[..., 1]

    def layer(self, il: int) -> "Q4_1Weight":
        """Layer ``il`` of a stacked weight, as views into the stack."""
        return Q4_1Weight(self.qs[il], self.dm[il])

    @classmethod
    def from_q4_1(cls, w: Q4_1Tensor, device="cpu") -> "Q4_1Weight":
        dm = np.stack([np.asarray(w.scales, np.float32), np.asarray(w.mins, np.float32)], axis=-1)
        return cls(
            qs=torch.from_numpy(np.ascontiguousarray(w.qs, dtype=np.uint8)).to(device),
            dm=torch.from_numpy(np.ascontiguousarray(dm)).to(device),
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


def quantize_activations_q4_1(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``[..., in]`` → (q f32 integer-valued ``[..., in]`` in [0, 15], d_x
    and m_x ``[..., in/32]``); runtime ``quantize_row_q4_1`` semantics
    (``ggml.c:606-648``): true min and max, ``d = (max − min)/15`` by true
    division, ``inv = 1/d`` (0 when d = 0), ``q = trunc((x − min)·inv + ½)``
    (round half away from zero of a value ≥ 0)."""
    xb = x.float().reshape(-1, QK)
    mn = xb.amin(dim=-1)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar through
    # its reciprocal (see quantize_activations_q4_0_int)
    d = (xb.amax(dim=-1) - mn) / torch.full_like(mn, 15.0)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    q = torch.trunc((xb - mn[:, None]) * inv[:, None] + 0.5)
    lead = (*x.shape[:-1], x.shape[-1] // QK)
    return q.reshape(x.shape), d.reshape(lead), mn.reshape(lead)


def dequantize_activations_q4_1(q: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x̂ = q·d_x + m_x`` per 32-block (a product, then a sum: two f32
    roundings, as the JAX fake-quantization does)."""
    qb = q.reshape(*d.shape, QK)
    return (qb * d[..., None] + m[..., None]).reshape(q.shape)


def _block_dots(x: torch.Tensor, w: Q4_0Weight, rows: int = 4096) -> torch.Tensor:
    """Block dots ``Σ_i (n−8)·x_i`` → f32 ``[..., out, in/32]`` for x
    ``[..., in]``, a batched f32 product per block; row chunks bound the
    temporaries."""
    out, in_dim = w.shape
    nb = in_dim // QK
    lead = x.shape[:-1]
    xb = x.float().reshape(-1, nb, QK).permute(1, 2, 0)  # [nb, 32, R]
    parts = []
    for r0 in range(0, out, rows):
        n = unpack_nibbles(w.qs[r0 : r0 + rows]).float() - 8.0  # [rows, in]
        n = n.reshape(-1, nb, QK).transpose(0, 1)  # [nb, rows, 32]
        parts.append(torch.bmm(n, xb).permute(2, 1, 0))  # [R, rows, nb]
    return torch.cat(parts, dim=1).reshape(*lead, out, nb)


def q4_0_block_partials(q: torch.Tensor, w: Q4_0Weight, rows: int = 4096) -> torch.Tensor:
    """Exact integer block dots ``Σ_i (n−8)·q`` → int32 ``[..., out, in/32]``
    for q ``[..., in]``.  Each block dot is a batched f32 product of 32
    integer terms of magnitude ≤ 56: every partial sum is an integer below
    2^24, so the f32 result is exact in any summation order."""
    return _block_dots(q, w, rows).to(torch.int32)


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


def q4_0_matmul_multi_f32_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of both f32-activation Q4_0 kernels: ``y [B,
    out]`` from unquantized ``x [B, in]``: block dots ``Σ_i (n−8)·x_i`` by a
    batched f32 product, then ``Σ_b d_b · dot_b``."""
    return (_block_dots(x, w) * w.d[None]).sum(dim=-1)


def q4_0_matvec_f32_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of the f32-activation matvec: ``y [out]`` from ``x [in]``."""
    return q4_0_matmul_multi_f32_plain(x[None], w)[0]


def q4_1_matvec_plain(x: torch.Tensor, w: Q4_1Weight, quantize_acts: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the Q4_1 matvec: ``y [out]`` f32 from ``x
    [in]``, ``Σ_b d_b·A_b + m_b·S_b`` with ``A_b = Σ_i n_i·x̂_i`` (a batched
    f32 product) and ``S_b = Σ_i x̂_i``; x̂ is the Q4_1 fake-quantized
    activation, or x itself without ``quantize_acts``.  Chunks of 4096 rows
    bound the temporaries."""
    out, in_dim = w.shape
    rows = 4096
    nb = in_dim // QK
    xh = dequantize_activations_q4_1(*quantize_activations_q4_1(x)) if quantize_acts else x.float()
    xb = xh.reshape(nb, QK, 1)
    s = xb.sum(dim=1)[:, 0]  # [nb]
    parts = []
    for r0 in range(0, out, rows):
        n = unpack_nibbles(w.qs[r0 : r0 + rows]).float().reshape(-1, nb, QK).transpose(0, 1)  # [nb, rows, 32]
        parts.append(torch.bmm(n, xb)[:, :, 0].t())  # [rows, nb]
    acc = torch.cat(parts)
    return (acc * w.d + s * w.m).sum(dim=-1)


def _check_weight(w, x: torch.Tensor, what: str) -> None:
    out, in_dim = w.shape
    scales, name, shape, align = ((w.dm, "dm", (out, in_dim // QK, 2), 8) if isinstance(w, Q4_1Weight)
                                  else (w.d, "d", (out, in_dim // QK), 4))
    if not (x.is_cuda and w.qs.device == x.device and scales.device == x.device):
        raise ValueError(f"{what}: x and the weight must be on the same CUDA device")
    if w.qs.dtype != torch.uint8 or w.qs.dim() != 2 or not w.qs.is_contiguous():
        raise ValueError(f"{what}: qs must be contiguous uint8 [out, in/2]")
    if scales.dtype != torch.float32 or scales.shape != shape or not scales.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous float32 {list(shape)}")
    if in_dim % QK:
        raise ValueError(f"{what}: in dim {in_dim} is not a multiple of {QK}")
    if w.qs.data_ptr() % 16 or scales.data_ptr() % align:
        raise ValueError(f"{what}: qs must be 16-byte and {name} {align}-byte aligned (vector loads)")


def _check_x(x: torch.Tensor, shape: tuple, what: str) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous float32 {list(shape)}, got {x.dtype} {tuple(x.shape)}")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


#: the largest in-dim the f32 kernels stage in a block's shared memory (227 KB)
MAX_F32_IN = 55 * 1024


def q4_0_matvec_f32(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [out] = W · x`` for one unquantized activation row ``x [in]`` f32
    (no 4-bit activation codes).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_matvec_f32_plain(x, w)
    y = _launch_q4_0_matvec_f32(x, w, "q4_0_matvec_f32")
    q4_0_matvec_f32.launches += 1
    return y


q4_0_matvec_f32.launches = 0


def _launch_q4_0_matvec_f32(x: torch.Tensor, w: Q4_0Weight, what: str) -> torch.Tensor:
    """Check and launch the f32-activation matvec kernel (no count: the
    caller's wrapper counts its launch)."""
    out, in_dim = w.shape
    _check_weight(w, x, what)
    _check_x(x, (in_dim,), what)
    if in_dim > MAX_F32_IN:
        raise ValueError(f"{what}: in dim {in_dim} exceeds {MAX_F32_IN} (shared memory)")
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matvec_f32(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, _stream(x))
    build.check(code, what)
    return y


def q4_0_matvec(x: torch.Tensor, w: Q4_0Weight, quantize_acts: bool = True) -> torch.Tensor:
    """``y [out] = W · x`` for one activation row ``x [in]`` f32 with the
    reference's int4×int4 dot; ``quantize_acts=False`` takes the f32 row
    as it is (:func:`q4_0_matvec_f32`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if not quantize_acts:
        return q4_0_matvec_f32(x, w)
    if x.device.type == "cpu":
        return q4_0_matvec_plain(x, w)
    y = _launch_q4_0_matvec(x, w, "q4_0_matvec")
    q4_0_matvec.launches += 1
    return y


q4_0_matvec.launches = 0


def _launch_q4_0_matvec(x: torch.Tensor, w: Q4_0Weight, what: str) -> torch.Tensor:
    """Check and launch the matvec kernel (no count: the caller's wrapper
    counts its launch)."""
    out, in_dim = w.shape
    _check_weight(w, x, what)
    _check_x(x, (in_dim,), what)
    nb = in_dim // QK
    xq = torch.empty(in_dim, dtype=torch.int8, device=x.device)
    qsum = torch.empty(nb, dtype=torch.int32, device=x.device)
    dx = torch.empty(nb, dtype=torch.float32, device=x.device)
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matvec(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), xq.data_ptr(),
        qsum.data_ptr(), dx.data_ptr(), y.data_ptr(), out, in_dim, _stream(x),
    )
    build.check(code, what)
    return y


#: rows the multi-row kernel accepts (``MAX_MULTI_ROWS`` of the TPU kernel)
MAX_MULTI_ROWS = 32


def q4_0_matmul_multi_f32(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [B, out] = x [B, in] · Wᵀ`` for 2 ≤ B ≤ 32 unquantized activation
    rows f32, streaming the packed weight once for all rows.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_matmul_multi_f32_plain(x, w)
    y = _launch_q4_0_matmul_multi_f32(x, w, "q4_0_matmul_multi_f32")
    q4_0_matmul_multi_f32.launches += 1
    return y


q4_0_matmul_multi_f32.launches = 0


def _launch_q4_0_matmul_multi_f32(x: torch.Tensor, w: Q4_0Weight, what: str) -> torch.Tensor:
    """Check and launch the f32-activation multi-row kernel (no count: the
    caller's wrapper counts its launch)."""
    out, in_dim = w.shape
    _check_weight(w, x, what)
    B = x.shape[0] if x.dim() == 2 else 0
    _check_x(x, (B, in_dim), what)
    if not 1 <= B <= MAX_MULTI_ROWS:
        raise ValueError(f"{what}: {B} rows, the kernel takes 1..{MAX_MULTI_ROWS}")
    y = torch.empty((B, out), dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matmul_multi_f32(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, B, _stream(x))
    build.check(code, what)
    return y


def q4_0_matmul_multi(x: torch.Tensor, w: Q4_0Weight, quantize_acts: bool = True) -> torch.Tensor:
    """``y [B, out] = x [B, in] · Wᵀ`` for 2 ≤ B ≤ 32 activation rows f32,
    each row with the reference's int4×int4 dot, streaming the packed weight
    once for all rows; ``quantize_acts=False`` takes the f32 rows as they are
    (:func:`q4_0_matmul_multi_f32`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if not quantize_acts:
        return q4_0_matmul_multi_f32(x, w)
    if x.device.type == "cpu":
        return q4_0_matmul_multi_plain(x, w)
    y = _launch_q4_0_matmul_multi(x, w, "q4_0_matmul_multi")
    q4_0_matmul_multi.launches += 1
    return y


q4_0_matmul_multi.launches = 0


def _launch_q4_0_matmul_multi(x: torch.Tensor, w: Q4_0Weight, what: str) -> torch.Tensor:
    """Check and launch the multi-row kernel (no count: the caller's
    wrapper counts its launch)."""
    out, in_dim = w.shape
    _check_weight(w, x, what)
    B = x.shape[0] if x.dim() == 2 else 0
    _check_x(x, (B, in_dim), what)
    if not 1 <= B <= MAX_MULTI_ROWS:
        raise ValueError(f"{what}: {B} rows, the kernel takes 1..{MAX_MULTI_ROWS}")
    nb = in_dim // QK
    xq = torch.empty((B, in_dim), dtype=torch.int8, device=x.device)
    qsum = torch.empty((B, nb), dtype=torch.int32, device=x.device)
    dx = torch.empty((B, nb), dtype=torch.float32, device=x.device)
    y = torch.empty((B, out), dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matmul_multi(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), xq.data_ptr(),
        qsum.data_ptr(), dx.data_ptr(), y.data_ptr(), out, in_dim, B, _stream(x),
    )
    build.check(code, what)
    return y


def q4_1_matvec_f32(x: torch.Tensor, w: Q4_1Weight) -> torch.Tensor:
    """``y [out] = W · x`` for one unquantized activation row ``x [in]`` f32
    against a Q4_1 weight.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_1_matvec_plain(x, w, quantize_acts=False)
    out, in_dim = w.shape
    _check_weight(w, x, "q4_1_matvec_f32")
    _check_x(x, (in_dim,), "q4_1_matvec_f32")
    if in_dim > MAX_F32_IN:
        raise ValueError(f"q4_1_matvec_f32: in dim {in_dim} exceeds {MAX_F32_IN} (shared memory)")
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_1_matvec_f32(
        w.qs.data_ptr(), w.dm.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, _stream(x))
    build.check(code, "q4_1_matvec_f32")
    q4_1_matvec_f32.launches += 1
    return y


q4_1_matvec_f32.launches = 0


def q4_1_matvec(x: torch.Tensor, w: Q4_1Weight, quantize_acts: bool = True) -> torch.Tensor:
    """``y [out] = W · x`` for one activation row ``x [in]`` f32 against a
    Q4_1 weight, the activation quantized through Q4_1 (the reference's
    Q4_1 matmul quantizes both operands); ``quantize_acts=False`` takes the
    f32 row as it is (:func:`q4_1_matvec_f32`).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if not quantize_acts:
        return q4_1_matvec_f32(x, w)
    if x.device.type == "cpu":
        return q4_1_matvec_plain(x, w)
    out, in_dim = w.shape
    _check_weight(w, x, "q4_1_matvec")
    _check_x(x, (in_dim,), "q4_1_matvec")
    xq = torch.empty(in_dim, dtype=torch.uint8, device=x.device)
    xs = torch.empty((in_dim // QK, 4), dtype=torch.float32, device=x.device)  # d_x, m_x, Σx̂, pad
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_1_matvec(
        w.qs.data_ptr(), w.dm.data_ptr(), x.data_ptr(), xq.data_ptr(), xs.data_ptr(), y.data_ptr(),
        out, in_dim, _stream(x),
    )
    build.check(code, "q4_1_matvec")
    q4_1_matvec.launches += 1
    return y


q4_1_matvec.launches = 0
