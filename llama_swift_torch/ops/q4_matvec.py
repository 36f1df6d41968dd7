"""Q4_0 matvec (batch 1), Q4_0 multi-row matmul (2–32 rows) and Q4_1 matvec
(batch 1): the port's device layouts, the plain versions and the wrappers of
the CUDA kernels in ``csrc/q4_matvec.cu``.

Counterpart of ``llama_swift_tpu/ops/q4_vpu_pallas.py`` (``q4_0_vpu_matvec``,
``q4_0_vpu_matvec_stacked``, ``q4_0_vpu_matmul_multi``, ``q4_1_vpu_matvec``,
``q4_1_vpu_matvec_stacked`` and the bandwidth probe ``stream_probe``, whose
kernel is ``csrc/stream_probe.cu``).  The kernel notes at the top of the CUDA
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
correction); the sums are equal up to reassociation.  The multi-row kernel
takes the block dots on the bf16 tensor cores from exact products (the
nibbles and three bf16 pieces of x, ``csrc/q4_f32_mma.cuh``), cut by
:func:`f32_mma_plan`; the Q4_0 matvec's persistent grid is
:func:`matvec_f32_plan`'s.

**The 4-bit-activation matvecs** (:func:`q4_0_matvec`, :func:`q4_1_matvec`)
run one kernel template on a persistent grid (:func:`matvec_q4_plan`), each
call one launch with no scratch: every block quantizes x into shared memory
a quad of threads per 32-block (:func:`quantize_blocks_q4_0`,
:func:`quantize_blocks_q4_1` mirror it) while its first weight loads are in
flight.  :func:`q4_0_matvec_lane_order` and :func:`q4_1_matvec_lane_order`
are the kernel's order of sums in PyTorch, for tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

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

F32_WARPS = 16  # warps of an f32 matvec block (``F32_WARPS`` in the CUDA source)
F32_RING = 2  # weight blocks a lane keeps in flight (``F32_RING``)
F32_BLOCKS_PER_SM = 2  # blocks an SM of its persistent grid (``F32_BLOCKS_PER_SM``)


@dataclasses.dataclass(frozen=True)
class MatvecF32Plan:
    """The f32 matvecs' launch (Q4_0 and Q4_1): ``blocks`` blocks of
    ``warps`` warps, warp w of block g on rows ``g·warps + w +
    k·blocks·warps`` (at most ``rows_per_warp`` each), each lane with
    ``ring`` weight blocks in flight; x staged transposed in ``smem_bytes``
    (``8·stride`` float4, ``stride = (in/32) | 1``; Q4_1 adds each block's
    sum of x, ``in/32`` floats)."""

    blocks: int
    warps: int
    ring: int
    stride: int
    smem_bytes: int
    rows_per_warp: int

    def warp_rows(self, out: int, block: int, warp: int) -> list:
        step = self.blocks * self.warps
        return list(range(block * self.warps + warp, out, step))


@functools.lru_cache(maxsize=None)
def matvec_f32_plan(out: int, in_dim: int, sms: int = 132, q4_1: bool = False) -> MatvecF32Plan:
    """Plan of the f32 matvecs' kernel (:func:`q4_0_matvec_f32`, and with
    ``q4_1`` :func:`q4_1_matvec_f32`) on a card of ``sms`` SMs: two blocks
    an SM (a persistent grid that stages x once a block), fewer when the
    rows do not fill them."""
    if out < 1 or in_dim < QK or in_dim % QK:
        raise ValueError(f"matvec_f32_plan: out {out}, in dim {in_dim}")
    stride = (in_dim // QK) | 1
    blocks = min(-(-out // F32_WARPS), F32_BLOCKS_PER_SM * sms)
    smem = 8 * stride * 16 + (4 * (in_dim // QK) if q4_1 else 0)
    return MatvecF32Plan(blocks=blocks, warps=F32_WARPS, ring=F32_RING, stride=stride, smem_bytes=smem,
                         rows_per_warp=-(-out // (blocks * F32_WARPS)))


#: the largest in-dim whose staged x and codes the 4-bit-activation
#: matvecs hold in a block's shared memory (Q4_1: 176 bytes per 32
#: elements, 225,288 bytes)
MAX_Q4_IN = 40 * 1024

MV_WARPS = 32  # warps of a 4-bit-activation matvec block (``MV_WARPS`` in the CUDA source)
MV_RING = 4  # weight blocks a lane keeps in flight (``MV_RING``)
MV_BLOCKS_PER_SM = 1  # blocks an SM of its persistent grid (``MV_BLOCKS_PER_SM``)


@dataclasses.dataclass(frozen=True)
class MatvecQ4Plan:
    """The 4-bit-activation matvecs' launch (Q4_0 and Q4_1): ``blocks``
    blocks of ``warps`` warps, one an SM, warp w of block g on rows
    ``w·blocks + g + k·blocks·warps`` (at most ``rows_per_warp`` each; the
    blocks' rows differ by one at most), each lane with ``ring`` weight
    blocks in flight; x staged and its codes in ``smem_bytes`` of shared
    memory a block (per 32 elements 128 bytes of x, 32 codes and the
    block's {sum of codes, d_x}, 168 bytes, or Q4_1's {d_x, m_x, Σx̂}, 176;
    and the staging copy's 8-byte barrier)."""

    blocks: int
    warps: int
    ring: int
    smem_bytes: int
    rows_per_warp: int

    def warp_rows(self, out: int, block: int, warp: int) -> list:
        step = self.blocks * self.warps
        return list(range(warp * self.blocks + block, out, step))


@functools.lru_cache(maxsize=None)
def matvec_q4_plan(out: int, in_dim: int, sms: int = 132, q4_1: bool = False) -> MatvecQ4Plan:
    """Plan of the 4-bit-activation matvecs' kernel (:func:`q4_0_matvec`,
    and with ``q4_1`` :func:`q4_1_matvec`) on a card of ``sms`` SMs: a
    block an SM (x staged and quantized once an SM), fewer blocks than rows
    never; in-dims above ``MAX_Q4_IN`` are refused."""
    if out < 1 or in_dim < QK or in_dim % QK or in_dim > MAX_Q4_IN:
        raise ValueError(f"matvec_q4_plan: out {out}, in dim {in_dim}: the in dim must be a multiple of {QK} "
                         f"up to {MAX_Q4_IN} (shared memory)")
    blocks = min(out, MV_BLOCKS_PER_SM * sms)
    return MatvecQ4Plan(blocks=blocks, warps=MV_WARPS, ring=MV_RING,
                        smem_bytes=(in_dim // QK) * (176 if q4_1 else 168) + 8,
                        rows_per_warp=-(-out // (blocks * MV_WARPS)))


def _tree32(v: torch.Tensor, f) -> torch.Tensor:
    """``f`` over the last axis of 32 in the order in which lane 0 of a warp
    reduction by shuffles (xor 16, 8, 4, 2, 1) sees the lanes' values."""
    for s in (16, 8, 4, 2, 1):
        v = f(v[..., :s], v[..., s : 2 * s])
    return v[..., 0]


def _deinterleave(q: torch.Tensor) -> torch.Tensor:
    """Codes ``[nb, 32]`` in element order → bytes ``[nb, 32]`` as the
    kernels hold them: element 8g + 2t + p at byte 16p + 4g + t."""
    return q.reshape(-1, 4, 4, 2).permute(0, 3, 1, 2).reshape(-1, QK)


def quantize_blocks_q4_0(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 4-bit-activation Q4_0 kernel's quantizer, a quad of threads a
    32-block, as it fills shared memory: x ``[in]`` → (codes int8 ``[in/32, 32]``
    de-interleaved, the sum of each block's codes int32 ``[in/32]``, d_x
    ``[in/32]``); ``amax/7`` and ``1/d`` divided truly, ``trunc(x·inv ±
    ½)`` with each operation rounded."""
    xb = x.float().reshape(-1, QK)
    d = _tree32(xb.abs(), torch.maximum) / torch.full((xb.shape[0],), 7.0)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    q = torch.trunc(xb * inv[:, None] + torch.where(xb >= 0, 0.5, -0.5)).to(torch.int32)
    return _deinterleave(q).to(torch.int8), q.sum(dim=1, dtype=torch.int32), d


def quantize_blocks_q4_1(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 4-bit-activation Q4_1 kernel's quantizer, a quad of threads a
    32-block, as it fills shared memory: x ``[in]`` → (codes uint8 ``[in/32,
    32]`` de-interleaved, ``[in/32, 3]`` of each block's {d_x, m_x, Σx̂});
    min and max exact, ``(max − min)/15`` and ``1/d`` divided truly, ``x̂ =
    q·d_x + m_x`` rounded twice and Σx̂ added in the tree order of a warp's
    shuffle reduction."""
    xb = x.float().reshape(-1, QK)
    mn = _tree32(xb, torch.minimum)
    d = (_tree32(xb, torch.maximum) - mn) / torch.full_like(mn, 15.0)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    q = torch.trunc((xb - mn[:, None]) * inv[:, None] + 0.5)
    xh = q * d[:, None] + mn[:, None]
    return _deinterleave(q.to(torch.uint8)), torch.stack([d, mn, _tree32(xh, torch.add)], dim=1)


def _butterfly(acc: torch.Tensor) -> torch.Tensor:
    """The lanes' sums ``[out, 32]`` added as a warp's butterfly does (xor
    16, 8, 4, 2, 1): lane 0's result ``[out]``."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return acc[:, 0]


def _lane_sums(terms: torch.Tensor) -> torch.Tensor:
    """The 4-bit-activation kernels' sum of block terms ``[out, nb]``: lane
    l adds the terms of blocks l, l + 32, … in order, then the butterfly."""
    out, nb = terms.shape
    acc = torch.zeros((out, 32))
    for k in range(-(-nb // 32)):
        b = torch.arange(32) + 32 * k
        live, b = b < nb, b.clamp(max=nb - 1)
        acc = torch.where(live[None], acc + terms[:, b], acc)
    return _butterfly(acc)


def q4_0_matvec_lane_order(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """The Q4_0 4-bit-activation kernel's order of sums in PyTorch, for
    tests: block terms ``partial·(d_w·d_x)`` (an exact integer partial, two
    roundings) summed by :func:`_lane_sums`.  Every operation is one IEEE
    rounding, so on the CPU these are the kernel's bits."""
    q, dx = quantize_activations_q4_0_int(x)
    return _lane_sums(q4_0_block_partials(q, w).float() * (w.d * dx[None]))


def q4_1_matvec_lane_order(x: torch.Tensor, w: Q4_1Weight) -> torch.Tensor:
    """The Q4_1 4-bit-activation kernel's order of sums in PyTorch, for
    tests: per block ``nx = fma(d_x, Σn·q, m_x·Σn)`` and the term
    ``fma(m_w, Σx̂, d_w·nx)`` (the contraction nvcc chose for the first
    kernel's ``acc += d·nx + m·s``), Σx̂ as :func:`quantize_blocks_q4_1`
    adds it, summed by :func:`_lane_sums`.  The integer sums are exact and
    :func:`_fma` rounds once, so these are the kernel's bits."""
    q, dx, mx = quantize_activations_q4_1(x)
    xsum = quantize_blocks_q4_1(x)[1][:, 2]
    w0 = Q4_0Weight(w.qs, w.d)
    nq = _block_dots(q, w0) + 8.0 * q.reshape(-1, QK).sum(dim=1)  # Σ(n − 8)·q + 8·Σq: exact integers
    n = _block_dots(torch.ones_like(q), w0) + 8.0 * QK
    nx = _fma(dx[None], nq, mx[None] * n)
    return _lane_sums(_fma(w.m, xsum[None], w.d * nx))


def _fma(a, b, c):
    """An f32 fused multiply-add, rounded once: the exact product in f64,
    its sum with ``c`` rounded to odd in f64 (TwoSum's exact error says
    which way), then to nearest in f32, which rounds the exact value
    correctly (53 bits ≥ 24 + 2)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)
    even = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(even, torch.nextafter(s, torch.where(e > 0, math.inf, -math.inf)), s).float()


def _f32_lane_order(x: torch.Tensor, n: torch.Tensor, d: torch.Tensor, m: torch.Tensor = None) -> torch.Tensor:
    """The f32 matvec kernel's sums: lane l takes blocks ``l, l + 32, …``,
    each block's dot ``Σ_i n_i·x_i`` a chain of 32 FMAs from 0 in element
    order, then ``acc = fma(d_b, dot_b, acc)`` (with mins ``m``: ``acc =
    fma(d_b, dot_b, fma(m_b, S_b, acc))``, ``S_b`` the block's sum of x
    taken as the kernel does, four elements at a time); the warp's
    butterfly (xor 16, 8, 4, 2, 1) adds the lanes.  n ``[out, nb, 32]``."""
    out, nb, _ = n.shape
    xb = x.float().reshape(nb, QK)
    if m is not None:
        xsum = torch.zeros(nb)
        for j in range(8):
            v = xb[:, 4 * j : 4 * j + 4]
            xsum = xsum + (((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3])
    acc = torch.zeros((out, 32))
    for k in range(-(-nb // 32)):
        b = torch.arange(32) + 32 * k
        live, b = b < nb, b.clamp(max=nb - 1)
        dot = torch.zeros((out, 32))
        for i in range(QK):
            dot = _fma(n[:, b, i], xb[b, i][None], dot)
        inner = acc if m is None else _fma(m[:, b], xsum[b][None], acc)
        acc = torch.where(live[None], _fma(d[:, b], dot, inner), acc)
    return _butterfly(acc)


def q4_0_matvec_f32_lane_order(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """The Q4_0 f32 matvec kernel's order of sums in PyTorch, for tests
    (``_f32_lane_order`` with nibbles ``n − 8`` and the scales ``d``): the
    kernel's bits wherever the f64 sums that it rounds are exact."""
    out, in_dim = w.shape
    n = (unpack_nibbles(w.qs).float() - 8.0).reshape(out, in_dim // QK, QK)
    return _f32_lane_order(x, n, w.d)


def q4_1_matvec_f32_lane_order(x: torch.Tensor, w: Q4_1Weight) -> torch.Tensor:
    """The Q4_1 f32 matvec kernel's order of sums in PyTorch, for tests
    (``_f32_lane_order`` with nibbles ``n``, the deltas ``d`` and the mins
    ``m`` times each block's sum of x)."""
    out, in_dim = w.shape
    n = unpack_nibbles(w.qs).float().reshape(out, in_dim // QK, QK)
    return _f32_lane_order(x, n, w.d, w.m)


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
    plan = matvec_f32_plan(out, in_dim, _sm_count(x.device))
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matvec_f32(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, plan.blocks, _stream(x))
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
    y = _launch_matvec_q4(x, w, "q4_0_matvec")
    q4_0_matvec.launches += 1
    return y


q4_0_matvec.launches = 0


def _launch_matvec_q4(x: torch.Tensor, w, what: str) -> torch.Tensor:
    """Check and launch the 4-bit-activation matvec kernel of ``w``'s type
    (Q4_0 or Q4_1; one launch, no scratch; no count: the caller's wrapper
    counts its launch)."""
    out, in_dim = w.shape
    _check_weight(w, x, what)
    _check_x(x, (in_dim,), what)
    q4_1 = isinstance(w, Q4_1Weight)
    plan = matvec_q4_plan(out, in_dim, _sm_count(x.device), q4_1=q4_1)
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    lib = build.lib("q4_matvec")
    code = (lib.q4_1_matvec if q4_1 else lib.q4_0_matvec)(
        w.qs.data_ptr(), (w.dm if q4_1 else w.d).data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim,
        plan.blocks, _stream(x))
    build.check(code, what)
    return y


#: rows the multi-row kernel accepts (``MAX_MULTI_ROWS`` of the TPU kernel)
MAX_MULTI_ROWS = 32

#: the multi-row kernel's tiling (``MM_*`` in ``csrc/q4_matvec.cu``): output
#: rows a block, weight blocks a ring stage, blocks of a cluster that split
#: a tile's in-dim, a block's shared memory at most and an SM's (H100)
MULTI_TILE_ROWS, MULTI_KC, MULTI_MAX_SPLITS = 64, 16, 2
SMEM_PER_BLOCK, SMEM_PER_SM = 232448, 233472


@dataclasses.dataclass(frozen=True)
class MultiPlan:
    """How ``q4_0_matmul_multi`` cuts one call: ``tiles`` blocks of
    ``MULTI_TILE_ROWS`` output rows, each tile's in-dim chunks of
    ``MULTI_KC`` weight blocks split over a cluster of ``splits`` blocks
    (block r takes chunks r, r + splits, ...: ``chunk_sets[r]``), ``np``
    activation rows (B padded to 8), ``smem`` bytes of shared memory a
    block, ``blocks_per_sm`` of them resident on an SM."""

    np: int
    splits: int
    tiles: int
    chunks: int
    smem: int
    blocks_per_sm: int

    @property
    def chunk_sets(self) -> list:
        return [list(range(r, self.chunks, self.splits)) for r in range(self.splits)]

    @property
    def grid(self) -> tuple:
        return (self.splits, self.tiles)


def _multi_smem(np_: int) -> int:
    """Shared memory of the multi-row kernel at ``np_`` activation rows (a
    multiple of 8): its ring stages (``mm_stages``: 2 at 32 rows, else 3) of
    64 rows' nibbles and scales, the rows' codes and their {bias, dx} pairs
    (``mm_smem_bytes`` in the CUDA source)."""
    stage = MULTI_TILE_ROWS * (MULTI_KC * 16 + 16) + MULTI_TILE_ROWS * (MULTI_KC + 4) * 4 \
        + np_ * (MULTI_KC * 32 + 16) + MULTI_KC * np_ * 8
    return (2 if np_ == 32 else 3) * stage


def multi_plan(out: int, in_dim: int, B: int, sms: int = 132) -> MultiPlan:
    """The launch plan of the multi-row kernel for ``B`` rows against an
    ``[out, in_dim]`` weight on a card of ``sms`` SMs (the CUDA source
    computes the same shared memory, ``q4_0_matmul_multi_smem_bytes``).  A
    tile's in-dim chunks are split over 2 blocks of a cluster (the even
    and the odd ones) where the tiles alone would leave half the blocks
    that fit on the SMs unused, so that a small ``out`` still fills the
    card; no block of a cluster is left without a chunk."""
    if not 1 <= B <= MAX_MULTI_ROWS or in_dim % QK or in_dim < QK or out < 1:
        raise ValueError(f"multi_plan: {B} rows of {in_dim} against {out} outputs is no multi-row product")
    np_ = 8 * -(-B // 8)
    smem = _multi_smem(np_)
    tiles = -(-out // MULTI_TILE_ROWS)
    chunks = -(-(in_dim // QK) // MULTI_KC)
    # two blocks an SM where their shared memory fits (1 KB a block the card
    # reserves), but one at 9-16 rows: 128 registers of class sums a thread
    per_sm = 2 if np_ != 16 and 2 * (smem + 1024) <= SMEM_PER_SM else 1
    splits = MULTI_MAX_SPLITS if chunks >= MULTI_MAX_SPLITS and MULTI_MAX_SPLITS * tiles <= sms * per_sm else 1
    return MultiPlan(np=np_, splits=splits, tiles=tiles, chunks=chunks, smem=smem, blocks_per_sm=per_sm)


#: activation rows one launch of the T layout's integer product takes
#: (``MM_MAX_ROWS`` in ``csrc/q4_matvec.cu``: the multi-row kernel at up to
#: 8 tiles of 8 rows)
MAX_INT_LAUNCH_ROWS = 64


@dataclasses.dataclass(frozen=True)
class IntMatmulPlan:
    """How ``q4_0_int_matmul`` cuts N rows: ``launches`` of (first row, rows,
    :class:`MultiPlan`), each a pre-pass and one launch of the multi-row
    kernel at ``plan.np // 8`` tiles of 8 rows."""

    launches: tuple

    @property
    def np(self) -> int:
        """Rows of the largest launch's scratch."""
        return max(p.np for _, _, p in self.launches)


def int_matmul_plan(out: int, in_dim: int, N: int, sms: int = 132) -> IntMatmulPlan:
    """The launches of the T layout's integer product for ``N`` rows against
    an ``[out, in_dim]`` weight: calls of at most
    :data:`MAX_INT_LAUNCH_ROWS` rows in order.  A call of 1..32 rows takes
    :func:`multi_plan` (``q4_0_matmul_multi``'s launch, bit for bit); one
    of 33..64 rows holds one block an SM (its ring does not fit twice) and
    splits the in-dim over a cluster of 2 where that takes fewer waves of
    blocks (⌈blocks / SMs⌉ · chunks a block)."""
    if N < 1 or in_dim % QK or in_dim < QK or out < 1:
        raise ValueError(f"int_matmul_plan: {N} rows of {in_dim} against {out} outputs is no integer product")
    launches = []
    for n0 in range(0, N, MAX_INT_LAUNCH_ROWS):
        rows = min(MAX_INT_LAUNCH_ROWS, N - n0)
        if rows <= MAX_MULTI_ROWS:
            plan = multi_plan(out, in_dim, rows, sms)
        else:
            np_ = 8 * -(-rows // 8)
            tiles, chunks = -(-out // MULTI_TILE_ROWS), -(-(in_dim // QK) // MULTI_KC)

            def waves(s):
                return -(-tiles * s // sms) * -(-chunks // s)

            splits = MULTI_MAX_SPLITS if chunks >= MULTI_MAX_SPLITS and waves(MULTI_MAX_SPLITS) < waves(1) else 1
            plan = MultiPlan(np=np_, splits=splits, tiles=tiles, chunks=chunks, smem=_multi_smem(np_), blocks_per_sm=1)
        launches.append((n0, rows, plan))
    return IntMatmulPlan(launches=tuple(launches))


#: the f32-activation products' tiling on the bf16 tensor cores
#: (``FM_*`` in ``csrc/q4_f32_mma.cuh``): output rows a block, consumer
#: warps, the staged row counts (2: one or two rows, their three pieces as
#: MMA columns) and the ring's barrier bytes
F32_MMA_TILE_ROWS, F32_MMA_CONSUMERS = 64, 8
F32_MMA_NP = (2, 8, 16, 32, 48, 64)
F32_MMA_BAR_BYTES = 128


@dataclasses.dataclass(frozen=True)
class F32MmaPlan:
    """How one call of the f32-activation tensor-core product
    (``q4_0_matmul_multi_f32``, ``q4_0_matmul_t``) is cut: ``rows`` staged
    as ``np`` rows (2: one or two rows whose three bf16 pieces are MMA
    columns; else rows padded to 8, 16, 32, 48 or 64); ``cols`` MMA
    columns, each consumer warp on one block (two at 1 or 2 rows) of every
    chunk of ``kc`` weight blocks; ``tiles`` tiles of
    ``F32_MMA_TILE_ROWS`` output rows of
    ``chunks`` chunks each, and clusters of ``cluster`` blocks that share
    ``cluster_tiles`` tiles' (tile, chunk) units in contiguous ranges
    (``unit_ranges``); a ring of ``stages`` stages of ``stage_bytes`` after
    ``flush_bytes`` that keep a block's first tile's sums; ``smem`` bytes
    of shared memory a block, ``blocks_per_sm`` of them on an SM."""

    np: int
    cols: int
    kc: int
    stage_bytes: int
    flush_bytes: int
    stages: int
    smem: int
    blocks_per_sm: int
    cluster: int
    cluster_tiles: int
    tiles: int
    chunks: int

    @property
    def blocks(self) -> int:
        return self.cluster * -(-self.tiles // self.cluster_tiles)

    def unit_ranges(self, tiles: int = None) -> list:
        """The units [u0, u1) of each block of a cluster of ``tiles`` tiles
        (the last cluster may hold fewer), unit u = tile · chunks + chunk."""
        tiles = self.cluster_tiles if tiles is None else tiles
        units = tiles * self.chunks
        return [(r * units // self.cluster, (r + 1) * units // self.cluster) for r in range(self.cluster)]

    @property
    def partial_bytes(self) -> int:
        """Bytes of the partial sums that the ring takes at the end: the
        consumer warps' [warps of a group][cols][64] and, in a tile's owner,
        the [cluster][np][64] of the blocks that hold its units."""
        warps = F32_MMA_CONSUMERS // (1 if self.cols <= 16 else 2)
        return (warps * self.cols + self.cluster * self.np) * F32_MMA_TILE_ROWS * 4


def _f32_mma_clusters(np_: int, tiles: int, chunks: int, sms: int, per_sm: int) -> tuple:
    """(cluster, cluster_tiles): the shares of the tiles' units that leave
    the least work on the busiest SM, ``ceil(blocks / sms) · T / C`` tiles'
    worth, with ties to fewer blocks, then smaller clusters.  Up to 8 rows
    a cluster of C = 2 or 4 blocks shares T <= C tiles, where the blocks
    fill at most 90 % of the slots, so that all clusters are resident at
    once (clusters of 3, or 64 clusters of 4 in 264 slots, measured
    slower); beyond, a cluster of 2 splits one tile.  A block then owns at
    most one tile and its units lie in at most two.  Every block has a unit.  Up to 8 rows
    172 tiles (11008 outputs) take C = 4, T = 3 (232 blocks, 3/4 of a tile
    each), 64 (4096) C = 2, T = 1; 500 (32000) take one tile a block."""
    options = []
    for c in (1, 2, 4) if np_ <= 8 else (1, 2):
        for t in range(1, (c if np_ <= 8 else 1) + 1):
            last = tiles - (-(-tiles // t) - 1) * t
            blocks = c * -(-tiles // t)
            if last * chunks < c or (np_ <= 8 and c > 1 and blocks > 0.9 * sms * per_sm):
                continue
            options.append(((-(-blocks // sms)) * t / c, blocks, c, t))
    best = min(options)
    return best[2], best[3]


@functools.lru_cache(maxsize=None)
def f32_mma_plan(out: int, in_dim: int, rows: int, sms: int = 132) -> F32MmaPlan:
    """The launch plan of the f32-activation tensor-core product for
    ``rows`` (1..64) rows against an ``[out, in_dim]`` weight on a card of
    ``sms`` SMs; the CUDA source computes the same shared memory
    (``q4_0_f32_mma_smem_bytes``).  Up to 8 rows two blocks share an SM,
    from 9 rows one (its registers); up to 32 rows the ring takes as many
    stages, at most 8, as half an SM's shared memory holds, beyond as a
    block's whole.  Cached: a model asks for a few shapes, each hundreds of
    times a step."""
    if not 1 <= rows <= F32_MMA_NP[-1] or in_dim % QK or in_dim < QK or out < 1:
        raise ValueError(f"f32_mma_plan: {rows} rows of {in_dim} against {out} outputs is no such product")
    np_ = next(p for p in F32_MMA_NP if rows <= p)
    cols = 8 if np_ == 2 else np_
    kg = F32_MMA_CONSUMERS // (1 if cols <= 16 else 2)  # consumer warps on a group of n-tiles
    kc = kg * (2 if np_ == 2 else 1)  # two blocks a warp at 1 or 2 rows
    per_sm = 2 if np_ <= 8 else 1
    flush = kg * cols * F32_MMA_TILE_ROWS * 4 if np_ <= 8 else 0
    dstride = kc + (8 if kc == 4 else 4)
    stage = F32_MMA_TILE_ROWS * (kc * 16 + 16) + F32_MMA_TILE_ROWS * dstride * 4 + np_ * (kc * 128 + 16)
    budget = (SMEM_PER_SM // 2 - 1024 if np_ <= 32 else SMEM_PER_BLOCK) - F32_MMA_BAR_BYTES - flush
    stages = min(8, budget // stage)
    tiles = -(-out // F32_MMA_TILE_ROWS)
    chunks = -(-(in_dim // QK) // kc)
    cluster, cluster_tiles = _f32_mma_clusters(np_, tiles, chunks, sms, per_sm)
    return F32MmaPlan(np=np_, cols=cols, kc=kc, stage_bytes=stage, flush_bytes=flush, stages=stages,
                      smem=F32_MMA_BAR_BYTES + flush + stages * stage, blocks_per_sm=per_sm, cluster=cluster,
                      cluster_tiles=cluster_tiles, tiles=tiles, chunks=chunks)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_f32_mma(x: torch.Tensor, w: Q4_0Weight, rows: int, what: str) -> torch.Tensor:
    """Launch the f32-activation tensor-core product (``csrc/q4_f32_mma.cuh``
    through ``q4_matmul_t.cu``'s entry) for ``rows`` checked rows of x; no
    count: each wrapper counts its own launches."""
    out, in_dim = w.shape
    plan = f32_mma_plan(out, in_dim, rows, _sm_count(x.device))
    y = torch.empty((rows, out), dtype=torch.float32, device=x.device)
    code = build.lib("q4_matmul_t").q4_0_f32_mma(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, rows, plan.cluster,
        plan.cluster_tiles, _stream(x))
    build.check(code, what)
    return y


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
    return _launch_f32_mma(x, w, B, what)


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
    plan = multi_plan(out, in_dim, B, _sm_count(x.device))
    xq = torch.empty((plan.np, in_dim), dtype=torch.int8, device=x.device)
    bd = torch.empty((in_dim // QK, plan.np, 2), dtype=torch.int32, device=x.device)  # {bias, dx bits}
    y = torch.empty((B, out), dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_0_matmul_multi(
        w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr(), xq.data_ptr(), bd.data_ptr(), y.data_ptr(),
        out, in_dim, B, plan.splits, _stream(x),
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
    plan = matvec_f32_plan(out, in_dim, _sm_count(x.device), q4_1=True)
    y = torch.empty(out, dtype=torch.float32, device=x.device)
    code = build.lib("q4_matvec").q4_1_matvec_f32(
        w.qs.data_ptr(), w.dm.data_ptr(), x.data_ptr(), y.data_ptr(), out, in_dim, plan.blocks, _stream(x))
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
    y = _launch_matvec_q4(x, w, "q4_1_matvec")
    q4_1_matvec.launches += 1
    return y


q4_1_matvec.launches = 0


# ---------------------------------------------------------------------------
# the HBM stream probe (tools/kernelbench.py's read ceiling)
# ---------------------------------------------------------------------------

#: rows of a TPU probe tile: the entry point keeps one sum per tile
PROBE_TILE = 128


def _wrap_i32(v: int) -> int:
    return (int(v) + 2**31) % 2**32 - 2**31


def _probe_rows(sums: torch.Tensor, all_rows: bool) -> torch.Tensor:
    return sums if all_rows else sums[::PROBE_TILE]


PROBE_WARPS = 8  # warps of a probe block, a row each (``PROBE_WARPS`` in ``csrc/stream_probe.cu``)
PROBE_LOADS = 4  # 16-byte loads a lane keeps in flight (``PROBE_LOADS``)


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """The stream probe's launch: ``blocks`` blocks of ``warps`` warps,
    warp w of block g on row ``g·warps + w`` (``block_rows``: one contiguous
    span of whole rows a block, the hardware's block scheduler handing the
    blocks to the SMs), each lane with ``loads`` 16-byte loads of its row in
    flight; no shared memory."""

    out: int
    row_bytes: int
    blocks: int
    warps: int
    loads: int

    def block_rows(self, g: int) -> range:
        return range(g * self.warps, min((g + 1) * self.warps, self.out))


@functools.lru_cache(maxsize=None)
def probe_plan(out: int, in_dim: int) -> ProbePlan:
    """Plan of the stream probe's kernel: a warp a row, ``PROBE_WARPS``
    rows a block."""
    if out < 1 or in_dim < QK or in_dim % QK:
        raise ValueError(f"probe_plan: out {out}, in dim {in_dim}: the in dim must be a multiple of {QK}")
    return ProbePlan(out=out, row_bytes=in_dim // 2, blocks=-(-out // PROBE_WARPS), warps=PROBE_WARPS,
                     loads=PROBE_LOADS)


def stream_probe_plain(qs: torch.Tensor, bias: int, *, all_rows: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the probe: every row's ``Σ_k (word[r, k] +
    bias)`` over the little-endian int32 words of ``qs`` uint8 ``[out,
    in/2]``, wrapped to int32 (``torch.sum`` widens to int64) and rounded
    once to f32; rows 0, 128, 256, … unless ``all_rows``."""
    words = qs.contiguous().view(torch.int32).long()
    s = (words + _wrap_i32(bias)).sum(dim=1)
    sums = ((s + 2**31) % 2**32 - 2**31).to(torch.int32).float()
    return _probe_rows(sums, all_rows)


def stream_probe(qs: torch.Tensor, bias: int, *, all_rows: bool = False) -> torch.Tensor:
    """The read ceiling of a packed weight (``stream_probe`` of
    ``llama_swift_tpu/ops/q4_vpu_pallas.py``): ``qs`` uint8 ``[out, in/2]``
    (a :class:`Q4_0Weight`'s nibbles, ``out % 128 == 0``) → f32 ``[out/128]``,
    the int32 sum of each 128-row tile's first row of words, each word plus
    ``bias`` (an int, wrapped to int32, that a timing loop varies); with
    ``all_rows`` every row's sum ``[out]``, which the kernel always writes.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if qs.dim() != 2 or qs.dtype != torch.uint8 or qs.shape[0] % PROBE_TILE or qs.shape[1] % 16:
        raise ValueError(f"stream_probe: qs must be uint8 [out, in/2] with out % {PROBE_TILE} == 0 "
                         f"and in % 32 == 0, got {qs.dtype} {tuple(qs.shape)}")
    if qs.device.type == "cpu":
        return stream_probe_plain(qs, bias, all_rows=all_rows)
    if not qs.is_cuda or not qs.is_contiguous() or qs.data_ptr() % 16:
        raise ValueError("stream_probe: qs must be a contiguous, 16-byte aligned CUDA tensor")
    rows, in_dim = qs.shape[0], qs.shape[1] * 2
    sums = torch.empty(rows, dtype=torch.float32, device=qs.device)
    code = build.lib("stream_probe").stream_probe(
        qs.data_ptr(), _wrap_i32(bias), sums.data_ptr(), rows, in_dim, probe_plan(rows, in_dim).blocks, _stream(qs))
    build.check(code, "stream_probe")
    stream_probe.launches += 1
    return _probe_rows(sums, all_rows)


stream_probe.launches = 0
