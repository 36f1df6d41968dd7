"""Q4_0 weights of the T layout and their products: the weight type, the
wrappers of the CUDA kernels for the T layout and their plain versions, and
the carriers of the JAX package's T and W layout leaves.

Counterpart of ``llama_swift_tpu/ops/q4_matmul_pallas.py`` (``Q4_0TensorT``;
the phase-dequant kernel ``_q4_0_phase_kernel`` behind
``q4_0_matmul_pallas``/``_stacked``; the integer kernel
``_q4_0_magic_kernel`` behind ``q4_0_int_matmul_pallas``/``_stacked``; the
multi-row kernel ``_multi_t_grid_kernel`` behind ``q4_0_t_matmul_multi``).
The JAX package picks the T layout for the tensor-parallel path
(``params_from_tensors(shard_pad > 1)`` on the accelerator; the port's
``q4_layout="t"`` asks for it anywhere).  Its ``linear`` tries the integer
kernel first, then the multi-row one, each behind a gate that is 0 there
(:data:`MAX_INT_KERNEL_ROWS`, :data:`MAX_MULTI_ROWS_T`), then sends 1–64
rows to the phase kernel; the port keeps the same gates at 0, so serving
takes the phase kernel's counterpart (:func:`q4_0_matmul_t`) and a caller
that raises a gate reaches the other two.

**Layout.**  :class:`Q4_0WeightT` keeps the logical bytes of
:class:`~.q4_matvec.Q4_0Weight` (nibbles ``[..., out, in/2]``, scales
``[..., out, in/32]``), without the TPU's ``[out/128, in/8, 128]`` tiling,
its 1024-multiple in-dim padding or its 128-row out granularity.  Only the
type differs: it tells ``linear`` to dispatch as the JAX package dispatches
``Q4_0TensorT``, and the Q4_0 dequant and the embedding gather read it as
they read any Q4_0 weight.  Because it subclasses ``Q4_0Weight``, every
``isinstance`` dispatch tests the T type first.  The TPU kernel of the
multi-row T product differs from the V layout's multi-row kernel only in
which axis its tiles put on lanes; with one logical layout for both, one
CUDA kernel (``csrc/q4_matvec.cu``) serves both, behind a wrapper and a
count of its own here (:func:`q4_0_t_matmul_multi`).

**Numerics.**  The phase kernel: ``y = x · deq(W)ᵀ`` in f32, each weight
``(n − 8)·d`` with one rounding; activations are fake-quantized by the
caller when the model quantizes them, as in the JAX package.  Its CUDA
counterpart (``csrc/q4_f32_mma.cuh``, shared with the f32-activation
multi-row product) takes each 32-block's dot from exact products of the
bf16 nibbles and an exact three-way bf16 split of x on the tensor cores,
then scales it by ``d``: within 2^-24 of each term of the plain version.
The integer and multi-row kernels: ``y = Σ_b d_w·d_x·(P − 8·S)`` with exact integer
block dots ``P`` of the 4-bit codes (``ggml_vec_dot_q4_0``); with f32 rows
the multi-row product takes ``Σ_b d_w·Σ_i (n − 8)·x_i``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import QK
from . import build
from .fused_layer import block_perm
from .q4_dequant import dequantize_q4_0
from .q4_matvec import (
    MAX_MULTI_ROWS,
    Q4_0Weight,
    _check_weight,
    _check_x,
    _launch_f32_mma,
    _launch_matvec_q4,
    _launch_q4_0_matmul_multi,
    _launch_q4_0_matmul_multi_f32,
    _launch_q4_0_matvec_f32,
    _sm_count,
    _stream,
    int_matmul_plan,
    q4_0_matmul_multi_f32_plain,
    q4_0_matmul_multi_plain,
)

#: rows above which the product dequantizes and multiplies instead
#: (``MAX_PHASE_KERNEL_ROWS`` of the TPU kernel)
MAX_PHASE_KERNEL_ROWS = 64

#: ``linear`` sends T products of at most this many rows, with quantized
#: activations, to the integer kernel (:func:`q4_0_int_matmul`).  0, as in
#: the JAX package (``q4_matmul_pallas.py:391``), which measured its integer
#: kernel slower end to end than the phase kernel on the TPU: the
#: block-diagonal expansion of the codes wastes about 16× of the matrix
#: unit's work, and its small per-phase dots are latency-bound.  A caller
#: may raise it, as the JAX package's tests do.
MAX_INT_KERNEL_ROWS = 0

#: ``linear`` sends T products of 1 to this many rows to the multi-row
#: kernel (:func:`q4_0_t_matmul_multi`).  0, as in the JAX package
#: (``q4_matmul_pallas.py:613``): on the TPU the T orientation needs a lane
#: broadcast of the activation column for every FMA, and batched serving
#: ran at 11.9 tok/s at 13B with B = 8.  A caller may raise it.
MAX_MULTI_ROWS_T = 0


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


def unpack_qs_v(qs4v: np.ndarray) -> np.ndarray:
    """JAX V (and W) layout words ``[..., out/128, 128, in/8]`` (group-major
    lanes: lane ``g·nb + b`` holds u32 #g of block b) → logical nibble bytes
    ``[..., out, in/2]`` — the inverse of ``_pack_qs_v``
    (``llama_swift_tpu/ops/q4_vpu_pallas.py:62-89``)."""
    qs4 = np.asarray(qs4v).view(np.uint32)
    *lead, ot, lt, kh4 = qs4.shape
    nb = kh4 // 4
    qs4 = qs4.reshape(*lead, ot * lt, 4, nb).swapaxes(-1, -2)  # [..., out, nb, 4]
    return np.ascontiguousarray(qs4).view(np.uint8).reshape(*lead, ot * lt, kh4 * 4)


def from_jax_w(qs4w: np.ndarray, scales_w: np.ndarray, in_dim: int, device="cpu") -> Q4_0Weight:
    """JAX W-layout leaves (``Q4_0TensorW`` of the fused-layer kernels,
    ``q4_fused_layer.py:80-124``) → :class:`~.q4_matvec.Q4_0Weight`:
    ``qs4w`` int32 ``[..., out/128, 128, in_pad/8]`` (the V layout's words)
    and ``scales_w`` f32 ``[..., out/128, 128, in_pad/32]``, both with the
    blocks permuted by λ (packed block position λ holds logical block
    ``block_perm(nb)[λ]``).  Undoes λ, then keeps columns ``[0, in_dim)``
    (the in-dim padding to a multiple of 4096 is dropped)."""
    qs = unpack_qs_v(qs4w)  # [..., out, in_pad/2]
    sc = np.asarray(scales_w, dtype=np.float32)
    sc = sc.reshape(*sc.shape[:-3], -1, sc.shape[-1])  # [..., out, in_pad/32]
    inv = np.argsort(block_perm(sc.shape[-1]))
    qs = qs.reshape(*qs.shape[:-1], -1, 16)[..., inv, :].reshape(qs.shape)
    sc = sc[..., inv]
    qs, sc = qs[..., : in_dim // 2], sc[..., : in_dim // QK]
    return Q4_0Weight(
        torch.from_numpy(np.ascontiguousarray(qs, dtype=np.uint8)).to(device),
        torch.from_numpy(np.ascontiguousarray(sc)).to(device),
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
    y = _launch_f32_mma(x, w, n, "q4_0_matmul_t")
    q4_0_matmul_t.launches += 1
    return y


q4_0_matmul_t.launches = 0


def q4_0_int_matmul_plain(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """Plain PyTorch version of the integer kernel: ``y [N, out]`` f32 from
    ``x [N, in]``, each row quantized per 32-block to integer codes, exact
    integer block partials (``q4_matvec.q4_0_block_partials``), then ``Σ_b
    partial · (d_w · d_x)``: the multi-row product's plain version, for any
    N."""
    return q4_0_matmul_multi_plain(x, w)


def q4_0_int_matmul(x: torch.Tensor, w: Q4_0Weight) -> torch.Tensor:
    """``y [N, out] = x [N, in] · Wᵀ`` for N ≥ 1 f32 rows with the
    reference's int4×int4 dot: each row quantized per 32-block to codes in
    [−7, 7] (by the kernel's pre-pass), exact block dots on the int8 tensor
    cores, the scales applied outside.  The kernel is the multi-row
    product's (``csrc/q4_matvec.cu``), up to 64 rows a launch; at 1–32 rows
    its result is :func:`~.q4_matvec.q4_0_matmul_multi`'s bit for bit.  No
    row cap: more than 64 rows run as further launches of the same weights
    inside one call (:func:`~.q4_matvec.int_matmul_plan`).  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return q4_0_int_matmul_plain(x, w)
    out, in_dim = w.shape
    _check_weight(w, x, "q4_0_int_matmul")
    n = x.shape[0] if x.dim() == 2 else 0
    _check_x(x, (n, in_dim), "q4_0_int_matmul")
    if n < 1:
        raise ValueError("q4_0_int_matmul: no rows")
    plan = int_matmul_plan(out, in_dim, n, _sm_count(x.device))
    xq = torch.empty((plan.np, in_dim), dtype=torch.int8, device=x.device)
    bd = torch.empty((in_dim // QK, plan.np, 2), dtype=torch.int32, device=x.device)  # {bias, dx bits}
    y = torch.empty((n, out), dtype=torch.float32, device=x.device)
    lib = build.lib("q4_matvec")
    for n0, rows, p in plan.launches:
        code = lib.q4_0_int_matmul(
            w.qs.data_ptr(), w.d.data_ptr(), x.data_ptr() + 4 * n0 * in_dim, xq.data_ptr(), bd.data_ptr(),
            y.data_ptr() + 4 * n0 * out, out, in_dim, rows, p.splits, _stream(x))
        build.check(code, "q4_0_int_matmul")
    q4_0_int_matmul.launches += 1
    return y


q4_0_int_matmul.launches = 0


def q4_0_t_matmul_multi_plain(x: torch.Tensor, w: Q4_0Weight, *, quantize_acts: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the multi-row T product: ``y [B, out]`` f32
    from ``x [B, in]`` — exact integer block dots of each row's 4-bit codes,
    or with ``quantize_acts=False`` the block dots ``Σ_i (n − 8)·x_i`` of
    the f32 rows, scaled by ``d_w``."""
    return (q4_0_matmul_multi_plain if quantize_acts else q4_0_matmul_multi_f32_plain)(x, w)


def q4_0_t_matmul_multi(x: torch.Tensor, w: Q4_0Weight, *, quantize_acts: bool = True) -> torch.Tensor:
    """``y [B, out] = x [B, in] · Wᵀ`` for 1 ≤ B ≤ 32 rows of a T-layout
    weight, one weight stream for all rows: with ``quantize_acts`` each row
    quantized per 32-block and dotted exactly (``ggml_vec_dot_q4_0``), else
    the f32 rows as they are (the JAX kernel's ``d_x = 1``).  The kernels
    are those of the V layout's products (``csrc/q4_matvec.cu``: the matvec
    at B = 1, the multi-row kernel from 2 rows, each in its quantized or f32
    form), which this wrapper launches and counts as its own.  CPU tensors
    take the plain version; CUDA tensors launch a kernel (or raise)."""
    B = x.shape[0] if x.dim() == 2 else 0
    if not 1 <= B <= MAX_MULTI_ROWS:  # the JAX function asserts the same cap
        raise ValueError(f"q4_0_t_matmul_multi: {B} rows, it takes 1..{MAX_MULTI_ROWS}")
    if x.device.type == "cpu":
        return q4_0_t_matmul_multi_plain(x, w, quantize_acts=quantize_acts)
    what = "q4_0_t_matmul_multi"
    if B == 1:
        launch = _launch_matvec_q4 if quantize_acts else _launch_q4_0_matvec_f32
        y = launch(x[0], w, what)[None]
    else:
        launch = _launch_q4_0_matmul_multi if quantize_acts else _launch_q4_0_matmul_multi_f32
        y = launch(x, w, what)
    q4_0_t_matmul_multi.launches += 1
    return y


q4_0_t_matmul_multi.launches = 0
