"""Quantized linear ops: ``y = x @ W.T`` for dense, Q4_0 and Q4_1 weights
(counterpart of ``llama_swift_tpu/ops/quantized_matmul.py``).

Parity-relevant semantics of the reference's quantized matmul
(``ggml_compute_forward_mul_mat_q4_0_f32``, ``ggml.c:5987-6285``): the
activations are quantized to Q4_0 too and the dot is int4×int4, scaled by
the product of block scales; rounding is half away from zero.

:func:`linear` dispatches on the weight type and the number of rows, as
the JAX package's ``linear`` does (``quantized_matmul.py:236-250`` there),
whatever ``quantize_activations`` is:

* Q4_0, one row → the matvec kernel (``ops/q4_matvec.py``): exact integer
  block dots on 4-bit activation codes, or with ``quantize_activations=False``
  the f32-activation matvec;
* Q4_0, 2–32 rows (the engine's batched decode step, short prefill chunks)
  → the multi-row kernel (same file): one weight stream for all rows, exact
  integer block dots per row, or the f32-activation multi-row kernel;
* Q4_0, more rows → fake-quantize the activations (when asked), dequantize
  the weight with the dequant kernel (``ops/q4_dequant.py``), then one
  ``torch.matmul`` (the JAX package leaves this product to XLA);
* Q4_1, one row → the Q4_1 matvec kernel (``ops/q4_matvec.py``), the
  activation quantized through Q4_1 (``ggml.c:6287+``), or the f32-activation
  Q4_1 matvec;
* Q4_1, any other row count → fake-quantize through Q4_1 (when asked), the
  Q4_1 dequant kernel, then one ``torch.matmul``: the JAX package has no
  Q4_1 multi-row kernel (``quantized_matmul.py:192-195`` there), so the
  engine's batched step dequantizes every weight too;
* Q4_0 of the T layout (:class:`~.q4_matmul.Q4_0WeightT`, the
  tensor-parallel path), tested before plain Q4_0 since it subclasses it,
  in the JAX package's order (``quantized_matmul.py:321-347`` there): with
  quantized activations and at most ``q4_matmul.MAX_INT_KERNEL_ROWS`` rows
  → the integer kernel; 1 to ``q4_matmul.MAX_MULTI_ROWS_T`` rows → the
  multi-row T product; 1–64 rows → fake-quantize the activations (when
  asked), then the phase kernel's counterpart; more rows → fake-quantize,
  the dequant kernel, then one ``torch.matmul``.  Both gates are 0, as in
  the JAX package, and are read at each call, so a caller may raise them.
  JAX's third condition, ``_pick_kt4(kh4)`` (a Mosaic tiling rule), holds
  for every in-dim after its 1024-padding and has no counterpart here;
* dense → ``torch.matmul`` in f32.

A CPU tensor takes each kernel's plain version.
"""

from __future__ import annotations

import torch

from ..config import QK
from .q4_dequant import dequantize_q4_0, dequantize_q4_1, q4_0_dequant, q4_1_dequant
from . import q4_matmul
from .q4_matmul import MAX_PHASE_KERNEL_ROWS, Q4_0WeightT, q4_0_int_matmul, q4_0_matmul_t, q4_0_t_matmul_multi
from .q4_matvec import (
    MAX_MULTI_ROWS,
    Q4_0Weight,
    Q4_1Weight,
    dequantize_activations_q4_1,
    q4_0_matmul_multi,
    q4_0_matvec,
    q4_1_matvec,
    quantize_activations_q4_1,
)

# f32 products on the card run in full f32: TF32 would keep ~3 decimal
# digits.  Both flags default to these values; set explicitly.  bf16
# products reduce in f32 as well.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = [
    "dequantize_q4_0", "dequantize_q4_1", "embedding_lookup", "fake_quantize_q4_0",
    "fake_quantize_q4_1", "linear", "round_half_away",
]


def round_half_away(v: torch.Tensor) -> torch.Tensor:
    """C ``round()``: half away from zero (``ggml.c:588``); ``torch.round``
    rounds half to even."""
    return torch.trunc(v + torch.where(v >= 0, 0.5, -0.5))


def fake_quantize_q4_0(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize activation rows through Q4_0 (the INIT phase of
    the reference's quantized matmul, ``ggml.c:6134-6151``).  x ``[..., k]``,
    k % 32 == 0; same shape and dtype out."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // QK, QK)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    d = amax / torch.full_like(amax, 7.0)  # true division on CUDA too (see q4_matvec)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    return (round_half_away(xf * inv) * d).reshape(shape).to(x.dtype)


def fake_quantize_q4_1(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize through Q4_1 (runtime ``quantize_row_q4_1``
    semantics, true min/max — ``ggml.c:606-648``): the codes and block
    constants of ``quantize_activations_q4_1`` (true division on the card
    too), then ``q·d + m``.  x ``[..., k]``, k % 32 == 0; same shape and
    dtype out."""
    return dequantize_activations_q4_1(*quantize_activations_q4_1(x)).to(x.dtype)


def _matmul_f32_out(x: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """``x @ wd.T`` with f32 accumulation and an f32 result (bf16 operands
    keep f32 outputs, as ``preferred_element_type=f32`` does in JAX)."""
    if wd.dtype == torch.float32:
        return torch.matmul(x.float(), wd.t())
    return torch.mm(x.to(wd.dtype), wd.t(), out_dtype=torch.float32)


def linear(
    x: torch.Tensor,
    w,
    *,
    quantize_activations: bool = True,
    compute_dtype=torch.float32,
    dense_matmul_dtype=None,
) -> torch.Tensor:
    """``y[..., out] = x[..., in] @ W[out, in].T`` (``ggml_mul_mat(w, x)``,
    ``ggml.c:3623-3646``).

    ``dense_matmul_dtype``: operand dtype of the prefill dense-dequant
    matmul on the card (``torch.bfloat16`` when ``cfg.prefill_bf16``); CPU
    tensors always compute in f32, as the JAX package does off the TPU.
    """
    lead = x.shape[:-1]
    if isinstance(w, (Q4_0Weight, Q4_1Weight)):
        q41 = isinstance(w, Q4_1Weight)
        out_dim, in_dim = w.shape
        n_rows = x.numel() // x.shape[-1]
        # T first (it subclasses Q4_0Weight); above 64 rows (and above the
        # gates) it takes the dequant below, past the branches of fewer rows
        if isinstance(w, Q4_0WeightT) and n_rows <= max(
                MAX_PHASE_KERNEL_ROWS, q4_matmul.MAX_INT_KERNEL_ROWS if quantize_activations else 0):
            x2 = x.reshape(n_rows, in_dim).float().contiguous()
            if quantize_activations and n_rows <= q4_matmul.MAX_INT_KERNEL_ROWS:
                y = q4_0_int_matmul(x2, w)
            elif 1 <= n_rows <= q4_matmul.MAX_MULTI_ROWS_T:
                y = q4_0_t_matmul_multi(x2, w, quantize_acts=quantize_activations)
            else:
                if quantize_activations:
                    x2 = fake_quantize_q4_0(x2)
                y = q4_0_matmul_t(x2, w)
            return y.reshape(*lead, out_dim).to(compute_dtype)
        if n_rows == 1:
            y = (q4_1_matvec if q41 else q4_0_matvec)(
                x.reshape(in_dim).float().contiguous(), w, quantize_acts=quantize_activations)
            return y.reshape(*lead, out_dim).to(compute_dtype)
        if not q41 and 1 < n_rows <= MAX_MULTI_ROWS:
            y = q4_0_matmul_multi(x.reshape(n_rows, in_dim).float().contiguous(), w,
                                  quantize_acts=quantize_activations)
            return y.reshape(*lead, out_dim).to(compute_dtype)
        if quantize_activations:
            x = (fake_quantize_q4_1 if q41 else fake_quantize_q4_0)(x)
        mm_dtype = dense_matmul_dtype if (dense_matmul_dtype is not None and x.is_cuda) else torch.float32
        wd = (q4_1_dequant if q41 else q4_0_dequant)(w, mm_dtype)
        y = _matmul_f32_out(x.reshape(n_rows, in_dim), wd)
        return y.reshape(*lead, out_dim).to(compute_dtype)
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(f"linear: weights of type {type(w).__name__} are not served by the port")
    return torch.matmul(x.float(), w.float().t()).to(compute_dtype)


def embedding_lookup(tokens: torch.Tensor, w, *, compute_dtype=torch.float32) -> torch.Tensor:
    """``ggml_get_rows`` (``ggml.c:6760-6920``): rows of the (possibly
    quantized) embedding table, dequantized to f32 per row.  A T-layout
    table (``quantized_matmul.py:518-535`` there) holds the logical bytes,
    so its rows are gathered and decoded as a Q4_0 table's."""
    if isinstance(w, Q4_0Weight):  # Q4_0WeightT too
        rows = Q4_0Weight(w.qs.index_select(0, tokens), w.d.index_select(0, tokens))
        return dequantize_q4_0(rows, compute_dtype)
    if isinstance(w, Q4_1Weight):  # a gather and n·d + m, as XLA does in JAX
        rows = Q4_1Weight(w.qs.index_select(0, tokens), w.dm.index_select(0, tokens))
        return dequantize_q4_1(rows, compute_dtype)
    return w.index_select(0, tokens).to(compute_dtype)
