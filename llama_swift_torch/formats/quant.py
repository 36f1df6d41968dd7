"""Q4_0 / Q4_1 block-quantization codecs (host side, vectorized numpy).

Reimplements — bit-exactly, from semantics not from code — the reference's
scalar quantizers/dequantizers:

* ``ggml_quantize_q4_0`` / ``quantize_row_q4_0`` scalar path
  (``Sources/cpp/utils.cpp:431-485``, ``Sources/cpp/ggml.c:568-601``):
  32-element blocks, scale ``d = amax/7``, values ``round(v/d) + 8`` with C
  ``round()`` (half away from zero), two 4-bit values per byte
  (``lo | hi<<4``, byte *j* holds elements *2j* and *2j+1*), blocks stored
  interleaved in the row as ``[f32 d][16 nibble bytes]`` — 20 B per 32
  weights (``ggml.c:408, 2038-2039``).

* ``ggml_quantize_q4_1`` (``utils.cpp:487-544``) / ``quantize_row_q4_1``
  (``ggml.c:606-648``): min/delta affine blocks, stored *planar per row*:
  ``[nb × f32 min][nb × f32 d][nb × 16 nibble bytes]`` — 24 B per 32 weights.
  The offline tool variant (``utils.cpp:505``) initializes the running max
  with ``std::numeric_limits<float>::min()`` (= +FLT_MIN, a tiny *positive*
  number) instead of ``-FLT_MAX`` — so all-negative blocks get
  ``max ≈ 0``.  We replicate both variants behind ``tool_compat``.

* ``dequantize_row_q4_0`` / ``dequantize_row_q4_1`` (``ggml.c:651-717``).

The quantizers also produce the 16-bucket nibble histograms the quantize CLI
prints (``Sources/cpp/quantize.cpp:244-279``).

Host layout: :class:`Q4_0Tensor`/:class:`Q4_1Tensor` split the raw row
bytes into separate dense ``scales``/``qs`` (and ``mins``) arrays.  The
nibble-packed ``qs`` array keeps the file's even/odd intra-byte order, which
is also the port's device layout (``ops/q4_matvec.Q4_0Weight``).

A copy of ``llama_swift_tpu/formats/quant.py``: the port does not depend on
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import QK, GGMLType

FLT_MIN = np.float32(1.1754943508222875e-38)  # std::numeric_limits<float>::min()

Q4_0_BLOCK_BYTES = 4 + QK // 2  # [f32 d][16 nibble bytes] = 20
Q4_1_BLOCK_BYTES = 8 + QK // 2  # f32 min + f32 d + 16 nibble bytes = 24


def round_half_away(v: np.ndarray) -> np.ndarray:
    """C ``round()``: round half away from zero (``ggml.c:588``).

    numpy's ``np.round`` rounds half to even, which differs on exact .5 ties;
    SURVEY.md §7 pins half-away-from-zero as the canonical rounding.
    """
    return np.trunc(v + np.where(v >= 0, np.float32(0.5), np.float32(-0.5)))


def _pack_nibbles(qi: np.ndarray) -> np.ndarray:
    """Pack uint8 values in [0,16) pairwise: byte j = elem 2j | elem 2j+1 << 4
    (``utils.cpp:466-476``)."""
    lo = qi[..., 0::2]
    hi = qi[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def _unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_pack_nibbles`: bytes [..., n] -> values [..., 2n]
    with even elements from low nibbles (``ggml.c:664-666``)."""
    lo = packed & np.uint8(0xF)
    hi = packed >> np.uint8(4)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), dtype=np.uint8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


# ---------------------------------------------------------------------------
# Q4_0
# ---------------------------------------------------------------------------


def quantize_q4_0_values(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize ``x[..., k]`` (k % 32 == 0) to Q4_0.

    Returns ``(scales f32[..., k/32], qs uint8[..., k/16])`` with qs in
    packed-nibble file order.  Math per ``utils.cpp:448-476``.
    """
    assert x.shape[-1] % QK == 0, x.shape
    blocks = x.astype(np.float32).reshape(x.shape[:-1] + (x.shape[-1] // QK, QK))
    amax = np.max(np.abs(blocks), axis=-1)
    d = amax / np.float32(7.0)
    with np.errstate(divide="ignore"):
        inv_d = np.where(d != 0, np.float32(1.0) / np.where(d != 0, d, 1), np.float32(0.0))
    q = round_half_away(blocks * inv_d[..., None]).astype(np.int8) + np.int8(8)
    qi = q.astype(np.uint8)
    assert qi.max(initial=0) < 16 and qi.min(initial=0) >= 0
    packed = _pack_nibbles(qi).reshape(x.shape[:-1] + (x.shape[-1] // 2,))
    return d.astype(np.float32), packed


def dequantize_q4_0_values(scales: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Inverse transform (``dequantize_row_q4_0``, ``ggml.c:650-687``):
    ``v = (nibble - 8) * d``."""
    nb = scales.shape[-1]
    vals = _unpack_nibbles(qs).astype(np.float32) - np.float32(8.0)
    vals = vals.reshape(scales.shape[:-1] + (nb, QK))
    return (vals * scales[..., None].astype(np.float32)).reshape(
        scales.shape[:-1] + (nb * QK,)
    )


# ---------------------------------------------------------------------------
# Q4_1
# ---------------------------------------------------------------------------


def quantize_q4_1_values(
    x: np.ndarray, *, tool_compat: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize ``x[..., k]`` to Q4_1 affine blocks.

    Returns ``(mins, scales, qs_packed)``.  With ``tool_compat=True``
    replicates ``ggml_quantize_q4_1``'s running-max initialization to +FLT_MIN
    (``utils.cpp:505``); with ``False``, the runtime ``quantize_row_q4_1``
    semantics (true max, ``ggml.c:617-625``).
    """
    assert x.shape[-1] % QK == 0, x.shape
    blocks = x.astype(np.float32).reshape(x.shape[:-1] + (x.shape[-1] // QK, QK))
    mn = np.min(blocks, axis=-1)
    mx = np.max(blocks, axis=-1)
    if tool_compat:
        mx = np.maximum(mx, FLT_MIN)
        # the min loop init is FLT_MAX in both variants; only max differs
    d = (mx - mn) / np.float32(15.0)
    inv_d = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = round_half_away((blocks - mn[..., None]) * inv_d[..., None])
    # Reference stores through uint8 with assert 0<=v<16; tool_compat max-init
    # can push values of all-negative blocks above 15 — clamp like the
    # assert-disabled release build effectively wraps; we clamp instead to
    # keep values in-range (documented deviation; only reachable for
    # pathological all-negative blocks under tool_compat).
    qi = np.clip(q, 0, 15).astype(np.uint8)
    packed = _pack_nibbles(qi).reshape(x.shape[:-1] + (x.shape[-1] // 2,))
    return mn.astype(np.float32), d.astype(np.float32), packed


def dequantize_q4_1_values(
    mins: np.ndarray, scales: np.ndarray, qs: np.ndarray
) -> np.ndarray:
    """``v = nibble * d + m`` (``ggml.c:689-717``)."""
    nb = scales.shape[-1]
    vals = _unpack_nibbles(qs).astype(np.float32)
    vals = vals.reshape(scales.shape[:-1] + (nb, QK))
    out = vals * scales[..., None].astype(np.float32) + mins[..., None].astype(np.float32)
    return out.reshape(scales.shape[:-1] + (nb * QK,))


# ---------------------------------------------------------------------------
# Row-serialized (file) forms
# ---------------------------------------------------------------------------


def q4_0_rows_to_bytes(scales: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Serialize per-row Q4_0 arrays to the interleaved file layout
    ``[d0][nib0][d1][nib1]...`` (``utils.cpp:446-479``).

    scales: f32 [rows, nb]; qs: uint8 [rows, nb*16] -> uint8 [rows, nb*20].
    """
    rows, nb = scales.shape
    out = np.empty((rows, nb, Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :, :4] = scales.astype("<f4").view(np.uint8).reshape(rows, nb, 4)
    out[:, :, 4:] = qs.reshape(rows, nb, QK // 2)
    return out.reshape(rows, nb * Q4_0_BLOCK_BYTES)


def q4_0_bytes_to_rows(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Parse interleaved Q4_0 row bytes -> (scales [rows, nb], qs [rows, nb*16])."""
    rows, rowbytes = raw.shape
    assert rowbytes % Q4_0_BLOCK_BYTES == 0
    nb = rowbytes // Q4_0_BLOCK_BYTES
    blk = raw.reshape(rows, nb, Q4_0_BLOCK_BYTES)
    scales = np.ascontiguousarray(blk[:, :, :4]).view("<f4").reshape(rows, nb)
    qs = np.ascontiguousarray(blk[:, :, 4:]).reshape(rows, nb * QK // 2)
    return scales, qs


def q4_1_rows_to_bytes(
    mins: np.ndarray, scales: np.ndarray, qs: np.ndarray
) -> np.ndarray:
    """Serialize Q4_1 to the *planar-per-row* file layout
    ``[nb mins][nb ds][nibbles]`` (``utils.cpp:497-501``)."""
    rows, nb = scales.shape
    return np.concatenate(
        [
            mins.astype("<f4").view(np.uint8).reshape(rows, nb * 4),
            scales.astype("<f4").view(np.uint8).reshape(rows, nb * 4),
            qs.reshape(rows, nb * QK // 2),
        ],
        axis=1,
    )


def q4_1_bytes_to_rows(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows, rowbytes = raw.shape
    assert rowbytes % Q4_1_BLOCK_BYTES == 0
    nb = rowbytes // Q4_1_BLOCK_BYTES
    mins = np.ascontiguousarray(raw[:, : nb * 4]).view("<f4").reshape(rows, nb)
    scales = (
        np.ascontiguousarray(raw[:, nb * 4 : nb * 8]).view("<f4").reshape(rows, nb)
    )
    qs = np.ascontiguousarray(raw[:, nb * 8 :]).reshape(rows, nb * QK // 2)
    return mins, scales, qs


# ---------------------------------------------------------------------------
# Tensor wrappers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Q4_0Tensor:
    """A 2-D Q4_0 weight [rows, cols] in planar numpy arrays.

    ``scales`` f32 [rows, cols/32]; ``qs`` packed nibbles uint8 [rows, cols/2]
    in the file's even/odd order (byte j = cols 2j, 2j+1 of its block).
    """

    scales: np.ndarray
    qs: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return (self.qs.shape[0], self.qs.shape[1] * 2)

    @property
    def ggml_type(self) -> GGMLType:
        return GGMLType.Q4_0

    @classmethod
    def quantize(cls, x: np.ndarray) -> "Q4_0Tensor":
        scales, qs = quantize_q4_0_values(x)
        return cls(scales=scales, qs=qs)

    @classmethod
    def from_row_bytes(cls, raw: np.ndarray) -> "Q4_0Tensor":
        scales, qs = q4_0_bytes_to_rows(raw)
        return cls(scales=scales, qs=qs)

    def to_row_bytes(self) -> np.ndarray:
        return q4_0_rows_to_bytes(np.asarray(self.scales), np.asarray(self.qs))

    def dequantize(self) -> np.ndarray:
        return dequantize_q4_0_values(np.asarray(self.scales), np.asarray(self.qs))

    def nibble_histogram(self) -> np.ndarray:
        """16-bucket histogram over all stored nibbles (``quantize.cpp:252-279``)."""
        vals = _unpack_nibbles(np.asarray(self.qs))
        return np.bincount(vals.reshape(-1), minlength=16).astype(np.int64)


@dataclasses.dataclass
class Q4_1Tensor:
    """A 2-D Q4_1 weight [rows, cols]: ``mins``/``scales`` f32 [rows, cols/32],
    ``qs`` packed uint8 [rows, cols/2]."""

    mins: np.ndarray
    scales: np.ndarray
    qs: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return (self.qs.shape[0], self.qs.shape[1] * 2)

    @property
    def ggml_type(self) -> GGMLType:
        return GGMLType.Q4_1

    @classmethod
    def quantize(cls, x: np.ndarray, *, tool_compat: bool = True) -> "Q4_1Tensor":
        mins, scales, qs = quantize_q4_1_values(x, tool_compat=tool_compat)
        return cls(mins=mins, scales=scales, qs=qs)

    @classmethod
    def from_row_bytes(cls, raw: np.ndarray) -> "Q4_1Tensor":
        mins, scales, qs = q4_1_bytes_to_rows(raw)
        return cls(mins=mins, scales=scales, qs=qs)

    def to_row_bytes(self) -> np.ndarray:
        return q4_1_rows_to_bytes(
            np.asarray(self.mins), np.asarray(self.scales), np.asarray(self.qs)
        )

    def dequantize(self) -> np.ndarray:
        return dequantize_q4_1_values(
            np.asarray(self.mins), np.asarray(self.scales), np.asarray(self.qs)
        )

    def nibble_histogram(self) -> np.ndarray:
        vals = _unpack_nibbles(np.asarray(self.qs))
        return np.bincount(vals.reshape(-1), minlength=16).astype(np.int64)


QuantizedTensor = (Q4_0Tensor, Q4_1Tensor)


def row_nbytes(ftype: GGMLType, cols: int) -> int:
    """Bytes per row of a 2-D tensor for each GGML dtype
    (type-size table ``ggml.c:2026-2049``)."""
    if ftype == GGMLType.F32:
        return cols * 4
    if ftype == GGMLType.F16:
        return cols * 2
    if ftype == GGMLType.Q4_0:
        assert cols % QK == 0
        return cols // QK * Q4_0_BLOCK_BYTES
    if ftype == GGMLType.Q4_1:
        assert cols % QK == 0
        return cols // QK * Q4_1_BLOCK_BYTES
    raise ValueError(f"unknown ftype {ftype}")
