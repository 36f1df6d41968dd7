"""Shapes, bytes and operations of a LLaMA-family model served on Q4_0
weights (GGML type 2: 16 bytes of 4-bit codes and one f32 scale a block of
32 weights, 0.625 bytes a weight).

The least time a piece of work can take on the card is the larger of its
bytes over the HBM rate and its operations over the peak of their type
(``benchmark/peaks.py``).  Each input byte is counted read once and each
output byte written once, whatever a kernel reads again.  The arithmetic of
the megakernel's and the dequant's bounds follows ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

from .. import peaks

QK = 32
Q4_0_BYTES_PER_WEIGHT = (QK // 2 + 4) / QK


@dataclasses.dataclass(frozen=True)
class Dims:
    D: int  # n_embd
    H: int  # heads
    L: int  # layers
    F: int  # FFN hidden size
    V: int  # vocabulary
    n_ctx: int
    kv_bytes: int  # bytes of one cached K or V element

    @property
    def Dh(self) -> int:
        return self.D // self.H


@dataclasses.dataclass(frozen=True)
class Tensor:
    """One weight of the model as the benchmark makes it: a Q4_0 matrix
    ``[out, in]`` whose products have about ``std`` per unit input, or (``out``
    None) an f32 norm vector of ``in_dim``."""

    name: str
    out: int
    in_dim: int
    std: float = 0.0


_KV_BYTES = {"float32": 4, "bfloat16": 2}


def dims(cfg: dict) -> Dims:
    p = cfg["port"]
    return Dims(D=p["n_embd"], H=p["n_head"], L=p["n_layer"], F=p["n_ff"], V=p["n_vocab"], n_ctx=p["n_ctx"],
                kv_bytes=_KV_BYTES[p["kv_cache_dtype"]])


def layer_shapes(d: Dims) -> list:
    """The four products of a layer on fused params, in the order a forward
    computes them: wqkv, wo, w13, w2 (``[out, in]``)."""
    return [(3 * d.D, d.D), (d.D, d.D), (2 * d.F, d.D), (d.D, d.F)]


def tensors(d: Dims) -> list:
    """Every weight of the model: the three global ones, then the six each
    layer has."""
    return [
        Tensor("tok_embeddings", d.V, d.D, 1.0),
        Tensor("norm", None, d.D),
        Tensor("output", d.V, d.D, d.D ** -0.5),
        Tensor("attention_norm", None, d.D),
        Tensor("wqkv", 3 * d.D, d.D, d.D ** -0.5),
        Tensor("wo", d.D, d.D, d.D ** -0.5),
        Tensor("ffn_norm", None, d.D),
        Tensor("w13", 2 * d.F, d.D, d.D ** -0.5),
        Tensor("w2", d.D, d.F, d.F ** -0.5),
    ]


def q4_bytes(out: int, in_dim: int) -> float:
    return out * in_dim * Q4_0_BYTES_PER_WEIGHT


def layer_weight_bytes(d: Dims) -> float:
    """Q4_0 bytes of every layer's four products."""
    return d.L * sum(q4_bytes(o, i) for o, i in layer_shapes(d))


def output_weight_bytes(d: Dims) -> float:
    return q4_bytes(d.V, d.D)


def layer_params(d: Dims) -> int:
    return sum(o * i for o, i in layer_shapes(d))


def megakernel_bytes(d: Dims, n_past: int) -> float:
    """One launch of the whole-stack kernel at ``n_past``: every layer's
    weights and norms, the keys and values of positions ``0..n_past`` read
    and the new row written (``n_past + 2`` rows of K and of V a layer), x
    in and out."""
    return (layer_weight_bytes(d) + 2 * d.L * d.D * 4
            + 2 * d.L * d.H * (n_past + 2) * d.Dh * d.kv_bytes + 2 * d.D * 4)


def megakernel_ops(d: Dims) -> float:
    """Integer multiply-adds of the 4-bit block dots, two operations each."""
    return 2.0 * d.L * layer_params(d)


def megakernel_bound_s(d: Dims, n_past: int) -> float:
    return max(megakernel_bytes(d, n_past) / peaks.HBM_BYTES_PER_S, megakernel_ops(d) / peaks.INT8_OPS)


def decode_step_bytes(d: Dims, n_past: int) -> float:
    """One decoded token: the megakernel's bytes, the embedding row, the
    final norm, the output projection's weights, x and the logits."""
    return (megakernel_bytes(d, n_past) + q4_bytes(1, d.D) + d.D * 4
            + output_weight_bytes(d) + d.D * 4 + d.V * 4)


def decode_step_ops(d: Dims) -> float:
    return megakernel_ops(d) + 2.0 * d.V * d.D


def decode_step_bound_s(d: Dims, n_past: int) -> float:
    return max(decode_step_bytes(d, n_past) / peaks.HBM_BYTES_PER_S, decode_step_ops(d) / peaks.INT8_OPS)


def token_weight_bytes(d: Dims) -> float:
    """Q4_0 bytes a decoded token reads, before its keys and values."""
    return layer_weight_bytes(d) + output_weight_bytes(d)


def prefill_dequant_shapes(d: Dims) -> list:
    """The Q4_0 dequant launches of one prefill, in order: each layer's four
    products, then the output projection."""
    return layer_shapes(d) * d.L + [(d.V, d.D)]


def dequant_bound_s(out: int, in_dim: int) -> float:
    """Q4_0 read once, bf16 written once."""
    return (q4_bytes(out, in_dim) + 2 * out * in_dim) / peaks.HBM_BYTES_PER_S


def prefill_flops(d: Dims, n_tokens: int, n_past: int = 0) -> float:
    """FLOPs a prompt of ``n_tokens`` real tokens needs: the layers' products
    on those rows, causal attention over ``n_past + i + 1`` keys for row i
    (scores and the weighted sum, 2·D multiply-adds a key), and the output
    row of the last position."""
    keys = n_tokens * n_past + n_tokens * (n_tokens + 1) // 2
    return 2.0 * n_tokens * d.L * layer_params(d) + 4.0 * d.L * d.D * keys + 2.0 * d.V * d.D
