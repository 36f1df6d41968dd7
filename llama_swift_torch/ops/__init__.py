"""Ops of the port: plain PyTorch tensor code, and the hand-written CUDA
kernels of the serving paths: the batch-1 path (matvec, flash decode,
dequant), the engine's batched decode (multi-row matmul, batched and
paged flash decode), the int8 KV cache (the three flash-decode kernels
over int8 codes and row scales), the whole-stack batch-1 decode kernel
on fused wqkv/w13 params, Q4_1 weights (the Q4_1 matvec and the Q4_1
dequant), f32 activations (the Q4_0 and Q4_1 matvecs and the Q4_0
multi-row matmul on unquantized rows), the T layout of the
tensor-parallel path (the 1–64-row Q4_0 product on f32 rows, and behind
gates that are 0, as in the JAX package, the exact integer product on the
int8 tensor cores and the multi-row T product), one decode layer in two
kernels (the attention block and the FFN block), the HBM stream probe
of ``tools/kernelbench.py``, and causal prefill attention (one launch a
layer of every prefill forward)."""

from .attention import (
    flash_decode_attention,
    flash_decode_attention_batched,
    flash_decode_attention_batched_int8,
    flash_decode_attention_paged,
    flash_decode_attention_paged_int8,
    flash_decode_attention_stacked_int8,
    flash_prefill_attention,
)
from .fused_layer import fused_attn_block, fused_ffn_block, fused_layers_block
from .q4_dequant import q4_0_dequant, q4_1_dequant
from .q4_matmul import q4_0_int_matmul, q4_0_matmul_t, q4_0_t_matmul_multi
from .q4_matvec import (
    q4_0_matmul_multi,
    q4_0_matmul_multi_f32,
    q4_0_matvec,
    q4_0_matvec_f32,
    q4_1_matvec,
    q4_1_matvec_f32,
    stream_probe,
)

#: every kernel wrapper; each carries a ``launches`` counter
KERNELS = (
    q4_0_matvec, flash_decode_attention, q4_0_dequant,
    q4_0_matmul_multi, flash_decode_attention_batched, flash_decode_attention_paged,
    flash_decode_attention_stacked_int8, flash_decode_attention_batched_int8, flash_decode_attention_paged_int8,
    fused_layers_block, q4_1_matvec, q4_1_dequant,
    q4_0_matvec_f32, q4_1_matvec_f32, q4_0_matmul_multi_f32, q4_0_matmul_t,
    q4_0_int_matmul, q4_0_t_matmul_multi, fused_attn_block, fused_ffn_block, stream_probe,
    flash_prefill_attention,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    flash_prefill_attention.keys_read = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
