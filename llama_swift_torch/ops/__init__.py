"""Ops of the port: plain PyTorch tensor code, and the three hand-written
CUDA kernels of the batch-1 serving path (matvec, flash decode, dequant)."""

from .attention import flash_decode_attention
from .q4_dequant import q4_0_dequant
from .q4_matvec import q4_0_matvec

#: every kernel wrapper; each carries a ``launches`` counter
KERNELS = (q4_0_matvec, flash_decode_attention, q4_0_dequant)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
