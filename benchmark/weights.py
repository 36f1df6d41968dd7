"""The model's weights, made on the device from ``--seed``.

Each tensor (and each layer of a per-layer one) has a generator of its own,
seeded from the run's seed and the tensor's name and layer, so that the port
and the plain reference, which makes them again after the window, get the
same values without sharing a buffer.  A Q4_0 matrix ``[out, in]`` is made
as the port holds it: codes ``uint8 [out, in/2]`` (the even element in the
low nibble) and one f32 scale ``[out, in/32]`` a block.  Codes are uniform in
1..15 (values −7..7, as the GGML quantizer writes them, standard deviation
sqrt(56/3)); scales are uniform in [0.5, 1.5)·std/sqrt(56/3), full f32.
Norm vectors are 1 + 0.05·N(0, 1).
"""

from __future__ import annotations

import hashlib
import math

import torch

QK = 32
CODE_STD = math.sqrt(56.0 / 3.0)  # standard deviation of a value uniform in -7..7


def tensor_seed(seed: int, name: str, layer: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _generator(seed: int, name: str, layer: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(tensor_seed(seed, name, layer))
    return g


def q4_0(seed: int, name: str, layer: int, out: int, in_dim: int, std: float, device) -> tuple:
    """(codes ``uint8 [out, in/2]``, scales ``f32 [out, in/32]``)."""
    g = _generator(seed, name, layer, device)
    pairs = torch.randint(0, 225, (out, in_dim // 2), dtype=torch.uint8, device=device, generator=g)
    hi = torch.div(pairs, 15, rounding_mode="floor")
    qs = (pairs - hi * 15 + 1) | ((hi + 1) << 4)
    d = torch.rand((out, in_dim // QK), dtype=torch.float32, device=device, generator=g)
    d = (d + 0.5) * (std / CODE_STD)
    return qs, d


def norm_vector(seed: int, name: str, layer: int, n: int, device) -> torch.Tensor:
    g = _generator(seed, name, layer, device)
    return 1.0 + 0.05 * torch.randn((n,), dtype=torch.float32, device=device, generator=g)


def make(seed: int, spec, layer: int, device):
    """Tensor ``spec`` (a ``counts.<family>.Tensor``) of layer ``layer`` (0
    for a global one): a Q4_0 pair or a norm vector."""
    if spec.out is None:
        return norm_vector(seed, spec.name, layer, spec.in_dim, device)
    return q4_0(seed, spec.name, layer, spec.out, spec.in_dim, spec.std, device)

