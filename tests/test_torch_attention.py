"""Port's flash-decode attention (llama_swift_torch/ops/attention.py) against
the JAX package's flash_decode_attention (interpret mode) and
reference_decode_attention: n_past on and off chunk edges, a bf16 cache,
stale slots beyond n_past, and the stacked cache read at a layer index.  On
the CPU the wrapper runs the kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.ops.attention import flash_decode_attention, reference_decode_attention
from llama_swift_torch.ops import attention as tatt

L, H, C, D = 2, 4, 256, 128


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((H, D)).astype(np.float32)
    k = rng.standard_normal((L, H, C, D)).astype(np.float32)
    v = rng.standard_normal((L, H, C, D)).astype(np.float32)
    return q, k, v


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


@pytest.mark.parametrize("n_past", [0, 63, 64, 127, 128, 200, 255])
def test_flash_matches_jax_kernel_and_reference(qkv, n_past):
    q, k, v = qkv
    out = tatt.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1, n_past)
    jk = np.asarray(flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]), jnp.int32(n_past), chunk=128, interpret=True))
    ref = np.asarray(reference_decode_attention(jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]), n_past))
    assert _rel(out.numpy(), jk) <= 1e-5
    assert _rel(out.numpy(), ref) <= 1e-5
    port_ref = tatt.reference_decode_attention(torch.from_numpy(q), torch.from_numpy(k[1]), torch.from_numpy(v[1]), n_past)
    assert _rel(port_ref.numpy(), ref) <= 1e-5


def test_flash_ignores_stale_slots(qkv):
    q, k, v = qkv
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 50:] = 1e6
    v2[:, :, 50:] = -1e6
    out = tatt.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2), 0, 49)
    ref = np.asarray(reference_decode_attention(jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]), 49))
    assert _rel(out.numpy(), ref) <= 1e-5


def test_flash_bf16_cache(qkv):
    """Same bf16 cache values through both packages (the rounding to bf16 is
    the cache's; the attention itself runs in f32)."""
    q, k, v = qkv
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    out = tatt.flash_decode_attention(torch.from_numpy(q), kb, vb, 1, 200)
    jk = np.asarray(flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kb[1].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(vb[1].float().numpy()).astype(jnp.bfloat16), jnp.int32(200), chunk=128, interpret=True))
    assert _rel(out.numpy(), jk) <= 1e-5
