"""Port's Q4_0 dequant (llama_swift_torch/ops/q4_dequant.py) is bit-exact
against the JAX package's dequantize_q4_0_jnp, in f32 and in bf16, and the
prefill linear built on it agrees with the JAX linear.  On the CPU the
wrapper runs the kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.ops.quantized_matmul import dequantize_q4_0_jnp, linear as jlinear
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.ops.q4_dequant import q4_0_dequant
from llama_swift_torch.ops.q4_matvec import Q4_0Weight
from llama_swift_torch.ops.quantized_matmul import linear


@pytest.fixture(scope="module")
def w_np():
    rng = np.random.default_rng(3)
    return Q4_0Tensor.quantize(rng.standard_normal((256, 1024)).astype(np.float32) * 0.05)


@pytest.fixture(scope="module")
def w_t(w_np):
    return Q4_0Weight.from_q4_0(TQ4_0Tensor(w_np.scales, w_np.qs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_bit_exact(w_np, w_t, dtype):
    dense = q4_0_dequant(w_t, getattr(torch, dtype)).float().numpy()
    expect = np.asarray(dequantize_q4_0_jnp(w_np, dtype=getattr(jnp, dtype)).astype(jnp.float32))
    np.testing.assert_array_equal(dense, expect)


def test_prefill_linear_matches_jax(w_np, w_t):
    x = np.random.default_rng(4).standard_normal((8, 1024)).astype(np.float32)
    y = linear(torch.from_numpy(x), w_t).numpy()
    yj = np.asarray(jlinear(jnp.asarray(x), w_np))
    assert np.max(np.abs(y - yj)) / np.max(np.abs(yj)) <= 1e-5
