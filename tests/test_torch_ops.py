"""Port's plain tensor ops against the JAX package: norms, rope,
fake-quantization, round-half-away and the embedding lookup."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.ops import norms as jnorms
from llama_swift_tpu.ops import quantized_matmul as jqmm
from llama_swift_tpu.ops.rope import rope as jrope
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.ops import norms, quantized_matmul as qmm
from llama_swift_torch.ops.q4_matvec import Q4_0Weight
from llama_swift_torch.ops.rope import rope


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
def test_norms(norm_type):
    x = _rng(0).standard_normal((3, 256)).astype(np.float32) * 3 + 1
    w = _rng(1).standard_normal(256).astype(np.float32)
    y = norms.norm(torch.from_numpy(x), torch.from_numpy(w), norm_type).numpy()
    yj = np.asarray(jnorms.norm(jnp.asarray(x), jnp.asarray(w), norm_type))
    np.testing.assert_allclose(y, yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_past", [0, 37])
def test_rope(n_past):
    x = _rng(2).standard_normal((5, 4, 128)).astype(np.float32)
    pos = np.arange(n_past, n_past + 5, dtype=np.int32)
    y = rope(torch.from_numpy(x), torch.from_numpy(pos), 128).numpy()
    yj = np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), 128))
    np.testing.assert_allclose(y, yj, rtol=1e-5, atol=1e-5)


def test_fake_quantize_bit_exact():
    x = _rng(3).standard_normal((4, 256)).astype(np.float32)
    x[0, :3] = [7.0, 2.5, -0.5]  # ties on the first block (d = 1)
    np.testing.assert_array_equal(
        qmm.fake_quantize_q4_0(torch.from_numpy(x)).numpy(), np.asarray(jqmm.fake_quantize_q4_0(jnp.asarray(x))))
    np.testing.assert_array_equal(
        qmm.fake_quantize_q4_1(torch.from_numpy(x)).numpy(), np.asarray(jqmm.fake_quantize_q4_1(jnp.asarray(x))))


def test_round_half_away():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49], np.float32)
    np.testing.assert_array_equal(
        qmm.round_half_away(torch.from_numpy(v)).numpy(), np.asarray(jqmm.round_half_away_jnp(jnp.asarray(v))))


def test_embedding_lookup_q4_0_and_dense():
    table = _rng(4).standard_normal((64, 128)).astype(np.float32)
    tq = Q4_0Tensor.quantize(table)
    toks = np.array([0, 5, 63, 5], np.int64)
    got = qmm.embedding_lookup(torch.from_numpy(toks), Q4_0Weight.from_q4_0(TQ4_0Tensor(tq.scales, tq.qs)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jqmm.embedding_lookup(jnp.asarray(toks), tq)))
    dense = qmm.embedding_lookup(torch.from_numpy(toks), torch.from_numpy(table))
    np.testing.assert_array_equal(dense.numpy(), table[toks])


def test_dense_linear():
    x = _rng(5).standard_normal((3, 128)).astype(np.float32)
    w = _rng(6).standard_normal((64, 128)).astype(np.float32)
    y = qmm.linear(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(y, np.asarray(jqmm.linear(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)
