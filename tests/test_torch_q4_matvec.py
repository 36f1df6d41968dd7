"""Port's Q4_0 matvec (llama_swift_torch/ops/q4_matvec.py) against the JAX
package: exact integer block partials, the activation quantizer's
half-away-from-zero ties, and y against the TPU kernel in interpret mode and
against fake-quant + dense dot.  On the CPU the wrapper runs the kernel's
plain version; the CUDA kernel itself is held against it by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.ops.q4_matmul_pallas import quantize_activations_q4_0_int
from llama_swift_tpu.ops.q4_vpu_pallas import Q4_0TensorV, q4_0_vpu_matvec
from llama_swift_tpu.ops.quantized_matmul import dequantize_q4_0_jnp, fake_quantize_q4_0
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.ops import q4_matvec as tmv

OUT, IN = 256, 1024


@pytest.fixture(scope="module")
def w_np():
    rng = np.random.default_rng(0)
    return Q4_0Tensor.quantize(rng.standard_normal((OUT, IN)).astype(np.float32) * 0.05)


@pytest.fixture(scope="module")
def w_t(w_np):
    return tmv.Q4_0Weight.from_q4_0(TQ4_0Tensor(w_np.scales, w_np.qs))


def _x(seed):
    return np.random.default_rng(seed).standard_normal(IN).astype(np.float32)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def test_activation_quantizer_bit_exact():
    x = _x(1)
    q, d = tmv.quantize_activations_q4_0_int(torch.from_numpy(x))
    qj, dj = quantize_activations_q4_0_int(jnp.asarray(x[None]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj)[0])
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj)[0])


def test_activation_quantizer_ties_round_half_away():
    """amax 7 gives d = 1, so ±2.5 and ±0.5 sit exactly on ties: half away
    from zero gives ±3 and ±1 where torch.round would give ±2 and 0."""
    x = np.zeros(IN, np.float32)
    x[:6] = [7.0, 2.5, -2.5, 0.5, -0.5, 1.5]
    q, d = tmv.quantize_activations_q4_0_int(torch.from_numpy(x))
    assert q[:6].tolist() == [7.0, 3.0, -3.0, 1.0, -1.0, 2.0]
    qj, _ = quantize_activations_q4_0_int(jnp.asarray(x[None]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj)[0])
    assert float(d[0]) == 1.0


def test_block_partials_exact(w_np, w_t):
    x = _x(2)
    q, _ = tmv.quantize_activations_q4_0_int(torch.from_numpy(x))
    parts = tmv.q4_0_block_partials(q, w_t).numpy()
    qi = q.numpy().astype(np.int64).reshape(IN // 32, 32)
    nib = np.empty((OUT, IN), np.int64)
    nib[:, 0::2] = w_np.qs & 0xF
    nib[:, 1::2] = w_np.qs >> 4
    expect = ((nib - 8).reshape(OUT, IN // 32, 32) * qi[None]).sum(-1)
    np.testing.assert_array_equal(parts, expect)


@pytest.mark.parametrize("seed", [3, 4])
def test_matvec_matches_tpu_kernel_interpret(w_np, w_t, seed):
    x = _x(seed)
    y = tmv.q4_0_matvec(torch.from_numpy(x), w_t).numpy()
    yj = np.asarray(q4_0_vpu_matvec(jnp.asarray(x[None]), Q4_0TensorV.from_q4_0(w_np), interpret=True))[0]
    assert _rel(y, yj) <= 1e-5


def test_matvec_matches_fake_quant_dense_dot(w_np, w_t):
    x = _x(5)
    y = tmv.q4_0_matvec(torch.from_numpy(x), w_t).numpy()
    ref = np.asarray(fake_quantize_q4_0(jnp.asarray(x))) @ np.asarray(dequantize_q4_0_jnp(w_np)).T
    assert _rel(y, ref) <= 1e-5


def test_layer_view_is_not_a_copy(w_t):
    stacked = tmv.Q4_0Weight(torch.stack([w_t.qs, w_t.qs]), torch.stack([w_t.d, w_t.d]))
    layer = stacked.layer(1)
    assert layer.qs.data_ptr() == stacked.qs[1].data_ptr()
    assert layer.shape == (OUT, IN)


def test_wrapper_rejects_bad_cuda_inputs(w_t):
    """A tensor that is not on the CPU never reaches the plain version."""
    x = torch.zeros(IN, device="meta")
    with pytest.raises(ValueError):
        tmv.q4_0_matvec(x, w_t)
