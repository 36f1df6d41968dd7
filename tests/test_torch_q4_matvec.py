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
from llama_swift_tpu.ops.quantized_matmul import dequantize_q4_0_jnp, fake_quantize_q4_0, linear
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


# ---------------------------------------------------------------------------
# the 4-bit-activation kernel's quantizer, launch plan and order of sums
# (csrc/q4_matvec.cu q4_matvec_kernel<BlockQ4_0>; on the card the kernel is
# held to q4_0_matvec_lane_order bit for bit, tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


def _ties_and_zeros(seed):
    """Random x with a block of exact ties (amax 7: d = 1, values k + ½), an
    all-zero block (d = 0) and a block of one sign."""
    x = _x(seed)
    x[:32] = [7.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5] * 4
    x[32:64] = 0.0
    x[64:96] = np.abs(x[64:96])
    return x


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_block_quantizer_bit_exact_vs_jax(seed):
    """A thread a 32-block gives the warp-a-block quantizer's codes, sums of
    codes and scales: the JAX quantizer's q and d bit for bit, the codes
    de-interleaved (element 8g + 2t + p at byte 16p + 4g + t)."""
    x = _ties_and_zeros(seed)
    codes, qsum, dx = tmv.quantize_blocks_q4_0(torch.from_numpy(x))
    qj, dj = quantize_activations_q4_0_int(jnp.asarray(x[None]))
    qj = np.asarray(qj)[0].reshape(-1, 32)
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dj)[0])
    np.testing.assert_array_equal(qsum.numpy(), qj.sum(axis=1))
    back = codes.numpy().reshape(-1, 2, 4, 4).transpose(0, 2, 3, 1).reshape(-1, 32)
    np.testing.assert_array_equal(back, qj)
    assert codes.dtype == torch.int8 and float(dx[1]) == 0.0 and float(dx[0]) == 1.0


@pytest.mark.parametrize("q4_1", [False, True])
@pytest.mark.parametrize("in_dim", [32, 4096, 11008, 13824, 22016, tmv.MAX_Q4_IN])
def test_q4_plan_stages_x_within_a_block(in_dim, q4_1):
    """168 (Q4_0) or 176 (Q4_1) bytes of staged x, codes and block data per
    32 elements and an 8-byte barrier: within a block's 227 KB up to
    ``MAX_Q4_IN`` (Q4_1 there: 225,288 bytes), one 32-warp block an SM."""
    plan = tmv.matvec_q4_plan(8192, in_dim, 132, q4_1=q4_1)
    assert plan.smem_bytes == (in_dim // 32) * (176 if q4_1 else 168) + 8 <= tmv.SMEM_PER_BLOCK
    assert (plan.blocks, plan.warps, plan.ring) == (132, tmv.MV_WARPS, tmv.MV_RING) and tmv.MV_BLOCKS_PER_SM == 1


@pytest.mark.parametrize("q4_1", [False, True])
def test_q4_plan_refuses_in_dims_beyond_the_cap(q4_1):
    """One block of x more than ``MAX_Q4_IN`` would not fit: refused."""
    with pytest.raises(ValueError):
        tmv.matvec_q4_plan(4096, tmv.MAX_Q4_IN + 32, q4_1=q4_1)


@pytest.mark.parametrize("out", [1, 15, 16, 17, 2112, 4096, 4224, 11008, 32000])
def test_q4_plan_gives_every_row_to_one_warp(out):
    """A block an SM (no more blocks than rows); warp w of block g takes
    rows w·blocks + g + k·blocks·warps: each row exactly once, and the
    blocks' rows differ by one at most."""
    plan = tmv.matvec_q4_plan(out, 4096, 132)
    assert plan.blocks == min(out, 132)
    rows = [r for g in range(plan.blocks) for w in range(plan.warps) for r in plan.warp_rows(out, g, w)]
    assert sorted(rows) == list(range(out))
    per_block = [sum(len(plan.warp_rows(out, g, w)) for w in range(plan.warps)) for g in range(plan.blocks)]
    assert max(per_block) - min(per_block) <= 1
    assert max(len(plan.warp_rows(out, g, w)) for g in range(plan.blocks) for w in range(plan.warps)) \
        == plan.rows_per_warp


@pytest.mark.parametrize("out,in_dim", [(16, 48), (0, 64), (16, 0)])
def test_q4_plan_refuses_ragged_or_empty_shapes(out, in_dim):
    with pytest.raises(ValueError):
        tmv.matvec_q4_plan(out, in_dim)


def _weight(out, in_dim, seed):
    w = Q4_0Tensor.quantize(np.random.default_rng(seed).standard_normal((out, in_dim)).astype(np.float32) * 0.05)
    return w, tmv.Q4_0Weight.from_q4_0(TQ4_0Tensor(w.scales, w.qs))


@pytest.mark.parametrize("out,in_dim", [(128, 256), (128, 1056), (256, 2080)])
def test_lane_order_matches_plain_and_jax(out, in_dim):
    """In-dims of 8, 33 (a lane with a second block) and 65 blocks (a ragged
    third lane step), within 1e-5 of max |y| of the plain version, of the
    TPU kernel in interpret mode and of the JAX package's Pallas-free
    product (``linear(..., prefer_pallas=False)``): the same exact block
    partials, summed in other orders."""
    t, w = _weight(out, in_dim, seed=in_dim)
    x = np.random.default_rng(in_dim + 1).standard_normal(in_dim).astype(np.float32)
    got = tmv.q4_0_matvec_lane_order(torch.from_numpy(x), w).numpy()
    assert _rel(got, tmv.q4_0_matvec_plain(torch.from_numpy(x), w).numpy()) <= 1e-5
    assert _rel(got, np.asarray(q4_0_vpu_matvec(jnp.asarray(x[None]), Q4_0TensorV.from_q4_0(t), interpret=True))[0]) \
        <= 1e-5
    assert _rel(got, np.asarray(linear(jnp.asarray(x), t, prefer_pallas=False))) <= 1e-5


def test_lane_order_is_the_order_of_the_sums():
    """The mirror equals a lane-by-lane reference written out in numpy f32
    (each product and sum rounded once), bit for bit: lane l adds
    partial·(d_w·d_x) of blocks l, l + 32, … in order, then the butterfly."""
    out, in_dim = 5, 2080
    t, w = _weight(out, in_dim, seed=9)
    x = np.random.default_rng(10).standard_normal(in_dim).astype(np.float32)
    x[:IN] = _ties_and_zeros(10)
    got = tmv.q4_0_matvec_lane_order(torch.from_numpy(x), w).numpy()
    qj, dj = quantize_activations_q4_0_int(jnp.asarray(x[None]))
    q = np.asarray(qj)[0].astype(np.int64).reshape(-1, 32)
    dx = np.asarray(dj)[0]
    nib = np.empty((out, in_dim), np.int64)
    nib[:, 0::2] = t.qs & 0xF
    nib[:, 1::2] = t.qs >> 4
    nb = in_dim // 32
    for o in range(out):
        lanes = []
        for lane in range(32):
            acc = np.float32(0.0)
            for b in range(lane, nb, 32):
                part = np.float32(((nib[o, 32 * b : 32 * b + 32] - 8) * q[b]).sum())
                acc = np.float32(acc + np.float32(part * np.float32(t.scales[o, b] * dx[b])))
            lanes.append(acc)
        for s in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ s]) for i in range(32)]
        assert got[o] == lanes[0], o


def test_exact_fma_rounds_once():
    """The mirrors' f32 fused multiply-add is the exact a·b + c rounded to
    nearest once (checked with fractions), also where the f64 sum alone
    would round twice."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (rng.standard_normal(3000) * 2.0 ** rng.integers(-40, 10, 3000)).astype(np.float32)
    # a·b = 1 + 2^-11 + 2^-24, a tie in f32, and c = 2^-80 above it: the f64
    # sum drops c and the f32 rounding of the tie then goes down, not up
    a[0] = b[0] = np.float32(1.0 + 2.0**-12)
    c[0] = np.float32(2.0**-80)
    got = tmv._fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        nbrs = [np.nextafter(got[i], np.float32(-np.inf)), got[i], np.nextafter(got[i], np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in nbrs]
        assert errs[1] <= min(errs), i
    assert got[0] == np.float32(1.0 + 2.0**-11 + 2.0**-23)
