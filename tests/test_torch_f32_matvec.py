"""The Q4_0 and Q4_1 matvecs on f32 activations (``csrc/q4_matvec.cu``
``q4_0_matvec_f32`` and ``q4_1_matvec_f32``: one persistent-grid kernel
template with a ring of weight loads a lane, the weight block type its
parameter), on the CPU:

* their launch plan (``ops/q4_matvec.matvec_f32_plan``): two blocks an SM,
  16 warps a block, every row taken by exactly one warp, and the staged x
  (Q4_1: and each block's sum of x) within a block's 227 KB for LLaMA's
  in-dims 4096, 11008, 13824 and 22016 and for ``MAX_F32_IN``;
* their order of sums (``q4_0_matvec_f32_lane_order``,
  ``q4_1_matvec_f32_lane_order``: lane l's blocks l, l + 32, … as fused
  multiply-adds, then the warp butterfly) against the plain versions and
  the JAX package's TPU kernels with ``quantize_acts=False`` in interpret
  mode, within the JAX test's ``rtol = atol = 2e-5`` (the pattern of
  tests/test_torch_f32_acts.py).  On the card the kernels are held to the
  same orders bit for bit (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor, Q4_1Tensor
from llama_swift_tpu.ops.q4_vpu_pallas import Q4_0TensorV, Q4_1TensorV, q4_0_vpu_matvec, q4_1_vpu_matvec
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.formats.quant import Q4_1Tensor as TQ4_1Tensor
from llama_swift_torch.ops import q4_matvec as mv

TOL = 2e-5  # tests/test_q4_vpu.py's rtol and atol for the TPU kernels
SMEM_LIMIT = 232448  # a block's shared memory on the H100


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
@pytest.mark.parametrize("in_dim", [4096, 11008, 13824, 22016, mv.MAX_F32_IN])
def test_plan_stages_x_within_a_block(in_dim, kind):
    """x transposed (Q4_1: and its block sums) within a block's 227 KB; at
    ``MAX_F32_IN`` the Q4_1 kernel's exactly."""
    q4_1 = kind == "q4_1"
    plan = mv.matvec_f32_plan(4096, in_dim, q4_1=q4_1)
    assert plan.smem_bytes == 8 * ((in_dim // 32) | 1) * 16 + (4 * (in_dim // 32) if q4_1 else 0) <= SMEM_LIMIT
    assert plan.stride % 2 == 1 and plan.warps == mv.F32_WARPS and plan.ring == mv.F32_RING
    assert plan.blocks == mv.matvec_f32_plan(4096, in_dim).blocks  # one grid for both block types
    assert in_dim != mv.MAX_F32_IN or not q4_1 or plan.smem_bytes == SMEM_LIMIT


@pytest.mark.parametrize("out", [1, 15, 16, 17, 2112, 4096, 4224, 11008, 32000])
def test_plan_gives_every_row_to_one_warp(out):
    """Two blocks an SM of 132 (fewer when the rows do not fill them); warp w
    of block g takes rows g·16 + w + k·blocks·16: each row exactly once."""
    plan = mv.matvec_f32_plan(out, 4096, 132)
    assert plan.blocks == min(-(-out // 16), 2 * 132)
    rows = [r for g in range(plan.blocks) for w in range(plan.warps) for r in plan.warp_rows(out, g, w)]
    assert sorted(rows) == list(range(out))
    assert max(len(plan.warp_rows(out, g, w)) for g in range(plan.blocks) for w in range(plan.warps)) \
        == plan.rows_per_warp


def test_plan_refuses_ragged_in_dims():
    with pytest.raises(ValueError):
        mv.matvec_f32_plan(16, 48)


def _weight(out, in_dim, seed, kind="q4_0"):
    w = np.random.default_rng(seed).standard_normal((out, in_dim)).astype(np.float32) * 0.05
    if kind == "q4_1":
        t = Q4_1Tensor.quantize(w)
        return t, mv.Q4_1Weight.from_q4_1(TQ4_1Tensor(t.mins, t.scales, t.qs))
    t = Q4_0Tensor.quantize(w)
    return t, mv.Q4_0Weight.from_q4_0(TQ4_0Tensor(t.scales, t.qs))


#: kind -> (lane order, plain version, JAX TPU kernel and its tensor type)
KINDS = {
    "q4_0": (mv.q4_0_matvec_f32_lane_order, mv.q4_0_matvec_f32_plain,
             lambda x, t: q4_0_vpu_matvec(x, Q4_0TensorV.from_q4_0(t), quantize_acts=False, interpret=True)),
    "q4_1": (mv.q4_1_matvec_f32_lane_order, lambda x, w: mv.q4_1_matvec_plain(x, w, quantize_acts=False),
             lambda x, t: q4_1_vpu_matvec(x, Q4_1TensorV.from_q4_1(t), quantize_acts=False, interpret=True)),
}


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
@pytest.mark.parametrize("out,in_dim", [(128, 256), (128, 1056), (256, 2080)])
def test_lane_order_matches_plain_and_tpu_kernel(out, in_dim, kind):
    """In-dims of 8, 33 (a lane with a second block) and 65 blocks (a ragged
    third lane step)."""
    order, plain, tpu = KINDS[kind]
    t, w = _weight(out, in_dim, seed=in_dim, kind=kind)
    x = np.random.default_rng(in_dim + 1).standard_normal(in_dim).astype(np.float32)
    got = order(torch.from_numpy(x), w).numpy()
    np.testing.assert_allclose(got, plain(torch.from_numpy(x), w).numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(tpu(jnp.asarray(x[None]), t))[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("in_dim", [4096, 11008, 13824, 22016, mv.MAX_F32_IN])
def test_q4_1_lane_order_at_llama_in_dims(in_dim):
    """The Q4_1 order against the plain version at LLaMA's in-dims (7B's
    4096 and 11008, 13B's and 65B's n_ff 13824 and 22016) and the largest
    the kernel stages, on a few rows."""
    _, w = _weight(4, in_dim, seed=in_dim % 101, kind="q4_1")
    x = torch.from_numpy(np.random.default_rng(in_dim).standard_normal(in_dim).astype(np.float32))
    got = mv.q4_1_matvec_f32_lane_order(x, w).numpy()
    np.testing.assert_allclose(got, mv.q4_1_matvec_plain(x, w, quantize_acts=False).numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_lane_order_is_the_order_of_the_sums(kind):
    """On powers of two (every block dot and block sum of x exact) the
    mirror differs from a plain sum only by where the partial sums round:
    it equals a sequential lane-by-lane reference written out element by
    element (Q4_1: the min's term first, each block's sum of x four
    elements at a time)."""
    out, in_dim = 3, 2080
    rng = np.random.default_rng(7)
    _, w = _weight(out, in_dim, seed=3, kind=kind)
    d_np = 2.0 ** rng.integers(-6, 1, (out, in_dim // 32))
    m_np = -(2.0 ** rng.integers(-4, 3, (out, in_dim // 32)))
    if kind == "q4_1":
        w = mv.Q4_1Weight(w.qs, torch.from_numpy(np.stack([d_np, m_np], -1)).float())
    else:
        w = mv.Q4_0Weight(w.qs, torch.from_numpy(d_np).float())
    x = torch.from_numpy((2.0 ** rng.integers(-8, 8, in_dim)) * rng.choice([-1.0, 1.0], in_dim)).float()
    got = KINDS[kind][0](x, w)
    n = (mv.unpack_nibbles(w.qs).float() - (0.0 if kind == "q4_1" else 8.0)).numpy().astype(np.float64)
    xd, d = x.numpy().astype(np.float64), w.d.numpy().astype(np.float64)
    nb = in_dim // 32
    for o in range(out):
        lanes = []
        for lane in range(32):
            acc = np.float32(0.0)
            for b in range(lane, nb, 32):
                dot = np.dot(n[o, 32 * b : 32 * b + 32], xd[32 * b : 32 * b + 32])  # exact
                if kind == "q4_1":
                    xs = np.float32(0.0)
                    for j in range(8):
                        v = x.numpy()[32 * b + 4 * j : 32 * b + 4 * j + 4]
                        xs = np.float32(xs + np.float32(np.float32(np.float32(v[0] + v[1]) + v[2]) + v[3]))
                    acc = np.float32(np.float64(m_np[o, b]) * np.float64(xs) + np.float64(acc))
                acc = np.float32(d[o, b] * dot + np.float64(acc))
            lanes.append(acc)
        for s in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ s]) for i in range(32)]
        assert got[o].item() == float(lanes[0]), o
