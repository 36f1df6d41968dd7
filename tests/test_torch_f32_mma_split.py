"""The arithmetic of the f32-activation Q4_0 products on the bf16 tensor
cores (``csrc/q4_f32_mma.cuh``: ``q4_0_matmul_multi_f32`` and
``q4_0_matmul_t``), on the CPU, through a small PyTorch mirror of what the
kernel computes:

* the exact three-way bf16 split of x (x0 = x with its low 16 bits cleared,
  x1 likewise of the remainder, x2 the rest): ``x == x0 + x1 + x2`` bit for
  bit and each piece a bf16, over finite f32 bit patterns with |x| ≥
  2^-100, 0 and ±max (hypothesis);
* the MMA fragments' K order: the kernel's A fragments (nibble pairs of a
  weight word) and B fragments (pairs of staged x) hold the same elements
  at each k of both k-steps, so the emulated MMA of one block equals the
  block's dot exactly;
* exact nibble × piece products summed per block, then scaled by d and
  summed (also with the pieces as MMA columns, the launch of 1 and 2
  rows): within 1e-6 of max |y| of both plain versions
  (``q4_0_matmul_multi_f32_plain``, ``q4_0_matmul_t_plain``), and within
  1e-5 of the JAX kernels run as their own tests run them on the CPU (the
  phase kernel ``q4_0_matmul_pallas`` and the f32 multi-row kernel
  ``q4_0_vpu_matmul_multi(quantize_acts=False)``, in interpret mode);
* the launch plan's Python mirror (``ops/q4_matvec.f32_mma_plan``): every
  row count 1..64 at the LLaMA in-dims fits a block's 227 KB with its
  partial sums, and no block of a cluster is left without a chunk.

The CUDA kernel itself is held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.  Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.ops.q4_matmul_pallas import Q4_0TensorT, q4_0_matmul_pallas
from llama_swift_tpu.ops.q4_vpu_pallas import Q4_0TensorV, q4_0_vpu_matmul_multi
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.ops import q4_matmul as qm
from llama_swift_torch.ops import q4_matvec as mv

PLAIN_BAR = 1e-6  # relative to max |y|: the same products, summed in another order
JAX_BAR = 1e-5  # relative to max |y|: the TPU kernels' own sums
LLAMA_IN = [4096, 5120, 11008, 13824, 22016]
F32_MAX = float(np.finfo(np.float32).max)


def _cut(v: torch.Tensor) -> torch.Tensor:
    """v with its low 16 bits cleared: rounded toward zero to a bf16."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def split3(x: torch.Tensor):
    """The kernel's split of f32 x into three bf16 pieces (as f32 values)."""
    x0 = _cut(x)
    r = x - x0
    x1 = _cut(r)
    return x0, x1, r - x1


def _nibbles(w: mv.Q4_0Weight) -> torch.Tensor:
    return mv.unpack_nibbles(w.qs).float() - 8.0  # [out, in], exact


def mirror(x: torch.Tensor, w: mv.Q4_0Weight, pieces_as_columns: bool = False) -> torch.Tensor:
    """y [N, out] as the kernel computes it: per 32-block, the exact products
    of n - 8 and each bf16 piece of x summed (in f64: the tensor cores'
    sum, exact up to their truncation), rounded to f32 once a block, scaled
    by d and summed over blocks in f32; with ``pieces_as_columns`` each
    piece's block dots are scaled and summed on their own and the three
    sums added at the end, the small pieces first."""
    out, in_dim = w.shape
    nb = in_dim // 32
    n = _nibbles(w).double().reshape(out, nb, 32)
    d = w.d.float()
    pieces = split3(x.float())

    def scaled(p):  # [N, out, nb]: d * (block dot of piece p)
        dots = torch.einsum("obk,rbk->rob", n, p.double().reshape(-1, nb, 32)).float()
        return d[None] * dots

    if pieces_as_columns:
        sums = [scaled(p).sum(dim=-1) for p in pieces]
        return (sums[2] + sums[1]) + sums[0]
    dots = sum(torch.einsum("obk,rbk->rob", n, p.double().reshape(-1, nb, 32)) for p in pieces[::-1]).float()
    return (d[None] * dots).sum(dim=-1)


def _weight(out: int, in_dim: int, seed: int):
    """(JAX logical tensor, the port's weight) from a numpy seed."""
    t = Q4_0Tensor.quantize((np.random.default_rng(seed).standard_normal((out, in_dim)) * 0.05).astype(np.float32))
    return t, mv.Q4_0Weight.from_q4_0(TQ4_0Tensor(t.scales, t.qs))


def _x(rows: int, in_dim: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, in_dim)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


_FINITE = st.integers(min_value=0, max_value=2**32 - 1).map(
    lambda b: np.array([b], dtype=np.uint32).view(np.float32)[0]).filter(
    lambda v: np.isfinite(v) and abs(float(v)) >= 2.0**-100)


@settings(max_examples=400, deadline=None, database=None)
@given(_FINITE)
@example(np.float32(0.0))
@example(np.float32(-0.0))
@example(np.float32(F32_MAX))
@example(np.float32(-F32_MAX))
@example(np.float32(2.0**-100))
def test_split_is_exact_and_pieces_are_bf16(v):
    x = torch.tensor([v], dtype=torch.float32)
    pieces = split3(x)
    for p in pieces:
        assert torch.isfinite(p).all()
        assert torch.equal(p, p.to(torch.bfloat16).float())  # each piece is a bf16
    # x0 + x1 and then + x2 are exact in f32: the sum rounds nothing
    assert torch.equal((pieces[0] + pieces[1]) + pieces[2], x)
    assert float(pieces[0].double() + pieces[1].double() + pieces[2].double()) == float(v)


def test_split_of_a_tensor_is_exact():
    """A seeded tensor over 60 binades, every element (the kernel splits
    pairs of these; the pair packing takes each value's upper 16 bits)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1 << 14) * np.exp2(rng.integers(-30, 30, 1 << 14))).astype(np.float32))
    x0, x1, x2 = split3(x)
    assert torch.equal(x0 + x1 + x2, x)
    assert torch.equal(x2, x2.to(torch.bfloat16).float())
    assert (x2.view(torch.int32) & 0xFFFF).eq(0).all()


# ---------------------------------------------------------------------------
# the fragments' K order
# ---------------------------------------------------------------------------


def _fragments(n_words: np.ndarray, xs: np.ndarray):
    """The kernel's operands of one 32-element block for a 16-row tile and
    8 activation rows, element by element: A_s[i][k] and B_s[k][j] of k-step
    s as nibble_frags and the B fragments build them (lane 4g + t: word t
    of rows g, g + 8; elements 8t..8t+7 of x row g)."""
    A = np.zeros((2, 16, 16))
    B = np.zeros((2, 16, 8))
    for s in range(2):
        for g in range(8):
            for t in range(4):
                for half, k in ((0, 2 * t), (1, 2 * t + 1)):
                    for r, k_off in ((2 * s, 0), (2 * s + 1, 8)):  # a0/a1 = v[2s], a2/a3 = v[2s + 1]
                        e = 8 * t + r + 4 * half  # v[r] = {n[8t + r], n[8t + r + 4]}
                        for row in (g, g + 8):
                            word = int(n_words[row, t])
                            A[s, row, k + k_off] = ((word >> (4 * (e - 8 * t))) & 0xF) - 8
                        B[s, k + k_off, g] = xs[g, e]  # pair r of x: (x[8t + r], x[8t + r + 4])
    return A, B


def test_fragment_k_order_is_the_element_order():
    rng = np.random.default_rng(1)
    qs = rng.integers(0, 256, (16, 16), dtype=np.uint8)  # one block of 16 rows: 16 bytes each
    xs = rng.integers(-1000, 1000, (8, 32)).astype(np.float64)  # integers: every sum is exact
    n = (np.stack([qs & 0xF, qs >> 4], axis=-1).reshape(16, 32).astype(np.float64)) - 8.0  # element 2j, 2j + 1
    A, B = _fragments(qs.view(np.uint32).reshape(16, 4), xs)
    D = A[0] @ B[0] + A[1] @ B[1]
    np.testing.assert_array_equal(D, n @ xs.T)
    # every element of the block appears once in each k-step pair's K range
    assert sorted(np.abs(A[:, 0, :]).ravel().tolist()) == sorted(np.abs(n[0]).tolist())


# ---------------------------------------------------------------------------
# the mirror against both plain versions and the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("columns", [False, True], ids=["pieces_as_mmas", "pieces_as_columns"])
@pytest.mark.parametrize("rows", [1, 2, 3, 8, 17, 33, 64])
def test_mirror_matches_both_plain_versions(rows, columns):
    _, w = _weight(40, 352, seed=rows)
    x = torch.from_numpy(_x(rows, 352, seed=rows + 1))
    y = mirror(x, w, pieces_as_columns=columns)
    assert _rel(y, mv.q4_0_matmul_multi_f32_plain(x, w)) <= PLAIN_BAR
    assert _rel(y, qm.q4_0_matmul_t_plain(x, w)) <= PLAIN_BAR


@pytest.mark.parametrize("rows", [1, 8, 33])
def test_mirror_matches_the_phase_kernel(rows):
    """Against the T layout's TPU kernel in interpret mode (as
    tests/test_torch_q4_matmul_t.py runs it)."""
    t, w = _weight(256, 1024, seed=3 * rows)
    x = _x(rows, 1024, seed=rows)
    yj = q4_0_matmul_pallas(jnp.asarray(x), Q4_0TensorT.from_q4_0(t), interpret=True)
    assert _rel(mirror(torch.from_numpy(x), w, pieces_as_columns=rows <= 2), yj) <= JAX_BAR


@pytest.mark.parametrize("B", [2, 8])
def test_mirror_matches_the_multi_row_kernel(B):
    """Against the f32 multi-row TPU kernel in interpret mode (as
    tests/test_torch_f32_acts.py runs it)."""
    t, w = _weight(256, 256, seed=B)
    x = _x(B, 256, seed=B + 5)
    yj = q4_0_vpu_matmul_multi(jnp.asarray(x), Q4_0TensorV.from_q4_0(t), quantize_acts=False, interpret=True)
    assert _rel(mirror(torch.from_numpy(x), w, pieces_as_columns=B <= 2), yj) <= JAX_BAR


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dim", LLAMA_IN)
def test_plan_fits_shared_memory_at_every_row_count(in_dim):
    for out in (77, 4096, 5120, 11008, 12288, 22016, 32000):
        for rows in range(1, 65):
            plan = mv.f32_mma_plan(out, in_dim, rows)
            assert plan.np >= rows and (plan.np == 2 or plan.np % 8 == 0)
            assert plan.smem <= mv.SMEM_PER_BLOCK, (out, in_dim, rows)
            assert plan.blocks_per_sm * (plan.smem + 1024) <= mv.SMEM_PER_SM
            assert plan.stages >= 2 and plan.partial_bytes <= plan.stages * plan.stage_bytes
            assert plan.chunks * plan.kc * 32 >= in_dim > (plan.chunks - 1) * plan.kc * 32
            last = plan.tiles - (plan.blocks // plan.cluster - 1) * plan.cluster_tiles
            for tiles in {plan.cluster_tiles, last}:
                ranges = plan.unit_ranges(tiles)
                assert ranges[0][0] == 0 and ranges[-1][1] == tiles * plan.chunks
                assert all(a < b for a, b in ranges), (out, in_dim, rows)  # every block has a unit
                assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
                # a block's units lie in at most two tiles, in one beyond 8 rows
                spans = [(b - 1) // plan.chunks - a // plan.chunks + 1 for a, b in ranges]
                assert max(spans) <= (2 if plan.np <= 8 else 1), (out, in_dim, rows)
                # a block owns (holds the first unit of) at most one tile
                assert all(-(-b // plan.chunks) - -(-a // plan.chunks) <= 1 for a, b in ranges)


def test_plan_shares_tiles_over_clusters():
    """Up to 8 rows the 172 tiles of 11008 outputs go to clusters of 4
    blocks sharing 3 tiles (232 blocks, 3/4 of a tile each, all resident),
    the 64 of 4096 to clusters of 2 on one tile, the 192 of 12288 (256
    blocks in clusters of 4 would fill 97 % of the slots) and the 500 of
    32000 one to a block; beyond 8 rows a cluster of 2 splits a tile where that leaves
    less work on the busiest SM; one chunk a tile is never split."""
    share = lambda out, rows: (lambda p: (p.cluster, p.cluster_tiles, p.blocks))(mv.f32_mma_plan(out, 4096, rows))
    assert [share(o, 8) for o in (4096, 5120, 11008, 12288, 32000)] == [
        (2, 1, 128), (4, 3, 108), (4, 3, 232), (1, 1, 192), (1, 1, 500)]
    assert [share(o, 1) for o in (4096, 11008)] == [share(o, 8) for o in (4096, 11008)]
    assert [share(o, 64) for o in (4096, 5120, 11008, 32000)] == [(2, 1, 128), (1, 1, 80), (2, 1, 344), (1, 1, 500)]
    assert mv.f32_mma_plan(100, 512, 8).cluster == 2 and mv.f32_mma_plan(40, 256, 8).cluster == 1
    assert mv.f32_mma_plan(100, 1024, 1).cluster == 2 and mv.f32_mma_plan(100, 512, 1).chunks == 1
    with pytest.raises(ValueError):
        mv.f32_mma_plan(4096, 4096, 65)
