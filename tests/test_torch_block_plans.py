"""The launch plans of two kernels, as pure functions (no card, no JAX):

* ``ops/q4_matvec.int_matmul_plan``, the T layout's integer product
  (``q4_0_int_matmul``) on the multi-row kernel: calls of at most 64 rows in
  order, row 6's plan (``multi_plan``) at 1–32 rows, one block an SM and the
  fewer waves of blocks at 33–64 rows, for N = 1…130 at LLaMA's shapes;
* ``ops/fused_layer.attn_block_plan``, the attention block's splits of a
  head over the history at 32, 40, 52 and 64 heads and n_past 0…2047: every
  history key in exactly one split, none empty, no more items than the
  grid's blocks where the heads allow.

The CUDA sources compute the same (``q4_0_matmul_multi_smem_bytes``,
``fused_attn_block_splits``/``_split_keys``); ``tests/test_torch_cuda.py``
holds them to these functions on the card.  Also the wrappers' refusals
that hold on the CPU.
"""

import pytest
import torch

from llama_swift_torch.config import ModelConfig
from llama_swift_torch.ops import fused_layer as fl
from llama_swift_torch.ops import q4_matmul as qm
from llama_swift_torch.ops import q4_matvec as mv


def _llama_shapes(size):
    cfg = getattr(ModelConfig, f"llama_{size}")()
    d, f = cfg.n_embd, cfg.n_ff
    return [(d, d), (f, d), (d, f), (cfg.n_vocab, d), (3 * d, d), (2 * f, d)]


def _mm_smem(np_):
    """``mm_smem_bytes`` of ``csrc/q4_matvec.cu``: 3 ring stages (2 at 32 rows)."""
    stage = 64 * (16 * 16 + 16) + 64 * (16 + 4) * 4 + np_ * (16 * 32 + 16) + 16 * np_ * 8
    return (2 if np_ == 32 else 3) * stage


@pytest.mark.parametrize("size", ["7b", "13b", "65b"])
@pytest.mark.parametrize("N", range(1, 131))
def test_int_matmul_plan_cuts_rows_into_launches(size, N):
    """Calls of at most 64 rows, in order, covering every row once; each
    call's instance is its rows padded to 8-row tiles; 1–32 rows take row
    6's plan itself (its launch, bit for bit), 33–64 rows one block an SM
    with the ring's three stages and a cluster of 2 exactly where it takes
    fewer waves; every plan within a block's shared memory, the cluster's
    partials within the ring, no block of a cluster without a chunk."""
    for out, in_dim in _llama_shapes(size):
        plan = mv.int_matmul_plan(out, in_dim, N)
        assert [n0 for n0, _, _ in plan.launches] == list(range(0, N, mv.MAX_INT_LAUNCH_ROWS))
        assert sum(rows for _, rows, _ in plan.launches) == N
        for n0, rows, p in plan.launches:
            assert 1 <= rows <= mv.MAX_INT_LAUNCH_ROWS
            assert p.np == 8 * -(-rows // 8) and p.smem == _mm_smem(p.np) <= mv.SMEM_PER_BLOCK
            assert p.splits <= p.chunks and 2 * p.splits * p.np * mv.MULTI_TILE_ROWS * 4 <= p.smem
            if rows <= mv.MAX_MULTI_ROWS:
                assert p == mv.multi_plan(out, in_dim, rows)
            else:
                assert p.blocks_per_sm == 1 and 2 * (p.smem + 1024) > mv.SMEM_PER_SM

                def waves(s):
                    return -(-p.tiles * s // 132) * -(-p.chunks // s)

                assert (p.splits == 2) == (p.chunks >= 2 and waves(2) < waves(1))
        assert plan.np == max(p.np for _, _, p in plan.launches)


def test_int_matmul_plan_at_the_timed_shapes():
    """The plans the card's checks time at 64 rows: a cluster of 2 at
    4096 and 11008 outputs (fewer waves), none at 32000 (as many)."""
    got = {(out, in_dim): mv.int_matmul_plan(out, in_dim, 64).launches[0][2].splits
           for out, in_dim in [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]}
    assert got == {(4096, 4096): 2, (11008, 4096): 2, (4096, 11008): 2, (32000, 4096): 1}
    assert [rows for _, rows, _ in mv.int_matmul_plan(4096, 4096, 130).launches] == [64, 64, 2]


@pytest.mark.parametrize("args", [(4096, 4096, 0), (4096, 4016, 8), (0, 4096, 8), (64, 0, 2), (64, 16, 1)])
def test_int_matmul_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        mv.int_matmul_plan(*args)


def test_int_matmul_refuses_on_the_cpu_what_the_kernel_does_not_take():
    """Rows not on the CPU never reach the plain version; on a card the
    wrapper raises on a wrong in-dim or dtype (tests/test_torch_cuda.py)."""
    w = qm.Q4_0WeightT(torch.zeros((64, 128), dtype=torch.uint8), torch.ones((64, 8)))
    with pytest.raises(ValueError):
        qm.q4_0_int_matmul(torch.zeros((4, 256), device="meta"), w)


@pytest.mark.parametrize("H", [32, 40, 52, 64])
def test_attn_block_plan_splits_every_history_key_once(H):
    """n_past 0: no split (ctx is the own term); else at most 132 // H
    splits of a multiple of 16 keys, none empty, every key j < n_past in
    exactly one split, and H·S items no more than the grid's 132 blocks."""
    assert fl.attn_block_plan(H, 0) == (0, 0)
    for n_past in range(1, 2048):
        S, keys = fl.attn_block_plan(H, n_past)
        assert 1 <= S <= max(1, 132 // H) and keys % 16 == 0
        assert (S - 1) * keys < n_past <= S * keys
        assert H * S <= 132


def test_attn_block_plan_at_llama_heads():
    """4 splits a head at 32 heads (128 items of 132), 3 at 40, 2 at 52 and
    64, from 64 history keys; one split at a few keys; more on fewer heads."""
    assert [fl.attn_block_plan(H, 511)[0] for H in (32, 40, 52, 64)] == [4, 3, 2, 2]
    assert fl.attn_block_plan(32, 127) == (4, 32)
    assert fl.attn_block_plan(64, 2047) == (2, 1024)
    assert fl.attn_block_plan(32, 5) == (1, 16)
    assert fl.attn_block_plan(2, 200, sms=132) == (13, 16)
    assert fl.attn_block_plan(200, 100) == (1, 112)  # more heads than blocks: one split each


def test_attn_block_refuses_on_the_cpu():
    """What the block does not take raises before any plan: an int8 cache,
    another head dim, n_past outside the cache, a layer outside the stack."""
    H, D, L, n_ctx = 2, 256, 1, 32
    x, norm_w = torch.zeros(D), torch.ones(D)
    cos, sin = fl.rope_vectors(3)
    w = lambda out, i: mv.Q4_0Weight(torch.zeros((L, out, i // 2), dtype=torch.uint8),  # noqa: E731
                                     torch.ones((L, out, i // 32)))
    kc = torch.zeros((L, H, n_ctx, fl.HEAD_DIM))
    for cache, n_past, il, match in [(kc.to(torch.int8), 3, 0, "int8"), (kc, n_ctx, 0, "n_past"),
                                     (kc, -1, 0, "n_past"), (kc, 3, 1, "layer"),
                                     (torch.zeros((L, H, n_ctx, 64)), 3, 0, "head dim")]:
        with pytest.raises(ValueError, match=match):
            fl.fused_attn_block(x, norm_w, cos, sin, w(3 * D, D), w(D, D), cache, cache, il, n_past)
