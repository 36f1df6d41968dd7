"""Port's multi-row Q4_0 matmul (llama_swift_torch/ops/q4_matvec.py,
q4_0_matmul_multi) against the JAX package's q4_0_vpu_matmul_multi in
interpret mode: 2..32 rows, exact integer block partials per row, the
stacked layer pick, the row-count dispatch of ops/quantized_matmul.linear,
and the CUDA kernel's launch plan at every LLaMA size and row count.  On
the CPU the wrapper runs the kernel's plain version; the CUDA kernel is
held against it by chip_smoke.py and tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.ops.q4_vpu_pallas import Q4_0TensorV, q4_0_vpu_matmul_multi
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.ops import q4_matvec as tmv
from llama_swift_torch.ops import quantized_matmul as tqmm

OUT, IN = 256, 4096
REL = 1e-6  # both sides: exact integer partials, f32 block terms, f32 sums in another order


def _w(seed, out=OUT, in_dim=IN):
    rng = np.random.default_rng(seed)
    return Q4_0Tensor.quantize(rng.standard_normal((out, in_dim)).astype(np.float32) * 0.05)


@pytest.fixture(scope="module")
def w_np():
    return _w(0)


def _port(w):
    return tmv.Q4_0Weight.from_q4_0(TQ4_0Tensor(w.scales, w.qs))


def _x(seed, rows, in_dim=IN):
    return np.random.default_rng(seed).standard_normal((rows, in_dim)).astype(np.float32)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


@pytest.mark.parametrize("B", [2, 3, 8, 32])
def test_multi_matches_tpu_kernel_interpret(w_np, B):
    x = _x(B, B)
    y = tmv.q4_0_matmul_multi(torch.from_numpy(x), _port(w_np)).numpy()
    yj = np.asarray(q4_0_vpu_matmul_multi(jnp.asarray(x), Q4_0TensorV.from_q4_0(w_np), interpret=True))
    assert y.shape == (B, OUT)
    assert _rel(y, yj) <= REL


def test_multi_rows_match_matvec(w_np):
    """Row b of the multi-row product is the batch-1 matvec of row b."""
    x = torch.from_numpy(_x(7, 5))
    w = _port(w_np)
    y = tmv.q4_0_matmul_multi(x, w)
    for b in range(5):
        assert _rel(y[b].numpy(), tmv.q4_0_matvec(x[b], w).numpy()) <= REL


def test_multi_block_partials_exact(w_np):
    x = _x(9, 4)
    q, dx = tmv.quantize_activations_q4_0_int(torch.from_numpy(x))
    assert q.shape == (4, IN) and dx.shape == (4, IN // 32)
    parts = tmv.q4_0_block_partials(q, _port(w_np), rows=100).numpy()  # ragged row chunks
    nib = np.empty((OUT, IN), np.int64)
    nib[:, 0::2] = w_np.qs & 0xF
    nib[:, 1::2] = w_np.qs >> 4
    qi = q.numpy().astype(np.int64).reshape(4, 1, IN // 32, 32)
    expect = ((nib - 8).reshape(1, OUT, IN // 32, 32) * qi).sum(-1)
    np.testing.assert_array_equal(parts, expect)


def test_multi_stacked_layer_pick():
    """A layer view of a stacked [L, out, in] weight gives that layer's
    product, as the JAX stacked call does at layer_idx."""
    ws = [_w(20 + i, 128, 1024) for i in range(3)]
    stacked = tmv.Q4_0Weight(
        torch.stack([_port(w).qs for w in ws]), torch.stack([_port(w).d for w in ws]))
    jstacked = Q4_0TensorV(
        scales_v=jnp.stack([jnp.asarray(Q4_0TensorV.from_q4_0(w).scales_v) for w in ws]),
        qs4v=jnp.stack([jnp.asarray(Q4_0TensorV.from_q4_0(w).qs4v) for w in ws]),
    )
    x = _x(3, 4, 1024)
    for il in range(3):
        y = tmv.q4_0_matmul_multi(torch.from_numpy(x), stacked.layer(il)).numpy()
        yj = np.asarray(q4_0_vpu_matmul_multi(jnp.asarray(x), jstacked, jnp.int32(il), interpret=True))
        assert _rel(y, yj) <= REL
        assert _rel(y, tmv.q4_0_matmul_multi(torch.from_numpy(x), _port(ws[il])).numpy()) == 0.0


@pytest.mark.parametrize("rows,route", [(1, "matvec"), (2, "multi"), (17, "multi"), (32, "multi"),
                                        (33, "dequant"), (64, "dequant")])
def test_linear_routes_by_row_count(monkeypatch, w_np, rows, route):
    """linear sends 1 row to the matvec, 2..32 rows to the multi-row kernel
    and more rows to fake-quant + dequant + matmul (the JAX dispatch,
    ops/quantized_matmul.py:192-201, 245-250 there)."""
    seen = []
    for name in ("q4_0_matvec", "q4_0_matmul_multi", "q4_0_dequant"):
        fn = getattr(tqmm, name)
        monkeypatch.setattr(tqmm, name, lambda *a, _fn=fn, _n=name, **k: seen.append(_n) or _fn(*a, **k))
    x = torch.from_numpy(_x(rows, rows))
    y = tqmm.linear(x, _port(w_np))
    assert y.shape == (rows, OUT)
    assert seen == [{"matvec": "q4_0_matvec", "multi": "q4_0_matmul_multi", "dequant": "q4_0_dequant"}[route]]
    if route == "multi":
        # the multi-row result is the per-row int4 dot, not the fake-quant product
        assert _rel(y.numpy(), tmv.q4_0_matmul_multi_plain(x, _port(w_np)).numpy()) == 0.0


def test_wrapper_rejects_non_cpu_inputs(w_np):
    """A tensor that is not on the CPU never reaches the plain version."""
    with pytest.raises(ValueError):
        tmv.q4_0_matmul_multi(torch.zeros((4, IN), device="meta"), _port(w_np))


def _llama_shapes(cfg):
    """(out, in) of every product of a LLaMA config: wq/wk/wv/wo, w1/w3, w2,
    the output projection, fused wqkv and w13."""
    d, f = cfg.n_embd, cfg.n_ff
    return [(d, d), (f, d), (d, f), (cfg.n_vocab, d), (3 * d, d), (2 * f, d)]


@pytest.mark.parametrize("size", ["7b", "13b", "30b", "65b"])
@pytest.mark.parametrize("B", range(2, tmv.MAX_MULTI_ROWS + 1))
def test_multi_plan_covers_every_block_and_row_once(size, B):
    """The multi-row kernel's plan: shared memory within a block's 227 KB
    and the blocks an SM holds, the cluster's partials within the
    ring, every weight block of the in-dim in exactly one chunk of exactly
    one block of the cluster (none empty), every output row in exactly one
    tile, B padded to whole 8-row MMA tiles, the in-dim split where the
    tiles alone would fill at most half of the blocks the card holds."""
    cfg = getattr(TModelConfig, f"llama_{size}")()
    for out, in_dim in _llama_shapes(cfg):
        plan = tmv.multi_plan(out, in_dim, B)
        assert plan.smem <= tmv.SMEM_PER_BLOCK and plan.blocks_per_sm * (plan.smem + 1024) <= tmv.SMEM_PER_SM
        assert plan.blocks_per_sm == (1 if plan.np == 16 else 2)
        assert plan.np % 8 == 0 and B <= plan.np < B + 8
        assert 1 <= plan.splits <= tmv.MULTI_MAX_SPLITS
        assert 2 * plan.splits * plan.np * tmv.MULTI_TILE_ROWS * 4 <= plan.smem
        nb = in_dim // 32
        blocks = []
        for chunks in plan.chunk_sets:
            assert chunks
            for c in chunks:
                blocks += range(c * tmv.MULTI_KC, min((c + 1) * tmv.MULTI_KC, nb))
        assert sorted(blocks) == list(range(nb))
        rows = [r for t in range(plan.tiles)
                for r in range(t * tmv.MULTI_TILE_ROWS, min((t + 1) * tmv.MULTI_TILE_ROWS, out))]
        assert rows == list(range(out))
        assert plan.grid == (plan.splits, plan.tiles)
        assert (plan.splits == 2) == (2 * plan.tiles <= 132 * plan.blocks_per_sm and plan.chunks >= 2)


@pytest.mark.parametrize("args", [(4096, 4096, 0), (4096, 4096, 33), (4096, 4016, 8), (0, 4096, 8), (64, 0, 2)])
def test_multi_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        tmv.multi_plan(*args)
