"""The paged and the dense batched flash-decode kernels' launch plans and
order of work (``csrc/flash_decode.cu`` ``flash_decode_paged`` and
``flash_decode_batched``: one kernel template on the chunk pass of
``csrc/flash_common.cuh``, the rows read through a page table or from each
slot's plane), on the CPU:

* ``ops/attention.paged_plan``, the pure mirror of the launcher's plan:
  at most 8 splits, shared memory within the H100's 227 KB for every even
  head dim in [2, 1024], pages of 16, 64 and 128, f32/bf16/int8 caches and
  up to 2048 keys (and far beyond); every live key of every slot falls in
  exactly one split and one tile, each tile's copies cut at page edges and
  none past the slot's live pages; what the launcher refuses raises.
* A PyTorch mirror of the kernel's order (the slot's own split plan, tiles
  of the plan's rows read through the table, an online softmax from tile
  to tile, the splits combined in split order) against the plain version
  (1e-6 relative) and the JAX package's paged kernels in interpret mode
  (1e-5, the bar of tests/test_torch_attention_batched.py), at pages of
  16 and 128, garbage table entries beyond the live pages and a slot at
  n_past 0.
* The same for the batched kernel: ``ops/attention.batched_plan`` (at
  most 8 splits, shared memory within 227 KB for every head dim, B 1..32
  and up to 100,000 keys, every live key of every slot in exactly one
  split and tile and none beyond the slot's n_past; the plans that
  tools/flash_variants.py launches cut the keys as it does), and the mirror of its order (rows from
  each slot's plane, stale rows beyond each n_past) against the plain
  version (1e-6) and the JAX package's batched kernels in interpret mode
  (1e-5).

The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.ops.attention import (
    flash_decode_attention_batched,
    flash_decode_attention_batched_int8,
    flash_decode_attention_paged,
    flash_decode_attention_paged_int8,
)
from llama_swift_torch.models.llama import quantize_kv
from llama_swift_torch.ops import attention as att
from llama_swift_torch.tools import flash_variants

KEYS = [1, 2, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513, 1000, 1024, 1025, 1289,
        2047, 2048, 8192, 100_000]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elt", [4, 2, 1])
def test_paged_plan_fits_every_head_dim(elt):
    """At most the plan's splits (a cluster holds 8) and ring stages, a tile
    of at least one row and at most the longest split, shared memory within
    232,448 bytes."""
    for dh in range(2, att.MAX_HEAD_DIM + 1, 2):
        for n_keys in KEYS:
            plan = att.paged_plan(16, 32, dh, elt, 16, n_keys)
            assert 1 <= plan.splits <= att.PAGED_MAX_SPLITS <= 8  # a cluster of the portable size
            assert 1 <= plan.tile <= plan.keys and 1 <= plan.stages <= att.PAGED_STAGES
            assert plan.smem_bytes <= att.SMEM_LIMIT, (dh, elt, n_keys)
            assert plan.grid == (plan.splits, 32, 16)


def test_paged_plan_at_the_engine_step():
    """The engine's B = 8 step at n_ctx 512, 32 heads of 128 dims: two
    splits of at most 256 keys a (slot, head), tiles of 16 KB of K rows
    (32 f32 rows, 64 bf16, 128 int8) in a ring of two stages; 72 KB of
    shared memory a block (three an SM)."""
    bf16, f32, i8 = (att.paged_plan(8, 32, 128, elt, 128, 512) for elt in (2, 4, 1))
    assert (bf16.splits, bf16.keys, bf16.tile, bf16.stages) == (2, 256, 64, 2)
    assert (f32.splits, f32.keys, f32.tile, f32.stages) == (2, 256, 32, 2)
    assert (i8.splits, i8.keys, i8.tile, i8.stages) == (2, 256, 128, 2)
    assert bf16.smem_bytes == 72352 and bf16.grid == (2, 32, 8)


@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("elt", [4, 2, 1])
def test_every_live_key_in_one_split_tile_and_page_run(page, elt):
    """For slots of every key count up to 2048 (B 1..16 at a time): the
    splits of a slot cover its keys once, in order, each of a multiple of
    16 keys but the last and at most the plan's longest; no more splits
    than the plan's; a tile's runs cover its rows once, each within one
    page, and read no page past the slot's live ones."""
    rng = np.random.default_rng(page + elt)
    for B in range(1, 17):
        n_keys = [int(k) for k in rng.integers(1, 2049, size=B)]
        plan = att.paged_plan(B, 8, 128, elt, page, max(n_keys))
        for keys in n_keys + [1, max(n_keys)]:
            splits = plan.slot_splits(keys)
            assert 1 <= len(splits) <= plan.splits
            seen = []
            for c, (j0, jn) in enumerate(splits):
                assert 1 <= jn <= plan.keys
                assert jn % att.PASS_MIN_KEYS == 0 or c == len(splits) - 1
                for r0, n in plan.tiles(j0, jn):
                    assert 1 <= n <= plan.tile
                    runs = plan.runs(r0, n)
                    assert [j for j, _ in runs][0] == r0 and sum(ln for _, ln in runs) == n
                    for j, ln in runs:
                        assert j // page == (j + ln - 1) // page  # within one page
                        assert (j + ln - 1) // page < -(-keys // page)  # a live page of the slot
                        seen += range(j, j + ln)
            assert seen == list(range(keys))


def test_runs_are_one_copy_a_page_touched():
    """A tile's rows are one bulk copy of K and one of V for each page they
    touch: at page 128 a tile of 64 or 128 rows is one copy, or two where
    a slot's split starts off a page edge; at page 16 a 64-row tile is 4
    or 5 (and a 128-row int8 tile 8 or 9)."""
    for page in (16, 128):
        for elt in (2, 1):
            plan = att.paged_plan(8, 32, 128, elt, page, 2048)
            for keys in (1, 129, 1289, 2048):
                for j0, jn in plan.slot_splits(keys):
                    for r0, n in plan.tiles(j0, jn):
                        assert len(plan.runs(r0, n)) == (r0 + n - 1) // page - r0 // page + 1
                        assert len(plan.runs(r0, n)) <= -(-plan.tile // page) + 1


@pytest.mark.parametrize("dh,n_keys,B,elt", [(17, 16, 1, 4), (0, 16, 1, 4), (1026, 16, 1, 4), (128, 0, 1, 4),
                                             (128, 16, 0, 4), (128, 16, 1, 3)])
def test_paged_plan_refuses(dh, n_keys, B, elt):
    with pytest.raises(ValueError):
        att.paged_plan(B, 4, dh, elt, 16, n_keys)


def test_paged_wrapper_refuses_non_cuda_inputs():
    """Off the CPU the wrapper launches the kernel or raises: a meta tensor
    is refused before any launch."""
    q = torch.zeros((2, 2, 128), device="meta")
    pool = torch.zeros((3, 1, 2, 16, 128), device="meta")
    table = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        att.flash_decode_attention_paged(q, pool, pool, table, 0, torch.zeros(2, dtype=torch.int32), 3)


# ---------------------------------------------------------------------------
# the kernel's order of work, mirrored in PyTorch
# ---------------------------------------------------------------------------


def chunk_order(q, plan, rows, scaled, n_pasts, max_n_past):
    """The slot kernel's computation in its order, in f32: per (slot, head)
    the slot's splits (``SlotPlan.slot_splits`` of its own keys), per split
    tiles of ``plan.tile`` rows (``rows(which, b, h, r0, n)``: K, V or
    their scales, as f32 ``[n, X]``), an online softmax from tile to tile
    (int8: scores times the K row scale, value weights times the V row
    scale, the sum of the unscaled weights), then the splits combined in
    split order."""
    B, H, dh = q.shape
    scale = torch.tensor(1.0 / math.sqrt(float(dh)))
    out = torch.empty((B, H, dh))
    for b in range(B):
        keys = min(int(n_pasts[b]) + 1, max_n_past + 1)
        for h in range(H):
            parts = []
            for j0, jn in plan.slot_splits(keys):
                m, l, acc = torch.tensor(-math.inf), torch.tensor(0.0), torch.zeros(dh)
                for r0, n in plan.tiles(j0, jn):
                    s = rows("k", b, h, r0, n) @ q[b, h]
                    if scaled:
                        s = s * rows("ks", b, h, r0, n)[:, 0]
                    s = s * scale
                    m_new = torch.maximum(m, s.max())
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l = l * alpha + p.sum()
                    pv = p if not scaled else p * rows("vs", b, h, r0, n)[:, 0]
                    acc = acc * alpha + pv @ rows("v", b, h, r0, n)
                    m = m_new
                parts.append((m, l, acc))
            mx = max(pm for pm, _, _ in parts)
            l_all, acc_all = torch.tensor(0.0), torch.zeros(dh)
            for pm, pl, pa in parts:
                a = torch.exp(pm - mx)
                l_all = l_all + a * pl
                acc_all = acc_all + a * pa
            out[b, h] = acc_all / l_all
    return out


def paged_chunk_order(q, k_pool, v_pool, k_scale, v_scale, table, il, n_pasts, max_n_past):
    """The paged kernel's order (``chunk_order``): tiles read through the
    table, ids clamped to the pool."""
    P, _, H, page, dh = k_pool.shape
    plan = att.paged_plan(q.shape[0], H, dh, k_pool.element_size(), page, max_n_past + 1)
    pools = {"k": k_pool, "v": v_pool, "ks": k_scale, "vs": v_scale}

    def rows(which, b, h, r0, n):
        j = torch.arange(r0, r0 + n)
        pid = table[b, j // page].long().clamp(0, P - 1)
        return pools[which][pid, il, h, j % page].float()

    return chunk_order(q, plan, rows, k_scale is not None, n_pasts, max_n_past)


def batched_chunk_order(q, k, v, k_scale, v_scale, il, n_pasts, max_n_past, plan=None):
    """The batched kernel's order (``chunk_order``): tiles read from each
    slot's plane of layer ``il`` of the caches ``[L, B, H, n_ctx, X]``."""
    _, B, H, _, dh = k.shape
    plan = plan or att.batched_plan(B, H, dh, k.element_size(), max_n_past + 1)
    caches = {"k": k, "v": v, "ks": k_scale, "vs": v_scale}

    def rows(which, b, h, r0, n):
        return caches[which][il, b, h, r0 : r0 + n].float()

    return chunk_order(q, plan, rows, k_scale is not None, n_pasts, max_n_past)


def _pools(kind, n_pasts, page, C, garbage, seed, L=2, H=2, dh=128):
    """q and pools [P, L, H, page, dh] (int8: codes by the port's write and
    their scale pools) for slots at ``n_pasts`` through a shuffled table
    whose entries beyond each slot's live pages hold ``garbage``; rows
    beyond each n_past hold stale data (int8: code 127, scale 1e3)."""
    rng = np.random.default_rng(seed)
    B = len(n_pasts)
    live = [n // page + 1 for n in n_pasts]
    P = sum(live) + 1
    ids = rng.permutation(P - 1)
    table = np.full((B, C // page), garbage, np.int32)
    nxt = 0
    for b in range(B):
        table[b, : live[b]] = ids[nxt : nxt + live[b]]
        nxt += live[b]
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((P, L, H, page, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((P, L, H, page, dh)).astype(np.float32))
    stale = torch.ones((P, page), dtype=torch.bool)
    for b, n in enumerate(n_pasts):
        j = torch.arange(n + 1)
        stale[torch.from_numpy(table[b]).long()[j // page], j % page] = False
    if kind == "int8":
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        for codes, sc in ((k8, ks), (v8, vs)):
            codes.permute(0, 3, 1, 2, 4)[stale] = 127
            sc.permute(0, 3, 1, 2, 4)[stale] = 1e3
        return q, (k8, v8, ks, vs), torch.from_numpy(table)
    k.permute(0, 3, 1, 2, 4)[stale] = 1e4
    v.permute(0, 3, 1, 2, 4)[stale] = -1e4
    dtype = getattr(torch, kind)
    return q, (k.to(dtype), v.to(dtype)), torch.from_numpy(table)


def _order(q, pools, table, il, n_pasts):
    np_ = torch.tensor(n_pasts, dtype=torch.int32)
    scales = pools[2:] if len(pools) == 4 else (None, None)
    return paged_chunk_order(q, pools[0], pools[1], *scales, table, il, np_, max(n_pasts))


def _plain(q, pools, table, il, n_pasts):
    np_ = torch.tensor(n_pasts, dtype=torch.int32)
    fn = att.flash_decode_attention_paged_int8 if len(pools) == 4 else att.flash_decode_attention_paged
    return fn(q, *pools, table, il, np_, max(n_pasts))  # the CPU wrapper is the plain version


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("page,garbage", [(16, 10**6), (128, -3)])
def test_paged_order_matches_plain_at_2048(kind, page, garbage):
    """At n_ctx 2048, one slot at its last position (2 splits of 1024 keys,
    each many tiles through a ring of two), one at n_past 0, others across
    page edges: the kernel's order within 1e-6 of the plain version."""
    n_pasts = [2047, 0, 700, 129, 16]
    q, pools, table = _pools(kind, n_pasts, page, 2048, garbage, seed=page)
    plan = att.paged_plan(len(n_pasts), 2, 128, pools[0].element_size(), page, 2048)
    assert plan.splits == 2 and plan.keys == 1024 and len(plan.tiles(0, plan.keys)) > plan.stages
    for il in range(2):
        assert _rel(_order(q, pools, table, il, n_pasts), _plain(q, pools, table, il, n_pasts)) <= 1e-6


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("page,garbage", [(16, -3), (128, 10**6)])
def test_paged_order_matches_jax_kernel(kind, page, garbage):
    """The kernel's order against the JAX package's paged kernels in
    interpret mode (f32/bf16: ``flash_decode_attention_paged``; int8:
    ``flash_decode_attention_paged_int8``) within 1e-5."""
    n_pasts = [0, 63, 200, 255]
    q, pools, table = _pools(kind, n_pasts, page, 256, garbage, seed=page + 1)
    jn = jnp.asarray(n_pasts, jnp.int32)
    for il in range(2):
        got = _order(q, pools, table, il, n_pasts)
        if kind == "int8":
            want, _, _ = flash_decode_attention_paged_int8(
                jnp.asarray(q.numpy()), *(jnp.asarray(t.numpy()) for t in pools), jnp.asarray(table.numpy()),
                jnp.int32(il), jn, interpret=True)
        else:
            jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
            want, _, _ = flash_decode_attention_paged(
                jnp.asarray(q.numpy()), *(jnp.asarray(t.float().numpy()).astype(jdt) for t in pools),
                jnp.asarray(table.numpy()), jnp.int32(il), jn, interpret=True)
        assert _rel(got, want) <= 1e-5
        assert _rel(got, _plain(q, pools, table, il, n_pasts)) <= 1e-6


# ---------------------------------------------------------------------------
# the dense batched kernel: its plan and order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elt", [4, 2, 1])
def test_batched_plan_fits_every_head_dim(elt):
    """At most 8 splits (a cluster of the portable size), a tile of at least
    one row and at most the longest split (and 1024 rows), at most the
    ring's stages, shared memory within 232,448 bytes, for B 1..32."""
    for dh in range(2, att.MAX_HEAD_DIM + 1, 2):
        for n_keys in KEYS:
            for B in (1, 8, 32):
                plan = att.batched_plan(B, 32, dh, elt, n_keys)
                assert 1 <= plan.splits <= att.batched_splits(B, 32, n_keys) <= att.MAX_SPLITS == 8
                assert 1 <= plan.tile <= min(plan.keys, att.MAX_TILE)
                assert 1 <= plan.stages <= att.BATCHED_STAGES
                assert plan.smem_bytes <= att.SMEM_LIMIT, (dh, elt, n_keys)
                assert plan.grid == (plan.splits, 32, B) and plan.page is None


@pytest.mark.parametrize("B,n_keys,splits", [(8, 512, 2), (16, 512, 1), (4, 512, 2), (1, 2048, 8), (8, 2048, 2),
                                              (16, 2048, 2), (16, 128, 1), (32, 2048, 2), (1, 1, 1)])
def test_batched_splits_at_the_timed_cases(B, n_keys, splits):
    """The split rule at the cases tools/flash_variants.py timed on an H100
    (the fastest or within a few percent of it), and its bounds: 1 to 8
    splits, at most 4 blocks an SM of 132 unless the keys need more than
    one split for every 1024."""
    assert att.batched_splits(B, 32, n_keys) == splits
    for b in (1, 2, 3, 8, 16, 32, 64):
        for k in (1, 16, 255, 256, 257, 1024, 1025, 2048, 4096, 100_000):
            s = att.batched_splits(b, 32, k)
            assert 1 <= s <= 8 and s <= max(1, -(-k // 256))
            assert b * 32 * s <= 4 * 132 or s == min(8, -(-k // 1024))


@pytest.mark.parametrize("elt", [4, 2, 1])
def test_flash_variants_plans_cut_keys_as_the_wrapper(elt):
    """tools/flash_variants.py launches the batched kernel on its own plans
    (``variant_plan``): at most ``max_splits`` splits that cover the keys,
    a tile of one row to the longest split; at the wrapper's splits and
    stage bytes, the wrapper's plan."""
    for n_keys in (1, 17, 512, 1289, 2048):
        for splits in (1, 2, 4, 8):
            for stage_bytes in (8192, 16384, 32768, 65536):
                S, tile = flash_variants.variant_plan(128, elt, n_keys, splits, stage_bytes)
                keys = att.split_plan(n_keys, S)[1]
                assert 1 <= S <= splits and S * keys >= n_keys and 1 <= tile <= keys
        for B in (1, 8, 16):
            own = att.batched_plan(B, 32, 128, elt, n_keys)
            assert flash_variants.variant_plan(128, elt, n_keys, own.splits, att.BATCHED_STAGE_BYTES) == \
                (own.splits, own.tile)


@pytest.mark.parametrize("elt", [4, 2, 1])
def test_batched_every_live_key_in_one_split_and_tile(elt):
    """For slots of every key count up to 2048 (B 1..32 at a time): the
    splits of a slot cover its keys once, in order, each of a multiple of
    16 keys but the last and at most the plan's longest; no more splits
    than the plan's; a tile's rows are one copy each of K and V (a plane
    has no page edges) and no row beyond the slot's n_past is read."""
    rng = np.random.default_rng(elt)
    for B in (1, 2, 7, 8, 16, 32):
        n_keys = [int(k) for k in rng.integers(1, 2049, size=B)]
        plan = att.batched_plan(B, 8, 128, elt, max(n_keys))
        for keys in n_keys + [1, max(n_keys)]:
            splits = plan.slot_splits(keys)
            assert 1 <= len(splits) <= plan.splits
            seen = []
            for c, (j0, jn) in enumerate(splits):
                assert 1 <= jn <= plan.keys
                assert jn % att.PASS_MIN_KEYS == 0 or c == len(splits) - 1
                for r0, n in plan.tiles(j0, jn):
                    assert 1 <= n <= plan.tile and plan.runs(r0, n) == [(r0, n)]
                    assert r0 + n <= keys  # never past the slot's n_past
                    seen += range(r0, r0 + n)
            assert seen == list(range(keys))


@pytest.mark.parametrize("dh,n_keys,B,elt", [
    (17, 16, 1, 4), (0, 16, 1, 4), (1026, 16, 1, 4), (128, 0, 1, 4), (128, 16, 0, 4), (128, 16, 1, 3)])
def test_batched_plan_refuses(dh, n_keys, B, elt):
    with pytest.raises(ValueError):
        att.batched_plan(B, 4, dh, elt, n_keys)


def _planes(kind, n_pasts, C, seed, L=2, H=2, dh=128):
    """q and caches [L, B, H, C, dh] (int8: codes by the port's write and
    their row scales) for slots at ``n_pasts``, stale rows beyond each
    n_past (f32/bf16: +-1e4; int8: code 127, scale 1e3)."""
    rng = np.random.default_rng(seed)
    B = len(n_pasts)
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((L, B, H, C, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((L, B, H, C, dh)).astype(np.float32))
    if kind == "int8":
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        for b, n in enumerate(n_pasts):
            for codes, sc in ((k8, ks), (v8, vs)):
                codes[:, b, :, n + 1 :] = 127
                sc[:, b, :, n + 1 :] = 1e3
        return q, (k8, v8, ks, vs)
    for b, n in enumerate(n_pasts):
        k[:, b, :, n + 1 :] = 1e4
        v[:, b, :, n + 1 :] = -1e4
    dtype = getattr(torch, kind)
    return q, (k.to(dtype), v.to(dtype))


def _batched_order(q, caches, il, n_pasts, plan=None):
    np_ = torch.tensor(n_pasts, dtype=torch.int32)
    scales = caches[2:] if len(caches) == 4 else (None, None)
    return batched_chunk_order(q, caches[0], caches[1], *scales, il, np_, max(n_pasts), plan=plan)


def _batched_plain(q, caches, il, n_pasts):
    np_ = torch.tensor(n_pasts, dtype=torch.int32)
    fn = att.flash_decode_attention_batched_int8 if len(caches) == 4 else att.flash_decode_attention_batched
    return fn(q, *caches, il, np_, max(n_pasts))  # the CPU wrapper is the plain version


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_batched_order_matches_plain_at_2048(kind):
    """At n_ctx 2048, one slot at its last position (8 splits of 256 keys,
    or 2 of 1024, each several tiles through a ring of two), one at n_past
    0, others on both sides of a 16-key split edge: the kernel's order
    within 1e-6 of the plain version."""
    n_pasts = [2047, 0, 700, 129, 16]
    q, caches = _planes(kind, n_pasts, 2048, seed=11)
    plan = att.batched_plan(len(n_pasts), 2, 128, caches[0].element_size(), 2048)
    assert plan.splits == 8 and plan.keys == 256 and len(plan.tiles(0, plan.keys)) >= plan.stages
    wide = att.batched_plan(len(n_pasts), 2, 128, caches[0].element_size(), 2048, sms=1)  # 1 split a 1024 keys
    assert wide.splits == 2 and wide.keys == 1024 and len(wide.tiles(0, wide.keys)) > wide.stages
    for il in range(2):
        plain = _batched_plain(q, caches, il, n_pasts)
        assert _rel(_batched_order(q, caches, il, n_pasts), plain) <= 1e-6
        assert _rel(_batched_order(q, caches, il, n_pasts, plan=wide), plain) <= 1e-6


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_batched_order_matches_jax_kernel(kind):
    """The kernel's order against the JAX package's batched kernels in
    interpret mode (f32/bf16: ``flash_decode_attention_batched``; int8:
    ``flash_decode_attention_batched_int8``) within 1e-5, and the order at
    1 and 8 splits of 16-row tiles within 1e-6 of the plain version."""
    n_pasts = [0, 63, 200, 255]
    q, caches = _planes(kind, n_pasts, 256, seed=12)
    jn = jnp.asarray(n_pasts, jnp.int32)
    for il in range(2):
        got = _batched_order(q, caches, il, n_pasts)
        if kind == "int8":
            want, _, _ = flash_decode_attention_batched_int8(
                jnp.asarray(q.numpy()), *(jnp.asarray(t.numpy()) for t in caches), jnp.int32(il), jn,
                interpret=True)
        else:
            jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
            want, _, _ = flash_decode_attention_batched(
                jnp.asarray(q.numpy()), *(jnp.asarray(t.float().numpy()).astype(jdt) for t in caches),
                jnp.int32(il), jn, interpret=True)
        assert _rel(got, want) <= 1e-5
        plain = _batched_plain(q, caches, il, n_pasts)
        assert _rel(got, plain) <= 1e-6
        own = att.batched_plan(4, 2, 128, caches[0].element_size(), 256)
        for splits in (1, 8):
            plan = dataclasses.replace(own, splits=splits, keys=att.split_plan(256, splits)[1], tile=16)
            assert _rel(_batched_order(q, caches, il, n_pasts, plan=plan), plain) <= 1e-6
