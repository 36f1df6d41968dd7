"""Causal prefill attention on the CPU (``ops/attention.py``,
``csrc/flash_prefill.cu``): the wrapper's plain version bit for bit the
model's earlier ``_attention``/``_attention_chunked``, the kernel's launch
plan (query tiles longest first, key tiles that never reach ``n_past + N``),
a PyTorch mirror of the kernel's key-tile loop and diagonal mask against the
plain version, and the head dims the wrapper refuses.  The kernel itself is
held to the plain version on the card by ``tests/test_torch_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from llama_swift_torch import ops
from llama_swift_torch.models import llama as model_lib
from llama_swift_torch.ops import attention as att


def _seed_attention_chunked(q, keys, values, n_past, n_ctx, compute_dtype, chunk=512):
    """The model's chunked prefill attention as it stood before the kernel."""
    N, d = q.shape[0], q.shape[-1]
    H = keys.shape[0]
    scale = 1.0 / np.sqrt(float(d))
    qf = q.float().transpose(0, 1)
    i_idx = torch.arange(N, device=q.device)[:, None]
    m = torch.full((H, N, 1), float("-inf"), device=q.device)
    l = torch.zeros((H, N, 1), device=q.device)
    acc = torch.zeros((H, N, d), device=q.device)
    for c0 in range(0, n_ctx, chunk):
        kc = keys[:, c0 : c0 + chunk].float()
        vc = values[:, c0 : c0 + chunk].float()
        s = torch.einsum("hnd,hjd->hnj", qf, kc) * scale
        allowed = (c0 + torch.arange(kc.shape[1], device=q.device)[None, :]) <= (n_past + i_idx)
        s = torch.where(allowed[None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        p = torch.exp(s - m_safe)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hnj,hjd->hnd", p, vc)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(0, 1).to(compute_dtype)


def _seed_attention(q, keys, values, n_past, n_ctx, compute_dtype):
    """The model's prefill attention as it stood before the kernel."""
    if n_ctx >= 1024 and n_ctx % 512 == 0:
        return _seed_attention_chunked(q, keys, values, n_past, n_ctx, compute_dtype)
    N, d = q.shape[0], q.shape[-1]
    scale = 1.0 / np.sqrt(float(d))
    scores = torch.einsum("nhd,hjd->hnj", q.float(), keys.float()) * scale
    i_idx = torch.arange(N, device=q.device)[:, None]
    j_idx = torch.arange(n_ctx, device=q.device)[None, :]
    scores = torch.where((j_idx <= n_past + i_idx)[None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hnj,hjd->nhd", p, values.float()).to(compute_dtype)


def _inputs(N, H, dh, n_ctx, seed, q_dtype=torch.float32, kv_dtype=torch.float32, qscale=1.0):
    g = torch.Generator().manual_seed(seed)
    q = (qscale * torch.randn((N, H, dh), generator=g)).to(q_dtype)
    keys = torch.randn((H, n_ctx, dh), generator=g).to(kv_dtype)
    values = torch.randn((H, n_ctx, dh), generator=g).to(kv_dtype)
    return q, keys, values


@pytest.mark.parametrize("n_ctx", [64, 1024], ids=["whole", "chunked"])
@pytest.mark.parametrize("N,n_past", [(1, 0), (17, 0), (5, 40), (64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_bit_for_bit_the_earlier_attention(n_ctx, N, n_past, dtype):
    q, keys, values = _inputs(N, 2, 16, n_ctx, seed=N + n_past, q_dtype=dtype, kv_dtype=dtype)
    want = _seed_attention(q, keys, values, n_past, n_ctx, dtype)
    for got in (att.flash_prefill_attention(q, keys, values, n_past, dtype),
                model_lib._attention(q, keys, values, n_past, n_ctx, dtype)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_plain_chunked_bit_for_bit_at_n_ctx_4096():
    q, keys, values = _inputs(40, 2, 16, 4096, seed=5)
    want = _seed_attention_chunked(q, keys, values, 1000, 4096, torch.float32)
    assert torch.equal(att.flash_prefill_attention(q, keys, values, 1000, torch.float32), want)


PLAN_N = [1, 17, 64, 100, 2560]
PLAN_N_PAST = [0, 70, 1000]
PLAN_DH = [16, 18, 64, 128, 256]


@pytest.mark.parametrize("dh", PLAN_DH)
@pytest.mark.parametrize("n_past", PLAN_N_PAST)
@pytest.mark.parametrize("N", PLAN_N)
def test_plan_covers_every_row_reads_only_live_keys_longest_first(N, n_past, dh):
    for elt in (4, 2):
        plan = att.flash_prefill_plan(N, dh, n_past, elt)
        assert plan.dp % 8 == 0 and dh <= plan.dp <= 2 * max(dh, 32)
        assert plan.smem_bytes <= att.SMEM_LIMIT
        order = plan.order()
        rows = [r for q0, qn in order for r in range(q0, q0 + qn)]
        assert sorted(rows) == list(range(N))
        ends = [plan.key_end(q0, qn) for q0, qn in order]
        assert ends == sorted(ends, reverse=True)  # longest first
        assert ends[0] == n_past + N
        for q0, qn in order:
            tiles = plan.key_tiles(q0, qn)
            keys = [k for k0, kn in tiles for k in range(k0, k0 + kn)]
            # every key its last row attends, each once, none at or past n_past + N
            assert keys == list(range(n_past + q0 + qn))
            assert all(k0 < n_past + N and k0 + kn <= n_past + N for k0, kn in tiles)
            for r0, rn in plan.warp_rows(q0, qn):
                for k0, kn in tiles:
                    tile = range(k0, k0 + plan.bk)
                    if plan.skipped(r0, rn, k0):  # no key of the tile is any row's
                        assert all(k > n_past + r0 + rn - 1 for k in tile)
                    elif not plan.masked(r0, k0):  # every key of the tile is every row's
                        assert all(k <= n_past + r0 for k in tile)


def test_plan_tiles_are_chosen_from_the_shapes():
    assert [att.flash_prefill_plan(n, 128).warps for n in (1, 16, 17, 32, 33, 2560)] == [1, 1, 2, 2, 4, 4]
    assert [att.flash_prefill_plan(64, dh).dp for dh in (2, 64, 66, 128, 130, 256)] == [64, 64, 128, 128, 256, 256]
    assert [att.flash_prefill_plan(64, dh).bk for dh in (64, 128, 256)] == [64, 32, 32]
    # the cells' shape: 40 query tiles of 64 rows, 103,424 bytes a block (two blocks an SM)
    plan = att.flash_prefill_plan(2560, 128, 0, 4)
    assert (plan.q_tiles, plan.bq, plan.smem_bytes) == (40, 64, 103424)


def _mirror(q, keys, values, n_past, plan):
    """The kernel's loop in PyTorch f32: blocks in launch order, each warp's
    16 rows over the block's key tiles (rows past n_past + N zero-filled,
    as the copy does), the diagonal mask only on crossing tiles, skipped
    tiles, online softmax in log2 units with exp2."""
    N, H, dh = q.shape
    c = (1.0 / math.sqrt(float(dh))) * math.log2(math.e)
    out = torch.full((N, H, dh), float("nan"))
    for h in range(H):
        for q0, qn in plan.order():
            end = plan.key_end(q0, qn)
            for r0, rn in plan.warp_rows(q0, qn):
                qw = q[r0 : r0 + rn, h].float()
                lim = n_past + torch.arange(r0, r0 + rn)[:, None]
                m = torch.full((rn, 1), float("-inf"))
                l = torch.zeros((rn, 1))
                o = torch.zeros((rn, dh))
                for k0, kn in plan.key_tiles(q0, qn):
                    if plan.skipped(r0, rn, k0):
                        continue
                    kt = torch.zeros((plan.bk, dh))
                    vt = torch.zeros((plan.bk, dh))
                    kt[:kn] = keys[h, k0 : k0 + kn].float()
                    vt[:kn] = values[h, k0 : k0 + kn].float()
                    s = (qw @ kt.T) * c
                    if plan.masked(r0, k0):
                        s = torch.where(k0 + torch.arange(plan.bk)[None, :] <= lim, s, float("-inf"))
                    m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                    m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(s - m_use)
                    l = l * alpha + p.sum(dim=1, keepdim=True)
                    o = o * alpha + p @ vt
                    m = m_new
                assert end <= n_past + N
                out[r0 : r0 + rn, h] = o / l.clamp_min(1e-30)
    return out


@pytest.mark.parametrize("dh", [16, 18, 64])
@pytest.mark.parametrize("n_past", [0, 70])
@pytest.mark.parametrize("N", [1, 17, 64, 100])
def test_mirror_of_the_kernel_loop_matches_plain(N, n_past, dh):
    n_keys = n_past + N + 9
    q, keys, values = _inputs(N, 2, dh, n_keys, seed=3 * N + dh, qscale=3.0)
    keys[:, n_past + N :] = float("nan")  # never read: the kernel's copy zero-fills past n_past + N
    values[:, n_past + N :] = float("nan")
    want = att.flash_prefill_attention_plain(q, keys[:, : n_past + N], values[:, : n_past + N], n_past,
                                             torch.float32)
    got = _mirror(q, keys, values, n_past, att.flash_prefill_plan(N, dh, n_past, 4))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-6 * float(values[:, : n_past + N].abs().max())


@pytest.mark.parametrize("dh", [258, 17, 3, 0, 512])
def test_head_dims_the_kernel_does_not_take_raise(dh):
    q, keys, values = _inputs(4, 2, dh, 16, seed=1)
    with pytest.raises(ValueError):
        att.flash_prefill_attention(q, keys, values, 0, torch.float32)
    with pytest.raises(ValueError):
        att.flash_prefill_plan(4, dh)


def test_wrapper_refuses_mismatched_shapes_and_overflow():
    q, keys, values = _inputs(8, 2, 16, 16, seed=2)
    with pytest.raises(ValueError):  # n_past + N beyond the plane
        att.flash_prefill_attention(q, keys, values, 9, torch.float32)
    with pytest.raises(ValueError):  # head counts differ
        att.flash_prefill_attention(q, keys[:1], values[:1], 0, torch.float32)
    with pytest.raises(ValueError):  # planes of two shapes
        att.flash_prefill_attention(q, keys, values[:, :8], 0, torch.float32)
    with pytest.raises(ValueError):  # planes on another device than q
        att.flash_prefill_attention(q, keys.to("meta"), values.to("meta"), 0, torch.float32)


def test_counters_are_registered_and_reset():
    assert "flash_prefill_attention" in ops.launch_counts()
    att.flash_prefill_attention.launches, att.flash_prefill_attention.keys_read = 3, 99
    ops.reset_launch_counts()
    assert (att.flash_prefill_attention.launches, att.flash_prefill_attention.keys_read) == (0, 0)
