"""Port's batched and paged flash-decode attention
(llama_swift_torch/ops/attention.py) against the JAX package's
flash_decode_attention_batched / flash_decode_attention_paged in interpret
mode: per-slot n_pasts including 0 and n_ctx-1, stale data beyond each
slot's n_past, f32 and bf16 caches, and a shuffled page table with garbage
beyond the live pages.  On the CPU the wrappers run the kernels' plain
versions; the CUDA kernels are held against them by chip_smoke.py and
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.ops.attention import flash_decode_attention_batched, flash_decode_attention_paged
from llama_swift_torch.ops import attention as tatt

L, B, H, C, D = 2, 4, 4, 256, 128
N_PASTS = [0, 63, 200, C - 1]
REL = 1e-5


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((L, B, H, C, D)).astype(np.float32)
    v = rng.standard_normal((L, B, H, C, D)).astype(np.float32)
    for b, n in enumerate(N_PASTS):  # stale data beyond each slot's n_past
        k[:, b, :, n + 1 :] = 1e4
        v[:, b, :, n + 1 :] = -1e4
    return q, k, v


def _cast(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("il", [0, 1])
def test_batched_matches_jax_kernel(qkv, dtype, il):
    q, k, v = qkv
    kt, vt = _cast(k, dtype), _cast(v, dtype)
    n_pasts = torch.tensor(N_PASTS, dtype=torch.int32)
    out = tatt.flash_decode_attention_batched(torch.from_numpy(q), kt, vt, il, n_pasts, max(N_PASTS))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jk, _, _ = flash_decode_attention_batched(
        jnp.asarray(q), jnp.asarray(kt.float().numpy()).astype(jdt), jnp.asarray(vt.float().numpy()).astype(jdt),
        jnp.int32(il), jnp.asarray(N_PASTS, jnp.int32), interpret=True)
    assert out.shape == (B, H, D) and out.dtype == torch.float32
    assert _rel(out.numpy(), jk) <= REL


def test_batched_slot_equals_batch1_flash(qkv):
    """Slot b of the batched kernel is the batch-1 kernel over slot b's plane."""
    q, k, v = qkv
    n_pasts = torch.tensor(N_PASTS, dtype=torch.int32)
    out = tatt.flash_decode_attention_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1, n_pasts, max(N_PASTS))
    for b, n in enumerate(N_PASTS):
        one = tatt.flash_decode_attention(
            torch.from_numpy(q[b]), torch.from_numpy(k[:, b]), torch.from_numpy(v[:, b]), 1, n)
        assert _rel(out[b].numpy(), one.numpy()) <= REL


def test_batched_max_n_past_bounds_the_read(qkv):
    """A smaller max_n_past (all slots below it) reads fewer keys and gives
    the same result."""
    q, k, v = qkv
    n = [5, 0, 17, 9]
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0, torch.tensor(n, dtype=torch.int32))
    assert _rel(tatt.flash_decode_attention_batched(*args, 17).numpy(),
                tatt.flash_decode_attention_batched(*args, C - 1).numpy()) <= REL


def _paged(k, v, page, rng, garbage):
    """Scatter the dense [L, B, H, C, D] caches into a pool [P, L, H, page,
    D] through a shuffled table; entries beyond each slot's live pages hold
    ``garbage`` (out-of-range ids or pages of other slots)."""
    mp = C // page
    live = [n // page + 1 for n in N_PASTS]
    P = sum(live) + 1
    ids = rng.permutation(P - 1)
    table = np.full((B, mp), garbage, np.int32)
    kp = np.zeros((P, L, H, page, D), np.float32)
    vp = np.zeros_like(kp)
    nxt = 0
    for b in range(B):
        for c in range(live[b]):
            pid = ids[nxt]
            nxt += 1
            table[b, c] = pid
            kp[pid] = k[:, b, :, c * page : (c + 1) * page]
            vp[pid] = v[:, b, :, c * page : (c + 1) * page]
    return kp, vp, table


@pytest.mark.parametrize("page,garbage", [(128, 10**6), (16, -3), (64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_matches_jax_kernel_and_dense(qkv, page, garbage, dtype):
    q, k, v = qkv
    kp, vp, table = _paged(k, v, page, np.random.default_rng(page), garbage)
    kpt, vpt = _cast(kp, dtype), _cast(vp, dtype)
    n_pasts = torch.tensor(N_PASTS, dtype=torch.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for il in range(L):
        out = tatt.flash_decode_attention_paged(
            torch.from_numpy(q), kpt, vpt, torch.from_numpy(table), il, n_pasts, max(N_PASTS))
        dense = tatt.flash_decode_attention_batched(
            torch.from_numpy(q), _cast(k, dtype), _cast(v, dtype), il, n_pasts, max(N_PASTS))
        assert _rel(out.numpy(), dense.numpy()) <= REL
        jk, _, _ = flash_decode_attention_paged(
            jnp.asarray(q), jnp.asarray(kpt.float().numpy()).astype(jdt),
            jnp.asarray(vpt.float().numpy()).astype(jdt), jnp.asarray(table), jnp.int32(il),
            jnp.asarray(N_PASTS, jnp.int32), interpret=True)
        assert _rel(out.numpy(), jk) <= REL


def test_gather_pages_reads_only_live_pages():
    """gather_pages returns the slot-major dense view of the first n keys."""
    rng = np.random.default_rng(4)
    pool = torch.from_numpy(rng.standard_normal((5, 1, 2, 4, 8)).astype(np.float32))
    table = torch.tensor([[3, 1, 99], [0, 2, 4]], dtype=torch.int32)
    got = tatt.gather_pages(pool, table, 0, 6)
    assert got.shape == (2, 2, 6, 8)
    torch.testing.assert_close(got[0, :, :4], pool[3, 0])
    torch.testing.assert_close(got[0, :, 4:], pool[1, 0, :, :2])
    torch.testing.assert_close(got[1, :, 4:], pool[2, 0, :, :2])


def test_wrappers_reject_non_cpu_inputs(qkv):
    q = torch.zeros((B, H, D), device="meta")
    k = torch.zeros((L, B, H, C, D), device="meta")
    with pytest.raises(ValueError):
        tatt.flash_decode_attention_batched(q, k, k, 0, torch.zeros(B, dtype=torch.int32, device="meta"), 3)
