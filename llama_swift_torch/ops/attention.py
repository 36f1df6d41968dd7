"""Attention: the wrappers of the flash-decode kernels
(``csrc/flash_decode.cu``) and of the causal prefill kernel
(``csrc/flash_prefill.cu``), their plain versions, and the unfused reference.

Counterpart of ``llama_swift_tpu/ops/attention.py`` (``flash_decode_attention``,
``flash_decode_attention_stacked`` and its ``_int8`` variant,
``flash_decode_attention_batched`` and ``_int8``,
``flash_decode_attention_paged`` and ``_int8``,
``reference_decode_attention``).  Each kernel reads one layer of its cache
in place and only the keys ``j <= n_past`` of each slot:

* batch 1: the stacked head-major cache ``[L, H, n_ctx, Dh]``;
* batched: the engine's layer-major cache ``[L, B, H, n_ctx, Dh]``;
* paged: a page pool ``[P, L, H, page, Dh]`` through a table ``[B, MP]``.

Caches are f32 or bf16, or int8 with one f32 scale per (head, position)
row (scales ``[..., 1]`` beside the cache, ``[P, L, H, page, 1]`` beside a
pool).  The ``_int8`` wrappers fold the scales in as the TPU kernels do:
scores ``(q·k₈)·ks/√Dh``, value weights ``exp(s−m)·vs``, and the softmax
denominator sums the unscaled ``exp(s−m)``.

The batched and paged entry points take the per-slot positions as a device
int32 tensor ``n_pasts [B]`` and their largest value ``max_n_past`` as a
host int (the engine keeps both), so a step reads nothing back from the
card.  The note at the top of the CUDA source says what bounds the kernels
on the H100: each call is one launch on the chunk pass of
``csrc/flash_common.cuh``, a cluster of blocks a head (batch 1) or a
(slot, head) (batched and paged: one kernel template, the rows read from
the slot's plane or through its page table).  :func:`batched_plan` and
:func:`paged_plan` mirror those launches' plans (splits, tiles, ring
stages, shared memory).

Prefill (:func:`flash_prefill_attention`): N query rows against one
layer's K and V plane ``[H, n_keys, Dh]``, query i attending keys ``j <=
n_past + i``, in one launch a layer that reads only the keys ``j < n_past +
N`` and keeps the products at f32 precision (the CUDA source's note).
:func:`flash_prefill_plan` mirrors its launch (query tiles, their order,
key tiles, shared memory).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import build

#: cache element type -> the CUDA source's ``kind`` argument
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: the widest head the kernels take (4 dims a thread of a 256-thread block)
MAX_HEAD_DIM = 1024


def check_head_dim(what: str, dh: int) -> None:
    """Raise unless the kernels take head dim ``dh``: every even dim in [2,
    1024] (``head_dim_ok`` in the CUDA source).  Rows of a whole number of
    16-byte units on 16-byte aligned planes (``pass_bulk_rows``, dh 128 on
    every cache type) are staged by the bulk copy, others by plain loads."""
    if dh % 2 or not 2 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {dh} must be even and in [2, {MAX_HEAD_DIM}]")


# ---------------------------------------------------------------------------
# the chunk pass's launch plan (csrc/flash_common.cuh, csrc/flash_decode.cu)
# ---------------------------------------------------------------------------

PASS_MIN_KEYS = 16  # the least keys a split takes
PASS_BARRIER_BYTES = 128  # the ring's mbarriers
PASS_THREADS = 256  # threads of a block (ONE_THREADS)
PAGED_MAX_SPLITS = 2  # splits a (slot, head) of the paged kernel; the launcher takes at most 8
PAGED_STAGE_BYTES = 32768  # K and V rows of a full tile of the paged kernel
PAGED_STAGES = 2  # ring stages of the paged kernel (PAGED_STAGES)
BATCHED_SPLIT_KEYS = 256  # keys a split of the batched kernel aims at
BATCHED_MAX_SPLIT_KEYS = 1024  # keys a split of the batched kernel takes at most where 8 splits allow
BATCHED_BLOCKS_PER_SM = 4  # blocks a batched call aims at, at most, for each SM of the card
BATCHED_STAGE_BYTES = 32768  # K and V rows of a full tile of the batched kernel
BATCHED_STAGES = 2  # ring stages of the batched kernel (BATCHED_STAGES)
MAX_SPLITS = 8  # a cluster of the portable size (ONE_MAX_SPLITS)
MAX_TILE = 1024  # rows of a tile at most (SLOTS_MAX_TILE)
SMEM_LIMIT = 232448  # the most a block may take on the H100 (227 KB)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def split_plan(n_keys: int, max_splits: int) -> tuple[int, int]:
    """``(splits, keys)``: ``n_keys`` cut into at most ``max_splits`` runs of
    a multiple of 16 keys (the last may hold fewer), none empty."""
    s = min(-(-n_keys // PASS_MIN_KEYS), max_splits)
    length = -(-(-(-n_keys // s)) // PASS_MIN_KEYS) * PASS_MIN_KEYS
    return -(-n_keys // length), length


def pass_tile_rows(row_bytes: int, stage_bytes: int) -> int:
    """Rows of a tile when a ring stage holds ``stage_bytes`` of K and V
    rows, each padded to 16 bytes."""
    return max(1, (stage_bytes // 2) // _round16(row_bytes))


def pass_stage_bytes(tile: int, row_bytes: int, scaled: bool) -> int:
    return _round16(2 * tile * _round16(row_bytes) + (8 * tile if scaled else 0))


def pass_smem_bytes(tile: int, row_bytes: int, scaled: bool, stages: int) -> int:
    """The pass's shared memory: mbarriers, a tile's scores and weights,
    the key groups' sums, ``stages`` ring stages."""
    return (PASS_BARRIER_BYTES + _round16(8 * tile) + _round16(16 * PASS_THREADS)
            + stages * pass_stage_bytes(tile, row_bytes, scaled))


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """The plan of one batched or paged launch (the CUDA source's
    ``slots_smem_bytes`` computes the same shared memory from ``splits``
    and ``tile``): grid ``(splits, H, B)`` in clusters of ``splits``
    blocks; the longest split holds ``keys`` keys in tiles of ``tile``
    rows through a ring of two stages, of which it touches ``stages``;
    ``smem_bytes`` of dynamic shared memory a block.  ``page``: the pool's page rows (paged), or
    None (a slot's contiguous plane)."""

    splits: int
    keys: int
    tile: int
    stages: int
    smem_bytes: int
    grid: tuple
    page: int | None

    def slot_splits(self, n_keys_b: int) -> list:
        """``(j0, jn)`` of each split of a slot with ``n_keys_b`` keys (the
        kernel reads ``n_pasts[b] + 1`` on the card): ``split_plan(n_keys_b,
        splits)``; blocks past them hold no keys."""
        n, length = split_plan(n_keys_b, self.splits)
        return [(c * length, min(length, n_keys_b - c * length)) for c in range(n)]

    def tiles(self, j0: int, jn: int) -> list:
        """``(r0, n)`` of each tile of a split's keys ``[j0, j0 + jn)``."""
        return [(r0, min(self.tile, j0 + jn - r0)) for r0 in range(j0, j0 + jn, self.tile)]

    def runs(self, r0: int, n: int) -> list:
        """``(j, len)`` of each bulk copy of a tile's rows ``[r0, r0 + n)``:
        cut at page edges, each run within one page (one run on a plane)."""
        if self.page is None:
            return [(r0, n)]
        out, j = [], r0
        while j < r0 + n:
            length = min(r0 + n - j, self.page - j % self.page)
            out.append((j, length))
            j += length
        return out


def _slot_plan(what, B, H, dh, elt, n_keys, max_splits, stage_bytes, ring, page) -> SlotPlan:
    """``S = split_plan(n_keys, max_splits)`` splits, tiles of ``stage_bytes
    / 2`` of K rows or the longest split's keys if fewer, a ring of at most
    ``ring`` stages (as many as the split's tiles); the shared memory adds S
    partials, q and the block's own."""
    if B < 1 or H < 1 or n_keys < 1 or elt not in (1, 2, 4) or not 1 <= max_splits <= MAX_SPLITS:
        raise ValueError(f"{what}: B={B}, H={H}, n_keys={n_keys}, elt={elt}, max_splits={max_splits} out of range")
    check_head_dim(what, dh)
    row_bytes = dh * elt
    splits = split_plan(n_keys, max_splits)[0]
    keys = split_plan(n_keys, splits)[1]
    tile = min(pass_tile_rows(row_bytes, stage_bytes), keys, MAX_TILE)
    stages = min(-(-keys // tile), ring)
    smem = (_round16(4 * splits * (dh + 2)) + _round16(4 * dh) + _round16(4 * (dh + 2))
            + pass_smem_bytes(tile, row_bytes, elt == 1, stages))
    return SlotPlan(splits, keys, tile, stages, smem, (splits, H, B), page)


@functools.lru_cache(maxsize=4096)
def paged_plan(B: int, H: int, dh: int, elt: int, page: int, n_keys: int) -> SlotPlan:
    """The paged kernel's plan for ``B`` slots of ``H`` heads of dim ``dh``
    on cache elements of ``elt`` bytes (1: int8, with row scales), pages of
    ``page`` rows, at most ``n_keys = max_n_past + 1`` keys a slot:
    ``PAGED_MAX_SPLITS``, ``PAGED_STAGE_BYTES`` and ``PAGED_STAGES``, the
    fastest of the variants timed on an H100 (the CUDA source's note)."""
    if page < 1:
        raise ValueError(f"paged_plan: page={page} out of range")
    return _slot_plan("paged_plan", B, H, dh, elt, n_keys, PAGED_MAX_SPLITS, PAGED_STAGE_BYTES, PAGED_STAGES, page)


def batched_splits(B: int, H: int, n_keys: int, sms: int = 132) -> int:
    """Splits a (slot, head) of the batched kernel: one for every
    ``BATCHED_SPLIT_KEYS`` keys of the longest slot, halved while the grid
    would hold more than ``BATCHED_BLOCKS_PER_SM`` blocks an SM, but at
    least one for every ``BATCHED_MAX_SPLIT_KEYS`` keys; 1 to 8."""
    s = min(MAX_SPLITS, -(-n_keys // BATCHED_SPLIT_KEYS))
    while s > 1 and B * H * s > BATCHED_BLOCKS_PER_SM * sms:
        s //= 2
    return max(1, s, min(MAX_SPLITS, -(-n_keys // BATCHED_MAX_SPLIT_KEYS)))


@functools.lru_cache(maxsize=4096)
def batched_plan(B: int, H: int, dh: int, elt: int, n_keys: int, sms: int = 132) -> SlotPlan:
    """The batched kernel's plan for ``B`` slots of ``H`` heads of dim
    ``dh`` on a dense cache of ``elt``-byte elements (1: int8, with row
    scales), at most ``n_keys = max_n_past + 1`` keys a slot, on a card of
    ``sms`` SMs: :func:`batched_splits` splits, ``BATCHED_STAGE_BYTES``
    and ``BATCHED_STAGES``, the fastest of the variants timed on an H100
    (the CUDA source's note; ``tools/flash_variants.py``)."""
    splits = batched_splits(B, H, n_keys, sms) if B >= 1 and H >= 1 and n_keys >= 1 else 0
    return _slot_plan("batched_plan", B, H, dh, elt, n_keys, splits, BATCHED_STAGE_BYTES, BATCHED_STAGES, None)


def reference_decode_attention(q, keys, values, n_past: int) -> torch.Tensor:
    """Unfused reference: q ``[H, Dh]``, keys/values ``[H, n_ctx, Dh]``;
    attends slots ``j <= n_past``.  Returns ``[H, Dh]`` f32."""
    h, n_ctx, dh = keys.shape
    s = torch.einsum("hd,hjd->hj", q.float(), keys.float()) / math.sqrt(float(dh))
    j = torch.arange(n_ctx, device=keys.device)[None, :]
    s = torch.where(j <= n_past, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hj,hjd->hd", p, values.float())


def reference_decode_attention_batched(q, keys, values, n_pasts) -> torch.Tensor:
    """Unfused B-slot reference: q ``[B, H, Dh]``, keys/values ``[B, H, n,
    Dh]``; slot b attends ``j <= n_pasts[b]`` (the batched
    ``ggml_diag_mask_inf``).  Returns ``[B, H, Dh]`` f32."""
    dh = q.shape[-1]
    s = torch.einsum("bhd,bhjd->bhj", q.float(), keys.float()) * (1.0 / math.sqrt(float(dh)))
    j = torch.arange(keys.shape[2], device=keys.device)
    s = torch.where(j[None, None, :] <= n_pasts.to(keys.device)[:, None, None], s, float("-inf"))
    return torch.einsum("bhj,bhjd->bhd", torch.softmax(s, dim=-1), values.float())


def gather_pages(pool, page_table, il: int, n_keys: int) -> torch.Tensor:
    """Slot-major dense view of the first ``n_keys`` positions of layer
    ``il``: pool ``[P, L, H, page, X]``, table ``[B, MP]`` → ``[B, H,
    n_keys, X]`` (a copy; X is Dh for a pool, 1 for a scale pool).  Table
    ids are clamped to the pool, as the kernel does; only the pages that
    hold those positions are read."""
    P, _, H, page, dh = pool.shape
    tab = page_table[:, : -(-n_keys // page)].long().clamp(0, P - 1)  # [B, mp]
    planes = pool[tab, il]  # [B, mp, H, page, X]
    B, mp = tab.shape
    return planes.permute(0, 2, 1, 3, 4).reshape(B, H, mp * page, dh)[:, :, :n_keys]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_decode_attention_plain(q, k_cache, v_cache, il: int, n_past: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: softmax attention of q over the
    live keys ``0..n_past`` of layer ``il`` (the same scaling as the kernel:
    scores times ``1/sqrt(Dh)``)."""
    dh = q.shape[-1]
    keys = k_cache[il, :, : n_past + 1].float()
    values = v_cache[il, :, : n_past + 1].float()
    s = torch.einsum("hd,hjd->hj", q.float(), keys) * (1.0 / math.sqrt(float(dh)))
    return torch.einsum("hj,hjd->hd", torch.softmax(s, dim=-1), values)


def flash_decode_attention_stacked_int8_plain(q, k_cache, v_cache, k_scale, v_scale, il: int, n_past: int):
    """Plain PyTorch version of the int8 kernel: the live rows of layer
    ``il`` dequantized (``codes·scale``), then the masked softmax."""
    n = n_past + 1
    keys = k_cache[il, :, :n].float() * k_scale[il, :, :n]
    values = v_cache[il, :, :n].float() * v_scale[il, :, :n]
    return flash_decode_attention_plain(q, keys[None], values[None], 0, n_past)


def flash_decode_attention_batched_plain(q, k_cache, v_cache, il: int, n_pasts, max_n_past: int):
    """Plain PyTorch version of the batched kernel: masked softmax over
    layer ``il`` of the batched cache, keys ``j <= n_pasts[b]`` per slot."""
    n = max_n_past + 1
    return reference_decode_attention_batched(q, k_cache[il, :, :, :n], v_cache[il, :, :, :n], n_pasts)


def flash_decode_attention_batched_int8_plain(q, k_cache, v_cache, k_scale, v_scale, il: int, n_pasts,
                                              max_n_past: int):
    """Plain PyTorch version of the batched int8 kernel: layer ``il``'s
    rows up to ``max_n_past`` dequantized, then the batched masked softmax."""
    n = max_n_past + 1
    keys = k_cache[il, :, :, :n].float() * k_scale[il, :, :, :n]
    values = v_cache[il, :, :, :n].float() * v_scale[il, :, :, :n]
    return reference_decode_attention_batched(q, keys, values, n_pasts)


def flash_decode_attention_paged_plain(q, k_pool, v_pool, page_table, il: int, n_pasts, max_n_past: int):
    """Plain PyTorch version of the paged kernel: gather each slot's pages
    into a dense ``[B, H, n, Dh]``, then the batched masked softmax."""
    n = max_n_past + 1
    return reference_decode_attention_batched(
        q, gather_pages(k_pool, page_table, il, n), gather_pages(v_pool, page_table, il, n), n_pasts)


def flash_decode_attention_paged_int8_plain(q, k_pool, v_pool, k_scale_pool, v_scale_pool, page_table, il: int,
                                            n_pasts, max_n_past: int):
    """Plain PyTorch version of the paged int8 kernel: each slot's pages and
    their scale pages gathered and dequantized, then the batched masked
    softmax."""
    n = max_n_past + 1
    keys = gather_pages(k_pool, page_table, il, n).float() * gather_pages(k_scale_pool, page_table, il, n)
    values = gather_pages(v_pool, page_table, il, n).float() * gather_pages(v_scale_pool, page_table, il, n)
    return reference_decode_attention_batched(q, keys, values, n_pasts)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_caches(what, q, k, v, scales) -> int:
    """Raise unless the caches lie on q's CUDA device, are contiguous,
    aligned and of one shape, with a head dim the kernels take, and are
    f32/bf16 (``scales == ()``) or int8 with contiguous f32 row scales
    ``k.shape[:-1] + (1,)``; returns the kernel's ``kind``."""
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *scales))):
        raise ValueError(f"{what}: q, the caches and their scales must be on the same CUDA device")
    if v.shape != k.shape or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: caches must be contiguous and of one shape")
    if scales:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError(f"{what}: caches must both be int8")
        want = tuple(k.shape[:-1]) + (1,)
        if any(s.dtype != torch.float32 or tuple(s.shape) != want or not s.is_contiguous() for s in scales):
            raise ValueError(f"{what}: scales must be contiguous float32 {list(want)}")
    elif k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise ValueError(f"{what}: caches must both be float32 or both bfloat16")
    check_head_dim(what, k.shape[-1])
    if any(t.data_ptr() % max(2, t.element_size()) for t in (k, v)):
        raise ValueError(f"{what}: caches must be aligned to their element and to 2 bytes")
    return _KIND[k.dtype]


def _check_q(what, q, shape) -> None:
    if q.dtype != torch.float32 or tuple(q.shape) != shape or not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous float32 {list(shape)}")


def _check_n_pasts(what, q, n_pasts, B) -> None:
    if n_pasts.device != q.device or n_pasts.dtype != torch.int32 or tuple(n_pasts.shape) != (B,) \
            or not n_pasts.is_contiguous():
        raise ValueError(f"{what}: n_pasts must be contiguous int32 [{B}] on q's device")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(q):
    return ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)


def _scale_ptrs(scales, il=None):
    """Pointers of the scale tensors (of their layer ``il`` if given), or
    two NULLs for a float cache."""
    if not scales:
        return [None, None]
    return [(s if il is None else s[il]).data_ptr() for s in scales]


def _launch_stacked(what, q, k_cache, v_cache, scales, il: int, n_past: int) -> torch.Tensor:
    kind = _check_caches(what, q, k_cache, v_cache, scales)
    L, H, n_ctx, dh = k_cache.shape
    _check_q(what, q, (H, dh))
    if not (0 <= il < L and 0 <= n_past < n_ctx):
        raise ValueError(f"{what}: il={il}, n_past={n_past} out of range")
    out = torch.empty((H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode(
        q.data_ptr(), k_cache[il].data_ptr(), v_cache[il].data_ptr(), *_scale_ptrs(scales, il),
        out.data_ptr(), H, n_ctx, dh, n_past + 1, 1.0 / math.sqrt(float(dh)), kind, _stream(q),
    )
    build.check(code, what)
    return out


def _launch_batched(what, q, k_cache, v_cache, scales, il: int, n_pasts, max_n_past: int) -> torch.Tensor:
    kind = _check_caches(what, q, k_cache, v_cache, scales)
    L, B, H, n_ctx, dh = k_cache.shape
    _check_q(what, q, (B, H, dh))
    _check_n_pasts(what, q, n_pasts, B)
    if not (0 <= il < L and 0 <= max_n_past < n_ctx):
        raise ValueError(f"{what}: il={il}, max_n_past={max_n_past} out of range")
    n_keys = max_n_past + 1
    plan = batched_plan(B, H, dh, k_cache.element_size(), n_keys, _sm_count(q.device))
    if plan.smem_bytes > SMEM_LIMIT:  # the launcher refuses it too
        raise ValueError(f"{what}: {plan.smem_bytes} bytes of shared memory exceed {SMEM_LIMIT}")
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode_batched(
        q.data_ptr(), k_cache[il].data_ptr(), v_cache[il].data_ptr(), *_scale_ptrs(scales, il),
        n_pasts.data_ptr(), out.data_ptr(), B, H, n_ctx, dh, n_keys, plan.splits, plan.tile,
        1.0 / math.sqrt(float(dh)), kind, _stream(q),
    )
    build.check(code, what)
    return out


def _launch_paged(what, q, k_pool, v_pool, scales, page_table, il: int, n_pasts, max_n_past: int) -> torch.Tensor:
    kind = _check_caches(what, q, k_pool, v_pool, scales)
    P, L, H, page, dh = k_pool.shape
    B, MP = page_table.shape
    _check_q(what, q, (B, H, dh))
    _check_n_pasts(what, q, n_pasts, B)
    if page_table.dtype != torch.int32 or page_table.device != q.device or not page_table.is_contiguous():
        raise ValueError(f"{what}: page_table must be contiguous int32 on q's device")
    if not (0 <= il < L and 0 <= max_n_past < MP * page):
        raise ValueError(f"{what}: il={il}, max_n_past={max_n_past} out of range")
    n_keys = max_n_past + 1
    plan = paged_plan(B, H, dh, k_pool.element_size(), page, n_keys)
    if plan.smem_bytes > SMEM_LIMIT:  # the launcher refuses it too
        raise ValueError(f"{what}: {plan.smem_bytes} bytes of shared memory exceed {SMEM_LIMIT}")
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(scales),
        page_table.data_ptr(), n_pasts.data_ptr(), out.data_ptr(),
        B, P, L, H, page, MP, il, dh, n_keys, plan.splits, plan.tile, 1.0 / math.sqrt(float(dh)), kind, _stream(q),
    )
    build.check(code, what)
    return out


# ---------------------------------------------------------------------------
# wrappers: a CPU tensor takes the plain version, a CUDA tensor the kernel
# ---------------------------------------------------------------------------


def flash_decode_attention(q, k_cache, v_cache, il: int, n_past: int) -> torch.Tensor:
    """Single-query attention of ``q [H, Dh]`` f32 over layer ``il`` of the
    stacked caches ``[L, H, n_ctx, Dh]`` (f32 or bf16), keys ``j <= n_past``.
    Returns ``[H, Dh]`` f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, il, n_past)
    out = _launch_stacked("flash_decode_attention", q, k_cache, v_cache, (), il, n_past)
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def flash_decode_attention_stacked_int8(q, k_cache, v_cache, k_scale, v_scale, il: int, n_past: int):
    """:func:`flash_decode_attention` over an int8 stacked cache: codes
    ``[L, H, n_ctx, Dh]`` int8, row scales ``[L, H, n_ctx, 1]`` f32.  Returns
    ``[H, Dh]`` f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_int8_plain(q, k_cache, v_cache, k_scale, v_scale, il, n_past)
    out = _launch_stacked("flash_decode_attention_stacked_int8", q, k_cache, v_cache, (k_scale, v_scale),
                          il, n_past)
    flash_decode_attention_stacked_int8.launches += 1
    return out


flash_decode_attention_stacked_int8.launches = 0


def flash_decode_attention_batched(q, k_cache, v_cache, il: int, n_pasts, max_n_past: int) -> torch.Tensor:
    """B-slot single-query attention of ``q [B, H, Dh]`` f32 over layer
    ``il`` of the batched caches ``[L, B, H, n_ctx, Dh]`` (f32 or bf16):
    slot b attends keys ``j <= n_pasts[b]`` (int32 ``[B]`` on q's device;
    ``max_n_past`` bounds them).  Returns ``[B, H, Dh]`` f32.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_batched_plain(q, k_cache, v_cache, il, n_pasts, max_n_past)
    out = _launch_batched("flash_decode_attention_batched", q, k_cache, v_cache, (), il, n_pasts, max_n_past)
    flash_decode_attention_batched.launches += 1
    return out


flash_decode_attention_batched.launches = 0


def flash_decode_attention_batched_int8(q, k_cache, v_cache, k_scale, v_scale, il: int, n_pasts,
                                        max_n_past: int) -> torch.Tensor:
    """:func:`flash_decode_attention_batched` over an int8 batched cache:
    codes ``[L, B, H, n_ctx, Dh]`` int8, row scales ``[L, B, H, n_ctx, 1]``
    f32.  Returns ``[B, H, Dh]`` f32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_batched_int8_plain(
            q, k_cache, v_cache, k_scale, v_scale, il, n_pasts, max_n_past)
    out = _launch_batched("flash_decode_attention_batched_int8", q, k_cache, v_cache, (k_scale, v_scale),
                          il, n_pasts, max_n_past)
    flash_decode_attention_batched_int8.launches += 1
    return out


flash_decode_attention_batched_int8.launches = 0


def flash_decode_attention_paged(q, k_pool, v_pool, page_table, il: int, n_pasts, max_n_past: int) -> torch.Tensor:
    """B-slot single-query attention through a page table: pools ``[P, L,
    H, page, Dh]`` (f32 or bf16), ``page_table [B, MP]`` int32; key j of
    slot b is row ``j % page`` of page ``page_table[b, j // page]`` (clamped
    to the pool).  Entries beyond a slot's live pages are never read.
    Returns ``[B, H, Dh]`` f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_paged_plain(q, k_pool, v_pool, page_table, il, n_pasts, max_n_past)
    out = _launch_paged("flash_decode_attention_paged", q, k_pool, v_pool, (), page_table, il, n_pasts, max_n_past)
    flash_decode_attention_paged.launches += 1
    return out


flash_decode_attention_paged.launches = 0


def flash_decode_attention_paged_int8(q, k_pool, v_pool, k_scale_pool, v_scale_pool, page_table, il: int,
                                      n_pasts, max_n_past: int) -> torch.Tensor:
    """:func:`flash_decode_attention_paged` over an int8 pool: codes ``[P,
    L, H, page, Dh]`` int8 and scale pools ``[P, L, H, page, 1]`` f32,
    addressed by the same page ids.  Returns ``[B, H, Dh]`` f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if q.device.type == "cpu":
        return flash_decode_attention_paged_int8_plain(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, page_table, il, n_pasts, max_n_past)
    out = _launch_paged("flash_decode_attention_paged_int8", q, k_pool, v_pool, (k_scale_pool, v_scale_pool),
                        page_table, il, n_pasts, max_n_past)
    flash_decode_attention_paged_int8.launches += 1
    return out


flash_decode_attention_paged_int8.launches = 0


# ---------------------------------------------------------------------------
# causal prefill attention (csrc/flash_prefill.cu)
# ---------------------------------------------------------------------------

#: prefill contexts at/above this use the chunked online-softmax plain
#: version (peak score memory [H, N, chunk] instead of [H, N, n_ctx])
FLASH_PREFILL_MIN_CTX = 1024
PREFILL_MAX_HEAD_DIM = 256  # the widest head the prefill kernel takes
#: q and output element types -> the CUDA source's ``q_kind``/``out_kind``
_PREFILL_Q_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: plane element types -> ``kv_kind``
_PREFILL_KV_KIND = {torch.float32: 0, torch.bfloat16: 1}


def check_prefill_head_dim(what: str, dh: int) -> None:
    """Raise unless the prefill kernel takes head dim ``dh``: every even
    dim in [2, 256], zero-padded to the next of 64, 128 and 256."""
    if dh % 2 or not 2 <= dh <= PREFILL_MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {dh} must be even and in [2, {PREFILL_MAX_HEAD_DIM}]")


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """The launch of one prefill call (the CUDA source's ``flash_prefill``):
    head dim ``dh`` padded to ``dp``, key tiles of ``bk`` rows, ``warps``
    warps a block of 16 query rows each (``bq`` rows), ``q_tiles`` query
    tiles, one block a (query tile, head), ``smem_bytes`` of dynamic shared
    memory a block (``flash_prefill_smem_bytes``)."""

    n: int
    n_past: int
    dh: int
    dp: int
    bk: int
    warps: int
    bq: int
    q_tiles: int
    smem_bytes: int

    def order(self) -> list:
        """``(q0, qn)`` of each query tile in the order the blocks are
        issued: the last tile, which has the most keys, first."""
        return [(qt * self.bq, min(self.bq, self.n - qt * self.bq)) for qt in reversed(range(self.q_tiles))]

    def key_end(self, q0: int, qn: int) -> int:
        """Keys ``0 .. key_end - 1`` a block of rows ``[q0, q0 + qn)`` reads:
        up to its last row's diagonal, never at or past ``n_past + N``."""
        return self.n_past + q0 + qn

    def key_tiles(self, q0: int, qn: int) -> list:
        """``(k0, kn)`` of each key tile a block visits; the copy zero-fills
        the ``bk - kn`` rows of the last one."""
        end = self.key_end(q0, qn)
        return [(k0, min(self.bk, end - k0)) for k0 in range(0, end, self.bk)]

    def warp_rows(self, q0: int, qn: int) -> list:
        """``(r0, rn)`` of each warp of a block that holds query rows."""
        return [(q0 + 16 * w, min(16, qn - 16 * w)) for w in range(self.warps) if 16 * w < qn]

    def masked(self, r0: int, k0: int) -> bool:
        """Whether the key tile at ``k0`` crosses the diagonal of the warp
        whose first row is ``r0`` (only such tiles are masked)."""
        return k0 + self.bk - 1 > self.n_past + r0

    def skipped(self, r0: int, rn: int, k0: int) -> bool:
        """Whether a warp of rows ``[r0, r0 + rn)`` skips the key tile at
        ``k0``: it lies wholly beyond the warp's last row."""
        return k0 > self.n_past + r0 + rn - 1


@functools.lru_cache(maxsize=4096)
def flash_prefill_plan(n: int, dh: int, n_past: int = 0, elt: int = 4) -> PrefillPlan:
    """The prefill kernel's plan for ``n`` query rows after ``n_past``
    cached keys, heads of dim ``dh``, planes of ``elt``-byte elements (4:
    f32, 2: bf16), chosen from these shapes alone: ``dp`` the least of 64,
    128 and 256 (multiples of the MMA depth) that holds ``dh``, key tiles
    of 64 rows up to ``dp`` 64 and of 32 beyond (registers and shared
    memory), as few 16-row warps as N needs, at most 4."""
    if n < 1 or n_past < 0 or elt not in (2, 4):
        raise ValueError(f"flash_prefill_plan: n={n}, n_past={n_past}, elt={elt} out of range")
    check_prefill_head_dim("flash_prefill_plan", dh)
    dp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    bk = 64 if dp <= 64 else 32
    warps = 1 if n <= 16 else 2 if n <= 32 else 4
    bq = 16 * warps
    # Q rows of dp + 8 f32, two stages of K rows of dp + 8 and V rows of
    # dp + 4 (f32) or dp + 8 (bf16) elements
    smem = bq * (dp + 8) * 4 + 2 * bk * (2 * dp + (12 if elt == 4 else 16)) * elt
    return PrefillPlan(n, n_past, dh, dp, bk, warps, bq, -(-n // bq), smem)


def _attention_chunked(q, keys, values, n_past: int, n_ctx: int, compute_dtype, chunk: int = 512):
    """Online-softmax prefill attention over key chunks, so peak score
    memory is ``[H, N, chunk]`` (counterpart of ``_attention_flash_xla``).
    Same mask as :func:`flash_prefill_attention_plain`, softmax
    reassociated."""
    N, d = q.shape[0], q.shape[-1]
    H = keys.shape[0]
    scale = 1.0 / math.sqrt(float(d))
    qf = q.float().transpose(0, 1)  # [H, N, Dh]
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


def flash_prefill_attention_plain(q, keys, values, n_past: int, compute_dtype) -> torch.Tensor:
    """Plain PyTorch version of the prefill kernel: causal attention over
    the full plane, q ``[N, H, Dh]``, keys/values ``[H, n_ctx, Dh]``; query i
    attends keys ``j <= n_past + i`` (``ggml_diag_mask_inf``,
    ``ggml.c:6921-6981``), so stale slots beyond the high-water mark are
    never attended.  From ``FLASH_PREFILL_MIN_CTX`` keys (a multiple of 512)
    it takes :func:`_attention_chunked`."""
    n_ctx = keys.shape[1]
    if n_ctx >= FLASH_PREFILL_MIN_CTX and n_ctx % 512 == 0:
        return _attention_chunked(q, keys, values, n_past, n_ctx, compute_dtype)
    N, d = q.shape[0], q.shape[-1]
    scale = 1.0 / math.sqrt(float(d))
    scores = torch.einsum("nhd,hjd->hnj", q.float(), keys.float()) * scale
    i_idx = torch.arange(N, device=q.device)[:, None]
    j_idx = torch.arange(n_ctx, device=q.device)[None, :]
    scores = torch.where((j_idx <= n_past + i_idx)[None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hnj,hjd->nhd", p, values.float()).to(compute_dtype)


def _check_prefill(what, q, keys, values, n_past: int) -> None:
    """Raise unless q ``[N, H, Dh]`` and the planes ``[H, >= n_past + N,
    Dh]`` are on one device, of one head count and head dim, with a head
    dim the kernel takes (every caller, CPU tensors too)."""
    if keys.device != q.device or values.device != q.device:
        raise ValueError(f"{what}: q and the planes must be on one device")
    if q.dim() != 3 or keys.dim() != 3 or values.shape != keys.shape:
        raise ValueError(f"{what}: q must be [N, H, Dh] and the planes [H, n_keys, Dh] of one shape")
    N, H, dh = q.shape
    if keys.shape[0] != H or keys.shape[2] != dh:
        raise ValueError(f"{what}: planes {list(keys.shape)} do not match q {list(q.shape)}")
    check_prefill_head_dim(what, dh)
    if N < 1 or n_past < 0 or n_past + N > keys.shape[1]:
        raise ValueError(f"{what}: {N} rows at n_past={n_past} overflow {keys.shape[1]} keys")


def _launch_prefill(what, q, keys, values, n_past: int, compute_dtype) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f"{what}: q and the planes must be on a CUDA device")
    if q.dtype not in _PREFILL_Q_KIND or compute_dtype not in _PREFILL_Q_KIND:
        raise ValueError(f"{what}: q and the output must be float32, bfloat16 or float16")
    if keys.dtype not in _PREFILL_KV_KIND or values.dtype != keys.dtype:
        raise ValueError(f"{what}: planes must both be float32 or both bfloat16")
    if q.stride(2) != 1 or keys.stride(2) != 1 or values.stride() != keys.stride():
        raise ValueError(f"{what}: q and the planes need a unit dim stride, the planes one set of strides")
    N, H, dh = q.shape
    elt = keys.element_size()
    words = [keys.data_ptr(), values.data_ptr(), keys.stride(0) * elt, keys.stride(1) * elt]
    if any(x % 4 for x in words):
        raise ValueError(f"{what}: planes and their strides must be 4-byte aligned")
    vec16 = all(x % 16 == 0 for x in words + [dh * elt])
    plan = flash_prefill_plan(N, dh, n_past, elt)
    out = torch.empty((N, H, dh), dtype=compute_dtype, device=q.device)
    code = build.lib("flash_prefill").flash_prefill(
        q.data_ptr(), q.stride(0), q.stride(1), _PREFILL_Q_KIND[q.dtype], keys.data_ptr(), values.data_ptr(),
        keys.stride(0), keys.stride(1), _PREFILL_KV_KIND[keys.dtype], out.data_ptr(),
        _PREFILL_Q_KIND[compute_dtype], N, H, dh, n_past, plan.dp, plan.warps, int(vec16),
        1.0 / math.sqrt(float(dh)), _stream(q),
    )
    build.check(code, what)
    return out


def flash_prefill_attention(q, keys, values, n_past: int, compute_dtype) -> torch.Tensor:
    """Causal attention of N query rows ``q [N, H, Dh]`` (f32, bf16 or f16,
    any row and head strides) over a layer's K and V planes ``[H, n_keys,
    Dh]`` (f32 or bf16; int8 and paged caches pass the f32 plane the model
    builds): query i attends keys ``j <= n_past + i``.  Returns ``[N, H,
    Dh]`` in ``compute_dtype``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise).  ``launches`` counts the launches
    and ``keys_read`` the keys their heads read, ``H · (n_past + N)`` a
    launch: no key at or past ``n_past + N``."""
    _check_prefill("flash_prefill_attention", q, keys, values, n_past)
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, keys, values, n_past, compute_dtype)
    out = _launch_prefill("flash_prefill_attention", q, keys, values, n_past, compute_dtype)
    flash_prefill_attention.launches += 1
    flash_prefill_attention.keys_read += q.shape[1] * (n_past + q.shape[0])
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.keys_read = 0
