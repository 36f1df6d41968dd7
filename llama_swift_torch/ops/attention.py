"""Decode attention: the wrappers of the flash-decode kernels
(``csrc/flash_decode.cu``), their plain versions, and the unfused reference.

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
on the H100.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: keys per split of the kernel's first pass (``CHUNK`` in the CUDA source)
SPLIT = 64

#: cache element type -> the CUDA source's ``kind`` argument
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
    """Raise unless the caches lie on q's CUDA device, are contiguous and of
    one shape, and are f32/bf16 (``scales == ()``) or int8 with contiguous
    f32 row scales ``k.shape[:-1] + (1,)``; returns the kernel's ``kind``."""
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
    dh = k.shape[-1]
    if dh % 32 or not 32 <= dh <= 1024:
        raise ValueError(f"{what}: head dim {dh} must be a multiple of 32 in [32, 1024]")
    return _KIND[k.dtype]


def _check_q(what, q, shape) -> None:
    if q.dtype != torch.float32 or tuple(q.shape) != shape or not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous float32 {list(shape)}")


def _check_n_pasts(what, q, n_pasts, B) -> None:
    if n_pasts.device != q.device or n_pasts.dtype != torch.int32 or tuple(n_pasts.shape) != (B,) \
            or not n_pasts.is_contiguous():
        raise ValueError(f"{what}: n_pasts must be contiguous int32 [{B}] on q's device")


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
    n_keys = n_past + 1
    part = torch.empty(H * -(-n_keys // SPLIT) * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode(
        q.data_ptr(), k_cache[il].data_ptr(), v_cache[il].data_ptr(), *_scale_ptrs(scales, il),
        part.data_ptr(), out.data_ptr(), H, n_ctx, dh, n_keys, 1.0 / math.sqrt(float(dh)), kind, _stream(q),
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
    part = torch.empty(B * H * -(-n_keys // SPLIT) * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode_batched(
        q.data_ptr(), k_cache[il].data_ptr(), v_cache[il].data_ptr(), *_scale_ptrs(scales, il),
        n_pasts.data_ptr(), part.data_ptr(), out.data_ptr(), B, H, n_ctx, dh, n_keys,
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
    part = torch.empty(B * H * -(-n_keys // SPLIT) * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    code = build.lib("flash_decode").flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(scales),
        page_table.data_ptr(), n_pasts.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, P, L, H, page, MP, il, dh, n_keys, 1.0 / math.sqrt(float(dh)), kind, _stream(q),
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
