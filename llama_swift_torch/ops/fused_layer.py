"""Fused batch-1 decode kernels and their plain versions: the whole-stack
kernel (all L transformer layers of one token in one launch,
``csrc/fused_layer.cu``) and one layer in two kernels, the attention block
(on the whole-stack kernel's phases, in the same source) and the FFN block
(``csrc/fused_blocks.cu``).

Counterpart of ``llama_swift_tpu/ops/q4_fused_layer.py``
(``fused_layers_block``, ``fused_attn_block``, ``fused_ffn_block``,
``rope_vectors``, ``block_perm``).  The port keeps its own Q4_0 layout
(:class:`~.q4_matvec.Q4_0Weight`, stacked ``[L, out, in/2]``); the TPU W
layout and its block permutation λ exist for Mosaic's lane rules, and
:func:`block_perm` is here only so that
:func:`~.q4_matmul.from_jax_w` can undo λ.

Whole stack, per layer: norm → 4-bit activation quantization → fused wqkv →
rope → the new K/V written to the cache at ``n_past`` → attention over keys
``j <= n_past`` → wo → residual → norm → fused w13 → SwiGLU → w2 →
residual, with every product the exact int4×int4 block dot.  The JAX kernel
returns the new K/V for the caller to write; here they are written in place
before attention reads them, which gives the new token's own softmax term
the cache-rounded values the JAX kernel's round trip gives it.

The two blocks (the JAX package's "two kernels per layer" design, which no
serving path of either package reaches) keep the JAX semantics: the
attention block only reads the cache, at ``j < n_past``, returns the new
token's roped K and V rounded through the cache type for the caller to
write at ``n_past``, and puts their term last in the softmax; each block
returns its delta and the caller adds the residual.  Only the TPU's
``[ot, 8, 128]`` output tiles (row 0 live) become a ``[D]`` delta.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..config import QK
from . import build
from .attention import flash_decode_attention_plain, split_plan
from .norms import norm
from .q4_matvec import Q4_0Weight, q4_0_matvec_plain

#: the head dim the kernel takes (one thread per dim, as the TPU kernel
#: maps one head per 128-lane tile)
HEAD_DIM = 128

_KIND = {torch.float32: 0, torch.bfloat16: 1}


def block_perm(nb: int) -> np.ndarray:
    """λ of the TPU W layout: packed block position λ holds logical block
    ``4·(λ % R) + λ // R`` (R = nb // 4); a copy of
    ``llama_swift_tpu/ops/q4_fused_layer.block_perm``."""
    R = nb // 4
    lam = np.arange(nb)
    return 4 * (lam % R) + lam // R


def rope_vectors(n_past: int, head_dim: int = HEAD_DIM, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(cos_row, sin_signed_row) ``[head_dim]`` f32 for position ``n_past``:
    ``theta_j = 10000^(-2j/d)``, cos repeated per pair, sin signed −/+ for
    the even/odd element (a copy of the JAX ``rope_vectors``)."""
    j = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    theta = torch.pow(10000.0, -2.0 * j / head_dim)  # a scalar base: no host-to-device copy
    ang = float(n_past) * theta
    cos = torch.repeat_interleave(torch.cos(ang), 2)
    sin = torch.sin(ang)
    return cos, torch.stack([-sin, sin], dim=1).reshape(-1)


def _rope_rows(x: torch.Tensor, cos: torch.Tensor, sin_s: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair rope of ``[H, Dh]`` rows: ``x·cos + swap(x)·sin_s``,
    swap exchanging each (2i, 2i+1) pair."""
    swap = x.reshape(*x.shape[:-1], -1, 2).flip(-1).reshape(x.shape)
    return x * cos + swap * sin_s


def fused_layers_block_plain(
    x, attn_norms, ffn_norms, wqkv: Q4_0Weight, wo: Q4_0Weight, w13: Q4_0Weight, w2: Q4_0Weight,
    k_cache, v_cache, n_past: int, *, norm_type: str = "layernorm", eps: float = 1e-5,
    trace: Optional[list] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same arithmetic layer by
    layer (the exact integer matvec, the JAX SwiGLU formula), attention over
    the cache after the new row is written (history, then the own term
    last).  Writes each layer's K/V at ``n_past``; returns x ``[D]`` f32.
    ``trace``: a list to which the quantizer inputs ``[L, 3D + F]`` (attn
    norm, ctx, ffn norm, gate per layer) are appended."""
    L, H = attn_norms.shape[0], k_cache.shape[1]
    D, F = H * HEAD_DIM, w2.shape[1]
    cos, sin_s = rope_vectors(n_past, HEAD_DIM, x.device)
    x = x.float().reshape(D)
    rows = []
    for il in range(L):
        h = norm(x, attn_norms[il], norm_type, eps)
        qkv = q4_0_matvec_plain(h, wqkv.layer(il))
        q = _rope_rows(qkv[:D].reshape(H, HEAD_DIM), cos, sin_s)
        k_cache[il, :, n_past] = _rope_rows(qkv[D : 2 * D].reshape(H, HEAD_DIM), cos, sin_s).to(k_cache.dtype)
        v_cache[il, :, n_past] = qkv[2 * D :].reshape(H, HEAD_DIM).to(v_cache.dtype)
        ctx = flash_decode_attention_plain(q, k_cache, v_cache, il, n_past).reshape(D)
        x = x + q4_0_matvec_plain(ctx, wo.layer(il))
        h2 = norm(x, ffn_norms[il], norm_type, eps)
        g13 = q4_0_matvec_plain(h2, w13.layer(il))
        g1, g3 = g13[:F], g13[F:]
        gate = g1 / (1.0 + torch.exp(-g1)) * g3
        x = x + q4_0_matvec_plain(gate, w2.layer(il))
        if trace is not None:
            rows.append(torch.cat([h, ctx, h2, gate]))
    if trace is not None:
        trace.append(torch.stack(rows).cpu())
    return x


def _check(x, norms, weights, k_cache, v_cache, n_past: int) -> tuple[int, int, int, int]:
    """Raise on what the kernel does not take; returns (L, H, D, F)."""
    what = "fused_layers_block"
    L, H, n_ctx, dh = k_cache.shape
    D = H * dh
    wqkv, wo, w13, w2 = weights
    F = w2.shape[1]
    if dh != HEAD_DIM:
        raise ValueError(f"{what}: head dim {dh}, the kernel takes {HEAD_DIM}")
    if k_cache.dtype not in _KIND or v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: caches must be f32 or bf16 [L, H, n_ctx, {HEAD_DIM}], one type")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what}: caches must be contiguous")
    if not 0 <= n_past < n_ctx:
        raise ValueError(f"{what}: n_past {n_past} outside [0, {n_ctx})")
    if x.dtype != torch.float32 or x.shape != (D,):
        raise ValueError(f"{what}: x must be float32 [{D}], got {x.dtype} {tuple(x.shape)}")
    for nw in norms:
        if nw.dtype != torch.float32 or nw.shape != (L, D) or not nw.is_contiguous():
            raise ValueError(f"{what}: norms must be contiguous float32 [{L}, {D}]")
    for w, (out, in_dim) in zip(weights, [(3 * D, D), (D, D), (2 * F, D), (D, F)]):
        if (w.qs.dtype != torch.uint8 or w.qs.shape != (L, out, in_dim // 2) or not w.qs.is_contiguous()
                or w.d.dtype != torch.float32 or w.d.shape != (L, out, in_dim // QK) or not w.d.is_contiguous()):
            raise ValueError(f"{what}: a weight is not a contiguous stacked Q4_0 [{L}, {out}, {in_dim}]")
    if F % QK:
        raise ValueError(f"{what}: n_ff {F} is not a multiple of {QK}")
    tensors = [x, *norms, k_cache, v_cache] + [t for w in weights for t in (w.qs, w.d)]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one CUDA device")
    return L, H, D, F


def fused_layers_block(
    x, attn_norms, ffn_norms, wqkv: Q4_0Weight, wo: Q4_0Weight, w13: Q4_0Weight, w2: Q4_0Weight,
    k_cache, v_cache, n_past: int, *, norm_type: str = "layernorm", eps: float = 1e-5,
    trace: Optional[list] = None,
) -> torch.Tensor:
    """All L layers of one decode token: x ``[D]`` f32 residual stream in;
    returns the stream after L layers.  Stacked weights ``[L, out, in/2]``
    (wqkv: 3D rows q;k;v; w13: 2F rows w1;w3), norms ``[L, D]`` f32, caches
    ``[L, H, n_ctx, 128]`` f32 or bf16 written in place at row ``n_past``.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  ``trace``: see :func:`fused_layers_block_plain` (a check's
    hook: the kernel then writes its quantizer inputs too)."""
    if x.device.type == "cpu":
        return fused_layers_block_plain(x, attn_norms, ffn_norms, wqkv, wo, w13, w2, k_cache, v_cache, n_past,
                                        norm_type=norm_type, eps=eps, trace=trace)
    if norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    weights = (wqkv, wo, w13, w2)
    L, H, D, F = _check(x, (attn_norms, ffn_norms), weights, k_cache, v_cache, n_past)
    out = x.clone()
    lib = build.lib("fused_layer")
    scratch = torch.empty(lib.fused_layers_scratch_bytes(H, F, n_past), dtype=torch.uint8, device=x.device)
    tr = torch.empty((L, 3 * D + F), dtype=torch.float32, device=x.device) if trace is not None else None
    code = lib.fused_layers(
        out.data_ptr(), attn_norms.data_ptr(), ffn_norms.data_ptr(),
        *[p for w in weights for p in (w.qs.data_ptr(), w.d.data_ptr())],
        k_cache.data_ptr(), v_cache.data_ptr(), scratch.data_ptr(), tr.data_ptr() if tr is not None else None,
        L, H, F, k_cache.shape[2], n_past, int(norm_type == "layernorm"), eps,
        1.0 / math.sqrt(float(HEAD_DIM)), _KIND[k_cache.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    build.check(code, "fused_layers_block")
    fused_layers_block.launches += 1
    if trace is not None:
        trace.append(tr.cpu())
    return out


fused_layers_block.launches = 0


def grid_blocks(n_head: int, n_ff: int, dtype=torch.float32) -> int:
    """Blocks of the kernel's cooperative launch on the current card: one
    block a multiprocessor (132 on the H100), where the occupancy
    calculator says it is resident; raises if none fits."""
    n = build.lib("fused_layer").fused_layers_blocks(n_head, n_ff, _KIND[dtype])
    build.check(max(0, -n), "fused_layers_block grid")
    return n


# ---------------------------------------------------------------------------
# one layer in two kernels: the attention block and the FFN block
# ---------------------------------------------------------------------------


def _check_stacked(w, L: int, out: int, in_dim: int, what: str, name: str) -> None:
    if not isinstance(w, Q4_0Weight) or (
            w.qs.dtype != torch.uint8 or tuple(w.qs.shape) != (L, out, in_dim // 2) or not w.qs.is_contiguous()
            or w.d.dtype != torch.float32 or tuple(w.d.shape) != (L, out, in_dim // QK)
            or not w.d.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous stacked Q4_0 [{L}, {out}, {in_dim}]")


def _check_vector(v, n: int, what: str, name: str) -> None:
    if v.dtype != torch.float32 or tuple(v.shape) != (n,) or not v.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous float32 [{n}], got {v.dtype} {tuple(v.shape)}")


def _check_attn(x, attn_norm, cos, sin, wqkv, wo, k_cache, v_cache, il: int, n_past: int) -> tuple[int, int]:
    """Raise on what the attention block does not take (on the CPU too:
    the JAX block has no int8 scales and maps a head to a 128-lane tile);
    returns (H, D)."""
    what = "fused_attn_block"
    if k_cache.dtype not in _KIND or v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: caches must be f32 or bf16 [L, H, n_ctx, {HEAD_DIM}], one type "
                         f"(got {k_cache.dtype}; an int8 cache has no counterpart in the JAX block)")
    L, H, n_ctx, dh = k_cache.shape
    D = H * dh
    if dh != HEAD_DIM:
        raise ValueError(f"{what}: head dim {dh}, the block takes {HEAD_DIM}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what}: caches must be contiguous")
    if not 0 <= n_past < n_ctx:
        raise ValueError(f"{what}: n_past {n_past} outside [0, {n_ctx})")
    if not 0 <= il < L:
        raise ValueError(f"{what}: layer {il} outside [0, {L})")
    for v, n, name in ((x, D, "x"), (attn_norm, D, "attn_norm"), (cos, HEAD_DIM, "cos"), (sin, HEAD_DIM, "sin")):
        _check_vector(v, n, what, name)
    _check_stacked(wqkv, L, 3 * D, D, what, "wqkv")
    _check_stacked(wo, L, D, D, what, "wo")
    tensors = [x, attn_norm, cos, sin, k_cache, v_cache, wqkv.qs, wqkv.d, wo.qs, wo.d]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one device")
    return H, D


def attn_block_plan(n_head: int, n_past: int, sms: int = 132) -> tuple[int, int]:
    """(splits of a head, keys of a split) of the attention block's history
    pass at ``n_past`` on a card of ``sms`` SMs (one block each): at most
    ``sms // n_head`` splits a head (4 at 32 heads, 3 at 40, 2 at 52 and
    64), each a multiple of 16 keys, none empty; (0, 0) at n_past 0, where
    there is no history.  The CUDA source's ``block_split_plan`` (queried by
    ``fused_attn_block_splits``/``_split_keys``) computes the same."""
    return split_plan(n_past, max(1, sms // n_head)) if n_past else (0, 0)


def fused_attn_block_plain(
    x, attn_norm, cos, sin, wqkv: Q4_0Weight, wo: Q4_0Weight, k_cache, v_cache, il: int, n_past: int, *,
    norm_type: str = "layernorm", eps: float = 1e-5, trace: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the attention block: the exact integer
    matvec, rope with the given vectors, the new k and v rounded through the
    cache dtype, softmax over the history ``j < n_past`` and the new
    token's own term (last), then wo.  Returns (delta ``[D]``, k_new, v_new
    ``[H, 128]``) f32; the cache is only read.  ``trace``: a list to which
    the quantizer inputs ``[2D]`` (attention norm, ctx) are appended."""
    H, D = k_cache.shape[1], k_cache.shape[1] * HEAD_DIM
    h = norm(x.float(), attn_norm, norm_type, eps)
    qkv = q4_0_matvec_plain(h, wqkv.layer(il))
    q = _rope_rows(qkv[:D].reshape(H, HEAD_DIM), cos, sin)
    k_new = _rope_rows(qkv[D : 2 * D].reshape(H, HEAD_DIM), cos, sin).to(k_cache.dtype).float()
    v_new = qkv[2 * D :].reshape(H, HEAD_DIM).to(v_cache.dtype).float()
    scale = 1.0 / math.sqrt(float(HEAD_DIM))
    keys, values = k_cache[il, :, :n_past].float(), v_cache[il, :, :n_past].float()
    s = torch.cat([torch.einsum("hd,hjd->hj", q, keys), (q * k_new).sum(-1, keepdim=True)], dim=-1) * scale
    p = torch.softmax(s, dim=-1)
    ctx = (torch.einsum("hj,hjd->hd", p[:, :n_past], values) + p[:, n_past:] * v_new).reshape(D)
    if trace is not None:
        trace.append(torch.cat([h, ctx]).cpu())
    return q4_0_matvec_plain(ctx, wo.layer(il)), k_new, v_new


def fused_attn_block(
    x, attn_norm, cos, sin, wqkv: Q4_0Weight, wo: Q4_0Weight, k_cache, v_cache, il: int, n_past: int, *,
    norm_type: str = "layernorm", eps: float = 1e-5, trace: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer ``il``'s attention block of one decode token: x ``[D]`` f32
    (the residual stream), ``attn_norm`` ``[D]`` (the layer's), ``cos`` and
    ``sin`` ``[128]`` (:func:`rope_vectors` of ``n_past``), stacked weights
    ``wqkv [L, 3D, D]`` and ``wo [L, D, D]``, caches ``[L, H, n_ctx, 128]``
    f32 or bf16, only read, at rows ``j < n_past``.  Returns (delta ``[D]``,
    k_new, v_new ``[H, 128]``) f32, the new rows already rounded through the
    cache dtype; the caller writes them at ``n_past`` and adds the delta.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  ``trace``: see :func:`fused_attn_block_plain`."""
    if norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    H, D = _check_attn(x, attn_norm, cos, sin, wqkv, wo, k_cache, v_cache, il, n_past)
    if x.device.type == "cpu":
        return fused_attn_block_plain(x, attn_norm, cos, sin, wqkv, wo, k_cache, v_cache, il, n_past,
                                      norm_type=norm_type, eps=eps, trace=trace)
    lib = build.lib("fused_layer")
    scratch = torch.empty(lib.fused_attn_block_scratch_bytes(H, n_past), dtype=torch.uint8, device=x.device)
    delta = torch.empty(D, dtype=torch.float32, device=x.device)
    k_new = torch.empty((H, HEAD_DIM), dtype=torch.float32, device=x.device)
    v_new = torch.empty_like(k_new)
    tr = torch.empty(2 * D, dtype=torch.float32, device=x.device) if trace is not None else None
    code = lib.fused_attn_block(
        x.data_ptr(), attn_norm.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        wqkv.qs.data_ptr(), wqkv.d.data_ptr(), wo.qs.data_ptr(), wo.d.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), delta.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        scratch.data_ptr(), tr.data_ptr() if tr is not None else None,
        il, H, k_cache.shape[2], n_past, int(norm_type == "layernorm"), eps,
        1.0 / math.sqrt(float(HEAD_DIM)), _KIND[k_cache.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    build.check(code, "fused_attn_block")
    fused_attn_block.launches += 1
    if trace is not None:
        trace.append(tr.cpu())
    return delta, k_new, v_new


fused_attn_block.launches = 0


def _check_ffn(x, ffn_norm, w13, w2, il: int, fuse_shards: int) -> tuple[int, int]:
    """Raise on what the FFN block does not take; returns (D, F)."""
    what = "fused_ffn_block"
    if fuse_shards != 1:
        raise ValueError(f"{what}: w13 built with fuse_shards={fuse_shards} interleaves its rows per shard; "
                         "the block takes g1 in rows [0, F) and g3 in [F, 2F) (fuse_shards=1)")
    D = x.shape[0] if x.dim() == 1 else -1
    L, F = w2.qs.shape[0], w2.shape[1]
    _check_vector(x, D, what, "x")
    _check_vector(ffn_norm, D, what, "ffn_norm")
    if D % QK or F % QK:
        raise ValueError(f"{what}: widths {D}, {F} must be multiples of {QK}")
    _check_stacked(w13, L, 2 * F, D, what, "w13")
    _check_stacked(w2, L, D, F, what, "w2")
    if not 0 <= il < L:
        raise ValueError(f"{what}: layer {il} outside [0, {L})")
    if any(t.device != x.device for t in (ffn_norm, w13.qs, w13.d, w2.qs, w2.d)):
        raise ValueError(f"{what}: every tensor must be on one device")
    return D, F


def fused_ffn_block_plain(
    x, ffn_norm, w13: Q4_0Weight, w2: Q4_0Weight, il: int, *, norm_type: str = "layernorm", eps: float = 1e-5,
    trace: Optional[list] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the FFN block: ``w2·q4(silu(g1)⊙g3)`` with
    ``[g1; g3] = w13·q4(norm(x)·w)``, the exact integer matvec and the JAX
    SwiGLU formula.  Returns delta ``[D]`` f32.  ``trace``: a list to which
    the quantizer inputs ``[D + F]`` (FFN norm, gate) are appended."""
    F = w2.shape[1]
    h = norm(x.float(), ffn_norm, norm_type, eps)
    g13 = q4_0_matvec_plain(h, w13.layer(il))
    g1, g3 = g13[:F], g13[F:]
    gate = g1 / (1.0 + torch.exp(-g1)) * g3
    if trace is not None:
        trace.append(torch.cat([h, gate]).cpu())
    return q4_0_matvec_plain(gate, w2.layer(il))


def fused_ffn_block(
    x, ffn_norm, w13: Q4_0Weight, w2: Q4_0Weight, il: int, *, norm_type: str = "layernorm", eps: float = 1e-5,
    fuse_shards: int = 1, trace: Optional[list] = None,
) -> torch.Tensor:
    """Layer ``il``'s FFN block of one decode token: x ``[D]`` f32 (the
    residual stream), ``ffn_norm`` ``[D]`` (the layer's), stacked weights
    ``w13 [L, 2F, D]`` (g1 in rows ``[0, F)``, g3 in ``[F, 2F)``) and ``w2
    [L, D, F]``.  Returns delta ``[D]`` f32; the caller adds the residual.
    ``fuse_shards``: what w13 was built with (``Params.fuse_shards``); only
    1 keeps the halves apart, and any other raises.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise).  ``trace``:
    see :func:`fused_ffn_block_plain`."""
    if norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    D, F = _check_ffn(x, ffn_norm, w13, w2, il, fuse_shards)
    if x.device.type == "cpu":
        return fused_ffn_block_plain(x, ffn_norm, w13, w2, il, norm_type=norm_type, eps=eps, trace=trace)
    lib = build.lib("fused_blocks")
    scratch = torch.empty(lib.fused_ffn_block_scratch_bytes(D, F), dtype=torch.uint8, device=x.device)
    delta = torch.empty(D, dtype=torch.float32, device=x.device)
    tr = torch.empty(D + F, dtype=torch.float32, device=x.device) if trace is not None else None
    code = lib.fused_ffn_block(
        x.data_ptr(), ffn_norm.data_ptr(), w13.qs.data_ptr(), w13.d.data_ptr(), w2.qs.data_ptr(), w2.d.data_ptr(),
        delta.data_ptr(), scratch.data_ptr(), tr.data_ptr() if tr is not None else None,
        il, D, F, int(norm_type == "layernorm"), eps,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    build.check(code, "fused_ffn_block")
    fused_ffn_block.launches += 1
    if trace is not None:
        trace.append(tr.cpu())
    return delta


fused_ffn_block.launches = 0


def block_grids(n_head: int, n_ff: int, dtype=torch.float32) -> tuple[int, int]:
    """Blocks of the attention block's and the FFN block's cooperative
    launches on the current card (the occupancy limit: one block a
    multiprocessor for the attention block, at most four for the FFN
    block); raises if none fits."""
    n_attn = build.lib("fused_layer").fused_attn_block_blocks(n_head, _KIND[dtype])
    n_ffn = build.lib("fused_blocks").fused_ffn_block_blocks(n_head * HEAD_DIM, n_ff)
    build.check(max(0, -n_attn), "fused_attn_block grid")
    build.check(max(0, -n_ffn), "fused_ffn_block grid")
    return n_attn, n_ffn
