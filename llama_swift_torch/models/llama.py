"""LLaMA forward pass in PyTorch (counterpart of ``llama_swift_tpu/models/llama.py``).

Graph, op for op (``LlamaPredictOperation.mm:558-712``): tok_embedding
get_rows → per layer [ norm·attention_norm → wq/wk/wv → rope(Q)/rope(K) → KV
store → softmax(K·Qᵀ/√d, causal) · V → wo → +residual → norm·ffn_norm →
silu(w1·x)·(w3·x) → w2 → +residual ] → final norm·norm → output matmul.

The port runs eagerly: layers are a Python loop over views of stacked
``[L, ...]`` weights (the JAX package's unrolled path), and the KV cache is
written in place.  Single-token steps reach two CUDA kernels — the Q4_0
matvec for every matmul and flash-decode attention — and multi-token
(prefill) steps reach the Q4_0 dequant kernel before each matmul (the
multi-row kernel for 2–32 rows).  Q4_1 weights (``ggml-model-q4_1.bin``)
take the Q4_1 matvec for one row and the Q4_1 dequant for any other row
count, prefill and the engine's batched step alike: the JAX package has no
Q4_1 multi-row kernel.

The continuous-batching engine (``runtime/engine.py``) adds a batched
cache, dense (``init_cache_batched``, ``[L, B, H, n_ctx, Dh]``) or paged
(``init_cache_paged``, a page pool and a page table), the slot admission
path ``forward(..., slot=)`` and ``forward_batched``: one decode step for B
slots, whose matmuls reach the multi-row Q4_0 kernel and whose attention
reaches the batched or paged flash-decode kernel.

Fused params (``cfg.fuse_layer_matmuls``) hold ``wqkv`` (the out-dim concat
of wq, wk, wv) and ``w13`` (w1, w3) in place of their parts: one product
each, so a token, step or chunk makes 4·L + 1 matmul launches instead of
7·L + 1.  On fused Q4_0 params, batch-1 decode (one token, no slot, no
int8 scales, quantized activations, 128-dim heads: the JAX package's
conditions) runs every layer in one launch of the whole-stack kernel
(``ops/fused_layer.fused_layers_block``); the output projection after it
stays on the matvec.  Fused Q4_1 params decode on the composed path, as in
the JAX package.

T-layout params (``params_from_tensors(q4_layout="t")``, the card's default
when ``shard_pad > 1``: the tensor-parallel builds of ``parallel/tp.py``)
hold :class:`~..ops.q4_matmul.Q4_0WeightT`: every product of 1–64 rows
takes the T kernel (``ops/q4_matmul.q4_0_matmul_t``), prefill bucket and
decode alike, and the whole-stack kernel is never taken.

Every cache may be f32, bf16 or int8.  An int8 cache holds symmetric codes
and one f32 scale per (head, position) row, written by :func:`quantize_kv`
(the JAX formula, round half to even); prefill and the plain attention read
it back as ``codes·scale``.  Decode reaches the int8 flash kernel of its
mode: batch 1 (``init_cache``) → ``flash_decode_attention_stacked_int8``,
dense batched → ``flash_decode_attention_batched_int8``, paged →
``flash_decode_attention_paged_int8``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..config import QK, ModelConfig
from ..formats.ggml import GGMLModelFile, expected_tensor_shapes
from ..formats.quant import Q4_0Tensor, Q4_1Tensor
from ..ops import quantized_matmul as qmm
from ..ops.attention import (
    flash_decode_attention,
    flash_decode_attention_batched,
    flash_decode_attention_batched_int8,
    flash_decode_attention_paged,
    flash_decode_attention_paged_int8,
    flash_decode_attention_stacked_int8,
    gather_pages,
    reference_decode_attention_batched,
)
from ..ops.fused_layer import fused_layers_block
from ..ops.norms import norm
from ..ops.q4_matmul import Q4_0WeightT, from_jax_t, from_jax_w, unpack_qs_v
from ..ops.q4_matvec import Q4_0Weight, Q4_1Weight
from ..ops.rope import rope

Cache = dict


class Params(dict):
    """The model's weights by name (``tok_embeddings``, ``norm``, ``output``,
    ``layers_stacked``), and how the builder laid them out: ``shard_pad``
    and ``fuse_shards`` (:func:`params_from_tensors`); ``mesh`` once
    ``parallel/tp.shard_params_tp`` has kept one rank's shard."""

    def __init__(self, *args, shard_pad: int = 1, fuse_shards: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.shard_pad, self.fuse_shards = shard_pad, fuse_shards

LAYER_WEIGHTS = (
    "attention_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w1", "w2", "w3",
)

#: the fused out-dim concats of ``cfg.fuse_layer_matmuls``: each fused
#: weight's parts, in row order (exact: each Q4 block scale belongs to one
#: source row)
FUSED = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3")}
FUSED_LAYER_WEIGHTS = ("attention_norm", "wqkv", "wo", "ffn_norm", "w13", "w2")

#: the packed weight types: dataclasses of tensors with ``.layer(il)``
#: (:class:`Q4_0WeightT` is a :class:`Q4_0Weight`)
Q4_WEIGHTS = (Q4_0Weight, Q4_1Weight)

#: prefill contexts at/above this use the chunked online-softmax attention
#: (peak score memory [H, N, chunk] instead of [H, N, n_ctx])
FLASH_PREFILL_MIN_CTX = 1024


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another device (``"cpu"`` in the tests); no silent fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _loader_name(il: int, w: str) -> str:
    if w in ("wq", "wk", "wv", "wo"):
        return f"layers.{il}.attention.{w}.weight"
    if w in ("w1", "w2", "w3"):
        return f"layers.{il}.feed_forward.{w}.weight"
    return f"layers.{il}.{w}.weight"


def _to_device(a, device, dense_dtype):
    """One loader tensor → the port's device form (Q4_0 and Q4_1 stay packed)."""
    if isinstance(a, Q4_0Tensor):
        return Q4_0Weight.from_q4_0(a, device)
    if isinstance(a, Q4_1Tensor):
        return Q4_1Weight.from_q4_1(a, device)
    a = np.asarray(a)
    dtype = torch.float32 if a.ndim == 1 else dense_dtype
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device, dtype)


#: ``q4_layout`` values: ``"t"`` (:class:`Q4_0WeightT`), or ``"v"``, the
#: port's one logical Q4_0 layout, which stands for the JAX package's V and
#: W layouts alike
Q4_LAYOUTS = ("t", "v")


def params_from_tensors(
    tensors: dict,
    cfg: ModelConfig,
    *,
    device=None,
    param_dtype: Optional[torch.dtype] = None,
    q4_layout: Optional[str] = None,
    shard_pad: int = 1,
    fuse_shards: int = 1,
) -> Params:
    """Arrange loader output (``formats/ggml.py``) into the model's params.

    Q4_0 and Q4_1 tensors stay packed (:class:`Q4_0Weight`,
    :class:`Q4_1Weight`); dense f16/f32 weights
    become ``param_dtype`` (default f32 on the CPU, bf16 on the card — the
    JAX package's choice off and on the TPU); norms are always f32.  Layer
    weights are stacked ``[L, ...]`` in ``params["layers_stacked"]``,
    filled layer by layer on the device (no host-side stack).  With
    ``cfg.fuse_layer_matmuls`` the layers hold ``wqkv`` and ``w13`` (see
    :data:`FUSED`) instead of their parts.

    The JAX package's layout arguments (``llama_swift_tpu/models/llama.py:
    55-140, 208-275``), with its defaults and rules:

    * ``q4_layout="t"`` makes every Q4_0 weight
      whose out dim is a multiple of 128 a :class:`Q4_0WeightT`, whose
      products of 1–64 rows take the T kernel (the tensor-parallel path).
      Left unset, the card takes ``"t"`` when ``shard_pad > 1``, as the TPU
      does; otherwise ``"v"``, the port's logical layout (:data:`Q4_LAYOUTS`).
    * ``shard_pad`` zero-pads the FFN hidden dim (w1/w3 rows, w2 columns)
      and the vocab (``tok_embeddings`` and ``output`` rows) to a multiple
      of itself, so that a row split gives every rank the same share; zero
      blocks are exact, and ``forward`` slices the logits to ``n_vocab``.
    * ``fuse_shards`` interleaves the fused concats per tensor-parallel
      shard: rank r's rows are (q_r; k_r; v_r) and (w1_r; w3_r), so a
      contiguous row split hands each rank its own fused matrices
      (``parallel/tp.py`` checks it against the TP degree).

    ``params.shard_pad`` and ``params.fuse_shards`` record the last two.
    """
    device = resolve_device(device)
    if param_dtype is None:
        param_dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if q4_layout is None:
        q4_layout = "t" if device.type == "cuda" and shard_pad > 1 else "v"
    if q4_layout not in Q4_LAYOUTS:
        raise ValueError(f"params_from_tensors: q4_layout {q4_layout!r} is not one of {Q4_LAYOUTS}")
    t_layout = q4_layout == "t"
    ff_pad, vocab_pad = (-(-n // shard_pad) * shard_pad for n in (cfg.n_ff, cfg.n_vocab))
    cvt = functools.partial(_to_device, device=device, dense_dtype=param_dtype)
    stacked: dict = {}
    names = FUSED_LAYER_WEIGHTS if cfg.fuse_layer_matmuls else LAYER_WEIGHTS
    for il in range(cfg.n_layer):
        for w in names:
            t = _as_layout(_layer_tensor(tensors, il, w, param_dtype, ff_pad, fuse_shards), t_layout)
            if w not in stacked:
                stacked[w] = _empty_stack(t, cfg.n_layer, device)
            for a, b in zip(_fields(_stack_at(stacked[w], il)), _fields(t)):
                a.copy_(b)
    return Params({
        "tok_embeddings": _as_layout(_pad(cvt(tensors["tok_embeddings.weight"]), out_to=vocab_pad), t_layout),
        "norm": cvt(tensors["norm.weight"]),
        "output": _as_layout(_pad(cvt(tensors["output.weight"]), out_to=vocab_pad), t_layout),
        "layers_stacked": stacked,
    }, shard_pad=shard_pad, fuse_shards=fuse_shards)


def _layer_tensor(tensors: dict, il: int, name: str, param_dtype, ff_pad: int, fuse_shards: int):
    """Layer ``il``'s weight ``name`` on the CPU, its FFN hidden dim padded
    to ``ff_pad``; a fused name is the out-dim concat of its parts,
    interleaved per shard when ``fuse_shards > 1`` (the JAX package's
    ``_concat_out_sharded``)."""
    parts = [_pad(_to_device(tensors[_loader_name(il, w)], "cpu", param_dtype),
                  out_to=ff_pad if w in ("w1", "w3") else None, in_to=ff_pad if w == "w2" else None)
             for w in FUSED.get(name, (name,))]
    if len(parts) == 1:
        return parts[0]
    rows = parts[0].shape[0]
    if rows % fuse_shards:
        raise ValueError(f"params_from_tensors: {rows} rows of {name} do not split into {fuse_shards} shards")
    per = rows // fuse_shards
    fields = [
        torch.cat([f[r * per : (r + 1) * per] for r in range(fuse_shards) for f in part_fields])
        for part_fields in zip(*map(_fields, parts))
    ]
    return type(parts[0])(*fields) if isinstance(parts[0], Q4_WEIGHTS) else fields[0]


def _pad(t, out_to: Optional[int] = None, in_to: Optional[int] = None):
    """Zero rows up to ``out_to`` and zero columns up to ``in_to`` of a
    weight ``[out, in]`` (packed: whole zero blocks, which decode to exact
    zeros; the JAX package's ``_pad_weight``)."""
    if out_to is None and in_to is None:
        return t
    rows, cols = t.shape
    ro, co = (out_to or rows) - rows, (in_to or cols) - cols
    if not ro and not co:
        return t

    def pad(f):  # f [rows, cols·k, ...]: widths from the last axis back
        return torch.nn.functional.pad(f, [0, 0] * (f.dim() - 2) + [0, co * f.shape[1] // cols, 0, ro])

    return type(t)(*map(pad, _fields(t))) if isinstance(t, Q4_WEIGHTS) else pad(t)


def _as_layout(t, t_layout: bool):
    """``t`` as a :class:`Q4_0WeightT` when the T layout is asked and it is
    a Q4_0 weight whose out dim is a multiple of 128 (the JAX package's
    condition for tiling); otherwise ``t``."""
    if t_layout and type(t) is Q4_0Weight and t.shape[0] % 128 == 0:
        return Q4_0WeightT(t.qs, t.d)
    return t


def _fields(t) -> tuple:
    """The tensors of a packed weight (a dense tensor is its own one)."""
    return tuple(getattr(t, f.name) for f in dataclasses.fields(t)) if isinstance(t, Q4_WEIGHTS) else (t,)


def _empty_stack(t, n_layer: int, device):
    if isinstance(t, Q4_WEIGHTS):
        return type(t)(*(_empty_stack(f, n_layer, device) for f in _fields(t)))
    return torch.empty((n_layer,) + tuple(t.shape), dtype=t.dtype, device=device)


def _stack_at(stack, il: int):
    return stack.layer(il) if isinstance(stack, Q4_WEIGHTS) else stack[il]


def params_from_file(model: GGMLModelFile, *, device=None, param_dtype=None) -> Params:
    return params_from_tensors(model.tensors, model.config, device=device, param_dtype=param_dtype)


def params_from_jax_numpy(tree: dict, cfg: ModelConfig, *, device=None, shard_pad: int = 1,
                          fuse_shards: int = 1) -> Params:
    """Carry JAX params across: ``tree`` is the JAX package's stacked params
    pytree after ``jax.tree_util.tree_map(np.asarray, ...)``.

    Q4 containers are recognised by their field names, without importing
    the JAX classes.  Q4_0: ``qs4v``/``scales_v`` (V layout: unpacked to
    logical order, the 4096 in-dim zero padding dropped), ``qs4w``/
    ``scales_w`` (W layout of the fused-layer kernels: the V geometry with
    blocks permuted by λ, carried by :func:`~..ops.q4_matmul.from_jax_w`,
    which undoes λ and drops the padding) or ``qs``/``scales`` (logical).  Q4_1:
    ``qs4v``/``sm_v`` (V layout; delta lanes ``[0, nb)``, min lanes
    ``[nb, 2nb)``; the padding dropped) or ``qs``/``scales``/``mins``
    (logical).  T layout (``qs4``/``scales_t``, stacked or not): unpacked by
    :func:`~..ops.q4_matmul.from_jax_t`, the in-dim padding dropped, and
    kept a :class:`Q4_0WeightT`.  Fused ``wqkv``/``w13`` stay fused.  Dense
    leaves become f32 tensors.

    Padding of the FFN hidden dim and the vocab is kept up to a multiple of
    ``shard_pad`` and dropped beyond, so that the JAX package's
    ``params_from_tensors(shard_pad=s, fuse_shards=f)`` comes across as the
    port's own with the same two arguments (which are recorded as there).
    Shard-interleaved fused rows (``fuse_shards > 1``) are kept as they are.
    """
    device = resolve_device(device)
    if "layers_stacked" not in tree:
        raise ValueError("params_from_jax_numpy: expected stacked JAX params (layers_stacked)")
    n_ff, n_vocab = (-(-n // shard_pad) * shard_pad for n in (cfg.n_ff, cfg.n_vocab))
    in_dims = {"w2": n_ff}

    def out_rows(name: str, n_out: int):
        """Rows to keep of a weight with ``n_out`` rows (None: all)."""
        if name in ("tok_embeddings", "output"):
            return np.arange(n_vocab)
        if name in ("w1", "w3"):
            return np.arange(n_ff)
        if name == "w13" and fuse_shards > 1:
            if n_out != 2 * n_ff:
                raise ValueError(f"params_from_jax_numpy: w13 has {n_out} rows, {2 * n_ff} expected")
            return None
        if name == "w13":  # halves w1; w3, each possibly padded
            return np.r_[0:n_ff, n_out // 2 : n_out // 2 + n_ff]
        return None

    def cvt(a, name: str, in_dim: int):
        cls = Q4_0Weight
        if hasattr(a, "sm_v"):  # Q4_1 V layout; sc becomes [..., out, in/32, (d, m)]
            qs, sm = unpack_qs_v(a.qs4v), np.asarray(a.sm_v, dtype=np.float32)
            sm = sm.reshape(*sm.shape[:-3], -1, sm.shape[-1])  # [..., out, 2·in_pad/32]
            nb = sm.shape[-1] // 2
            sc = np.stack([sm[..., :nb], sm[..., nb:]], axis=-1)
            qs, sc, cls = qs[..., : in_dim // 2], sc[..., : in_dim // QK, :], Q4_1Weight
        elif hasattr(a, "qs4v"):
            qs = unpack_qs_v(a.qs4v)  # [..., out, in_pad/2]
            sc = np.asarray(a.scales_v, dtype=np.float32)
            sc = sc.reshape(*sc.shape[:-3], -1, sc.shape[-1])  # [..., out, in_pad/32]
            qs, sc = qs[..., : in_dim // 2], sc[..., : in_dim // QK]
        elif hasattr(a, "qs4w"):  # W layout: λ undone, the padding dropped
            t = from_jax_w(a.qs4w, a.scales_w, in_dim)
            qs, sc = t.qs.numpy(), t.d.numpy()
        elif hasattr(a, "mins"):  # logical Q4_1
            qs, cls = np.asarray(a.qs), Q4_1Weight
            sc = np.stack([np.asarray(a.scales, dtype=np.float32), np.asarray(a.mins, dtype=np.float32)], axis=-1)
        elif hasattr(a, "qs") and hasattr(a, "scales"):
            qs, sc = np.asarray(a.qs), np.asarray(a.scales, dtype=np.float32)
        elif hasattr(a, "qs4"):  # T layout [..., out/128, in_pad/8, 128]
            t = from_jax_t(a.qs4, a.scales_t, in_dim, np.shape(a.qs4)[-3] * 128)
            qs, sc, cls = t.qs.numpy(), t.d.numpy(), Q4_0WeightT
        else:
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        rows = out_rows(name, qs.shape[-2])
        if rows is not None:  # the out axis: qs's second to last, in sc too
            qs, sc = np.take(qs, rows, axis=qs.ndim - 2), np.take(sc, rows, axis=qs.ndim - 2)
        return cls(
            torch.from_numpy(np.ascontiguousarray(qs, dtype=np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(sc, dtype=np.float32)).to(device),
        )

    return Params({
        "tok_embeddings": cvt(tree["tok_embeddings"], "tok_embeddings", cfg.n_embd),
        "norm": cvt(tree["norm"], "norm", cfg.n_embd),
        "output": cvt(tree["output"], "output", cfg.n_embd),
        "layers_stacked": {
            k: cvt(v, k, in_dims.get(k, cfg.n_embd)) for k, v in tree["layers_stacked"].items()
        },
    }, shard_pad=shard_pad, fuse_shards=fuse_shards)


def random_params(
    cfg: ModelConfig, seed: int = 0, scale: float = 0.05, dtype=np.float32
) -> dict:
    """Random numpy weights in loader-tensor naming, for tests/fixtures."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in expected_tensor_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = (1.0 + scale * rng.standard_normal(shape)).astype(np.float32)
        else:
            out[name] = (scale * rng.standard_normal(shape)).astype(dtype)
    return out


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def _cache_dtype(cfg: ModelConfig, dtype):
    if dtype is not None:
        return dtype
    return torch.int8 if cfg.kv_cache_dtype == "int8" else getattr(torch, cfg.kv_cache_dtype)


def _kv_planes(shape, dtype, device, suffix: str = "") -> Cache:
    """K and V buffers of ``shape``; an int8 cache adds f32 scales of
    ``shape[:-1] + (1,)``, one per (head, position) row (``k_scale`` or,
    with ``suffix="_pool"``, ``k_scale_pool``)."""
    cache = {
        "k" + suffix: torch.zeros(shape, dtype=dtype, device=device),
        "v" + suffix: torch.zeros(shape, dtype=dtype, device=device),
    }
    if dtype == torch.int8:
        for name in ("k", "v"):
            cache[name + "_scale" + suffix] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)
    return cache


def init_cache(cfg: ModelConfig, dtype=None, *, device=None) -> Cache:
    """Dense KV cache ``[L, H, n_ctx, Dh]`` (head-major: each head's history
    contiguous; keys stored post-rope), f32, bf16 or int8 (int8 when
    ``dtype=torch.int8`` or ``cfg.kv_cache_dtype == "int8"``: then also
    ``k_scale``/``v_scale`` ``[L, H, n_ctx, 1]`` f32).  ``forward`` writes it
    in place at ``(il, :, n_past, :)``."""
    shape = (cfg.n_layer, cfg.n_head, cfg.n_ctx, cfg.head_dim)
    return _kv_planes(shape, _cache_dtype(cfg, dtype), resolve_device(device))


def init_cache_batched(cfg: ModelConfig, batch: int, dtype=None, *, device=None) -> Cache:
    """Layer-major batched KV cache ``[L, B, H, n_ctx, Dh]`` for
    :func:`forward_batched` and the slot path of :func:`forward`: layer
    ``il``'s planes of all slots are one contiguous ``[B, H, n_ctx, Dh]``
    block, which the batched flash kernel reads in place.  An int8 cache
    adds ``k_scale``/``v_scale`` ``[L, B, H, n_ctx, 1]`` f32."""
    shape = (cfg.n_layer, batch, cfg.n_head, cfg.n_ctx, cfg.head_dim)
    return _kv_planes(shape, _cache_dtype(cfg, dtype), resolve_device(device))


def init_cache_paged(
    cfg: ModelConfig, n_pages: int, max_slots: int, dtype=None, page: int = 128, *, device=None,
) -> Cache:
    """Paged batched KV cache: a pool ``[n_pages, L, H, page, Dh]`` of
    position-range pages, each holding one slot's ``page`` positions across
    all layers, and a table ``[max_slots, MP]`` int32 of page ids
    (``MP = ceil(n_ctx / page)``).  A slot's footprint grows with its
    sequence instead of a dense ``n_ctx`` plane.

    The LAST page is scratch: every table entry points at it until the
    engine allocates, so writes from idle slots (a step computes all B
    lanes) land there instead of on a live page.

    An int8 pool adds ``k_scale_pool``/``v_scale_pool`` ``[n_pages, L, H,
    page, 1]`` f32, addressed by the same page ids."""
    page = min(page, cfg.n_ctx)
    mp = -(-cfg.n_ctx // page)
    shape = (n_pages, cfg.n_layer, cfg.n_head, page, cfg.head_dim)
    device = resolve_device(device)
    cache = _kv_planes(shape, _cache_dtype(cfg, dtype), device, suffix="_pool")
    cache["page_table"] = torch.full((max_slots, mp), n_pages - 1, dtype=torch.int32, device=device)
    return cache


def quantize_kv(val: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 cache write of the JAX package (``cache_write*`` in
    ``llama_swift_tpu/models/llama.py``): symmetric codes per row of the last
    axis, ``scale = amax/127``, ``q = clip(round(v·inv), -127, 127)`` with
    ``inv = 1/scale`` (0 for an all-zero row).  ``torch.round`` rounds half
    to even, as ``jnp.round`` does.  Returns (int8 codes, f32 scales
    ``[..., 1]``)."""
    v = val.float()
    amax = v.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)  # true division on CUDA too (see ops/q4_matvec)
    live = scale > 0
    inv = torch.where(live, 1.0 / torch.where(live, scale, torch.ones_like(scale)), torch.zeros_like(scale))
    return torch.round(v * inv).clamp(-127, 127).to(torch.int8), scale


def _store(buf, scale, index, val) -> None:
    """``buf[index] = val``; for an int8 cache (``scale`` given) the codes go
    to ``buf[index]`` and the row scales to ``scale[index]``, so both take
    the same positions (idle lanes included)."""
    if scale is None:
        buf[index] = val.to(buf.dtype)
    else:
        q, s = quantize_kv(val)
        buf[index] = q
        scale[index] = s


def _layer_plane(buf, scale, il: int, table=None, n_keys: int = 0):
    """Layer ``il`` of a cache for the plain attention: the dense plane, or
    with ``table [MP]`` the slot's first ``n_keys`` positions gathered from
    the pool.  An int8 cache reads back as ``codes·scale`` f32 (the JAX
    package's ``cache_read*``); a float cache as it is."""
    if table is None:
        codes, s = buf[il], None if scale is None else scale[il]
    else:
        codes = gather_pages(buf, table[None], il, n_keys)[0]
        s = None if scale is None else gather_pages(scale, table[None], il, n_keys)[0]
    return codes if s is None else codes.float() * s


def _paged_write(pool, scale_pool, table, il: int, positions, val) -> None:
    """Store ``val [N, H, Dh]`` at ``positions [N]`` (device int64) of layer
    ``il`` through one table row ``table [MP]``: per-position page ids, so
    a chunk may start at any position and straddle pages (the JAX package's
    single-write fast path assumes an aligned start).  An int8 pool's scales
    go to ``scale_pool`` at the same page ids."""
    page = pool.shape[3]
    pids = table[positions // page].long().clamp(0, pool.shape[0] - 1)
    _store(pool.select(1, il), None if scale_pool is None else scale_pool.select(1, il),
           (pids, slice(None), positions % page), val)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention_chunked(q, keys, values, n_past: int, n_ctx: int, compute_dtype, chunk: int = 512):
    """Online-softmax prefill attention over key chunks, so peak score
    memory is ``[H, N, chunk]`` (counterpart of ``_attention_flash_xla``).
    Same mask as :func:`_attention`, softmax reassociated."""
    N, d = q.shape[0], q.shape[-1]
    H = keys.shape[0]
    scale = 1.0 / np.sqrt(float(d))
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


def _attention(q, keys, values, n_past: int, n_ctx: int, compute_dtype):
    """Causal attention over the full cache buffer: q ``[N, H, Dh]``,
    keys/values ``[H, n_ctx, Dh]``; query i attends keys ``j <= n_past + i``
    (``ggml_diag_mask_inf``, ``ggml.c:6921-6981``), so stale slots beyond
    the high-water mark are never attended."""
    if n_ctx >= FLASH_PREFILL_MIN_CTX and n_ctx % 512 == 0:
        return _attention_chunked(q, keys, values, n_past, n_ctx, compute_dtype)
    N, d = q.shape[0], q.shape[-1]
    scale = 1.0 / np.sqrt(float(d))
    scores = torch.einsum("nhd,hjd->hnj", q.float(), keys.float()) * scale
    i_idx = torch.arange(N, device=q.device)[:, None]
    j_idx = torch.arange(n_ctx, device=q.device)[None, :]
    scores = torch.where((j_idx <= n_past + i_idx)[None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hnj,hjd->nhd", p, values.float()).to(compute_dtype)


def _layer_at(stacked: dict, il: int) -> dict:
    return {k: _stack_at(v, il) for k, v in stacked.items()}


def _qkv(h, layer: dict, lin, N: int, H: int, Dh: int):
    """q, k, v ``[N, H, Dh]``: one product over fused ``wqkv`` split by
    ``n_embd``, or three over wq, wk, wv."""
    if "wqkv" in layer:
        qkv = lin(h, layer["wqkv"])
        D = H * Dh
        return tuple(qkv[:, i * D : (i + 1) * D].reshape(N, H, Dh) for i in range(3))
    return tuple(lin(h, layer[w]).reshape(N, H, Dh) for w in ("wq", "wk", "wv"))


def _takes_megakernel(stacked: dict, N: int, slot, cache: Cache, cfg: ModelConfig) -> bool:
    """The JAX package's conditions for the whole-stack kernel
    (``llama_swift_tpu/models/llama.py:899-906``): fused Q4_0 params (its
    ``Q4_0TensorW``: fused Q4_1 and T-layout params stay composed), one
    token, no slot, no int8 scales, quantized activations, 128-dim heads."""
    return (type(stacked.get("wqkv")) is Q4_0Weight and N == 1 and slot is None and "k" in cache
            and "k_scale" not in cache and cfg.quantize_activations and cfg.head_dim == 128)


def forward(
    params: Params,
    tokens: torch.Tensor,  # [N] int64 on the params' device (may include right-padding)
    n_past: int,  # tokens already in the cache
    cache: Cache,
    cfg: ModelConfig,
    slot: Optional[int] = None,
) -> tuple[torch.Tensor, Cache]:
    """One evaluation over N token slots starting at position ``n_past``.

    Returns (logits ``[N, n_vocab]`` f32, cache).  The cache is updated in
    place: the JAX package's functional ``dynamic_update_slice`` at
    ``(il, :, n_past, :)`` (``models/llama.py:697-722`` there) becomes a
    slice assignment into the preallocated buffer.

    ``slot``: the engine's admission path.  ``cache`` is then a batched
    cache (:func:`init_cache_batched` or :func:`init_cache_paged`) and only
    slot ``slot``'s positions are written and read: the dense planes at
    ``(il, slot)``, or the slot's pages through its table row (attention
    then runs over the slot's pages gathered into a dense ``[H, n_ctx, Dh]``).
    An int8 cache's scales are written and read at the same positions.
    """
    compute_dtype = getattr(torch, cfg.compute_dtype)
    N = tokens.shape[0]
    if n_past + N > cfg.n_ctx:
        raise ValueError(f"forward: {N} tokens at n_past={n_past} overflow n_ctx={cfg.n_ctx}")
    lin = functools.partial(
        qmm.linear,
        quantize_activations=cfg.quantize_activations,
        compute_dtype=compute_dtype,
        dense_matmul_dtype=torch.bfloat16 if (cfg.prefill_bf16 and N > 1) else None,
    )
    H, Dh = cfg.n_head, cfg.head_dim
    positions = torch.arange(n_past, n_past + N, device=tokens.device)
    x = qmm.embedding_lookup(tokens, params["tok_embeddings"], compute_dtype=compute_dtype)
    paged = "page_table" in cache
    if paged:
        k_cache, v_cache, table = cache["k_pool"], cache["v_pool"], cache["page_table"][slot]
        k_scale, v_scale = cache.get("k_scale_pool"), cache.get("v_scale_pool")
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
        if slot is not None:  # [L, H, n_ctx, Dh] (scales [..., 1]) views of the slot
            k_cache, v_cache = k_cache[:, slot], v_cache[:, slot]
            if k_scale is not None:
                k_scale, v_scale = k_scale[:, slot], v_scale[:, slot]
    use_flash = cfg.use_flash_decode and N == 1 and slot is None
    stacked = params["layers_stacked"]
    if _takes_megakernel(stacked, N, slot, cache, cfg):
        x = fused_layers_block(
            x.reshape(cfg.n_embd).float().contiguous(), stacked["attention_norm"], stacked["ffn_norm"],
            stacked["wqkv"], stacked["wo"], stacked["w13"], stacked["w2"], k_cache, v_cache, n_past,
            norm_type=cfg.norm_type, eps=cfg.norm_eps)
        x = norm(x[None].to(compute_dtype), params["norm"], cfg.norm_type, cfg.norm_eps)
        return lin(x, params["output"]).float()[:, : cfg.n_vocab], cache
    for il in range(cfg.n_layer):
        layer = _layer_at(stacked, il)
        h = norm(x, layer["attention_norm"], cfg.norm_type, cfg.norm_eps)
        q, k, v = _qkv(h, layer, lin, N, H, Dh)
        # rope over the full head dim (eval recomputes n_rot = n_embd/n_head,
        # .mm:528, ignoring the file's n_rot field)
        q = rope(q, positions, Dh)
        k = rope(k, positions, Dh)
        # the write comes first: prefill attends the cache as stored (int8:
        # dequantized), as the JAX package's cache_read does
        if paged:
            _paged_write(k_cache, k_scale, table, il, positions, k)
            _paged_write(v_cache, v_scale, table, il, positions, v)
        else:
            rows = (il, slice(None), slice(n_past, n_past + N))
            _store(k_cache, k_scale, rows, k.transpose(0, 1))
            _store(v_cache, v_scale, rows, v.transpose(0, 1))
        if use_flash and k_scale is not None:
            ctx = flash_decode_attention_stacked_int8(
                q[0].float().contiguous(), k_cache, v_cache, k_scale, v_scale, il, n_past)
            ctx = ctx[None].to(compute_dtype)
        elif use_flash:
            ctx = flash_decode_attention(q[0].float().contiguous(), k_cache, v_cache, il, n_past)
            ctx = ctx[None].to(compute_dtype)
        else:
            tab = table if paged else None
            keys = _layer_plane(k_cache, k_scale, il, tab, cfg.n_ctx)
            values = _layer_plane(v_cache, v_scale, il, tab, cfg.n_ctx)
            ctx = _attention(q, keys, values, n_past, cfg.n_ctx, compute_dtype)
        x = x + lin(ctx.reshape(N, cfg.n_embd), layer["wo"])
        x = _ffn(x, layer, lin, cfg, compute_dtype)
    x = norm(x, params["norm"], cfg.norm_type, cfg.norm_eps)
    logits = lin(x, params["output"]).float()
    return logits[:, : cfg.n_vocab], cache


def _ffn(x, layer, lin, cfg: ModelConfig, compute_dtype):
    """Feed-forward block with its residual: silu(w1·h) * (w3·h) → w2
    (``.mm:658-684``); fused ``w13`` is one product split in halves."""
    h = norm(x, layer["ffn_norm"], cfg.norm_type, cfg.norm_eps)
    if "w13" in layer:
        g1, g3 = lin(h, layer["w13"]).chunk(2, dim=-1)
    else:
        g1 = lin(h, layer["w1"])
        g3 = lin(h, layer["w3"])
    gate = torch.nn.functional.silu(g1.float()).to(compute_dtype)
    return x + lin(gate * g3, layer["w2"])


# ---------------------------------------------------------------------------
# Batched decode (continuous batching: one weight stream for all slots)
# ---------------------------------------------------------------------------


def forward_batched(
    params: Params,
    tokens: torch.Tensor,  # [B] int64 on the params' device, one pending token per slot
    n_pasts,  # [B] host ints (list, numpy array or CPU tensor): per-slot positions
    cache: Cache,  # init_cache_batched or init_cache_paged
    cfg: ModelConfig,
) -> tuple[torch.Tensor, Cache]:
    """One decode step for B slots sharing the weights.

    Every matmul sees all B rows at once (the multi-row Q4_0 kernel for
    B ≤ 32; Q4_1 weights are dequantized, as in the JAX package), so the
    packed weights cross device memory once per step whatever the
    occupancy.  Slot b's new K/V land at position
    ``n_pasts[b]`` (dense: ``k[il, b, :, n_pasts[b]]``; paged: through its
    table row), then attention reads each slot's keys ``j <= n_pasts[b]``:
    the batched flash kernel over the dense cache, the paged one over the
    pool, or the plain masked softmax when ``cfg.use_flash_decode`` is off
    (dense cache only).  An int8 cache stores codes and row scales
    (:func:`quantize_kv`) and reaches the int8 variants of those kernels.
    ``n_pasts`` stay host values so that the kernels' grid needs no read
    back from the card.

    Returns (logits ``[B, n_vocab]`` f32, cache), the cache updated in place.
    """
    compute_dtype = getattr(torch, cfg.compute_dtype)
    host = np.asarray(n_pasts, dtype=np.int64).reshape(-1)
    B = tokens.shape[0]
    if host.shape != (B,) or host.min() < 0 or host.max() >= cfg.n_ctx:
        raise ValueError(f"forward_batched: n_pasts {host.tolist()} must be {B} positions in [0, {cfg.n_ctx})")
    max_n_past = int(host.max())
    dev = tokens.device
    pos = torch.as_tensor(host, device=dev)  # [B] int64: rope, writes, plain attention
    pos32 = pos.to(torch.int32)  # the kernels' per-slot positions
    lin = functools.partial(
        qmm.linear, quantize_activations=cfg.quantize_activations, compute_dtype=compute_dtype,
    )
    H, Dh = cfg.n_head, cfg.head_dim
    paged = "page_table" in cache
    if paged:
        k_cache, v_cache, table = cache["k_pool"], cache["v_pool"], cache["page_table"]
        k_scale, v_scale = cache.get("k_scale_pool"), cache.get("v_scale_pool")
        page = k_cache.shape[3]
        pids = table[torch.arange(B, device=dev), pos // page].long().clamp(0, k_cache.shape[0] - 1)
        offs = pos % page
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
        slots = torch.arange(B, device=dev)
    int8 = k_scale is not None
    x = qmm.embedding_lookup(tokens, params["tok_embeddings"], compute_dtype=compute_dtype)
    stacked = params["layers_stacked"]
    for il in range(cfg.n_layer):
        layer = _layer_at(stacked, il)
        h = norm(x, layer["attention_norm"], cfg.norm_type, cfg.norm_eps)
        q, k, v = _qkv(h, layer, lin, B, H, Dh)
        # rope treats the slot axis as the position axis: slot b rotates at
        # its own n_pasts[b]
        q = rope(q, pos, Dh)
        k = rope(k, pos, Dh)
        qf = q.float().contiguous()
        if paged:
            rows = (pids, slice(None), offs)
            _store(k_cache.select(1, il), k_scale.select(1, il) if int8 else None, rows, k)
            _store(v_cache.select(1, il), v_scale.select(1, il) if int8 else None, rows, v)
            if int8:
                ctx = flash_decode_attention_paged_int8(
                    qf, k_cache, v_cache, k_scale, v_scale, table, il, pos32, max_n_past)
            else:
                ctx = flash_decode_attention_paged(qf, k_cache, v_cache, table, il, pos32, max_n_past)
        else:
            rows = (il, slots, slice(None), pos)
            _store(k_cache, k_scale, rows, k)
            _store(v_cache, v_scale, rows, v)
            if cfg.use_flash_decode and int8:
                ctx = flash_decode_attention_batched_int8(
                    qf, k_cache, v_cache, k_scale, v_scale, il, pos32, max_n_past)
            elif cfg.use_flash_decode:
                ctx = flash_decode_attention_batched(qf, k_cache, v_cache, il, pos32, max_n_past)
            else:
                ctx = reference_decode_attention_batched(
                    q, _layer_plane(k_cache, k_scale, il), _layer_plane(v_cache, v_scale, il), pos)
        x = x + lin(ctx.to(compute_dtype).reshape(B, cfg.n_embd), layer["wo"])
        x = _ffn(x, layer, lin, cfg, compute_dtype)
    x = norm(x, params["norm"], cfg.norm_type, cfg.norm_eps)
    logits = lin(x, params["output"]).float()
    return logits[:, : cfg.n_vocab], cache


def prefill(params, tokens, n_past: int, cache, cfg: ModelConfig):
    """Process a (padded) prompt chunk; returns (all logits, cache)."""
    return forward(params, tokens, n_past, cache, cfg)


def decode_step(params, token, n_past: int, cache, cfg: ModelConfig):
    """Single-token decode; ``token`` is a 0-d int64 tensor.  Returns
    (logits ``[n_vocab]``, cache)."""
    logits, cache = forward(params, token.reshape(1), n_past, cache, cfg)
    return logits[0], cache


def greedy_decode_loop(params, first_token, n_past: int, cache, cfg: ModelConfig, n_steps: int):
    """``n_steps`` of greedy decode; tokens stay on the device between
    steps (no host read until the caller asks).  Returns (token ids
    ``[n_steps]``, cache)."""
    token = first_token.reshape(1)
    toks = []
    for i in range(n_steps):
        logits, cache = forward(params, token, n_past + i, cache, cfg)
        token = logits[0].argmax().reshape(1)
        toks.append(token)
    return torch.cat(toks), cache


def pad_tokens(ids: list[int], multiple: int) -> tuple[np.ndarray, int]:
    """Right-pad a token list to a shape bucket (pad id 0); returns
    (padded ``[P]`` int32, true length)."""
    n = len(ids)
    p = max(multiple, ((n + multiple - 1) // multiple) * multiple)
    out = np.zeros(p, dtype=np.int32)
    out[:n] = ids
    return out, n
