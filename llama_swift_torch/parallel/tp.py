"""Tensor-parallel forward (counterpart of ``llama_swift_tpu/parallel/tp.py``).

Every rank runs the same program on its own shard of every weight: the
products are the port's ``linear`` (so the shards reach the same kernels as
a single device: on the T layout, the T kernel for every product of 1–64
rows), and the collectives are explicit ``torch.distributed`` calls, as the
JAX package's ``shard_map`` body calls ``jax.lax.all_gather``.

Sharding (the JAX package's, ``tp.py:10-31`` there; as data in
``sharding.tp_param_specs``):

* every 2-D weight is out-sharded (row-parallel): for wq/wk/wv/w1/w3/output
  the file's split_type 1; wo and w2 are out-sharded too, and their
  outputs all-gathered, so each rank holds whole rows;
* 128-dim heads shard evenly (n_head % tp == 0); the KV cache is
  head-sharded, ``[L, H/tp, n_ctx, Dh]`` a rank, and attention is local;
* ``tok_embeddings`` is vocab-sharded: a masked local lookup, then an
  all-reduce;
* the logits come back vocab-sharded and are all-gathered;
* norms are replicated.

Communication a layer: four all-gathers tiled on the last axis (ctx before
wo, wo's output, the gate before w2, w2's output).  A tiled gather puts rank
r's ``[N, d]`` at columns ``[r·d, (r+1)·d)``: the port gathers a list and
concatenates on the last axis (``all_gather_into_tensor`` would stack ranks
on dim 0 instead).

Params come from ``params_from_tensors(..., shard_pad=128·tp, fuse_shards=tp)``
(n_ff and vocab padded to whole shards; fused wqkv/w13 interleaved per
shard), then :func:`shard_params_tp`.  Fused params built with another
``fuse_shards`` are refused: their rows would cross ranks.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..models import llama as model_lib
from ..models.llama import Params
from ..ops import quantized_matmul as qmm
from ..ops.attention import flash_decode_attention
from ..ops.norms import norm
from ..ops.rope import rope
from .mesh import Mesh
from .sharding import shard_params


def shard_params_tp(params: Params, mesh: Mesh) -> Params:
    """This rank's shard of every weight (contiguous copies, so each rank
    keeps only its own rows), with the mesh recorded as ``params.mesh``."""
    sharded = shard_params(params, mesh.rank, mesh.tp)
    sharded.mesh = mesh
    return sharded


def shard_cache_tp(cache: dict, mesh: Mesh) -> dict:
    """This rank's heads of a batch-1 cache: ``[L, H/tp, n_ctx, Dh]``."""
    def heads(v):
        per = v.shape[1] // mesh.tp
        return v.narrow(1, mesh.rank * per, per).contiguous()

    return {k: heads(v) for k, v in cache.items()}


def _all_gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Tiled all-gather on the last axis: rank r's columns land at
    ``[r·d, (r+1)·d)``."""
    if not mesh.distributed:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=-1)


def _all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.distributed:
        x = x.contiguous()
        dist.all_reduce(x)
    return x


def _local_forward(params, tokens, n_past: int, cache, cfg: ModelConfig, mesh: Mesh):
    """Forward on one rank's shards; mirrors the JAX ``_local_forward``
    (``tp.py:132-260`` there) op for op, the layer loop unrolled and the
    cache written in place."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    N = tokens.shape[0]
    tp = mesh.tp
    h_local, d_local, Dh = cfg.n_head // tp, cfg.n_embd // tp, cfg.head_dim
    lin = functools.partial(qmm.linear, quantize_activations=cfg.quantize_activations, compute_dtype=compute_dtype)
    ag = functools.partial(_all_gather_last, mesh=mesh)
    positions = torch.arange(n_past, n_past + N, device=tokens.device)

    # vocab-sharded embedding: rows [rank·vpl, (rank+1)·vpl) are local;
    # others look up row 0 and are zeroed before the sum
    emb = params["tok_embeddings"]
    vpl = emb.shape[0]
    local_ids = tokens - mesh.rank * vpl
    in_range = (local_ids >= 0) & (local_ids < vpl)
    x = qmm.embedding_lookup(torch.where(in_range, local_ids, 0), emb, compute_dtype=compute_dtype)
    x = _all_reduce_sum(torch.where(in_range[:, None], x, torch.zeros_like(x)), mesh)[:, : cfg.n_embd]

    stacked = params["layers_stacked"]
    k_cache, v_cache = cache["k"], cache["v"]
    for il in range(cfg.n_layer):
        layer = model_lib._layer_at(stacked, il)
        h = norm(x, layer["attention_norm"], cfg.norm_type, cfg.norm_eps)
        if "wqkv" in layer:  # this rank's rows are (q_r; k_r; v_r)
            qkv = lin(h, layer["wqkv"])
            q, k, v = (qkv[:, i * d_local : (i + 1) * d_local].reshape(N, h_local, Dh) for i in range(3))
        else:
            q, k, v = (lin(h, layer[w]).reshape(N, h_local, Dh) for w in ("wq", "wk", "wv"))
        q = rope(q, positions, Dh)
        k = rope(k, positions, Dh)
        rows = (il, slice(None), slice(n_past, n_past + N))
        k_cache[rows] = k.transpose(0, 1).to(k_cache.dtype)
        v_cache[rows] = v.transpose(0, 1).to(v_cache.dtype)
        if cfg.use_flash_decode and N == 1:  # the head-sharded cache is local: per-shard flash decode
            ctx = flash_decode_attention(q[0].float().contiguous(), k_cache, v_cache, il, n_past)[None]
            ctx = ctx.to(compute_dtype)
        else:
            ctx = model_lib._attention(q, k_cache[il], v_cache[il], n_past, cfg.n_ctx, compute_dtype)
        x = x + ag(lin(ag(ctx.reshape(N, d_local)), layer["wo"]))
        h = norm(x, layer["ffn_norm"], cfg.norm_type, cfg.norm_eps)
        if "w13" in layer:  # (w1_r; w3_r)
            g1, g3 = lin(h, layer["w13"]).chunk(2, dim=-1)
        else:
            g1, g3 = lin(h, layer["w1"]), lin(h, layer["w3"])
        gate = torch.nn.functional.silu(g1.float()).to(compute_dtype) * g3
        x = x + ag(lin(ag(gate), layer["w2"]))
    x = norm(x, params["norm"], cfg.norm_type, cfg.norm_eps)
    logits = ag(lin(x, params["output"]).float())
    return logits[:, : cfg.n_vocab], cache


def make_tp_forward(cfg: ModelConfig, params: Params, cache: dict):
    """The forward of this rank's shards (:func:`shard_params_tp`,
    :func:`shard_cache_tp`): a callable ``(params, tokens [N], n_past,
    cache) → (logits [N, n_vocab] f32 on every rank, cache)``, the cache
    written in place.  Raises on params whose fused concats do not match
    the TP degree (``fuse_shards`` ≠ tp: the JAX package runs them and
    mixes ranks' rows), on heads that do not split, and on int8 caches
    (the JAX TP cache is f32 or bf16)."""
    mesh: Mesh = getattr(params, "mesh", None)
    if mesh is None:
        raise ValueError("make_tp_forward: params hold no shard; pass them through shard_params_tp")
    tp = mesh.tp
    if cfg.n_head % tp:
        raise ValueError(f"make_tp_forward: n_head {cfg.n_head} not divisible by tp={tp}")
    if "wqkv" in params["layers_stacked"] and params.fuse_shards != tp:
        raise ValueError(f"make_tp_forward: fused params were built with fuse_shards={params.fuse_shards}, "
                         f"tp={tp}; build them with params_from_tensors(..., fuse_shards={tp})")
    if "k_scale" in cache:
        raise ValueError("make_tp_forward: the TP cache is f32 or bf16, not int8")
    if cache["k"].shape[1] != cfg.n_head // tp:
        raise ValueError(f"make_tp_forward: the cache holds {cache['k'].shape[1]} heads, "
                         f"{cfg.n_head // tp} expected (shard_cache_tp)")
    return functools.partial(_local_forward, cfg=cfg, mesh=mesh)
