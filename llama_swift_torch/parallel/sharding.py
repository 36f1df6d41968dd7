"""Tensor-parallel split map and per-rank slicing (counterpart of
``llama_swift_tpu/parallel/sharding.py`` and of the specs of
``llama_swift_tpu/parallel/tp.py``).

The JAX package turns split maps into ``PartitionSpec``s and lets GSPMD
place the shards and insert the collectives.  PyTorch has no GSPMD, and
the JAX NamedSharding path "only proves the jnp fallback" (``parallel/tp.py:4-9``
there): what serves is the ``shard_map`` forward, whose map shards every
2-D weight by rows (out axis, :data:`ROW_PARALLEL`) and replicates the
norms.  The port keeps that one map as data (:func:`tp_param_specs`) and
the per-rank slicing (:func:`shard_params`), not the placement; the
collectives are ``parallel/tp.py``'s.  Packed Q4 weights split leaf by
leaf along the out axis (nibbles ``[out, in/2]`` and scales
``[out, in/32]`` alike).
"""

from __future__ import annotations

from ..config import ModelConfig
from ..models.llama import Q4_WEIGHTS, Params, _fields

# [out, in] axis -> mesh axis, as JAX PartitionSpec tuples
ROW_PARALLEL = ("tp", None)  # out sharded
REPLICATED_1D = (None,)

NORMS = ("attention_norm", "ffn_norm", "norm")


def tp_param_specs(params: dict) -> dict:
    """The spec of every weight of ``params`` (top level and
    ``layers_stacked``): row-parallel, the norms replicated."""
    def spec(k):
        return REPLICATED_1D if k in NORMS else ROW_PARALLEL

    return {**{k: spec(k) for k in ("tok_embeddings", "norm", "output")},
            "layers_stacked": {k: spec(k) for k in params["layers_stacked"]}}


def shard_leaf(w, spec: tuple, rank: int, tp: int):
    """Rank ``rank``'s rows of one weight (dense, or packed leaf by leaf);
    a stacked weight's leading layer axis is kept whole.  Replicated
    weights are returned as they are."""
    if spec == REPLICATED_1D:
        return w
    axis = (w.qs if isinstance(w, Q4_WEIGHTS) else w).dim() - 2  # the out axis

    def take(f):
        n = f.shape[axis]
        if n % tp:
            raise ValueError(f"shard_leaf: {n} rows do not split into {tp} shards")
        per = n // tp
        return f.narrow(axis, rank * per, per).contiguous()

    return type(w)(*map(take, _fields(w))) if isinstance(w, Q4_WEIGHTS) else take(w)


def shard_params(params: Params, rank: int, tp: int) -> Params:
    """This rank's params under :func:`tp_param_specs`, with the layout the
    builder recorded."""
    specs = tp_param_specs(params)
    out = Params(shard_pad=params.shard_pad, fuse_shards=params.fuse_shards)
    for k, spec in specs.items():
        if k == "layers_stacked":
            out[k] = {n: shard_leaf(w, spec[n], rank, tp) for n, w in params[k].items()}
        else:
            out[k] = shard_leaf(params[k], spec, rank, tp)
    return out


def validate_tp_divisibility(cfg: ModelConfig, tp: int, *, tiled_q4: bool = False) -> None:
    """TP must divide heads, ffn hidden, vocab and (for quant) keep whole
    32-element blocks per shard.

    With ``tiled_q4`` (the JAX package's 128-row-tiled layouts), row-parallel
    shards have 128-row granularity: n_embd must divide by 128·tp; n_ff and
    vocab are zero-padded by ``params_from_tensors(shard_pad=128*tp)``
    instead.
    """
    if cfg.n_head % tp:
        raise ValueError(f"n_head {cfg.n_head} not divisible by tp={tp}")
    if cfg.n_ff % (32 * tp) and not tiled_q4:
        raise ValueError(
            f"n_ff {cfg.n_ff} must keep whole Q4 blocks per shard (tp={tp})"
        )
    if cfg.n_vocab % tp and not tiled_q4:
        raise ValueError(f"n_vocab {cfg.n_vocab} not divisible by tp={tp}")
    if cfg.n_embd % (32 * tp):
        raise ValueError(
            f"n_embd {cfg.n_embd} must keep whole Q4 blocks per shard (tp={tp})"
        )
    if tiled_q4 and cfg.n_embd % (128 * tp):
        raise ValueError(
            f"tiled Q4 layout row-shards at 128-row granularity: n_embd "
            f"{cfg.n_embd} must divide by 128*tp={128 * tp}"
        )
