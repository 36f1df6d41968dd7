"""The port's T layout (llama_swift_torch/ops/q4_matmul.py, the T branch of
ops/quantized_matmul.linear and params_from_tensors(q4_layout="t")) against
the JAX package, on the CPU, where the T kernel's wrapper takes its plain
version (the CUDA kernel is held against that on the card by
tests/test_torch_cuda.py and chip_smoke.py).  Inputs come from numpy seeds.

* ``q4_0_matmul_t_plain`` against the phase-dequant kernel
  ``q4_0_matmul_pallas`` in interpret mode and its stacked form at layer 1
  of 2: out 256, in 1024 and 2048, N = 1, 3, 8, 33, 64, within 1e-6 of
  max |y| (both take f32-exact products of the same decoded weights; only
  the summation order differs).
* ``linear``'s T dispatch: 1–64 rows take the T kernel, 65 the dequant and
  one product; activations are fake-quantized only when asked.
* The T embedding gather equals the JAX one exactly.
* JAX ``params_from_tensors(transpose_q4=True, shard_pad=256)``, plain and
  fused (``fuse_shards`` 1 and 2), carried across by
  ``params_from_jax_numpy`` equal the port's own
  ``params_from_tensors(q4_layout="t", shard_pad=256)`` byte for byte.
* The model on the T layout against JAX ``forward`` with
  ``transpose_q4=True`` under ``FORCE_PALLAS_INTERPRET`` (JAX then runs the
  phase kernel): a 64-row prefill and 2 decode steps, logits within 1e-5
  with f32 activations and 2e-3 with 4-bit ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import ModelConfig
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.ops import quantized_matmul as jqmm
from llama_swift_tpu.ops.q4_matmul_pallas import Q4_0TensorT, q4_0_matmul_pallas, q4_0_matmul_pallas_stacked
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.ops import q4_matmul as qm
from llama_swift_torch.ops import quantized_matmul as qmm
from llama_swift_torch.ops.q4_matvec import Q4_0Weight

KERNEL_BAR = 1e-6  # relative to max |y|
F32_BAR = 1e-5  # model logits, f32 activations
Q4_BAR = 2e-3  # model logits, 4-bit activations: the repo's parity bar


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _tcfg(cfg, **kw):
    return dataclasses.replace(TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def _port_tensors(tensors):
    return {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor) else v) for k, v in tensors.items()}


def _q4(rng, out, in_dim):
    return Q4_0Tensor.quantize((rng.standard_normal((out, in_dim)) * 0.05).astype(np.float32))


def _t(tensor: Q4_0TensorT, in_dim: int) -> qm.Q4_0WeightT:
    return qm.from_jax_t(np.asarray(tensor.qs4), np.asarray(tensor.scales_t), in_dim, np.shape(tensor.qs4)[-3] * 128)


# ---------------------------------------------------------------------------
# the kernel's plain version against the TPU kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dim", [1024, 2048])
@pytest.mark.parametrize("rows", [1, 3, 8, 33, 64])
def test_plain_matches_phase_kernel(rows, in_dim):
    rng = np.random.default_rng(rows * 7 + in_dim)
    tensors = [_q4(rng, 256, in_dim) for _ in range(2)]
    x = rng.standard_normal((rows, in_dim)).astype(np.float32)
    ts = [Q4_0TensorT.from_q4_0(t) for t in tensors]
    stacked = Q4_0TensorT(scales_t=jnp.stack([t.scales_t for t in ts]), qs4=jnp.stack([t.qs4 for t in ts]))
    w = _t(stacked, in_dim)
    assert isinstance(w.layer(1), qm.Q4_0WeightT)
    for il in (0, 1):
        # the logical bytes of the file: unpacking the T words loses nothing
        np.testing.assert_array_equal(w.layer(il).qs.numpy(), tensors[il].qs)
        np.testing.assert_array_equal(w.layer(il).d.numpy(), tensors[il].scales)
    y = qm.q4_0_matmul_t_plain(torch.from_numpy(x), w.layer(1)).numpy()
    ys = q4_0_matmul_pallas_stacked(jnp.asarray(x), stacked, 1, interpret=True)
    yj = q4_0_matmul_pallas(jnp.asarray(x), ts[1], interpret=True)
    assert _rel(y, ys) <= KERNEL_BAR
    assert _rel(y, yj) <= KERNEL_BAR
    assert torch.equal(qm.q4_0_matmul_t(torch.from_numpy(x), w.layer(1)), torch.from_numpy(y))


def test_from_jax_t_drops_padding():
    """A 1024-padded in dim and out rows beyond ``out_dim`` are dropped."""
    rng = np.random.default_rng(3)
    t = _q4(rng, 384, 1024)
    w = qm.from_jax_t(np.asarray(Q4_0TensorT.from_q4_0(t).qs4), np.asarray(Q4_0TensorT.from_q4_0(t).scales_t),
                      992, 300)
    assert w.shape == (300, 992)
    np.testing.assert_array_equal(w.qs.numpy(), t.qs[:300, :496])
    np.testing.assert_array_equal(w.d.numpy(), t.scales[:300, :31])


# ---------------------------------------------------------------------------
# linear's T dispatch and the embedding gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [True, False], ids=["q4_acts", "f32_acts"])
@pytest.mark.parametrize("rows,route", [(1, "q4_0_matmul_t"), (3, "q4_0_matmul_t"), (33, "q4_0_matmul_t"),
                                        (64, "q4_0_matmul_t"), (65, "q4_0_dequant")])
def test_linear_t_dispatch(monkeypatch, rows, route, quantize):
    seen = []
    for name in ("q4_0_matmul_t", "q4_0_dequant", "fake_quantize_q4_0", "q4_0_matvec", "q4_0_matmul_multi"):
        fn = getattr(qmm, name)
        monkeypatch.setattr(qmm, name, lambda *a, _fn=fn, _n=name, **k: seen.append(_n) or _fn(*a, **k))
    rng = np.random.default_rng(rows)
    t = _q4(rng, 256, 1024)
    w = _t(Q4_0TensorT.from_q4_0(t), 1024)
    x = rng.standard_normal((rows, 1024)).astype(np.float32)
    y = qmm.linear(torch.from_numpy(x), w, quantize_activations=quantize).numpy()
    assert seen == (["fake_quantize_q4_0"] if quantize else []) + [route]
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", True)
    yj = jqmm.linear(jnp.asarray(x), Q4_0TensorT.from_q4_0(t), quantize_activations=quantize)
    assert _rel(y, yj) <= KERNEL_BAR
    # the plain Q4_0 weight of the same bytes takes its own dispatch
    seen.clear()
    qmm.linear(torch.from_numpy(x), Q4_0Weight(w.qs, w.d), quantize_activations=quantize)
    assert "q4_0_matmul_t" not in seen


def test_t_embedding_gather_is_exact():
    rng = np.random.default_rng(11)
    t = _q4(rng, 384, 1024)
    tokens = np.array([0, 5, 127, 128, 300, 383, 5])
    w = _t(Q4_0TensorT.from_q4_0(t), 1024)
    got = qmm.embedding_lookup(torch.from_numpy(tokens), w).numpy()
    want = np.asarray(jqmm.embedding_lookup(jnp.asarray(tokens), Q4_0TensorT.from_q4_0(t)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# params carried across, and the model against JAX
# ---------------------------------------------------------------------------


def _cfg(**kw):
    # 128-dim heads (as tests/test_tp_shard_map.py); n_mult 96 makes n_ff
    # 2784 and n_vocab 300, neither a multiple of 256 (nor n_ff of 128)
    base = dict(n_embd=1024, n_head=8, n_vocab=300, n_mult=96, n_layer=2, n_ctx=128, n_rot=128)
    return ModelConfig.tiny(**{**base, **kw})


@pytest.fixture(scope="module")
def padded_tensors():
    dense = jllama.random_params(_cfg(), seed=9)
    return {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}


def _assert_same_params(got, want):
    assert set(got) == set(want)
    for top in ("tok_embeddings", "norm", "output"):
        a, b = got[top], want[top]
        assert type(a) is type(b), top
        for fa, fb in zip(tllama._fields(a), tllama._fields(b)):
            assert torch.equal(fa, fb), top
    assert set(got["layers_stacked"]) == set(want["layers_stacked"])
    for name, b in want["layers_stacked"].items():
        a = got["layers_stacked"][name]
        assert type(a) is type(b), name
        for fa, fb in zip(tllama._fields(a), tllama._fields(b)):
            assert torch.equal(fa, fb), name
    assert (got.shard_pad, got.fuse_shards) == (want.shard_pad, want.fuse_shards)


@pytest.mark.parametrize("fused,fuse_shards", [(False, 1), (True, 1), (True, 2)],
                         ids=["plain", "fused", "fused_2_shards"])
def test_t_params_carried_across_exactly(padded_tensors, fused, fuse_shards):
    cfg = _cfg(fuse_layer_matmuls=fused)
    jp = jllama.params_from_tensors(padded_tensors, cfg, param_dtype=jnp.float32, transpose_q4=True,
                                    shard_pad=256, fuse_shards=fuse_shards)
    carried = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), _tcfg(cfg), device="cpu",
                                           shard_pad=256, fuse_shards=fuse_shards)
    direct = tllama.params_from_tensors(_port_tensors(padded_tensors), _tcfg(cfg), device="cpu", q4_layout="t",
                                        shard_pad=256, fuse_shards=fuse_shards)
    _assert_same_params(carried, direct)
    stacked = direct["layers_stacked"]
    assert isinstance(stacked["wo"], qm.Q4_0WeightT) and isinstance(direct["output"], qm.Q4_0WeightT)
    assert stacked["w2"].shape == (cfg.n_embd, 2816) and direct["output"].shape == (512, cfg.n_embd)
    if fused and fuse_shards == 2:  # rank 1's half of w13 is (w1 rows 1408..2815; w3 rows 1408..2815)
        w1 = padded_tensors["layers.0.feed_forward.w1.weight"]
        np.testing.assert_array_equal(stacked["w13"].layer(0).qs[2816:2816 + 1376].numpy(), w1.qs[1408:])


def test_t_params_default_layout_follows_device(padded_tensors):
    """On the CPU the default keeps the logical layout; ``q4_layout="t"``
    asks for T; the megakernel never runs on T params."""
    tcfg = _tcfg(_cfg(fuse_layer_matmuls=True))
    port = _port_tensors(padded_tensors)
    assert type(tllama.params_from_tensors(port, tcfg, device="cpu", shard_pad=256)["output"]) is Q4_0Weight
    p = tllama.params_from_tensors(port, tcfg, device="cpu", q4_layout="t")
    assert isinstance(p["layers_stacked"]["wqkv"], qm.Q4_0WeightT)
    cache = tllama.init_cache(tcfg, device="cpu")
    assert not tllama._takes_megakernel(p["layers_stacked"], 1, None, cache, tcfg)
    with pytest.raises(ValueError):
        tllama.params_from_tensors(port, tcfg, device="cpu", q4_layout="x")


@pytest.fixture(scope="module")
def model_tensors():
    dense = jllama.random_params(_cfg(n_vocab=256, n_mult=256), seed=4)
    return {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}


@pytest.mark.parametrize("quantize", [False, True], ids=["f32_acts", "q4_acts"])
def test_model_t_layout_matches_jax(model_tensors, monkeypatch, quantize):
    cfg = _cfg(n_vocab=256, n_mult=256, quantize_activations=quantize)
    tcfg = _tcfg(cfg)
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, transpose_q4=True)
    assert isinstance(jp["layers_stacked"]["wq"], Q4_0TensorT)
    params = tllama.params_from_tensors(_port_tensors(model_tensors), tcfg, device="cpu", q4_layout="t")
    launched = []
    fn = qmm.q4_0_matmul_t
    monkeypatch.setattr(qmm, "q4_0_matmul_t", lambda x, w: launched.append(x.shape[0]) or fn(x, w))
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", True)
    bar = Q4_BAR if quantize else F32_BAR
    prompt, length = jllama.pad_tokens([1, 17, 30, 42, 99, 7, 200, 3, 55], 64)
    cache, jcache = tllama.init_cache(tcfg, device="cpu"), jllama.init_cache(cfg)
    lg, cache = tllama.prefill(params, torch.from_numpy(prompt.astype(np.int64)), 0, cache, tcfg)
    jlg, jcache = jllama.prefill(jp, jnp.asarray(prompt), jnp.int32(0), jcache, cfg)
    assert _rel(lg.numpy()[:length], np.asarray(jlg)[:length]) <= bar
    assert launched == [64] * (7 * cfg.n_layer + 1)  # every product of the bucket on the T kernel
    for i, tok in enumerate([4, 250]):
        lg, cache = tllama.decode_step(params, torch.tensor(tok), length + i, cache, tcfg)
        jlg, jcache = jllama.decode_step(jp, jnp.int32(tok), jnp.int32(length + i), jcache, cfg)
        assert _rel(lg.numpy(), jlg) <= bar, i
