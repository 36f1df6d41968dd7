"""The port's Q4 products on f32 activations (``quantize_activations=False``)
against the JAX package, on the CPU, where the f32-activation kernels'
wrappers take their plain versions (the CUDA kernels are held against those
on the card by tests/test_torch_cuda.py and chip_smoke.py).  Inputs come
from numpy seeds.

* Each plain version against its TPU kernel in interpret mode:
  ``q4_0_vpu_matvec(quantize_acts=False)``, ``q4_1_vpu_matvec(quantize_acts=
  False)`` and ``q4_0_vpu_matmul_multi(quantize_acts=False)`` at in 256 and
  512 (multi-row: B = 2, 5, 8, 32), within the JAX test's own ``rtol = atol
  = 2e-5`` (tests/test_q4_vpu.py): the TPU kernel takes ``Σn·x − 8·Σx`` in a
  phase-major order, the port ``Σ(n−8)·x``; equal up to reassociation.
* ``linear``'s dispatch, as the JAX ``linear``: with f32 activations one row
  (Q4_0 or Q4_1) takes the f32 matvec and 2–32 Q4_0 rows the f32 multi-row
  kernel, never a dequant; 33+ Q4_0 rows and 2+ Q4_1 rows dequantize.
* The tiny model with f32 activations against JAX forward under
  ``FORCE_PALLAS_INTERPRET`` (the JAX package's own test switch: its
  ``linear`` then runs the same Pallas kernels in interpret mode), logits
  within 1e-5 relative: an 8-token prefill and 4 decode steps on Q4_0 and
  Q4_1, plain and fused params; and an engine step at B = 4 after slot
  prefills (JAX: ``slot_prefill_chunk`` and ``batched_decode``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType, ModelConfig
from llama_swift_tpu.formats.quant import Q4_0Tensor, Q4_1Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.ops import quantized_matmul as jqmm
from llama_swift_tpu.ops.q4_vpu_pallas import (
    Q4_0TensorV,
    Q4_1TensorV,
    q4_0_vpu_matmul_multi,
    q4_0_vpu_matvec,
    q4_1_vpu_matvec,
)
from llama_swift_tpu.runtime.engine import batched_decode, slot_prefill_chunk
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.formats.quant import Q4_1Tensor as TQ4_1Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.ops import quantized_matmul as qmm

OUT = 256
TOL = 2e-5  # tests/test_q4_vpu.py's rtol and atol for the TPU kernels
MODEL_BAR = 1e-5  # relative logits
PROMPT = [1, 17, 30, 42, 99, 7, 200, 3]
DECODE = [4, 250, 9, 77]
SLOT_PROMPTS = [[1, 17, 30, 42, 99], [1, 26, 7], [1, 5, 6, 7, 8, 9, 10]]
STEP_TOKENS = [[4, 6, 9, 0], [77, 3, 210, 0]]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _weight(kind, in_dim, seed=0):
    """(JAX logical tensor, the port's packed weight) of one random weight,
    at the scale of tests/test_q4_vpu.py's weights (std 0.05)."""
    w = np.random.default_rng(seed).standard_normal((OUT, in_dim)).astype(np.float32) * 0.05
    if kind == "q4_0":
        t = Q4_0Tensor.quantize(w)
        return t, mv.Q4_0Weight.from_q4_0(TQ4_0Tensor(t.scales, t.qs))
    t = Q4_1Tensor.quantize(w)
    return t, mv.Q4_1Weight.from_q4_1(TQ4_1Tensor(t.mins, t.scales, t.qs))


def _x(rows, in_dim, seed=1):
    return np.random.default_rng(seed).standard_normal((rows, in_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# the plain versions against the TPU kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dim", [256, 512])
def test_q4_0_matvec_f32_plain_matches_tpu_kernel(in_dim):
    t, w = _weight("q4_0", in_dim)
    x = _x(1, in_dim)
    y = mv.q4_0_matvec_f32_plain(torch.from_numpy(x[0]), w).numpy()
    yj = q4_0_vpu_matvec(jnp.asarray(x), Q4_0TensorV.from_q4_0(t), quantize_acts=False, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yj)[0], rtol=TOL, atol=TOL)
    # the CPU wrapper is the plain version
    assert torch.equal(mv.q4_0_matvec(torch.from_numpy(x[0]), w, quantize_acts=False), torch.from_numpy(y))


@pytest.mark.parametrize("in_dim", [256, 512])
def test_q4_1_matvec_f32_plain_matches_tpu_kernel(in_dim):
    t, w = _weight("q4_1", in_dim)
    x = _x(1, in_dim)
    y = mv.q4_1_matvec_plain(torch.from_numpy(x[0]), w, quantize_acts=False).numpy()
    yj = q4_1_vpu_matvec(jnp.asarray(x), Q4_1TensorV.from_q4_1(t), quantize_acts=False, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yj)[0], rtol=TOL, atol=TOL)
    assert torch.equal(mv.q4_1_matvec(torch.from_numpy(x[0]), w, quantize_acts=False), torch.from_numpy(y))


@pytest.mark.parametrize("in_dim", [256, 512])
@pytest.mark.parametrize("B", [2, 5, 8, 32])
def test_q4_0_matmul_multi_f32_plain_matches_tpu_kernel(B, in_dim):
    t, w = _weight("q4_0", in_dim)
    x = _x(B, in_dim)
    y = mv.q4_0_matmul_multi_f32_plain(torch.from_numpy(x), w).numpy()
    yj = q4_0_vpu_matmul_multi(jnp.asarray(x), Q4_0TensorV.from_q4_0(t), quantize_acts=False, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yj), rtol=TOL, atol=TOL)
    assert torch.equal(mv.q4_0_matmul_multi(torch.from_numpy(x), w, quantize_acts=False), torch.from_numpy(y))
    # each row is the matvec's row
    np.testing.assert_allclose(y[1], mv.q4_0_matvec_f32_plain(torch.from_numpy(x[1]), w).numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# linear's dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,rows,route", [
    ("q4_0", 1, "q4_0_matvec_f32"), ("q4_0", 2, "q4_0_matmul_multi_f32"), ("q4_0", 17, "q4_0_matmul_multi_f32"),
    ("q4_0", 32, "q4_0_matmul_multi_f32"), ("q4_0", 33, "q4_0_dequant"), ("q4_0", 64, "q4_0_dequant"),
    ("q4_1", 1, "q4_1_matvec_f32"), ("q4_1", 2, "q4_1_dequant"), ("q4_1", 33, "q4_1_dequant"),
])
def test_linear_dispatch_with_f32_activations(monkeypatch, kind, rows, route):
    """One row and 2–32 Q4_0 rows never dequantize; the result equals the
    JAX ``linear`` on the V layout with its kernels in interpret mode."""
    seen = []
    for mod, name in [(mv, "q4_0_matvec_f32"), (mv, "q4_1_matvec_f32"), (mv, "q4_0_matmul_multi_f32"),
                      (qmm, "q4_0_dequant"), (qmm, "q4_1_dequant"), (qmm, "fake_quantize_q4_0"),
                      (qmm, "fake_quantize_q4_1")]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: seen.append(_n) or _fn(*a, **k))
    t, w = _weight(kind, 256)
    x = _x(rows, 256)
    y = qmm.linear(torch.from_numpy(x), w, quantize_activations=False).numpy()
    assert seen == [route]
    v = Q4_0TensorV.from_q4_0(t) if kind == "q4_0" else Q4_1TensorV.from_q4_1(t)
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", True)
    yj = jqmm.linear(jnp.asarray(x), v, quantize_activations=False)
    np.testing.assert_allclose(y, np.asarray(yj), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the model with f32 activations against JAX under FORCE_PALLAS_INTERPRET
# ---------------------------------------------------------------------------


def _cfg(kind, fused):
    """A tiny config whose products all reach the V layout's kernels in JAX
    (out dims multiples of 128), with f32 activations."""
    return ModelConfig.tiny(n_ctx=64, n_embd=128, n_head=2, n_rot=64, n_vocab=256, n_mult=128, n_layer=2,
                            scan_layers=False, fuse_layer_matmuls=fused, quantize_activations=False,
                            ftype=GGMLType.Q4_0 if kind == "q4_0" else GGMLType.Q4_1)


def _tcfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def tensors():
    dense = jllama.random_params(_cfg("q4_0", False), seed=5)
    return {kind: {k: (cls.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}
            for kind, cls in (("q4_0", Q4_0Tensor), ("q4_1", Q4_1Tensor))}


def _both(kind, fused, tensors, monkeypatch):
    """(cfg, JAX V-layout params, the port's params) of one weight type."""
    cfg = _cfg(kind, fused)
    jparams = jllama.params_from_tensors(tensors[kind], cfg, param_dtype=jnp.float32, q4_layout="v")
    port = {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor)
                else TQ4_1Tensor(v.mins, v.scales, v.qs) if isinstance(v, Q4_1Tensor) else v)
            for k, v in tensors[kind].items()}
    params = tllama.params_from_tensors(port, _tcfg(cfg), device="cpu")
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", True)
    return cfg, jparams, params


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_model_f32_activations_matches_jax(tensors, monkeypatch, kind, fused):
    cfg, jparams, params = _both(kind, fused, tensors, monkeypatch)
    tcfg = _tcfg(cfg)
    assert ("wqkv" in params["layers_stacked"]) == fused
    cache, jcache = tllama.init_cache(tcfg, device="cpu"), jllama.init_cache(cfg)
    launched = []
    for name in ("q4_0_matvec_f32", "q4_1_matvec_f32", "q4_0_matmul_multi_f32"):
        fn = getattr(mv, name)
        monkeypatch.setattr(mv, name, lambda *a, _fn=fn, _n=name, **k: launched.append(_n) or _fn(*a, **k))
    lg, cache = tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
    jlg, jcache = jllama.prefill(jparams, jnp.asarray(PROMPT, jnp.int32), jnp.int32(0), jcache, cfg)
    assert _rel(lg.numpy(), jlg) <= MODEL_BAR
    # an 8-row prefill: the f32 multi-row kernel on Q4_0, the dequant on Q4_1
    per_forward = (4 if fused else 7) * cfg.n_layer + 1
    assert launched == (["q4_0_matmul_multi_f32"] * per_forward if kind == "q4_0" else [])
    for i, tok in enumerate(DECODE):
        launched.clear()
        lg, cache = tllama.decode_step(params, torch.tensor(tok), len(PROMPT) + i, cache, tcfg)
        jlg, jcache = jllama.decode_step(jparams, jnp.int32(tok), jnp.int32(len(PROMPT) + i), jcache, cfg)
        assert _rel(lg.numpy(), jlg) <= MODEL_BAR, i
        assert launched == [f"{kind}_matvec_f32"] * per_forward


@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_engine_step_b4_f32_activations_matches_jax(tensors, monkeypatch, kind):
    """Slot prefills of 3 slots, then 2 batched steps at B = 4 (the engine's
    decode step: the f32 multi-row kernel on Q4_0, the dequant on Q4_1)."""
    cfg, jparams, params = _both(kind, False, tensors, monkeypatch)
    tcfg = _tcfg(cfg)
    B = 4
    cache, jcache = tllama.init_cache_batched(tcfg, B, device="cpu"), jllama.init_cache_batched(cfg, B)
    for b, ids in enumerate(SLOT_PROMPTS):
        lg, cache = tllama.forward(params, torch.tensor(ids), 0, cache, tcfg, slot=b)
        jlg, jcache = slot_prefill_chunk(jparams, jnp.asarray(ids, jnp.int32), jnp.int32(0), jnp.int32(b), jcache,
                                         cfg)
        assert _rel(lg.numpy(), jlg) <= MODEL_BAR, b
    n_pasts = np.array([len(p) for p in SLOT_PROMPTS] + [0])
    for toks in STEP_TOKENS:
        lg, cache = tllama.forward_batched(params, torch.tensor(toks), n_pasts, cache, tcfg)
        jlg, jcache = batched_decode(jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(n_pasts, jnp.int32),
                                     jcache, cfg)
        assert _rel(lg.numpy()[:3], np.asarray(jlg)[:3]) <= MODEL_BAR
        n_pasts[:3] += 1
