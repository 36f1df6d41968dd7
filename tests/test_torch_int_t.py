"""The T layout's integer products in the port (llama_swift_torch/ops/q4_matmul.py:
``q4_0_int_matmul``, ``q4_0_t_matmul_multi`` and the gates
``MAX_INT_KERNEL_ROWS``/``MAX_MULTI_ROWS_T`` that ``linear`` reads) against
the JAX package, on the CPU, where each wrapper takes its plain version (the
CUDA kernels are held against those on the card by tests/test_torch_cuda.py
and chip_smoke.py).  Inputs come from numpy seeds.

* ``q4_0_int_matmul_plain`` against the integer kernel
  ``q4_0_int_matmul_pallas`` in interpret mode and its stacked form at layer
  1 of 2: out 256, in 1024, N = 1, 3, 8, 33, 64, within 1e-6 of max |y|
  (both take exact integer block dots; the JAX kernel scales them as
  ``d_w·(d_x·P − 8·d_x·S)``, the port as ``(P − 8·S)·(d_w·d_x)``, and the sums
  over blocks run in another order).
* ``q4_0_t_matmul_multi`` against the JAX multi-row T kernel in interpret
  mode: B = 1, 3, 8, 32, with 4-bit activations within 1e-6 of max |y| (the
  same exact dots), with f32 rows within 1e-5 (the JAX kernel sums
  ``Σ 16^-p·(16^p·n)·x − 8·Σx`` by nibble phase, the port ``Σ (n − 8)·x``;
  measured at most 2.6e-7 and 4.3e-7 on these inputs).
* ``linear``'s T dispatch at the gates (0, 0), (64, 0) and (0, 32): each row
  count reaches the expected wrapper, 65 rows still the dequant, and the
  result equals the JAX ``linear`` at the same gates within 1e-6 (1e-5 where
  the multi-row T product takes f32 rows).
* A tiny T-layout model with the gates raised, against JAX ``forward`` with
  its gates raised the same way (``monkeypatch`` on
  ``llama_swift_tpu.ops.q4_matmul_pallas``) under ``FORCE_PALLAS_INTERPRET``:
  a 64-row prefill and 2 decode steps, logits within 2e-3 with 4-bit
  activations (the repo's parity bar) and 1e-5 with f32 ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import ModelConfig
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.ops import q4_matmul_pallas as jqp
from llama_swift_tpu.ops import quantized_matmul as jqmm
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.ops import q4_matmul as qm
from llama_swift_torch.ops import quantized_matmul as qmm

KERNEL_BAR = 1e-6  # relative to max |y|: exact integer dots on both sides
F32_ROWS_BAR = 1e-5  # relative to max |y|: f32 rows summed in another order
F32_BAR = 1e-5  # model logits, f32 activations
Q4_BAR = 2e-3  # model logits, 4-bit activations: the repo's parity bar


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _q4(rng, out, in_dim):
    return Q4_0Tensor.quantize((rng.standard_normal((out, in_dim)) * 0.05).astype(np.float32))


def _t(tensor: jqp.Q4_0TensorT, in_dim: int) -> qm.Q4_0WeightT:
    return qm.from_jax_t(np.asarray(tensor.qs4), np.asarray(tensor.scales_t), in_dim, np.shape(tensor.qs4)[-3] * 128)


def _stacked_t(rng, in_dim, n=2):
    ts = [jqp.Q4_0TensorT.from_q4_0(_q4(rng, 256, in_dim)) for _ in range(n)]
    stacked = jqp.Q4_0TensorT(scales_t=jnp.stack([t.scales_t for t in ts]), qs4=jnp.stack([t.qs4 for t in ts]))
    return ts, stacked, _t(stacked, in_dim)


# ---------------------------------------------------------------------------
# row 12: the integer product's plain version against the TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 3, 8, 33, 64])
def test_int_plain_matches_magic_kernel(rows):
    rng = np.random.default_rng(100 + rows)
    ts, stacked, w = _stacked_t(rng, 1024)
    x = rng.standard_normal((rows, 1024)).astype(np.float32)
    y = qm.q4_0_int_matmul_plain(torch.from_numpy(x), w.layer(1)).numpy()
    yj = jqp.q4_0_int_matmul_pallas(jnp.asarray(x), ts[1], interpret=True)
    ys = jqp.q4_0_int_matmul_pallas_stacked(jnp.asarray(x), stacked, 1, interpret=True)
    assert _rel(y, yj) <= KERNEL_BAR
    assert _rel(y, ys) <= KERNEL_BAR
    # the wrapper takes the plain version on the CPU, with no row cap
    assert torch.equal(qm.q4_0_int_matmul(torch.from_numpy(x), w.layer(1)), torch.from_numpy(y))


# ---------------------------------------------------------------------------
# row 13: the multi-row T product against the TPU kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [True, False], ids=["q4_acts", "f32_acts"])
@pytest.mark.parametrize("rows", [1, 3, 8, 32])
def test_t_multi_matches_tpu_kernel(rows, quantize):
    rng = np.random.default_rng(200 + rows)
    ts, stacked, w = _stacked_t(rng, 1024)
    x = rng.standard_normal((rows, 1024)).astype(np.float32)
    y = qm.q4_0_t_matmul_multi(torch.from_numpy(x), w.layer(1), quantize_acts=quantize).numpy()
    yj = jqp.q4_0_t_matmul_multi(jnp.asarray(x), ts[1], quantize_acts=quantize, interpret=True)
    ys = jqp.q4_0_t_matmul_multi(jnp.asarray(x), stacked, 1, quantize_acts=quantize, interpret=True)
    bar = KERNEL_BAR if quantize else F32_ROWS_BAR
    assert _rel(y, yj) <= bar
    assert _rel(y, ys) <= bar
    plain = qm.q4_0_t_matmul_multi_plain(torch.from_numpy(x), w.layer(1), quantize_acts=quantize)
    assert torch.equal(plain, torch.from_numpy(y))


def test_t_multi_takes_at_most_32_rows():
    """The JAX function asserts 1 ≤ B ≤ 32; the port raises, on any device."""
    rng = np.random.default_rng(7)
    _, _, w = _stacked_t(rng, 1024, n=1)
    x = torch.from_numpy(rng.standard_normal((33, 1024)).astype(np.float32))
    with pytest.raises(ValueError, match="1..32"):
        qm.q4_0_t_matmul_multi(x, w.layer(0))
    with pytest.raises(AssertionError):
        jqp.q4_0_t_matmul_multi(jnp.asarray(x.numpy()), jqp.Q4_0TensorT.from_q4_0(_q4(rng, 256, 1024)), interpret=True)


# ---------------------------------------------------------------------------
# linear's T dispatch at three gate settings
# ---------------------------------------------------------------------------

WRAPPERS = ("q4_0_int_matmul", "q4_0_t_matmul_multi", "q4_0_matmul_t", "q4_0_dequant", "fake_quantize_q4_0",
            "q4_0_matvec", "q4_0_matmul_multi")


def _route(gates, rows, quantize):
    """The wrapper the JAX package's order picks for ``rows`` T rows."""
    max_int, max_multi = gates
    if quantize and rows <= max_int:
        return ["q4_0_int_matmul"]
    if 1 <= rows <= max_multi:
        return ["q4_0_t_matmul_multi"]
    fq = ["fake_quantize_q4_0"] if quantize else []
    return fq + (["q4_0_matmul_t"] if rows <= 64 else ["q4_0_dequant"])


@pytest.mark.parametrize("gates", [(0, 0), (64, 0), (0, 32)], ids=["gates_0_0", "int_64", "multi_32"])
@pytest.mark.parametrize("quantize", [True, False], ids=["q4_acts", "f32_acts"])
@pytest.mark.parametrize("rows", [1, 8, 32, 33, 64, 65])
def test_linear_t_dispatch_at_gates(monkeypatch, gates, quantize, rows):
    seen = []
    for name in WRAPPERS:
        fn = getattr(qmm, name)
        monkeypatch.setattr(qmm, name, lambda *a, _fn=fn, _n=name, **k: seen.append(_n) or _fn(*a, **k))
    monkeypatch.setattr(qm, "MAX_INT_KERNEL_ROWS", gates[0])
    monkeypatch.setattr(qm, "MAX_MULTI_ROWS_T", gates[1])
    rng = np.random.default_rng(rows * 3 + gates[0] + gates[1])
    t = _q4(rng, 256, 1024)
    w = _t(jqp.Q4_0TensorT.from_q4_0(t), 1024)
    x = rng.standard_normal((rows, 1024)).astype(np.float32)
    y = qmm.linear(torch.from_numpy(x), w, quantize_activations=quantize).numpy()
    assert seen == _route(gates, rows, quantize)
    monkeypatch.setattr(jqp, "MAX_INT_KERNEL_ROWS", gates[0])
    monkeypatch.setattr(jqp, "MAX_MULTI_ROWS_T", gates[1])
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", True)
    yj = jqmm.linear(jnp.asarray(x), jqp.Q4_0TensorT.from_q4_0(t), quantize_activations=quantize)
    multi_f32 = seen == ["q4_0_t_matmul_multi"] and not quantize
    assert _rel(y, yj) <= (F32_ROWS_BAR if multi_f32 else KERNEL_BAR)


def test_gates_default_to_zero():
    """The JAX package's serving values, which the port mirrors."""
    assert (qm.MAX_INT_KERNEL_ROWS, qm.MAX_MULTI_ROWS_T) == (0, 0)
    assert (jqp.MAX_INT_KERNEL_ROWS, jqp.MAX_MULTI_ROWS_T) == (0, 0)


# ---------------------------------------------------------------------------
# a tiny T-layout model with the gates raised, against JAX
# ---------------------------------------------------------------------------


def _cfg(**kw):
    base = dict(n_embd=1024, n_head=8, n_vocab=256, n_mult=256, n_layer=2, n_ctx=128, n_rot=128)
    return ModelConfig.tiny(**{**base, **kw})


def _tcfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def model_tensors():
    dense = jllama.random_params(_cfg(), seed=4)
    return {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}


@pytest.mark.parametrize("quantize", [True, False], ids=["q4_acts", "f32_acts"])
@pytest.mark.parametrize("gates", [(64, 0), (0, 32)], ids=["int_64", "multi_32"])
def test_model_t_layout_with_gates_matches_jax(model_tensors, monkeypatch, gates, quantize):
    cfg = _cfg(quantize_activations=quantize)
    tcfg = _tcfg(cfg)
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, transpose_q4=True)
    port = {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor) else v) for k, v in model_tensors.items()}
    params = tllama.params_from_tensors(port, tcfg, device="cpu", q4_layout="t")
    launched = []
    for name in ("q4_0_int_matmul", "q4_0_t_matmul_multi", "q4_0_matmul_t"):
        fn = getattr(qmm, name)
        monkeypatch.setattr(qmm, name, lambda x, w, _fn=fn, _n=name, **k: launched.append((_n, x.shape[0]))
                            or _fn(x, w, **k))
    for mod in (qm, jqp):
        monkeypatch.setattr(mod, "MAX_INT_KERNEL_ROWS", gates[0])
        monkeypatch.setattr(mod, "MAX_MULTI_ROWS_T", gates[1])
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", True)
    bar = Q4_BAR if quantize else F32_BAR
    n_mm = 7 * cfg.n_layer + 1
    prompt, length = jllama.pad_tokens([1, 17, 30, 42, 99, 7, 200, 3, 55], 64)
    cache, jcache = tllama.init_cache(tcfg, device="cpu"), jllama.init_cache(cfg)
    lg, cache = tllama.prefill(params, torch.from_numpy(prompt.astype(np.int64)), 0, cache, tcfg)
    jlg, jcache = jllama.prefill(jp, jnp.asarray(prompt), jnp.int32(0), jcache, cfg)
    assert _rel(lg.numpy()[:length], np.asarray(jlg)[:length]) <= bar
    prefill_route = _route(gates, 64, quantize)[-1]
    assert launched == [(prefill_route, 64)] * n_mm
    launched.clear()
    for i, tok in enumerate([4, 250]):
        lg, cache = tllama.decode_step(params, torch.tensor(tok), length + i, cache, tcfg)
        jlg, jcache = jllama.decode_step(jp, jnp.int32(tok), jnp.int32(length + i), jcache, cfg)
        assert _rel(lg.numpy(), jlg) <= bar, i
    decode_route = _route(gates, 1, quantize)[-1]
    assert launched == [(decode_route, 1)] * (2 * n_mm)
