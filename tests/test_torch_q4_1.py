"""Q4_1 weights in the port (llama_swift_torch/ops/q4_matvec.py,
ops/q4_dequant.py, ops/quantized_matmul.py, models/llama.py) against the JAX
package, on the CPU, where the Q4_1 matvec and dequant wrappers take their
plain versions (the CUDA kernels are held against those on the card by
tests/test_torch_cuda.py and chip_smoke.py).  Inputs come from numpy seeds.

* The activation quantizer: the same codes and x̂ as the JAX
  fake_quantize_q4_1 (exact), and bit-identical to the port's quantizer
  before it divided by a tensor (on the CPU both divide truly).
* The matvec's plain version against the TPU kernel in interpret mode,
  single and stacked, with and without quantized activations (≤ 1e-5 of
  max |y|: both sum f32 products, in other orders).
* The dequant bit-exact against dequantize_q4_1_jnp; the TPU dequant
  kernel in interpret mode (its phase-major order undone) is one fused
  multiply-add, so there the port lies within one rounding of the product.
* Q4_1 params carried across from JAX (logical and V layout, fused and not)
  byte-exact; the model's prefill and decode logits against JAX forward
  within 1e-5; fused Q4_1 params never reach the whole-stack Q4_0 kernel;
  the engine's batched rows against batch-1 decode; LlamaRunner, the Engine
  and the CLI on a Q4_1 file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType, ModelConfig
from llama_swift_tpu.config import RunnerConfig as JRunnerConfig
from llama_swift_tpu.config import SamplingConfig as JSamplingConfig
from llama_swift_tpu.formats import ggml as jggml
from llama_swift_tpu.formats.quant import Q4_1Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.ops import quantized_matmul as jqmm
from llama_swift_tpu.ops.q4_dequant_pallas import q4v_dequant_pm, q4v_dequant_pm_stacked
from llama_swift_tpu.ops.q4_vpu_pallas import Q4_1TensorV, q4_1_vpu_matvec, q4_1_vpu_matvec_stacked
from llama_swift_tpu.runtime.runner import LlamaRunner as JaxRunner
from llama_swift_torch import Engine, RunnerConfig, SamplingConfig, Vocab
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_1Tensor as TQ4_1Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.ops import q4_dequant as dq
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.ops import quantized_matmul as qmm
from llama_swift_torch.runtime.runner import LlamaRunner

OUT, IN = 256, 1024
MATVEC_BAR = 1e-5  # relative to max |y|: f32 sums in another order
MODEL_BAR = 1e-5


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _tcfg(cfg, **kw):
    return dataclasses.replace(TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def _port(t):
    return TQ4_1Tensor(t.mins, t.scales, t.qs) if isinstance(t, Q4_1Tensor) else t


@pytest.fixture(scope="module")
def w_np():
    rng = np.random.default_rng(0)
    return Q4_1Tensor.quantize((rng.standard_normal((OUT, IN)) * 0.05).astype(np.float32))


@pytest.fixture(scope="module")
def w_t(w_np):
    return mv.Q4_1Weight.from_q4_1(_port(w_np))


def _acts(seed, rows=1):
    """Activation rows with the blocks that matter: a constant block (d = 0)
    and a block of exact ties (min 0, max 15: d = 1, values k + ½)."""
    x = np.random.default_rng(seed).standard_normal((rows, IN)).astype(np.float32)
    x[:, 32:64] = 0.75
    x[:, 64:96] = np.arange(32) % 15 + 0.5
    x[:, 64], x[:, 65] = 0.0, 15.0
    return x


# ---------------------------------------------------------------------------
# the activation quantizer
# ---------------------------------------------------------------------------


def _parent_fake_quantize_q4_1(x: torch.Tensor) -> torch.Tensor:
    """The port's fake_quantize_q4_1 before its divisor became a tensor
    (``(max − min) / 15.0``, a Python scalar, which CUDA PyTorch divides
    through the reciprocal)."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // 32, 32)
    mn = xf.amin(dim=-1, keepdim=True)
    d = (xf.amax(dim=-1, keepdim=True) - mn) / 15.0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    return (qmm.round_half_away((xf - mn) * inv) * d + mn).reshape(shape).to(x.dtype)


@pytest.mark.parametrize("seed", [1, 2])
def test_fake_quantize_q4_1_bit_identical_to_before(seed):
    x = torch.from_numpy(_acts(seed, rows=4) * np.float32(3.0))
    assert torch.equal(qmm.fake_quantize_q4_1(x), _parent_fake_quantize_q4_1(x))
    q, d, m = mv.quantize_activations_q4_1(x)
    assert torch.equal(mv.dequantize_activations_q4_1(q, d, m), _parent_fake_quantize_q4_1(x))
    xb = x.bfloat16()
    assert torch.equal(qmm.fake_quantize_q4_1(xb), _parent_fake_quantize_q4_1(xb))


@pytest.mark.parametrize("seed", [3, 4])
def test_quantizer_matches_jax(seed):
    x = _acts(seed, rows=3)
    q, d, m = mv.quantize_activations_q4_1(torch.from_numpy(x))
    assert float(q.min()) >= 0 and float(q.max()) <= 15 and torch.equal(q, q.trunc())
    assert float(d[0, 1]) == 0.0 and float(d[0, 2]) == 1.0  # the constant block; the tie block
    assert q[0, 66:96].tolist() == [j % 15 + 1 for j in range(2, 32)]  # k + ½ → k + 1, half away from 0
    want = np.asarray(jqmm.fake_quantize_q4_1(jnp.asarray(x)))
    np.testing.assert_array_equal(mv.dequantize_activations_q4_1(q, d, m).numpy(), want)
    np.testing.assert_array_equal(qmm.fake_quantize_q4_1(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------------------
# the matvec's plain version against the TPU kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("quantize_acts", [True, False], ids=["q4_1_acts", "f32_acts"])
def test_matvec_plain_matches_tpu_kernel_interpret(w_np, w_t, quantize_acts, stacked):
    x = _acts(5)[0]
    y = mv.q4_1_matvec_plain(torch.from_numpy(x), w_t, quantize_acts=quantize_acts).numpy()
    v = Q4_1TensorV.from_q4_1(w_np)
    if stacked:  # layer 1 of a 2-layer stack whose layer 0 is another weight
        other = Q4_1TensorV.from_q4_1(Q4_1Tensor.quantize(np.ones((OUT, IN), np.float32)))
        vs = jax.tree_util.tree_map(lambda a, b: jnp.stack([jnp.asarray(a), jnp.asarray(b)]), other, v)
        yj = q4_1_vpu_matvec_stacked(jnp.asarray(x[None]), vs, 1, quantize_acts=quantize_acts, interpret=True)
    else:
        yj = q4_1_vpu_matvec(jnp.asarray(x[None]), v, quantize_acts=quantize_acts, interpret=True)
    assert _rel(y, np.asarray(yj)[0]) <= MATVEC_BAR
    if quantize_acts:  # the CPU wrapper is the plain version
        assert torch.equal(mv.q4_1_matvec(torch.from_numpy(x), w_t), torch.from_numpy(y))


def test_matvec_matches_fake_quant_dense_dot(w_np, w_t):
    x = _acts(6)[0]
    y = mv.q4_1_matvec(torch.from_numpy(x), w_t).numpy()
    ref = np.asarray(jqmm.fake_quantize_q4_1(jnp.asarray(x))) @ np.asarray(jqmm.dequantize_q4_1_jnp(w_np)).T
    assert _rel(y, ref) <= MATVEC_BAR


def test_weight_layout_and_layer_view(w_np, w_t):
    """d and m are views of one [out, nb, 2] tensor (one 8-byte load a
    block); a layer of a stack is a view, never a copy."""
    assert w_t.dm.shape == (OUT, IN // 32, 2) and w_t.dm.is_contiguous()
    np.testing.assert_array_equal(w_t.d.numpy(), w_np.scales)
    np.testing.assert_array_equal(w_t.m.numpy(), w_np.mins)
    assert w_t.d.data_ptr() == w_t.dm.data_ptr()
    stacked = mv.Q4_1Weight(torch.stack([w_t.qs, w_t.qs]), torch.stack([w_t.dm, w_t.dm]))
    layer = stacked.layer(1)
    assert layer.qs.data_ptr() == stacked.qs[1].data_ptr() and layer.dm.data_ptr() == stacked.dm[1].data_ptr()
    assert layer.shape == (OUT, IN)


def test_wrappers_reject_non_cpu_tensors(w_t):
    """A tensor that is not on the CPU never reaches a plain version."""
    with pytest.raises(ValueError):
        mv.q4_1_matvec(torch.zeros(IN, device="meta"), w_t)
    meta = mv.Q4_1Weight(w_t.qs.to("meta"), w_t.dm.to("meta"))
    with pytest.raises(ValueError):
        dq.q4_1_dequant(meta, torch.float16)


# ---------------------------------------------------------------------------
# the dequant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_bit_exact_vs_jax(w_np, w_t, dtype):
    dense = dq.q4_1_dequant(w_t, getattr(torch, dtype)).float().numpy()
    want = np.asarray(jqmm.dequantize_q4_1_jnp(w_np, dtype=getattr(jnp, dtype)).astype(jnp.float32))
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(dq.dequantize_q4_1(w_t).numpy(), w_np.dequantize())


def _logical_order(dense_pm: np.ndarray) -> np.ndarray:
    """Undo the TPU kernel's phase-major order: column p·kh4 + g·nb + b holds
    element 32b + 8g + p (q4_dequant_pallas.py:11-28)."""
    out, in_dim = dense_pm.shape
    return dense_pm.reshape(out, 8, 4, in_dim // 32).transpose(0, 3, 2, 1).reshape(out, in_dim)


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_vs_tpu_kernel_interpret(w_np, w_t, dtype, stacked):
    """The TPU kernel under XLA's interpreter contracts ``n·d + m`` into a
    fused multiply-add (one rounding), where the port, ggml and
    dequantize_q4_1_jnp round the product and then the sum.  So the kernel
    equals the FMA exactly, and the port's f32 values lie within half an ulp
    of the product ``n·d`` plus one ulp of the result of it (the port's
    extra rounding of the product, and each side's rounding of the sum)."""
    v = Q4_1TensorV.from_q4_1(w_np)
    jdt = getattr(jnp, dtype)
    if stacked:
        qs, sm = jnp.stack([v.qs4v, v.qs4v * 0]), jnp.stack([v.sm_v, v.sm_v * 0])
        pm = q4v_dequant_pm_stacked(0, qs, sm, is_q41=True, dtype=jdt, interpret=True)
    else:
        pm = q4v_dequant_pm(jnp.asarray(v.qs4v), jnp.asarray(v.sm_v), is_q41=True, dtype=jdt, interpret=True)
    kernel = _logical_order(np.asarray(pm.astype(jnp.float32)))
    n = mv.unpack_nibbles(w_t.qs).double().numpy()
    nd = n * np.repeat(w_np.scales.astype(np.float64), 32, axis=1)  # exact in f64
    fma = (nd + np.repeat(w_np.mins.astype(np.float64), 32, axis=1)).astype(np.float32)
    np.testing.assert_array_equal(kernel, np.asarray(jnp.asarray(fma).astype(jdt).astype(jnp.float32)))
    port = dq.q4_1_dequant(w_t, torch.float32).double().numpy()
    ulp = lambda a: np.spacing(np.abs(a).astype(np.float32)).astype(np.float64)  # noqa: E731
    assert np.all(np.abs(port - fma) <= 0.5 * ulp(nd) + ulp(fma))
    assert not np.array_equal(port, fma)  # the two roundings do differ somewhere


# ---------------------------------------------------------------------------
# linear and the embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 8])
def test_linear_matches_jax(w_np, w_t, rows):
    """One row takes the matvec, more rows fake-quantize and dequantize
    (there is no Q4_1 multi-row kernel).  With f32 activations one row still
    takes the matvec (its f32-activation form), as the JAX ``linear`` sends
    it to ``q4_1_vpu_matvec(quantize_acts=False)``; more rows multiply the
    dequantized weight."""
    x = _acts(7, rows)
    y = qmm.linear(torch.from_numpy(x), w_t).numpy()
    assert _rel(y, np.asarray(jqmm.linear(jnp.asarray(x), w_np))) <= MATVEC_BAR
    x0 = torch.from_numpy(x[0])
    y0 = qmm.linear(x0[None], w_t, quantize_activations=False)[0]
    yj = q4_1_vpu_matvec(jnp.asarray(x[:1]), Q4_1TensorV.from_q4_1(w_np), quantize_acts=False, interpret=True)
    assert _rel(y0.numpy(), np.asarray(yj)[0]) <= 2e-5
    assert torch.equal(y0, mv.q4_1_matvec_plain(x0, w_t, quantize_acts=False))
    if rows > 1:
        xt = torch.from_numpy(x)
        assert torch.equal(qmm.linear(xt, w_t, quantize_activations=False), xt @ dq.dequantize_q4_1(w_t).t())


def test_embedding_lookup_matches_jax(w_np, w_t):
    tokens = np.array([0, 5, 255, 5, 17])
    rows = qmm.embedding_lookup(torch.from_numpy(tokens), w_t).numpy()
    np.testing.assert_array_equal(rows, np.asarray(jqmm.embedding_lookup(jnp.asarray(tokens), w_np)))
    v = Q4_1TensorV.from_q4_1(w_np)
    np.testing.assert_array_equal(rows, np.asarray(jqmm.embedding_lookup(jnp.asarray(tokens), v)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _model_cfg(**kw):
    return ModelConfig(n_vocab=512, n_embd=256, n_mult=256, n_head=2, n_layer=2, n_rot=128,
                       ftype=GGMLType.Q4_1, n_ctx=128, scan_layers=False, **kw)


@pytest.fixture(scope="module")
def model_tensors():
    dense = jllama.random_params(_model_cfg(), seed=11)
    return {k: (Q4_1Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}


def _port_params(tensors, tcfg):
    return tllama.params_from_tensors({k: _port(v) for k, v in tensors.items()}, tcfg, device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("layout", ["none", "v"])
def test_params_carried_across_exactly(model_tensors, layout, fused):
    cfg = _model_cfg(fuse_layer_matmuls=fused)
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, q4_layout=layout)
    leaves = [jp["tok_embeddings"], jp["layers_stacked"]["wo"]]
    assert all(hasattr(a, "sm_v" if layout == "v" else "mins") for a in leaves)
    carried = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), _tcfg(cfg), device="cpu")
    direct = _port_params(model_tensors, _tcfg(cfg))
    assert set(carried["layers_stacked"]) == set(direct["layers_stacked"])
    pairs = [(carried[k], direct[k]) for k in ("tok_embeddings", "output")]
    pairs += [(carried["layers_stacked"][k], v) for k, v in direct["layers_stacked"].items()]
    for got, want in pairs:
        assert type(got) is type(want)
        if isinstance(want, mv.Q4_1Weight):
            assert torch.equal(got.qs, want.qs) and torch.equal(got.dm, want.dm)
        else:
            assert torch.equal(got, want)
    assert isinstance(direct["layers_stacked"]["w13" if fused else "w1"], mv.Q4_1Weight)


@pytest.mark.parametrize("layout", ["none", "v"])
def test_model_matches_jax(model_tensors, layout):
    """Prefill (fake-quant + dequant + one matmul per product) and three
    decode steps (the matvec) against JAX forward, logits within 1e-5."""
    cfg = _model_cfg()
    tcfg = _tcfg(cfg)
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, q4_layout=layout)
    params = _port_params(model_tensors, tcfg)
    jc, tc = jllama.init_cache(cfg), tllama.init_cache(tcfg, device="cpu")
    prompt = [1, 17, 300, 42, 99]
    lj, jc = jllama.prefill(jp, jnp.asarray(prompt, jnp.int32), jnp.int32(0), jc, cfg)
    lt, tc = tllama.prefill(params, torch.tensor(prompt), 0, tc, tcfg)
    assert _rel(lt.numpy(), lj) <= MODEL_BAR
    for i, tok in enumerate([7, 311, 2]):
        dj, jc = jllama.decode_step(jp, jnp.int32(tok), jnp.int32(len(prompt) + i), jc, cfg)
        dt, tc = tllama.decode_step(params, torch.tensor(tok), len(prompt) + i, tc, tcfg)
        assert _rel(dt.numpy(), dj) <= MODEL_BAR, i


@pytest.fixture
def spy(monkeypatch):
    """The model's calls of the whole-stack Q4_0 kernel's wrapper."""
    calls = []
    real = tllama.fused_layers_block

    def wrapped(*args, **kwargs):
        calls.append(args[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tllama, "fused_layers_block", wrapped)
    return calls


def test_fused_q4_1_decodes_composed(model_tensors, spy):
    """Fused Q4_1 params meet every other condition of the whole-stack
    kernel (one token, no slot, float cache, quantized activations, 128-dim
    heads), which reads Q4_0 weights only: the JAX package leaves fused
    Q4_1 outside its W layout, so it decodes on the composed path.  Before
    the condition checked the weight type, this decode reached the kernel."""
    logits = {}
    for fused in (False, True):
        tcfg = _tcfg(_model_cfg(fuse_layer_matmuls=fused))
        params = _port_params(model_tensors, tcfg)
        cache = tllama.init_cache(tcfg, device="cpu")
        _, cache = tllama.prefill(params, torch.tensor([1, 2, 3]), 0, cache, tcfg)
        assert "wqkv" in params["layers_stacked"] if fused else "wq" in params["layers_stacked"]
        assert not tllama._takes_megakernel(params["layers_stacked"], 1, None, cache, tcfg)
        logits[fused], _ = tllama.decode_step(params, torch.tensor(4), 3, cache, tcfg)
    assert spy == []
    assert _rel(logits[True].numpy(), logits[False].numpy()) <= MODEL_BAR


PROMPTS = [[1, 17, 300, 42, 99], [1, 260, 7], [1, 5, 6, 7, 8, 9, 10, 11, 12]]
STEP_TOKENS = [[4, 6, 9, 0], [77, 3, 210, 0], [5, 411, 2, 0]]  # slot 3 idle


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_forward_batched_matches_batch1(model_tensors, paged):
    """Slot prefills and forward_batched rows (fake-quant + dequant + one
    matmul) against batch-1 prefill and decode_step (the matvec) of the
    same requests, logits within 1e-5."""
    tcfg = _tcfg(_model_cfg())
    params = _port_params(model_tensors, tcfg)
    if paged:
        cache = tllama.init_cache_paged(tcfg, 8, 4, page=64, device="cpu")
        cache["page_table"][:3, 0] = torch.tensor([4, 2, 0], dtype=torch.int32)
    else:
        cache = tllama.init_cache_batched(tcfg, 4, device="cpu")
    rows = []
    for b, ids in enumerate(PROMPTS):
        lg, cache = tllama.forward(params, torch.tensor(ids), 0, cache, tcfg, slot=b)
        rows.append([lg[-1].numpy()])
    n_pasts = np.array([len(p) for p in PROMPTS] + [0])
    for toks in STEP_TOKENS:
        lg, cache = tllama.forward_batched(params, torch.tensor(toks), n_pasts, cache, tcfg)
        for b in range(3):
            rows[b].append(lg[b].numpy())
        n_pasts[:3] += 1
    for b, ids in enumerate(PROMPTS):
        c1 = tllama.init_cache(tcfg, device="cpu")
        lg, c1 = tllama.prefill(params, torch.tensor(ids), 0, c1, tcfg)
        want = [lg[-1].numpy()]
        for s, toks in enumerate(STEP_TOKENS):
            lg, c1 = tllama.decode_step(params, torch.tensor(toks[b]), len(ids) + s, c1, tcfg)
            want.append(lg.numpy())
        for got, w in zip(rows[b], want):
            assert _rel(got, w) <= MODEL_BAR, b


@pytest.fixture(scope="module")
def q4_1_file(tmp_path_factory, tiny_cfg, tiny_tensors, tiny_vocab_pieces):
    cfg = dataclasses.replace(tiny_cfg, ftype=GGMLType.Q4_1)
    tensors = {k: (Q4_1Tensor.quantize(v) if v.ndim == 2 else v) for k, v in tiny_tensors.items()}
    path = str(tmp_path_factory.mktemp("tq41") / "ggml-model-q4_1.bin")
    jggml.write_model_file(path, cfg, tiny_vocab_pieces, tensors)
    return path


@pytest.mark.parametrize("device_sampling", [True, False])
def test_runner_serves_q4_1_file_as_jax(q4_1_file, device_sampling):
    prompt = "the rain in"
    jax_toks = [e.token for e in JaxRunner(q4_1_file, n_ctx=64, prefill_bucket=8).run_events(
        prompt, JRunnerConfig(num_tokens=8, device_sampling=device_sampling,
                              sampling=JSamplingConfig(seed=7, top_k=1))) if e.kind.value == "outputToken"]
    runner = LlamaRunner(q4_1_file, n_ctx=64, prefill_bucket=8, device="cpu")
    port_toks = [e.token for e in runner.run_events(
        prompt, RunnerConfig(num_tokens=8, device_sampling=device_sampling,
                             sampling=SamplingConfig(seed=7, top_k=1))) if e.kind.value == "outputToken"]
    assert isinstance(runner.params["layers_stacked"]["wq"], mv.Q4_1Weight)
    assert len(jax_toks) > 8 and port_toks == jax_toks


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_serves_q4_1_as_runner(q4_1_file, tiny_vocab_pieces, paged):
    """Two seeded streams through the Engine (batched steps dequantize)
    give the tokens LlamaRunner gives each alone (batch-1 matvec), all
    sampled on the host from the request's numpy stream."""
    runner = LlamaRunner(q4_1_file, n_ctx=64, prefill_bucket=8, device="cpu")
    runner.ensure_loaded()
    vocab = Vocab(tiny_vocab_pieces)
    kw = dict(paged_pages=9, page=16) if paged else {}
    eng = Engine(runner.params, runner.config, vocab, max_slots=2, prefill_bucket=8, **kw)
    prompts = ["the rain", "he said"]
    handles = [eng.submit(p, SamplingConfig(seed=7 + i, n_predict=6)) for i, p in enumerate(prompts)]
    for _ in range(200):
        if not any(s.handle is not None for s in eng.slots) and eng._pending.empty():
            break
        eng.step()
    for i, (p, h) in enumerate(zip(prompts, handles)):
        events = runner.run_events(p, RunnerConfig(num_tokens=6, device_sampling=False,
                                                   sampling=SamplingConfig(seed=7 + i)))
        alone = [e.token for e in events if e.kind.value == "outputToken"]
        assert [vocab.piece_str(t) for t in h.token_ids] == alone


def test_cli_serves_q4_1_file(q4_1_file, capsys):
    from llama_swift_torch import cli

    assert cli.main(["--model", q4_1_file, "--device", "cpu", "--prompt", "the rain", "--n-tokens", "4",
                     "--n-ctx", "64", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "Done." in out and "Failed" not in out and "tok/s decode" in out
