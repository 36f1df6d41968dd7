"""The port's fused path (llama_swift_torch/ops/fused_layer.py and the fused
params of llama_swift_torch/models/llama.py) against the JAX package, on the
CPU, where the whole-stack kernel's wrapper takes its plain version.

* block_perm equals the JAX one; W-layout and fused V-layout JAX params,
  carried across by params_from_jax_numpy, equal the port's own fused
  params byte for byte.
* fused_layers_block_plain against the JAX megakernel in interpret mode:
  x after the layers and the new K/V within 5e-4 relative, the bar of the
  JAX package's own fused tests (tests/test_fused_layer.py), wherever the
  two quantize every activation alike.  On a bf16 cache at n_past 0 they do
  not: the position attends only its own bf16-rounded v row, so the 4-bit
  quantization of ctx meets exact ``k + 1/2`` ties, which XLA rounds
  otherwise than the port (the int8 cache's hazard, ROADMAP §C); the test
  then shows that every differing code sits on such a tie.
* The whole model on fused params (prefill + 2 decode steps, f32 and bf16
  caches) against JAX forward with q4_layout="w" (its megakernel in
  interpret mode), logits within the repo's 2e-3 bar; the engine's slot
  prefill and forward_batched on fused params against JAX's fused V layout.
* The megakernel branch is taken only under the JAX package's conditions.
* The kernels' rebuild key follows the shared headers.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType, ModelConfig
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.models.llama import _concat_out, _pad_weight
from llama_swift_tpu.ops import q4_fused_layer as jfl
from llama_swift_tpu.runtime.engine import batched_decode, slot_prefill_chunk
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.ops import build
from llama_swift_torch.ops import fused_layer as fl
from llama_swift_torch.ops.q4_matvec import Q4_0Weight, quantize_activations_q4_0_int

BAR = 2e-3  # the repo's logit parity bar
KERNEL_BAR = 5e-4  # tests/test_fused_layer.py's bar for the fused kernels


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _tcfg(cfg, **kw):
    return dataclasses.replace(TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def _port_tensors(tensors):
    return {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor) else v) for k, v in tensors.items()}


# the config of tests/test_fused_layer.py::test_model_fused_matches_v_layout
def _model_cfg(**kw):
    return ModelConfig.tiny(n_ctx=128, n_embd=256, n_head=2, n_rot=128, n_vocab=256, n_mult=128, n_layer=2,
                            scan_layers=False, fuse_layer_matmuls=True, **kw)


@pytest.fixture(scope="module")
def model_tensors():
    dense = jllama.random_params(_model_cfg(), seed=7)
    return {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [8, 128, 384])
def test_block_perm_matches_jax(nb):
    np.testing.assert_array_equal(fl.block_perm(nb), jfl.block_perm(nb))


@pytest.mark.parametrize("layout", ["w", "v"])
def test_fused_params_carried_across_exactly(model_tensors, layout):
    """JAX fused params (W layout: blocks permuted by λ, in-dims padded to
    4096; or fused V layout) come across as the port's own fused params."""
    cfg = _model_cfg()
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, q4_layout=layout)
    assert {"wqkv", "w13"} <= set(jp["layers_stacked"])
    carried = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), _tcfg(cfg), device="cpu")
    direct = tllama.params_from_tensors(_port_tensors(model_tensors), _tcfg(cfg), device="cpu")
    assert set(direct["layers_stacked"]) == set(tllama.FUSED_LAYER_WEIGHTS)
    assert set(carried["layers_stacked"]) == set(direct["layers_stacked"])
    for name in ("wqkv", "wo", "w13", "w2"):
        got, want = carried["layers_stacked"][name], direct["layers_stacked"][name]
        assert torch.equal(got.qs, want.qs) and torch.equal(got.d, want.d), name
    # the fused rows are the file's rows, in q; k; v and w1; w3 order
    w = direct["layers_stacked"]["wqkv"].layer(1)
    parts = [model_tensors[f"layers.1.attention.{n}.weight"] for n in ("wq", "wk", "wv")]
    np.testing.assert_array_equal(w.qs.numpy(), np.concatenate([p.qs for p in parts]))
    np.testing.assert_array_equal(w.d.numpy(), np.concatenate([p.scales for p in parts]))


# ---------------------------------------------------------------------------
# the plain megakernel against the JAX megakernel (interpret mode)
# ---------------------------------------------------------------------------


@jax.jit
def _jax_codes(h):
    """The JAX megakernel's activation quantization (``_quant_prep``'s
    formula) under XLA, per 32-block of h."""
    hb = h.reshape(-1, 32)
    d = jnp.max(jnp.abs(hb), axis=1) / 7.0
    inv = jnp.where(d > 0, 1.0 / jnp.where(d > 0, d, 1.0), 0.0)
    return jnp.trunc(hb * inv[:, None] + jnp.where(hb >= 0, 0.5, -0.5))


def _tie_flips(trace: torch.Tensor) -> tuple[int, bool]:
    """Codes that XLA and the port quantize differently from the same
    quantizer inputs, and whether each of them sits on an exact tie."""
    port = quantize_activations_q4_0_int(trace)[0].reshape(-1, 32).numpy()
    diff = np.asarray(_jax_codes(jnp.asarray(trace.numpy().reshape(-1)))) != port
    xb = trace.double().reshape(-1, 32)
    t = (7.0 * xb.abs() / xb.abs().amax(dim=-1, keepdim=True)).numpy()
    return int(diff.sum()), bool(np.all(t[diff] % 1.0 == 0.5))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_past", [0, 67, 130])
def test_plain_matches_jax_megakernel(n_past, cache_dtype):
    H, L, n_ctx, F = 2, 2, 256, 768
    D = H * fl.HEAD_DIM
    rng = np.random.default_rng(n_past)

    def q4(out, in_dim):
        return [Q4_0Tensor.quantize((rng.standard_normal((out, in_dim)) * 0.05).astype(np.float32))
                for _ in range(L)]

    wq, wk, wv, wo, w1, w3, w2 = q4(D, D), q4(D, D), q4(D, D), q4(D, D), q4(F, D), q4(F, D), q4(D, F)
    wqkv = [_concat_out([a, b, c]) for a, b, c in zip(wq, wk, wv)]
    w13 = [_concat_out([a, b]) for a, b in zip(w1, w3)]
    x = (rng.standard_normal(D) * 0.3).astype(np.float32)
    an, fn = ((1.0 + 0.05 * rng.standard_normal((L, D))).astype(np.float32) for _ in range(2))
    kc = (rng.standard_normal((L, H, n_ctx, fl.HEAD_DIM)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((L, H, n_ctx, fl.HEAD_DIM)) * 0.5).astype(np.float32)
    kc[:, :, n_past:], vc[:, :, n_past:] = 1e4, -1e4  # never attended: n_past is the new row
    jdt = getattr(jnp, cache_dtype)

    def stack_w(ws):
        packed = [jfl.Q4_0TensorW.from_q4_0(_pad_weight(w, in_to=4096)) for w in ws]
        return jnp.stack([p.qs4w for p in packed]), jnp.stack([p.scales_w for p in packed])

    cos, sin = jfl.rope_vectors(jnp.int32(n_past), fl.HEAD_DIM)
    xo, k_new, v_new = jfl.fused_layers_block(
        jnp.asarray(x).reshape(H, -1), jnp.asarray(an).reshape(L, H, -1), jnp.asarray(fn).reshape(L, H, -1),
        cos, sin, *stack_w(wqkv), *stack_w(wo), *stack_w(w13), *stack_w(w2),
        jnp.asarray(kc, jdt), jnp.asarray(vc, jdt), n_past, ctx_chunk=128, interpret=True)

    def stack_t(ws):
        return Q4_0Weight(torch.from_numpy(np.stack([w.qs for w in ws])),
                          torch.from_numpy(np.stack([w.scales for w in ws]).astype(np.float32)))

    tdt = getattr(torch, cache_dtype)
    tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    trace = []
    out = fl.fused_layers_block(torch.from_numpy(x), torch.from_numpy(an), torch.from_numpy(fn), stack_t(wqkv),
                                stack_t(wo), stack_t(w13), stack_t(w2), tk, tv, n_past, trace=trace)
    assert torch.equal(tk[:, :, n_past + 1 :], torch.from_numpy(kc[:, :, n_past + 1 :]).to(tdt))
    errs = [_rel(out.numpy(), np.asarray(xo).reshape(D)), _rel(tk[:, :, n_past].float().numpy(), k_new),
            _rel(tv[:, :, n_past].float().numpy(), v_new)]
    flips, all_ties = _tie_flips(trace[0])
    if flips == 0:
        assert max(errs) <= KERNEL_BAR, errs
    else:  # exact ties only: bf16 v rows attended alone (see the module docstring)
        assert all_ties and (n_past, cache_dtype) == (0, "bfloat16"), (flips, errs)


def test_rope_vectors_match_jax():
    cos, sin = fl.rope_vectors(77)
    jcos, jsin = jfl.rope_vectors(jnp.int32(77), fl.HEAD_DIM)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos)[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin)[0], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole model and the engine path on fused params
# ---------------------------------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    """Counts the model's calls of the whole-stack kernel's wrapper (on the
    CPU its launch counter never moves: only a kernel launch counts)."""
    calls = []
    real = tllama.fused_layers_block

    def wrapped(*args, **kwargs):
        calls.append(args[-1])  # n_past
        return real(*args, **kwargs)

    monkeypatch.setattr(tllama, "fused_layers_block", wrapped)
    return calls


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_model_fused_matches_jax_w_layout(model_tensors, spy, cache_dtype):
    cfg = _model_cfg(kv_cache_dtype=cache_dtype)
    tcfg = _tcfg(cfg)
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, q4_layout="w")
    params = tllama.params_from_tensors(_port_tensors(model_tensors), tcfg, device="cpu")
    jc, tc = jllama.init_cache(cfg), tllama.init_cache(tcfg, device="cpu")
    lj, jc = jllama.prefill(jp, jnp.asarray([1, 5, 9], jnp.int32), jnp.int32(0), jc, cfg)
    lt, tc = tllama.prefill(params, torch.tensor([1, 5, 9]), 0, tc, tcfg)
    assert _rel(lt.numpy(), lj) <= BAR
    assert spy == []  # prefill takes the composed path
    for i, tok in enumerate([7, 11]):
        dj, jc = jllama.decode_step(jp, jnp.int32(tok), jnp.int32(3 + i), jc, cfg)
        dt, tc = tllama.decode_step(params, torch.tensor(tok), 3 + i, tc, tcfg)
        assert _rel(dt.numpy(), dj) <= BAR, i
    assert spy == [3, 4]  # one whole-stack call per decoded token
    np.testing.assert_allclose(tc["k"][:, :, :5].float().numpy(), np.asarray(jc["k"], np.float32)[:, :, :5],
                               rtol=KERNEL_BAR, atol=1e-6)


def test_fused_engine_path_matches_jax(model_tensors):
    """Slot prefill and forward_batched on fused params (serve.py's form:
    fused V layout) against the JAX package's engine helpers."""
    cfg = _model_cfg()
    tcfg = _tcfg(cfg)
    jp = jllama.params_from_tensors(model_tensors, cfg, param_dtype=jnp.float32, q4_layout="v")
    params = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    prompts, steps, B = [[1, 17, 30, 42, 99], [1, 26, 7]], [[4, 6, 0], [77, 3, 0]], 3
    jc, tc = jllama.init_cache_batched(cfg, B), tllama.init_cache_batched(tcfg, B, device="cpu")
    for b, ids in enumerate(prompts):
        lj, jc = slot_prefill_chunk(jp, jnp.asarray(ids, jnp.int32), jnp.int32(0), jnp.int32(b), jc, cfg)
        lt, tc = tllama.forward(params, torch.tensor(ids), 0, tc, tcfg, slot=b)
        assert _rel(lt.numpy(), lj) <= BAR, b
    n_pasts = np.array([len(p) for p in prompts] + [0])
    for toks in steps:
        lj, jc = batched_decode(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(n_pasts, jnp.int32), jc, cfg)
        lt, tc = tllama.forward_batched(params, torch.tensor(toks), n_pasts, tc, tcfg)
        assert _rel(lt.numpy()[:2], np.asarray(lj)[:2]) <= BAR
        n_pasts[:2] += 1


@pytest.mark.parametrize("case", ["taken", "int8_cache", "head_dim_64", "f32_activations", "unfused"])
def test_megakernel_only_under_jax_conditions(spy, case):
    """One decode step: the whole-stack kernel runs only with fused params,
    one token, no slot, no int8 scales, quantized activations and 128-dim
    heads (llama_swift_tpu/models/llama.py:899-906); otherwise the composed
    path runs."""
    kw = {"int8_cache": dict(kv_cache_dtype="int8"), "head_dim_64": dict(n_head=4, n_rot=64),
          "f32_activations": dict(quantize_activations=False),
          "unfused": dict(fuse_layer_matmuls=False)}.get(case, {})
    tcfg = _tcfg(ModelConfig.tiny(n_ctx=64, n_embd=256, n_head=2, n_rot=128, n_vocab=256, n_mult=128,
                                  n_layer=2, fuse_layer_matmuls=True, ftype=GGMLType.Q4_0), **kw)
    dense = tllama.random_params(tcfg, seed=3)
    tensors = {k: (TQ4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}
    params = tllama.params_from_tensors(tensors, tcfg, device="cpu")
    cache = tllama.init_cache(tcfg, device="cpu")
    _, cache = tllama.prefill(params, torch.tensor([1, 2, 3]), 0, cache, tcfg)
    logits, _ = tllama.decode_step(params, torch.tensor(4), 3, cache, tcfg)
    assert bool(torch.isfinite(logits).all())
    assert spy == ([3] if case == "taken" else [])


def test_runner_serves_fused_params(tmp_path, model_tensors, tiny_vocab_pieces, spy):
    """LlamaRunner(fuse_layer_matmuls=True) streams the same greedy tokens as
    the unfused runner, one whole-stack call per decoded token."""
    from llama_swift_tpu.formats import ggml
    from llama_swift_torch.config import RunnerConfig, SamplingConfig
    from llama_swift_torch.runtime.runner import LlamaRunner

    path = str(tmp_path / "model-q4_0.bin")
    ggml.write_model_file(path, dataclasses.replace(_model_cfg(), ftype=GGMLType.Q4_0), tiny_vocab_pieces,
                          model_tensors)
    rcfg = RunnerConfig(num_tokens=6, sampling=SamplingConfig(seed=7, top_k=1))
    streams = {}
    for fused in (False, True):
        runner = LlamaRunner(path, n_ctx=64, prefill_bucket=8, device="cpu", fuse_layer_matmuls=fused)
        streams[fused] = [e.token for e in runner.run_events("the rain in", rcfg) if e.kind.value == "outputToken"]
        assert ("wqkv" in runner.params["layers_stacked"]) == fused
    assert streams[True] == streams[False]
    assert len(spy) == 6  # the device sampler's 6 forwards, all on the fused runner


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def test_rebuild_key_follows_shared_headers(tmp_path):
    """An edit to a header under csrc/ changes every source's rebuild key
    (no nvcc needed: only the digest is computed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    before = {stem: build.source_digest(stem, str(csrc)) for stem in build.SOURCES}
    assert before == {stem: build.source_digest(stem) for stem in build.SOURCES}
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert "q4_common.cuh" in headers and "flash_common.cuh" in headers
    with open(csrc / "q4_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {stem: build.source_digest(stem, str(csrc)) for stem in build.SOURCES}
    assert all(after[stem] != before[stem] for stem in build.SOURCES)
