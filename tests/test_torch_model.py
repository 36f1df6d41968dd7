"""The port's whole forward pass (llama_swift_torch/models/llama.py) against
the JAX package's forward and the independent numpy reference
(tests/reference_model.py), at a small Q4_0 config with 128-dim heads:
JAX params built in the V layout carried across by params_from_jax_numpy,
then prefill + decode logits within the repo's 2e-3 parity bar."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType, ModelConfig
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.models import llama as tllama
from reference_model import forward_ref

PROMPT = [1, 17, 300, 42, 99, 5, 260, 7]
N_DECODE = 4
BAR = 2e-3


@pytest.fixture(scope="module")
def cfg():
    return ModelConfig(n_vocab=512, n_embd=256, n_mult=256, n_head=2, n_layer=2,
                       n_rot=128, ftype=GGMLType.Q4_0, n_ctx=256)


@pytest.fixture(scope="module")
def tcfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def tensors(cfg):
    dense = jllama.random_params(cfg, seed=11)
    return {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _decode_tokens():
    return [int(t) for t in np.random.default_rng(5).integers(2, 512, N_DECODE)]


@pytest.fixture(scope="module")
def port_logits(cfg, tcfg, tensors):
    jparams = jllama.params_from_tensors(tensors, cfg, q4_layout="v")
    params = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    cache = tllama.init_cache(tcfg, device="cpu")
    logits, cache = tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
    steps = [logits.numpy()]
    for i, tok in enumerate(_decode_tokens()):
        lg, cache = tllama.decode_step(params, torch.tensor(tok), len(PROMPT) + i, cache, tcfg)
        steps.append(lg.numpy()[None])
    return steps, jparams


def test_params_from_jax_numpy_roundtrip(cfg, tcfg, tensors, port_logits):
    """V-layout words unpack to the file's logical bytes, padding dropped."""
    _, jparams = port_logits
    params = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    w2 = tensors["layers.1.feed_forward.w2.weight"]
    got = params["layers_stacked"]["w2"].layer(1)
    np.testing.assert_array_equal(got.qs.numpy(), w2.qs)
    np.testing.assert_array_equal(got.d.numpy(), w2.scales)
    direct = tllama.params_from_tensors(
        {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor) else v) for k, v in tensors.items()},
        tcfg, device="cpu")
    np.testing.assert_array_equal(direct["output"].qs.numpy(), params["output"].qs.numpy())
    np.testing.assert_array_equal(direct["layers_stacked"]["wq"].qs.numpy(),
                                  params["layers_stacked"]["wq"].qs.numpy())


def test_logits_match_jax_forward(cfg, port_logits):
    steps, jparams = port_logits
    cache = jllama.init_cache(cfg)
    lg, cache = jllama.prefill(jparams, jnp.asarray(PROMPT, jnp.int32), jnp.int32(0), cache, cfg)
    assert _rel(steps[0], lg) <= BAR
    for i, tok in enumerate(_decode_tokens()):
        lg, cache = jllama.decode_step(jparams, jnp.int32(tok), jnp.int32(len(PROMPT) + i), cache, cfg)
        assert _rel(steps[i + 1][0], lg) <= BAR, i


def test_logits_match_numpy_reference(cfg, tensors, port_logits):
    steps, _ = port_logits
    dense = {k: (v.dequantize() if isinstance(v, Q4_0Tensor) else v) for k, v in tensors.items()}
    kv_k = np.zeros((cfg.n_layer, cfg.n_ctx, cfg.n_head, cfg.head_dim), np.float32)
    kv_v = np.zeros_like(kv_k)
    ref = forward_ref(dense, cfg, PROMPT, kv_k, kv_v, 0, quantize_activations=True)
    assert _rel(steps[0], ref) <= BAR
    for i, tok in enumerate(_decode_tokens()):
        ref = forward_ref(dense, cfg, [tok], kv_k, kv_v, len(PROMPT) + i, quantize_activations=True)
        assert _rel(steps[i + 1], ref) <= BAR, i


def test_greedy_decode_loop_matches_decode_steps(tcfg, tensors, port_logits):
    steps, jparams = port_logits
    params = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    cache = tllama.init_cache(tcfg, device="cpu")
    logits, cache = tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
    first = logits[-1].argmax()
    toks, _ = tllama.greedy_decode_loop(params, first, len(PROMPT), cache, tcfg, 3)
    cache = tllama.init_cache(tcfg, device="cpu")
    _, cache = tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
    tok, expect = first, []
    for i in range(3):
        lg, cache = tllama.decode_step(params, tok, len(PROMPT) + i, cache, tcfg)
        tok = lg.argmax()
        expect.append(int(tok))
    assert toks.tolist() == expect


def test_random_params_match_jax(cfg, tcfg):
    ours, theirs = tllama.random_params(tcfg, seed=3), jllama.random_params(cfg, seed=3)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_pad_tokens():
    padded, n = tllama.pad_tokens([5, 6, 7], 8)
    assert n == 3 and padded.tolist() == [5, 6, 7, 0, 0, 0, 0, 0]
    np.testing.assert_array_equal(padded, jllama.pad_tokens([5, 6, 7], 8)[0])
