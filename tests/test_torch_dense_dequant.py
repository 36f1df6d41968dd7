"""Dense-dequant params in the port (``params_from_tensors(dense_dequant=True)``,
llama_swift_torch/models/llama.py) against the JAX package's, on the CPU,
where the dequant wrappers take their plain versions (the card's dequant
kernels are bit-exact to those: tests/test_torch_cuda.py, chip_smoke.py).

* Every leaf bit-equal to the JAX params' f32 leaves, for Q4_0 and Q4_1
  files, plain and fused; a bf16 build equal to ``dequantize()`` cast.
* Prefill and decode logits against JAX's dense params within 1e-5
  relative: the same dense f32 products, summed in other orders.
* Dense params against the port's own quantized params with
  ``quantize_activations=False`` within 2e-4 (the JAX package's bar in
  tests/test_model.py): dense weights carry no activation fake-quantization.
* No packed weight survives: the T layout and ``shard_pad`` pad but never
  tile, and the whole-stack kernel is never taken.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor, Q4_1Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.formats.quant import Q4_1Tensor as TQ4_1Tensor
from llama_swift_torch.models import llama as tllama

PROMPT = [1, 17, 200, 42, 99, 5]
DECODE = [7, 130, 64]
LOGIT_BAR = 1e-5
QUANT_BAR = 2e-4  # tests/test_model.py::test_dense_dequant_mode_matches_quantized


def _tcfg(cfg, **kw):
    return dataclasses.replace(TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _quantized(tensors, kind):
    cls = Q4_0Tensor if kind == "q4_0" else Q4_1Tensor
    return {k: (cls.quantize(v) if v.ndim == 2 else v) for k, v in tensors.items()}


def _port(tensors):
    def cvt(t):
        if isinstance(t, Q4_0Tensor):
            return TQ4_0Tensor(t.scales, t.qs)
        if isinstance(t, Q4_1Tensor):
            return TQ4_1Tensor(t.mins, t.scales, t.qs)
        return t
    return {k: cvt(v) for k, v in tensors.items()}


def _leaves(params):
    """{name: numpy array} of the port's params (stacked layers by name)."""
    out = {k: params[k] for k in ("tok_embeddings", "norm", "output")}
    out.update({f"layers.{k}": v for k, v in params["layers_stacked"].items()})
    for k, v in out.items():
        assert isinstance(v, torch.Tensor), f"{k} is still packed: {type(v).__name__}"
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module", params=["q4_0", "q4_1"])
def kind(request):
    return request.param


@pytest.fixture(scope="module")
def qtensors(tiny_tensors, kind):
    return _quantized(tiny_tensors, kind)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_dense_params_bit_equal_to_jax(tiny_cfg, qtensors, fused):
    cfg = dataclasses.replace(tiny_cfg, fuse_layer_matmuls=fused)
    jp = jllama.params_from_tensors(qtensors, cfg, param_dtype=jnp.float32, dense_dequant=True)
    tp = tllama.params_from_tensors(_port(qtensors), _tcfg(cfg), device="cpu", param_dtype=torch.float32,
                                    dense_dequant=True)
    got = _leaves(tp)
    want = {k: np.asarray(jp[k]) for k in ("tok_embeddings", "norm", "output")}
    want.update({f"layers.{k}": np.asarray(v) for k, v in jp["layers_stacked"].items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_dense_params_are_the_cast_dequantization(tiny_cfg, qtensors):
    tp = tllama.params_from_tensors(_port(qtensors), _tcfg(tiny_cfg), device="cpu", param_dtype=torch.bfloat16,
                                    dense_dequant=True)
    want = torch.from_numpy(qtensors["layers.1.attention.wk.weight"].dequantize()).to(torch.bfloat16)
    assert torch.equal(tp["layers_stacked"]["wk"][1], want)
    want = torch.from_numpy(qtensors["tok_embeddings.weight"].dequantize()).to(torch.bfloat16)
    assert torch.equal(tp["tok_embeddings"], want)
    assert tp["norm"].dtype == torch.float32


def _run(params, cfg, forward):
    """Prefill logits of PROMPT, then decode logits of DECODE."""
    cache = forward.init_cache(cfg)
    logits, cache = forward.prefill(params, forward.tokens(PROMPT), 0, cache, cfg)
    out = [np.asarray(logits)]
    for i, tok in enumerate(DECODE):
        lg, cache = forward.decode_step(params, forward.tokens([tok])[0], len(PROMPT) + i, cache, cfg)
        out.append(np.asarray(lg).reshape(1, -1))
    return out


class _Jax:
    init_cache = staticmethod(jllama.init_cache)
    prefill = staticmethod(jllama.prefill)
    decode_step = staticmethod(jllama.decode_step)

    @staticmethod
    def tokens(ids):
        return jnp.asarray(ids, dtype=jnp.int32)


class _Port:
    init_cache = staticmethod(lambda cfg: tllama.init_cache(cfg, device="cpu"))
    prefill = staticmethod(tllama.prefill)
    decode_step = staticmethod(tllama.decode_step)

    @staticmethod
    def tokens(ids):
        return torch.tensor(ids)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_dense_logits_match_jax(tiny_cfg, qtensors, fused):
    cfg = dataclasses.replace(tiny_cfg, fuse_layer_matmuls=fused)
    jp = jllama.params_from_tensors(qtensors, cfg, param_dtype=jnp.float32, dense_dequant=True)
    tcfg = _tcfg(cfg)
    tp = tllama.params_from_tensors(_port(qtensors), tcfg, device="cpu", param_dtype=torch.float32,
                                    dense_dequant=True)
    for got, want in zip(_run(tp, tcfg, _Port), _run(jp, cfg, _Jax)):
        assert _rel(got, want) <= LOGIT_BAR


def test_dense_matches_quantized_without_activation_quantization(tiny_cfg, qtensors):
    """Dense weights skip the activation fake-quantization even when the
    config asks for it, so they agree with packed weights on f32 rows."""
    tcfg = _tcfg(tiny_cfg)
    dense = tllama.params_from_tensors(_port(qtensors), tcfg, device="cpu", param_dtype=torch.float32,
                                       dense_dequant=True)
    packed = tllama.params_from_tensors(_port(qtensors), tcfg, device="cpu", param_dtype=torch.float32)
    f32_acts = dataclasses.replace(tcfg, quantize_activations=False)
    for got, want in zip(_run(dense, tcfg, _Port), _run(packed, f32_acts, _Port)):
        np.testing.assert_allclose(got, want, rtol=QUANT_BAR, atol=QUANT_BAR)


def test_dense_params_pad_but_never_tile(tiny_cfg, qtensors):
    tcfg = _tcfg(tiny_cfg, fuse_layer_matmuls=True)
    tp = tllama.params_from_tensors(_port(qtensors), tcfg, device="cpu", param_dtype=torch.float32,
                                    dense_dequant=True, q4_layout="t", shard_pad=384)
    leaves = _leaves(tp)  # every leaf a dense tensor
    assert leaves["output"].shape == (384, tcfg.n_embd)
    assert not leaves["output"][tcfg.n_vocab:].any()
    assert leaves["layers.w2"].shape == (tcfg.n_layer, tcfg.n_embd, 384)
    cache = tllama.init_cache(tcfg, device="cpu")
    assert not tllama._takes_megakernel(tp["layers_stacked"], 1, None, cache,
                                        dataclasses.replace(tcfg, n_embd=128 * tcfg.n_head))
