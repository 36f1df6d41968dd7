"""The port's two-kernels-per-layer blocks (llama_swift_torch/ops/fused_layer.py:
``fused_attn_block``, ``fused_ffn_block`` and ``ops/q4_matmul.from_jax_w``)
against the JAX package, on the CPU, where each wrapper takes its plain
version (the CUDA kernels of csrc/fused_blocks.cu are held against those on
the card by tests/test_torch_cuda.py and chip_smoke.py).  Inputs come from
numpy seeds, at the shapes of tests/test_fused_layer.py.

* The FFN block (D 512, F 1408) against JAX ``fused_ffn_block`` in interpret
  mode: the delta within 3e-4 (rtol and atol), the JAX test's bar.
* The attention block (H 4, head dim 128, n_ctx 256, n_past 0, 67 and 130,
  f32 and bf16 caches) against JAX ``fused_attn_block`` in interpret mode:
  the delta within 5e-4 and k_new/v_new within 2e-5 (rtol and atol), the JAX
  test's bars (on a bf16 cache k_new/v_new are rounded to bf16 from f32
  values that differ by ulps, so there each element is within one bf16 step,
  2^-7 of its value), wherever the two quantize ctx alike; on a bf16 cache at
  n_past 0 the position attends only its own bf16-rounded v row and the 4-bit
  quantization of ctx can meet exact ``k + 1/2`` ties, which XLA rounds
  otherwise than the port (see tests/test_torch_fused_layer.py), and then
  every differing code must sit on such a tie.  The port's caches are
  unchanged by a call.
* ``from_jax_w`` carries the JAX W-layout leaves (λ-permuted blocks, in-dim
  padded to 4096), single and stacked, back to the logical bytes.
* Two layers of the plain blocks, the caller writing k_new/v_new at n_past
  and adding each delta, equal ``fused_layers_block_plain`` on the same
  token within 5e-4.
* An int8 cache, a head dim other than 128 and a w13 built with
  ``fuse_shards > 1`` raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models.llama import _concat_out, _pad_weight
from llama_swift_tpu.ops import q4_fused_layer as jfl
from llama_swift_torch.ops import fused_layer as fl
from llama_swift_torch.ops.q4_matmul import from_jax_w
from llama_swift_torch.ops.q4_matvec import Q4_0Weight, quantize_activations_q4_0_int

FFN_BAR = 3e-4  # tests/test_fused_layer.py::test_fused_ffn_block (rtol and atol)
ATTN_BAR = 5e-4  # tests/test_fused_layer.py::test_fused_attn_block, the delta
KV_BAR = 2e-5  # the same test, k_new and v_new
CHAIN_BAR = 5e-4  # two layers of blocks against the whole-stack plain version, relative


def _q4(rng, out, in_dim):
    return Q4_0Tensor.quantize((rng.standard_normal((out, in_dim)) * 0.05).astype(np.float32))


def _w(tensors):
    """JAX W-layout leaves of a stack of logical tensors, carried across."""
    packed = [jfl.Q4_0TensorW.from_q4_0(_pad_weight(t, in_to=4096)) for t in tensors]
    qs4w, scales_w = jnp.stack([p.qs4w for p in packed]), jnp.stack([p.scales_w for p in packed])
    return (qs4w, scales_w), from_jax_w(np.asarray(qs4w), np.asarray(scales_w), tensors[0].shape[1])


def _tie_flips(x: np.ndarray) -> tuple[int, bool]:
    """Codes that XLA and the port quantize differently from the same
    values, and whether each of them sits on an exact tie."""
    port = quantize_activations_q4_0_int(torch.from_numpy(x))[0].reshape(-1, 32).numpy()
    hb = jnp.asarray(x.reshape(-1, 32))
    d = jnp.max(jnp.abs(hb), axis=1) / 7.0
    inv = jnp.where(d > 0, 1.0 / jnp.where(d > 0, d, 1.0), 0.0)
    diff = np.asarray(jnp.trunc(hb * inv[:, None] + jnp.where(hb >= 0, 0.5, -0.5))) != port
    xb = np.abs(x.astype(np.float64).reshape(-1, 32))
    t = 7.0 * xb / xb.max(axis=1, keepdims=True)
    return int(diff.sum()), bool(np.all(t[diff] % 1.0 == 0.5))


def test_from_jax_w_round_trips():
    rng = np.random.default_rng(1)
    ts = [_q4(rng, 256, 1408) for _ in range(2)]
    (qs4w, scales_w), w = _w(ts)
    for il, t in enumerate(ts):
        np.testing.assert_array_equal(w.layer(il).qs.numpy(), t.qs)
        np.testing.assert_array_equal(w.layer(il).d.numpy(), t.scales)
        single = from_jax_w(np.asarray(qs4w[il]), np.asarray(scales_w[il]), 1408)
        np.testing.assert_array_equal(single.qs.numpy(), t.qs)
        np.testing.assert_array_equal(single.d.numpy(), t.scales)
        back = jfl.Q4_0TensorW(scales_w=scales_w[il], qs4w=qs4w[il]).to_q4_0()
        np.testing.assert_array_equal(np.asarray(back.qs)[:, : 1408 // 2], t.qs)


def test_ffn_block_matches_jax():
    D, F = 512, 1408
    rng = np.random.default_rng(0)
    w1, w3, w2 = _q4(rng, F, D), _q4(rng, F, D), _q4(rng, D, F)
    (j13, w13), (j2, w2t) = _w([_concat_out([w1, w3])]), _w([w2])
    x = (rng.standard_normal(D) * 0.3).astype(np.float32)
    nw = (1.0 + 0.05 * rng.standard_normal(D)).astype(np.float32)
    out = jfl.fused_ffn_block(jnp.asarray(x)[None], jnp.asarray(nw)[None], *j13, *j2, jnp.int32(0), ff_real=F,
                              interpret=True)
    want = np.asarray(out)[:, 0, :].reshape(D)
    got = fl.fused_ffn_block(torch.from_numpy(x), torch.from_numpy(nw), w13, w2t, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=FFN_BAR, atol=FFN_BAR)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_past", [0, 67, 130])
def test_attn_block_matches_jax(n_past, cache_dtype):
    H, n_ctx = 4, 256
    D = H * fl.HEAD_DIM
    rng = np.random.default_rng(10 + n_past)
    wq, wk, wv, wo = (_q4(rng, D, D) for _ in range(4))
    jqkv, wqkv = _w([_concat_out([wq, wk, wv])])
    jwo, wot = _w([wo])
    x = (rng.standard_normal(D) * 0.3).astype(np.float32)
    nw = (1.0 + 0.05 * rng.standard_normal(D)).astype(np.float32)
    kc = (rng.standard_normal((1, H, n_ctx, fl.HEAD_DIM)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((1, H, n_ctx, fl.HEAD_DIM)) * 0.5).astype(np.float32)
    kc[:, :, n_past:], vc[:, :, n_past:] = 1e4, -1e4  # the block reads only j < n_past
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    cos, sin = jfl.rope_vectors(jnp.int32(n_past), fl.HEAD_DIM)
    xo, jk, jv = jfl.fused_attn_block(
        jnp.asarray(x)[None], jnp.asarray(nw)[None], cos, sin, *jqkv, *jwo, jnp.asarray(kc, jdt),
        jnp.asarray(vc, jdt), jnp.int32(0), jnp.int32(n_past), ctx_chunk=128, interpret=True)
    tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    tk0, tv0 = tk.clone(), tv.clone()
    trace = []
    delta, k_new, v_new = fl.fused_attn_block(
        torch.from_numpy(x), torch.from_numpy(nw), torch.from_numpy(np.array(cos)[0]),
        torch.from_numpy(np.array(sin)[0]), wqkv, wot, tk, tv, 0, n_past, trace=trace)
    assert torch.equal(tk, tk0) and torch.equal(tv, tv0)  # the cache is only read
    for got, want in ((k_new.numpy(), np.asarray(jk)), (v_new.numpy(), np.asarray(jv))):
        if cache_dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=KV_BAR, atol=KV_BAR)
        else:  # rounded to bf16 from f32 values that differ by ulps: within one bf16 step
            assert np.all(np.abs(got - want) <= np.abs(want) * 2.0**-7)
    flips, all_ties = _tie_flips(trace[0][D:].numpy())  # ctx, wo's input
    if flips == 0:
        np.testing.assert_allclose(delta.numpy(), np.asarray(xo)[:, 0, :].reshape(D), rtol=ATTN_BAR,
                                   atol=ATTN_BAR)
    else:  # exact ties only: a bf16 v row attended alone
        assert all_ties and (n_past, cache_dtype) == (0, "bfloat16"), flips


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_two_layers_of_blocks_equal_the_whole_stack(cache_dtype):
    """The r4 decode step (attention block, the caller's write of k_new and
    v_new at n_past, residual, FFN block, residual, per layer) against the
    whole-stack plain version on the same token and cache."""
    H, L, n_ctx, F, n_past = 2, 2, 256, 768, 70
    D = H * fl.HEAD_DIM
    g = torch.Generator().manual_seed(5)

    def stack(out, in_dim):
        qs = torch.randint(0, 256, (L, out, in_dim // 2), dtype=torch.uint8, generator=g)
        return Q4_0Weight(qs, torch.rand((L, out, in_dim // 32), generator=g) * (2.0 / (4.6 * in_dim**0.5)))

    wqkv, wo, w13, w2 = stack(3 * D, D), stack(D, D), stack(2 * F, D), stack(D, F)
    an, fn = (1.0 + 0.05 * torch.randn((L, D), generator=g) for _ in range(2))
    x = torch.randn(D, generator=g)
    kc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), generator=g).to(cache_dtype)
    vc = torch.randn((L, H, n_ctx, fl.HEAD_DIM), generator=g).to(cache_dtype)
    kw, vw = kc.clone(), vc.clone()
    want = fl.fused_layers_block_plain(x, an, fn, wqkv, wo, w13, w2, kw, vw, n_past)
    cos, sin = fl.rope_vectors(n_past)
    got = x.clone()
    for il in range(L):
        delta, k_new, v_new = fl.fused_attn_block(got, an[il], cos, sin, wqkv, wo, kc, vc, il, n_past)
        kc[il, :, n_past], vc[il, :, n_past] = k_new.to(cache_dtype), v_new.to(cache_dtype)
        got = got + delta
        got = got + fl.fused_ffn_block(got, fn[il], w13, w2, il)
    assert torch.equal(kc, kw) and torch.equal(vc, vw)  # the same rows written
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= CHAIN_BAR, err


def test_blocks_refuse_what_the_jax_blocks_lack():
    H, L, n_ctx, D = 2, 1, 64, 256
    g = torch.Generator().manual_seed(0)
    w = Q4_0Weight(torch.zeros((L, 3 * D, D // 2), dtype=torch.uint8), torch.ones((L, 3 * D, D // 32)))
    wo = Q4_0Weight(torch.zeros((L, D, D // 2), dtype=torch.uint8), torch.ones((L, D, D // 32)))
    x, nw = torch.randn(D, generator=g), torch.ones(D)
    cos, sin = fl.rope_vectors(3)
    k8 = torch.zeros((L, H, n_ctx, fl.HEAD_DIM), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        fl.fused_attn_block(x, nw, cos, sin, w, wo, k8, k8.clone(), 0, 3)
    k64 = torch.zeros((L, 2 * H, n_ctx, 64))
    with pytest.raises(ValueError, match="head dim"):
        fl.fused_attn_block(x, nw, cos, sin, w, wo, k64, k64.clone(), 0, 3)
    F = 256
    w13 = Q4_0Weight(torch.zeros((L, 2 * F, D // 2), dtype=torch.uint8), torch.ones((L, 2 * F, D // 32)))
    w2 = Q4_0Weight(torch.zeros((L, D, F // 2), dtype=torch.uint8), torch.ones((L, D, F // 32)))
    assert fl.fused_ffn_block(x, nw, w13, w2, 0).shape == (D,)
    with pytest.raises(ValueError, match="fuse_shards"):
        fl.fused_ffn_block(x, nw, w13, w2, 0, fuse_shards=2)
