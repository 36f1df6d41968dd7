"""The port's int8 KV cache (llama_swift_torch/models/llama.py quantize_kv and
the int8 caches; the three int8 flash-decode wrappers of
llama_swift_torch/ops/attention.py) against the JAX package on the CPU.

* The write: codes and scales bit-exact against the numpy model of the JAX
  write (tests/test_attention.py), all-zero rows and exact .5 ties included.
* The kernels' plain versions against the JAX int8 kernels in interpret
  mode, within 1e-5 relative, with stale codes and scales beyond n_past and
  garbage page-table entries beyond the live pages.
* Batch 1, batched dense and paged: logits of the port and of JAX within the
  repo's 2e-3 bar, the JAX int8 kernels in interpret mode.
* The Engine on int8 caches, dense and paged: streams complete, pages come
  back, greedy tokens equal the batch-1 int8 path, chunked admission stays
  isolated (the scales follow the idle-lane rule).

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against them by chip_smoke.py and tests/test_torch_cuda.py.
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
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.ops.attention import (
    flash_decode_attention_batched_int8 as jflash_batched_int8,
    flash_decode_attention_paged_int8 as jflash_paged_int8,
    flash_decode_attention_stacked_int8 as jflash_stacked_int8,
)
from llama_swift_tpu.runtime.engine import batched_decode, slot_prefill_chunk
from llama_swift_tpu.runtime.runner import LlamaRunner as JLlamaRunner
from llama_swift_torch import Engine, RunnerConfig, SamplingConfig, Vocab
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.ops import attention as tatt
from llama_swift_torch.runtime.runner import LlamaRunner

BAR = 2e-3  # the repo's hardware parity bar for logits
REL = 1e-5  # kernels against their reference
STALE_CODE, STALE_SCALE = 127, 1e3  # beyond n_past: must never be attended


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _tcfg(cfg, **kw):
    return dataclasses.replace(TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def _np_quant(a):
    """The numpy model of the JAX int8 write (tests/test_attention.py:136-141)."""
    amax = np.abs(np.asarray(a)).max(axis=-1, keepdims=True)
    scale = amax / 127.0
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1), 0.0)
    qa = np.clip(np.round(np.asarray(a) * inv), -127, 127).astype(np.int8)
    return qa, scale.astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the write
# ---------------------------------------------------------------------------


def test_quantize_kv_bit_exact_against_numpy_model():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((4, 9, 128)) * rng.uniform(0.01, 30, (4, 9, 1))).astype(np.float32)
    a[1, 3] = 0.0  # an all-zero row: scale 0, codes 0
    a[2, 5] = -0.0
    codes, scale = tllama.quantize_kv(torch.from_numpy(a))
    want_codes, want_scale = _np_quant(a)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (4, 9, 1)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(scale.numpy(), want_scale)
    assert not codes[1, 3].any() and scale[1, 3].item() == 0.0 and scale[2, 5].item() == 0.0


def test_quantize_kv_rounds_ties_half_to_even():
    """amax 127 gives scale 1 and amax 254 scale 2 (inv exactly 0.5), so
    these values land on exact .5 ties after scaling."""
    row1 = np.zeros(32, np.float32)
    row1[:8] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5]
    row2 = np.zeros(32, np.float32)
    row2[:6] = [-254, 5, 7, -1, 3, 253]
    a = np.stack([row1, row2])
    codes, scale = tllama.quantize_kv(torch.from_numpy(a))
    assert scale[:, 0].tolist() == [1.0, 2.0]
    assert codes[0, :8].tolist() == [127, 2, -4, 0, 0, 2, -2, 126]
    assert codes[1, :6].tolist() == [-127, 2, 4, 0, 2, 126]
    np.testing.assert_array_equal(codes.numpy(), _np_quant(a)[0])


# ---------------------------------------------------------------------------
# (b) the kernels' plain versions against the JAX int8 kernels
# ---------------------------------------------------------------------------

L, H, C, D = 2, 4, 256, 128


def _stale(codes, scale, n):
    """Stale codes and scales beyond position n of the last-but-one axis."""
    codes[..., n + 1 :, :] = STALE_CODE
    scale[..., n + 1 :, :] = STALE_SCALE


def _quantized(shape, seed):
    rng = np.random.default_rng(seed)
    codes, scale = tllama.quantize_kv(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    return codes, scale


@pytest.mark.parametrize("n_past", [0, 5, 200])
def test_stacked_int8_plain_matches_jax_kernel(n_past):
    q = np.random.default_rng(1).standard_normal((H, D)).astype(np.float32)
    k8, ks = _quantized((L, H, C, D), 2)
    v8, vs = _quantized((L, H, C, D), 3)
    for t in ((k8, ks), (v8, vs)):
        _stale(t[0][1], t[1][1], n_past)
    got = tatt.flash_decode_attention_stacked_int8(torch.from_numpy(q), k8, v8, ks, vs, 1, n_past)
    want, _, _ = jflash_stacked_int8(jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
                                     jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jnp.int32(1),
                                     jnp.int32(n_past), chunk=128, interpret=True)
    assert got.shape == (H, D) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= REL
    # the same as dequantizing the cache and taking the f32 kernel's plain version
    deq = tatt.flash_decode_attention_plain(torch.from_numpy(q), k8.float() * ks, v8.float() * vs, 1, n_past)
    assert _rel(got.numpy(), deq.numpy()) <= REL


N_PASTS = [0, 100, C - 1]  # B = 3, spread


@pytest.fixture(scope="module")
def batched_int8():
    B = len(N_PASTS)
    q = np.random.default_rng(4).standard_normal((B, H, D)).astype(np.float32)
    k8, ks = _quantized((L, B, H, C, D), 5)
    v8, vs = _quantized((L, B, H, C, D), 6)
    for b, n in enumerate(N_PASTS):
        for t in ((k8, ks), (v8, vs)):
            _stale(t[0][:, b], t[1][:, b], n)
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("il", [0, 1])
def test_batched_int8_plain_matches_jax_kernel(batched_int8, il):
    q, k8, v8, ks, vs = batched_int8
    n_pasts = torch.tensor(N_PASTS, dtype=torch.int32)
    got = tatt.flash_decode_attention_batched_int8(torch.from_numpy(q), k8, v8, ks, vs, il, n_pasts, max(N_PASTS))
    want, _, _ = jflash_batched_int8(jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
                                     jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jnp.int32(il),
                                     jnp.asarray(N_PASTS, jnp.int32), interpret=True)
    assert got.shape == (len(N_PASTS), H, D)
    assert _rel(got.numpy(), want) <= REL
    # slot b is the batch-1 int8 kernel over slot b's planes
    for b, n in enumerate(N_PASTS):
        one = tatt.flash_decode_attention_stacked_int8(
            torch.from_numpy(q[b]), k8[:, b], v8[:, b], ks[:, b], vs[:, b], il, n)
        assert _rel(got[b].numpy(), one.numpy()) <= REL


def _to_pages(dense, page, table, live):
    """Scatter [L, B, H, C, X] into a pool [P, L, H, page, X] (one spare
    page) at the table's live pages."""
    Ld, B, Hd, _, X = dense.shape
    pool = torch.zeros((sum(live) + 1, Ld, Hd, page, X), dtype=dense.dtype)
    for b in range(B):
        for c in range(live[b]):
            pool[table[b, c]] = dense[:, b, :, c * page : (c + 1) * page]
    return pool


@pytest.mark.parametrize("page,garbage", [(64, 10**6), (16, -3), (128, 0)])
def test_paged_int8_plain_matches_jax_kernel_and_dense(batched_int8, page, garbage):
    """Slot 1 (n_past 100) and slot 2 cross pages; entries beyond each slot's
    live pages hold garbage (out-of-range ids, or page 0 of another slot)."""
    q, k8, v8, ks, vs = batched_int8
    B = len(N_PASTS)
    live = [n // page + 1 for n in N_PASTS]
    ids = np.random.default_rng(page).permutation(sum(live))
    table = np.full((B, C // page), garbage, np.int32)
    nxt = 0
    for b in range(B):
        table[b, : live[b]] = ids[nxt : nxt + live[b]]
        nxt += live[b]
    kp, vp, ksp, vsp = (_to_pages(t, page, table, live) for t in (k8, v8, ks, vs))
    n_pasts = torch.tensor(N_PASTS, dtype=torch.int32)
    for il in range(L):
        got = tatt.flash_decode_attention_paged_int8(
            torch.from_numpy(q), kp, vp, ksp, vsp, torch.from_numpy(table), il, n_pasts, max(N_PASTS))
        dense = tatt.flash_decode_attention_batched_int8(
            torch.from_numpy(q), k8, v8, ks, vs, il, n_pasts, max(N_PASTS))
        assert _rel(got.numpy(), dense.numpy()) <= REL
        want, _, _ = jflash_paged_int8(
            jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()), jnp.asarray(ksp.numpy()),
            jnp.asarray(vsp.numpy()), jnp.asarray(table), jnp.int32(il), jnp.asarray(N_PASTS, jnp.int32),
            interpret=True)
        assert _rel(got.numpy(), want) <= REL


def test_int8_wrappers_reject_non_cpu_inputs():
    q = torch.zeros((H, D), device="meta")
    k = torch.zeros((L, H, C, D), dtype=torch.int8, device="meta")
    s = torch.zeros((L, H, C, 1), device="meta")
    with pytest.raises(ValueError):
        tatt.flash_decode_attention_stacked_int8(q, k, k, s, s, 0, 3)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def test_int8_caches_match_jax_layout():
    """Both routes to an int8 cache (the config and an explicit dtype) build
    the JAX package's keys, shapes and dtypes, scales included."""
    cfg = ModelConfig.tiny(n_ctx=64, kv_cache_dtype="int8")
    tcfg = _tcfg(cfg)
    plain = _tcfg(cfg, kv_cache_dtype="float32")
    pairs = [
        (jllama.init_cache(cfg), tllama.init_cache(tcfg, device="cpu"),
         tllama.init_cache(plain, dtype=torch.int8, device="cpu")),
        (jllama.init_cache_batched(cfg, 3), tllama.init_cache_batched(tcfg, 3, device="cpu"),
         tllama.init_cache_batched(plain, 3, dtype=torch.int8, device="cpu")),
        (jllama.init_cache_paged(cfg, 5, 3, page=16), tllama.init_cache_paged(tcfg, 5, 3, page=16, device="cpu"),
         tllama.init_cache_paged(plain, 5, 3, dtype=torch.int8, page=16, device="cpu")),
    ]
    for want, *gots in pairs:
        for got in gots:
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert tuple(got[k].shape) == v.shape, k
                assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


# ---------------------------------------------------------------------------
# (c) batch 1 and (d) batched: the model, port vs JAX
# ---------------------------------------------------------------------------

PROMPT = [1, 17, 300, 42, 99, 5, 260, 7]
DECODE = [77, 3, 210, 411]


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(n_vocab=512, n_embd=256, n_mult=256, n_head=2, n_layer=2, n_rot=128,
                      ftype=GGMLType.Q4_0, n_ctx=256, scan_layers=False, kv_cache_dtype="int8")
    dense = jllama.random_params(cfg, seed=11)
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}
    jparams = jllama.params_from_tensors(tensors, cfg, param_dtype=jnp.float32, q4_layout="v")
    params = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), _tcfg(cfg), device="cpu")
    return cfg, jparams, params


def test_batch1_int8_matches_jax(model):
    """Prefill and 4 decode steps over an int8 init_cache with f32
    activations (as the JAX package's int8 tests run): the JAX package takes
    its int8 flash kernel (interpret mode) for decode, the port the kernel's
    plain version; prefill reads the quantized cache in both."""
    cfg, jparams, params = model
    cfg = dataclasses.replace(cfg, quantize_activations=False)
    tcfg = _tcfg(cfg)
    cache = tllama.init_cache(tcfg, device="cpu")
    jcache = jllama.init_cache(cfg)
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache and "k_scale" in jcache
    lg, cache = tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
    jlg, jcache = jllama.prefill(jparams, jnp.asarray(PROMPT, jnp.int32), jnp.int32(0), jcache, cfg)
    assert _rel(lg.numpy(), jlg) <= BAR
    for i, tok in enumerate(DECODE):
        lg, cache = tllama.decode_step(params, torch.tensor(tok), len(PROMPT) + i, cache, tcfg)
        jlg, jcache = jllama.decode_step(jparams, jnp.int32(tok), jnp.int32(len(PROMPT) + i), jcache, cfg)
        assert _rel(lg.numpy(), jlg) <= BAR, i
    n = len(PROMPT) + len(DECODE)
    np.testing.assert_allclose(cache["k_scale"][:, :, :n].numpy(), np.asarray(jcache["k_scale"])[:, :, :n],
                               rtol=1e-5)


def test_int8_cache_puts_4bit_activations_on_exact_ties(model):
    """Why the port is held to JAX with f32 activations on an int8 cache:
    position 0 attends one key, so its attention output is exactly one row
    of V codes times one scale, and the 4-bit quantization of that row
    (``x·7/amax`` per 32-block) meets exact ``k + 1/2`` ties wherever
    ``14·|c| = (2k+1)·max|c|``.  Which way each tie rounds then rests on the
    last bit of the scale arithmetic, which differs between implementations
    (and between the card and the CPU): one such flip moves the logits by
    percents."""
    cfg, _, params = model
    tcfg = _tcfg(cfg)
    cache = tllama.init_cache(tcfg, device="cpu")
    tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
    codes = cache["v"][0, :, 0].long().abs().reshape(-1, 32)  # layer 0, position 0, per 32-block
    cmax = codes.amax(dim=-1, keepdim=True)
    ties = int(((14 * codes) % (2 * cmax) == cmax).sum())
    assert ties > 0


def test_batch1_int8_flash_matches_unfused(model):
    """use_flash_decode off: the plain masked softmax over codes·scale."""
    cfg, _, params = model
    logits = {}
    for flash in (True, False):
        tcfg = _tcfg(cfg, use_flash_decode=flash)
        cache = tllama.init_cache(tcfg, device="cpu")
        _, cache = tllama.prefill(params, torch.tensor(PROMPT), 0, cache, tcfg)
        logits[flash], _ = tllama.decode_step(params, torch.tensor(9), len(PROMPT), cache, tcfg)
    assert _rel(logits[True].numpy(), logits[False].numpy()) <= REL


SLOT_PROMPTS = [[1, 17, 300, 42, 99], [1, 260, 7], [1, 5, 6, 7, 8, 9, 10, 11, 12]]
STEP_TOKENS = [[4, 6, 9, 0], [77, 3, 210, 0], [5, 411, 2, 0]]  # slot 3 stays idle
B, PAGE = 4, 64
TABLE = np.array([[4, 1, 7, 7], [2, 7, 7, 7], [0, 5, 7, 7], [7, 7, 7, 7]], np.int32)  # 7: scratch


def _jax_batched(cfg, jparams, paged):
    if paged:
        cache = jllama.init_cache_paged(cfg, 8, B, dtype=jnp.int8, page=PAGE)
        cache["page_table"] = jnp.asarray(TABLE)
    else:
        cache = jllama.init_cache_batched(cfg, B, dtype=jnp.int8)
    out = []
    for b, ids in enumerate(SLOT_PROMPTS):
        lg, cache = slot_prefill_chunk(jparams, jnp.asarray(ids, jnp.int32), jnp.int32(0), jnp.int32(b), cache, cfg)
        out.append(np.asarray(lg))
    n_pasts = np.array([len(p) for p in SLOT_PROMPTS] + [0], np.int32)
    for toks in STEP_TOKENS:
        lg, cache = batched_decode(jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(n_pasts), cache, cfg)
        out.append(np.asarray(lg)[:3])
        n_pasts[:3] += 1
    return out


def _port_batched(tcfg, params, paged, dtype=None):
    if paged:
        cache = tllama.init_cache_paged(tcfg, 8, B, dtype=dtype, page=PAGE, device="cpu")
        cache["page_table"].copy_(torch.from_numpy(TABLE))
    else:
        cache = tllama.init_cache_batched(tcfg, B, dtype=dtype, device="cpu")
    out = []
    for b, ids in enumerate(SLOT_PROMPTS):
        lg, cache = tllama.forward(params, torch.tensor(ids), 0, cache, tcfg, slot=b)
        out.append(lg.numpy())
    n_pasts = np.array([len(p) for p in SLOT_PROMPTS] + [0])
    for toks in STEP_TOKENS:
        lg, cache = tllama.forward_batched(params, torch.tensor(toks), n_pasts, cache, tcfg)
        out.append(lg.numpy()[:3])
        n_pasts[:3] += 1
    return out, cache


@pytest.fixture(scope="module")
def jax_batched(model):
    cfg, jparams, _ = model
    f32 = dataclasses.replace(cfg, quantize_activations=False)
    return {paged: _jax_batched(f32, jparams, paged) for paged in (False, True)}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slot_prefill_and_forward_batched_int8_match_jax(model, jax_batched, paged):
    cfg, _, params = model
    tcfg = _tcfg(cfg, quantize_activations=False)
    got, cache = _port_batched(tcfg, params, paged)
    assert ("k_scale_pool" if paged else "k_scale") in cache
    want = jax_batched[paged]
    assert len(got) == len(want) == len(SLOT_PROMPTS) + len(STEP_TOKENS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= BAR, i


def test_explicit_int8_dtype_is_served(model, jax_batched):
    """``init_cache_batched(..., dtype=torch.int8)`` with a float32
    ``kv_cache_dtype`` (the Engine's ``cache_dtype=torch.int8`` route)
    builds scales and quantizes its writes, so forward_batched agrees with
    JAX's ``init_cache_batched(dtype=jnp.int8)`` path.  Without scales the
    writes would truncate values below 1 to 0 and the logits would be wrong."""
    cfg, _, params = model
    tcfg = _tcfg(cfg, quantize_activations=False, kv_cache_dtype="float32")
    got, cache = _port_batched(tcfg, params, paged=False, dtype=torch.int8)
    for i, (g, w) in enumerate(zip(got, jax_batched[False])):
        assert _rel(g, w) <= BAR, i
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].shape == cache["k"].shape[:-1] + (1,)


def test_forward_batched_int8_unfused_and_paged_equal_flash(model):
    """Dense flash, dense unfused (codes·scale, masked softmax) and paged
    agree; row b of the batched step equals batch-1 decode of the same slot
    state on an int8 init_cache."""
    cfg, _, params = model
    tcfg = _tcfg(cfg)
    flash, dcache = _port_batched(tcfg, params, paged=False)
    plain, _ = _port_batched(_tcfg(cfg, use_flash_decode=False), params, paged=False)
    paged, _ = _port_batched(tcfg, params, paged=True)
    for f, p, g in zip(flash, plain, paged):
        assert _rel(p, f) <= REL and _rel(g, f) <= 1e-6
    for b, ids in enumerate(SLOT_PROMPTS):
        cache = tllama.init_cache(tcfg, device="cpu")
        _, cache = tllama.prefill(params, torch.tensor(ids), 0, cache, tcfg)
        for s, toks in enumerate(STEP_TOKENS):
            lg, cache = tllama.decode_step(params, torch.tensor(toks[b]), len(ids) + s, cache, tcfg)
            assert _rel(flash[len(SLOT_PROMPTS) + s][b], lg.numpy()) <= REL, (b, s)
        n = len(ids) + len(STEP_TOKENS)
        # the slot's planes hold what the batch-1 cache holds, to the last
        # bit of the activations (a code may round the other way)
        assert (dcache["k"][:, b, :, :n].int() - cache["k"][:, :, :n].int()).abs().max() <= 1
        torch.testing.assert_close(dcache["v_scale"][:, b, :, :n], cache["v_scale"][:, :, :n], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# (e) the Engine and the runner on int8 caches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tiny_tensors, tiny_vocab_pieces):
    cfg = ModelConfig.tiny(n_ctx=64, ftype=GGMLType.Q4_0)
    tcfg = _tcfg(cfg)
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in tiny_tensors.items()}
    ttensors = {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor) else v) for k, v in tensors.items()}
    params = tllama.params_from_tensors(ttensors, tcfg, device="cpu")
    return cfg, tcfg, tensors, params, Vocab(tiny_vocab_pieces)


def _drain(eng, handles, max_steps=400):
    for _ in range(max_steps):
        if not any(s.handle is not None for s in eng.slots) and eng._pending.empty():
            return [h.token_ids for h in handles]
        eng.step()
    pytest.fail("engine did not finish its streams")


ENGINE_PROMPTS = ("the rain", "he said", "in the", "a on the")
N_PREDICT = 6


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_int8_greedy_matches_batch1(tiny, paged):
    """Four greedy streams through 2 slots of an int8 cache (two wait): each
    completes, every page comes back, and the tokens are batch-1 greedy
    decode over an int8 init_cache."""
    _, tcfg, _, params, vocab = tiny
    kw = dict(paged_pages=9, page=16) if paged else {}
    eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=8, cache_dtype=torch.int8, seed=0, **kw)
    assert eng.cache["k_pool" if paged else "k"].dtype == torch.int8
    assert ("k_scale_pool" if paged else "k_scale") in eng.cache
    greedy = SamplingConfig(top_k=1, repeat_penalty=1.0, n_predict=N_PREDICT)
    hs = [eng.submit(p, greedy) for p in ENGINE_PROMPTS]
    outs = _drain(eng, hs)
    assert eng.stats["device_sampled_steps"] > 0
    if paged:
        assert sorted(eng._free_pages) == list(range(8)) and (eng.cache["page_table"] == 8).all()
    for p, out in zip(ENGINE_PROMPTS, outs):
        ids = vocab.tokenize(p, bos=True)
        assert len(out) == len(ids) + N_PREDICT and out[: len(ids)] == ids
        cache = tllama.init_cache(tcfg, dtype=torch.int8, device="cpu")
        lg, cache = tllama.prefill(params, torch.tensor(ids), 0, cache, tcfg)
        toks, _ = tllama.greedy_decode_loop(params, lg[-1].argmax(), len(ids), cache, tcfg, N_PREDICT - 1)
        assert out[len(ids):] == [int(lg[-1].argmax())] + toks.tolist(), p


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_int8_chunked_admission_is_isolated(tiny, paged):
    """A stream admitted chunk by chunk while another decodes gives the
    tokens it gives alone: the idle lanes of the prefilling slot write codes
    and scales at its next chunk's position, which that chunk overwrites."""
    _, tcfg, _, params, vocab = tiny
    kw = dict(paged_pages=12, page=16) if paged else {}

    def run(with_other):
        eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=4, cache_dtype=torch.int8, **kw)
        if with_other:
            eng.submit("ab", SamplingConfig(seed=1, n_predict=40))
            for _ in range(3):
                eng.step()
        h = eng.submit("the rain in spain stays", SamplingConfig(seed=2, n_predict=6))
        for _ in range(60):
            eng.step()
        return h.token_ids

    assert run(True) == run(False)


def test_runner_int8_stream_matches_jax_runner(tmp_path, tiny, tiny_vocab_pieces):
    """LlamaRunner follows ``runner.config.kv_cache_dtype``, as the JAX
    runner does: the same greedy stream on an int8 cache."""
    cfg, _, tensors, _, _ = tiny
    path = str(tmp_path / "tiny-q4_0.bin")
    jggml.write_model_file(path, cfg, tiny_vocab_pieces, tensors)
    streams = []
    for runner, rcfg in [
        (LlamaRunner(path, n_ctx=64, prefill_bucket=8, device="cpu"),
         RunnerConfig(num_tokens=10, device_sampling=False, sampling=SamplingConfig(seed=7, top_k=1))),
        (JLlamaRunner(path, n_ctx=64, prefill_bucket=8),
         JRunnerConfig(num_tokens=10, device_sampling=False, sampling=JSamplingConfig(seed=7, top_k=1))),
    ]:
        runner.ensure_loaded()
        runner.config = dataclasses.replace(runner.config, kv_cache_dtype="int8")
        streams.append([e.token for e in runner.run_events("the rain in", rcfg) if e.kind.value == "outputToken"])
    assert len(streams[0]) > 10
    assert streams[0] == streams[1]
