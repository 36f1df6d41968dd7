"""The port's continuous-batching path (llama_swift_torch/models/llama.py
forward_batched and the slot path of forward; llama_swift_torch/runtime/
engine.py Engine; the batched device sampler) against the JAX package, on
the CPU with the kernels' plain versions.

* forward_batched (dense and paged caches) and slot prefill: port vs JAX at
  a 2-layer, 128-dim-head Q4_0 config with the JAX Pallas kernels in
  interpret mode, logits within the repo's 2e-3 bar.
* chunked slot prefill equals whole prefill; an unaligned paged prefill
  chunk that straddles a page equals the dense path (the JAX paged write
  assumes an aligned chunk, so the port is its own reference here).
* Engine behaviour, mirroring tests/test_engine.py and tests/test_paged_kv.py.
  Tests step the engine synchronously where they can; every wait on the
  engine thread has a deadline that fails the test.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType, ModelConfig
from llama_swift_tpu.config import SamplingConfig as JSamplingConfig
from llama_swift_tpu.formats import ggml as jggml
from llama_swift_tpu.formats.quant import Q4_0Tensor
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.runtime.device_sampler import topk_topp_probs as jtopk_topp_probs
from llama_swift_tpu.runtime.engine import Engine as JEngine
from llama_swift_tpu.runtime.engine import batched_decode, slot_prefill_chunk
from llama_swift_tpu.tokenizer import Vocab as JVocab
from llama_swift_torch import Engine, PredictionFailedError, RunnerConfig, SamplingConfig, Vocab
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.runtime import engine as tengine
from llama_swift_torch.runtime.device_sampler import topk_topp_probs_batched
from llama_swift_torch.runtime.runner import LlamaRunner

BAR = 2e-3
DEADLINE_S = 60.0  # any single wait on the engine thread


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _tcfg(cfg, **kw):
    return dataclasses.replace(TModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


# ---------------------------------------------------------------------------
# forward_batched and the slot path, port vs JAX
# ---------------------------------------------------------------------------

PROMPTS = [[1, 17, 300, 42, 99], [1, 260, 7], [1, 5, 6, 7, 8, 9, 10, 11, 12]]
STEP_TOKENS = [[4, 6, 9, 0], [77, 3, 210, 0], [5, 411, 2, 0]]  # slot 3 stays idle
B, PAGE = 4, 64
TABLE = np.array([[4, 1, 7, 7], [2, 7, 7, 7], [0, 5, 7, 7], [7, 7, 7, 7]], np.int32)  # 7: scratch


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(n_vocab=512, n_embd=256, n_mult=256, n_head=2, n_layer=2, n_rot=128,
                      ftype=GGMLType.Q4_0, n_ctx=256, scan_layers=False)
    dense = jllama.random_params(cfg, seed=11)
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in dense.items()}
    jparams = jllama.params_from_tensors(tensors, cfg, param_dtype=jnp.float32, q4_layout="v")
    tcfg = _tcfg(cfg)
    params = tllama.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, tcfg, jparams, params


def _jax_run(cfg, jparams, paged):
    """The JAX package on the CPU as its own tests run it: the batched and
    paged flash kernels in interpret mode, the Q4_0 products on its XLA path
    (the multi-row kernel itself is held against its interpret mode in
    tests/test_torch_q4_matmul_multi.py)."""
    if paged:
        cache = jllama.init_cache_paged(cfg, 8, B, page=PAGE)
        cache["page_table"] = jnp.asarray(TABLE)
    else:
        cache = jllama.init_cache_batched(cfg, B)
    out = []
    for b, ids in enumerate(PROMPTS):
        lg, cache = slot_prefill_chunk(jparams, jnp.asarray(ids, jnp.int32), jnp.int32(0), jnp.int32(b),
                                       cache, cfg)
        out.append(np.asarray(lg))
    n_pasts = np.array([len(p) for p in PROMPTS] + [0], np.int32)
    for toks in STEP_TOKENS:
        lg, cache = batched_decode(jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(n_pasts), cache, cfg)
        out.append(np.asarray(lg)[:3])
        n_pasts[:3] += 1
    return out


def _port_run(tcfg, params, paged):
    if paged:
        cache = tllama.init_cache_paged(tcfg, 8, B, page=PAGE, device="cpu")
        cache["page_table"].copy_(torch.from_numpy(TABLE))
    else:
        cache = tllama.init_cache_batched(tcfg, B, device="cpu")
    out = []
    for b, ids in enumerate(PROMPTS):
        lg, cache = tllama.forward(params, torch.tensor(ids), 0, cache, tcfg, slot=b)
        out.append(lg.numpy())
    n_pasts = np.array([len(p) for p in PROMPTS] + [0])
    for toks in STEP_TOKENS:
        lg, cache = tllama.forward_batched(params, torch.tensor(toks), n_pasts, cache, tcfg)
        out.append(lg.numpy()[:3])
        n_pasts[:3] += 1
    return out, cache


@pytest.fixture(scope="module")
def port_runs(model):
    _, tcfg, _, params = model
    return {
        "dense": _port_run(tcfg, params, paged=False),
        "paged": _port_run(tcfg, params, paged=True),
        "unfused": _port_run(dataclasses.replace(tcfg, use_flash_decode=False), params, paged=False),
    }


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slot_prefill_and_forward_batched_match_jax(model, port_runs, paged):
    cfg, tcfg, jparams, params = model
    want = _jax_run(cfg, jparams, paged)
    got, _ = port_runs["paged" if paged else "dense"]
    assert len(got) == len(want) == len(PROMPTS) + len(STEP_TOKENS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= BAR, i


def test_paged_equals_dense_and_batch1(model, port_runs):
    """Port: the paged run equals the dense run; row b of forward_batched
    equals decode_step of the same slot state in a batch-1 cache."""
    _, tcfg, _, params = model
    dense, dcache = port_runs["dense"]
    paged, _ = port_runs["paged"]
    for d, p in zip(dense, paged):
        assert _rel(p, d) <= 1e-6
    for b, ids in enumerate(PROMPTS):
        cache = tllama.init_cache(tcfg, device="cpu")
        _, cache = tllama.prefill(params, torch.tensor(ids), 0, cache, tcfg)
        for s, toks in enumerate(STEP_TOKENS):
            lg, cache = tllama.decode_step(params, torch.tensor(toks[b]), len(ids) + s, cache, tcfg)
            assert _rel(dense[len(PROMPTS) + s][b], lg.numpy()) <= 1e-5, (b, s)
        # the slot's dense plane holds what the batch-1 cache holds
        n = len(ids) + len(STEP_TOKENS)
        torch.testing.assert_close(dcache["k"][:, b, :, :n], cache["k"][:, :, :n], rtol=1e-5, atol=1e-5)


def test_forward_batched_unfused_matches_flash(port_runs):
    flash, _ = port_runs["dense"]
    plain, _ = port_runs["unfused"]
    for f, p in zip(flash, plain):
        assert _rel(p, f) <= 1e-5


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_slot_prefill_equals_whole(model, paged):
    _, tcfg, _, params = model
    ids = [int(t) for t in np.random.default_rng(5).integers(3, 500, size=21)]

    def cache():
        if paged:
            c = tllama.init_cache_paged(tcfg, 8, 2, page=16, device="cpu")
            c["page_table"][1, :2] = torch.tensor([3, 5], dtype=torch.int32)
            return c
        return tllama.init_cache_batched(tcfg, 2, device="cpu")

    whole, cw = tllama.forward(params, torch.tensor(ids), 0, cache(), tcfg, slot=1)
    cc, pos = cache(), 0
    while pos < len(ids):
        chunk = ids[pos : pos + 8]
        lg, cc = tllama.forward(params, torch.tensor(chunk), pos, cc, tcfg, slot=1)
        pos += len(chunk)
    assert _rel(lg[-1].numpy(), whole[-1].numpy()) <= 1e-5
    key = "k_pool" if paged else "k"
    torch.testing.assert_close(cc[key], cw[key], rtol=1e-5, atol=1e-5)


def test_unaligned_paged_prefill_straddles_page(model):
    """A prefill chunk that starts at an unaligned position and crosses a
    page boundary lands where the dense batched path puts it (the hazard of
    the JAX paged write, whose single-write path assumes an aligned start)."""
    _, tcfg, _, params = model
    ids = [int(t) for t in np.random.default_rng(8).integers(3, 500, size=19)]
    chunks = [(0, 12), (12, 19)]  # positions 12..18 straddle the page edge at 16
    paged = tllama.init_cache_paged(tcfg, 6, 2, page=16, device="cpu")
    paged["page_table"][0, :2] = torch.tensor([4, 1], dtype=torch.int32)
    dense = tllama.init_cache_batched(tcfg, 2, device="cpu")
    for lo, hi in chunks:
        lp, paged = tllama.forward(params, torch.tensor(ids[lo:hi]), lo, paged, tcfg, slot=0)
        ld, dense = tllama.forward(params, torch.tensor(ids[lo:hi]), lo, dense, tcfg, slot=0)
        assert _rel(lp.numpy(), ld.numpy()) <= 1e-6
    for pos in range(len(ids)):
        pid = (4, 1)[pos // 16]
        torch.testing.assert_close(paged["k_pool"][pid, :, :, pos % 16], dense["k"][:, 0, :, pos])
    lp, _ = tllama.forward_batched(params, torch.tensor([9, 0]), [len(ids), 0], paged, tcfg)
    ld, _ = tllama.forward_batched(params, torch.tensor([9, 0]), [len(ids), 0], dense, tcfg)
    assert _rel(lp[0].numpy(), ld[0].numpy()) <= 1e-6


def test_forward_batched_rejects_out_of_range_positions(model):
    _, tcfg, _, params = model
    cache = tllama.init_cache_batched(tcfg, 2, device="cpu")
    with pytest.raises(ValueError):
        tllama.forward_batched(params, torch.tensor([1, 2]), [0, tcfg.n_ctx], cache, tcfg)


# ---------------------------------------------------------------------------
# batched device sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("penalize", [True, False])
def test_batched_sampler_matches_jax_per_slot(penalize):
    rng = np.random.default_rng(3)
    nb, V, R, k = 4, 300, 16, 40
    logits = (rng.standard_normal((nb, V)) * 3).astype(np.float32)
    rings = rng.integers(0, V, (nb, R))
    temps = np.array([0.8, 1.0, 0.5, 1.3], np.float32)
    top_ps = np.array([0.95, 0.5, 1.0, 0.9], np.float32)
    pens = np.array([1.3, 1.0, 1.1, 2.0], np.float32)
    ids, probs = topk_topp_probs_batched(
        torch.from_numpy(logits), torch.from_numpy(rings), top_k=k, top_p=torch.from_numpy(top_ps),
        temp=torch.from_numpy(temps), repeat_penalty=torch.from_numpy(pens), penalize=penalize)
    for b in range(nb):
        jids, jprobs = jtopk_topp_probs(
            jnp.asarray(logits[b]), jnp.asarray(rings[b], jnp.int32), top_k=k, top_p=jnp.float32(top_ps[b]),
            temp=jnp.float32(temps[b]), repeat_penalty=jnp.float32(pens[b]), penalize=penalize)
        np.testing.assert_array_equal(ids[b].numpy(), np.asarray(jids))
        np.testing.assert_allclose(probs[b].numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)


def test_batched_decode_sampled_leaves_idle_rings(model):
    _, tcfg, _, params = model
    cache = tllama.init_cache_batched(tcfg, 3, device="cpu")
    rings = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    ring_pos = torch.tensor([0, 2, 3])
    before = rings.clone()
    g = torch.Generator().manual_seed(0)
    ones = torch.ones(3)
    toks, _ = tengine.batched_decode_sampled(
        params, torch.tensor([5, 6, 7]), [3, 0, 9], torch.tensor([True, False, True]), cache, rings,
        ring_pos, g, ones, ones, ones, tcfg, 40, True)
    assert toks.shape == (3,)
    assert ring_pos.tolist() == [1, 2, 0]
    torch.testing.assert_close(rings[1], before[1])
    assert rings[0, 0] == toks[0] and rings[2, 3] == toks[2]
    assert rings[0, 1:].tolist() == before[0, 1:].tolist()


# ---------------------------------------------------------------------------
# Engine behaviour
# ---------------------------------------------------------------------------

PIECES = [b"<unk>", b"<s>", b"</s>"] + [bytes([c]) for c in range(32, 127)]


@pytest.fixture(scope="module")
def tiny(tiny_tensors, tiny_vocab_pieces):
    cfg = ModelConfig.tiny(n_ctx=64, ftype=GGMLType.Q4_0)
    tcfg = _tcfg(cfg)
    tensors = {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v) for k, v in tiny_tensors.items()}
    from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor

    ttensors = {k: (TQ4_0Tensor(v.scales, v.qs) if isinstance(v, Q4_0Tensor) else v) for k, v in tensors.items()}
    params = tllama.params_from_tensors(ttensors, tcfg, device="cpu")
    return cfg, tcfg, tensors, params, Vocab(tiny_vocab_pieces)


def _drain(eng, handles, max_steps=400):
    """Step synchronously until every handle is finished; returns the
    token-id lists (prompt echo included)."""
    for _ in range(max_steps):
        if not any(s.handle is not None for s in eng.slots) and eng._pending.empty():
            break
        eng.step()
    else:
        pytest.fail("engine did not finish its streams")
    return [h.token_ids for h in handles]


def _collect(handle):
    return list(handle.tokens(timeout=DEADLINE_S))


def test_engine_decode_continues_during_long_admission(tiny):
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=4)
    eng.submit("the rain", SamplingConfig(seed=1, n_predict=40))
    for _ in range(8):
        eng.step()
        if eng.slots[0].active:
            break
    assert eng.slots[0].active
    long_prompt = "the rain " * 5
    assert len(vocab.tokenize(long_prompt, bos=True)) > 3 * 4
    eng.submit(long_prompt, SamplingConfig(seed=2, n_predict=2))
    a_before = len(eng.slots[0].generated)
    steps = 0
    eng.step()
    while eng.slots[1].prefilling:
        assert not eng.slots[1].active
        eng.step()
        steps += 1
    assert steps >= 2
    assert len(eng.slots[0].generated) - a_before >= steps
    assert eng.stats["prefill_chunks"] > steps


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_chunked_admission_is_isolated(tiny, paged):
    """A stream admitted chunk by chunk while another decodes gives the
    tokens it gives alone: idle lanes of a prefilling slot must not write
    over its prompt (in the JAX engine they write position 0)."""
    _, tcfg, _, params, vocab = tiny
    kw = dict(paged_pages=12, page=16) if paged else {}

    def run(with_other):
        eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=4, **kw)
        if with_other:
            eng.submit("ab", SamplingConfig(seed=1, n_predict=40))
            for _ in range(3):
                eng.step()
        h = eng.submit("the rain in spain stays", SamplingConfig(seed=2, n_predict=6))
        for _ in range(60):
            eng.step()
        return h.token_ids

    assert run(True) == run(False)


def test_reference_engine_admission_hazard(tiny, tiny_vocab_pieces):
    """The hazard that test_engine_chunked_admission_is_isolated guards
    against, shown in the JAX engine (ROADMAP §C): each decode step also
    runs the lane of a slot that is still prefilling, at n_past 0, so its
    first prompt position is overwritten, and the same seeded request gives
    other tokens when another stream decodes during its admission."""
    cfg, _, tensors, _, _ = tiny
    jparams = jllama.params_from_tensors(tensors, cfg, param_dtype=jnp.float32)
    vocab = JVocab(tiny_vocab_pieces)

    def run(with_other):
        eng = JEngine(jparams, cfg, vocab, max_slots=2, prefill_bucket=4)
        if with_other:
            eng.submit("ab", JSamplingConfig(seed=1, n_predict=40))
            for _ in range(3):
                eng.step()
        h = eng.submit("the rain in spain stays", JSamplingConfig(seed=2, n_predict=6))
        for _ in range(60):
            eng.step()
        return h.token_ids

    assert run(True) != run(False)


def test_engine_single_stream_matches_runner_and_jax_engine(tmp_path, tiny, tiny_vocab_pieces):
    """One seeded stream: the port's Engine, the port's LlamaRunner and the
    JAX Engine give the same tokens (all three sample on the host with the
    request's numpy stream)."""
    cfg, tcfg, tensors, params, vocab = tiny
    path = str(tmp_path / "tiny-q4_0.bin")
    jggml.write_model_file(path, cfg, tiny_vocab_pieces, tensors)
    eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=8)
    h = eng.submit("the rain", SamplingConfig(seed=7, n_predict=8))
    port_engine = [vocab.piece_str(t) for t in _drain(eng, [h])[0]]

    runner = LlamaRunner(path, n_ctx=tcfg.n_ctx, prefill_bucket=8, device="cpu")
    events = runner.run_events("the rain", RunnerConfig(num_tokens=8, sampling=SamplingConfig(seed=7),
                                                        device_sampling=False))
    port_runner = [e.token for e in events if e.kind.value == "outputToken"]

    mf = jggml.load_model_file(path, n_ctx=cfg.n_ctx)
    jeng = JEngine(jllama.params_from_file(mf), mf.config, JVocab(mf.vocab), max_slots=2, prefill_bucket=8)
    jh = jeng.submit("the rain", JSamplingConfig(seed=7, n_predict=8))
    for _ in range(40):
        jeng.step()
    jax_engine = [vocab.piece_str(t) for t in jh.token_ids]
    assert len(port_engine) == len(vocab.tokenize("the rain", bos=True)) + 8
    assert port_engine == port_runner == jax_engine


def test_engine_device_sampling_path(tiny):
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=8, seed=0)
    prompts = ("the rain", "he said")
    hs = [eng.submit(p, SamplingConfig(n_predict=6)) for p in prompts]
    _drain(eng, hs)
    for p, h in zip(prompts, hs):
        ids = vocab.tokenize(p, bos=True)
        out = _collect(h)
        assert len(out) == len(ids) + 6
        assert "".join(out[: len(ids)]) == "".join(vocab.piece_str(t) for t in ids)
    assert eng.stats["device_sampled_steps"] > 0
    assert eng.stats["device_sampled_steps"] == eng.stats["decode_steps"]
    assert all(t.device == eng.device for t in (eng.rings, eng.ring_pos, eng.cache["k"], eng.cache["v"]))


def test_engine_concurrent_streams_on_the_thread(tiny):
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=4, prefill_bucket=8)
    prompts = ["the rain", "he said", "in the", "a on"]
    with eng:
        handles = [eng.submit(p, SamplingConfig(seed=i, n_predict=6)) for i, p in enumerate(prompts)]
        outs = [_collect(h) for h in handles]
    for p, out in zip(prompts, outs):
        ids = vocab.tokenize(p, bos=True)
        assert "".join(out[: len(ids)]) == "".join(vocab.piece_str(t) for t in ids)
        assert len(out) == len(ids) + 6
    assert eng.stats["admitted"] == 4
    assert all(h.ttft_s is not None and h.ttft_s >= 0 for h in handles)


def test_engine_more_streams_than_slots(tiny):
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=2, prefill_bucket=8)
    handles = [eng.submit(f"the {c}", SamplingConfig(seed=i, n_predict=4)) for i, c in enumerate("abcde")]
    _drain(eng, handles)
    assert all(len(_collect(h)) > 4 for h in handles)
    assert eng.stats["admitted"] == 5


def test_engine_ttft_stat_keeps_the_last_window(tiny):
    """``stats["ttft_s"]`` is a window of the last ``TTFT_WINDOW`` requests'
    times to first token: more finished requests than that leave exactly
    the newest ones, in order, and each is its handle's own value."""
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=8, prefill_bucket=8)
    n = tengine.TTFT_WINDOW + 6
    handles = [eng.submit("a", SamplingConfig(seed=i, n_predict=1)) for i in range(n)]
    _drain(eng, handles, max_steps=4 * n)
    assert eng.stats["admitted"] == n
    ttft = eng.stats["ttft_s"]
    assert len(ttft) == tengine.TTFT_WINDOW
    by_first_token = sorted(handles, key=lambda h: h.t_submit + h.ttft_s)
    assert list(ttft) == [h.ttft_s for h in by_first_token[-tengine.TTFT_WINDOW:]]


def test_engine_isolation_between_streams(tiny):
    _, tcfg, _, params, vocab = tiny
    eng1 = Engine(params, tcfg, vocab, max_slots=4, prefill_bucket=8)
    alone = _drain(eng1, [eng1.submit("the rain", SamplingConfig(seed=3, n_predict=6))])[0]
    eng2 = Engine(params, tcfg, vocab, max_slots=4, prefill_bucket=8)
    h1 = eng2.submit("the rain", SamplingConfig(seed=3, n_predict=6))
    h2 = eng2.submit("on a he", SamplingConfig(seed=9, n_predict=6))
    together = _drain(eng2, [h1, h2])[0]
    assert alone == together


def test_engine_paged_serves_and_frees(tiny):
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=3, prefill_bucket=8, paged_pages=9, page=16)
    prompts = ("the rain", "he said", "a b")
    hs = [eng.submit(p, SamplingConfig(n_predict=6)) for p in prompts]
    _drain(eng, hs)
    for p, h in zip(prompts, hs):
        assert len(_collect(h)) == len(vocab.tokenize(p, bos=True)) + 6
    assert sorted(eng._free_pages) == list(range(8))
    assert all(not s.pages for s in eng.slots)
    assert (eng.cache["page_table"] == 8).all()  # every row back on the scratch page


def test_engine_paged_pool_exhaustion_fails_the_stream(tiny):
    _, tcfg, _, params, vocab = tiny
    eng = Engine(params, tcfg, vocab, max_slots=1, prefill_bucket=8, paged_pages=3, page=16)
    h = eng.submit("the rain in spain", SamplingConfig(n_predict=40))
    _drain(eng, [h])
    with pytest.raises(PredictionFailedError):
        _collect(h)
    assert sorted(eng._free_pages) == [0, 1]


def test_engine_failed_step_fails_every_stream(tiny, monkeypatch):
    """A crashed step on the engine thread finishes every live and pending
    handle with the error and rejects later submits."""
    _, tcfg, _, params, vocab = tiny

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tengine, "batched_decode_sampled", boom)
    eng = Engine(params, tcfg, vocab, max_slots=1, prefill_bucket=8)
    hs = [eng.submit("the rain", SamplingConfig(n_predict=4)) for _ in range(2)]
    with eng:
        for h in hs:
            with pytest.raises(RuntimeError, match="device lost"):
                _collect(h)
    assert isinstance(eng.dead, RuntimeError)
    with pytest.raises(RuntimeError):
        _collect(eng.submit("x"))


def test_stream_handle_wait_has_a_deadline():
    h = tengine.StreamHandle()
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        list(h.tokens(timeout=0.05))
    assert time.perf_counter() - t0 < 5
    assert threading.active_count() >= 1
