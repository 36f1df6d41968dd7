"""The port's tensor parallelism (llama_swift_torch/parallel/) and its
serving entry point (llama_swift_torch/serve.py) on the CPU, the ranks as
processes of a gloo group that meet through a ``file://`` store in the
test's own directory (so parallel test workers never share a port).

* ``make_tp_forward`` at tp = 2 (and one case at 4) against the JAX
  package's ``make_tp_forward`` on a tp = 2 (4) mesh of the conftest's CPU
  devices: V and T layouts, plain and fused (``fuse_shards`` = tp), a
  prompt prefill and 2 decode steps, logits within 1e-5 with f32
  activations; each rank's shard shapes follow the split map.
* Fused params whose ``fuse_shards`` is not the TP degree are refused (the
  JAX package runs them and mixes the ranks' rows: shown here too).
* ``parallel/sharding.shard_params`` slices by the split map: every 2-D
  weight by rows, norms replicated; ``serve`` refuses a TP degree that
  does not divide the model.
* ``serve``: flags round-trip, the missing-model paths, a single process on
  ``--device cpu``, and two gloo ranks started without ``--seed`` that
  sample the same ids (rank 0's seed is broadcast before the samplers are
  built).

Every spawned process is joined with a timeout and every rendezvous has
one, so a hung group fails the test instead of stalling the suite.  JAX is
imported inside the tests: the spawned ranks import this module and need
only torch.
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

from llama_swift_torch import serve
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats.quant import Q4_0Tensor as TQ4_0Tensor
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.parallel import sharding
from llama_swift_torch.parallel import tp as ttp
from llama_swift_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from llama_swift_torch.parallel.multihost import init_distributed, shutdown

BAR = 1e-5  # relative logits, f32 activations
JOIN_S = 150  # a rank's whole run
RENDEZVOUS_S = 90
PROMPT = [1, 7, 33, 120, 5, 250, 9]
STEPS = [4, 77]
CFG = dict(n_embd=1024, n_head=8, n_vocab=256, n_mult=256, n_layer=2, n_ctx=64, n_rot=128,
           quantize_activations=False)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _spawn(target, world: int, tmp_path, *args):
    """Run ``target(rank, world, store, *args)`` in ``world`` spawned
    processes; each must exit 0 within JOIN_S seconds."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target, args=(r, world, store, *args)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, "a rank did not finish in time"
    assert [p.exitcode for p in procs] == [0] * world


def _tp_rank(rank, world, store, cfgs, tensors, cases, out_path):
    """One rank of every case: the port's TP prefill and decode steps;
    saves its logits and its shard shapes."""
    torch.set_num_threads(2)
    init_distributed(f"file://{store}", world, rank, device="cpu", timeout_s=RENDEZVOUS_S)
    try:
        mesh = make_mesh(tp=world)
        out = {}
        for case, build_kw in cases.items():
            cfg = cfgs[case]
            params = ttp.shard_params_tp(tllama.params_from_tensors(tensors, cfg, device="cpu", **build_kw), mesh)
            cache = ttp.shard_cache_tp(tllama.init_cache(cfg, device="cpu"), mesh)
            fwd = ttp.make_tp_forward(cfg, params, cache)
            logits, cache = fwd(params, torch.tensor(PROMPT), 0, cache)
            out[f"{case}/0"] = logits.numpy()
            for i, tok in enumerate(STEPS):
                logits, cache = fwd(params, torch.tensor([tok]), len(PROMPT) + i, cache)
                out[f"{case}/{i + 1}"] = logits.numpy()
            stacked = params["layers_stacked"]
            qkv = stacked["wqkv"] if "wqkv" in stacked else stacked["wq"]
            out[f"{case}/shapes"] = np.array([
                qkv.shape[0], stacked["wo"].shape[0], stacked["w2"].shape[1], params["output"].shape[0],
                params["tok_embeddings"].shape[0], cache["k"].shape[1]])
        np.savez(f"{out_path}.{rank}.npz", **out)
    finally:
        shutdown()


@pytest.fixture(scope="module")
def q4_tensors():
    from llama_swift_tpu.formats.quant import Q4_0Tensor
    from llama_swift_tpu.models import llama as jllama

    return {k: (Q4_0Tensor.quantize(v) if v.ndim == 2 else v)
            for k, v in jllama.random_params(_jcfg(), seed=3).items()}


def _jcfg(**kw):
    from llama_swift_tpu.config import ModelConfig

    return ModelConfig.tiny(**{**CFG, **kw})


def _port(tensors):
    return {k: (TQ4_0Tensor(v.scales, v.qs) if hasattr(v, "qs") else v) for k, v in tensors.items()}


def _jax_tp(tensors, cfg, tp: int, **build_kw):
    """The JAX package's TP logits (prefill, then each step) on a tp-device mesh."""
    import jax
    import jax.numpy as jnp

    from llama_swift_tpu.models import llama as jllama
    from llama_swift_tpu.parallel import tp as jtp
    from llama_swift_tpu.parallel.mesh import make_mesh as jmake_mesh

    mesh = jmake_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    params = jtp.shard_params_tp(jllama.params_from_tensors(tensors, cfg, param_dtype=jnp.float32, **build_kw), mesh)
    cache = jtp.shard_cache_tp(jllama.init_cache(cfg), mesh)
    fwd = jtp.make_tp_forward(mesh, cfg, params, cache)
    logits, cache = fwd(params, jnp.asarray(PROMPT, jnp.int32), jnp.int32(0), cache)
    out = [np.asarray(logits)]
    for i, tok in enumerate(STEPS):
        logits, cache = fwd(params, jnp.asarray([tok], jnp.int32), jnp.int32(len(PROMPT) + i), cache)
        out.append(np.asarray(logits))
    return out


#: (layout, fused, tp): the V and T layouts, plain and fused (fuse_shards = tp)
TP_CASES = [("v", False, 2), ("t", False, 2), ("v", True, 2), ("t", True, 2), ("t", True, 4)]


def _case_cfg(fused):
    # fused: the serving branch, with per-shard flash decode
    return _jcfg(fuse_layer_matmuls=fused, use_flash_decode=fused)


def _build_kw(layout, fused, tp):
    return dict(shard_pad=128 * tp, fuse_shards=tp if fused else 1, q4_layout=layout)


@pytest.fixture(scope="module")
def port_tp_runs(q4_tensors, tmp_path_factory):
    """Every case's ranks, one spawned group per TP degree (a rank runs
    all its degree's cases): {case: [rank 0's arrays, rank 1's, ...]}."""
    runs = {}
    for tp in sorted({c[2] for c in TP_CASES}):
        cases = {f"{layout}-{fused}": _build_kw(layout, fused, tp) for layout, fused, t in TP_CASES if t == tp}
        cfgs = {case: TModelConfig.tiny(**CFG, fuse_layer_matmuls=fused, use_flash_decode=fused)
                for case, fused in ((f"{layout}-{fused}", fused) for layout, fused, t in TP_CASES)}
        tmp = tmp_path_factory.mktemp(f"tp{tp}")
        out = str(tmp / "logits")
        _spawn(_tp_rank, tp, tmp, cfgs, _port(q4_tensors), cases, out)
        ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(tp)]
        for case in cases:
            runs[f"{case}-{tp}"] = [{k.split("/")[1]: v for k, v in r.items() if k.startswith(case + "/")}
                                    for r in ranks]
    return runs


@pytest.mark.parametrize("layout,fused,tp", TP_CASES)
def test_tp_matches_jax(q4_tensors, port_tp_runs, monkeypatch, layout, fused, tp):
    from llama_swift_tpu.ops import quantized_matmul as jqmm

    cfg = _case_cfg(fused)
    kw = _build_kw(layout, fused, tp)
    kw.update({"transpose_q4": True, "q4_layout": None} if layout == "t" else {})
    # fused: JAX runs its kernels in interpret mode, as tests/test_tp_shard_map.py does
    monkeypatch.setattr(jqmm, "FORCE_PALLAS_INTERPRET", fused)
    want = _jax_tp(q4_tensors, cfg, tp, **kw)
    ranks = port_tp_runs[f"{layout}-{fused}-{tp}"]
    for r in ranks:  # the same whole logits on every rank
        for i, w in enumerate(want):
            assert _rel(r[str(i)], w) <= BAR, i
    ff_pad = -(-cfg.n_ff // (128 * tp)) * 128 * tp
    vocab_pad = -(-cfg.n_vocab // (128 * tp)) * 128 * tp
    rows = (3 if fused else 1) * cfg.n_embd // tp
    assert ranks[0]["shapes"].tolist() == [rows, cfg.n_embd // tp, ff_pad, vocab_pad // tp, vocab_pad // tp,
                                           cfg.n_head // tp]


def test_fused_params_must_match_tp(q4_tensors):
    """Fused params built for one shard (fuse_shards=1) at tp = 2: the JAX
    package runs them and its logits leave the single-device ones; the
    port refuses them."""
    import jax.numpy as jnp

    from llama_swift_tpu.models import llama as jllama

    cfg = _jcfg(fuse_layer_matmuls=True)
    wrong = _jax_tp(q4_tensors, cfg, 2, shard_pad=256, q4_layout="v", fuse_shards=1)
    params = jllama.params_from_tensors(q4_tensors, cfg, param_dtype=jnp.float32, shard_pad=256, q4_layout="v")
    single, _ = jllama.prefill(params, jnp.asarray(PROMPT, jnp.int32), jnp.int32(0), jllama.init_cache(cfg), cfg)
    assert _rel(wrong[0], single) > 0.1
    tcfg = TModelConfig.tiny(**CFG, fuse_layer_matmuls=True)
    mesh = Mesh(tp=2, rank=0, distributed=False)
    for fuse_shards, ok in ((1, False), (2, True)):
        p = tllama.params_from_tensors(_port(q4_tensors), tcfg, device="cpu", shard_pad=256, fuse_shards=fuse_shards)
        p = ttp.shard_params_tp(p, mesh)
        cache = ttp.shard_cache_tp(tllama.init_cache(tcfg, device="cpu"), mesh)
        if ok:
            ttp.make_tp_forward(tcfg, p, cache)
        else:
            with pytest.raises(ValueError, match="fuse_shards"):
                ttp.make_tp_forward(tcfg, p, cache)


def test_tp_one_rank_matches_forward(q4_tensors):
    """Without a process group (collectives are the identity), tp = 1 on
    the T layout gives the model's own forward."""
    tcfg = TModelConfig.tiny(**CFG)
    params = tllama.params_from_tensors(_port(q4_tensors), tcfg, device="cpu", q4_layout="t", shard_pad=128)
    sharded = ttp.shard_params_tp(params, single_device_mesh())
    cache = ttp.shard_cache_tp(tllama.init_cache(tcfg, device="cpu"), single_device_mesh())
    got, _ = ttp.make_tp_forward(tcfg, sharded, cache)(sharded, torch.tensor(PROMPT), 0, cache)
    want, _ = tllama.forward(params, torch.tensor(PROMPT), 0, tllama.init_cache(tcfg, device="cpu"), tcfg)
    assert _rel(got.numpy(), want.numpy()) <= BAR
    with pytest.raises(ValueError, match="world size 1"):
        make_mesh(tp=2)


def test_split_map_shards(q4_tensors):
    """The split map: every 2-D weight splits its rows (packed leaves
    alike, stacked weights per layer), norms replicate."""
    tcfg = TModelConfig.tiny(**CFG)
    params = tllama.params_from_tensors(_port(q4_tensors), tcfg, device="cpu")
    sharding.validate_tp_divisibility(tcfg, 4)
    with pytest.raises(ValueError):
        sharding.validate_tp_divisibility(tcfg, 3)
    full = params["layers_stacked"]
    for rank in range(4):
        got = sharding.shard_params(params, rank, 4)
        s = got["layers_stacked"]
        assert torch.equal(s["wq"].qs, full["wq"].qs[:, rank * 256 : (rank + 1) * 256])
        assert torch.equal(s["wo"].qs, full["wo"].qs[:, rank * 256 : (rank + 1) * 256])
        assert torch.equal(s["wo"].d, full["wo"].d[:, rank * 256 : (rank + 1) * 256])
        assert s["w2"].shape == (tcfg.n_embd // 4, tcfg.n_ff)
        assert got["tok_embeddings"].shape == (tcfg.n_vocab // 4, tcfg.n_embd)
        assert got["output"].shape == (tcfg.n_vocab // 4, tcfg.n_embd)
        assert s["attention_norm"] is full["attention_norm"] and got["norm"] is params["norm"]


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def test_flags_roundtrip():
    args = serve.build_argparser().parse_args([
        "--model", "/tmp/x.bin", "--coordinator", "host0:8476", "--num-processes", "2", "--process-id", "1",
        "--tp", "16", "--n-tokens", "4", "--device", "cpu",
    ])
    assert (args.coordinator, args.num_processes, args.process_id, args.tp, args.n_tokens, args.device) == (
        "host0:8476", 2, 1, 16, 4, "cpu")
    assert serve.build_argparser().parse_args([]).device is None  # the card


def test_missing_model(monkeypatch, capsys):
    monkeypatch.delenv("MODEL_PATH", raising=False)
    assert serve.main(["--device", "cpu"]) == 1
    assert serve.main(["--model", "/nonexistent/file.bin", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "Model path not specified" in out and "Invalid model path" in out


def _write_model(directory, n_embd: int, n_head: int) -> str:
    from llama_swift_torch.formats import ggml

    cfg = TModelConfig.tiny(n_embd=n_embd, n_head=n_head, n_vocab=256, n_mult=256, n_layer=1, n_ctx=128, n_rot=128)
    pieces = [b"<unk>", b"<s>", b"</s>"] + [bytes([b]) for b in range(32, 127)]
    pieces += [f"<x{i}>".encode() for i in range(cfg.n_vocab - len(pieces))]
    path = str(directory / f"tiny-{n_head}.bin")
    ggml.write_model_file(path, cfg, pieces, tllama.random_params(cfg, seed=4))
    return path


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("serve"), 1024, 8)


def test_serve_single_process_cpu(model_file, capsys):
    rc = serve.main(["--model", model_file, "--prompt", "the rain", "--n-tokens", "3", "--n-ctx", "128",
                     "--seed", "5", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "mesh tp=1" in out and "3 tokens" in out and "tok/s decode" in out


def _serve_rank(rank, world, store, model_file, out_path):
    """One serving rank without --seed; records the ids its sampler draws."""
    from llama_swift_torch.runtime import sampler

    torch.set_num_threads(2)
    drawn = []
    sample = sampler.SamplerState.sample
    sampler.SamplerState.sample = lambda self, logits: drawn.append(sample(self, logits)) or drawn[-1]
    rc = serve.main(["--model", model_file, "--prompt", "the rain", "--n-tokens", "8", "--n-ctx", "128",
                     "--device", "cpu", "--coordinator", f"file://{store}", "--num-processes", str(world),
                     "--process-id", str(rank)])
    np.save(f"{out_path}.{rank}.npy", np.array(drawn + [rc]))


def test_serve_two_ranks_without_seed_sample_alike(model_file, tmp_path):
    out = str(tmp_path / "ids")
    _spawn(_serve_rank, 2, tmp_path, model_file, out)
    ids = [np.load(f"{out}.{r}.npy").tolist() for r in range(2)]
    assert ids[0][-1] == 0 and len(ids[0]) == 9  # rc 0 after 8 draws
    assert ids[0] == ids[1]


def test_serve_refuses_tp_that_does_not_divide(tmp_path):
    """Two ranks on a 3-head model: serve checks the model against the TP
    degree (``sharding.validate_tp_divisibility``) and both return 1."""
    model = _write_model(tmp_path, 384, 3)
    out = str(tmp_path / "ids")
    _spawn(_serve_rank, 2, tmp_path, model, out)
    assert [np.load(f"{out}.{r}.npy").tolist() for r in range(2)] == [[1], [1]]
