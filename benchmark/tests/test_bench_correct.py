"""``correct`` on the CPU at a tiny size: the port's plain path against the
reference, a sound run, and runs with the timed path broken underneath."""

import pytest
import torch

from benchmark import registry, run
from benchmark.faults import FAULTS, planted
from benchmark.tests import tiny

CELL = "deepseek7b-q4_0.chat"


def _run(seed=2**31 + 5, seconds=5.0):
    return run.run_cell(CELL, seed, seconds, False, device="cpu", cfg=tiny.config(), mix=tiny.mix(),
                        limits=tiny.LIMITS, log=lambda *a: None)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["_values"]["tokens"] >= 16
    assert res["metrics"]["output_tok_s"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(fault):
    with planted(fault):
        res = _run()
    assert not res["correct"]
    assert res["_values"]["mean_gap_excess"] > tiny.LIMITS["mean_gap_excess"]


def test_reference_matches_the_port_forward():
    """Prefill then decode through the port's cache against the reference's
    one forward: the decode rows' logits agree to f32 rounding."""
    from llama_swift_torch.models import llama

    from benchmark.check import sequences
    from benchmark.record import Record

    cfg = tiny.config()
    system, ref_mod = registry.system("llama"), registry.reference("llama")
    mc = system.model_config(cfg)
    params = system.build_params(cfg, 11, "cpu")
    prompt = [1] + torch.randint(3, 512, (40,), generator=torch.Generator().manual_seed(3)).tolist()
    cache = llama.init_cache(mc, device="cpu")
    padded, n = llama.pad_tokens(prompt, 64)
    llama.prefill(params, torch.as_tensor(padded, dtype=torch.int64), 0, cache, mc)
    tok, served, port_logits = prompt[-1], [], []
    for i in range(8):
        lg, cache = llama.decode_step(params, torch.tensor(tok), len(prompt) - 1 + i, cache, mc)
        port_logits.append(lg)
        tok = int(lg.argmax())
        served.append(tok)
    rec = Record(0, len(prompt), 8, True, 0.0, tokens=served)
    ref = ref_mod.Reference(cfg, 11, "cpu", prefill_bf16=False)
    (ref_logits,) = ref.logits(sequences(ref_mod, [rec], {0: prompt}))
    port = torch.stack(port_logits)
    assert float((port - ref_logits).abs().max() / ref_logits.abs().max()) < 1e-5


def test_forbidden_names_are_whole():
    import sys

    sys.modules.setdefault("llama_swift_tpu_like", sys)  # a name that only starts like one
    try:
        assert "llama_swift_tpu" not in run.loaded_forbidden()
    finally:
        del sys.modules["llama_swift_tpu_like"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_penalty_is_the_greedy_samplers(seed):
    """The check's penalized logits put first what the port's sampler takes
    at top-k 1 with the repeat penalty, row by row along a served answer."""
    from llama_swift_torch.config import SamplingConfig
    from llama_swift_torch.runtime.device_sampler import init_ring, sample_token

    from benchmark.check import penalized
    from benchmark.reference.llama import Sequence

    g = torch.Generator().manual_seed(seed)
    V, last_n, n = 16, 4, 40
    prompt = [1] + torch.randint(3, V, (5,), generator=g).tolist()
    logits = torch.randn((n, V), generator=g)
    scfg = SamplingConfig(seed=0, temp=1.0, top_k=1, top_p=1.0, repeat_penalty=1.3, repeat_last_n=last_n)
    ring, pos = init_ring(prompt, last_n, "cpu")
    served = []
    for j in range(n):
        t = int(sample_token(logits[j], ring, torch.Generator().manual_seed(0), scfg))
        ring[pos], pos = t, (pos + 1) % last_n
        served.append(t)
    seq = Sequence(prompt + served[:-1], len(prompt) - 1, len(prompt) - 1)
    pen = penalized(logits, seq, 1.3, last_n)
    assert pen.argmax(dim=-1).tolist() == served
    assert not torch.equal(pen, logits)
