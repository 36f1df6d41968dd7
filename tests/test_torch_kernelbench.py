"""The HBM stream probe (llama_swift_torch/ops/q4_matvec.stream_probe, kernel
csrc/stream_probe.cu) and the kernelbench tool
(llama_swift_torch/tools/kernelbench.py) on the CPU.

* The probe's plain version bit-equal to the JAX ``stream_probe`` run in
  Pallas interpret mode: random int32 words whose sums wrap, biases 0, 5,
  −7 and 2³¹−1, and the JAX tool's own ``synth_v`` words (the port reads the
  same words as the little-endian bytes of a ``Q4_0Weight``'s ``qs``).
* ``kernelbench.main`` on the CPU (the plain versions) at tiny shapes
  returns every variant, each rate the bytes the variant moves (nibbles; with
  f32 scales; 2 bytes a dense bf16 weight) over its time; without a card and
  without ``--device cpu`` it raises.

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from llama_swift_tpu.ops.q4_vpu_pallas import stream_probe as jax_stream_probe
from llama_swift_tpu.tools.kernelbench import synth_v
from llama_swift_torch.ops import q4_matvec as mv
from llama_swift_torch.tools import kernelbench as kb

OUT, WORDS = 256, 128  # in = 1024


def _jax_probe(words: np.ndarray, bias: int) -> np.ndarray:
    qs4v = jnp.asarray(words.reshape(OUT // 128, 128, -1))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_stream_probe(qs4v, jnp.asarray(bias).astype(jnp.int32)))


def _qs(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(words, dtype="<i4").view(np.uint8))


@pytest.fixture(scope="module")
def wrapping_words():
    rng = np.random.default_rng(0)
    return rng.integers(-(2**31), 2**31, size=(OUT, WORDS), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("bias", [0, 5, -7, 2**31 - 1])
def test_probe_plain_bit_equal_to_jax(wrapping_words, bias):
    want = _jax_probe(wrapping_words, bias)
    got = mv.stream_probe_plain(_qs(wrapping_words), bias)
    assert got.dtype == torch.float32 and got.shape == want.shape == (OUT // 128,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the sums wrapped: the int64 sums of these rows lie outside int32
    wide = wrapping_words.astype(np.int64).sum(axis=1) + WORDS * bias
    assert (np.abs(wide) >= 2**31).any()


def test_probe_plain_bit_equal_to_jax_on_synth_v_words():
    w, _ = synth_v(OUT, 1024)
    words = np.asarray(w.qs4v).reshape(OUT, -1)
    for bias in (0, 3):
        np.testing.assert_array_equal(mv.stream_probe_plain(_qs(words), bias).numpy(), _jax_probe(words, bias))


def test_probe_wrapper_rows_and_checks(wrapping_words):
    qs = _qs(wrapping_words)
    rows = mv.stream_probe(qs, 5, all_rows=True)
    assert rows.shape == (OUT,)
    assert torch.equal(rows[::128], mv.stream_probe(qs, 5))
    row3 = (wrapping_words[3].astype(np.int64) + 5).sum()
    assert rows[3] == np.float32(np.int64((row3 + 2**31) % 2**32 - 2**31))
    assert torch.equal(mv.stream_probe(qs, 2**32 + 5), mv.stream_probe(qs, 5))  # the bias wraps to int32
    with pytest.raises(ValueError):
        mv.stream_probe(qs[:100], 0)  # out % 128 != 0
    with pytest.raises(ValueError):
        mv.stream_probe(qs.view(torch.int32), 0)


TINY = {"attn": (256, 512), "w2": (128, 1024)}


def test_kernelbench_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(kb, "SHAPES", TINY)
    monkeypatch.setattr(kb, "time_ms", lambda fn, iters, device: (fn(0), fn(1), 1.0)[-1])  # 1 ms a call
    res = kb.main(["--device", "cpu", "--iters", "2", "--shapes", "attn,w2",
                   "--variants", "probe,vpu,vpu_raw,dense,phase"])
    assert sorted(res) == ["attn", "w2"]
    for name, (out, in_dim) in TINY.items():
        assert sorted(res[name]) == sorted(kb.VARIANTS)
        expect = {"probe": out * in_dim // 2, "dense": out * in_dim * 2}
        for v in ("vpu", "vpu_raw", "phase"):
            expect[v] = out * in_dim // 2 + out * in_dim // 8
        for v, nbytes in expect.items():
            assert res[name][v] == pytest.approx(nbytes / 1e-3 / 1e9, rel=1e-12)
    text = capsys.readouterr().out
    assert "device=cpu" in text and "% of the probe" in text


def test_kernelbench_defaults_and_real_timing_on_cpu(monkeypatch):
    monkeypatch.setattr(kb, "SHAPES", {"attn": (128, 256)})
    res = kb.main(["--device", "cpu", "--iters", "1", "--shapes", "attn"])
    assert sorted(res["attn"]) == ["dense", "probe", "vpu", "vpu_raw"]  # the JAX tool's default variants
    assert all(v > 0 for v in res["attn"].values())


def test_kernelbench_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kb.main(["--shapes", "attn"])
    with pytest.raises(SystemExit):
        kb.main(["--device", "cpu", "--variants", "probe,bogus"])


def test_kernelbench_refuses_a_rate_above_the_card(monkeypatch):
    monkeypatch.setattr(kb, "SHAPES", {"attn": (128, 256)})
    monkeypatch.setattr(kb, "time_ms", lambda fn, iters, device: 1e-9)
    with pytest.raises(RuntimeError, match="above the card"):
        kb.main(["--device", "cpu", "--shapes", "attn", "--variants", "probe"])
