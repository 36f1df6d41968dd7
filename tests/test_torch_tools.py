"""The port's tools against the JAX package's, on the CPU: the quantize tool
(llama_swift_torch/tools/quantize.py) writes the same bytes as
llama_swift_tpu.tools.quantize from the same f32 and f16 files, types 2
(Q4_0) and 3 (Q4_1); the perplexity harness (llama_swift_torch/utils/
perplexity.py) scores a tiny f16 model and its two quantizations as the
JAX harness does (ppl within 1e-4 relative: the logits agree to ~1e-6 and
the NLL sums differ only in order and width; the same n_scored), and so does
``perplexity_of_text`` (within 1e-5); ``log_softmax_row`` returns JAX's
value; the perplexity CLI prints its JSON summary.  The converter
(llama_swift_torch/tools/convert_pth.py) writes the JAX converter's bytes
(f32 and f16) from a tiny checkpoint the test saves, with a shim
``sentencepiece``; the port quantizes the result and serves it."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType
from llama_swift_tpu.formats import ggml as jggml
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.tools import convert_pth as jax_convert
from llama_swift_tpu.tools.quantize import quantize_model_file as jax_quantize
from llama_swift_tpu.tokenizer import Vocab as JVocab
from llama_swift_tpu.utils.perplexity import log_softmax_row as jax_log_softmax_row
from llama_swift_tpu.utils.perplexity import perplexity as jax_perplexity
from llama_swift_tpu.utils.perplexity import perplexity_of_text as jax_ppl_of_text
from llama_swift_torch import LlamaRunner, RunnerConfig, SamplingConfig
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats import ggml as tggml
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.runtime.events import EventKind
from llama_swift_torch.tokenizer import Vocab
from llama_swift_torch.tools import convert_pth
from llama_swift_torch.tools import perplexity as ppl_tool
from llama_swift_torch.tools import quantize as quantize_tool
from llama_swift_torch.utils.perplexity import log_softmax_row, perplexity, perplexity_of_text

N_CTX = 64
TEXT = ("the rain in spain stays mainly in the plain; he said that on a warm night "
        "the wind and the sea were at rest. ") * 8


def _quiet(*args, **kwargs):
    pass


@pytest.fixture(scope="module")
def model_files(tmp_path_factory, tiny_cfg, tiny_tensors, tiny_vocab_pieces):
    """The tiny model as f32 and as f16 GGML files."""
    d = tmp_path_factory.mktemp("tools")
    paths = {}
    for name, ftype, dtype in (("f32", GGMLType.F32, np.float32), ("f16", GGMLType.F16, np.float16)):
        tensors = {k: (v.astype(dtype) if v.ndim == 2 else v) for k, v in tiny_tensors.items()}
        paths[name] = str(d / f"model-{name}.bin")
        jggml.write_model_file(paths[name], dataclasses.replace(tiny_cfg, ftype=ftype), tiny_vocab_pieces, tensors)
    return paths


@pytest.mark.parametrize("itype", [2, 3], ids=["q4_0", "q4_1"])
@pytest.mark.parametrize("src", ["f32", "f16"])
def test_quantize_tool_writes_the_jax_tools_bytes(model_files, tmp_path, src, itype):
    ours, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert quantize_tool.quantize_model_file(model_files[src], ours, itype, log=_quiet)
    assert jax_quantize(model_files[src], theirs, itype, log=_quiet)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    mf = tggml.load_model_file(ours, n_ctx=N_CTX)
    assert mf.config.ftype == GGMLType(itype)
    assert type(mf.tensors["layers.0.attention.wq.weight"]).__name__ == ("Q4_0Tensor" if itype == 2 else "Q4_1Tensor")


def test_quantize_tool_cli(model_files, tmp_path, capsys):
    out = str(tmp_path / "q4_1.bin")
    assert quantize_tool.main([model_files["f16"], out, "3"]) == 0
    text = capsys.readouterr().out
    assert "quant size" in text and "quantize time" in text
    assert quantize_tool.main([model_files["f16"], out]) == 1  # usage


@pytest.fixture(scope="module")
def quantized_files(model_files, tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    paths = {"f16": model_files["f16"]}
    for name, itype in (("q4_0", 2), ("q4_1", 3)):
        paths[name] = str(d / f"model-{name}.bin")
        quantize_tool.quantize_model_file(model_files["f16"], paths[name], itype, log=_quiet)
    return paths


@pytest.mark.parametrize("kind", ["f16", "q4_0", "q4_1"])
def test_perplexity_matches_jax(quantized_files, kind):
    path = quantized_files[kind]
    jmf = jggml.load_model_file(path, n_ctx=N_CTX)
    jcfg = dataclasses.replace(jmf.config, prefill_bf16=False)
    ids = np.asarray(JVocab(jmf.vocab).tokenize(TEXT, bos=False), dtype=np.int32)[: 3 * N_CTX]
    want = jax_perplexity(jllama.params_from_tensors(jmf.tensors, jcfg, param_dtype=jnp.float32), jcfg, ids)

    mf = tggml.load_model_file(path, n_ctx=N_CTX)
    cfg = dataclasses.replace(mf.config, prefill_bf16=False)
    tids = np.asarray(Vocab(mf.vocab).tokenize(TEXT, bos=False))[: 3 * N_CTX]
    np.testing.assert_array_equal(tids, ids)
    seconds = []
    got = perplexity(tllama.params_from_tensors(mf.tensors, cfg, device="cpu"), cfg, tids, window_seconds=seconds)
    assert got["n_scored"] == want["n_scored"] == 3 * N_CTX // 2
    assert abs(got["ppl"] - want["ppl"]) <= 1e-4 * want["ppl"]
    assert len(seconds) == 3 and np.isfinite(got["nll"])


def test_perplexity_tells_the_quantizations_apart(quantized_files):
    """On the same tokens f16, Q4_0 and Q4_1 score three different values
    (each file's own weights are used)."""
    scores = {}
    for kind, path in quantized_files.items():
        mf = tggml.load_model_file(path, n_ctx=N_CTX)
        cfg = dataclasses.replace(mf.config, prefill_bf16=False)
        ids = np.asarray(Vocab(mf.vocab).tokenize(TEXT, bos=False))[: 2 * N_CTX]
        scores[kind] = perplexity(tllama.params_from_tensors(mf.tensors, cfg, device="cpu"), cfg, ids)["ppl"]
    assert len(set(scores.values())) == 3


def test_perplexity_cli_prints_json(quantized_files, tmp_path, capsys):
    text = tmp_path / "corpus.txt"
    text.write_text(TEXT)
    assert ppl_tool.main(["--model", quantized_files["q4_1"], "--text", str(text), "--n-ctx", str(N_CTX),
                          "--max-windows", "2", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_scored"] == N_CTX and summary["device"] == "cpu" and len(summary["window_s"]) == 2
    assert np.isfinite(summary["ppl"]) and summary["ppl"] > 1.0


def test_perplexity_needs_a_window():
    with pytest.raises(ValueError):
        perplexity({"norm": None}, TModelConfig.tiny(n_ctx=N_CTX), np.arange(10))


# ---------------------------------------------------------------------------
# perplexity_of_text, log_softmax_row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f16", "q4_0"])
def test_perplexity_of_text_matches_jax(quantized_files, kind):
    """The whole text tokenized without BOS, every window scored; within
    1e-5 relative of the JAX harness (logits agree to ~1e-6)."""
    jmf = jggml.load_model_file(quantized_files[kind], n_ctx=N_CTX)
    jcfg = dataclasses.replace(jmf.config, prefill_bf16=False)
    want = jax_ppl_of_text(jllama.params_from_tensors(jmf.tensors, jcfg, param_dtype=jnp.float32), jcfg,
                           JVocab(jmf.vocab), TEXT)
    mf = tggml.load_model_file(quantized_files[kind], n_ctx=N_CTX)
    cfg = dataclasses.replace(mf.config, prefill_bf16=False)
    params = tllama.params_from_tensors(mf.tensors, cfg, device="cpu")
    got = perplexity_of_text(params, cfg, Vocab(mf.vocab), TEXT, stride=N_CTX // 2)  # stride: ignored, as in JAX
    assert got["n_scored"] == want["n_scored"] >= 4 * N_CTX // 2
    assert abs(got["ppl"] - want["ppl"]) <= 1e-5 * want["ppl"]
    ids = np.asarray(Vocab(mf.vocab).tokenize(TEXT, bos=False))
    assert got == perplexity(params, cfg, ids)


def test_log_softmax_row_equals_jax():
    logits = (np.random.default_rng(3).standard_normal(512) * 8).astype(np.float32)
    for target in (0, 17, 511):
        assert log_softmax_row(logits, target) == jax_log_softmax_row(logits, target)
    lp = np.array([log_softmax_row(logits, t) for t in range(512)])
    assert abs(np.log(np.exp(lp).sum())) < 1e-5


# ---------------------------------------------------------------------------
# convert_pth
# ---------------------------------------------------------------------------


class _FakeSentencePiece:
    """The sentencepiece calls the converters make, over a 256-piece vocab:
    unknown, two controls, four byte tokens and normal pieces."""

    def __init__(self, path):
        self.path = path

    def vocab_size(self):
        return 256

    def is_unknown(self, i):
        return i == 0

    def is_control(self, i):
        return i in (1, 2)

    def is_byte(self, i):
        return 3 <= i < 7

    def id_to_piece(self, i):
        return f"<0x{i + 0x3D:02X}>" if 3 <= i < 7 else f"▁tok{i}"


@pytest.fixture()
def checkpoint(tmp_path, tiny_cfg, tiny_tensors, monkeypatch):
    """A tiny LLaMA checkpoint (``params.json``, ``consolidated.00.pth`` with
    the reference's names and a ``rope.freqs`` tensor to skip) in two
    directories, one for each converter, and a shim ``sentencepiece``."""
    import sys
    import types

    shim = types.ModuleType("sentencepiece")
    shim.SentencePieceProcessor = _FakeSentencePiece
    monkeypatch.setitem(sys.modules, "sentencepiece", shim)
    sd = {k: torch.from_numpy(v.copy()) for k, v in tiny_tensors.items()}
    sd["layers.0.attention.inner_attention.rope.freqs"] = torch.zeros(8)
    dirs = {}
    for who in ("jax", "port"):
        d = tmp_path / who / "tiny"
        d.mkdir(parents=True)
        (d / "params.json").write_text(json.dumps({"dim": tiny_cfg.n_embd, "multiple_of": tiny_cfg.n_mult,
                                                   "n_heads": tiny_cfg.n_head, "n_layers": tiny_cfg.n_layer}))
        torch.save(sd, d / "consolidated.00.pth")
        dirs[who] = str(d)
    return dirs


@pytest.mark.parametrize("ftype", [0, 1], ids=["f32", "f16"])
def test_convert_pth_writes_the_jax_converters_bytes(checkpoint, ftype):
    (ours,) = convert_pth.convert(checkpoint["port"], ftype)
    (theirs,) = jax_convert.convert(checkpoint["jax"], ftype)
    assert ours.endswith(f"ggml-model-{('f32', 'f16')[ftype]}.bin")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    mf = tggml.load_model_file(ours, n_ctx=N_CTX)
    assert mf.config.ftype == GGMLType(ftype)
    assert mf.vocab[:4] == [" ⁇ ".encode(), b"", b"", b"@"] and mf.vocab[40] == b" tok40"
    assert "layers.0.attention.inner_attention.rope.freqs" not in mf.tensors


def test_convert_pth_cli(checkpoint, capsys):
    assert convert_pth.main([]) == 1
    assert convert_pth.main([checkpoint["port"], "2"]) == 1
    assert convert_pth.main([checkpoint["port"]]) == 0  # f16 by default
    assert "Done. Output file:" in capsys.readouterr().out


def test_converted_file_quantized_and_served_by_the_port(checkpoint, tmp_path):
    (f16,) = convert_pth.convert(checkpoint["port"], 1)
    q4 = str(tmp_path / "ggml-model-q4_0.bin")
    assert quantize_tool.quantize_model_file(f16, q4, 2, log=_quiet)
    runner = LlamaRunner(q4, n_ctx=N_CTX, prefill_bucket=8, device="cpu")
    events = list(runner.run_events(" tok40 tok41", RunnerConfig(num_tokens=6, sampling=SamplingConfig(seed=1))))
    assert events[-1].kind == EventKind.COMPLETED
    assert sum(e.kind == EventKind.OUTPUT_TOKEN for e in events) >= 6
