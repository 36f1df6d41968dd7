"""The port's tools against the JAX package's, on the CPU: the quantize tool
(llama_swift_torch/tools/quantize.py) writes the same bytes as
llama_swift_tpu.tools.quantize from the same f32 and f16 files, types 2
(Q4_0) and 3 (Q4_1); the perplexity harness (llama_swift_torch/utils/
perplexity.py) scores a tiny f16 model and its two quantizations as the
JAX harness does (ppl within 1e-4 relative: the logits agree to ~1e-6 and
the NLL sums differ only in order and width; the same n_scored); the
perplexity CLI prints its JSON summary."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from llama_swift_tpu.config import GGMLType
from llama_swift_tpu.formats import ggml as jggml
from llama_swift_tpu.models import llama as jllama
from llama_swift_tpu.tools.quantize import quantize_model_file as jax_quantize
from llama_swift_tpu.tokenizer import Vocab as JVocab
from llama_swift_tpu.utils.perplexity import perplexity as jax_perplexity
from llama_swift_torch.config import ModelConfig as TModelConfig
from llama_swift_torch.formats import ggml as tggml
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.tokenizer import Vocab
from llama_swift_torch.tools import perplexity as ppl_tool
from llama_swift_torch.tools import quantize as quantize_tool
from llama_swift_torch.utils.perplexity import perplexity

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
