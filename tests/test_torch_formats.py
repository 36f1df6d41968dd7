"""The port's copies of the host-side modules (GGML reader/writer, Q4
codecs, tokenizer, host sampler) agree with the JAX package's originals."""

import numpy as np
import pytest

from llama_swift_tpu.formats import ggml as jggml
from llama_swift_tpu.formats import quant as jquant
from llama_swift_tpu.runtime.sampler import sample_top_p_top_k as jsample
from llama_swift_tpu.tokenizer import Vocab as JVocab
from llama_swift_torch.config import GGMLType, ModelConfig
from llama_swift_torch.formats import ggml, quant
from llama_swift_torch.runtime.sampler import sample_top_p_top_k
from llama_swift_torch.tokenizer import Vocab


@pytest.mark.parametrize("cls", ["Q4_0Tensor", "Q4_1Tensor"])
def test_quantizers_bit_exact(cls):
    x = np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)
    ours, theirs = getattr(quant, cls).quantize(x), getattr(jquant, cls).quantize(x)
    np.testing.assert_array_equal(ours.to_row_bytes(), theirs.to_row_bytes())
    np.testing.assert_array_equal(ours.dequantize(), theirs.dequantize())


def test_written_file_reads_back_in_both_packages(tmp_path, tiny_vocab_pieces):
    cfg = ModelConfig.tiny(ftype=GGMLType.Q4_0)
    rng = np.random.default_rng(1)
    tensors = {}
    for name, shape in ggml.expected_tensor_shapes(cfg).items():
        a = rng.standard_normal(shape).astype(np.float32)
        tensors[name] = quant.Q4_0Tensor.quantize(a) if len(shape) == 2 else a
    path = str(tmp_path / "m.bin")
    ggml.write_model_file(path, cfg, tiny_vocab_pieces, tensors)
    ours = ggml.load_model_file(path, n_ctx=64)
    theirs = jggml.load_model_file(path, n_ctx=64, use_native=False)
    assert ours.vocab == theirs.vocab == tiny_vocab_pieces
    assert ours.config.n_embd == theirs.config.n_embd and ours.config.ftype == GGMLType.Q4_0
    for name, t in tensors.items():
        if isinstance(t, quant.Q4_0Tensor):
            np.testing.assert_array_equal(ours.tensors[name].qs, t.qs)
            np.testing.assert_array_equal(theirs.tensors[name].scales, t.scales)
        else:
            np.testing.assert_array_equal(ours.tensors[name], t)


def test_bad_magic_rejected(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"\0" * 64)
    with pytest.raises(ggml.GGMLFormatError):
        ggml.load_model_file(str(path))


def test_tokenizer_matches(tiny_vocab_pieces):
    for text in ["the rain in", "", "hello, world! 123", "in the thing"]:
        assert Vocab(tiny_vocab_pieces).tokenize(text, bos=True) == JVocab(tiny_vocab_pieces).tokenize(text, bos=True)


def test_host_sampler_same_stream():
    logits = np.random.default_rng(2).standard_normal(256).astype(np.float32)
    kw = dict(repeat_penalty=1.3, top_k=40, top_p=0.95, temp=0.8)
    ours = [sample_top_p_top_k(logits, [0, 5, 9], rng=r, **kw) for r in [np.random.default_rng(3)] * 20]
    theirs = [jsample(logits, [0, 5, 9], rng=r, **kw) for r in [np.random.default_rng(3)] * 20]
    assert ours == theirs
