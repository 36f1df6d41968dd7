"""The port's native host runtime (llama_swift_torch/native/) against the
JAX package's (llama_swift_tpu/native/) and the port's Python paths, on the
same tiny fixture files, on the CPU.

* The mmap loader: config, vocab and tensors byte-identical to the port's
  Python reader and to the JAX package's ``use_native=True`` load, for f32,
  Q4_0 and Q4_1 files; the missing-file and bad-magic errors; multi-part
  files, ``use_native=False`` and a machine without a compiler take the
  Python reader; the runner loads through the mapping.
* The tokenizer's ids equal both packages' Python tokenizers; the Q4_0
  codecs bit-exact against the JAX package's library.
* The port builds and loads its own library under ``llama_swift_torch/_build/``,
  never the JAX package's ``native/_ggml_io.so``.
* CPU params of a native load share no memory with the read-only mapping.
* The mt19937 fault's regression tests: a seeded ``rng_impl="mt19937"``
  ``SamplerState`` draws the same tokens in both packages (both libraries
  built by the same g++: ``std::mt19937`` and ``std::discrete_distribution``
  come from libstdc++), and so does the ``LlamaRunner`` with host sampling.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from llama_swift_tpu.config import GGMLType
from llama_swift_tpu.config import RunnerConfig as JRunnerConfig
from llama_swift_tpu.config import SamplingConfig as JSamplingConfig
from llama_swift_tpu.formats import ggml as jggml
from llama_swift_tpu.formats.quant import Q4_0Tensor, Q4_1Tensor
from llama_swift_tpu.native import bindings as jnb
from llama_swift_tpu.runtime.runner import LlamaRunner as JaxRunner
from llama_swift_tpu.runtime.sampler import SamplerState as JSamplerState
from llama_swift_tpu.tokenizer import Vocab as JVocab
from llama_swift_torch import RunnerConfig, SamplingConfig, Vocab
from llama_swift_torch.formats import ggml
from llama_swift_torch.models import llama as tllama
from llama_swift_torch.native import bindings as nb
from llama_swift_torch.runtime.runner import LlamaRunner
from llama_swift_torch.runtime.sampler import SamplerState

FTYPES = {"f32": (GGMLType.F32, None), "q4_0": (GGMLType.Q4_0, Q4_0Tensor), "q4_1": (GGMLType.Q4_1, Q4_1Tensor)}


@pytest.fixture(scope="module")
def paths(tmp_path_factory, tiny_cfg, tiny_tensors, tiny_vocab_pieces):
    """One tiny file per weight type, written by the JAX package's writer."""
    d = tmp_path_factory.mktemp("native")
    out = {}
    for name, (ftype, cls) in FTYPES.items():
        tensors = {k: (cls.quantize(v) if cls is not None and v.ndim == 2 else v) for k, v in tiny_tensors.items()}
        out[name] = str(d / f"model-{name}.bin")
        jggml.write_model_file(out[name], dataclasses.replace(tiny_cfg, ftype=ftype), tiny_vocab_pieces, tensors)
    return out


def _arrays(t):
    """The arrays of a loaded tensor: itself, or a Q4 wrapper's fields."""
    if dataclasses.is_dataclass(t):
        return [np.asarray(getattr(t, f.name)) for f in dataclasses.fields(t)]
    return [np.asarray(t)]


def _assert_same_load(a, b):
    assert type(a.config).__name__ == type(b.config).__name__
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert a.vocab == b.vocab
    assert a.tensors.keys() == b.tensors.keys()
    for name in a.tensors:
        assert type(a.tensors[name]).__name__ == type(b.tensors[name]).__name__, name
        for x, y in zip(_arrays(a.tensors[name]), _arrays(b.tensors[name])):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("ftype", list(FTYPES))
def test_loader_byte_identical_to_python_reader_and_jax(paths, ftype, tiny_vocab_pieces):
    native = ggml.load_model_file(paths[ftype])  # the default: through the mapping
    python = ggml.load_model_file(paths[ftype], use_native=False)
    jax_native = jggml.load_model_file(paths[ftype], use_native=True)
    assert native.native_handle is not None and python.native_handle is None
    assert native.config.ftype == FTYPES[ftype][0]
    assert native.vocab == tiny_vocab_pieces
    _assert_same_load(native, python)
    _assert_same_load(native, jax_native)
    native.native_handle.close()
    jax_native.native_handle.close()


def test_loader_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        ggml.load_model_file(str(tmp_path / "nope.bin"), use_native=True)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\xde\xad\xbe\xef" + b"\0" * 64)
    with pytest.raises(ggml.GGMLFormatError):
        ggml.load_model_file(str(bad), use_native=True)
    with pytest.raises(ggml.GGMLFormatError):
        ggml.load_model_file(str(bad))


def test_multi_part_and_no_compiler_take_the_python_reader(tmp_path, tiny_cfg, tiny_tensors, tiny_vocab_pieces,
                                                           monkeypatch):
    path = str(tmp_path / "model-2parts.bin")
    jggml.write_model_file(path, tiny_cfg, tiny_vocab_pieces, tiny_tensors, n_parts=2)
    assert os.path.exists(path + ".1")
    merged = ggml.load_model_file(path, n_parts=2)
    assert merged.native_handle is None
    _assert_same_load(merged, jggml.load_model_file(path, n_parts=2, use_native=False))
    single = str(tmp_path / "model.bin")
    jggml.write_model_file(single, tiny_cfg, tiny_vocab_pieces, tiny_tensors)
    monkeypatch.setattr(nb, "available", lambda: False)
    assert ggml.load_model_file(single).native_handle is None


def test_runner_loads_through_the_mapping(paths, monkeypatch):
    seen = []
    real = ggml._load_model_file_native
    monkeypatch.setattr(ggml, "_load_model_file_native", lambda *a, **k: seen.append(a[0]) or real(*a, **k))
    runner = LlamaRunner(paths["q4_0"], n_ctx=64, prefill_bucket=8, device="cpu")
    runner.ensure_loaded()
    assert seen == [paths["q4_0"]]


def test_tokenizer_matches_both_packages(paths, tiny_vocab_pieces):
    mf = nb.NativeModelFile(paths["f32"])
    try:
        nt = nb.NativeTokenizer(mf)
        pv, jv = Vocab(tiny_vocab_pieces), JVocab(tiny_vocab_pieces)
        for text in ["the rain in spain", "hello world!", "a the on", "", "THE QUICK brown fox", "ab\xffab"]:
            for bos in (False, True):
                ids = nt.tokenize(text, bos)
                assert ids == pv.tokenize(text, bos) == jv.tokenize(text, bos), text
    finally:
        mf.close()


def test_q4_0_codecs_bit_exact_against_jax():
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    c, hist = nb.quantize_q4_0(x, with_hist=True)
    jc, jhist = jnb.quantize_q4_0(x, with_hist=True)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(hist, jhist)
    np.testing.assert_array_equal(c, Q4_0Tensor.quantize(x).to_row_bytes())
    np.testing.assert_array_equal(nb.dequant_q4_0(c, 8, 128), jnb.dequant_q4_0(jc, 8, 128))


def test_port_builds_and_loads_its_own_library():
    assert nb.available()
    path = os.path.realpath(nb.loaded_path())
    build_dir = os.path.realpath(nb.BUILD_DIR)
    assert os.path.dirname(path) == build_dir
    assert build_dir.endswith(os.path.join("llama_swift_torch", "_build"))
    assert path == os.path.realpath(nb.library_path())
    jax_lib = os.path.realpath(os.path.join(os.path.dirname(jnb.__file__), "_ggml_io.so"))
    assert path != jax_lib and os.path.exists(path)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("ftype", list(FTYPES))
def test_cpu_params_do_not_alias_the_mapping(paths, ftype, fused):
    mf = ggml.load_model_file(paths[ftype])
    h = mf.native_handle
    lo, hi = h._base, h._base + h.map_size
    cfg = dataclasses.replace(mf.config, fuse_layer_matmuls=fused)
    params = tllama.params_from_tensors(mf.tensors, cfg, device="cpu")

    def tensors(p):
        if isinstance(p, dict):
            for v in p.values():
                yield from tensors(v)
        elif dataclasses.is_dataclass(p):
            for f in dataclasses.fields(p):
                yield getattr(p, f.name)
        else:
            yield p

    ts = list(tensors(params))
    assert len(ts) >= 9 and all(isinstance(t, torch.Tensor) for t in ts)
    for t in ts:
        start = t.untyped_storage().data_ptr()
        end = start + t.untyped_storage().nbytes()
        assert end <= lo or start >= hi, "a param aliases the read-only mapping"
    for t in mf.tensors.values():  # the loader's own arrays too
        for a in _arrays(t):
            start = a.__array_interface__["data"][0]
            assert start + a.nbytes <= lo or start >= hi
    h.close()


SAMPLING = {
    "default": dict(),
    "top_k_5_penalty_1.5": dict(top_k=5, top_p=1.0, repeat_penalty=1.5, temp=1.2),
    "top_p_0.5_no_penalty": dict(top_k=100, top_p=0.5, repeat_penalty=1.0, temp=0.7),
}


@pytest.mark.parametrize("settings", list(SAMPLING))
@pytest.mark.parametrize("seed", [1, 7, 2024])
def test_mt19937_sampler_draws_as_jax(seed, settings):
    """The fault's regression test: before the port had its native sampler,
    ``rng_impl="mt19937"`` silently drew from numpy, and these sequences
    differed."""
    kw = dict(seed=seed, rng_impl="mt19937", repeat_last_n=16, **SAMPLING[settings])
    port, ref = SamplerState(SamplingConfig(**kw)), JSamplerState(JSamplingConfig(**kw))
    assert port._native is not None and ref._native is not None
    rng = np.random.default_rng(seed)
    for t in (1, 17, 30):
        port.observe(t)
        ref.observe(t)
    draws, want = [], []
    for _ in range(64):
        logits = (2.0 * rng.standard_normal(256)).astype(np.float32)
        draws.append(port.sample(logits))
        want.append(ref.sample(logits))
    assert draws == want
    assert len(set(draws)) > 1


def test_mt19937_without_a_compiler_draws_from_numpy(monkeypatch):
    monkeypatch.setattr(nb, "available", lambda: False)
    s = SamplerState(SamplingConfig(seed=3, rng_impl="mt19937"))
    assert s._native is None
    assert 0 <= s.sample(np.zeros(8, np.float32)) < 8


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
def test_runner_host_sampled_mt19937_stream_matches_jax(paths, ftype):
    prompt, n = "the rain in", 12
    jcfg = JRunnerConfig(num_tokens=n, device_sampling=False,
                         sampling=JSamplingConfig(seed=11, rng_impl="mt19937", temp=1.5))
    pcfg = RunnerConfig(num_tokens=n, device_sampling=False,
                        sampling=SamplingConfig(seed=11, rng_impl="mt19937", temp=1.5))
    want = [e.token for e in JaxRunner(paths[ftype], n_ctx=64, prefill_bucket=8).run_events(prompt, jcfg)
            if e.kind.value == "outputToken"]
    got = [e.token for e in LlamaRunner(paths[ftype], n_ctx=64, prefill_bucket=8, device="cpu").run_events(
        prompt, pcfg) if e.kind.value == "outputToken"]
    assert len(want) > n
    assert got == want
